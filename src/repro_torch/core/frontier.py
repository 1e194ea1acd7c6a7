"""Vectorized Pareto-frontier math for time-vs-cost fleet search.

A copy of ``repro.core.frontier`` (numpy only).  The what-if optimizer
of the serving stack prunes each search
generation by *dominance*: a candidate configuration survives only if no
other candidate is at least as good on both objectives (iteration /
epoch time, fleet $/hour) and strictly better on one.  The frontier is
the set of survivors — the only configurations a rational buyer would
pick, whatever their time/cost trade-off.

Everything here is plain NumPy over flat ``(times, costs)`` arrays, so
pruning a generation of hundreds of candidates costs microseconds —
dominance math must never be the reason to price fewer candidates
against the engine.

NaN-cost contract (the ``DeviceSpec.cost_per_hour=None`` devices, which
flow through ``DeviceArrays.cost_per_hour`` as NaN): NumPy comparisons
against NaN are silently ``False``, so naive frontier math would either
drop unrentable devices entirely or — worse — keep everything they
should dominate.  The rule here is explicit: **a NaN cost is treated as
"+inf dollars" for dominance**.  An unrentable device therefore stays
on the frontier exactly when it wins on *time alone* (nothing cheaper-
or-equal is as fast), and it can never knock a priced device off the
cost axis.  ``rank`` paths exclude NaN costs from the $-frontier
explicitly (see ``frontier_indices(..., objective="cost")``).  NaN
*times* are a caller bug and raise.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

__all__ = ["dominates", "frontier_indices", "pareto_mask", "thin_indices"]


def _as_objectives(times, costs) -> Tuple[np.ndarray, np.ndarray]:
    t = np.asarray(times, np.float64).reshape(-1)
    c = np.asarray(costs, np.float64).reshape(-1)
    if t.shape != c.shape:
        raise ValueError(f"times {t.shape} and costs {c.shape} differ")
    if np.isnan(t).any():
        raise ValueError("NaN time objective (unpredicted candidate?) — "
                         "frontier math needs every time finite")
    return t, c


def dominates(time_a: float, cost_a: float,
              time_b: float, cost_b: float) -> bool:
    """Reference (scalar) dominance: does A weakly dominate B?

    A dominates B iff A is <= on both objectives and < on at least one.
    NaN costs compare as +inf (the module contract), so a priced device
    strictly dominates an equally-fast unrentable one, and two
    unrentable devices compare on time alone.  This is the semantics
    :func:`pareto_mask` implements vectorized; the property suite checks
    them against each other."""
    ca = math.inf if math.isnan(cost_a) else cost_a
    cb = math.inf if math.isnan(cost_b) else cost_b
    return (time_a <= time_b and ca <= cb
            and (time_a < time_b or ca < cb))


def pareto_mask(times, costs) -> np.ndarray:
    """Boolean mask of non-dominated points (vectorized, O(n log n)).

    ``times`` must be finite; ``costs`` may contain NaN (treated as
    +inf — kept only via the time-only frontier) or +inf.  Duplicate
    points (equal on both objectives) do not dominate each other, so
    *all* copies of a surviving point are kept — the caller sees every
    candidate that achieved the frontier, not an arbitrary winner."""
    t, c = _as_objectives(times, costs)
    if t.size == 0:
        return np.zeros(0, bool)
    c_eff = np.where(np.isnan(c), np.inf, c)
    # unique rows come back lexsorted by (time, cost); within the unique
    # set weak dominance reduces to "strictly cheaper than everything
    # earlier in the sort" (an equal-time row with higher cost is
    # dominated by the cost term; a later-time row needs a strictly
    # lower cost than every earlier row to be incomparable with all of
    # them).  Duplicates collapse onto one row and share its verdict.
    pts = np.stack([t, c_eff], axis=1)
    uniq, inverse = np.unique(pts, axis=0, return_inverse=True)
    run_min = np.minimum.accumulate(uniq[:, 1])
    prev_min = np.concatenate(([np.inf], run_min[:-1]))
    keep = uniq[:, 1] < prev_min
    keep[0] = True      # nothing precedes the first row — even at inf cost
    return keep[inverse.reshape(-1)]


def frontier_indices(times, costs, objective: str = "pareto") -> np.ndarray:
    """Indices of the frontier, in deterministic order.

    ``objective``:

    * ``"pareto"`` — the 2-D time/cost frontier (NaN costs ride the
      time-only frontier, per the module contract).
    * ``"time"``  — pure speed: every index achieving the minimum time.
    * ``"cost"``  — the $-frontier: NaN-cost points are **excluded
      explicitly** (an unrentable device has no dollars axis to win on),
      then every index achieving the minimum cost among the rest.

    Ordering is (time asc, cost asc, index asc) — stable across runs and
    across any permutation-invariant caller, so search results and wire
    payloads are reproducible byte for byte."""
    t, c = _as_objectives(times, costs)
    if objective == "pareto":
        idx = np.flatnonzero(pareto_mask(t, c))
    elif objective == "time":
        idx = np.flatnonzero(t == t.min()) if t.size else np.zeros(0, int)
    elif objective == "cost":
        priced = ~np.isnan(c)
        if not priced.any():
            return np.zeros(0, np.int64)
        best = np.nanmin(np.where(priced, c, np.nan))
        idx = np.flatnonzero(priced & (c == best))
    else:
        raise ValueError(f"unknown frontier objective {objective!r}")
    c_eff = np.where(np.isnan(c), np.inf, c)
    order = np.lexsort((idx, c_eff[idx], t[idx]))
    return idx[order].astype(np.int64)


def thin_indices(ordered: Sequence[int], cap: int) -> np.ndarray:
    """Cap a frontier at ``cap`` points, keeping its shape.

    ``ordered`` is a frontier already in (time asc, ...) order (the
    output of :func:`frontier_indices`); thinning keeps both endpoints
    (the fastest and the cheapest survivor) and evenly-spaced interior
    points, so a capped frontier still spans the same trade-off range
    instead of clustering at one end.  Deterministic — pure index
    arithmetic, no RNG."""
    ordered = np.asarray(ordered, np.int64).reshape(-1)
    if cap <= 0:
        raise ValueError(f"frontier cap must be positive (got {cap})")
    if ordered.size <= cap:
        return ordered
    if cap == 1:
        return ordered[:1]
    pick = np.round(np.linspace(0, ordered.size - 1, cap)).astype(np.int64)
    return ordered[np.unique(pick)]
