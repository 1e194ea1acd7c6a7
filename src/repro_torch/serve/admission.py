"""Admission control for the serving front door: priced backpressure.

A copy of ``repro.serve.admission``: the same lanes, budgets and
environment seeds, in the same engine seconds, with one rule the
reference lacks: a bulk request that finds no other bulk request in
flight skips the bulk lane's share check (the global ``max_inflight_s``
budget and the ``max_queue`` bound still apply).  Without it a sweep
priced above the bulk share alone is refused forever, each refusal with
a ``Retry-After`` that promises room: the pass model is fitted from
measured passes, and on the card a pass's wall time under a burst is
mostly host work contending for the interpreter lock, so single sweeps
came to be priced above the share (an 8-trace sweep at 2.02 s against
2.0, refused for 60 s).  A request priced above the whole budget is
refused, as in the reference.

The coalescing service can *batch* arbitrary concurrency, but it cannot
make an overloaded worker faster — under sustained overload the pending
queue grows without bound and every request's latency diverges together.
This module is the missing policy layer: **refuse or defer work the
worker cannot afford**, so admitted requests keep a bounded latency and
goodput stays near capacity instead of collapsing.

The controller prices each request in *estimated engine seconds* using
the same union/split cost model the service already fits from measured
engine passes (``PredictionService._pass_model``): a request over T
traces x D devices costs roughly ``pass_overhead + warm_discount * ops *
D * cell_cost``.  Admission then enforces two budgets under one lock:

* ``max_queue`` — a hard cap on admitted-but-unfinished requests.  Hit
  it and the answer is **503** (the worker is saturated; retry elsewhere
  or later).
* ``max_inflight_s`` — a soft cap on the summed estimated cost of
  admitted work.  Hit it and the answer is **429** with a
  ``Retry-After`` hint sized to the excess (the backlog drains at
  roughly one estimated-second per wall second).

Priority lanes: interactive ``/rank`` traffic ("interactive") may spend
the whole cost budget; bulk ``/sweep`` traffic ("bulk") is capped at
``bulk_share`` of it, so a flood of batch sweeps sheds *first* and can
never starve interactive ranking.  Within a lane admission is FIFO by
arrival — there is no reordering, only refusal.

Contracts:

* **Thread-safety** — every counter mutation and read happens under the
  controller's lock; ``stats()`` snapshots are never torn.  The
  controller is shared by the asyncio front end (``serve/aserver.py``),
  the threaded front end (``serve/http.py``), and any in-process caller
  of ``PredictionService.rank_request``/``sweep_request``.
* **Conservation** — every admitted :class:`Ticket` must be released
  exactly once (``release`` is idempotent per ticket); the service's
  wire-format entry points release in ``finally``, so an engine error
  cannot leak in-flight budget.
* **Kill switch** — ``enabled=False`` admits everything but keeps full
  accounting, so ``/stats`` keeps its shape and operators can observe
  what *would* have been shed before turning enforcement on.

Knobs (see ``docs/knobs.md``): ``REPRO_ADMIT_MAX_QUEUE``,
``REPRO_ADMIT_MAX_INFLIGHT_S``, ``REPRO_ADMIT_BULK_SHARE``, and the
``enabled`` kwarg.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, Iterator, Optional

from repro_torch.core.batched import env_float, env_int

__all__ = ["AdmissionController", "AdmissionError", "DeadlineExceeded",
           "Ticket", "LANES", "deadline_scope", "remaining_s",
           "current_deadline"]

#: the two priority lanes: interactive rank queries vs bulk sweeps
LANES = ("interactive", "bulk")


class AdmissionError(RuntimeError):
    """A request the controller refused to admit.

    Transports translate this to an HTTP response: ``status`` is 429
    (cost budget exhausted — back off briefly) or 503 (queue hard-full —
    the worker is saturated), and ``retry_after_s`` becomes the
    ``Retry-After`` header, sized to the estimated drain time of the
    excess backlog."""

    def __init__(self, status: int, retry_after_s: float, reason: str,
                 lane: str):
        super().__init__(f"{status}: {reason} (lane={lane}, "
                         f"retry after {retry_after_s:.2f}s)")
        self.status = int(status)
        self.retry_after_s = float(retry_after_s)
        self.reason = reason
        self.lane = lane


class DeadlineExceeded(AdmissionError):
    """A request whose end-to-end deadline cannot be (or was not) met.

    Raised in two places: at admission, when the projected engine cost
    already exceeds the remaining budget (shedding instantly is kinder
    than queueing work the caller will never read), and at delivery,
    when a pending query's deadline lapses before its batch completes.
    Transports translate it to **504** with no useful ``Retry-After``
    (the caller's budget, not our load, is the constraint)."""

    def __init__(self, reason: str, lane: str = "interactive",
                 remaining_s: float = 0.0):
        super().__init__(504, 0.0, reason, lane)
        self.remaining_s = float(remaining_s)


# -- deadline scope ----------------------------------------------------------
# The remaining budget of the request currently being served, carried in
# thread-local storage so deep layers (netcache socket timeouts, router
# forwards) can derive their timeouts from it without threading a
# parameter through every call signature.  A scope stores the *absolute*
# ``time.monotonic()`` deadline; ``remaining_s`` converts to a budget.

_scope = threading.local()


@contextlib.contextmanager
def deadline_scope(deadline: Optional[float]) -> Iterator[None]:
    """Bind an absolute monotonic ``deadline`` for the enclosed work.

    ``None`` means unbounded.  Scopes nest; the innermost wins (callers
    binding a looser deadline inside a tighter one keep the tighter one
    because leaders bind the *minimum* across batch members)."""
    prev = getattr(_scope, "deadline", None)
    _scope.deadline = deadline if prev is None else (
        prev if deadline is None else min(prev, deadline))
    try:
        yield
    finally:
        _scope.deadline = prev


def current_deadline() -> Optional[float]:
    """The innermost bound absolute deadline, or ``None``."""
    return getattr(_scope, "deadline", None)


def remaining_s(default: Optional[float] = None) -> Optional[float]:
    """Seconds left in the current deadline scope.

    Returns ``default`` when no deadline is bound; returns 0.0 (never
    negative) when the deadline already lapsed, so callers can use the
    value directly as a socket timeout."""
    deadline = getattr(_scope, "deadline", None)
    if deadline is None:
        return default
    return max(deadline - time.monotonic(), 0.0)


@dataclasses.dataclass
class Ticket:
    """One admitted request's budget reservation (release exactly once)."""
    lane: str
    cost_s: float
    released: bool = False


class AdmissionController:
    """Cost-priced admission with priority lanes (see module docstring).

    Parameters
    ----------
    enabled:
        ``False`` admits everything but keeps counting — the kill switch
        (and the observe-before-enforce mode).
    max_queue:
        Hard cap on admitted-but-unfinished requests; beyond it requests
        are shed with 503.  Default ``REPRO_ADMIT_MAX_QUEUE`` (256).
    max_inflight_s:
        Soft cap on summed estimated cost (engine-seconds) of admitted
        work; beyond it requests are shed with 429 + Retry-After.
        Default ``REPRO_ADMIT_MAX_INFLIGHT_S`` (4.0).
    bulk_share:
        Fraction of ``max_inflight_s`` the bulk lane may occupy, clamped
        to [0, 1].  Default ``REPRO_ADMIT_BULK_SHARE`` (0.5).
    """

    def __init__(self, enabled: bool = True,
                 max_queue: Optional[int] = None,
                 max_inflight_s: Optional[float] = None,
                 bulk_share: Optional[float] = None):
        self.enabled = bool(enabled)
        self.max_queue = (env_int("REPRO_ADMIT_MAX_QUEUE", 256)
                          if max_queue is None else int(max_queue))
        self.max_inflight_s = (env_float("REPRO_ADMIT_MAX_INFLIGHT_S", 4.0)
                               if max_inflight_s is None
                               else float(max_inflight_s))
        share = (env_float("REPRO_ADMIT_BULK_SHARE", 0.5)
                 if bulk_share is None else float(bulk_share))
        self.bulk_share = min(max(share, 0.0), 1.0)
        self._lock = threading.Lock()
        self._inflight_requests = 0
        self._inflight_cost_s = 0.0
        self._lane_cost_s = {lane: 0.0 for lane in LANES}
        self._lane_requests = {lane: 0 for lane in LANES}
        self._admitted = {lane: 0 for lane in LANES}
        self._shed = {lane: 0 for lane in LANES}
        self._shed_429 = 0
        self._shed_503 = 0
        self._shed_504 = 0

    # -- admission ----------------------------------------------------------
    def admit(self, lane: str, cost_s: float) -> Ticket:
        """Reserve budget for one request or raise :class:`AdmissionError`.

        The decision and the reservation are one critical section, so two
        racing requests can never both squeeze into the last slot.  The
        returned ticket MUST be released (``release``) when the request
        finishes — success or error."""
        if lane not in LANES:
            raise ValueError(f"unknown admission lane {lane!r} "
                             f"(expected one of {LANES})")
        cost_s = max(float(cost_s), 0.0)
        with self._lock:
            if self.enabled:
                self._check_locked(lane, cost_s)
            self._admitted[lane] += 1
            self._lane_requests[lane] += 1
            self._inflight_requests += 1
            self._inflight_cost_s += cost_s
            self._lane_cost_s[lane] += cost_s
        return Ticket(lane=lane, cost_s=cost_s)

    def _check_locked(self, lane: str, cost_s: float) -> None:
        """Shed decision (caller holds the lock; raises to refuse)."""
        if self._inflight_requests >= self.max_queue:
            self._shed[lane] += 1
            self._shed_503 += 1
            raise AdmissionError(
                503, self._clamp_retry(self._inflight_cost_s),
                f"admission queue full ({self._inflight_requests} in "
                f"flight >= max_queue={self.max_queue})", lane)
        projected = self._inflight_cost_s + cost_s
        if lane == "bulk" and self._lane_requests["bulk"]:
            # an idle bulk lane skips its share: a sweep priced above the
            # share alone still runs once nothing else of its lane does
            bulk_budget = self.bulk_share * self.max_inflight_s
            bulk_projected = self._lane_cost_s["bulk"] + cost_s
            if bulk_projected > bulk_budget:
                self._shed[lane] += 1
                self._shed_429 += 1
                raise AdmissionError(
                    429, self._clamp_retry(bulk_projected - bulk_budget),
                    f"bulk lane over its cost share "
                    f"({bulk_projected:.3f}s > {bulk_budget:.3f}s)", lane)
        if projected > self.max_inflight_s:
            self._shed[lane] += 1
            self._shed_429 += 1
            raise AdmissionError(
                429, self._clamp_retry(projected - self.max_inflight_s),
                f"in-flight cost budget exhausted "
                f"({projected:.3f}s > {self.max_inflight_s:.3f}s)", lane)

    def record_deadline_shed(self, lane: str) -> None:
        """Count a request shed (or cancelled) for deadline reasons.

        Deadline sheds are *not* load sheds — they happen at any load
        when the caller's budget is tighter than one engine pass — so
        they get their own counter instead of inflating ``shed_429``."""
        with self._lock:
            self._shed[lane] = self._shed.get(lane, 0) + 1
            self._shed_504 += 1

    @staticmethod
    def _clamp_retry(excess_s: float) -> float:
        """Retry-After hint: the excess backlog's drain time, clamped so
        clients neither hammer (floor 50 ms) nor give up (cap 30 s)."""
        return min(max(float(excess_s), 0.05), 30.0)

    def release(self, ticket: Ticket) -> None:
        """Return an admitted request's reservation (idempotent per
        ticket, so a ``finally`` that races an error path is safe)."""
        with self._lock:
            if ticket.released:
                return
            ticket.released = True
            self._inflight_requests = max(self._inflight_requests - 1, 0)
            self._lane_requests[ticket.lane] = max(
                self._lane_requests[ticket.lane] - 1, 0)
            self._inflight_cost_s = max(
                self._inflight_cost_s - ticket.cost_s, 0.0)
            self._lane_cost_s[ticket.lane] = max(
                self._lane_cost_s[ticket.lane] - ticket.cost_s, 0.0)

    # -- accounting ---------------------------------------------------------
    def stats(self) -> Dict:
        """Snapshot of limits + counters (the ``/stats`` admission block)."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "max_queue": self.max_queue,
                "max_inflight_s": self.max_inflight_s,
                "bulk_share": self.bulk_share,
                "inflight_requests": self._inflight_requests,
                "inflight_cost_s": round(self._inflight_cost_s, 6),
                "admitted": dict(self._admitted),
                "shed": dict(self._shed),
                "shed_429": self._shed_429,
                "shed_503": self._shed_503,
                "shed_504": self._shed_504,
            }
