"""What-if optimizer: generation-batched Pareto search over the sweep

A copy of ``repro.serve.optimizer`` over the port's ``core/cost.py``,
``core/devices.py`` and ``core/frontier.py``: with the same seed it walks
the same candidates, and its frontier agrees with the reference's to
float rounding (the engines sum in different orders).

engine.

The paper answers "how fast would this job run on device X?"; the
purchasing question users actually have is "given a $/hour budget,
**which fleet should I run**?".  :class:`WhatIfOptimizer` searches
candidate configurations — (device type, replica count, per-device batch
size) triples — for the Pareto frontier of epoch time vs fleet $/hour,
with the existing union-grid sweep engine as its inner loop.

The headline is the *performance architecture* of the search, not the
search itself:

* **Generation batching** — every generation collects the (trace,
  device) cells its surviving candidates need, dedupes them across
  candidates (candidates overlap heavily: all replica counts of one
  device share one cell, many candidates share a trace), and fetches
  the lot in **one** ``sweep`` through the
  :class:`~repro_torch.serve.service.PredictionService` coalescer — so a
  200-candidate search costs a handful of engine passes, never one per
  candidate.  ``tests/test_torch_service.py`` counter-asserts engine
  passes <= generations.
* **Cache-tier compounding** — generation *k*'s pass warms the result
  cache, the ragged ``STACK_CACHE``, and the cross-stack
  ``WAVE_FACTOR_CACHE`` for exactly the cells generation *k+1* mutates
  around, so successive generations are nearly free; this is the first
  compound workload that exercises every cache tier in one request.
* **Dominance pruning** — vectorized frontier math
  (:mod:`repro_torch.core.frontier`) shrinks each generation to at most
  ``frontier_cap`` survivors *before* their mutants are priced against
  the engine.  Devices with no rental price (``cost_per_hour=None`` ->
  NaN) are kept on the time-only frontier and excluded from the
  $-frontier explicitly — NaN comparisons never silently drop or
  mis-rank a candidate.

Candidate model (deliberately the standard data-parallel throughput
model — the engine predicts per-device iteration time, everything else
is closed-form): a candidate runs ``replicas`` copies of one device,
each stepping the trace measured at ``batch_size``; fleet throughput is
``replicas * batch_size / iter_ms``, epoch time is ``epoch_samples /
throughput``, fleet cost is ``replicas * cost_per_hour``.  Replica
counts are powers of two up to ``max_replicas``.  Objectives scale
monotonically with throughput, so the frontier is invariant to
``epoch_samples``.

Determinism: the search RNG is seeded (``seed``), candidate sets are
iterated in insertion order, and the frontier order is the
deterministic (time, cost, index) sort from ``core.frontier`` — the
same request always returns the same bytes, and every candidate's
``iter_ms`` is bitwise-equal to a direct ``FleetPlanner.sweep`` of that
candidate (pinned by ``tests/test_torch_service.py``).

Env knobs (docs/knobs.md): ``REPRO_OPT_GENERATION_SIZE``,
``REPRO_OPT_MAX_GENERATIONS``, ``REPRO_OPT_FRONTIER_CAP``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import cost as cost_mod
from repro_torch.core import devices
from repro_torch.core import frontier as frontier_mod
from repro_torch.core.batched import env_int
from repro_torch.core.trace import TrackedTrace

__all__ = ["FleetConfig", "OptimizeResult", "WhatIfOptimizer",
           "encode_optimize", "format_frontier"]

#: hard ceilings on wire-tunable search knobs: admission prices the cell
#: rectangle, not the generation loop, so the loop itself must be
#: bounded against absurd requests
_MAX_GENERATIONS = 256
_MAX_GENERATION_SIZE = 4096
_MAX_REPLICAS = 4096

#: a candidate's identity: (trace index, device index, replica count)
_Key = Tuple[int, int, int]


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """One evaluated candidate configuration (a row of the search)."""
    device: str
    replicas: int
    batch_size: int
    trace_idx: int              # which input trace (batch-size variant)
    label: str                  # that trace's label
    iter_ms: float              # engine-predicted per-device iteration
    time_s: float               # epoch_samples / fleet throughput
    samples_per_s: float        # fleet throughput
    cost_per_hour: Optional[float]   # replicas * device $/hr; None if
    # the device is not rentable (kept on the time-only frontier)


@dataclasses.dataclass
class OptimizeResult:
    """A finished search: the frontier plus its cost accounting."""
    frontier: List[FleetConfig]         # (time asc, cost asc) order
    evaluated: List[FleetConfig]        # every unique candidate priced
    generations: int                    # evaluation rounds run
    sweeps: int                         # engine sweeps submitted
    candidates: int                     # == len(evaluated)
    cells_priced: int                   # unique (trace, device) cells
    # learned from the engine across all generations
    cells_deduped: int                  # candidate cell references
    # served without engine work (cross-candidate + cross-generation)
    converged: bool                     # mutation pool drained early


class WhatIfOptimizer:
    """One Pareto search over (device, replicas, batch size) candidates.

    ``service`` is anything with ``sweep(traces, dests=...) ->
    [{device: ms}, ...]`` — a :class:`PredictionService` (the production
    spelling: generations ride the coalescer and can share engine
    passes with concurrent traffic) or a bare
    :class:`~repro_torch.serve.fleet.FleetPlanner` (tests, scripts).

    ``traces`` are the workload measured at each candidate per-device
    batch size; ``batch_sizes[i]`` is the global batch a replica of
    ``traces[i]`` steps.  ``dests`` defaults to the planner fleet.
    """

    def __init__(self, service, traces: Sequence[TrackedTrace],
                 batch_sizes: Sequence[int],
                 dests: Optional[Sequence[str]] = None, *,
                 epoch_samples: float = 1e6,
                 max_replicas: int = 8,
                 generation_size: Optional[int] = None,
                 max_generations: Optional[int] = None,
                 frontier_cap: Optional[int] = None,
                 seed: int = 0):
        self.service = service
        self.traces = list(traces)
        self.batch_sizes = [int(b) for b in batch_sizes]
        if not self.traces:
            raise ValueError("optimize needs at least one trace")
        if len(self.batch_sizes) != len(self.traces):
            raise ValueError(
                f"batch_sizes ({len(self.batch_sizes)}) must align with "
                f"traces ({len(self.traces)})")
        if any(b <= 0 for b in self.batch_sizes):
            raise ValueError("batch sizes must be positive")
        if dests is None:
            dests = service.planner.fleet if hasattr(service, "planner") \
                else sorted(devices.all_devices())
        self.dests = list(dests)
        self._specs = [devices.get(n) for n in self.dests]  # fail fast
        if not self.dests:
            raise ValueError("optimize needs at least one device")
        self.epoch_samples = float(epoch_samples)
        if not self.epoch_samples > 0:
            raise ValueError("epoch_samples must be positive")
        self.max_replicas = self._bounded(
            "max_replicas", int(max_replicas), _MAX_REPLICAS)
        self.generation_size = self._bounded(
            "generation_size",
            env_int("REPRO_OPT_GENERATION_SIZE", 64)
            if generation_size is None else int(generation_size),
            _MAX_GENERATION_SIZE)
        self.max_generations = self._bounded(
            "max_generations",
            env_int("REPRO_OPT_MAX_GENERATIONS", 8)
            if max_generations is None else int(max_generations),
            _MAX_GENERATIONS)
        self.frontier_cap = self._bounded(
            "frontier_cap",
            env_int("REPRO_OPT_FRONTIER_CAP", 24)
            if frontier_cap is None else int(frontier_cap), 4096)
        #: power-of-two replica ladder the search climbs
        self.replica_levels = []
        r = 1
        while r <= self.max_replicas:
            self.replica_levels.append(r)
            r *= 2
        self._rng = np.random.default_rng(int(seed))
        self._cells: Dict[Tuple[int, int], float] = {}   # (ti, di) -> ms
        self._evaluated: Dict[_Key, FleetConfig] = {}
        self._sweeps = 0
        self._cells_priced = 0
        self._cells_deduped = 0

    @staticmethod
    def _bounded(name: str, value: int, ceiling: int) -> int:
        if not 1 <= value <= ceiling:
            raise ValueError(
                f"{name} must be in [1, {ceiling}] (got {value})")
        return value

    # -- engine access ------------------------------------------------------
    def _ensure_cells(self, keys: Sequence[_Key]) -> None:
        """Fetch every (trace, device) cell ``keys`` needs in ONE sweep.

        Candidates overlap heavily (replica ladders share a cell, many
        candidates share a trace), so the generation's cell set is
        deduped first; cells already learned — by an earlier generation,
        or as rectangle byproducts of one — cost nothing.  The sweep
        goes through ``self.service``, i.e. the coalescer when fronted
        by a :class:`PredictionService`: one engine pass per generation
        at most, shared with any concurrent traffic."""
        refs = [(ti, di) for ti, di, _ in keys]
        need = {}
        for cell in refs:
            if cell not in self._cells:
                need[cell] = True
        self._cells_deduped += len(refs) - len(need)
        if not need:
            return
        tis = sorted({ti for ti, _ in need})
        dis = sorted({di for _, di in need})
        union = [self.dests[di] for di in dis]
        rows = self.service.sweep([self.traces[ti] for ti in tis],
                                  dests=union)
        self._sweeps += 1
        # the rectangle may exceed the asked-for cells; its byproducts
        # are free knowledge (the result cache holds them anyway), so
        # keep them — a later generation that mutates onto one pays
        # nothing
        for ti, row in zip(tis, rows):
            for di, name in zip(dis, union):
                if (ti, di) not in self._cells:
                    self._cells_priced += 1
                self._cells[(ti, di)] = float(row[name])

    def _metrics(self, key: _Key) -> FleetConfig:
        ti, di, replicas = key
        spec = self._specs[di]
        iter_ms = self._cells[(ti, di)]
        batch = self.batch_sizes[ti]
        tput = replicas * cost_mod.throughput(batch, iter_ms)
        cph = (None if spec.cost_per_hour is None
               else replicas * spec.cost_per_hour)
        return FleetConfig(
            device=self.dests[di], replicas=replicas, batch_size=batch,
            trace_idx=ti, label=self.traces[ti].label, iter_ms=iter_ms,
            time_s=self.epoch_samples / tput, samples_per_s=tput,
            cost_per_hour=cph)

    # -- search steps -------------------------------------------------------
    def _initial(self) -> List[_Key]:
        """Generation 1: the replicas=1 grid (or a seeded sample of it)."""
        keys = [(ti, di, 1) for ti in range(len(self.traces))
                for di in range(len(self.dests))]
        return self._cap(keys)

    def _mutants(self, parents: Sequence[_Key]) -> List[_Key]:
        """Neighbors of the surviving frontier + random immigrants."""
        n_tr, n_dev = len(self.traces), len(self.dests)
        out: Dict[_Key, bool] = {}

        def add(ti: int, di: int, r: int) -> None:
            if 0 <= ti < n_tr and 0 <= di < n_dev \
                    and 1 <= r <= self.max_replicas:
                out[(ti, di, r)] = True

        parents = list(parents)
        # one vectorized draw per mutation class, not one rng call per
        # mutant — the mutation loop runs every generation and must stay
        # invisible next to the engine pass it feeds
        jumps = self._rng.integers(n_dev, size=(len(parents), 2)) \
            if parents else np.zeros((0, 2), int)
        for pi, (ti, di, r) in enumerate(parents):
            add(ti, di, r * 2)          # scale the fleet out / in
            add(ti, di, r // 2)
            add(ti - 1, di, r)          # adjacent batch-size variant
            add(ti + 1, di, r)
            add(ti, int(jumps[pi, 0]), r)   # jump to another device type
            add(ti, int(jumps[pi, 1]), r)
        n_imm = max(self.generation_size // 4, 1)   # immigrants
        for ti, di, r in zip(self._rng.integers(n_tr, size=n_imm),
                             self._rng.integers(n_dev, size=n_imm),
                             self._rng.choice(self.replica_levels,
                                              size=n_imm)):
            add(int(ti), int(di), int(r))
        return self._cap([k for k in out if k not in self._evaluated])

    def _cap(self, keys: List[_Key]) -> List[_Key]:
        if len(keys) <= self.generation_size:
            return keys
        pick = self._rng.choice(len(keys), size=self.generation_size,
                                replace=False)
        return [keys[i] for i in sorted(pick)]

    def _prune(self, pool: Sequence[_Key]) -> List[_Key]:
        """Dominance-prune a candidate pool to <= ``frontier_cap`` keys.

        NaN-cost candidates (unrentable devices) ride the time-only
        frontier per the ``core.frontier`` contract; the thinning keeps
        both endpoints so the capped frontier still spans the full
        trade-off range."""
        cfgs = [self._evaluated[k] for k in pool]
        times = np.asarray([c.time_s for c in cfgs], np.float64)
        costs = np.asarray([np.nan if c.cost_per_hour is None
                            else c.cost_per_hour for c in cfgs],
                           np.float64)
        ordered = frontier_mod.frontier_indices(times, costs)
        kept = frontier_mod.thin_indices(ordered, self.frontier_cap)
        return [pool[int(i)] for i in kept]

    def run(self) -> OptimizeResult:
        """Run the search to convergence or ``max_generations``."""
        generations = 0
        frontier_keys: List[_Key] = []
        fresh = self._initial()
        converged = False
        while True:
            self._ensure_cells(fresh)
            for key in fresh:
                self._evaluated[key] = self._metrics(key)
            generations += 1
            pool = list(dict.fromkeys(list(frontier_keys) + list(fresh)))
            frontier_keys = self._prune(pool)
            if generations >= self.max_generations:
                break
            fresh = self._mutants(frontier_keys)
            if not fresh:       # every neighbor already priced: done
                converged = True
                break
        # full-pool final frontier: thinning is a *search* cap, but the
        # reported frontier must be the true non-dominated set over
        # everything the search priced (a thinned-away point is still an
        # answer the user may want)
        all_keys = list(self._evaluated)
        final = self._prune(all_keys) if len(all_keys) else []
        return OptimizeResult(
            frontier=[self._evaluated[k] for k in final],
            evaluated=[self._evaluated[k] for k in all_keys],
            generations=generations, sweeps=self._sweeps,
            candidates=len(self._evaluated),
            cells_priced=self._cells_priced,
            cells_deduped=self._cells_deduped, converged=converged)


# -- wire helpers -----------------------------------------------------------
def encode_optimize(result: OptimizeResult) -> Dict:
    """An ``OptimizeResult`` as its JSON wire document.

    Only the frontier ships (the evaluated list can be hundreds of rows
    and is reconstructible from a replayed search); ``cost_per_hour``
    is ``null`` for unrentable devices.  Strictly RFC-8259-safe: every
    number is finite by construction (times and throughputs derive from
    positive iteration times)."""
    return {
        "frontier": [dataclasses.asdict(c) for c in result.frontier],
        "search": {
            "generations": result.generations,
            "sweeps": result.sweeps,
            "candidates": result.candidates,
            "cells_priced": result.cells_priced,
            "cells_deduped": result.cells_deduped,
            "converged": result.converged,
        },
    }


def format_frontier(result: OptimizeResult) -> str:
    """Human-readable frontier table (fastest first), for the CLI."""
    lines = [f"{'device':<12} {'x':>4} {'batch':>6} {'iter ms':>9} "
             f"{'epoch s':>9} {'$/hr':>8} {'samples/s':>11}"]
    for c in result.frontier:
        cph = f"{c.cost_per_hour:.2f}" if c.cost_per_hour is not None \
            else "-"
        lines.append(
            f"{c.device:<12} {c.replicas:>4} {c.batch_size:>6} "
            f"{c.iter_ms:>9.2f} {c.time_s:>9.1f} {cph:>8} "
            f"{c.samples_per_s:>11.1f}")
    lines.append(
        f"[{result.candidates} candidates / {result.generations} "
        f"generations / {result.sweeps} engine sweeps; "
        f"{result.cells_priced} cells priced, "
        f"{result.cells_deduped} deduped]")
    return "\n".join(lines)
