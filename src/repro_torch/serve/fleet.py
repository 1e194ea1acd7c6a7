"""Fleet planning: "rank every device you could buy" as a query.

The port of ``repro.serve.fleet``.  ``FleetPlanner`` wraps the vectorized
prediction engine (:mod:`repro_torch.core.batched`) behind the serving
question of the paper's case studies (Sec. 5.3): given one measured
trace, predict the iteration time on every registered device and rank
the fleet by throughput or by cost-normalized throughput;
:meth:`FleetPlanner.sweep` asks it for many traces at once through the
ragged engine.  Results are memoized per (trace fingerprint, device,
predictor config, fleet token); repeated queries only pay for the
(trace, device) cells not yet seen, which a cell-masked sweep fills.
The fleet token hashes the fleet's membership and member specs, so
swapping ``planner.fleet`` never serves entries minted under the old one.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import cost as cost_mod
from repro_torch.core import devices
from repro_torch.core.trace import TrackedTrace
from repro_torch.serve.cache import BackendLike, CacheStats, make_backend

__all__ = ["CacheStats", "FleetChoice", "FleetPlanner", "format_fleet",
           "format_sweep", "rank_rows"]


@dataclasses.dataclass(frozen=True)
class FleetChoice:
    """One ranked row of a fleet query (mirrors ``cost.DeviceChoice``)."""
    device: str
    iter_ms: float
    throughput: float
    cost_per_hour: Optional[float]
    cost_normalized: Optional[float]
    speedup_vs_origin: float


def rank_rows(times: Dict[str, float], batch_size: int, origin_ms: float,
              by: str = "throughput") -> List["FleetChoice"]:
    """Turn a ``{device: iter_ms}`` row into a ranked fleet.

    The ONE ranking spelling of :meth:`FleetPlanner.rank` (and of the
    serving layer above it, so both answer bitwise-identically).  ``by`` is "throughput" (speed) or "cost"
    (samples/$); devices with no rental price rank last under "cost".
    A price of **0.0 is a real price** (free tier / already-owned
    hardware): its samples/$ is ``inf`` and it ranks first — only
    ``None`` means "not rentable" and ranks last."""
    if by not in ("throughput", "cost"):
        raise ValueError(f"unknown ranking objective {by!r}")
    rows = []
    for name, ms in times.items():
        spec = devices.get(name)
        tput = cost_mod.throughput(batch_size, ms)
        cn = (cost_mod.cost_normalized_throughput(
                  batch_size, ms, spec.cost_per_hour)
              if spec.cost_per_hour is not None else None)
        rows.append(FleetChoice(
            device=name, iter_ms=ms, throughput=tput,
            cost_per_hour=spec.cost_per_hour, cost_normalized=cn,
            speedup_vs_origin=origin_ms / ms))
    if by == "cost":
        # secondary key (device name) makes equal-score ordering stable
        rows.sort(key=lambda c: (-(c.cost_normalized or 0.0), c.device))
    else:
        rows.sort(key=lambda c: (-c.throughput, c.device))
    return rows


class FleetPlanner:
    """Answer fleet queries with a cached vectorized predictor.

    ``predictor`` is any object exposing ``predict_fleet(trace, dests)``
    and ``config_key()`` (all predictors in :mod:`repro_torch.core.predictor`
    do); ``fleet`` defaults to every registered device.  ``cache``
    accepts anything :func:`repro_torch.serve.cache.make_backend` does: None
    (fresh in-process LRU of ``cache_size`` entries), a sqlite path, a
    ``tcp://`` network cache or a ready backend instance —
    ``engine_passes`` counts how many times the underlying engine
    actually ran (one per predict/sweep call with any cache miss)."""

    def __init__(self, predictor=None, fleet: Optional[Sequence[str]] = None,
                 cache_size: int = 4096, cache: BackendLike = None,
                 cell_fill: bool = True):
        if predictor is None:
            from repro_torch.core.predictor import HabitatPredictor
            predictor = HabitatPredictor()
        self.predictor = predictor
        self.cache_size = cache_size
        self.cache = make_backend(cache, cache_size)
        self.engine_passes = 0
        #: cell-level partial-compute sweeps: pass the cold-cell mask down
        #: to ``predict_sweep`` so warm (trace, device) cells never hit
        #: wave scaling or the MLP scorer again.  ``False`` recomputes the
        #: whole rectangle of missing traces x devices (kill switch);
        #: predictors whose ``predict_sweep`` lacks ``cell_mask`` fall
        #: back to the rectangle automatically.
        self.cell_fill = cell_fill
        self._cell_mask_ok = self._supports_cell_mask(predictor)
        self._lock = threading.Lock()   # before the fleet setter needs it
        self.fleet = (sorted(devices.all_devices()) if fleet is None
                      else list(fleet))

    @staticmethod
    def _supports_cell_mask(predictor) -> bool:
        import inspect
        fn = getattr(predictor, "predict_sweep", None)
        if fn is None:
            return False
        try:
            return "cell_mask" in inspect.signature(fn).parameters
        except (TypeError, ValueError):
            return False

    def engine_pass_count(self) -> int:
        """Locked read of the engine-pass counter (for ``stats()``
        snapshots; the attribute itself is only written under
        ``self._lock``)."""
        with self._lock:
            return self.engine_passes

    @property
    def stats(self) -> CacheStats:
        """This planner's cache accounting (per-worker for shared backends)."""
        return self.cache.stats

    @staticmethod
    def engine_cache_stats() -> Dict[str, Dict]:
        """Hit/miss/byte counters of the engine-level caches.

        The stack cache and the cross-stack wave-factor cache are
        process-wide (module-level in ``core.batched`` — they serve every
        planner in the process), so this is a static snapshot; each cache
        snapshots its counters under its own lock.  Scorer-dispatch counts
        ride along, so a stats payload shows the dispatch-count model of
        the hot path, not just cache behavior."""
        from repro_torch.core import batched
        return {"stack_cache": batched.STACK_CACHE.stats(),
                "wave_factor_cache": batched.WAVE_FACTOR_CACHE.stats(),
                "scorer_dispatches": batched.SCORER_DISPATCHES.snapshot()}

    # -- fleet -------------------------------------------------------------
    @property
    def fleet(self) -> List[str]:
        return list(self._fleet)

    @fleet.setter
    def fleet(self, names: Sequence[str]) -> None:
        """Swap the fleet; cached entries from the old fleet cannot leak.

        The fleet token — part of every cache key — hashes both membership
        and the member specs as resolved at assignment time, so ``rank()``
        after a fleet change recomputes instead of serving entries minted
        under the old membership."""
        names = list(names)
        specs = [devices.get(n) for n in names]   # fail fast on unknowns
        h = hashlib.sha1()
        for spec in sorted(specs, key=lambda s: s.name):
            h.update(repr(dataclasses.astuple(spec)).encode())
        # both fields under the lock: queries read (_fleet, _fleet_token)
        # inside it and must never observe a torn pair
        with self._lock:
            self._fleet = names
            self._fleet_token = h.hexdigest()[:16]

    # -- cache -------------------------------------------------------------
    @staticmethod
    def _key(fingerprint: str, device: str, config_key: Tuple,
             fleet_token: str) -> Tuple:
        # fleet_token is a per-query SNAPSHOT taken together with the
        # destination list: a concurrent fleet swap mid-query must not mix
        # old-fleet devices with the new token (or vice versa)
        return (fingerprint, device, config_key, fleet_token)

    def _query_fleet(self, dests: Optional[Sequence[str]]
                     ) -> Tuple[List[str], str]:
        """Atomically resolve (destination list, fleet token) for a query."""
        with self._lock:
            return (list(self._fleet) if dests is None else list(dests),
                    self._fleet_token)

    def _probe_many(self, keys: Sequence[Tuple]) -> List[Optional[float]]:
        """Backend hit-or-miss with stats accounting, one round-trip per
        query rather than per cell.

        The ONE lookup used by both predict() and sweep(), so their
        hit/miss semantics cannot drift (falls back to per-key ``get``
        for backends without ``get_many`` — accounting is identical
        either way).  A backend that *raises* — a network cache whose
        retry/degradation layer is itself broken, a corrupt sqlite file —
        degrades to compute-as-miss: the query is answered from the
        engine and the outage is visible as ``stats.degraded``, never as
        a failed request batch."""
        get_many = getattr(self.cache, "get_many", None)
        try:
            if get_many is not None:
                return list(get_many(keys))
            return [self.cache.get(k) for k in keys]
        except Exception:
            self._count_degraded(misses=len(keys))
            return [None] * len(keys)

    def _store(self, items: Sequence[Tuple[Tuple, float]]) -> None:
        """Insert computed cells (backend evicts LRU overflow).

        The ONE write path shared by predict() and sweep(); counts one
        engine pass, since every store follows exactly one engine call.
        A failing backend drops the fill (the answers are already
        computed) and bumps ``stats.degraded`` — an outage costs cache
        warmth, never correctness."""
        with self._lock:
            self.engine_passes += 1
        try:
            self.cache.put_many(items)
        except Exception:
            self._count_degraded()

    def sweep_cached(self, traces: Sequence[TrackedTrace],
                     dests: Optional[Sequence[str]] = None) -> bool:
        """Whether :meth:`sweep` would answer every cell from the cache,
        read without touching its stats or LRU order (not in the
        reference: the service prices such a request apart).  False for
        a backend that cannot be read so (sqlite, netcache)."""
        contains_many = getattr(self.cache, "contains_many", None)
        if contains_many is None:
            return False
        dests, token = self._query_fleet(dests)
        ck = getattr(self.predictor, "sweep_config_key",
                     self.predictor.config_key)()
        return all(contains_many([self._key(t.fingerprint(), name, ck, token)
                                  for t in traces for name in dests]))

    def _count_degraded(self, misses: int = 0) -> None:
        """Record a backend failure on the backend's own stats object
        (where ``planner.stats`` reads from), defensively — a backend
        broken enough to raise may have broken accounting too."""
        try:
            self.cache.stats.degraded += 1
            self.cache.stats.misses += misses
        except Exception:
            pass

    def clear_cache(self) -> None:
        """Reset cached results, stats, and the engine-pass counter."""
        self.cache.clear()
        with self._lock:
            self.engine_passes = 0

    # -- queries -----------------------------------------------------------
    def predict(self, trace: TrackedTrace,
                dests: Optional[Sequence[str]] = None) -> Dict[str, float]:
        """Predicted iteration time (ms) per destination device.

        Cached devices are served from the LRU; the remainder is computed
        in ONE vectorized ``predict_fleet`` call."""
        dests, token = self._query_fleet(dests)
        fp = trace.fingerprint()
        ck = self.predictor.config_key()
        out: Dict[str, float] = {}
        missing: List[str] = []
        probes = self._probe_many([self._key(fp, name, ck, token)
                                   for name in dests])
        for name, ms in zip(dests, probes):
            if ms is not None:
                out[name] = ms
            else:
                missing.append(name)
        if missing:
            fleet = self.predictor.predict_fleet(trace, missing)
            totals = fleet.total_ms
            for name, ms in zip(fleet.dests, totals):
                out[name] = float(ms)
            self._store([(self._key(fp, name, ck, token), out[name])
                         for name in fleet.dests])
        return {name: out[name] for name in dests}

    def sweep(self, traces: Sequence[TrackedTrace],
              dests: Optional[Sequence[str]] = None
              ) -> List[Dict[str, float]]:
        """Multi-trace what-if sweep: iteration time per (trace, device).

        Cached (trace fingerprint, device) cells are served from the LRU;
        every remaining cell is computed in ONE ragged ``predict_sweep``
        pass over the traces that still miss devices.  Returns one
        ``{device: ms}`` dict per input trace, in input order.

        Cache stability: a cell is computed once and then served, so it
        never churns within one key.  Recomputed totals agree to float
        tolerance (the device's segment sums may add in another order;
        trained-MLP cells depend on the co-batch's float32 products), and
        MLP cells live under a sweep-tagged config key so they never
        alias ``predict()``'s per-trace entries."""
        traces = list(traces)
        dests, token = self._query_fleet(dests)
        # sweep results live under the predictor's sweep identity: equal to
        # config_key() when the sweep path reproduces predict_fleet
        # exactly, tagged apart when a fused scorer makes it only
        # tolerance-close (predict() cells must never alias those)
        ck = getattr(self.predictor, "sweep_config_key",
                     self.predictor.config_key)()
        fps = [t.fingerprint() for t in traces]
        out: List[Dict[str, float]] = [{} for _ in traces]
        missing: Dict[int, List[str]] = {}
        probes = self._probe_many([self._key(fp, name, ck, token)
                                   for fp in fps for name in dests])
        it = iter(probes)
        for i in range(len(fps)):
            for name in dests:
                ms = next(it)
                if ms is not None:
                    out[i][name] = ms
                else:
                    missing.setdefault(i, []).append(name)
        if missing:
            # one ragged pass: [traces with any miss] x [union of missed
            # devices].  With cell-level fills (the default) a cold-cell
            # mask rides along, so warm cells of that rectangle are NOT
            # recomputed — they stay NaN in the engine grid and keep their
            # served values; without mask support the full rectangle is
            # priced and the warm byproducts are simply dropped.  Either
            # way hit accounting stays truthful and cached values never
            # churn within one key.
            run = sorted(missing)
            miss_sets = {i: set(missing[i]) for i in run}
            union: List[str] = [d for d in dests
                                if any(d in miss_sets[i] for i in run)]
            mask: Optional[np.ndarray] = None
            if self.cell_fill and self._cell_mask_ok:
                col = {name: j for j, name in enumerate(union)}
                mask = np.zeros((len(run), len(union)), bool)
                for row, i in enumerate(run):
                    for name in miss_sets[i]:
                        mask[row, col[name]] = True
                if mask.all():
                    mask = None     # cold rectangle: full grid is faster
            totals = self._sweep_totals([traces[i] for i in run], union,
                                        cell_mask=mask)
            items: List[Tuple[Tuple, float]] = []
            for row, i in enumerate(run):
                vals = totals[row].tolist()   # C-level float conversion
                if len(miss_sets[i]) == len(union) == len(dests):
                    # fast path: the whole row was missing (cold sweep)
                    out[i] = dict(zip(dests, vals))
                    items.extend((self._key(fps[i], name, ck, token), ms)
                                 for name, ms in zip(dests, vals))
                    continue
                for j, name in enumerate(union):
                    if name in miss_sets[i]:
                        ms = vals[j]
                        out[i][name] = ms
                        items.append(
                            (self._key(fps[i], name, ck, token), ms))
            self._store(items)
        # rows built on the hit path or the fast path are already in
        # ``dests`` iteration order; only hit/miss-mixed rows need the
        # reordering rebuild
        mixed = {i for i, names in missing.items()
                 if 0 < len(names) < len(dests)}
        return [{name: row[name] for name in dests} if i in mixed else row
                for i, row in enumerate(out)]

    def _sweep_totals(self, traces: Sequence[TrackedTrace],
                      dests: Sequence[str], cell_mask=None):
        """(n_traces, n_dests) grid via the predictor's ragged engine.

        The documented predictor contract is only ``predict_fleet`` +
        ``config_key``; predictors without a ``predict_sweep`` (all
        in-repo ones have it via ``_FleetTraceMixin``) fall back to one
        fleet grid per trace.  ``cell_mask`` is only ever non-None when
        the predictor advertises support (masked-out totals come back
        NaN and the caller must not read them)."""
        if hasattr(self.predictor, "predict_sweep"):
            if cell_mask is not None:
                return self.predictor.predict_sweep(
                    traces, dests, cell_mask=cell_mask).total_ms
            return self.predictor.predict_sweep(traces, dests).total_ms
        return np.stack([self.predictor.predict_fleet(t, dests).total_ms
                         for t in traces])

    def rank(self, trace: TrackedTrace, batch_size: int,
             dests: Optional[Sequence[str]] = None,
             by: str = "throughput") -> List[FleetChoice]:
        """Ranked fleet: ``by`` is "throughput" (speed) or "cost" ($/sample).

        Devices with no rental price rank last under ``by="cost"``; the
        row math and ordering live in :func:`rank_rows` (shared with the
        serving layer, so both spellings are bitwise-identical)."""
        return rank_rows(self.predict(trace, dests), batch_size,
                         trace.run_time_ms, by)


def format_fleet(choices: Sequence[FleetChoice]) -> str:
    """Human-readable ranking table (same layout as ``cost.format_ranking``)."""
    return cost_mod.format_ranking(choices)


def format_sweep(labels: Sequence[str], times: Sequence[Dict[str, float]],
                 top: int = 5) -> str:
    """Human-readable sweep grid: one row per trace, fastest devices first.

    Columns are the union of each trace's ``top`` fastest devices, so the
    table stays readable even against the full registry."""
    cols: List[str] = []
    for row in times:
        for name in sorted(row, key=row.get)[:top]:
            if name not in cols:
                cols.append(name)
    label_w = max([len("trace")] + [len(lb) for lb in labels])
    col_w = max([10] + [len(c) + 1 for c in cols])
    lines = [" ".join([f"{'trace':<{label_w}}"]
                      + [f"{c:>{col_w}}" for c in cols] + ["   best"])]
    for lb, row in zip(labels, times):
        best = min(row, key=row.get)
        cells = [f"{row[c]:>{col_w}.3f}" if c in row
                 else f"{'-':>{col_w}}" for c in cols]
        lines.append(" ".join([f"{lb:<{label_w}}"] + cells
                              + [f"   {best}"]))
    return "\n".join(lines)
