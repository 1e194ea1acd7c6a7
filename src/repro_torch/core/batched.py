"""Vectorized fleet-prediction engine on torch tensors: traces x devices.

The port of ``repro.core.batched``.  The serving question Habitat answers
is "from the one device you own, rank every device you could buy"
(Sec. 5.3): one trace, or a stack of traces, predicted against dozens of
destinations per request.  The pipeline is array-shaped and runs on the
predictor's torch device:

  * kernel-alike ops   -> wave scaling fills the (n_ops x n_devices) grid
                          in one float64 tensor expression
                          (``wave_scaling.wave_factor_vec``), with the
                          t-independent factor cached across requests;
  * kernel-varying ops -> MLP rows (float32) built on the device from the
                          op and device features, scored either by one
                          per-kind forward each or by ONE launch of the
                          fused scorer (:class:`FusedMLPScorer`, the
                          Hopper kernels on sm_90), falling back to a
                          vectorized Paleo-style roofline for kinds
                          without an MLP.

Host numpy keeps what identifies a trace (fingerprints, the stacked
arrays the caches key on) and the row/cell index bookkeeping; only the
per-trace totals come back to the host, at the end.

:func:`stack_traces` concatenates traces into a :class:`RaggedTraceArrays`
(segment offsets over one structure of arrays); :func:`predict_sweep`
fills the whole (total_ops x n_devices) grid in one pass, or only the
cells of a ``cell_mask`` (the planner's cache-cold cells).
"""

from __future__ import annotations

import dataclasses
import os
import threading
from collections import OrderedDict
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import devices, wave_scaling
from repro_torch.core import mlp as mlp_mod
from repro_torch.core.devices import DeviceArrays, DeviceSpec
from repro_torch.core.trace import TraceArrays, TrackedTrace
from repro_torch.kernels import fused_mlp_score as fms

#: Paleo-fallback efficiencies, matching ``predictor._analytical_ms``.
_EFF_COMPUTE = (0.50, 0.70)   # (kernel-alike, kernel-varying)
_EFF_MEMORY = (0.82, 0.75)

F64 = torch.float64


def _env_num(name: str, default, cast):
    """A numeric knob from the environment, falling back on bad input
    (a malformed or negative override keeps the documented default)."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        value = cast(raw)
    except ValueError:
        return default
    return value if value >= 0 else default


def env_int(name: str, default: int) -> int:
    return _env_num(name, default, int)


class _DispatchCounters:
    """Process-wide MLP scorer-dispatch accounting.

    ``fused`` counts one-launch scorer calls (``score_ms`` /
    ``score_rows_ms``); ``per_kind`` counts individual per-kind
    ``predict_ms`` forwards."""

    def __init__(self):
        self._lock = threading.Lock()
        self.fused = 0
        self.per_kind = 0

    def bump(self, which: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, which, getattr(self, which) + n)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {"fused": self.fused, "per_kind": self.per_kind}

    def reset(self) -> None:
        with self._lock:
            self.fused = 0
            self.per_kind = 0


#: dispatch accounting for every MLP scoring path (see class docstring)
SCORER_DISPATCHES = _DispatchCounters()


def _tensor_bytes(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


class _WaveFactorCache:
    """Cross-stack LRU of t-independent wave-scaling factor grids.

    Keyed by ``(content token, fleet names, exact, overhead model,
    torch device)``; the content token is the tuple of trace
    fingerprints, so ``predict()`` on one trace and a 1-trace sweep share
    an entry.  A lookup only hits for the *same* ``DeviceArrays``
    instance (``devices.as_arrays`` memoizes one per spec tuple) and
    value-equal origin specs, so a replaced registry entry can never be
    served a stale factor.  Factors are tensors on the keyed device.
    Bounded by entries AND bytes (``REPRO_FACTOR_CACHE_ENTRIES`` /
    ``REPRO_FACTOR_CACHE_BYTES``, defaults 64 / 128 MiB); thread-safe."""

    def __init__(self, capacity: Optional[int] = None,
                 max_bytes: Optional[int] = None):
        self.capacity = (env_int("REPRO_FACTOR_CACHE_ENTRIES", 64)
                         if capacity is None else capacity)
        self.max_bytes = (env_int("REPRO_FACTOR_CACHE_BYTES", 128 << 20)
                          if max_bytes is None else max_bytes)
        self._data: "OrderedDict[Tuple, Tuple]" = OrderedDict()
        self._lock = threading.Lock()
        self._total_bytes = 0
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0

    def get(self, key: Tuple, da: DeviceArrays, origins: Tuple):
        """(factor, overheads) when warm, else None (counted as a miss)."""
        return self._lookup(key, da, origins, count_miss=True)

    def peek(self, key: Tuple, da: DeviceArrays, origins: Tuple):
        """Like :meth:`get`, but a cold probe is not a counted miss
        (masked sweeps probe opportunistically and never insert)."""
        return self._lookup(key, da, origins, count_miss=False)

    def _lookup(self, key, da, origins, count_miss: bool):
        with self._lock:
            entry = self._data.get(key)
            if entry is not None and entry[0] is da and entry[1] == origins:
                self._data.move_to_end(key)
                self.hits += 1
                return entry[2], entry[3]
            if count_miss:
                self.misses += 1
            return None

    def insert(self, key: Tuple, da: DeviceArrays, origins: Tuple,
               factor: torch.Tensor, overheads) -> None:
        nbytes = _tensor_bytes(factor)
        if overheads is not None:
            nbytes += _tensor_bytes(overheads[0]) + _tensor_bytes(overheads[1])
        with self._lock:
            old = self._data.pop(key, None)
            if old is not None:
                self._total_bytes -= old[4]
            self._data[key] = (da, origins, factor, overheads, nbytes)
            self._total_bytes += nbytes
            self.inserts += 1
            while self._data and (len(self._data) > self.capacity
                                  or self._total_bytes > self.max_bytes):
                _, evicted = self._data.popitem(last=False)
                self._total_bytes -= evicted[4]
                self.evictions += 1

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "inserts": self.inserts, "evictions": self.evictions,
                    "entries": len(self._data),
                    "bytes": self._total_bytes,
                    "capacity": self.capacity,
                    "max_bytes": self.max_bytes}

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._total_bytes = 0
            self.hits = self.misses = self.inserts = self.evictions = 0


#: the process-wide cross-stack wave-factor cache (see class docstring)
WAVE_FACTOR_CACHE = _WaveFactorCache()


def _factor_key(content: Tuple, da: DeviceArrays, exact: bool,
                model_overhead: bool, device: torch.device) -> Tuple:
    """The one factor-cache key spelling of the single-trace and ragged
    paths (a 1-trace stack and ``predict()`` share an entry)."""
    return (content, tuple(da.names), exact, model_overhead, str(device))


def _idx(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host row/column indices as a long tensor on ``device``."""
    return torch.as_tensor(np.asarray(rows, np.int64), device=device)


def transform_features(raw: torch.Tensor) -> torch.Tensor:
    """log1p of float32 features (``repro.core.dataset.transform_features``
    on the device)."""
    return torch.log1p(raw.to(torch.float32))


def _roofline_core(flops, bytes_accessed, kernel_varying, peak_flops,
                   mem_bandwidth) -> torch.Tensor:
    """Paleo-style roofline on broadcast-ready float64 tensors (one
    expression for the grid and the flat-cell spellings)."""
    const = lambda v: torch.tensor(v, dtype=F64, device=flops.device)
    eff_c = torch.where(kernel_varying, const(_EFF_COMPUTE[1]),
                        const(_EFF_COMPUTE[0]))
    eff_m = torch.where(kernel_varying, const(_EFF_MEMORY[1]),
                        const(_EFF_MEMORY[0]))
    flops_t = (flops * (1.0 / eff_c)) / peak_flops
    mem_t = (bytes_accessed * (1.0 / eff_m)) / mem_bandwidth
    return torch.maximum(flops_t, mem_t) * 1e3


def analytical_ms_vec(view, dv) -> torch.Tensor:
    """Vectorized Paleo-style roofline estimate, shape (n_ops, n_dev).
    ``view`` holds float64 ``flops``/``bytes_accessed`` and a bool
    ``kernel_varying`` tensor per op."""
    return _roofline_core(view.flops[:, None], view.bytes_accessed[:, None],
                          view.kernel_varying[:, None],
                          dv.peak_flops[None, :], dv.mem_bandwidth[None, :])


def _arrays_view(arrays, device: torch.device) -> SimpleNamespace:
    """The per-op numeric fields of a (Ragged)TraceArrays as tensors."""
    f64 = lambda a: torch.as_tensor(a, dtype=F64, device=device)
    return SimpleNamespace(
        flops=f64(arrays.flops), bytes_accessed=f64(arrays.bytes_accessed),
        intensity=f64(arrays.intensity),
        measured_ms=f64(arrays.measured_ms),
        multiplicity=f64(arrays.multiplicity),
        kernel_varying=torch.as_tensor(arrays.kernel_varying, device=device),
        op_features=f64(arrays.op_features))


class _FeatureBufferPool:
    """Reusable float32 row buffers for the MLP feature grids, per
    (row width, device).  Checkout is exclusive; a released buffer is
    reused by later calls, which queue behind earlier work on the same
    stream."""

    _MAX_FREE = 8               # buffers kept per (width, device)
    _MAX_BYTES = 16 << 20       # never retain one buffer above 16 MiB

    def __init__(self):
        self._free: Dict[Tuple, List[torch.Tensor]] = {}
        self._lock = threading.Lock()

    def acquire(self, n_rows: int, n_cols: int,
                device: torch.device) -> torch.Tensor:
        key = (n_cols, str(device))
        with self._lock:
            free = self._free.get(key, [])
            for i, buf in enumerate(free):
                if buf.shape[0] >= n_rows:
                    return free.pop(i)
        cap = 1 << max(int(n_rows) - 1, 0).bit_length()
        return torch.empty((max(cap, 1), n_cols), dtype=torch.float32,
                           device=device)

    def release(self, buf: torch.Tensor) -> None:
        if _tensor_bytes(buf) > self._MAX_BYTES:
            return      # one-off giant grids go back to the allocator
        with self._lock:
            free = self._free.setdefault((buf.shape[1], str(buf.device)),
                                         [])
            if len(free) < self._MAX_FREE:
                free.append(buf)


_FEATURE_BUFFERS = _FeatureBufferPool()


def _features_grid_into(buf: torch.Tensor, op_t: torch.Tensor,
                        dev_t: torch.Tensor) -> torch.Tensor:
    """Fill ``buf`` with the device-major feature grid: row
    ``i * n_dev + j`` is op ``i`` queried against device ``j``.  The
    op and device blocks arrive already log1p-transformed (element-wise,
    so transforming each block once gives the grid's bits)."""
    n_idx, n_op_f = op_t.shape
    n_dev, n_dev_f = dev_t.shape
    rows = buf[:n_idx * n_dev]
    grid = rows.view(n_idx, n_dev, n_op_f + n_dev_f)
    grid[:, :, :n_op_f] = op_t[:, None, :]
    grid[:, :, n_op_f:] = dev_t[None, :, :]
    return rows


@dataclasses.dataclass
class FleetPrediction:
    """Per-(op, device) prediction grid for one trace against a fleet."""
    origin_device: str
    dests: List[str]
    op_ms: torch.Tensor          # (n_ops, n_dev) float64, engine's device
    arrays: TraceArrays
    label: str = "iteration"
    _totals: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def total_ms(self) -> np.ndarray:
        """Predicted iteration time per destination device, (n_dev,),
        reduced on the device and brought to the host once."""
        if self._totals is None:
            mult = torch.as_tensor(self.arrays.multiplicity, dtype=F64,
                                   device=self.op_ms.device)
            self._totals = ((self.op_ms * mult[:, None]).sum(dim=0)
                            .cpu().numpy())
        return self._totals

    def time_for(self, dest: str) -> float:
        return float(self.total_ms[self.dests.index(dest)])

    def as_dict(self) -> Dict[str, float]:
        return dict(zip(self.dests, self.total_ms.tolist()))

    def breakdown(self, dest: str) -> Dict[str, float]:
        """Per-kind time breakdown on one destination (paper Fig. 4)."""
        j = self.dests.index(dest)
        weighted = (self.op_ms[:, j].cpu().numpy()
                    * self.arrays.multiplicity)
        totals = np.bincount(self.arrays.kind_ids, weights=weighted,
                             minlength=len(self.arrays.kinds))
        return {k: float(t) for k, t in zip(self.arrays.kinds, totals)}


def _mlp_kind_rows(arrays, mlps: Dict):
    """Yield (kind, host row indices) for each op kind with an MLP and at
    least one kernel-varying row (shared by every scoring path)."""
    for kid, kind in enumerate(arrays.kinds):
        if kind not in mlps:
            continue
        idx = np.flatnonzero(arrays.kernel_varying
                             & (arrays.kind_ids == kid))
        if len(idx):
            yield kind, idx


def _no_mlp_rows(arrays, mlps: Dict) -> np.ndarray:
    kind_has_mlp = np.asarray([k in mlps for k in arrays.kinds], bool)
    return np.flatnonzero(arrays.kernel_varying
                          & ~kind_has_mlp[arrays.kind_ids])


def _score_grid(arrays, view, da: DeviceArrays, dv, mlps: Dict, fused,
                out: torch.Tensor, feature_buffers: bool) -> None:
    """Kernel-varying MLP rows x every destination: the device-major
    feature grid per kind, scored by ONE fused launch when ``fused`` is
    given, else by one per-kind forward each."""
    device = out.device
    groups = list(_mlp_kind_rows(arrays, mlps))
    if not groups:
        return
    dev_t = transform_features(dv.feature_matrix)
    n_feat = view.op_features.shape[1] + dev_t.shape[1]
    bufs, feats, rows = [], {}, {}
    try:
        for kind, idx in groups:
            rows[kind] = _idx(idx, device)
            op_t = transform_features(view.op_features[rows[kind]])
            n = len(idx) * da.n
            buf = (_FEATURE_BUFFERS.acquire(n, n_feat, device)
                   if feature_buffers else
                   torch.empty((n, n_feat), dtype=torch.float32,
                               device=device))
            bufs.append(buf)
            feats[kind] = _features_grid_into(buf, op_t, dev_t)
            if fused is None:
                SCORER_DISPATCHES.bump("per_kind")
                out[rows[kind]] = (mlps[kind].predict_ms(feats[kind])
                                   .to(F64).reshape(len(idx), da.n))
        if fused is not None:
            scored = fused.score_ms(feats)
            for kind, idx in groups:
                out[rows[kind]] = scored[kind].to(F64).reshape(len(idx),
                                                               da.n)
    finally:
        if feature_buffers:
            for buf in bufs:
                _FEATURE_BUFFERS.release(buf)


def _combine_grid(t_o: torch.Tensor, factor: torch.Tensor, overheads):
    """Cached-factor combine on the grid: per-op origin overheads become
    a column, per-destination ones a row."""
    oh = (None if overheads is None
          else (overheads[0][:, None], overheads[1][None, :]))
    return wave_scaling.combine_wave_factor(t_o[:, None], factor, oh)


def predict_trace_batch(trace: TrackedTrace,
                        dests: Union[DeviceArrays, Sequence[str],
                                     Sequence[DeviceSpec]],
                        mlps: Optional[Dict] = None,
                        exact: bool = False,
                        model_overhead: bool = False,
                        scorer=None,
                        feature_buffers: bool = True,
                        factor_cache: bool = True,
                        device=None) -> FleetPrediction:
    """Predict one trace's per-op times on every destination at once.

    ``scorer`` is a ready :class:`FusedMLPScorer` (or a spelling of
    :func:`_resolve_scorer`); without one, MLP rows go through per-kind
    forwards.  ``factor_cache=False`` bypasses :data:`WAVE_FACTOR_CACHE`
    (same numbers, recomputed)."""
    device = devices.torch_device(device)
    origin = devices.get(trace.origin_device)
    da = devices.as_arrays(dests)
    dv = da.on(device)
    arrays = trace.to_arrays()
    view = _arrays_view(arrays, device)
    mlps = mlps or {}
    out = torch.empty((arrays.n_ops, da.n), dtype=F64, device=device)

    alike = np.flatnonzero(~arrays.kernel_varying)
    if len(alike):
        t_host = arrays.measured_ms[alike]
        if np.isnan(t_host).any():
            bad = int(alike[np.isnan(t_host).argmax()])
            raise ValueError(
                f"op {trace.ops[bad].name} has no origin measurement")
        ai = _idx(alike, device)
        t_o = view.measured_ms[ai]
        key = _factor_key((trace.fingerprint(),), da, exact,
                          model_overhead, device)
        cached = (WAVE_FACTOR_CACHE.get(key, da, (origin,))
                  if factor_cache else None)
        if cached is not None:
            factor, overheads = cached
        else:
            ov = wave_scaling.origin_view(origin, device)
            factor = wave_scaling.wave_factor_vec(
                view.intensity[ai], view.bytes_accessed[ai], ov, dv,
                exact=exact)
            # the origin overhead is stored per op: the ragged paths index
            # it by row, and broadcasting the scalar changes no bits
            overheads = ((ov.overhead.expand(len(alike)).clone(),
                          wave_scaling.dest_overheads(dv))
                         if model_overhead else None)
            if factor_cache:
                WAVE_FACTOR_CACHE.insert(key, da, (origin,), factor,
                                         overheads)
        out[ai] = _combine_grid(t_o, factor, overheads)

    no_mlp = _no_mlp_rows(arrays, mlps)
    if len(no_mlp):
        ni = _idx(no_mlp, device)
        out[ni] = analytical_ms_vec(
            SimpleNamespace(flops=view.flops[ni],
                            bytes_accessed=view.bytes_accessed[ni],
                            kernel_varying=view.kernel_varying[ni]), dv)

    _score_grid(arrays, view, da, dv, mlps,
                _resolve_scorer(scorer, mlps, device), out,
                feature_buffers)
    return FleetPrediction(origin_device=trace.origin_device,
                           dests=list(da.names), op_ms=out, arrays=arrays,
                           label=trace.label)


# ---------------------------------------------------------------------------
# Multi-trace ragged grid: several traces x many devices in one pass.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RaggedTraceArrays:
    """Several traces stacked into one structure-of-arrays (host numpy).

    Rows ``offsets[i]:offsets[i+1]`` belong to trace ``i``; ``kind_ids``
    index into the *unified* ``kinds`` list, so one per-kind MLP batch can
    span every trace.  :meth:`on` gives the engine's tensor view on a
    device, built once per device."""
    offsets: np.ndarray          # (n_traces + 1,) int64 segment boundaries
    trace_ids: np.ndarray        # (total_ops,) int32 row -> trace index
    origins: List[str]           # (n_traces,) origin device names
    labels: List[str]            # (n_traces,)
    fingerprints: List[str]      # (n_traces,) TrackedTrace.fingerprint()
    flops: np.ndarray            # (total_ops,)
    bytes_accessed: np.ndarray   # (total_ops,)
    intensity: np.ndarray        # (total_ops,)
    measured_ms: np.ndarray      # (total_ops,) NaN where unmeasured
    multiplicity: np.ndarray     # (total_ops,)
    kernel_varying: np.ndarray   # (total_ops,) bool
    kind_ids: np.ndarray         # (total_ops,) int32 into ``kinds``
    kinds: List[str]             # unified kinds, sorted
    op_features: np.ndarray      # (total_ops, 9) raw MLP op features
    _views: Dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)
    _views_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    @property
    def n_traces(self) -> int:
        return len(self.origins)

    @property
    def n_ops(self) -> int:
        return int(self.flops.shape[0])

    def segment(self, i: int) -> TraceArrays:
        """Trace ``i``'s rows as a plain :class:`TraceArrays` view."""
        s, e = int(self.offsets[i]), int(self.offsets[i + 1])
        return TraceArrays(
            flops=self.flops[s:e], bytes_accessed=self.bytes_accessed[s:e],
            intensity=self.intensity[s:e],
            measured_ms=self.measured_ms[s:e],
            multiplicity=self.multiplicity[s:e],
            kernel_varying=self.kernel_varying[s:e],
            kind_ids=self.kind_ids[s:e], kinds=self.kinds,
            op_features=self.op_features[s:e])

    def alike_origin_arrays(self) -> devices.OriginArrays:
        """Per-op origin arrays of the kernel-alike rows."""
        specs = [devices.get(o) for o in self.origins]
        return devices.repeat_origins(
            specs, np.diff(self.offsets)).take(~self.kernel_varying)

    def on(self, device: torch.device) -> SimpleNamespace:
        """Tensor view on ``device``: the per-op fields, ``trace_ids``,
        the kernel-alike row index ``alike`` and its origin terms
        ``alike_origin`` (``wave_scaling.origin_view``)."""
        key = str(device)
        with self._views_lock:
            view = self._views.get(key)
            if view is None:
                view = _arrays_view(self, device)
                view.trace_ids = _idx(self.trace_ids, device)
                view.alike = _idx(np.flatnonzero(~self.kernel_varying),
                                  device)
                view.alike_origin = wave_scaling.origin_view(
                    self.alike_origin_arrays(), device)
                self._views[key] = view
            return view

    def factor_token(self) -> Tuple:
        """Content identity for the factor cache: the trace fingerprints
        (a 1-trace stack's token equals ``predict()``'s)."""
        return tuple(self.fingerprints)

    def origin_specs(self) -> Tuple:
        """Per-trace origin specs as resolved now (the factor cache
        validates entries against them by value)."""
        return tuple(devices.get(o) for o in self.origins)

    def alike_wave_factor(self, da: DeviceArrays, exact: bool,
                          model_overhead: bool, device: torch.device):
        """(factor (n_alike, n_dev), overheads-or-None) on ``device``,
        served from :data:`WAVE_FACTOR_CACHE` when warm."""
        key = _factor_key(self.factor_token(), da, exact, model_overhead,
                          device)
        origins = self.origin_specs()
        hit = WAVE_FACTOR_CACHE.get(key, da, origins)
        if hit is not None:
            return hit
        view, dv = self.on(device), da.on(device)
        factor = wave_scaling.wave_factor_vec(
            view.intensity[view.alike], view.bytes_accessed[view.alike],
            view.alike_origin, dv, exact=exact)
        overheads = ((view.alike_origin.overhead,
                      wave_scaling.dest_overheads(dv))
                     if model_overhead else None)
        WAVE_FACTOR_CACHE.insert(key, da, origins, factor, overheads)
        return factor, overheads

    def peek_wave_factor(self, da: DeviceArrays, exact: bool,
                         model_overhead: bool, device: torch.device):
        """The cached factor if warm, else None (not a counted miss)."""
        return WAVE_FACTOR_CACHE.peek(
            _factor_key(self.factor_token(), da, exact, model_overhead,
                        device), da, self.origin_specs())

    def extend(self, traces: Sequence[TrackedTrace]) -> "RaggedTraceArrays":
        """A NEW stack with ``traces`` appended, reusing this stack's
        arrays for the shared prefix (bit-identical to restacking)."""
        return _concat_stacks(self, _build_stack(list(traces)))


def _concat_stacks(a: RaggedTraceArrays,
                   b: RaggedTraceArrays) -> RaggedTraceArrays:
    if a.kinds == b.kinds:
        kinds, a_ids, b_ids = list(a.kinds), a.kind_ids, b.kind_ids
    else:
        kinds = sorted(set(a.kinds) | set(b.kinds))
        kmap = {k: i for i, k in enumerate(kinds)}
        a_ids = np.asarray([kmap[k] for k in a.kinds],
                           np.int32)[a.kind_ids]
        b_ids = np.asarray([kmap[k] for k in b.kinds],
                           np.int32)[b.kind_ids]
    cat = lambda f: np.concatenate([getattr(a, f), getattr(b, f)])
    return RaggedTraceArrays(
        offsets=np.concatenate([a.offsets, a.offsets[-1] + b.offsets[1:]]),
        trace_ids=np.concatenate([a.trace_ids,
                                  b.trace_ids + np.int32(a.n_traces)]),
        origins=a.origins + b.origins, labels=a.labels + b.labels,
        fingerprints=a.fingerprints + b.fingerprints,
        flops=cat("flops"), bytes_accessed=cat("bytes_accessed"),
        intensity=cat("intensity"), measured_ms=cat("measured_ms"),
        multiplicity=cat("multiplicity"),
        kernel_varying=cat("kernel_varying"),
        kind_ids=np.concatenate([a_ids, b_ids]), kinds=kinds,
        op_features=cat("op_features"))


class _StackCache:
    """Fingerprint-keyed LRU of built :class:`RaggedTraceArrays`.

    Keys are ``((fingerprint, label), ...)``.  An exact hit skips
    stacking (and keeps the stack's device views warm); a request
    extending a cached prefix stacks only the new tail.  Bounded by
    entries AND host bytes (``REPRO_STACK_CACHE_ENTRIES`` /
    ``REPRO_STACK_CACHE_BYTES``, defaults 16 / 256 MiB); thread-safe."""

    def __init__(self, capacity: Optional[int] = None,
                 max_bytes: Optional[int] = None):
        self.capacity = (env_int("REPRO_STACK_CACHE_ENTRIES", 16)
                         if capacity is None else capacity)
        self.max_bytes = (env_int("REPRO_STACK_CACHE_BYTES", 256 << 20)
                          if max_bytes is None else max_bytes)
        self._data: "OrderedDict[Tuple, RaggedTraceArrays]" = OrderedDict()
        self._bytes: Dict[Tuple, int] = {}
        self._total_bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.extends = 0
        self.builds = 0

    @staticmethod
    def _nbytes(stack: RaggedTraceArrays) -> int:
        return sum(getattr(stack, f).nbytes
                   for f in ("offsets", "trace_ids", "flops",
                             "bytes_accessed", "intensity", "measured_ms",
                             "multiplicity", "kernel_varying", "kind_ids",
                             "op_features"))

    def stack(self, traces: List[TrackedTrace]) -> RaggedTraceArrays:
        key = tuple((t.fingerprint(), t.label) for t in traces)
        with self._lock:
            hit = self._data.get(key)
            if hit is not None:
                self._data.move_to_end(key)
                self.hits += 1
                return hit
            best: Optional[Tuple] = None
            for k in self._data:
                if len(k) < len(key) and key[:len(k)] == k \
                        and (best is None or len(k) > len(best)):
                    best = k
            base = self._data[best] if best is not None else None
        if base is not None:
            stack = base.extend(traces[len(best):])
        else:
            stack = _build_stack(traces)
        nbytes = self._nbytes(stack)
        with self._lock:
            self.extends += base is not None
            self.builds += base is None
            if key in self._data:       # racing fill: replace accounting
                self._total_bytes -= self._bytes.pop(key)
            self._data[key] = stack
            self._bytes[key] = nbytes
            self._total_bytes += nbytes
            self._data.move_to_end(key)
            while self._data and (len(self._data) > self.capacity
                                  or self._total_bytes > self.max_bytes):
                old_key, _ = self._data.popitem(last=False)
                self._total_bytes -= self._bytes.pop(old_key)
        return stack

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "extends": self.extends,
                    "builds": self.builds, "entries": len(self._data),
                    "bytes": self._total_bytes,
                    "capacity": self.capacity,
                    "max_bytes": self.max_bytes}

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._bytes.clear()
            self._total_bytes = 0
            self.hits = self.extends = self.builds = 0


#: the process-wide stack cache behind ``stack_traces(cache=True)``
STACK_CACHE = _StackCache()


def stack_traces(traces: Union[RaggedTraceArrays, Sequence[TrackedTrace]],
                 cache: bool = True) -> RaggedTraceArrays:
    """Stack several :class:`TrackedTrace` into one ragged SoA.

    Idempotent (a ready :class:`RaggedTraceArrays` passes through).
    ``cache=True`` memoizes the build in :data:`STACK_CACHE`;
    ``cache=False`` forces a fresh build."""
    if isinstance(traces, RaggedTraceArrays):
        return traces
    traces = list(traces)
    if not traces:
        raise ValueError("stack_traces needs at least one trace")
    if cache:
        for t in traces:        # validate before keying the cache
            if t.to_arrays().n_ops == 0:
                raise ValueError(f"trace {t.label!r} has no ops")
        return STACK_CACHE.stack(traces)
    return _build_stack(traces)


def _build_stack(traces: List[TrackedTrace]) -> RaggedTraceArrays:
    if not traces:
        raise ValueError("stack_traces needs at least one trace")
    per = [t.to_arrays() for t in traces]
    for t, p in zip(traces, per):
        if p.n_ops == 0:
            raise ValueError(f"trace {t.label!r} has no ops")
    lengths = np.asarray([p.n_ops for p in per], np.int64)
    offsets = np.zeros(len(per) + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    cat = lambda field: np.concatenate([getattr(p, field) for p in per])
    if all(p.kinds == per[0].kinds for p in per[1:]):
        kinds = list(per[0].kinds)
        kind_ids = cat("kind_ids")
    else:
        kinds = sorted(set().union(*(p.kinds for p in per)))
        kmap = {k: i for i, k in enumerate(kinds)}
        kind_ids = np.concatenate([
            np.asarray([kmap[k] for k in p.kinds], np.int32)[p.kind_ids]
            for p in per])
    return RaggedTraceArrays(
        offsets=offsets,
        trace_ids=np.repeat(np.arange(len(per), dtype=np.int32), lengths),
        origins=[t.origin_device for t in traces],
        labels=[t.label for t in traces],
        fingerprints=[t.fingerprint() for t in traces],
        flops=cat("flops"), bytes_accessed=cat("bytes_accessed"),
        intensity=cat("intensity"), measured_ms=cat("measured_ms"),
        multiplicity=cat("multiplicity"),
        kernel_varying=cat("kernel_varying"),
        kind_ids=kind_ids, kinds=kinds, op_features=cat("op_features"))


@dataclasses.dataclass
class SweepPrediction:
    """The (n_traces x n_devices) what-if grid of one ragged sweep."""
    dests: List[str]
    op_ms: torch.Tensor          # (total_ops, n_dev) float64, engine device
    arrays: RaggedTraceArrays
    _totals: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def n_traces(self) -> int:
        return self.arrays.n_traces

    @property
    def labels(self) -> List[str]:
        return self.arrays.labels

    @property
    def total_ms(self) -> np.ndarray:
        """Iteration time grid, (n_traces, n_dev), host numpy.

        One segment sum on the device, then one copy to the host.
        Cell-masked sweeps leave NaN in uncomputed cells, which the sum
        propagates: readers must only consult computed cells."""
        if self._totals is None:
            view = self.arrays.on(self.op_ms.device)
            weighted = self.op_ms * view.multiplicity[:, None]
            totals = torch.zeros((self.n_traces, weighted.shape[1]),
                                 dtype=F64, device=self.op_ms.device)
            totals.index_add_(0, view.trace_ids, weighted)
            self._totals = totals.cpu().numpy()
        return self._totals

    def row(self, i: int) -> FleetPrediction:
        """Trace ``i``'s slice as a full :class:`FleetPrediction`."""
        s, e = int(self.arrays.offsets[i]), int(self.arrays.offsets[i + 1])
        return FleetPrediction(origin_device=self.arrays.origins[i],
                               dests=list(self.dests),
                               op_ms=self.op_ms[s:e],
                               arrays=self.arrays.segment(i),
                               label=self.arrays.labels[i])

    def time_for(self, i: int, dest: str) -> float:
        return float(self.total_ms[i, self.dests.index(dest)])

    def as_dicts(self) -> List[Dict[str, float]]:
        return [dict(zip(self.dests, row)) for row in self.total_ms.tolist()]


def _fusable(mlps: Dict) -> bool:
    """Can one stacked scorer hold these MLPs?  They must be TrainedMLPs
    (or expose ``cfg``/``params`` like one) of one architecture."""
    try:
        arches = {(m.cfg.hidden_layers, m.cfg.hidden_size,
                   np.shape(m.params[0][0])[0]) for m in mlps.values()}
    except (AttributeError, IndexError, TypeError):
        return False
    return len(arches) == 1


class FusedMLPScorer:
    """All op-kind MLPs packed for the one-launch fused scorer.

    ``impl="cuda"`` scores through the wrappers of
    :mod:`repro_torch.kernels.fused_mlp_score` — the Hopper kernels for a
    CUDA ``device``, their plain versions for the CPU; ``impl="plain"``
    forces the plain versions on any device.  On the CPU the row-mapped
    path uses the stacked lowering (rows regrouped by kind, one K-batched
    chain).  Every packed MLP must share one architecture."""

    def __init__(self, mlps: Dict, block_m: int = 128, impl: str = "cuda",
                 device=None):
        if not mlps:
            raise ValueError("FusedMLPScorer needs at least one MLP")
        if impl not in ("cuda", "plain"):
            raise ValueError(f"unknown scorer impl {impl!r}")
        if not _fusable(mlps):
            raise ValueError("fused scorer needs architecture-uniform "
                             "TrainedMLPs")
        self.device = devices.torch_device(device)
        self.kinds = sorted(mlps)
        first = mlps[self.kinds[0]]
        self.hidden = first.cfg.hidden_size
        self.in_features = np.shape(first.params[0][0])[0]
        ws, bs = zip(*(fms.pack_mlp_params(mlps[k].params,
                                           self.in_features, self.hidden,
                                           self.device)
                       for k in self.kinds))
        self.weights = torch.stack(ws)        # (K, L, H, H)
        self.biases = torch.stack(bs)         # (K, L, H)
        self.mlps = dict(mlps)                # normalization + output
        self.block_m = block_m
        self.impl = impl
        # stock TrainedMLPs standardize and un-log per row through stacked
        # constants; an overridden normalize/ms_from_log keeps its own
        self._stock_contract = all(
            type(m).normalize is mlp_mod.TrainedMLP.normalize
            and type(m).ms_from_log is mlp_mod.TrainedMLP.ms_from_log
            for m in mlps.values())
        if self._stock_contract:
            self._feat_mean = torch.as_tensor(np.stack(
                [np.asarray(mlps[k].feature_mean) for k in self.kinds]),
                device=self.device)
            self._feat_std = torch.as_tensor(np.stack(
                [np.asarray(mlps[k].feature_std) for k in self.kinds]),
                device=self.device)

    def score_ms(self, feats_by_kind: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """Raw feature rows per kind -> predicted ms per kind, one launch.

        Rows are grouped by kind, padded per kind to whole ``block_m``
        blocks, and the block count to a :func:`bucket_blocks` bucket;
        padding blocks carry kind 0 and zero rows and are sliced off."""
        if not any(f.shape[0] for f in feats_by_kind.values()):
            return {kind: self.mlps[kind].ms_from_log(
                        torch.zeros(0, device=self.device))
                    for kind in feats_by_kind}
        bm = self.block_m
        blocks = [-(-f.shape[0] // bm) for f in feats_by_kind.values()]
        padded = fms.bucket_blocks(sum(blocks))
        x = torch.zeros((padded * bm, self.hidden), dtype=torch.float32,
                        device=self.device)
        block_kinds = np.zeros(padded, np.int32)
        offset = 0
        for (kind, feats), nb in zip(feats_by_kind.items(), blocks):
            xn = self.mlps[kind].normalize(feats)
            x[offset:offset + xn.shape[0], :xn.shape[1]] = xn
            block_kinds[offset // bm:offset // bm + nb] = \
                self.kinds.index(kind)
            offset += nb * bm
        bk = torch.as_tensor(block_kinds, device=self.device)
        SCORER_DISPATCHES.bump("fused")
        if self.impl == "plain":
            log_ms = fms.fused_mlp_score_plain(x, bk, self.weights,
                                               self.biases)
        else:
            log_ms = fms.fused_mlp_score(x, bk, self.weights, self.biases,
                                         block_m=bm,
                                         in_features=self.in_features)
        out, offset = {}, 0
        for (kind, feats), nb in zip(feats_by_kind.items(), blocks):
            out[kind] = self.mlps[kind].ms_from_log(
                log_ms[offset:offset + feats.shape[0]])
            offset += nb * bm
        return out

    def _normalized_rows(self, feats: torch.Tensor,
                         kind_ids: torch.Tensor) -> torch.Tensor:
        """Per-row standardized features (each row with its kind's
        constants)."""
        if self._stock_contract:
            k = kind_ids.to(torch.long)
            return (feats - self._feat_mean[k]) / self._feat_std[k]
        out = torch.empty(feats.shape, dtype=F64, device=feats.device)
        for ki, kind in enumerate(self.kinds):
            rows = torch.nonzero(kind_ids == ki).flatten()
            if rows.numel():
                out[rows] = self.mlps[kind].normalize(feats[rows]).to(F64)
        return out

    def _ms_from_log_rows(self, log_ms: torch.Tensor,
                          kind_ids: torch.Tensor) -> torch.Tensor:
        if self._stock_contract:
            return mlp_mod.TrainedMLP.ms_from_log(log_ms)
        out = torch.empty(log_ms.shape, dtype=F64, device=log_ms.device)
        for ki, kind in enumerate(self.kinds):
            rows = torch.nonzero(kind_ids == ki).flatten()
            if rows.numel():
                out[rows] = self.mlps[kind].ms_from_log(
                    log_ms[rows]).to(F64)
        return out

    def score_rows_ms(self, feats: torch.Tensor,
                      kind_ids) -> torch.Tensor:
        """Raw feature rows in ANY kind order -> predicted ms (float64),
        one launch.  ``kind_ids[i]`` indexes ``self.kinds`` for row
        ``i``.  On CUDA the row-mapped kernel scores the rows in caller
        order, padded to whole ``block_m`` blocks
        (:func:`~repro_torch.kernels.fused_mlp_score.pad_rows_to_blocks`:
        padding rides the last row's kind, garbage by contract, sliced
        off), its first layer over the ``in_features`` columns; on the CPU
        rows are regrouped by kind into a (K, bucket_rows(max), H)
        stack."""
        m = feats.shape[0]
        if m == 0:
            return torch.zeros(0, dtype=F64, device=self.device)
        kind_ids = torch.as_tensor(kind_ids, dtype=torch.int32,
                                   device=self.device)
        xn = self._normalized_rows(feats, kind_ids)
        SCORER_DISPATCHES.bump("fused")
        if self.device.type == "cpu":
            host_ids = kind_ids.numpy()
            rows_by_kind = [torch.as_tensor(np.flatnonzero(host_ids == ki))
                            for ki in range(len(self.kinds))]
            bpad = fms.bucket_rows(max(len(r) for r in rows_by_kind))
            xs = torch.zeros((len(self.kinds), bpad, self.hidden),
                             dtype=torch.float32)
            for ki, rows in enumerate(rows_by_kind):
                xs[ki, :len(rows), :xn.shape[1]] = xn[rows]
            log_grid = fms.fused_mlp_score_stacked_plain(
                xs, self.weights, self.biases)
            log_ms = torch.empty(m, dtype=torch.float32)
            for ki, rows in enumerate(rows_by_kind):
                log_ms[rows] = log_grid[ki, :len(rows)]
        else:
            xp, row_kinds = fms.pad_rows_to_blocks(xn, kind_ids,
                                                   self.hidden, self.block_m)
            if self.impl == "plain":
                log_ms = fms.fused_mlp_score_rows_plain(
                    xp, row_kinds, self.weights, self.biases)[:m]
            else:
                log_ms = fms.fused_mlp_score_rows(
                    xp, row_kinds, self.weights, self.biases,
                    block_m=self.block_m,
                    in_features=self.in_features)[:m]
        return self._ms_from_log_rows(log_ms, kind_ids).to(F64)


def _resolve_scorer(scorer, mlps: Dict, device: torch.device):
    """Map a scorer spelling to a usable instance (or None: per-kind
    forwards).

    ``None``/"off" -> per-kind forwards; "auto" -> the Hopper kernels on
    a CUDA device (their wrappers raise on anything but sm_90) and
    per-kind forwards on the CPU, as the reference keeps its fused kernel
    to the TPU; MLPs of mixed architecture fall back to per-kind forwards
    (a policy about the MLPs, not the device).  "cuda" / "plain" force
    the fused path; a ready :class:`FusedMLPScorer` is used as-is."""
    if scorer is None or scorer == "off" or not mlps:
        return None
    if isinstance(scorer, FusedMLPScorer):
        return scorer
    if scorer == "auto":
        if device.type != "cuda" or not _fusable(mlps):
            return None
        return FusedMLPScorer(mlps, impl="cuda", device=device)
    if scorer in ("cuda", "plain"):
        return FusedMLPScorer(mlps, impl=scorer, device=device)
    raise ValueError(f"unknown scorer spelling {scorer!r}")


def _raise_unmeasured(ragged: RaggedTraceArrays, rows: np.ndarray,
                      t_o: np.ndarray) -> None:
    bad = int(rows[np.isnan(t_o).argmax()])
    tid = int(ragged.trace_ids[bad])
    raise ValueError(
        f"trace {ragged.labels[tid]!r} op row "
        f"{bad - int(ragged.offsets[tid])} has no origin measurement")


def predict_sweep(traces: Union[RaggedTraceArrays, Sequence[TrackedTrace]],
                  dests: Union[DeviceArrays, Sequence[str],
                               Sequence[DeviceSpec]],
                  mlps: Optional[Dict] = None,
                  exact: bool = False,
                  model_overhead: bool = False,
                  scorer=None,
                  cell_mask: Optional[np.ndarray] = None,
                  stack_cache: bool = True,
                  feature_buffers: bool = True,
                  factor_cache: bool = True,
                  device=None) -> SweepPrediction:
    """Predict every trace on every destination in one ragged pass.

    Row i of the result reproduces :func:`predict_trace_batch` on trace i
    alone (same expressions; MLP rows and the totals' sums to float
    tolerance).  ``cell_mask`` — bool (n_traces, n_dev), True = compute —
    evaluates only the masked-in cells and leaves the rest NaN (the
    planner fills only its cache-cold cells this way).  ``stack_cache``/
    ``feature_buffers``/``factor_cache`` select the stack cache, the
    pooled feature buffers and the cross-stack factor cache (same
    numbers either way)."""
    ragged = stack_traces(traces, cache=stack_cache)
    device = devices.torch_device(device)
    da = devices.as_arrays(dests)
    mlps = mlps or {}
    if cell_mask is not None:
        cell_mask = np.asarray(cell_mask, bool)
        if cell_mask.shape != (ragged.n_traces, da.n):
            raise ValueError(
                f"cell_mask shape {cell_mask.shape} != "
                f"(n_traces, n_dev) = {(ragged.n_traces, da.n)}")
        if cell_mask.all():
            cell_mask = None    # the full grid is the fast spelling
    fused = _resolve_scorer(scorer, mlps, device)
    if cell_mask is not None:
        return _predict_sweep_masked(ragged, da, mlps, exact,
                                     model_overhead, fused, cell_mask,
                                     feature_buffers, factor_cache, device)
    view, dv = ragged.on(device), da.on(device)
    out = torch.empty((ragged.n_ops, da.n), dtype=F64, device=device)

    alike = np.flatnonzero(~ragged.kernel_varying)
    if len(alike):
        t_host = ragged.measured_ms[alike]
        if np.isnan(t_host).any():
            _raise_unmeasured(ragged, alike, t_host)
        t_o = view.measured_ms[view.alike]
        if factor_cache:
            factor, overheads = ragged.alike_wave_factor(
                da, exact, model_overhead, device)
            out[view.alike] = _combine_grid(t_o, factor, overheads)
        else:
            out[view.alike] = wave_scaling.scale_times_vec(
                t_o, view.intensity[view.alike],
                view.bytes_accessed[view.alike], view.alike_origin, dv,
                exact=exact, model_overhead=model_overhead)

    no_mlp = _no_mlp_rows(ragged, mlps)
    if len(no_mlp):
        ni = _idx(no_mlp, device)
        out[ni] = analytical_ms_vec(
            SimpleNamespace(flops=view.flops[ni],
                            bytes_accessed=view.bytes_accessed[ni],
                            kernel_varying=view.kernel_varying[ni]), dv)

    _score_grid(ragged, view, da, dv, mlps, fused, out, feature_buffers)
    return SweepPrediction(dests=list(da.names), op_ms=out, arrays=ragged)


def _predict_sweep_masked(ragged: RaggedTraceArrays, da: DeviceArrays,
                          mlps: Dict, exact: bool, model_overhead: bool,
                          fused, cell_mask: np.ndarray,
                          feature_buffers: bool, factor_cache: bool,
                          device: torch.device) -> SweepPrediction:
    """Partial-compute sweep: evaluate only the masked-in cells.

    Each cell runs the full grid's expression on gathered per-cell
    inputs (a warm cached factor is gathered instead of recomputed);
    MLP cells of every kind go to ONE ``score_rows_ms`` launch when a
    fused scorer is active.  Masked-out cells stay NaN."""
    view, dv = ragged.on(device), da.on(device)
    out = torch.full((ragged.n_ops, da.n), float("nan"), dtype=F64,
                     device=device)
    op_mask = cell_mask[ragged.trace_ids]            # (n_ops, n_dev) host

    alike_rows = np.flatnonzero(~ragged.kernel_varying)
    r, c = np.nonzero(op_mask[alike_rows])
    if len(r):
        rows = alike_rows[r]
        t_host = ragged.measured_ms[rows]
        if np.isnan(t_host).any():
            _raise_unmeasured(ragged, rows, t_host)
        rt, ct, rows_t = _idx(r, device), _idx(c, device), _idx(rows,
                                                                device)
        t_cells = view.measured_ms[rows_t]
        cached = (ragged.peek_wave_factor(da, exact, model_overhead, device)
                  if factor_cache else None)
        if cached is not None:
            factor, overheads = cached
            oh = (None if overheads is None
                  else (overheads[0][rt], overheads[1][ct]))
            out[rows_t, ct] = wave_scaling.combine_wave_factor(
                t_cells, factor[rt, ct], oh)
        else:
            ov = view.alike_origin
            ov_cells = SimpleNamespace(
                mem_bandwidth=ov.mem_bandwidth[rt],
                clock_hz=ov.clock_hz[rt], wave_size=ov.wave_size[rt],
                overhead=ov.overhead[rt])
            out[rows_t, ct] = wave_scaling.scale_times_flat(
                t_cells, view.intensity[rows_t],
                view.bytes_accessed[rows_t], ov_cells, dv, ct, exact=exact,
                model_overhead=model_overhead)

    no_mlp = _no_mlp_rows(ragged, mlps)
    r, c = np.nonzero(op_mask[no_mlp])
    if len(r):
        rows_t, ct = _idx(no_mlp[r], device), _idx(c, device)
        out[rows_t, ct] = _roofline_core(
            view.flops[rows_t], view.bytes_accessed[rows_t],
            view.kernel_varying[rows_t], dv.peak_flops[ct],
            dv.mem_bandwidth[ct])

    pairs = []
    for kind, idx in _mlp_kind_rows(ragged, mlps):
        r, c = np.nonzero(op_mask[idx])
        if len(r):
            pairs.append((kind, _idx(idx[r], device), _idx(c, device)))
    if not pairs:
        return SweepPrediction(dests=list(da.names), op_ms=out,
                               arrays=ragged)
    dev_t = transform_features(dv.feature_matrix)
    n_op_f = view.op_features.shape[1]
    n_feat = n_op_f + dev_t.shape[1]

    def pair_features(buf, rows_t, ct):
        buf[:, :n_op_f] = transform_features(view.op_features[rows_t])
        buf[:, n_op_f:] = dev_t[ct]
        return buf

    total = sum(len(rows_t) for _, rows_t, _ in pairs)
    buf = (_FEATURE_BUFFERS.acquire(total, n_feat, device)
           if feature_buffers else
           torch.empty((total, n_feat), dtype=torch.float32, device=device))
    try:
        offset = 0
        kind_rows = np.empty(total, np.int32)
        for kind, rows_t, ct in pairs:
            n = len(rows_t)
            feats = pair_features(buf[offset:offset + n], rows_t, ct)
            if fused is None:
                SCORER_DISPATCHES.bump("per_kind")
                out[rows_t, ct] = mlps[kind].predict_ms(feats).to(F64)
            else:
                kind_rows[offset:offset + n] = fused.kinds.index(kind)
            offset += n
        if fused is not None:
            scored = fused.score_rows_ms(buf[:total], kind_rows)
            offset = 0
            for _, rows_t, ct in pairs:
                out[rows_t, ct] = scored[offset:offset + len(rows_t)]
                offset += len(rows_t)
    finally:
        if feature_buffers:
            _FEATURE_BUFFERS.release(buf)
    return SweepPrediction(dests=list(da.names), op_ms=out, arrays=ragged)
