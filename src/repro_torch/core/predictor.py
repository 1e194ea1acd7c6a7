"""The Habitat predictor facade (paper Sec. 3.2) plus baseline predictors.

``HabitatPredictor`` combines **wave scaling** (Eq. 2, optionally Eq. 1)
for kernel-alike ops and **pre-trained MLPs** for kernel-varying ops
(conv2d / linear / bmm / recurrent), falling back to an analytical
roofline (Paleo-style, also :class:`PaleoPredictor`) for kinds without an
MLP.  The port of ``repro.core.predictor``: every predictor runs its grid
math on a torch ``device`` — ``cuda`` unless the caller passes
``device="cpu"``.  Training the MLPs comes with a later part of the port.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import batched, dataset as dataset_mod
from repro_torch.core import devices, mlp, wave_scaling
from repro_torch.core.batched import FleetPrediction
from repro_torch.core.devices import DeviceSpec
from repro_torch.core.trace import Op, TrackedTrace


def _analytical_ms(op: Op, dev: DeviceSpec) -> float:
    """Paleo-style analytical estimate: roofline with generic efficiency
    (ignores algorithm selection and wave quantization — exactly what the
    paper says analytical models miss)."""
    eff_c = 0.70 if op.kernel_varying else 0.50
    eff_m = 0.75 if op.kernel_varying else 0.82
    flops_t = op.cost.flops / (dev.peak_flops * eff_c)
    mem_t = op.cost.bytes_accessed / (dev.mem_bandwidth * eff_m)
    return max(flops_t, mem_t) * 1e3


class _FleetTraceMixin:
    """Shared glue: derive ``predict_trace`` and a generic sweep from a
    ``predict_fleet`` grid."""

    def predict_trace(self, trace: TrackedTrace, dest: str) -> TrackedTrace:
        """Predict the trace on one destination (vectorized hot path)."""
        fleet = self.predict_fleet(trace, [dest])
        new_ops = [copy.copy(op) for op in trace.ops]
        for op, t in zip(new_ops, fleet.op_ms[:, 0].tolist()):
            op.predicted_ms = float(t)
        return TrackedTrace(ops=new_ops, origin_device=dest,
                            label=trace.label)

    def predict_sweep(self, traces: Sequence[TrackedTrace],
                      dests: Optional[Sequence[str]] = None
                      ) -> batched.SweepPrediction:
        """Generic multi-trace sweep: one ``predict_fleet`` grid per trace
        (``HabitatPredictor`` overrides it with the one-pass engine)."""
        if isinstance(traces, batched.RaggedTraceArrays):
            raise TypeError(
                f"{type(self).__name__}.predict_sweep needs TrackedTrace "
                f"objects; only HabitatPredictor accepts a prebuilt "
                f"RaggedTraceArrays")
        traces = list(traces)
        if dests is None:
            dests = sorted(devices.all_devices())
        ragged = batched.stack_traces(traces)
        fleets = [self.predict_fleet(t, dests) for t in traces]
        return batched.SweepPrediction(
            dests=list(fleets[0].dests),
            op_ms=torch.cat([f.op_ms for f in fleets]), arrays=ragged)

    def sweep_config_key(self) -> tuple:
        """Cache-key identity of sweep() results (the generic sweep IS
        predict_fleet per trace)."""
        return self.config_key()


class HabitatPredictor(_FleetTraceMixin):
    """Scale a measured trace from its origin device to destinations.

    ``sweep_scorer`` picks the MLP scorer of sweeps and fleet grids:
    "auto" (the Hopper kernels on an sm_90 CUDA device, per-kind forwards
    on the CPU), "off", or a forced fused spelling ("cuda" | "plain").
    ``stack_cache``/``feature_buffers``/``factor_cache`` are the engine's
    cache switches (same numbers either way).  ``device`` defaults to
    ``cuda``; there is no silent CPU fallback."""

    def __init__(self, mlps: Optional[Dict[str, mlp.TrainedMLP]] = None,
                 exact_wave: bool = False, model_overhead: bool = False,
                 sweep_scorer: str = "auto", stack_cache: bool = True,
                 feature_buffers: bool = True, factor_cache: bool = True,
                 device=None):
        self.mlps = mlps or {}
        self.exact_wave = exact_wave
        self.model_overhead = model_overhead
        self.sweep_scorer = sweep_scorer
        self.stack_cache = stack_cache
        self.feature_buffers = feature_buffers
        self.factor_cache = factor_cache
        self.device = devices.torch_device(device)
        self._scorer_cache: Dict = {}

    # -- per-op ------------------------------------------------------------
    def predict_op_ms(self, op: Op, origin: DeviceSpec,
                      dest: DeviceSpec) -> float:
        if op.kernel_varying:
            m = self.mlps.get(op.kind)
            if m is not None:
                feats = dataset_mod.op_features(op, dest)
                return float(m.predict_ms(feats)[0])
            return _analytical_ms(op, dest)
        if op.measured_ms is None:
            raise ValueError(f"op {op.name} has no origin measurement")
        return wave_scaling.scale_time(op.measured_ms, op, origin, dest,
                                       exact=self.exact_wave,
                                       model_overhead=self.model_overhead)

    def config_key(self) -> tuple:
        """Hashable identity of this predictor's configuration (result
        caches key on it)."""
        return (type(self).__name__, self.exact_wave, self.model_overhead,
                self.sweep_scorer, str(self.device),
                tuple(sorted((k, m.uid) for k, m in self.mlps.items())))

    def _fused_scorer(self, spelling):
        """Resolve (and memoize) the fused scorer: packing the (K, L, H, H)
        weight stack onto the device is reusable until the MLP set or the
        spelling changes."""
        if isinstance(spelling, batched.FusedMLPScorer):
            return spelling
        key = (spelling, tuple(sorted((k, m.uid)
                                      for k, m in self.mlps.items())))
        if self._scorer_cache.get("key") != key:
            scorer = batched._resolve_scorer(spelling, self.mlps,
                                             self.device)
            self._scorer_cache = {"key": key, "scorer": scorer}
        return self._scorer_cache["scorer"]

    # -- whole fleet -------------------------------------------------------
    def predict_fleet(self, trace: TrackedTrace,
                      dests: Optional[Sequence[str]] = None
                      ) -> FleetPrediction:
        """Vectorized: predict the trace on every destination at once."""
        if dests is None:
            dests = sorted(devices.all_devices())
        return batched.predict_trace_batch(
            trace, dests, mlps=self.mlps, exact=self.exact_wave,
            model_overhead=self.model_overhead,
            scorer=self._fused_scorer(self.sweep_scorer),
            feature_buffers=self.feature_buffers,
            factor_cache=self.factor_cache, device=self.device)

    def predict_sweep(self, traces, dests: Optional[Sequence[str]] = None,
                      scorer=None,
                      cell_mask=None) -> batched.SweepPrediction:
        """One ragged pass: every trace x every destination device.

        ``cell_mask`` (bool, (n_traces, n_dests), True = compute)
        requests a partial-compute sweep; the other cells stay NaN."""
        if dests is None:
            dests = sorted(devices.all_devices())
        spelling = self.sweep_scorer if scorer is None else scorer
        return batched.predict_sweep(
            traces, dests, mlps=self.mlps, exact=self.exact_wave,
            model_overhead=self.model_overhead,
            scorer=self._fused_scorer(spelling), cell_mask=cell_mask,
            stack_cache=self.stack_cache,
            feature_buffers=self.feature_buffers,
            factor_cache=self.factor_cache, device=self.device)

    def sweep_config_key(self) -> tuple:
        """Without MLPs the sweep reproduces ``predict_fleet``, so the
        identities coincide; with MLPs, co-batched float32 rows are only
        tolerance-close, so sweep cells get their own tag."""
        if not self.mlps:
            return self.config_key()
        return self.config_key() + ("sweep",)

    def predict_trace_scalar(self, trace: TrackedTrace,
                             dest: str) -> TrackedTrace:
        """The per-op Python loop on host floats (the reference spelling
        the vectorized engine is held against)."""
        origin = devices.get(trace.origin_device)
        dest_spec = devices.get(dest)
        new_ops = [copy.copy(op) for op in trace.ops]
        by_kind: Dict[str, list] = {}
        for i, op in enumerate(new_ops):
            if op.kernel_varying and op.kind in self.mlps:
                by_kind.setdefault(op.kind, []).append(i)
            elif op.kernel_varying:
                op.predicted_ms = _analytical_ms(op, dest_spec)
            else:
                op.predicted_ms = wave_scaling.scale_time(
                    op.measured_ms, op, origin, dest_spec,
                    exact=self.exact_wave,
                    model_overhead=self.model_overhead)
        for kind, idxs in by_kind.items():
            feats = np.stack([dataset_mod.op_features(new_ops[i], dest_spec)
                              for i in idxs])
            preds = self.mlps[kind].predict_ms(feats)
            for i, p in zip(idxs, preds):
                new_ops[i].predicted_ms = float(p)
        return TrackedTrace(ops=new_ops, origin_device=dest,
                            label=trace.label)


class FlopsRatioPredictor(_FleetTraceMixin):
    """The naive peak-FLOPS-ratio heuristic the paper debunks (Fig. 1)."""

    def __init__(self, device=None):
        self.device = devices.torch_device(device)

    def config_key(self) -> tuple:
        return (type(self).__name__,)

    def predict_fleet(self, trace: TrackedTrace,
                      dests: Optional[Sequence[str]] = None
                      ) -> FleetPrediction:
        if dests is None:
            dests = sorted(devices.all_devices())
        origin = devices.get(trace.origin_device)
        da = devices.as_arrays(dests)
        arrays = trace.to_arrays()
        if np.isnan(arrays.measured_ms).any():
            bad = int(np.isnan(arrays.measured_ms).argmax())
            raise ValueError(
                f"op {trace.ops[bad].name} has no origin measurement")
        t = torch.as_tensor(arrays.measured_ms, dtype=torch.float64,
                            device=self.device)
        op_ms = t[:, None] * (origin.peak_flops
                              / da.on(self.device).peak_flops)[None, :]
        return FleetPrediction(origin_device=trace.origin_device,
                               dests=list(da.names), op_ms=op_ms,
                               arrays=arrays, label=trace.label)


class PaleoPredictor(_FleetTraceMixin):
    """Purely analytical baseline (no runtime information used at all)."""

    def __init__(self, device=None):
        self.device = devices.torch_device(device)

    def config_key(self) -> tuple:
        return (type(self).__name__,)

    def predict_fleet(self, trace: TrackedTrace,
                      dests: Optional[Sequence[str]] = None
                      ) -> FleetPrediction:
        if dests is None:
            dests = sorted(devices.all_devices())
        da = devices.as_arrays(dests)
        arrays = trace.to_arrays()
        view = batched._arrays_view(arrays, self.device)
        op_ms = batched.analytical_ms_vec(view, da.on(self.device))
        return FleetPrediction(origin_device=trace.origin_device,
                               dests=list(da.names), op_ms=op_ms,
                               arrays=arrays, label=trace.label)
