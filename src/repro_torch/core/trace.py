"""Operation tracking: the port of ``repro.core.trace``.

A :class:`TrackedTrace` is an ordered list of :class:`Op` records, each
carrying its analytical cost (flops/bytes), its MLP feature vector, its
kernel-alike/kernel-varying classification and its origin-measured time,
with the reference's strict JSON codec (:class:`TraceValidationError`)
and content fingerprint.  Arrays stay host numpy and the fingerprint is a
sha1 over their bytes, so the two packages agree on result-cache keys and
router shards.

:class:`OperationTracker` records a step as the paper's tracker does
(Sec. 4.1, Listing 1)::

    tracker = OperationTracker("H100-SXM", measure="wallclock")
    trace = tracker.track(iteration, params, batch)
    print(trace.to_device("V100").run_time_ms)

The reference walks a jaxpr; eager PyTorch has none, so ``track`` runs
the step once under a ``TorchDispatchMode`` on the device of its tensors
and records one :class:`Op` per aten call the mode sees, below autograd,
so a training iteration's backward ops are recorded too (on CUDA the
autograd engine runs them on its device thread, which carries the mode).
Kinds follow the reference: ``mm``/``addmm`` (2-D after folding) are
``linear``, ``bmm``/``baddbmm`` are ``bmm`` (a batch of 1 is ``linear``,
as ``_classify_dot`` has it), ``convolution`` and each gradient of
``convolution_backward`` are ``conv2d`` with the reference's params (the
gradients' as JAX's transposed convolutions record them), and every
other op is its own kind, named with the reference's primitive name
(:func:`repro_torch.core.costmodel.prim_name`).  Autograd's bookkeeping
(``detach``, ``alias``) launches nothing and is not recorded.

A ``lax.scan`` whose body holds a matmul is one ``recurrent`` op in the
reference; its counterpart here is :func:`recurrent_scan`, whose forward
and backward each run inside a region the tracker collapses into one
``recurrent`` op with the region's summed cost and the reference's
``_recurrent_params``.

The port's own kernels are ``ctypes`` calls (``kernels/build.py``), which
no dispatch mode sees, so a step tracked here must run plain ops: the
evalzoo nets do, the Transformer runs with ``use_flash=False`` (dense
attention) and ``decode_step`` uses plain decode attention.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import numbers
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)

from repro_torch.core import costmodel, devices
from repro_torch.core.costmodel import OpCost

# Operation kinds.  The first four match the paper's kernel-varying set
# (Table 1); ``recurrent`` covers LSTM *and* other matmul-carrying scans
# (e.g. Mamba2's SSD recurrence), which are kernel-varying on TPUs because
# Mosaic/XLA retile them per generation.
KERNEL_VARYING_KINDS = ("conv2d", "linear", "bmm", "recurrent")


@dataclasses.dataclass
class Op:
    """One tracked operation (≈ one GPU kernel launch in the paper)."""
    name: str                       # primitive name
    kind: str                       # conv2d | linear | bmm | recurrent | <prim>
    cost: OpCost
    multiplicity: int = 1           # how many times it runs per iteration
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    in_shapes: Tuple[Tuple[int, ...], ...] = ()
    out_shapes: Tuple[Tuple[int, ...], ...] = ()
    dtype: str = "float32"
    measured_ms: Optional[float] = None   # T_o on the origin device
    predicted_ms: Optional[float] = None  # T_d after scaling
    #: the aten calls this op ran, as the tracker recorded them
    #: (:class:`AtenCall`; a ``recurrent`` op's region holds several),
    #: which ``wallclock`` replays; not part of the wire format
    calls: Tuple["AtenCall", ...] = dataclasses.field(
        default=(), repr=False, compare=False)

    @property
    def kernel_varying(self) -> bool:
        return self.kind in KERNEL_VARYING_KINDS

    def to_dict(self) -> Dict[str, Any]:
        """JSON-safe record (golden-trace files, service wire format).

        Every numeric field is coerced to a native Python number, so an
        op whose times/costs came back as numpy scalars (calibration,
        array math) still serializes — and Python floats round-trip
        through ``json`` bitwise (shortest-repr encoding)."""
        return {
            "name": self.name, "kind": self.kind,
            "cost": {"flops": float(self.cost.flops),
                     "bytes_read": float(self.cost.bytes_read),
                     "bytes_written": float(self.cost.bytes_written)},
            "multiplicity": int(self.multiplicity),
            "params": {str(k): _json_safe(v)
                       for k, v in self.params.items()},
            "in_shapes": [[int(x) for x in s] for s in self.in_shapes],
            "out_shapes": [[int(x) for x in s] for s in self.out_shapes],
            "dtype": self.dtype,
            "measured_ms": _json_safe(self.measured_ms),
            "predicted_ms": _json_safe(self.predicted_ms),
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Op":
        """Decode one op document, validating every field.

        Raises :class:`TraceValidationError` on any malformed input;
        valid documents decode bitwise-identically to the pre-validation
        decoder (``float``/``int`` coercion semantics unchanged)."""
        if not isinstance(d, dict):
            raise TraceValidationError(
                f"op document must be an object, got {type(d).__name__}")
        try:
            name, kind, dtype = d["name"], d["kind"], d["dtype"]
            cost_doc, raw_params = d["cost"], d["params"]
            raw_in, raw_out = d["in_shapes"], d["out_shapes"]
            raw_mult = d["multiplicity"]
            raw_measured, raw_predicted = d["measured_ms"], d["predicted_ms"]
        except KeyError as e:
            raise TraceValidationError(
                f"op document missing field {e}") from None
        name = _v_str(name, "op.name")
        kind = _v_str(kind, "op.kind")
        dtype = _v_str(dtype, "op.dtype")
        if not isinstance(cost_doc, dict):
            raise TraceValidationError(
                f"op.cost must be an object, got {type(cost_doc).__name__}")
        if not isinstance(raw_params, dict):
            raise TraceValidationError(
                f"op.params must be an object, "
                f"got {type(raw_params).__name__}")
        for key in _FEATURE_PARAM_KEYS.get(kind, ()):
            if key in raw_params:
                _v_num(raw_params[key], f"op.params.{key}")
        return Op(
            name=name, kind=kind,
            cost=OpCost(
                flops=_v_num(cost_doc.get("flops"), "op.cost.flops"),
                bytes_read=_v_num(cost_doc.get("bytes_read"),
                                  "op.cost.bytes_read"),
                bytes_written=_v_num(cost_doc.get("bytes_written"),
                                     "op.cost.bytes_written")),
            multiplicity=_v_num(raw_mult, "op.multiplicity",
                                integral=True),
            params=dict(raw_params),
            in_shapes=_v_shapes(raw_in, "op.in_shapes"),
            out_shapes=_v_shapes(raw_out, "op.out_shapes"),
            dtype=dtype,
            measured_ms=_v_num(raw_measured, "op.measured_ms",
                               allow_none=True),
            predicted_ms=_v_num(raw_predicted, "op.predicted_ms",
                                allow_none=True))

    def feature_vector(self) -> List[float]:
        """Kind-specific op features for the MLP predictors (Sec. 3.4).

        The paper's per-kind layer dimensions (Table 1), padded to length 7,
        plus the op's analytical FLOPs and bytes.  The two cost features are
        an addition over the paper: in JAX a "kind" covers heterogeneous
        jaxpr patterns (e.g. ``recurrent`` spans LSTM, GRU and SSD scans),
        so the dimensions alone do not determine the work performed."""
        p = self.params
        if self.kind == "conv2d":
            f = [p.get("batch", 1), p.get("in_ch", 1), p.get("out_ch", 1),
                 p.get("kernel", 1), p.get("padding", 0), p.get("stride", 1),
                 p.get("image", 1)]
        elif self.kind == "linear":
            f = [p.get("batch", 1), p.get("in_f", 1), p.get("out_f", 1),
                 p.get("bias", 0), 0, 0, 0]
        elif self.kind == "bmm":
            f = [p.get("b", 1), p.get("m", 1), p.get("n", 1), p.get("k", 1),
                 0, 0, 0]
        elif self.kind == "recurrent":
            f = [p.get("batch", 1), p.get("in_f", 1), p.get("hidden", 1),
                 p.get("seq", 1), p.get("layers", 1), p.get("bidir", 0),
                 p.get("bias", 0)]
        else:
            f = [self.cost.intensity, 0, 0, 0, 0, 0, 0]
        f = f + [self.cost.flops, self.cost.bytes_accessed]
        return [float(x) for x in f]


def _json_safe(v: Any) -> Any:
    """Coerce an op-params value into something ``json.dump`` accepts."""
    if isinstance(v, (bool, str)) or v is None:
        return v
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        return float(v)
    if isinstance(v, (tuple, list)):
        return [_json_safe(x) for x in v]
    return str(v)


class TraceValidationError(ValueError):
    """A trace wire document failed strict validation.

    The ONE exception type ``Op.from_dict`` / ``TrackedTrace.from_dict``
    / ``from_json`` raise on malformed input — missing or mistyped
    fields, NaN/negative times, type-confused shapes, absurd op counts —
    so obvious poison is rejected at the wire (the front ends map
    ``ValueError`` to a 400) instead of crashing deep inside numpy once
    the engine consumes the arrays.  Valid documents decode exactly as
    before: the bitwise round-trip guarantees below are unchanged."""


#: params keys ``Op.feature_vector`` feeds through ``float()`` per
#: kernel-varying kind — these must be numeric when present, or MLP
#: scoring would crash mid-engine-pass long after admission
_FEATURE_PARAM_KEYS = {
    "conv2d": ("batch", "in_ch", "out_ch", "kernel", "padding", "stride",
               "image"),
    "linear": ("batch", "in_f", "out_f", "bias"),
    "bmm": ("b", "m", "n", "k"),
    "recurrent": ("batch", "in_f", "hidden", "seq", "layers", "bidir",
                  "bias"),
}

_MAX_OPS_DEFAULT = 500_000


def _trace_max_ops() -> int:
    """``REPRO_TRACE_MAX_OPS`` (default 500000): the wire-entry cap on
    ops per trace.  Parsed leniently (the env-knob policy: malformed
    overrides keep the default) — duplicated from ``core.batched`` 's
    ``env_int`` because importing it here would be a cycle."""
    raw = os.environ.get("REPRO_TRACE_MAX_OPS")
    if raw is None:
        return _MAX_OPS_DEFAULT
    try:
        v = int(raw)
    except ValueError:
        return _MAX_OPS_DEFAULT
    return v if v > 0 else _MAX_OPS_DEFAULT


def _v_str(v: Any, where: str) -> str:
    if not isinstance(v, str):
        raise TraceValidationError(
            f"{where}: expected a string, got {type(v).__name__}")
    return v


def _v_num(v: Any, where: str, allow_none: bool = False,
           integral: bool = False):
    """Validate one numeric field: a real, finite, non-negative number
    (numpy scalars welcome; bools and numeric *strings* are rejected —
    a type-confused field must not silently coerce, or the decode would
    no longer round-trip bitwise)."""
    if v is None and allow_none:
        return None
    if isinstance(v, bool) or not isinstance(v, numbers.Real):
        raise TraceValidationError(
            f"{where}: expected a number, got {type(v).__name__}: {v!r}")
    f = float(v)
    if not math.isfinite(f):
        raise TraceValidationError(f"{where}: must be finite, got {f!r}")
    if f < 0:
        raise TraceValidationError(f"{where}: must be >= 0, got {f!r}")
    if integral:
        if f != int(f):
            raise TraceValidationError(
                f"{where}: must be an integer, got {f!r}")
        return int(f)
    return f


def _v_shapes(v: Any, where: str) -> Tuple[Tuple[int, ...], ...]:
    if not isinstance(v, (list, tuple)):
        raise TraceValidationError(
            f"{where}: expected a list, got {type(v).__name__}")
    out = []
    for i, s in enumerate(v):
        if not isinstance(s, (list, tuple)):
            raise TraceValidationError(
                f"{where}[{i}]: expected a shape list, "
                f"got {type(s).__name__}")
        out.append(tuple(_v_num(x, f"{where}[{i}]", integral=True)
                         for x in s))
    return tuple(out)



@dataclasses.dataclass
class TraceArrays:
    """Structure-of-arrays view of a trace (one row per op).

    This is the input format of the vectorized fleet-prediction engine
    (``core/batched.py``): all per-op scalars are pulled out of the ``Op``
    objects once, so predicting against N destination devices is pure
    array math instead of N Python loops over the op list.

    ``measured_ms`` is NaN for ops without an origin measurement;
    ``kind_ids[i]`` indexes into ``kinds``; ``op_features`` are the *raw*
    (un-log-transformed) 9-dim MLP op features of :meth:`Op.feature_vector`.
    """
    flops: np.ndarray            # (n_ops,)
    bytes_accessed: np.ndarray   # (n_ops,)
    intensity: np.ndarray        # (n_ops,)
    measured_ms: np.ndarray      # (n_ops,) NaN where unmeasured
    multiplicity: np.ndarray     # (n_ops,)
    kernel_varying: np.ndarray   # (n_ops,) bool
    kind_ids: np.ndarray         # (n_ops,) int32 index into ``kinds``
    kinds: List[str]             # unique kinds, sorted
    op_features: np.ndarray      # (n_ops, 9) raw MLP op features
    _fingerprint: Optional[str] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def n_ops(self) -> int:
        return int(self.flops.shape[0])

    def fingerprint(self) -> str:
        """Stable content hash, used as a result-cache key.

        Memoized: the serving path fingerprints every trace of every
        query (cache keys, sweep dedup), and the arrays are treated as
        immutable once built."""
        if self._fingerprint is None:
            h = hashlib.sha1()
            for arr in (self.flops, self.bytes_accessed, self.measured_ms,
                        self.multiplicity, self.kind_ids, self.op_features):
                h.update(np.ascontiguousarray(arr).tobytes())
            h.update("|".join(self.kinds).encode())
            self._fingerprint = h.hexdigest()
        return self._fingerprint


@dataclasses.dataclass
class TrackedTrace:
    """The result of tracking one training/serving iteration."""
    ops: List[Op]
    origin_device: str
    label: str = "iteration"
    #: share of the iteration's time ``measure("wallclock")`` timed for
    #: real (the rest fell back to the simulator); None otherwise
    covered_fraction: Optional[float] = dataclasses.field(
        default=None, repr=False, compare=False)
    #: device type of the tracked tensors ("cpu" / "cuda"), None for a
    #: decoded trace: ``measure("wallclock")`` checks it against the origin
    device_type: Optional[str] = dataclasses.field(
        default=None, repr=False, compare=False)
    _arrays: Optional[TraceArrays] = dataclasses.field(
        default=None, repr=False, compare=False)
    _fp: Optional[str] = dataclasses.field(
        default=None, repr=False, compare=False)

    # ---- aggregate views -------------------------------------------------
    @property
    def run_time_ms(self) -> float:
        times = [(op.predicted_ms if op.predicted_ms is not None
                  else op.measured_ms) for op in self.ops]
        if any(t is None for t in times):
            raise ValueError("trace has unmeasured ops; call measure() first")
        return float(sum(t * op.multiplicity
                         for t, op in zip(times, self.ops)))

    @property
    def total_cost(self) -> OpCost:
        total = OpCost()
        for op in self.ops:
            total = total + op.cost.scaled(op.multiplicity)
        return total

    def breakdown(self) -> Dict[str, float]:
        """Per-kind time breakdown in ms (paper Fig. 4)."""
        out: Dict[str, float] = {}
        for op in self.ops:
            t = op.predicted_ms if op.predicted_ms is not None \
                else (op.measured_ms or 0.0)
            out[op.kind] = out.get(op.kind, 0.0) + t * op.multiplicity
        return out

    def to_arrays(self, refresh: bool = False) -> TraceArrays:
        """Structure-of-arrays export for the vectorized prediction engine.

        The result is cached on the trace (per-op Python extraction is the
        last scalar loop on the fleet path); :meth:`measure` invalidates it.
        Pass ``refresh=True`` after mutating ops by hand."""
        if self._arrays is not None and not refresh:
            return self._arrays
        self._fp = None                 # fingerprint follows the arrays
        n = len(self.ops)
        kinds = sorted({op.kind for op in self.ops})
        kind_index = {k: i for i, k in enumerate(kinds)}
        flops = np.empty(n, np.float64)
        bytes_accessed = np.empty(n, np.float64)
        intensity = np.empty(n, np.float64)
        measured = np.full(n, np.nan, np.float64)
        mult = np.empty(n, np.float64)
        varying = np.zeros(n, bool)
        kind_ids = np.empty(n, np.int32)
        feats = np.zeros((n, 9), np.float64)
        for i, op in enumerate(self.ops):
            flops[i] = op.cost.flops
            bytes_accessed[i] = op.cost.bytes_accessed
            intensity[i] = op.cost.intensity
            if op.measured_ms is not None:
                measured[i] = op.measured_ms
            mult[i] = op.multiplicity
            varying[i] = op.kernel_varying
            kind_ids[i] = kind_index[op.kind]
            feats[i] = op.feature_vector()
        self._arrays = TraceArrays(
            flops=flops, bytes_accessed=bytes_accessed, intensity=intensity,
            measured_ms=measured, multiplicity=mult, kernel_varying=varying,
            kind_ids=kind_ids, kinds=kinds, op_features=feats)
        return self._arrays

    def fingerprint(self) -> str:
        """Content hash of the trace (ops + origin), for result caches.

        Memoized alongside the SoA cache (``to_arrays``); invalidated by
        :meth:`measure` and by ``to_arrays(refresh=True)``."""
        if self._fp is None:
            h = hashlib.sha1(self.to_arrays().fingerprint().encode())
            h.update(self.origin_device.encode())
            self._fp = h.hexdigest()
        return self._fp

    # ---- serialization ---------------------------------------------------
    # Wire-format guarantees (the prediction service ships traces as
    # these documents): from_json(to_json(t)) reproduces t's fingerprint,
    # run_time_ms, and every prediction BITWISE — Python floats survive
    # json round-trips exactly (shortest-repr), and to_dict coerces all
    # numerics to native Python numbers.  to_dict(from_dict(d)) == d, so
    # re-serialization is idempotent.  Pinned by tests/test_trace_wire.py.
    def to_dict(self) -> Dict[str, Any]:
        """JSON-safe record: the golden-trace on-disk and service wire
        format (see the round-trip guarantees above)."""
        return {"origin_device": self.origin_device, "label": self.label,
                "ops": [op.to_dict() for op in self.ops]}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "TrackedTrace":
        """Decode a trace document, validating every field.

        Raises :class:`TraceValidationError` (a ``ValueError``; front
        ends answer 400) on malformed input: wrong container types,
        mistyped fields, NaN/negative times, op counts over
        ``REPRO_TRACE_MAX_OPS``.  The origin device is deliberately NOT
        checked against the registry here — an unknown origin is a
        semantic failure the engine reports (and the quarantine layer
        tracks), not a malformed document."""
        if not isinstance(d, dict):
            raise TraceValidationError(
                f"trace document must be an object, "
                f"got {type(d).__name__}")
        try:
            ops_doc, origin = d["ops"], d["origin_device"]
        except KeyError as e:
            raise TraceValidationError(
                f"trace document missing field {e}") from None
        if not isinstance(ops_doc, list):
            raise TraceValidationError(
                f"trace.ops must be a list, got {type(ops_doc).__name__}")
        max_ops = _trace_max_ops()
        if len(ops_doc) > max_ops:
            raise TraceValidationError(
                f"trace has {len(ops_doc)} ops, over the wire-entry cap "
                f"of {max_ops} (REPRO_TRACE_MAX_OPS)")
        origin = _v_str(origin, "trace.origin_device")
        label = _v_str(d.get("label", "iteration"), "trace.label")
        return TrackedTrace(ops=[Op.from_dict(o) for o in ops_doc],
                            origin_device=origin, label=label)

    def to_json(self) -> str:
        import json
        return json.dumps(self.to_dict(), indent=1)

    @staticmethod
    def from_json(text: str) -> "TrackedTrace":
        import json
        try:
            doc = json.loads(text)
        except json.JSONDecodeError as e:
            raise TraceValidationError(
                f"trace document is not valid JSON: {e}") from None
        return TrackedTrace.from_dict(doc)

    def measure(self, method: str = "simulate") -> "TrackedTrace":
        """Fill ``measured_ms`` for every op on the origin device:
        ``"simulate"`` with the origin's spec, ``"wallclock"`` by timing
        each op on the device the origin names (``cpu-host``: the host;
        ``H100-SXM``: the card), which must be the device the trace was
        tracked on (``calibration.measure_trace_inplace``)."""
        self._arrays = None  # measured_ms changes under the SoA cache
        self._fp = None
        if method == "simulate":
            from repro_torch.core import simulator
            dev = devices.get(self.origin_device)
            for op in self.ops:
                op.measured_ms = simulator.op_time_ms(op, dev)
        elif method == "wallclock":
            from repro_torch.core import calibration
            self.covered_fraction = calibration.measure_trace_inplace(self)
        else:
            raise ValueError(f"unknown measure method {method!r}")
        return self

    def to_device(self, dest: str, predictor=None,
                  device=None) -> "TrackedTrace":
        """Predict this trace's execution on a different device (Listing
        1), by default with the ``default_predictor`` on ``device``."""
        from repro_torch.core import predictor as predictor_mod
        pred = predictor or predictor_mod.default_predictor(device=device)
        return pred.predict_trace(self, dest)


# ---------------------------------------------------------------------------
# The tracker
# ---------------------------------------------------------------------------
#: aten calls that are autograd's bookkeeping, not computation: they
#: launch nothing and the reference's jaxprs have no counterpart
_UNTRACKED = {"detach", "alias", "lift_fresh"}


def _shapes(x) -> Tuple[Tuple[int, ...], ...]:
    return tuple(tuple(t.shape) for t in costmodel.tensors_of(x))


def _dtype_name(out) -> str:
    ts = costmodel.tensors_of(out)
    return str(ts[0].dtype).replace("torch.", "") if ts else "float32"


def _classify_dot(cost_params) -> Tuple[str, Dict[str, Any]]:
    b = cost_params.get("b", 1)
    m, n, k = (cost_params.get(x, 1) for x in ("m", "n", "k"))
    if b > 1:
        return "bmm", {"b": b, "m": m, "n": n, "k": k}
    return "linear", {"batch": m, "in_f": k, "out_f": n, "bias": 0,
                      "b": b, "m": m, "n": n, "k": k}


def _conv_geometry(args):
    """(stride, padding, dilation, transposed, dilated kernel extent) of
    a convolution's args (``aten.convolution`` and
    ``aten.convolution_backward`` both carry ``stride, padding, dilation,
    transposed`` in that order, behind two or three tensors)."""
    w = args[2] if len(args) == 11 else args[1]
    at = 4 if len(args) == 11 else 3
    stride, padding, dilation = (int(args[at][0]), int(args[at + 1][0]),
                                 int(args[at + 2][0]))
    kd = dilation * (w.shape[2] - 1) + 1
    return stride, padding, dilation, bool(args[at + 3]), kd


def _classify_conv(args) -> Dict[str, Any]:
    """The reference's ``_classify_conv`` params of ``aten.convolution``.

    A transposed convolution is recorded as JAX's ``conv_transpose``
    records it: the convolution of the stride-dilated input with the
    flipped kernel, so stride 1 and padding ``kd - 1 - padding``."""
    x, w = args[0], args[1]
    stride, padding, _, transposed, kd = _conv_geometry(args)
    groups = int(args[8])
    if transposed:
        return {"batch": x.shape[0], "in_ch": x.shape[1],
                "out_ch": w.shape[1] * groups, "kernel": w.shape[2],
                "stride": 1, "padding": kd - 1 - padding,
                "image": x.shape[2]}
    return {"batch": x.shape[0], "in_ch": x.shape[1], "out_ch": w.shape[0],
            "kernel": w.shape[2], "stride": stride, "padding": padding,
            "image": x.shape[2]}


def _conv_grad_params(which: str, args) -> Dict[str, Any]:
    """Params of one gradient of ``aten.convolution_backward``, as the
    reference's ``_classify_conv`` records the convolution JAX's VJP runs
    for it (``_conv_general_dilated_transpose_lhs`` / ``_rhs``): the grad
    input convolves the grad output with the kernel (stride 1 and padding
    ``kd - 1 - p`` for a plain convolution, the forward stride and
    padding for a transposed one); the grad weight convolves the input,
    batch and channels swapped, with the grad output as its kernel."""
    go, x = args[0], args[1]
    stride, padding, dilation, transposed, kd = _conv_geometry(args)
    if which == "input":
        return {"batch": go.shape[0], "in_ch": go.shape[1],
                "out_ch": x.shape[1], "kernel": args[2].shape[2],
                "stride": stride if transposed else 1,
                "padding": padding if transposed else kd - 1 - padding,
                "image": go.shape[2]}
    return {"batch": x.shape[1], "in_ch": x.shape[0], "out_ch": go.shape[1],
            "kernel": go.shape[2], "stride": 1 if transposed else dilation,
            "padding": kd - 1 - padding if transposed else padding,
            "image": x.shape[2]}


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor operand of a recorded aten call: what a replay needs to
    make one like it (the values are drawn anew)."""
    shape: Tuple[int, ...]
    stride: Tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class AtenCall:
    """One aten call as the tracker saw it, tensors as
    :class:`TensorSpec`: ``func(*args, **kwargs)`` again on fresh
    operands times the kernel the iteration ran."""
    func: Any
    args: Tuple[Any, ...]
    kwargs: Dict[str, Any]


def _spec(x):
    if isinstance(x, torch.Tensor):
        return TensorSpec(tuple(x.shape), tuple(x.stride()), x.dtype)
    if isinstance(x, (list, tuple)):
        return type(x)(_spec(v) for v in x)
    return x


def _ops_of(func, args, kwargs, out) -> List[Op]:
    """The Op records of one aten call (one, or one per gradient of a
    ``convolution_backward``, each replaying that gradient alone)."""
    operands = tuple(args) + tuple(kwargs.values())
    spec_args = _spec(tuple(args))
    spec_kwargs = {k: _spec(v) for k, v in kwargs.items()}
    if costmodel.packet_name(func) == "convolution_backward":
        ops = []
        for which, cost, _ in costmodel.conv_grad_costs(args, out):
            slot = ("input", "weight", "bias").index(which)
            grad = out[slot]
            mask = [i == slot for i in range(3)]
            call = AtenCall(func, spec_args[:10] + (mask,), spec_kwargs)
            if which == "bias":
                ops.append(Op(name="reduce_sum", kind="reduce_sum",
                              cost=cost, in_shapes=_shapes(args[0]),
                              out_shapes=_shapes(grad),
                              dtype=_dtype_name(grad), calls=(call,)))
                continue
            reads = (args[0], args[2]) if which == "input" \
                else (args[1], args[0])
            ops.append(Op(name="conv_general_dilated", kind="conv2d",
                          cost=cost, params=_conv_grad_params(which, args),
                          in_shapes=_shapes(reads), out_shapes=_shapes(grad),
                          dtype=_dtype_name(grad), calls=(call,)))
        return ops
    cost, cparams = costmodel.op_cost(func, operands, out)
    name = costmodel.prim_name(func)
    if name == "dot_general":
        kind, params = _classify_dot(cparams)
        if costmodel.packet_name(func).rstrip("_") in ("addmm", "addmv"):
            params["bias"] = 1
    elif name == "conv_general_dilated":
        kind, params = "conv2d", _classify_conv(args)
    else:
        kind, params = name, dict(cparams)
    return [Op(name=name, kind=kind, cost=cost, params=params,
               in_shapes=_shapes(operands), out_shapes=_shapes(out),
               dtype=_dtype_name(out),
               calls=(AtenCall(func, spec_args, spec_kwargs),))]


def _recurrent_params(region: Sequence[Op], seq: int) -> Dict[str, Any]:
    """The reference's ``_recurrent_params`` over a region's matmuls:
    the largest m, k and n of its dot products."""
    hidden = batch = in_f = 1
    for op in region:
        if op.name == "dot_general":
            batch = max(batch, op.params.get("m", 1))
            in_f = max(in_f, op.params.get("k", 1))
            hidden = max(hidden, op.params.get("n", 1))
    return {"batch": batch, "in_f": in_f, "hidden": hidden, "seq": seq,
            "layers": 1, "bidir": 0, "bias": 0}


class _Recorder(TorchDispatchMode):
    """The dispatch mode behind :class:`OperationTracker`: appends the Op
    records of every aten call, or of an open :func:`recurrent_scan`
    region, which closes into one ``recurrent`` op."""

    def __init__(self):
        super().__init__()
        self.ops: List[Op] = []
        self.device_types: set = set()
        self._regions: List[List[Op]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if costmodel.packet_name(func) not in _UNTRACKED:
            for t in costmodel.tensors_of(out):
                self.device_types.add(t.device.type)
            sink = self._regions[-1] if self._regions else self.ops
            sink.extend(_ops_of(func, args, kwargs, out))
        return out

    def open_region(self) -> None:
        self._regions.append([])

    def close_region(self, seq: int, inputs, outputs) -> None:
        region = self._regions.pop()
        cost = OpCost()
        for op in region:
            cost = cost + op.cost
        sink = self._regions[-1] if self._regions else self.ops
        sink.append(Op(name="scan", kind="recurrent", cost=cost,
                       params=_recurrent_params(region, seq),
                       in_shapes=_shapes(inputs), out_shapes=_shapes(outputs),
                       dtype=_dtype_name(outputs),
                       calls=tuple(c for op in region for c in op.calls)))


def _active_recorder() -> Optional[_Recorder]:
    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, _Recorder):
            return mode
    return None


def _scan_loop(cell, carry, xs, consts):
    ys = []
    for t in range(xs.shape[0]):
        carry, y = cell(carry, xs[t], *consts)
        ys.append(y)
    return tuple(carry), torch.stack(ys)


class _RecurrentScan(torch.autograd.Function):
    """One recurrent region forward, one backward.  The forward keeps
    the cell loop's own autograd graph (as JAX keeps a scan's residuals)
    and the backward differentiates through it: recomputing the loop
    there would add the forward's matmuls to the backward region, which
    JAX's transposed scan does not run."""

    @staticmethod
    def forward(ctx, cell, n_carry, xs, *tensors):
        ctx.set_materialize_grads(False)
        rec = _active_recorder()
        if rec is not None:
            rec.open_region()
        inputs = (xs,) + tensors
        if any(ctx.needs_input_grad[2:]):
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(t.requires_grad)
                          for t in inputs]
                carry, ys = _scan_loop(cell, tuple(leaves[1:1 + n_carry]),
                                       leaves[0], leaves[1 + n_carry:])
            ctx.leaves, ctx.outs = leaves, carry + (ys,)
            outs = tuple(o.detach() for o in ctx.outs)
        else:
            carry, ys = _scan_loop(cell, tensors[:n_carry], xs,
                                   tensors[n_carry:])
            outs = carry + (ys,)
        if rec is not None:
            rec.close_region(xs.shape[0], inputs, outs)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        rec = _active_recorder()
        if rec is not None:
            rec.open_region()
        pairs = [(o, g) for o, g in zip(ctx.outs, grads)
                 if g is not None and o.requires_grad]
        wanted = [i for i, t in enumerate(ctx.leaves) if t.requires_grad
                  and ctx.needs_input_grad[2 + i]]
        got = torch.autograd.grad([o for o, _ in pairs],
                                  [ctx.leaves[i] for i in wanted],
                                  [g for _, g in pairs], allow_unused=True)
        out: List[Optional[torch.Tensor]] = [None] * len(ctx.leaves)
        for i, g in zip(wanted, got):
            out[i] = g
        if rec is not None:
            rec.close_region(ctx.outs[-1].shape[0], grads,
                             [g for g in out if g is not None])
        del ctx.leaves, ctx.outs
        return (None, None, *out)


def recurrent_scan(cell: Callable, carry: Sequence[torch.Tensor],
                   xs: torch.Tensor,
                   consts: Sequence[torch.Tensor] = ()):
    """``lax.scan`` for a cell that holds a matmul: the port's
    ``recurrent`` op.

    ``cell(carry, x_t, *consts) -> (carry, y_t)`` runs for each
    ``x_t = xs[t]``; returns ``(final carry, ys)`` with ``ys`` stacked on
    a leading axis.  ``carry`` is a tuple of tensors and ``consts`` the
    tensors the cell reads at every step (weights), both differentiable.
    Under :class:`OperationTracker` the forward loop is one ``recurrent``
    op, and its backward another, as the reference records a scan and its
    transpose.  Eager PyTorch's ``nn.LSTM`` is not used: on CUDA it runs
    cuDNN's fused RNN, on the CPU a loop of matmuls, so the card and the
    CPU would give different traces."""
    carry = tuple(carry)
    outs = _RecurrentScan.apply(cell, len(carry), xs, *carry, *consts)
    return tuple(outs[:-1]), outs[-1]


class OperationTracker:
    """Tracks a step function and measures per-op times on the origin
    (see the module docstring)."""

    def __init__(self, origin_device: str = "cpu-host",
                 measure: str = "simulate"):
        self.origin_device = origin_device
        self.measure_method = measure

    def track(self, fn, *args, label: str = "iteration",
              **kwargs) -> TrackedTrace:
        """Run ``fn(*args, **kwargs)`` once, recording its aten calls."""
        with _Recorder() as rec:
            fn(*args, **kwargs)
        kinds = rec.device_types
        trace = TrackedTrace(
            ops=rec.ops, origin_device=self.origin_device, label=label,
            device_type=("cuda" if "cuda" in kinds else
                         "cpu" if kinds else None))
        return trace.measure(self.measure_method)
