"""Real wall-clock measurement of tracked ops on the origin device.

The port of ``repro.core.calibration``, the *runtime-based* half of the
reproduction: each tracked op is run again in isolation as a standalone
callable and timed on the device the user already has, with the paper's
protocol (Sec. 4.1: 3 discarded warm-up runs, then the mean of 3
measured runs).  That device is the one the trace's origin
names: ``cpu-host`` times on the host with ``time.perf_counter()``,
``H100-SXM`` on the card with ``torch.cuda.Event``s on the current
stream.  A trace tracked on the other device raises: nothing moves
quietly between them.

:func:`build_callable` covers what the reference covers (``linear``,
``bmm``, ``conv2d``, ``recurrent``, the ``_UNARY`` and ``_ELEMENTWISE``
tables, ``reduce_*``), keyed on the reference's primitive names.  An op
the tracker recorded replays the aten calls it ran (``Op.calls``: the
same function, shapes, strides and arguments, fresh values); an op from a
decoded trace, which carries no calls, is rebuilt from its params as the
reference rebuilds it.  Rebuilding from params alone mistimes the
gradient convolutions: the grad weight is recorded, as JAX's VJP runs
it, as a convolution whose kernel is the grad output (a 112 x 112 kernel
at ResNet-50's first stage), and the params of a strided convolution's
gradients do not hold its dilation; so rebuilt, ResNet-50's and the
Inception-style net's ops summed to many times their iteration's own
time on the card (``PERF.md`` §6).  Ops outside the coverage, or
whose rebuild fails, fall back to the simulator with the origin's spec
and are flagged; :func:`measure_trace_inplace` returns the share of the
iteration's time measured for real.

Inputs are drawn on the device from one seeded ``torch.Generator`` per
measurement and reused by shape, strides and dtype: the reference's host
numpy draws would cost about 0.2 s per ResNet-50 activation.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import devices, simulator
from repro_torch.core.trace import AtenCall, Op, TensorSpec, TrackedTrace

WARMUP = 3
REPS = 3

#: the devices ``wallclock`` can time on, by origin spec name
WALLCLOCK_ORIGINS = {"cpu-host": "cpu", "H100-SXM": "cuda"}

_ELEMENTWISE = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul,
    "div": torch.div, "max": torch.maximum, "min": torch.minimum,
    "pow": torch.pow,
}
_UNARY = {
    "exp": torch.exp, "log": torch.log, "tanh": torch.tanh,
    "neg": torch.neg, "rsqrt": torch.rsqrt, "sqrt": torch.sqrt,
    "logistic": torch.sigmoid, "erf": torch.erf, "abs": torch.abs,
    "sign": torch.sign, "integer_pow": lambda x: x * x, "cos": torch.cos,
    "sin": torch.sin,
}


class RandomInputs:
    """Random operands on ``device`` from one seeded generator, reused by
    shape, strides and dtype: floats standard normal, integers 0 or 1."""

    def __init__(self, device: torch.device, seed: int = 0):
        self.device = device
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self._cache: Dict[Tuple, torch.Tensor] = {}

    def __call__(self, shape, dtype="float32", stride=None) -> torch.Tensor:
        """A tensor of ``shape`` (contiguous, or with ``stride`` over a
        storage just large enough: a stride of 0 broadcasts)."""
        dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        shape = tuple(int(n) for n in shape)
        key = (shape, None if stride is None else tuple(stride), dt)
        t = self._cache.get(key)
        if t is None:
            n = (1 + sum((d - 1) * st for d, st in zip(shape, stride))
                 if stride is not None and all(shape) else None)
            size = shape if n is None else (n,)
            if dt.is_floating_point:
                t = torch.randn(size, generator=self.generator,
                                device=self.device, dtype=torch.float32)
                t = t.to(dt)
            else:
                t = torch.randint(0, 2, size, generator=self.generator,
                                  device=self.device).to(dt)
            if n is not None:
                t = t.as_strided(shape, stride)
            self._cache[key] = t
        return t

    def operand(self, x):
        """A recorded call's argument with each :class:`TensorSpec` made
        real."""
        if isinstance(x, TensorSpec):
            return self(x.shape, x.dtype, x.stride)
        if isinstance(x, (list, tuple)):
            return type(x)(self.operand(v) for v in x)
        return x


def _replay(calls: Tuple[AtenCall, ...], rand: RandomInputs
            ) -> Tuple[Callable, tuple]:
    """A callable running ``calls`` in order on fresh operands (autograd
    off: the recorded calls are the kernels themselves)."""
    made = [(c.func, rand.operand(c.args),
             {k: rand.operand(v) for k, v in c.kwargs.items()})
            for c in calls]

    def run():
        with torch.no_grad():
            for func, args, kwargs in made:
                func(*args, **kwargs)
    return run, ()


def _time_callable(fn: Callable, *args, device=None) -> float:
    """Mean ms of ``REPS`` runs after ``WARMUP`` discarded ones, by CUDA
    events on the current stream on a CUDA ``device`` (default: that of
    the first tensor argument), else by the host clock (the host's ops
    return when done)."""
    for _ in range(WARMUP):
        fn(*args)
    if device is None:
        device = next((a.device for a in args
                       if isinstance(a, torch.Tensor)), None)
    if device is not None and torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / REPS
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn(*args)
    return (time.perf_counter() - t0) / REPS * 1e3


def _rnn(x, w, h0):
    h = h0
    for t in range(x.shape[0]):
        h = torch.tanh(torch.cat([x[t], h], -1) @ w)
    return h


def covers(op: Op) -> bool:
    """Whether ``op`` is of a kind the reference's calibration rebuilds."""
    return (op.kind in ("linear", "bmm", "conv2d", "recurrent")
            or (op.name in _UNARY and bool(op.in_shapes))
            or (op.name in _ELEMENTWISE and len(op.in_shapes) >= 2)
            or (op.name.startswith("reduce_") and bool(op.in_shapes)))


def build_callable(op: Op, rand: RandomInputs
                   ) -> Optional[Tuple[Callable, tuple]]:
    """A standalone callable for ``op`` within the reference's coverage:
    its recorded calls replayed, or without them a representative rebuild
    from its params; None outside the coverage."""
    if not covers(op):
        return None
    if op.calls:
        return _replay(op.calls, rand)
    p = op.params
    if op.kind == "linear":
        return torch.matmul, (rand((p["m"], p["k"])), rand((p["k"], p["n"])))
    if op.kind == "bmm":
        return torch.matmul, (rand((p["b"], p["m"], p["k"])),
                              rand((p["b"], p["k"], p["n"])))
    if op.kind == "conv2d":
        x = rand((p["batch"], p["in_ch"], p["image"], p["image"]))
        w = rand((p["out_ch"], p["in_ch"], p["kernel"], p["kernel"]))
        stride, padding = int(p["stride"]), int(p["padding"])
        return (lambda x, w: F.conv2d(x, w, stride=stride, padding=padding),
                (x, w))
    if op.kind == "recurrent":
        x = rand((p["seq"], p["batch"], p["in_f"]))
        w = rand((p["in_f"] + p["hidden"], p["hidden"]))
        h0 = rand((p["batch"], p["hidden"]))
        return _rnn, (x, w, h0)
    if op.name in _UNARY and op.in_shapes:
        return _UNARY[op.name], (rand(op.in_shapes[0], op.dtype),)
    if op.name in _ELEMENTWISE and len(op.in_shapes) >= 2:
        return _ELEMENTWISE[op.name], (rand(op.in_shapes[0], op.dtype),
                                       rand(op.in_shapes[1], op.dtype))
    return torch.sum, (rand(op.in_shapes[0], op.dtype),)


def measure_op_ms(op: Op, rand: RandomInputs,
                  origin: devices.DeviceSpec) -> Tuple[float, bool]:
    """(ms, measured_for_real) for one op on ``rand``'s device."""
    try:
        built = build_callable(op, rand)
        if built is not None:
            fn, args = built
            return _time_callable(fn, *args, device=rand.device), True
    except (RuntimeError, ValueError, TypeError, IndexError):
        pass        # an unbuildable rebuild falls back, flagged
    return simulator.op_time_ms(op, origin), False


def wallclock_device(trace: TrackedTrace) -> torch.device:
    """The device ``wallclock`` times ``trace`` on: the one its origin
    names, which must be the one its tensors were tracked on."""
    kind = WALLCLOCK_ORIGINS.get(trace.origin_device)
    if kind is None:
        raise ValueError(
            f"wallclock measures on the device the port runs on; origin "
            f"{trace.origin_device!r} is none of {sorted(WALLCLOCK_ORIGINS)}")
    if trace.device_type is not None and trace.device_type != kind:
        raise ValueError(
            f"trace {trace.label!r} was tracked on {trace.device_type} "
            f"tensors but its origin {trace.origin_device!r} is the "
            f"{kind} device: track on the origin, or name the origin "
            f"the tensors ran on")
    dev = devices.torch_device(kind)
    if kind == "cuda" and "H100" not in torch.cuda.get_device_name(dev):
        raise ValueError(
            f"origin {trace.origin_device!r} is an H100, but the card is "
            f"{torch.cuda.get_device_name(dev)!r}")
    return dev


def measure_trace_inplace(trace: TrackedTrace, seed: int = 0) -> float:
    """Fill ``measured_ms`` on every op by real measurement on the
    origin device.  Returns the fraction of iteration time covered by
    real measurements."""
    dev = wallclock_device(trace)
    origin = devices.get(trace.origin_device)
    rand = RandomInputs(dev, seed)
    real_ms = total_ms = 0.0
    for op in trace.ops:
        ms, real = measure_op_ms(op, rand, origin)
        op.measured_ms = ms
        total_ms += ms * op.multiplicity
        if real:
            real_ms += ms * op.multiplicity
    return real_ms / max(total_ms, 1e-12)


def calibrate_spec(device=None) -> dict:
    """Measure ``device``'s achieved fp32 GEMM rate (FLOP/s) and copy
    bandwidth (bytes/s), the counterparts of a spec's ``peak_flops`` and
    ``mem_bandwidth`` (Habitat ships measured bandwidths, Sec. 3.3).

    On the card the GEMM is 4096 wide and the copy 256 MiB, past the 50
    MB L2; on the host 1024 and 64 MiB, as the reference measures it.
    The fp32 GEMM runs at the precision ``torch.backends`` allows."""
    dev = devices.torch_device(device)
    rand = RandomInputs(dev)
    n = 4096 if dev.type == "cuda" else 1024
    a = rand((n, n))
    gemm_ms = _time_callable(torch.matmul, a, a, device=dev)
    big = rand(((256 if dev.type == "cuda" else 64) * 2**20 // 4,))
    copy_ms = _time_callable(lambda x: x + 1.0, big, device=dev)
    return {"peak_flops": 2.0 * n**3 / (gemm_ms * 1e-3),
            "mem_bandwidth": 2.0 * big.numel() * 4 / (copy_ms * 1e-3)}
