"""Ground-truth execution-time model (a copy of ``repro.core.simulator``).

The paper validates Habitat against wall-clock measurements on six physical
GPUs.  The ground truth for simulated destination devices is an
*analytical device simulator* that is deliberately
richer than anything wave scaling or the MLPs can express exactly:

  * roofline time with per-op-class efficiency curves,
  * wave quantization (ceil(B/W) — the effect Eq. 1 models and Eq. 2 drops),
  * **algorithm selection** for kernel-varying ops: the efficiency of a
    matmul/conv/recurrent op depends jointly on the device *generation* and
    a bucketed shape signature, emulating cuDNN/XLA picking different
    kernels per architecture (the exact phenomenon that motivates the MLP
    predictors, Sec. 3.2),
  * fixed per-kernel launch/dispatch overhead.

Everything is deterministic (seeded by md5 hashes), so tests are stable.
"""

from __future__ import annotations

import hashlib
import math
from typing import Tuple

from repro_torch.core.devices import DeviceSpec
from repro_torch.core.trace import Op
from repro_torch.core.wave_scaling import TILE_BYTES

#: per-kernel dispatch overhead, ms
_LAUNCH_OVERHEAD_MS = {"gpu": 5e-3, "tpu": 1.5e-3, "trainium": 2e-3,
                       "cpu": 2e-2}

#: base efficiency (fraction of peak) for op classes
_MATMUL_KINDS = ("linear", "bmm", "conv2d", "recurrent")


def _h01(*parts) -> float:
    """Deterministic hash of parts -> [0, 1)."""
    s = "|".join(str(p) for p in parts).encode()
    return int(hashlib.md5(s).hexdigest()[:8], 16) / 0xFFFFFFFF


def _shape_bucket(op: Op) -> Tuple:
    """Bucketed shape signature: log2 bins of the op's key dimensions."""
    p = op.params

    def b(x):
        return int(math.log2(max(int(x), 1)) + 0.5)

    if op.kind == "conv2d":
        return (b(p.get("batch", 1)), b(p.get("in_ch", 1)),
                b(p.get("out_ch", 1)), p.get("kernel", 1),
                b(p.get("image", 1)))
    if op.kind in ("linear", "bmm"):
        return (b(p.get("b", 1)), b(p.get("m", 1)), b(p.get("n", 1)),
                b(p.get("k", 1)))
    if op.kind == "recurrent":
        return (b(p.get("batch", 1)), b(p.get("in_f", 1)),
                b(p.get("hidden", 1)), b(p.get("seq", 1)))
    return ()


def _alignment_penalty(op: Op) -> float:
    """MXU/tensor-core alignment: dims off 128-multiples lose throughput."""
    p = op.params
    dims = [p.get(k) for k in ("m", "n", "k", "out_ch", "hidden")
            if p.get(k)]
    if not dims:
        return 1.0
    pen = 1.0
    for d in dims:
        d = int(d)
        if d >= 128:
            pen *= (d // 128 * 128) / d * 0.15 + 0.85  # mild raggedness cost
        else:
            pen *= max(d / 128.0, 0.05) * 0.8 + 0.2    # small-dim penalty
    return pen


def compute_efficiency(op: Op, dev: DeviceSpec) -> float:
    """Fraction of peak FLOP/s this op's kernel achieves on ``dev``."""
    if op.kind in _MATMUL_KINDS:
        base = 0.72 * _alignment_penalty(op)
        # Algorithm selection: generation x shape-bucket interaction.  This
        # is what makes these ops *kernel-varying*: the factor does NOT
        # cancel between two devices, so same-kernel scaling is invalid.
        algo = 0.70 + 0.30 * _h01(dev.generation, op.kind, _shape_bucket(op))
        return base * algo
    # kernel-alike: efficiency depends only on the op class (same kernel
    # everywhere), so ratios between devices are clean.
    base = {"reduce_sum": 0.30, "reduce_max": 0.30, "cumsum": 0.20,
            "sort": 0.10, "top_k": 0.15}.get(op.kind, 0.50)
    return base


def memory_efficiency(op: Op, dev: DeviceSpec) -> float:
    """Fraction of peak bandwidth achieved (kernel-alike across devices)."""
    if op.kind in _MATMUL_KINDS:
        return 0.75
    if op.name in ("gather", "scatter", "dynamic_slice",
                   "dynamic_update_slice"):
        return 0.35  # random access
    return 0.82


def op_time_ms(op: Op, dev: DeviceSpec) -> float:
    """Ground-truth execution time of one launch of ``op`` on ``dev``."""
    flops_t = op.cost.flops / (dev.peak_flops * compute_efficiency(op, dev))
    mem_t = op.cost.bytes_accessed / (dev.mem_bandwidth *
                                      memory_efficiency(op, dev))
    t = max(flops_t, mem_t)  # seconds
    # Wave quantization: the last partial wave still occupies a full wave
    # slot, and sub-wave kernels leave units idle.  The square root damps
    # the penalty to model latency hiding across in-flight waves.
    b = max(1, int(math.ceil(op.cost.bytes_accessed / TILE_BYTES)))
    w = dev.wave_size
    t *= (math.ceil(b / w) / (b / w)) ** 0.5
    return t * 1e3 + _LAUNCH_OVERHEAD_MS[dev.kind]


def trace_time_ms(trace, dev: DeviceSpec) -> float:
    """Ground-truth time of a whole iteration (sum over op launches)."""
    return float(sum(op_time_ms(op, dev) * op.multiplicity
                     for op in trace.ops))
