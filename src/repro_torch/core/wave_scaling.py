"""Wave scaling (paper Sec. 3.3) and roofline-based γ selection (Sec. 4.2).

Equation 1 (exact, with wave quantization):

    T_d = ceil(B/W_d) * ((D_o/D_d) * (W_d/W_o))^γ * (C_o/C_d)^(1-γ)
          * ceil(B/W_o)^(-1) * T_o

Equation 2 (the large-B limit Habitat uses in practice):

    T_d = (D_o/D_d)^γ * (W_o/W_d)^(1-γ) * (C_o/C_d)^(1-γ) * T_o

Equation 3 (γ from arithmetic intensity x and destination ridge point R):

    γ = 1 - 0.5 x / R          if x <  R      (memory-bandwidth bound side)
    γ = 0.5 R / x              otherwise      (compute bound side)

The scalar functions mirror ``repro.core.wave_scaling`` on Python floats.
The vectorized ones run as float64 torch tensors on the engine's device:
one expression (``_factor_core``) serves the (n_ops x n_dev) grid and the
flat per-cell spelling, so every cell of a masked sweep is computed by
the same operation sequence as the grid element it stands for.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.devices import DeviceSpec, OriginArrays
from repro_torch.core.trace import Op

#: Working-set bytes of one grid tile (a thread block's slice on GPUs; an
#: 8x128-lane VMEM sub-tile batch on TPUs).  The same constant is used by the
#: simulator so the exact Eq. 1 is testable against it.
TILE_BYTES = 64.0 * 1024

#: per-kernel dispatch overhead in ms (matches simulator._LAUNCH_OVERHEAD_MS)
DISPATCH_OVERHEAD_MS = {"gpu": 5e-3, "tpu": 1.5e-3, "trainium": 2e-3,
                        "cpu": 2e-2}


def num_tiles(op: Op) -> int:
    """B: the number of grid tiles ("thread blocks") of an op."""
    return max(1, int(math.ceil(op.cost.bytes_accessed / TILE_BYTES)))


def gamma(op: Op, dest: DeviceSpec) -> float:
    """Eq. 3.  γ ∈ [0, 1]: 1 = fully memory-bandwidth bound."""
    x = op.cost.intensity
    r = dest.ridge_point
    if x <= 0.0:
        return 1.0
    if x < r:
        return 1.0 - 0.5 * x / r
    return 0.5 * r / x


def scale_time(t_o_ms: float, op: Op, origin: DeviceSpec, dest: DeviceSpec,
               exact: bool = False, model_overhead: bool = False) -> float:
    """Scale a measured time T_o from ``origin`` to ``dest`` (Eq. 1 / Eq. 2).

    ``model_overhead`` (beyond paper): treat the fixed kernel dispatch
    latency as unscalable — subtract the origin's before scaling, add the
    destination's after.  Matters for launch-bound small kernels."""
    g = gamma(op, dest)
    d_ratio = origin.mem_bandwidth / dest.mem_bandwidth
    c_ratio = origin.clock_hz / dest.clock_hz
    w_o, w_d = origin.wave_size, dest.wave_size
    if exact:
        b = num_tiles(op)
        waves_d = math.ceil(b / w_d)
        waves_o = math.ceil(b / w_o)
        factor = (waves_d
                  * (d_ratio * (w_d / w_o)) ** g
                  * c_ratio ** (1.0 - g)
                  / waves_o)
    else:
        factor = (d_ratio ** g
                  * (w_o / w_d) ** (1.0 - g)
                  * c_ratio ** (1.0 - g))
    if model_overhead:
        oh_o = DISPATCH_OVERHEAD_MS[origin.kind]
        oh_d = DISPATCH_OVERHEAD_MS[dest.kind]
        return max(t_o_ms - oh_o, 0.0) * factor + oh_d
    return t_o_ms * factor


# ---------------------------------------------------------------------------
# Vectorized fleet path: Eqs. 1-3 as float64 tensors on the engine's device.
# ---------------------------------------------------------------------------
def origin_view(origin: Union[DeviceSpec, OriginArrays],
                device: torch.device) -> SimpleNamespace:
    """Origin-side terms as float64 tensors: shape (1,) for one spec (all
    ops measured on one device), (n_ops,) for per-op origin arrays (ragged
    stacks mixing origins).  ``overhead`` is the dispatch overhead of the
    overhead model."""
    if isinstance(origin, DeviceSpec):
        bw, ck, w = [origin.mem_bandwidth], [origin.clock_hz], \
            [float(origin.wave_size)]
        oh = [DISPATCH_OVERHEAD_MS[origin.kind]]
    else:
        bw, ck, w = origin.mem_bandwidth, origin.clock_hz, origin.wave_size
        oh = [DISPATCH_OVERHEAD_MS[k] for k in origin.kinds]
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    return SimpleNamespace(mem_bandwidth=f64(bw), clock_hz=f64(ck),
                           wave_size=f64(w), overhead=f64(oh))


def dest_overheads(dv) -> torch.Tensor:
    """(n_dev,) destination dispatch overheads of a device-array view."""
    return torch.as_tensor([DISPATCH_OVERHEAD_MS[k] for k in dv.kinds],
                           dtype=torch.float64,
                           device=dv.mem_bandwidth.device)


def _gamma_core(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Eq. 3 on broadcast-ready tensors (grid and flat spellings)."""
    g = torch.where(x < r, 1.0 - 0.5 * x / r,
                    0.5 * r / torch.where(x > 0.0, x, 1.0))
    return torch.where(x <= 0.0, 1.0, g)


def gamma_vec(intensity: torch.Tensor, ridge: torch.Tensor) -> torch.Tensor:
    """Eq. 3 for every (op, destination) pair: (n_ops,) x (n_dev,) ->
    (n_ops, n_dev)."""
    return _gamma_core(intensity[:, None], ridge[None, :])


def num_tiles_vec(bytes_accessed: torch.Tensor) -> torch.Tensor:
    """Vectorized ``num_tiles``: B per op."""
    return torch.clamp(torch.ceil(bytes_accessed / TILE_BYTES), min=1.0)


def _pow(base: torch.Tensor, exponent: torch.Tensor) -> torch.Tensor:
    """``base ** exponent``, the same bits wherever an element sits.

    On the CPU torch's vectorized pow and its scalar tail loop can round
    one element differently, so an op would get other bits in another
    co-batch and a coalesced answer would drift from the direct one;
    numpy's power rounds every element alike.  On CUDA every element
    runs the same device function."""
    if base.device.type != "cpu":
        return base ** exponent
    b, e = torch.broadcast_tensors(base, exponent)
    return torch.from_numpy(np.power(b.numpy(), e.numpy()))


def _factor_core(intensity, bytes_accessed, o_bw, o_ck, o_w, d_bw, d_ck,
                 d_w, d_ridge, exact: bool) -> torch.Tensor:
    """The t-independent scaling factor on broadcast-ready tensors."""
    g = _gamma_core(intensity, d_ridge)
    d_ratio = o_bw / d_bw
    c_ratio = o_ck / d_ck
    if exact:
        b = num_tiles_vec(bytes_accessed)
        waves_d = torch.ceil(b / d_w)
        waves_o = torch.ceil(b / o_w)
        return (waves_d
                * _pow(d_ratio * (d_w / o_w), g)
                * _pow(c_ratio, 1.0 - g)
                / waves_o)
    return (_pow(d_ratio, g)
            * _pow(o_w / d_w, 1.0 - g)
            * _pow(c_ratio, 1.0 - g))


def wave_factor_vec(intensity: torch.Tensor, bytes_accessed: torch.Tensor,
                    ov: SimpleNamespace, dv,
                    exact: bool = False) -> torch.Tensor:
    """The (n_ops, n_dev) factor grid of :func:`scale_times_vec`.

    Element [i, j] is the multiplier applied to op i's measured time to
    land on device j — a pure function of the op arrays and the fleet,
    which is why the engine caches it across sweeps."""
    return _factor_core(
        intensity[:, None], bytes_accessed[:, None],
        ov.mem_bandwidth[:, None], ov.clock_hz[:, None],
        ov.wave_size[:, None], dv.mem_bandwidth[None, :],
        dv.clock_hz[None, :], dv.wave_size[None, :],
        dv.ridge_point[None, :], exact)


def combine_wave_factor(t_o_ms: torch.Tensor, factor: torch.Tensor,
                        overheads: Optional[Tuple] = None) -> torch.Tensor:
    """Apply a (possibly cached) factor to measured times.  ``t_o_ms``
    and the overhead terms are broadcast-ready against ``factor``."""
    if overheads is not None:
        oh_o, oh_d = overheads
        return torch.clamp(t_o_ms - oh_o, min=0.0) * factor + oh_d
    return t_o_ms * factor


def scale_times_vec(t_o_ms: torch.Tensor, intensity: torch.Tensor,
                    bytes_accessed: torch.Tensor, ov: SimpleNamespace, dv,
                    exact: bool = False,
                    model_overhead: bool = False) -> torch.Tensor:
    """Vectorized :func:`scale_time`: one (n_ops x n_devices) grid at once.

    ``ov`` is :func:`origin_view` of one spec or of per-op origin arrays;
    ``dv`` a :meth:`DeviceArrays.on` view."""
    factor = wave_factor_vec(intensity, bytes_accessed, ov, dv, exact=exact)
    overheads = ((ov.overhead[:, None], dest_overheads(dv)[None, :])
                 if model_overhead else None)
    return combine_wave_factor(t_o_ms[:, None], factor, overheads)


def scale_times_flat(t_o_ms: torch.Tensor, intensity: torch.Tensor,
                     bytes_accessed: torch.Tensor, ov: SimpleNamespace, dv,
                     dest_idx: torch.Tensor, exact: bool = False,
                     model_overhead: bool = False) -> torch.Tensor:
    """Wave scaling over a flat list of (op, device) cells, shape (M,).

    Every input is per cell: ``t_o_ms``, ``intensity``, ``bytes_accessed``
    and the ``ov`` tensors are gathered to one entry per cell, and
    ``dest_idx[k]`` selects cell ``k``'s destination.  Same expression as
    the grid, so a masked sweep's cells equal the full grid's."""
    j = dest_idx
    factor = _factor_core(intensity, bytes_accessed, ov.mem_bandwidth,
                          ov.clock_hz, ov.wave_size, dv.mem_bandwidth[j],
                          dv.clock_hz[j], dv.wave_size[j],
                          dv.ridge_point[j], exact)
    overheads = ((ov.overhead, dest_overheads(dv)[j])
                 if model_overhead else None)
    return combine_wave_factor(t_o_ms, factor, overheads)
