"""Mamba2 SSD chunk scan: a Hopper kernel and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/ssd.py`` (``ssd``).  Same
inputs and layout:

  x (B, H, L, P);  dt (B, H, L);  a (H,) negative;  bmat, cmat (B, H, L, N)

and the recurrence ``S_t = S_{t-1} exp(dt_t a) + dt_t b_t x_t^T``,
``y_t = c_t . S_t`` from ``S_0 = 0``.  It returns ``(y, state)``: y
(B, H, L, P) float32, exactly the TPU kernel's output, and the state after
the last step (B, H, N, P) float32, which the TPU kernel discards and
Mamba2's decode needs.  No D-skip: the model adds it outside.

:func:`ssd` launches the CUDA kernel (``csrc/ssd.cu``) for CUDA tensors
and counts the launch in :data:`LAUNCHES`; for CPU tensors, and only for
them, it computes :func:`ssd_plain`, a port of ``ssd_ref.py``.  The
kernel reads its inputs through strides (unit innermost stride): b and c
shared by every head may arrive as an ``expand``-ed view with head stride
0.  Its y is a (B, H, L, P) view of (B, L, H, P) memory, the layout the
model reshapes to (B, L, H * P) without a copy.  One call runs three CUDA
kernels (chunk states, state passing, output) and counts as one launch;
it allocates their scratch, (B, H, C, N, P) and (B, H, C) fp32 with C =
ceil(L / chunk).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

#: the largest chunk the kernel takes (its cumulative sum is one warp
#: scan, two steps a lane)
MAX_CHUNK = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the kernel, bumped only where it is launched
LAUNCHES: Dict[str, int] = {"ssd": 0}


def reset_launches() -> None:
    LAUNCHES["ssd"] = 0


def ssd_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              bmat: torch.Tensor, cmat: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's sequential oracle in PyTorch, one step at a time in
    fp32 (three launches a step: decay, the rank-1 update, the readout);
    also returns the state after the last step."""
    b, h, l, p = x.shape
    n = bmat.shape[-1]
    bh = b * h
    xf = x.to(torch.float32).reshape(bh, l, p)
    cf = cmat.to(torch.float32).reshape(bh, l, n)
    dtf = dt.to(torch.float32)
    decay = torch.exp(dtf * a.to(torch.float32)[None, :, None]).reshape(bh, l)
    dtb = (dtf[..., None] * bmat.to(torch.float32)).reshape(bh, l, n)
    s = torch.zeros((bh, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(l):
        # S_t = S_{t-1} exp(dt_t a) + (dt_t b_t) x_t^T;  y_t = c_t . S_t
        s = torch.baddbmm(s * decay[:, t, None, None], dtb[:, t, :, None],
                          xf[:, t, None, :])
        ys.append(torch.bmm(cf[:, t, None, :], s))
    y = torch.cat(ys, dim=1).reshape(b, h, l, p)
    return y, s.reshape(b, h, n, p)


def _check(x, dt, a, bmat, cmat, chunk: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, L, P), got {tuple(x.shape)}")
    b, h, l, _ = x.shape
    if tuple(dt.shape) != (b, h, l):
        raise ValueError(f"dt {tuple(dt.shape)} is not {(b, h, l)}")
    if tuple(a.shape) != (h,):
        raise ValueError(f"a {tuple(a.shape)} is not {(h,)}")
    if bmat.dim() != 4 or tuple(bmat.shape[:3]) != (b, h, l) or \
            tuple(cmat.shape) != tuple(bmat.shape):
        raise ValueError(f"bmat {tuple(bmat.shape)} / cmat "
                         f"{tuple(cmat.shape)} are not (B, H, L, N) with "
                         f"{(b, h, l)}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be in [1, {MAX_CHUNK}], got {chunk}")


def _check_cuda(x, dt, a, bmat, cmat) -> None:
    """Everything the CUDA launcher assumes, checked before launching."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd: tensors on {x.device} are neither CPU nor "
                         f"CUDA")
    for t, what in ((dt, "dt"), (a, "a"), (bmat, "bmat"), (cmat, "cmat")):
        if t.device != x.device:
            raise ValueError(f"ssd: {what} on {t.device}, x on {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"ssd: the kernel takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    for t, what in ((bmat, "bmat"), (cmat, "cmat")):
        if t.dtype != x.dtype:
            raise TypeError(f"ssd: {what} is {t.dtype}, x is {x.dtype}")
    for t, what in ((dt, "dt"), (a, "a")):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd: {what} must be float32, got {t.dtype}")
    for t, what in ((x, "x"), (bmat, "bmat"), (cmat, "cmat")):
        if t.stride(3) != 1:
            raise ValueError(f"ssd: {what} needs a unit innermost stride, "
                             f"got strides {t.stride()}")
    if a.stride(0) != 1:
        raise ValueError("ssd: a must be contiguous")
    cap = torch.cuda.get_device_capability(x.device)
    if cap != (9, 0):
        raise RuntimeError(
            f"ssd is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(x.device)} has capability {cap}")
    b, h, l, p = x.shape
    n = bmat.shape[-1]
    if min(b, h, l, p, n) == 0:
        raise ValueError("ssd: empty input")
    if b > 65535 or h > 65535:
        raise ValueError(f"ssd: B ({b}) and H ({h}) must be at most 65535")


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
        bmat: torch.Tensor, cmat: torch.Tensor, chunk: int = MAX_CHUNK
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, H, L, P); dt (B, H, L); a (H,); bmat, cmat (B, H, L, N)
    -> (y (B, H, L, P) float32, final state (B, H, N, P) float32).

    ``chunk`` (1..:data:`MAX_CHUNK`) is the kernel's chunk length; it
    changes only the fp32 rounding.  On CUDA: x, bmat, cmat float32 or
    bfloat16 with a unit innermost stride; dt and a float32."""
    chunk = int(chunk)
    _check(x, dt, a, bmat, cmat, chunk)
    if x.device.type == "cpu":
        return ssd_plain(x, dt, a, bmat, cmat)
    _check_cuda(x, dt, a, bmat, cmat)
    b, h, l, p = x.shape
    n = bmat.shape[-1]
    y = torch.empty((b, l, h, p), dtype=torch.float32,
                    device=x.device).permute(0, 2, 1, 3)
    state = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    n_chunks = -(-l // chunk)
    states = torch.empty((b, h, n_chunks, n, p), dtype=torch.float32,
                         device=x.device)
    cum_last = torch.empty((b, h, n_chunks), dtype=torch.float32,
                           device=x.device)
    strides = []
    for t in (x, dt, bmat, cmat, y):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        build.launch("ssd", x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                     bmat.data_ptr(), cmat.data_ptr(), y.data_ptr(),
                     state.data_ptr(), states.data_ptr(),
                     cum_last.data_ptr(), _DTYPES[x.dtype], b, h, l, p, n,
                     chunk, *strides, stream)
    build.count_launch(LAUNCHES, "ssd")
    return y, state
