"""Flash-attention forward: a Hopper kernel and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``).  Same signature and layout:

  q (B, H, Sq, D);  k, v (B, KV, Skv, D)  ->  o (B, H, Sq, D), q's dtype

with scale ``D ** -0.5``, a causal mask (key j <= query i, both counted
from 0), an optional sliding window (``i - j < window`` when
``window > 0``) and grouped-query heads (query head h reads kv head
``h // (H // KV)``).  Softmax state is fp32.

:func:`flash_attention` launches the CUDA kernel (``csrc/
flash_attention.cu``) for CUDA tensors and counts the launch in
:data:`LAUNCHES`; for CPU tensors, and only for them, it computes
:func:`flash_attention_plain`, a port of ``flash_attention_ref.py``.  The
kernel reads its inputs through strides (unit stride on D), so views of
the model's (B, S, H, D) activations go in without a copy, and the
output it returns is a (B, H, Sq, D) view of (B, Sq, H, D) memory.
bfloat16 inputs run on the tensor cores (P rounded to bf16 for P V, every
sum fp32) and are copied with 16-byte rows (``cp.async``): a view whose
data pointer is not 16-byte aligned or whose (b, h, s) strides are not
multiples of 8 is cloned first (the model's views never are).  float32
inputs run the FFMA kernel.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import build

#: the TPU kernel's finite mask value (never -inf: see the CUDA source)
NEG_INF = -1e30
#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the kernel, bumped only where it is launched
LAUNCHES: Dict[str, int] = {"flash_attention": 0}


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """The reference's oracle in PyTorch: repeated K/V, the whole (Sq, Skv)
    score matrix in fp32, masked with the finite NEG_INF."""
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    rep = h // kv
    kr = torch.repeat_interleave(k, rep, dim=1).to(torch.float32)
    vr = torch.repeat_interleave(v, rep, dim=1).to(torch.float32)
    s = torch.einsum("bhqd,bhsd->bhqs", q.to(torch.float32), kr) \
        * (d ** -0.5)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (kpos <= qpos)
    if window > 0:
        ok = ok & (qpos - kpos < window)
    s = s.masked_fill(~ok, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqs,bhsd->bhqd", p, vr)
    return out.to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-d: (B, H, Sq, D), (B, KV, Skv, D)")
    b, h, _, d = q.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[0] != b or \
            k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if k.shape[1] == 0 or h % k.shape[1]:
        raise ValueError(f"query heads ({h}) must be a multiple of kv heads "
                         f"({k.shape[1]})")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Everything the CUDA launcher assumes, checked before launching."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: tensors on {q.device} are "
                         f"neither CPU nor CUDA")
    for t, what in ((k, "k"), (v, "v")):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {what} on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {what} is {t.dtype}, q is "
                            f"{q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: the kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {what} needs a unit stride "
                             f"on D, got strides {t.stride()}")
    cap = torch.cuda.get_device_capability(q.device)
    if cap != (9, 0):
        raise RuntimeError(
            f"flash_attention is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(q.device)} has capability {cap}")
    b, h, sq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if min(b, h, sq, k.shape[2]) == 0:
        raise ValueError("flash_attention: empty input")
    if max(b, h) > 65535:
        raise ValueError(f"flash_attention: B ({b}) and H ({h}) must be "
                         f"at most 65535")


def _rows_aligned(t: torch.Tensor) -> bool:
    """Whether every (b, h, s) row of ``t`` starts on 16 bytes."""
    return t.data_ptr() % 16 == 0 and all(
        st % 8 == 0 for st in t.stride()[:3])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, H, Sq, D); k, v (B, KV, Skv, D) -> (B, H, Sq, D) in q's dtype.

    H must be a multiple of KV.  On CUDA: float32 or bfloat16, D in
    :data:`HEAD_DIMS`, any strides with a unit stride on D."""
    window = int(window)
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, window)
    _check_cuda(q, k, v)
    if q.dtype == torch.bfloat16:
        q, k, v = (t if _rows_aligned(t) else
                   t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, d), dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    strides = []
    for t in (q, k, v, out):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        build.launch("flash_attention", q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], b, h,
                     kv, sq, skv, d, *strides, int(bool(causal)), window,
                     d ** -0.5, stream)
    build.count_launch(LAUNCHES, "flash_attention")
    return out
