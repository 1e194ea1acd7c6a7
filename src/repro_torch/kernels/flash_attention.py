"""Flash-attention forward: a Hopper kernel and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``).  Same signature and layout:

  q (B, H, Sq, D);  k, v (B, KV, Skv, D)  ->  o (B, H, Sq, D), q's dtype

with scale ``D ** -0.5``, a causal mask (key j <= query i), an optional
sliding window (``i - j < window`` when ``window > 0``) and grouped-query
heads (query head h reads kv head ``h // (H // KV)``).  Keys stand at
positions ``0 .. Skv-1`` and query row r at ``q_offset + r``: 0 (the
default) is the whole sequence, and a query chunk of a longer sequence
passes its first position, as the reference's attention takes
``q_offset``.  Softmax state is fp32.

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

The wrapper calls the dispatcher op ``repro_torch::flash_attention``
(``torch.library.custom_op``): its CUDA implementation is the launch
above, its CPU implementation the plain version, both writing the same
(B, Sq, H, D) memory.  The op has a gradient: the reference has no
backward kernel (its Pallas kernel takes no gradient, and its training
step differentiates the jnp chunked attention), so the backward is the
vector-Jacobian product of :func:`repro_torch.models.attention.
chunked_attention`, the port of that jnp code, recomputed from the saved
q, k, v with its static causal and window block skipping.  The backward
never calls :func:`flash_attention_plain`, which stays an oracle.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

#: the TPU kernel's finite mask value (never -inf: see the CUDA source)
NEG_INF = -1e30
#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the backward's (query, key) chunks: the reference's ``attn_chunk_q``
#: and ``attn_chunk_kv`` defaults, which every published config keeps
VJP_CHUNKS = (1024, 1024)

#: launches of the kernel, bumped only where it is launched
LAUNCHES: Dict[str, int] = {"flash_attention": 0}


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int = 0,
                          q_offset: int = 0) -> torch.Tensor:
    """The reference's oracle in PyTorch: repeated K/V, the whole (Sq, Skv)
    score matrix in fp32, masked with the finite NEG_INF; query row r at
    position ``q_offset + r``."""
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    rep = h // kv
    kr = torch.repeat_interleave(k, rep, dim=1).to(torch.float32)
    vr = torch.repeat_interleave(v, rep, dim=1).to(torch.float32)
    s = torch.einsum("bhqd,bhsd->bhqs", q.to(torch.float32), kr) \
        * (d ** -0.5)
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
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
           window: int, q_offset: int = 0) -> None:
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
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Everything the CUDA launcher assumes, checked before launching."""
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


def _empty_out(q: torch.Tensor) -> torch.Tensor:
    """The output buffer: (B, H, Sq, D), a view of (B, Sq, H, D) memory in
    q's dtype (the model reshapes it to (B, Sq, H * D) without a copy)."""
    b, h, sq, d = q.shape
    return q.new_empty((b, sq, h, d)).permute(0, 2, 1, 3)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, window: int, q_offset: int = 0) -> torch.Tensor:
    out = _empty_out(q)
    out.copy_(flash_attention_plain(q, k, v, causal, window, q_offset))
    return out


@_flash_op.register_kernel("cuda")
def _flash_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, window: int, q_offset: int = 0) -> torch.Tensor:
    _check_cuda(q, k, v)
    if q.dtype == torch.bfloat16:
        q, k, v = (t if _rows_aligned(t) else
                   t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    out = _empty_out(q)
    strides = []
    for t in (q, k, v, out):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        build.launch("flash_attention", q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], b, h,
                     kv, sq, skv, d, *strides, int(bool(causal)), window,
                     q_offset, d ** -0.5, stream)
    build.count_launch(LAUNCHES, "flash_attention")
    return out


@_flash_op.register_fake
def _flash_fake(q, k, v, causal, window, q_offset=0):
    return _empty_out(q)


def _flash_setup(ctx, inputs, output) -> None:
    q, k, v, causal, window, q_offset = inputs
    ctx.save_for_backward(q, k, v)
    ctx.causal, ctx.window, ctx.q_offset = causal, window, q_offset


def _flash_vjp(leaves, grad: torch.Tensor, causal: bool, window: int,
               q_offset: int = 0) -> Tuple[Optional[torch.Tensor], ...]:
    """The VJP of the chunked attention at ``leaves`` (q, k, v in the
    kernel's (B, H, S, D) layout, each requiring grad where wanted)."""
    from repro_torch.models.attention import chunked_attention
    wanted = [t for t in leaves if t.requires_grad]
    out: list = [None] * 6
    if wanted:
        with torch.enable_grad():
            o = chunked_attention(*(t.transpose(1, 2) for t in leaves),
                                  causal=causal, window=window,
                                  chunk_q=VJP_CHUNKS[0],
                                  chunk_kv=VJP_CHUNKS[1], q_offset=q_offset)
            got = iter(torch.autograd.grad(o, wanted, grad.transpose(1, 2)))
        for i, t in enumerate(leaves):
            if t.requires_grad:
                out[i] = next(got)
    return tuple(out)


def _flash_backward(ctx, grad: torch.Tensor
                    ) -> Tuple[Optional[torch.Tensor], ...]:
    """The VJP of the chunked attention at the saved inputs, in the
    kernel's (B, H, S, D) layout.  On DTensors it runs on each rank's
    shards, placed as the forward rule places them (batch kept split,
    heads kept split where the rule allows it, the sequence whole): every
    (batch row, KV group) is its own attention, so the local VJP is the
    whole one's restriction to the shard."""
    from repro_torch.parallel.ctx import from_shards, is_dtensor, \
        local_shards
    saved = ctx.saved_tensors
    needs = ctx.needs_input_grad
    if not is_dtensor(saved[0]):
        return _flash_vjp([t.detach().requires_grad_(n)
                           for t, n in zip(saved, needs)],
                          grad, ctx.causal, ctx.window, ctx.q_offset)
    from torch.distributed.tensor import Replicate, Shard
    q, k, v = saved
    heads = k.shape[1] > 1 and k.shape[1] % q.device_mesh.size() == 0
    want = [Shard(p.dim) if isinstance(p, Shard) and
            ((p.dim == 0 and q.shape[0] > 1) or (p.dim == 1 and heads))
            else Replicate() for p in q.placements]
    *local, g = local_shards([q, k, v, grad], q.device_mesh,
                             lambda _: want)
    out = _flash_vjp([t.detach().requires_grad_(n)
                      for t, n in zip(local, needs)], g, ctx.causal,
                     ctx.window, ctx.q_offset)
    return from_shards(out[:3], saved, lambda _: want) + out[3:]


_flash_op.register_autograd(_flash_backward, setup_context=_flash_setup)


_RULE: list = []


def register_sharding_rule() -> None:
    """Register the op's DTensor sharding rule (once; ``parallel.ctx.
    use_mesh`` and ``parallel.sharding.distribute`` call it, so importing
    this module stays free of ``torch.distributed``).  Its strategies, on
    each mesh dim:

      * batch-sharded: q, k, v and the output split on B;
      * head-sharded: q's heads, k's and v's KV heads and the output's
        heads split alike, offered only where KV divides by the whole
        mesh's size (so by every product of mesh dims that could split
        the heads): query head h of a shard then reads KV head h // rep
        of the same shard, as it reads ``h // (H / KV)`` whole.  The
        test must stay that strict: a strategy is written for one mesh
        dim, DTensor expands it to every combination of mesh dims and
        keeps a combination that splits the KV heads unevenly (12 over
        8 ranks), whose shards would read the wrong KV heads; a looser
        test (every product of mesh dims up to KV dividing it) ran torch
        2.11's data-parallel step into a local shape that did not match
        its shard.
        A head-sharded q beside replicated k and v (GQA: 4 heads and 2
        KV heads on a ``model=4`` mesh) matches no strategy and is
        gathered here; the model splits such heads itself, per shard,
        with a slice of the KV heads for each rank
        (``models.transformer._flash_attend``), which no strategy of
        one mesh dim can express;
      * replicated.

    A dim of size 1 is never split (DTensor's views refuse to squeeze a
    split dim).  The sequence is never split: one ``q_offset`` holds for
    the whole call, so a sequence-sharded q (the ``sp`` profile) or k, v
    is gathered on the sequence before the op (the model splits the
    query sequence itself, per shard, with an offset a chunk:
    ``models.transformer._flash_attend``).  D is never split.
    The backward needs no rule: it runs the chunked attention's VJP on
    each rank's shards, placed as these strategies place them."""
    if _RULE:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _flash_strategies(q, k, v, causal, window, *q_offset):
        # (DTensor passes the arguments as given: q_offset, left at its
        # default, may be missing)
        def on(p):
            return ([p], [p, p, p, None, None] + [None] * len(q_offset))
        out = [on(Replicate())]
        if q.shape[0] > 1:
            out.append(on(Shard(0)))
        if k.shape[1] > 1 and k.shape[1] % q.mesh.size() == 0:
            out.append(on(Shard(1)))
        return out
    _RULE.append(_flash_strategies)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q (B, H, Sq, D); k, v (B, KV, Skv, D) -> (B, H, Sq, D) in q's dtype,
    a view of (B, Sq, H, D) memory; differentiable in q, k and v.  Query
    row r stands at position ``q_offset + r``, key j at j.

    H must be a multiple of KV.  On CUDA: float32 or bfloat16, D in
    :data:`HEAD_DIMS`, any strides with a unit stride on D."""
    window, q_offset = int(window), int(q_offset)
    _check(q, k, v, window, q_offset)
    return torch.ops.repro_torch.flash_attention(q, k, v, bool(causal),
                                                 window, q_offset)
