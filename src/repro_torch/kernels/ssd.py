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

The wrapper calls the dispatcher op ``repro_torch::ssd``
(``torch.library.custom_op``): its CUDA implementation is the launch
above, its CPU implementation the plain version, both writing the same
layouts.  The op has a gradient: the reference has no backward kernel
(its Pallas kernel takes no gradient, and its training step
differentiates ``ssd_chunked``), so the backward is the vector-Jacobian
product of :func:`repro_torch.models.ssm.ssd_chunked` for y and the
final state, recomputed from the saved inputs at ``vjp_chunk`` (the
chunk the reference's Mamba2 block hands ``ssd_chunked``,
``cfg.ssm_chunk``).  b and c reach it as the views they are, so their
gradients come back per head and autograd sums a head-broadcast view's
over the heads.  The backward never calls :func:`ssd_plain`, which stays
an oracle.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import build

#: the largest chunk the kernel takes (its cumulative sum is one warp
#: scan, two steps a lane)
MAX_CHUNK = 64
#: the backward's default chunk: the reference's ``ssm_chunk``
VJP_CHUNK = 256
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


def _empty_outs(x: torch.Tensor, n: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y (B, H, L, P) fp32 as a view of (B, L, H, P) memory, and the final
    state (B, H, N, P) fp32."""
    b, h, l, p = x.shape
    y = x.new_empty((b, l, h, p), dtype=torch.float32).permute(0, 2, 1, 3)
    return y, x.new_empty((b, h, n, p), dtype=torch.float32)


@torch.library.custom_op("repro_torch::ssd", mutates_args=(),
                         device_types="cpu")
def _ssd_op(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            bmat: torch.Tensor, cmat: torch.Tensor, chunk: int,
            vjp_chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    y, state = _empty_outs(x, bmat.shape[-1])
    y_plain, state_plain = ssd_plain(x, dt, a, bmat, cmat)
    y.copy_(y_plain)
    state.copy_(state_plain)
    return y, state


@_ssd_op.register_kernel("cuda")
def _ssd_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              bmat: torch.Tensor, cmat: torch.Tensor, chunk: int,
              vjp_chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_cuda(x, dt, a, bmat, cmat)
    b, h, l, p = x.shape
    n = bmat.shape[-1]
    y, state = _empty_outs(x, n)
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


@_ssd_op.register_fake
def _ssd_fake(x, dt, a, bmat, cmat, chunk, vjp_chunk):
    return _empty_outs(x, bmat.shape[-1])


def _ssd_setup(ctx, inputs, output) -> None:
    ctx.save_for_backward(*inputs[:5])
    ctx.vjp_chunk = inputs[6]


def _ssd_vjp(leaves, grad_y: Optional[torch.Tensor],
             grad_state: Optional[torch.Tensor], vjp_chunk: int
             ) -> Tuple[Optional[torch.Tensor], ...]:
    """The VJP of ``ssd_chunked`` (y and the final state) at ``leaves``
    (x, dt, a, bmat, cmat in the kernel's layout, each requiring grad
    where wanted)."""
    from repro_torch.models.ssm import ssd_chunked
    wanted = [t for t in leaves if t.requires_grad]
    out: List[Optional[torch.Tensor]] = [None] * 7
    if not wanted or (grad_y is None and grad_state is None):
        return tuple(out)
    x, dt, a, bmat, cmat = leaves
    with torch.enable_grad():
        y, state = ssd_chunked(x.transpose(1, 2), dt.transpose(1, 2), a,
                               bmat.transpose(1, 2), cmat.transpose(1, 2),
                               chunk=vjp_chunk, return_final=True)
        pairs = [(o, g) for o, g in ((y, grad_y), (state, grad_state))
                 if g is not None]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], wanted,
            [g.transpose(1, 2) if o is y else g for o, g in pairs],
            allow_unused=True))
    for i, t in enumerate(leaves):
        if t.requires_grad:
            g = next(got)
            out[i] = torch.zeros_like(t) if g is None else g
    return tuple(out)


def _ssd_backward(ctx, grad_y: Optional[torch.Tensor],
                  grad_state: Optional[torch.Tensor]
                  ) -> Tuple[Optional[torch.Tensor], ...]:
    """The VJP of ``ssd_chunked`` (y and the final state) at the saved
    inputs, in the kernel's (B, H, L, .) layout.  On DTensors it runs on
    each rank's shards, placed as the forward rule places them (batch and
    heads kept split, the sequence whole): every (batch row, head) is its
    own scan, so the local VJP is the whole one's restriction to the
    shard, but for ``a``'s gradient, a sum over the batch rows, which is
    a partial sum over a batch split."""
    from repro_torch.parallel.ctx import from_shards, is_dtensor, \
        local_shards
    saved = ctx.saved_tensors
    needs = ctx.needs_input_grad
    if not is_dtensor(saved[0]):
        return _ssd_vjp([t.detach().requires_grad_(n)
                         for t, n in zip(saved, needs)],
                        grad_y, grad_state, ctx.vjp_chunk)
    from torch.distributed.tensor import Partial, Replicate, Shard
    x = saved[0]
    want = [Shard(p.dim) if isinstance(p, Shard) and p.dim < 2 and
            x.shape[p.dim] > 1 else Replicate() for p in x.placements]
    # a (H,): split where the heads are, whole elsewhere
    want_a = [Shard(0) if p == Shard(1) else Replicate() for p in want]
    grad_a = [Shard(0) if p == Shard(1) else
              Partial() if p == Shard(0) else Replicate() for p in want]

    def placed(i):
        return want_a if i == 2 else want
    local = local_shards(list(saved) + [grad_y, grad_state],
                         x.device_mesh,
                         lambda i: placed(i) if i < 5 else want)
    out = _ssd_vjp([t.detach().requires_grad_(n)
                    for t, n in zip(local[:5], needs)], local[5], local[6],
                   ctx.vjp_chunk)
    return from_shards(out[:5], saved,
                       lambda i: grad_a if i == 2 else want) + out[5:]


_ssd_op.register_autograd(_ssd_backward, setup_context=_ssd_setup)


_RULE: list = []


def register_sharding_rule() -> None:
    """Register the op's DTensor sharding rule (once; called where a mesh
    comes into use, as flash attention's is).  Its strategies, on each
    mesh dim:

      * batch-sharded: x, dt, bmat, cmat, y and the state split on B,
        ``a`` replicated;
      * head-sharded: x, dt, bmat, cmat, y and the state split on H and
        ``a`` on its one dim (every head's scan is its own; b and c
        reach the op per head, as a head-broadcast view);
      * replicated.

    A dim of size 1 is never split (DTensor's views refuse to squeeze a
    split dim).  The sequence L is never split: the scan carries its
    state across L, so a sequence-sharded input (the ``sp`` profile) is
    gathered on L before the op.  P and N are never split.  The backward
    runs the VJP on each rank's shards, placed as these strategies place
    them."""
    if _RULE:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.ssd.default)
    def _ssd_strategies(x, dt, a, bmat, cmat, chunk, vjp_chunk):
        rep = Replicate()
        batch = ([Shard(0), Shard(0)],
                 [Shard(0), Shard(0), rep, Shard(0), Shard(0), None, None])
        heads = ([Shard(1), Shard(1)],
                 [Shard(1), Shard(1), Shard(0), Shard(1), Shard(1), None,
                  None])
        whole = ([rep, rep], [rep, rep, rep, rep, rep, None, None])
        return [whole] + [strategy for strategy, size in
                          ((batch, x.shape[0]), (heads, x.shape[1]))
                          if size > 1]
    _RULE.append(_ssd_strategies)


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
        bmat: torch.Tensor, cmat: torch.Tensor, chunk: int = MAX_CHUNK,
        vjp_chunk: int = VJP_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, H, L, P); dt (B, H, L); a (H,); bmat, cmat (B, H, L, N)
    -> (y (B, H, L, P) float32, a view of (B, L, H, P) memory; final state
    (B, H, N, P) float32), differentiable in every input.

    ``chunk`` (1..:data:`MAX_CHUNK`) is the kernel's chunk length; it
    changes only the fp32 rounding.  ``vjp_chunk`` is the chunk of the
    backward's ``ssd_chunked``.  On CUDA: x, bmat, cmat float32 or
    bfloat16 with a unit innermost stride; dt and a float32."""
    chunk = int(chunk)
    _check(x, dt, a, bmat, cmat, chunk)
    return torch.ops.repro_torch.ssd(x, dt, a, bmat, cmat, chunk,
                                     int(vjp_chunk))
