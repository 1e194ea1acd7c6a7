"""Shared building-block layers (port of ``repro.models.layers``)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.parallel import ctx


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm computed in fp32 and cast back to ``x``'s dtype."""
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.to(torch.float32)).to(dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """The reference's float64 frequencies, as fp32, made on ``device``
    itself: a host-made tensor would be a pageable copy, which makes the
    host wait for the device on every layer."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float64,
                        device=device) / head_dim
    return (1.0 / (theta ** exps)).to(torch.float32)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary position embedding.

    x: (..., seq, heads, head_dim); positions: (..., seq), broadcast
    against x's leading dims (a forward's or a prefill's (1, seq): the
    tables are made once for all rows, not once a row)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].to(torch.float32) * freqs  # (.., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _swiglu_plain(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor) -> torch.Tensor:
    gate = F.silu(x @ w_gate)
    return (gate * (x @ w_up)) @ w_down


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """``(silu(x @ w_gate) * (x @ w_up)) @ w_down``; x (..., D), w_gate and
    w_up (D, F), w_down (F, D).  On a mesh, per shard
    (:func:`ffn_per_shard`)."""
    if not ctx.is_dtensor(x):
        return _swiglu_plain(x, w_gate, w_up, w_down)
    return ffn_per_shard(x, w_gate, w_up, w_down)


def ffn_per_shard(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor, experts: bool = False
                  ) -> torch.Tensor:
    """A SwiGLU FFN, ``(silu(x @ w_gate) * (x @ w_up)) @ w_down`` (x (...,
    D), w_gate and w_up (D, F), w_down (F, D); with ``experts``, x (E, T,
    D), every weight led by the same E, and batched products over E), on
    a mesh: each of its products per shard (``ctx.product``), planned by
    the bytes a rank receives (``ctx.product_plan``), with every
    placement and gradient placement stated, so that no product, forward
    or backward, is left to DTensor's plan (which on a CUDA mesh ran the
    SwiGLU backward's weight products on every rank over the gathered
    sequences of 16 ranks).  The gate and up products share one plan and
    one move of x, and keep F split where the plan splits it (the
    elementwise gate runs on the split); the down product is planned on
    the result, and its output is put back on x's placements.  On each
    mesh dim, as the plan prices it:

      * that splits the experts (``experts``, x split on E: expert
        parallelism): the weights split on E alike, each rank runs its
        experts;
      * that splits x's tokens (its batch, or its sequence): either the
        weights are gathered there (FSDP's gather: a training microbatch
        or a 32k prefill, whose tokens outweigh the weights), or, where
        the group's tokens are few (decode), the weights keep their
        split and the tokens move: to the gate and up projections' D
        split by an all-to-all, their partial sums reduce-scattered back
        to the tokens' ranks, and, for ``w_down``'s split of D, the
        group's rows of the gated product gathered and the output's D
        slices sent back by an all-to-all;
      * that leaves x's tokens whole: F split over it (Megatron-style
        tensor parallelism over ``model``: ``w_gate`` and ``w_up`` keep
        their F split, or a whole weight is cut with ``torch.chunk``'s
        sizes where F does not divide, and ``w_down``'s F is cut alike),
        the output a partial sum reduced to x's placement, so no rank of
        the dim runs the FFN the others run.

    A dim that splits x's D (under ``2d`` the norm's D-split scale leaves
    x so) gathers it into the gate and up products, and the output is
    reduced to that split (a reduce-scatter).  Where x is a partial sum,
    it is reduced first."""
    from torch.distributed.tensor import Shard
    lead = 1 if experts else 0
    px = tuple(x.placements)
    gate, up = ctx.product(x, (w_gate, w_up), lead, out="N")
    h = F.silu(gate) * up
    out = tuple("N" if p == Shard(x.ndim - 1) else "R" for p in px)
    y = ctx.product(h, w_down, lead, out=out)
    return y.redistribute(x.device_mesh, px)


def init_dense(shape: Sequence[int], dtype: torch.dtype,
               generator: torch.Generator,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, 1) * ``scale`` (default 1 / sqrt(fan_in)), drawn in fp32 on
    ``generator``'s device and cast to ``dtype``.  The reference draws from
    a JAX key: the distribution is the same, the numbers are not.  On the
    ``meta`` device (abstract parameters) nothing is drawn or allocated."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    meta = generator.device.type == "meta"
    w = torch.randn(tuple(shape), generator=None if meta else generator,
                    dtype=torch.float32, device=generator.device)
    return (w * scale).to(dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Token-level CE in fp32 (the reference's, whose z-loss term no
    caller turns on).  On a mesh the label logits are gathered per shard
    (:func:`_label_logits`) and made full while they still have the
    gather's shape (DTensor cannot reduce them after the trailing dim is
    dropped)."""
    logits = logits.to(torch.float32)
    logz = _logsumexp(logits)
    label_logits = ctx.constrain(_label_logits(logits, labels), "batch",
                                 None, None)[..., 0]
    return torch.mean(logz - label_logits)


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """``logsumexp`` of (B, S, V) logits over the vocab.  On a mesh that
    splits the vocab, per shard: each rank's max and sum of exponentials
    over its own vocab columns, the max all-reduced (max) and the sums
    (sum) over the mesh dims that split the vocab: two numbers a row.
    DTensor's own rule for ``logsumexp`` gathered the batch first:
    dbrx-132b's training step held the data group's 32 sequences' fp32
    logits, (32, 4096, 6272), 3 GiB, on every rank, once a
    microbatch."""
    if not ctx.is_dtensor(logits):
        return torch.logsumexp(logits, dim=-1)
    from torch.distributed.tensor import Replicate, Shard
    pl = tuple(logits.placements)
    mesh = logits.device_mesh
    vocab = [i for i, p in enumerate(pl)
             if p == Shard(2) and mesh.size(i) > 1]
    if not vocab or any(p.is_partial() for p in pl):
        return torch.logsumexp(logits, dim=-1)
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor.experimental import local_map
    out = tuple(Replicate() if p == Shard(2) else p for p in pl)

    def lse(x):
        m = x.detach().amax(-1, keepdim=True)
        for i in vocab:
            m = funcol.wait_tensor(funcol.all_reduce(m, "max", (mesh, i)))
        total = torch.exp(x - m).sum(-1)
        for i in vocab:
            total = _SumReplicated.apply(total, (mesh, i))
        return torch.log(total) + m[..., 0]
    return local_map(lse, out_placements=(out,), in_placements=(pl,),
                     device_mesh=mesh, redistribute_inputs=True)(logits)


class _SumReplicated(torch.autograd.Function):
    """An all-reduce (sum) over one mesh dim whose output is replicated
    there and read alike by every rank (the loss's log-normalizer): its
    gradient arrives whole on each rank, and each rank's partial sum
    takes it as it is."""

    @staticmethod
    def forward(fctx, t, group):
        import torch.distributed._functional_collectives as funcol
        return funcol.wait_tensor(funcol.all_reduce(t, "sum", group))

    @staticmethod
    def backward(fctx, grad):
        return grad, None


def _label_logits(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """``logits[..., labels]`` as (B, S, 1).  On a mesh each rank gathers
    from its own shard: where the vocab is split, the labels in its range
    (the others give 0), so the result is a partial sum over the vocab
    shards.  DTensor's own rule for ``gather`` builds the gradient as a
    zeros tensor of the logits' global shape on every rank, which at
    production scale is hundreds of GB."""
    index = labels.to(torch.long)[..., None]
    if not ctx.is_dtensor(logits):
        return torch.gather(logits, -1, index)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map
    pl = tuple(logits.placements)
    local, offset = compute_local_shape_and_global_offset(
        tuple(logits.shape), logits.device_mesh, pl)
    first, width = int(offset[-1]), int(local[-1])
    rows = tuple(p if isinstance(p, Shard) and p.dim < 2 else Replicate()
                 for p in pl)
    out = tuple(Partial() if p == Shard(2) else q for p, q in zip(pl, rows))

    def gather(lg, idx):
        idx = idx - first
        mine = (idx >= 0) & (idx < width)
        got = torch.gather(lg, -1, idx.clamp(0, width - 1))
        return torch.where(mine, got, torch.zeros_like(got))
    return local_map(gather, out_placements=(out,), in_placements=(pl, rows),
                     device_mesh=logits.device_mesh,
                     redistribute_inputs=True)(logits, index)
