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

    x: (..., seq, heads, head_dim); positions: (..., seq)."""
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
    return ffn_per_shard(_swiglu_plain, x, w_gate, w_up, w_down)


def ffn_per_shard(fn, x: torch.Tensor, w_gate: torch.Tensor,
                  w_up: torch.Tensor, w_down: torch.Tensor,
                  experts: bool = False) -> torch.Tensor:
    """``fn(x, w_gate, w_up, w_down)``, a SwiGLU FFN (x (..., D), w_gate
    and w_up (D, F), w_down (F, D); with ``experts``, x (E, T, D) and
    every weight led by the same E), run per shard on a mesh with every
    placement given (``local_map``), as Megatron-style tensor parallelism
    with FSDP runs it, so that no product, forward or backward, is left
    to DTensor's plan (which on a CUDA mesh ran the SwiGLU backward's
    weight products on every rank over the gathered sequences of 16
    ranks).  On each mesh dim:

      * that splits the experts (``experts``, x split on E: expert
        parallelism): the weights split on E alike, each rank runs its
        experts; their gradients are whole over it;
      * that splits x's tokens (its batch, or its sequence): the weights
        are gathered whole over it (FSDP's gather) and the rank runs its
        own tokens; the weights' gradients are partial sums over it,
        reduced back to their placement (a reduce-scatter);
      * that leaves x whole, where ``w_gate`` and ``w_up`` split F over it
        and ``w_down`` splits F alike (tensor parallelism over
        ``model``): F stays split, the rank runs its F slice of every
        token, and the output, like x's gradient, is a partial sum over
        it, reduced to x's placement (an all-reduce; x is held as
        ``_shard_act`` holds the residual stream); the weights' gradients
        are whole over it;
      * otherwise (x whole, F not split alike): the weights are gathered
        and the work is the same on every rank of the dim.

    A dim that splits D of ``w_gate`` or ``w_up``, or of ``w_down``'s
    output, gathers it, and so does a dim that splits x's D (under
    ``2d`` the norm's D-split scale leaves x so; the output is then
    reduced to that split, a reduce-scatter).  F or D that does not
    divide its axis is never split by the sharding rules, so it is
    gathered like any other whole dim.  Where x is a partial sum, ``fn``
    runs on the DTensors as before."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    px = tuple(x.placements)
    if any(p.is_partial() for p in px) or \
            sum(p == Shard(x.ndim - 1) for p in px) > 1:
        return fn(x, w_gate, w_up, w_down)
    lead = 1 if experts else 0
    # D split (the norm's D-split scale leaves it so under ``2d``):
    # gathered, as Megatron gathers a sequence-parallel input
    p_x = tuple(Replicate() if p == Shard(x.ndim - 1) else p for p in px)
    col, row, g_col, g_row, out = [], [], [], [], []
    for i, p in enumerate(p_x):
        if experts and p == Shard(0):
            c = r = gc = gr = o = Shard(0)
        elif isinstance(p, Shard):
            c = r = Replicate()
            gc = gr = Partial()
            o = p
        elif (w_gate.placements[i] == w_up.placements[i] == Shard(lead + 1)
              and w_down.placements[i] == Shard(lead)):
            c, r, o = Shard(lead + 1), Shard(lead), Partial()
            gc, gr = c, r
        else:
            c = r = gc = gr = o = Replicate()
        for lst, q in ((col, c), (row, r), (g_col, gc), (g_row, gr),
                       (out, o)):
            lst.append(q)
    col, row, g_col, g_row, out = map(tuple, (col, row, g_col, g_row, out))
    y = local_map(fn, out_placements=(out,),
                  in_placements=(p_x, col, col, row),
                  in_grad_placements=(out, g_col, g_col, g_row),
                  device_mesh=mesh, redistribute_inputs=True)(
        x, w_gate, w_up, w_down)
    return y.redistribute(mesh, px)


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
    logz = torch.logsumexp(logits, dim=-1)
    label_logits = ctx.constrain(_label_logits(logits, labels), "batch",
                                 None, None)[..., 0]
    return torch.mean(logz - label_logits)


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
