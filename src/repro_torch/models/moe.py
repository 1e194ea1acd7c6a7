"""Mixture-of-Experts layer: top-k routing with capacity-based dispatch
(port of ``repro.models.moe``).

Each token's top-k experts come from an fp32 router softmax, renormalised
over the k kept.  A token takes a slot in its expert's buffer of
``capacity = max(1, round(tokens * k / experts * capacity_factor))`` rows
by a running count in (token, k) order; past capacity it is dropped (its
residual passes through), as Switch/GShard capacity routing drops it.
The experts are SwiGLU FFNs run as batched products over the expert
axis (library GEMMs: the reference computes them outside any Pallas
kernel), and each token's k outputs are weighted by their kept
probabilities and summed by a reshape and a sum over k, not by an
``index_add_``, whose order on CUDA changes from run to run.  The Switch
load-balancing loss comes back beside the output.

``groups`` splits the tokens into equal groups with buffers of their own,
as the reference's locality-grouped dispatch does on a mesh; by default
the groups are the product of the mesh's batch axes
(:func:`_dispatch_groups`: one off a mesh, as in the reference).  On a
mesh the four constraint sites of the reference hold the group-major
tensors on the batch axes and the expert-major ones on 'model' (EP), and
a group's routing, dispatch and combine, all local to the group, run on
each rank's own groups (``local_map``, the group dim sharded as
``constrain(xg, "batch", None, None)`` leaves it): routing and capacity
are per group, so no token leaves its batch shard until the experts'
all-to-all in front of the expert FFN, which runs per shard too
(``layers.ffn_per_shard``: each rank's experts; the weights' D gathered
for a training step's many tokens, their gradients reduced back, or, for
decode's few, kept split and the tokens moved to it).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ffn_per_shard, init_dense
from repro_torch.parallel import ctx


def init_moe(d_model: int, d_ff: int, n_experts: int, dtype: torch.dtype,
             generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The router (D, E) and the experts' stacked SwiGLU weights
    (E, D, F), (E, D, F), (E, F, D), drawn from ``generator`` with the
    reference's distributions."""
    return {
        "router": init_dense((d_model, n_experts), dtype, generator),
        "w_gate": init_dense((n_experts, d_model, d_ff), dtype, generator),
        "w_up": init_dense((n_experts, d_model, d_ff), dtype, generator),
        "w_down": init_dense((n_experts, d_ff, d_model), dtype, generator),
    }


def capacity(tokens: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Rows of each expert's buffer for ``tokens`` tokens of a group
    (Python's ``round``, as the reference's)."""
    return int(max(1, round(tokens * top_k / n_experts * capacity_factor)))


def route(params: Mapping[str, torch.Tensor], x: torch.Tensor,
          top_k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (..., D) -> (fp32 router probabilities (..., E), the top-k
    probabilities renormalised (..., K), their experts (..., K))."""
    logits = x.to(torch.float32) @ params["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


def _dispatch_groups(t: int) -> int:
    """Token groups = product of the active batch mesh axes (1 off-mesh)."""
    mesh = ctx.current_mesh()
    if mesh is None:
        return 1
    g = 1
    shape = ctx.mesh_shape(mesh)
    for ax in ctx.batch_axes():
        g *= shape.get(ax, 1)
    while g > 1 and t % g != 0:
        g //= 2
    return max(g, 1)


def _dispatch(xg: torch.Tensor, router: torch.Tensor, top_k: int,
              cap: int) -> Tuple[torch.Tensor, ...]:
    """Route groups ``xg`` (g, tg, D) and fill each group's expert buffers:
    (buffers (g, E, C, D), each (token, k)'s expert and slot (g, tg*K),
    its weight (g, tg*K) in x's dtype, the router probabilities (g, tg, E)
    and the first choices one-hot (g, tg, E), both fp32)."""
    g, tg, d = xg.shape
    n_experts = router.shape[1]
    probs, top_p, top_e = route({"router": router}, xg, top_k)

    flat_e = top_e.reshape(g, tg * top_k)                   # (g, tg*K)
    onehot = F.one_hot(flat_e, n_experts)
    pos = torch.cumsum(onehot, dim=1) - 1                   # running count
    flat_pos = torch.gather(pos, 2, flat_e[..., None])[..., 0]
    keep = flat_pos < cap
    token_idx = torch.arange(tg, device=xg.device).repeat_interleave(top_k)

    # dispatch: every kept (token, k) owns one (expert, slot) row; the
    # dropped ones all write to a spare row ``cap``, which is cut off (no
    # host round trip to find the kept ones)
    rows = torch.arange(g, device=xg.device)[:, None]
    buf = torch.zeros((g, n_experts, cap + 1, d), dtype=xg.dtype,
                      device=xg.device)
    buf[rows, flat_e, torch.where(keep, flat_pos, cap)] = xg[:, token_idx]
    safe_pos = torch.where(keep, flat_pos, torch.zeros_like(flat_pos))
    w = (top_p.reshape(g, tg * top_k) * keep).to(xg.dtype)
    first = F.one_hot(top_e[..., 0], n_experts).to(torch.float32)
    return buf[:, :, :cap], flat_e, safe_pos, w, probs, first


def _combine(out: torch.Tensor, flat_e: torch.Tensor, safe_pos: torch.Tensor,
             w: torch.Tensor, top_k: int) -> torch.Tensor:
    """Each (token, k) reads its row of the experts' output (g, E, C, D)
    back, weighted by its kept probability (0 where dropped), then the k
    terms of a token summed: (g, tg, D)."""
    g = out.shape[0]
    rows = torch.arange(g, device=out.device)[:, None]
    gathered = out[rows, flat_e, safe_pos]                  # (g, tg*K, D)
    return (gathered * w[..., None]).reshape(
        g, -1, top_k, out.shape[-1]).sum(2)


def _per_group(fn, xg, n_out: int, n_in: int):
    """``fn`` as it runs on ``xg``'s groups: itself off a mesh; on one,
    under ``local_map`` on each rank's own groups, the group dim sharded
    as ``xg`` is (its first ``n_in`` inputs and every output), the rest
    of the inputs replicated.  A replicated input's gradient (the
    router's) is a partial sum over the mesh dims that split the groups,
    each rank's from its own groups only, and is reduced over them; the
    grouped inputs' gradients keep the groups' placements."""
    mesh = ctx.current_mesh()
    if mesh is None:
        return fn
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    grouped = tuple(xg.placements)
    whole = tuple(Replicate() for _ in grouped)
    summed = tuple(Partial() if isinstance(p, Shard) else Replicate()
                   for p in grouped)
    return lambda *args: local_map(
        fn, out_placements=(grouped,) * n_out,
        in_placements=tuple(grouped if i < n_in else whole
                            for i in range(len(args))),
        in_grad_placements=tuple(grouped if i < n_in else summed
                                 for i in range(len(args))),
        device_mesh=xg.device_mesh, redistribute_inputs=True)(*args)


def _expert_ffn(h: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU over (E, T, D) rows: batched products over E."""
    gate = F.silu(torch.bmm(h, w_gate))
    return torch.bmm(gate * torch.bmm(h, w_up), w_down)


def moe_layer(params: Mapping[str, torch.Tensor], x: torch.Tensor,
              top_k: int, capacity_factor: float = 1.25,
              aux_weight: float = 0.01, groups: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D) in x's dtype, aux loss fp32 scalar).

    ``params`` holds ``router`` (D, E) and ``w_gate``/``w_up`` (E, D, F),
    ``w_down`` (E, F, D); other keys are ignored (a decoder layer's dict
    may be passed whole).  ``groups`` (default :func:`_dispatch_groups`)
    must divide B * S.  The routing comes from :func:`route`, looked up
    at each call."""
    b, s, d = x.shape
    t = b * s
    g = _dispatch_groups(t) if groups is None else int(groups)
    if g < 1 or t % g:
        raise ValueError(f"groups ({g}) must divide the {t} tokens")
    tg = t // g
    n_experts = params["router"].shape[1]
    cap = capacity(tg, top_k, n_experts, capacity_factor)

    xg = ctx.constrain(x.reshape(g, tg, d), "batch", None, None)
    dispatch = _per_group(
        lambda xg_, router: _dispatch(xg_, router, top_k, cap), xg, 6, 1)
    buf, flat_e, safe_pos, w, probs, first = dispatch(xg, params["router"])

    # the experts' SwiGLU FFN over (E, g * C, D), expert-major (E@model,
    # g@batch): the only cross-device movement is this reshard
    h = ctx.constrain(buf.transpose(0, 1), "model", "batch", None, None)
    h = h.reshape(n_experts, g * cap, d)
    ffn = [h, params["w_gate"], params["w_up"], params["w_down"]]
    out = (ffn_per_shard(*ffn, experts=True)
           if ctx.is_dtensor(h) else _expert_ffn(*ffn))
    out = ctx.constrain(out.reshape(n_experts, g, cap, d), "model", "batch",
                        None, None).transpose(0, 1)       # (g, E, C, D)

    combine = _per_group(lambda o, fe, sp, w_: _combine(o, fe, sp, w_, top_k),
                         xg, 1, 4)
    combined = ctx.constrain(combine(out, flat_e, safe_pos, w), "batch",
                             None, None)

    # Switch load-balancing loss over all tokens
    me = probs.reshape(t, n_experts).mean(0)
    ce = first.reshape(t, n_experts).mean(0)
    aux = aux_weight * n_experts * torch.sum(me * ce)
    return combined.reshape(b, s, d), aux.to(torch.float32)
