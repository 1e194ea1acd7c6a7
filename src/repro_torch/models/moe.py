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
as the reference's locality-grouped dispatch does on a mesh; off a mesh
the reference uses one group, and so does the port by default.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import init_dense


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


def moe_layer(params: Mapping[str, torch.Tensor], x: torch.Tensor,
              top_k: int, capacity_factor: float = 1.25,
              aux_weight: float = 0.01, groups: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D) in x's dtype, aux loss fp32 scalar).

    ``params`` holds ``router`` (D, E) and ``w_gate``/``w_up`` (E, D, F),
    ``w_down`` (E, F, D); other keys are ignored (a decoder layer's dict
    may be passed whole).  ``groups`` (default 1) must divide B * S.
    The routing comes from :func:`route`, looked up at each call."""
    b, s, d = x.shape
    t = b * s
    g = 1 if groups is None else int(groups)
    if g < 1 or t % g:
        raise ValueError(f"groups ({g}) must divide the {t} tokens")
    tg = t // g
    n_experts = params["router"].shape[1]
    cap = capacity(tg, top_k, n_experts, capacity_factor)

    xg = x.reshape(g, tg, d)
    probs, top_p, top_e = route(params, xg, top_k)          # (g, tg, E|K)

    flat_e = top_e.reshape(g, tg * top_k)                   # (g, tg*K)
    onehot = F.one_hot(flat_e, n_experts)
    pos = torch.cumsum(onehot, dim=1) - 1                   # running count
    flat_pos = torch.gather(pos, 2, flat_e[..., None])[..., 0]
    keep = flat_pos < cap
    token_idx = torch.arange(tg, device=x.device).repeat_interleave(top_k)

    # dispatch: every kept (token, k) owns one (expert, slot) row; the
    # dropped ones all write to a spare row ``cap``, which is cut off (no
    # host round trip to find the kept ones)
    rows = torch.arange(g, device=x.device)[:, None]
    buf = torch.zeros((g, n_experts, cap + 1, d), dtype=x.dtype,
                      device=x.device)
    buf[rows, flat_e, torch.where(keep, flat_pos, cap)] = xg[:, token_idx]

    # the experts' SwiGLU FFN over (E, g * C, D)
    h = buf[:, :, :cap].transpose(0, 1).reshape(n_experts, g * cap, d)
    gate = F.silu(torch.bmm(h, params["w_gate"]))
    up = torch.bmm(h, params["w_up"])
    out = torch.bmm(gate * up, params["w_down"])
    out = out.reshape(n_experts, g, cap, d).transpose(0, 1)  # (g, E, C, D)

    # combine: each (token, k) reads its row back, weighted by its kept
    # probability (0 where dropped), then the k terms of a token summed
    safe_pos = torch.where(keep, flat_pos, torch.zeros_like(flat_pos))
    gathered = out[rows, flat_e, safe_pos]                  # (g, tg*K, D)
    w = (top_p.reshape(g, tg * top_k) * keep).to(x.dtype)
    combined = (gathered * w[..., None]).reshape(g, tg, top_k, d).sum(2)

    # Switch load-balancing loss over all tokens
    me = probs.reshape(t, n_experts).mean(0)
    ce = F.one_hot(top_e.reshape(t, top_k)[:, 0], n_experts).to(
        torch.float32).mean(0)
    aux = aux_weight * n_experts * torch.sum(me * ce)
    return combined.reshape(b, s, d), aux.to(torch.float32)
