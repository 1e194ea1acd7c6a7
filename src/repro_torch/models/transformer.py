"""The decoder LM of every family (port of ``repro.models.transformer``).

``init_params`` / ``forward`` / ``loss_fn`` / ``init_decode_state`` /
``prefill`` / ``decode_step``, driven by :class:`ModelConfig` as in the
reference:

  * dense / moe / vlm / audio : pre-norm attention + (SwiGLU | MoE)
    blocks (GQA, qk-norm, RoPE, per-layer sliding windows from
    :func:`layer_windows`);
  * ssm    : Mamba2 (SSD) blocks;
  * hybrid : zamba2-style groups of ``attn_every`` Mamba2 layers, each
    group followed by one application of a weight-shared attention + MLP
    block (window 0, a KV cache of its own per group).

vlm and audio frontends are the reference's stubs: ``prefix_embeds``
(precomputed patch or frame embeddings) are projected by
``frontend_proj`` and put before the tokens; ``forward`` trims them from
the logits.

Parameters are an :class:`LMParams` module: the top-level tensors as
attributes, one ``nn.ParameterDict`` per layer in an ``nn.ModuleList``
(the reference stacks layers for ``lax.scan``, hybrid ones by group; here
a Python loop walks them) and, for hybrid, the shared block.  Prefill
attention runs kernel 1 (the reference picks dense or chunked jnp
attention by length; all three compute the same function) unless
``cfg.use_flash`` is off, which selects the dense score-matrix attention
(the evalzoo Transformer's: a tracked training step must run plain ops);
the Mamba2 scan runs kernel 2.  MoE layers add their load-balancing loss
to ``forward``'s aux loss, which ``loss_fn`` adds to the cross-entropy.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from repro_torch.core.devices import torch_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, cross_entropy, init_dense,
                                       rms_norm, swiglu)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: unknown family {cfg.family!r} (known: {FAMILIES})")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


class LMParams(nn.Module):
    """The model's parameters: top-level tensors (``embed``,
    ``final_norm``, ``lm_head`` unless tied, ``frontend_proj`` with a
    frontend) by name; ``layers``, one ``nn.ParameterDict`` per layer;
    and for hybrid, ``shared``, the weight-shared attention + MLP block.
    An ssm or hybrid layer holds ``ln`` beside the Mamba2 block's tensors;
    an attention layer its attention tensors and either the SwiGLU's
    ``w_gate``/``w_up``/``w_down`` or, with experts, the MoE's ``router``
    and expert-stacked ``w_gate``/``w_up``/``w_down`` (the reference's
    ``moe`` sub-tree, flattened).  ``params["embed"]`` reads like the
    reference's parameter dict.  No tensor needs grad; a trainer turns it
    on (``models.evalzoo``)."""

    def __init__(self, top: Dict[str, torch.Tensor],
                 layers: Sequence[Dict[str, torch.Tensor]],
                 shared: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        for name, t in top.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))
        self.layers = nn.ModuleList(_param_dict(blk) for blk in layers)
        self.shared = None if shared is None else _param_dict(shared)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._parameters[name]

    @property
    def device(self) -> torch.device:
        return self["embed"].device


def _param_dict(blk: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in blk.items()})


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------
def _init_attn_block(cfg: ModelConfig, dtype, gen) -> Dict:
    d, h, kv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    dev = gen.device
    p = {
        "ln1": torch.ones((d,), dtype=dtype, device=dev),
        "wq": init_dense((d, h * hd), dtype, gen),
        "wk": init_dense((d, kv * hd), dtype, gen),
        "wv": init_dense((d, kv * hd), dtype, gen),
        "wo": init_dense((h * hd, d), dtype, gen),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
    return p


def _init_mlp_block(cfg: ModelConfig, dtype, gen) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    p = {"ln2": torch.ones((d,), dtype=dtype, device=gen.device)}
    if cfg.n_experts:
        p.update(moe_mod.init_moe(d, f, cfg.n_experts, dtype, gen))
    else:
        p.update({"w_gate": init_dense((d, f), dtype, gen),
                  "w_up": init_dense((d, f), dtype, gen),
                  "w_down": init_dense((f, d), dtype, gen)})
    return p


def _n_groups(cfg: ModelConfig) -> int:
    """Hybrid: the Mamba2 groups, each followed by the shared block."""
    return cfg.n_layers // cfg.attn_every


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> LMParams:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (default ``cuda``), with the reference's distributions."""
    _check_family(cfg)
    dev = torch_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = _dtype(cfg)
    top: Dict[str, torch.Tensor] = {
        "embed": init_dense((cfg.vocab_size, cfg.d_model), dtype, gen,
                            scale=0.02),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        top["lm_head"] = init_dense((cfg.d_model, cfg.vocab_size), dtype,
                                    gen)
    if cfg.frontend:
        top["frontend_proj"] = init_dense((cfg.frontend_dim, cfg.d_model),
                                          dtype, gen)
    layers: List[Dict[str, torch.Tensor]] = []
    for _ in range(cfg.n_layers):
        if cfg.family in ("ssm", "hybrid"):
            blk = {"ln": torch.ones((cfg.d_model,), dtype=dtype, device=dev)}
            blk.update(ssm_mod.init_mamba_block(cfg, dtype, gen))
        else:
            blk = _init_attn_block(cfg, dtype, gen)
            blk.update(_init_mlp_block(cfg, dtype, gen))
        layers.append(blk)
    shared = None
    if cfg.family == "hybrid":
        shared = _init_attn_block(cfg, dtype, gen)
        shared.update(_init_mlp_block(cfg, dtype, gen))
    return LMParams(top, layers, shared)


def layer_windows(cfg: ModelConfig) -> np.ndarray:
    """Per-layer attention windows: 0 = full attention."""
    if cfg.sliding_window and cfg.global_every:
        w = np.full((cfg.n_layers,), cfg.sliding_window, np.int32)
        w[cfg.global_every - 1::cfg.global_every] = 0  # every Nth is global
        return w
    if cfg.sliding_window:
        return np.full((cfg.n_layers,), cfg.sliding_window, np.int32)
    return np.zeros((cfg.n_layers,), np.int32)


# ---------------------------------------------------------------------------
# Blocks (prefill form)
# ---------------------------------------------------------------------------
def _qkv(blk, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    hn = rms_norm(x, blk["ln1"], cfg.norm_eps)
    q = (hn @ blk["wq"]).reshape(b, s, h, hd)
    k = (hn @ blk["wk"]).reshape(b, s, kv, hd)
    v = (hn @ blk["wv"]).reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, blk["q_norm"], cfg.norm_eps)
        k = rms_norm(k, blk["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mlp(blk, x: torch.Tensor, cfg: ModelConfig):
    """The block's MLP on ``x`` (the residual stream): (out, aux loss)."""
    hn = rms_norm(x, blk["ln2"], cfg.norm_eps)
    if cfg.n_experts:
        return moe_mod.moe_layer(blk, hn, cfg.top_k, cfg.capacity_factor,
                                 cfg.router_aux_weight)
    return swiglu(hn, blk["w_gate"], blk["w_up"], blk["w_down"]), None


def _attn_mlp_block(blk, x: torch.Tensor, cfg: ModelConfig, window: int,
                    positions: torch.Tensor):
    """(x after the block, its aux loss or None, (k, v))."""
    b, s, _ = x.shape
    q, k, v = _qkv(blk, x, cfg, positions)
    attend = (attn_mod.flash_attention if cfg.use_flash
              else attn_mod.dense_attention)
    o = attend(q, k, v, causal=True, window=window)
    x = x + o.reshape(b, s, -1) @ blk["wo"]
    m, aux = _mlp(blk, x, cfg)
    return x + m, aux, (k, v)


def _mamba_layer(layer, x: torch.Tensor, cfg: ModelConfig,
                 return_state=False):
    hn = rms_norm(x, layer["ln"], cfg.norm_eps)
    if return_state:
        out, st = ssm_mod.mamba_block(layer, hn, cfg, return_state=True)
        return x + out, st
    return x + ssm_mod.mamba_block(layer, hn, cfg)


def _embed(params: LMParams, cfg: ModelConfig,
           tokens: torch.Tensor) -> torch.Tensor:
    emb = params["embed"]
    # sqrt(d_model) rounded to the parameter dtype, as the reference rounds
    # it, and handed over as a Python number (a device scalar made from the
    # host would make the host wait for the device)
    scale = torch.tensor(math.sqrt(cfg.d_model), dtype=emb.dtype).item()
    return emb[tokens.to(torch.long)] * scale


def _embed_inputs(params: LMParams, cfg: ModelConfig, tokens: torch.Tensor,
                  prefix_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """Token embeddings, after the projected ``prefix_embeds`` (B, P,
    frontend_dim) where the config has a frontend and a prefix is given."""
    x = _embed(params, cfg, tokens)
    if cfg.frontend and prefix_embeds is not None:
        pre = prefix_embeds.to(x.device, _dtype(cfg)) \
            @ params["frontend_proj"]
        x = torch.cat([pre, x], dim=1)
    return x


def _head(params: LMParams, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None, :].expand(b, s)


def _layer_groups(params: LMParams, cfg: ModelConfig):
    """Hybrid: (group index, its ``attn_every`` (index, layer) pairs)."""
    n = cfg.attn_every
    for g in range(_n_groups(cfg)):
        yield g, [(i, params.layers[i]) for i in range(g * n, (g + 1) * n)]


def forward(params: LMParams, cfg: ModelConfig, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits over the token positions (B, S, V), the
    aux loss: the MoE layers' load-balancing terms summed, else 0)."""
    _check_family(cfg)
    x = _embed_inputs(params, cfg, tokens, prefix_embeds)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    auxs = []
    if cfg.family == "ssm":
        for layer in params.layers:
            x = _mamba_layer(layer, x, cfg)
    elif cfg.family == "hybrid":
        for _, group in _layer_groups(params, cfg):
            for _, layer in group:
                x = _mamba_layer(layer, x, cfg)
            x, aux, _ = _attn_mlp_block(params.shared, x, cfg, 0, positions)
            auxs.append(aux)
    else:
        for layer, window in zip(params.layers, layer_windows(cfg)):
            x, aux, _ = _attn_mlp_block(layer, x, cfg, int(window),
                                        positions)
            auxs.append(aux)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.frontend and prefix_embeds is not None:
        x = x[:, prefix_embeds.shape[1]:]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for aux in auxs:
        if aux is not None:
            aux_total = aux_total + aux
    return x @ _head(params, cfg), aux_total


def loss_fn(params: LMParams, cfg: ModelConfig, batch: Dict
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token cross-entropy of ``batch["tokens"]`` (after
    ``batch["prefix_embeds"]`` where given) against ``batch["labels"]``
    plus the aux loss: ``(loss, {"ce", "aux"})``."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          batch.get("prefix_embeds"))
    ce = cross_entropy(logits, batch["labels"])
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode with caches
# ---------------------------------------------------------------------------
def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      device=None) -> Dict[str, Any]:
    """Per-slot positions (``index``) and, per family, the Mamba2 states
    stacked by layer, ``ssm_layers`` (L, B, ...), and the KV caches
    (n, B, max_seq, KV, hd), n one a layer or, for hybrid, one a group.
    The reference stacks hybrid states (n_groups, attn_every, B, ...);
    here they are one a layer, so every state has the batch on axis 1."""
    _check_family(cfg)
    dev = torch_device(device)
    dtype = _dtype(cfg)
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    state: Dict[str, Any] = {
        "index": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if cfg.family in ("ssm", "hybrid"):
        st = ssm_mod.init_mamba_state(cfg, batch, dtype, dev)
        state["ssm_layers"] = {
            k: torch.zeros((cfg.n_layers,) + tuple(v.shape), dtype=v.dtype,
                           device=dev) for k, v in st.items()}
    if cfg.family != "ssm":
        n = _n_groups(cfg) if cfg.family == "hybrid" else cfg.n_layers
        shape = (n, batch, max_seq, kv, hd)
        state["k"] = torch.zeros(shape, dtype=dtype, device=dev)
        state["v"] = torch.zeros(shape, dtype=dtype, device=dev)
    return state


def prefill(params: LMParams, cfg: ModelConfig, tokens: torch.Tensor,
            max_seq: int, prefix_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """Run the prompt (after ``prefix_embeds`` where the config has a
    frontend), returning (last-position logits (B, 1, V), decode state
    with the caches written at positions [0, S), S counting the
    prefix)."""
    x = _embed_inputs(params, cfg, tokens, prefix_embeds)
    b, s, _ = x.shape
    if s > max_seq:
        raise ValueError(f"prompt of {s} positions exceeds max_seq "
                         f"{max_seq}")
    positions = _positions(b, s, x.device)
    state = init_decode_state(cfg, b, max_seq, device=x.device)
    state["index"].fill_(s)

    def mamba(i, layer, x):
        x, st = _mamba_layer(layer, x, cfg, return_state=True)
        for key, val in st.items():
            state["ssm_layers"][key][i] = val
        return x

    def attend(i, blk, x, window):
        x, _, (k, v) = _attn_mlp_block(blk, x, cfg, window, positions)
        state["k"][i, :, :s] = k
        state["v"][i, :, :s] = v
        return x

    if cfg.family == "ssm":
        for i, layer in enumerate(params.layers):
            x = mamba(i, layer, x)
    elif cfg.family == "hybrid":
        for g, group in _layer_groups(params, cfg):
            for i, layer in group:
                x = mamba(i, layer, x)
            x = attend(g, params.shared, x, 0)
    else:
        for i, (layer, window) in enumerate(zip(params.layers,
                                                layer_windows(cfg))):
            x = attend(i, layer, x, int(window))
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return x @ _head(params, cfg), state


def _decode_attention_block(blk, x: torch.Tensor, cfg: ModelConfig,
                            window: int, index: torch.Tensor,
                            k_cache: torch.Tensor, v_cache: torch.Tensor):
    """x: (B, 1, D); index: (B,) per-slot positions.  Writes this token's
    k and v into the caches in place."""
    b = x.shape[0]
    q, k, v = _qkv(blk, x, cfg, index[:, None])
    # each slot writes at its own position, clamped into the cache as the
    # reference's dynamic_update_slice clamps (idle slots keep counting)
    rows = torch.arange(b, device=x.device)
    at = index.to(torch.long).clamp(max=k_cache.shape[1] - 1)
    k_cache[rows, at] = k[:, 0]
    v_cache[rows, at] = v[:, 0]
    o = attn_mod.decode_attention(q, k_cache, v_cache, index, window)
    x = x + o.reshape(b, 1, -1) @ blk["wo"]
    m, _ = _mlp(blk, x, cfg)
    return x + m


def _decode_mamba(layer, x: torch.Tensor, cfg: ModelConfig, sts: Dict,
                  i: int) -> torch.Tensor:
    """One token through Mamba2 layer ``i``; its state updated in place."""
    hn = rms_norm(x, layer["ln"], cfg.norm_eps)
    out, st = ssm_mod.mamba_decode_step(
        layer, hn, {k: v[i] for k, v in sts.items()}, cfg)
    for key, val in st.items():
        sts[key][i] = val
    return x + out


def decode_step(params: LMParams, cfg: ModelConfig, token: torch.Tensor,
                state: Dict) -> Tuple[torch.Tensor, Dict]:
    """One decode step.  token: (B, 1) -> (logits (B, 1, V), state).

    Unlike the reference, which returns new arrays, the KV caches and
    Mamba2 states are updated in place (a full cache copy per token would
    double the memory); the returned dict holds the same tensors and the
    advanced ``index``."""
    _check_family(cfg)
    x = _embed(params, cfg, token)
    index = state["index"]
    new_state = dict(state)
    if cfg.family == "ssm":
        for i, layer in enumerate(params.layers):
            x = _decode_mamba(layer, x, cfg, state["ssm_layers"], i)
    elif cfg.family == "hybrid":
        for g, group in _layer_groups(params, cfg):
            for i, layer in group:
                x = _decode_mamba(layer, x, cfg, state["ssm_layers"], i)
            x = _decode_attention_block(params.shared, x, cfg, 0, index,
                                        state["k"][g], state["v"][g])
    else:
        for i, (layer, window) in enumerate(zip(params.layers,
                                                layer_windows(cfg))):
            x = _decode_attention_block(layer, x, cfg, int(window), index,
                                        state["k"][i], state["v"][i])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    new_state["index"] = index + 1
    return x @ _head(params, cfg), new_state
