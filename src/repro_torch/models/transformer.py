"""The decoder LM for the dense and ssm families (port of
``repro.models.transformer``).

``init_params`` / ``forward`` / ``init_decode_state`` / ``prefill`` /
``decode_step``, driven by :class:`ModelConfig` as in the reference:

  * dense : pre-norm attention + SwiGLU blocks (GQA, qk-norm, RoPE,
    per-layer sliding windows from :func:`layer_windows`);
  * ssm   : Mamba2 (SSD) blocks.

Parameters are an :class:`LMParams` module: the top-level tensors as
attributes and one ``nn.ParameterDict`` per layer in an
``nn.ModuleList`` (the reference stacks layers for ``lax.scan``; here a
Python loop walks them).  Prefill attention always runs kernel 1 (the
reference picks dense or chunked jnp attention by length; all three
compute the same function), and the Mamba2 scan kernel 2.  The moe,
hybrid, vlm and audio families raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from repro_torch.core.devices import torch_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, init_dense, rms_norm, swiglu

FAMILIES = ("dense", "ssm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported to repro_torch "
            f"(ported: {FAMILIES}; see ROADMAP.md, queue 1 item 7)")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


class LMParams(nn.Module):
    """The model's parameters: top-level tensors (``embed``,
    ``final_norm``, ``lm_head`` unless tied) by name, and ``layers``, one
    ``nn.ParameterDict`` per layer (for ssm layers, ``ln`` beside the
    Mamba2 block's tensors).  ``params["embed"]`` reads like the
    reference's parameter dict.  Inference only: no tensor needs grad."""

    def __init__(self, top: Dict[str, torch.Tensor],
                 layers: Sequence[Dict[str, torch.Tensor]]):
        super().__init__()
        for name, t in top.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))
        self.layers = nn.ModuleList(
            nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                              for k, v in blk.items()})
            for blk in layers)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._parameters[name]

    @property
    def device(self) -> torch.device:
        return self["embed"].device


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
    return {
        "ln2": torch.ones((d,), dtype=dtype, device=gen.device),
        "w_gate": init_dense((d, f), dtype, gen),
        "w_up": init_dense((d, f), dtype, gen),
        "w_down": init_dense((f, d), dtype, gen),
    }


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
    layers: List[Dict[str, torch.Tensor]] = []
    for _ in range(cfg.n_layers):
        if cfg.family == "ssm":
            blk = {"ln": torch.ones((cfg.d_model,), dtype=dtype, device=dev)}
            blk.update(ssm_mod.init_mamba_block(cfg, dtype, gen))
        else:
            blk = _init_attn_block(cfg, dtype, gen)
            blk.update(_init_mlp_block(cfg, dtype, gen))
        layers.append(blk)
    return LMParams(top, layers)


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


def _attn_mlp_block(blk, x: torch.Tensor, cfg: ModelConfig, window: int,
                    positions: torch.Tensor):
    b, s, _ = x.shape
    q, k, v = _qkv(blk, x, cfg, positions)
    o = attn_mod.flash_attention(q, k, v, causal=True, window=window)
    x = x + o.reshape(b, s, -1) @ blk["wo"]
    hn = rms_norm(x, blk["ln2"], cfg.norm_eps)
    x = x + swiglu(hn, blk["w_gate"], blk["w_up"], blk["w_down"])
    return x, (k, v)


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


def _head(params: LMParams, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None, :].expand(b, s)


def forward(params: LMParams, cfg: ModelConfig, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V), aux loss): the reference's
    ``forward`` without a frontend prefix (its aux loss is 0 for these
    families)."""
    _check_family(cfg)
    x = _embed(params, cfg, tokens)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    if cfg.family == "ssm":
        for layer in params.layers:
            x = _mamba_layer(layer, x, cfg)
    else:
        for layer, window in zip(params.layers, layer_windows(cfg)):
            x, _ = _attn_mlp_block(layer, x, cfg, int(window), positions)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ _head(params, cfg), torch.zeros((), device=x.device)


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode with caches
# ---------------------------------------------------------------------------
def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      device=None) -> Dict[str, Any]:
    """Per-slot positions (``index``) and, per family, the KV caches
    (L, B, max_seq, KV, hd) or the Mamba2 states stacked by layer."""
    _check_family(cfg)
    dev = torch_device(device)
    dtype = _dtype(cfg)
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    state: Dict[str, Any] = {
        "index": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if cfg.family == "ssm":
        st = ssm_mod.init_mamba_state(cfg, batch, dtype, dev)
        state["ssm_layers"] = {
            k: torch.zeros((cfg.n_layers,) + tuple(v.shape), dtype=v.dtype,
                           device=dev) for k, v in st.items()}
    else:
        shape = (cfg.n_layers, batch, max_seq, kv, hd)
        state["k"] = torch.zeros(shape, dtype=dtype, device=dev)
        state["v"] = torch.zeros(shape, dtype=dtype, device=dev)
    return state


def prefill(params: LMParams, cfg: ModelConfig, tokens: torch.Tensor,
            max_seq: int) -> Tuple[torch.Tensor, Dict]:
    """Run the prompt, returning (last-position logits (B, 1, V), decode
    state with the prompt's caches written at positions [0, S))."""
    x = _embed(params, cfg, tokens)
    b, s, _ = x.shape
    if s > max_seq:
        raise ValueError(f"prompt of {s} tokens exceeds max_seq {max_seq}")
    positions = _positions(b, s, x.device)
    state = init_decode_state(cfg, b, max_seq, device=x.device)
    state["index"].fill_(s)
    if cfg.family == "ssm":
        for i, layer in enumerate(params.layers):
            x, st = _mamba_layer(layer, x, cfg, return_state=True)
            for key, val in st.items():
                state["ssm_layers"][key][i] = val
    else:
        for i, (layer, window) in enumerate(zip(params.layers,
                                                layer_windows(cfg))):
            x, (k, v) = _attn_mlp_block(layer, x, cfg, int(window), positions)
            state["k"][i, :, :s] = k
            state["v"][i, :, :s] = v
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
    out = o.reshape(b, 1, -1) @ blk["wo"]
    x = x + out
    hn = rms_norm(x, blk["ln2"], cfg.norm_eps)
    return x + swiglu(hn, blk["w_gate"], blk["w_up"], blk["w_down"])


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
        sts = state["ssm_layers"]
        for i, layer in enumerate(params.layers):
            hn = rms_norm(x, layer["ln"], cfg.norm_eps)
            out, st = ssm_mod.mamba_decode_step(
                layer, hn, {k: v[i] for k, v in sts.items()}, cfg)
            for key, val in st.items():
                sts[key][i] = val
            x = x + out
    else:
        for i, (layer, window) in enumerate(zip(params.layers,
                                                layer_windows(cfg))):
            x = _decode_attention_block(layer, x, cfg, int(window), index,
                                        state["k"][i], state["v"][i])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    new_state["index"] = index + 1
    return x @ _head(params, cfg), new_state
