"""Attention in the model's (B, S, H, hd) layout (port of
``repro.models.attention``).

``flash_attention`` is the prefill path: it hands (B, H, S, hd) views to
the Hopper kernel (:mod:`repro_torch.kernels.flash_attention`), which on
CPU tensors computes its plain version.  ``dense_attention`` (the
reference's score-matrix attention) and ``decode_attention`` (one token
against a KV cache, per-slot positions) are plain PyTorch, as they are
plain jnp in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa

NEG_INF = fa.NEG_INF


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
          window: int) -> torch.Tensor:
    """(..., q, k) boolean mask; ``window`` 0 means off."""
    q = qpos[..., :, None]
    k = kpos[..., None, :]
    ok = torch.ones(torch.broadcast_shapes(q.shape, k.shape),
                    dtype=torch.bool, device=qpos.device)
    if causal:
        ok = ok & (k <= q)
    if window > 0:
        ok = ok & ((q - k) < window)
    return ok


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """Reference attention materializing the score matrix.

    q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) with H = KV * rep."""
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    rep = h // kv
    scale = hd ** -0.5
    qr = q.reshape(b, sq, kv, rep, hd).to(torch.float32)
    s = torch.einsum("bqkrd,bskd->bkrqs", qr, k.to(torch.float32)) * scale
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(skv, device=q.device)
    m = _mask(qpos, kpos, causal, int(window))
    s = s.masked_fill(~m, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkrqs,bskd->bqkrd", p, v.to(torch.float32))
    return out.reshape(b, sq, h, hd).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Kernel 1 in the model's layout: q (B, S, H, hd); k, v (B, S, KV, hd)
    -> (B, S, H, hd).  Positions count from 0 for queries and keys alike
    (the reference's ``q_offset=0``); the kernel picks its own tiles, so the
    reference's ``chunk_q`` / ``chunk_kv`` have no counterpart."""
    o = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=causal, window=window)
    return o.transpose(1, 2)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, index: torch.Tensor,
                     window: int = 0) -> torch.Tensor:
    """Single-token attention against a KV cache.

    q: (B, 1, H, hd); caches: (B, S, KV, hd); index: (B,) per-slot
    positions (continuous batching: every slot has its own length)."""
    b, _, h, hd = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    rep = h // kv
    scale = hd ** -0.5
    qr = q.reshape(b, kv, rep, hd).to(torch.float32)
    logits = torch.einsum("bkrd,bskd->bkrs", qr,
                          k_cache.to(torch.float32)) * scale
    kpos = torch.arange(s, device=q.device)[None, :]
    idx = index[:, None]
    ok = kpos <= idx
    if window > 0:
        ok = ok & ((idx - kpos) < window)
    logits = logits.masked_fill(~ok[:, None, None, :], NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkrs,bskd->bkrd", p, v_cache.to(torch.float32))
    return out.reshape(b, 1, h, hd).to(q.dtype)
