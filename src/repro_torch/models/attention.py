"""Attention in the model's (B, S, H, hd) layout (port of
``repro.models.attention``).

``flash_attention`` is the prefill path: it hands (B, H, S, hd) views to
the Hopper kernel (:mod:`repro_torch.kernels.flash_attention`), which on
CPU tensors computes its plain version.  ``dense_attention`` (the
reference's score-matrix attention) and ``decode_attention`` (one token
against a KV cache, per-slot positions) are plain PyTorch, as they are
plain jnp in the reference; ``decode_attention_split`` is the same read
on one range of a cache whose sequence is split over ranks, combined
from per-range softmax partials.  ``chunked_attention`` is the reference's
online-softmax jnp attention (its ``flash_attention``), the function the
reference trains through: the kernel's backward is its vector-Jacobian
product.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

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
    # the product in the layout JAX's einsum computes it (v's free dim
    # first), so a tracked step records the reference's (m, n) orientation
    out = torch.einsum("bskd,bkrqs->bkdrq", v.to(torch.float32), p)
    out = out.permute(0, 4, 1, 3, 2)
    return out.reshape(b, sq, h, hd).to(q.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window: int = 0,
                      chunk_q: int = 1024, chunk_kv: int = 1024,
                      q_offset: int = 0) -> torch.Tensor:
    """Online-softmax chunked attention (never materializes Sq x Skv).

    q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd); query row r stands at
    position ``q_offset + r`` and key j at j, as in the reference's loop
    (``attention.py:105``).  Query chunks run in a Python loop, so each
    chunk's kv loop covers only the blocks inside the causal triangle
    and, with a window, the band, their bounds shifted by the offset:
    fully masked blocks are never built.  The reference skips blocks only
    at ``q_offset == 0`` (``attention.py:108-112``); a skipped block is
    wholly masked, so its output is the same: a masked block's weights
    are wiped by the next live block's correction, and a row's live
    blocks all lie inside the bounds."""
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    rep = h // kv
    scale = hd ** -0.5
    window = int(window)
    cq, ckv = min(chunk_q, sq), min(chunk_kv, skv)
    pq, pkv = (-sq) % cq, (-skv) % ckv
    qp = F.pad(q, (0, 0, 0, 0, 0, pq))
    kp = F.pad(k, (0, 0, 0, 0, 0, pkv))
    vp = F.pad(v, (0, 0, 0, 0, 0, pkv))
    nq, nkv = (sq + pq) // cq, (skv + pkv) // ckv
    qr = qp.reshape(b, nq, cq, kv, rep, hd).permute(1, 0, 3, 4, 2, 5)
    kr = kp.reshape(b, nkv, ckv, kv, hd).permute(1, 0, 3, 2, 4)
    vr = vp.reshape(b, nkv, ckv, kv, hd).permute(1, 0, 3, 2, 4)
    outs = []
    for qi in range(nq):
        qb = qr[qi].to(torch.float32)                # (B, KV, rep, cq, hd)
        first = q_offset + qi * cq
        qpos = first + torch.arange(cq, device=q.device)
        hi = min(nkv, (first + cq + ckv - 1) // ckv) if causal else nkv
        lo = max(0, (first - window) // ckv) if window > 0 else 0
        m_run = torch.full((b, kv, rep, cq), NEG_INF, dtype=torch.float32,
                           device=q.device)
        l_run = torch.zeros((b, kv, rep, cq), dtype=torch.float32,
                            device=q.device)
        acc = torch.zeros((b, kv, rep, cq, hd), dtype=torch.float32,
                          device=q.device)
        for ki in range(lo, hi):
            kpos = ki * ckv + torch.arange(ckv, device=q.device)
            s = torch.einsum("bkrqd,bksd->bkrqs", qb,
                             kr[ki].to(torch.float32)) * scale
            ok = _mask(qpos, kpos, causal, window) & (kpos < skv)[None, :]
            s = s.masked_fill(~ok, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkrqs,bksd->bkrqd", p, vr[ki].to(torch.float32))
            m_run = m_new
        outs.append(acc / torch.clamp_min(l_run, 1e-30)[..., None])
    out = torch.stack(outs)                          # (nq, B, KV, rep, cq, hd)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(b, nq * cq, h, hd)
    return out[:, :sq].to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """Kernel 1 in the model's layout: q (B, Sq, H, hd); k, v (B, Skv, KV,
    hd) -> (B, Sq, H, hd).  Query row r stands at position ``q_offset +
    r``, key j at j, as in the reference's ``flash_attention``; the kernel
    picks its own tiles, so the reference's ``chunk_q`` / ``chunk_kv``
    have no counterpart."""
    o = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=causal, window=window,
                           q_offset=q_offset)
    return o.transpose(1, 2)


def _decode_logits(q: torch.Tensor, k_cache: torch.Tensor,
                   index: torch.Tensor, window: int,
                   first: int = 0) -> torch.Tensor:
    """The scaled logits (B, KV, rep, S) of one query token against cache
    positions ``[first, first + S)``, NEG_INF where a slot may not read
    the position (past its ``index``, or outside the window)."""
    b, _, h, hd = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    rep = h // kv
    scale = hd ** -0.5
    qr = q.reshape(b, kv, rep, hd).to(torch.float32)
    logits = torch.einsum("bkrd,bskd->bkrs", qr,
                          k_cache.to(torch.float32)) * scale
    kpos = torch.arange(first, first + s, device=q.device)[None, :]
    idx = index[:, None]
    ok = kpos <= idx
    if window > 0:
        ok = ok & ((idx - kpos) < window)
    return logits.masked_fill(~ok[:, None, None, :], NEG_INF)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, index: torch.Tensor,
                     window: int = 0) -> torch.Tensor:
    """Single-token attention against a KV cache.

    q: (B, 1, H, hd); caches: (B, S, KV, hd); index: (B,) per-slot
    positions (continuous batching: every slot has its own length)."""
    b, _, h, hd = q.shape
    p = torch.softmax(_decode_logits(q, k_cache, index, window), dim=-1)
    out = torch.einsum("bkrs,bskd->bkrd", p, v_cache.to(torch.float32))
    return out.reshape(b, 1, h, hd).to(q.dtype)


def decode_attention_split(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, index: torch.Tensor,
                           window: int, first: int,
                           all_reduce: Callable[[torch.Tensor, str],
                                                torch.Tensor]
                           ) -> torch.Tensor:
    """:func:`decode_attention` where the caches hold only positions
    ``[first, first + S_l)`` of the sequence and the other ranges lie on
    other ranks: the masked logits of this range, their max over every
    range (``all_reduce(m, "max")``), then the exponentials' sums and
    their products with v, summed over every range in one
    ``all_reduce(x, "sum")``, and their quotient.  A range that holds no
    live key of a slot adds exactly zero to it (its masked logits lie
    NEG_INF below the max, whose exponential underflows to 0); a slot
    with no live key anywhere reads the uniform average, as the softmax
    of :func:`decode_attention` does."""
    b, _, h, hd = q.shape
    logits = _decode_logits(q, k_cache, index, window, first)
    m = all_reduce(logits.amax(-1), "max")
    p = torch.exp(logits - m[..., None])
    acc = torch.einsum("bkrs,bskd->bkrd", p, v_cache.to(torch.float32))
    both = all_reduce(torch.cat([acc, p.sum(-1)[..., None]], -1), "sum")
    out = both[..., :hd] / both[..., hd:]
    return out.reshape(b, 1, h, hd).to(q.dtype)
