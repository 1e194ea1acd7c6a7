"""Shared building-block layers (port of ``repro.models.layers``)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


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


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    gate = F.silu(x @ w_gate)
    return (gate * (x @ w_up)) @ w_down


def init_dense(shape: Sequence[int], dtype: torch.dtype,
               generator: torch.Generator,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, 1) * ``scale`` (default 1 / sqrt(fan_in)), drawn in fp32 on
    ``generator``'s device and cast to ``dtype``.  The reference draws from
    a JAX key: the distribution is the same, the numbers are not."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * scale).to(dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Token-level CE in fp32 (the reference's, whose z-loss term no
    caller turns on)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    label_logits = torch.gather(
        logits, -1, labels.to(torch.long)[..., None])[..., 0]
    return torch.mean(logz - label_logits)
