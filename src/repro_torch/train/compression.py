"""Gradient compression for the cross-device reduction (port of
``repro.train.compression``; beyond the paper).

Blockwise int8 quantization: each gradient leaf is quantized to int8 with
a per-block (4096 elements) float32 scale before the data-parallel
reduction, then dequantized after, a ~3.7x cut of the wire volume.  Error
feedback (the residual carried to the next step) keeps SGD convergence
unbiased in expectation.  ``quantize_dequantize`` is the gradient
transform with the collective's numerics; ``torch.round``, like
``jnp.round``, rounds half to even.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.nn.functional as F

from repro_torch.train.optim import tree_leaves, tree_map

BLOCK = 4096


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = x.to(torch.float32).reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp_min(scale, 1e-12)),
                    -127, 127)
    return q.to(torch.int8), scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape,
                dtype: torch.dtype) -> torch.Tensor:
    out = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return out[:n].reshape(shape).to(dtype)


def quantize_dequantize(x: torch.Tensor) -> torch.Tensor:
    q, s = _quantize(x)
    return _dequantize(q, s, x.shape, x.dtype)


def compress_grads(grads: Any, residual: Any = None) -> Tuple[Any, Any]:
    """Apply int8 quantization with error feedback to a gradient tree.

    Returns (compressed grads to feed the optimizer, new residual)."""
    if residual is None:
        residual = tree_map(
            lambda g: torch.zeros_like(g, dtype=torch.float32), grads)
    carried = tree_map(lambda g, r: g.to(torch.float32) + r, grads, residual)
    compressed = tree_map(quantize_dequantize, carried)
    new_residual = tree_map(lambda c, q: c - q.to(torch.float32),
                            carried, compressed)
    return compressed, new_residual


def wire_bytes(grads: Any) -> Tuple[float, float]:
    """(uncompressed, compressed) all-reduce volumes in bytes."""
    leaves = tree_leaves(grads)
    raw = sum(x.numel() * 4 for x in leaves)
    comp = sum(x.numel() * 1 + (x.numel() // BLOCK + 1) * 4 for x in leaves)
    return float(raw), float(comp)
