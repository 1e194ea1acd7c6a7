"""One MLP's fused layer chain: a Hopper kernel and its plain version.

A Habitat MLP predictor, packed by :func:`pack_trained` (the multi-kind
scorer's ``pack_mlp_params`` for one kind) into uniform zero-padded
blocks, is one chain over a row batch:

  x (B, H) -> h <- relu(h @ W[l] + b[l]) for l < L - 1, no ReLU after the
  last layer -> column 0 of the last layer, (B,)

with weights (L, H, H) and biases (L, H).  :func:`fused_mlp` launches the
CUDA kernel (``csrc/fused_mlp.cu``, built on first use: one 3xTF32
tensor-core GEMM a layer, the L layers launched by one entry point and
counted as one launch) for CUDA tensors and counts the launch in
:data:`LAUNCHES`; for CPU tensors, and only for them, it computes the
plain PyTorch version beside it.  A CUDA device that is not sm_90, a
failed build or a failed launch raises.  Any B > 0 is taken: the kernel
masks the ragged tail itself.

:func:`serve_trained` serves a trained predictor through the chain as the
reference's ``tests/test_kernels.py::test_fused_mlp_serves_trained_predictor``
does: normalize with the model's statistics, pad to H, run the chain, map
log-ms to ms.  ``TrainedMLP.predict_ms`` stays the plain forward.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_mlp_score import (chain_scratch,
                                                 check_cuda_tensors,
                                                 check_in_features,
                                                 pack_mlp_params)

#: launches of the kernel, bumped only where the kernel is launched
LAUNCHES: Dict[str, int] = {"fused_mlp": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def fused_mlp_plain(x: torch.Tensor, weights: torch.Tensor,
                    biases: torch.Tensor,
                    in_features: Optional[int] = None) -> torch.Tensor:
    """x (B, H), weights (L, H, H), biases (L, H) -> (B,) float32: the
    addmm/ReLU chain (mirrors ``repro/kernels/fused_mlp_ref.py``).
    ``in_features`` is taken and ignored, as by the scorer's plain
    versions."""
    h = x.to(torch.float32)
    nl = weights.shape[0]
    for li in range(nl):
        z = torch.addmm(biases[li].to(torch.float32), h,
                        weights[li].to(torch.float32))
        h = z if li == nl - 1 else torch.relu(z)
    return h[:, 0]


def fused_mlp(x: torch.Tensor, weights: torch.Tensor, biases: torch.Tensor,
              in_features: Optional[int] = None) -> torch.Tensor:
    """x (B, H) padded features; weights (L, H, H); biases (L, H) -> (B,)
    float32 (column 0 of the last layer).  Given ``in_features``, rows
    ``in_features..H`` of ``weights[0]`` must be zero (as
    :func:`pack_trained` leaves them) and the kernel's first layer reads
    only that many columns of x; None means H, every column."""
    if x.dim() != 2:
        raise ValueError(f"x must be (B, H), got shape {tuple(x.shape)}")
    bsz, hdim = x.shape
    if weights.dim() != 3 or tuple(weights.shape[1:]) != (hdim, hdim):
        raise ValueError(f"weights shape {tuple(weights.shape)} is not "
                         f"(L, {hdim}, {hdim})")
    if tuple(biases.shape) != tuple(weights.shape[:2]):
        raise ValueError(f"biases shape {tuple(biases.shape)} is not "
                         f"{tuple(weights.shape[:2])}")
    k_in = check_in_features(in_features, hdim)
    if x.device.type == "cpu":
        return fused_mlp_plain(x, weights, biases)
    check_cuda_tensors("fused_mlp", x, (weights, "weights", torch.float32),
                       (biases, "biases", torch.float32))
    if hdim % 4 or hdim > 1024:
        raise ValueError(f"fused_mlp: needs H a multiple of 4 up to 1024, "
                         f"got H={hdim}")
    if bsz == 0:
        raise ValueError("fused_mlp: empty batch (callers never launch one)")
    out = torch.empty(bsz, dtype=torch.float32, device=x.device)
    nl = weights.shape[0]
    scratch = chain_scratch(x, nl)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        build.launch("fused_mlp", x.data_ptr(), weights.data_ptr(),
                     biases.data_ptr(), out.data_ptr(),
                     scratch[0].data_ptr(), scratch[1].data_ptr(), bsz, hdim,
                     nl, k_in, stream)
    build.count_launch(LAUNCHES, "fused_mlp")
    return out


def pack_trained(trained, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A trained MLP's layers as (L, H, H) / (L, H) float32 blocks on
    ``device``: H is the hidden size (at least the input width, a multiple
    of 4), the input and the single output zero-padded to it (so the rows
    past the input width of ``W[0]`` are zero, checked as it packs)."""
    n_in = trained.params[0][0].shape[0]
    hdim = -(-max(trained.cfg.hidden_size, n_in) // 4) * 4
    return pack_mlp_params(trained.params, n_in, hdim, torch.device(device))


def padded_rows(trained, features: torch.Tensor, hdim: int) -> torch.Tensor:
    """Raw feature rows (B, n_in) -> the chain's input (B, hdim): normalized
    with the model's statistics, float32, zero-padded to ``hdim``."""
    x = trained.normalize(features).to(torch.float32)
    padded = x.new_zeros((x.shape[0], hdim))
    padded[:, :x.shape[1]] = x
    return padded


def serve_trained(trained, features: torch.Tensor, weights: torch.Tensor,
                  biases: torch.Tensor) -> torch.Tensor:
    """Raw feature rows (B, n_in) -> predicted ms (B,) through
    :func:`fused_mlp`, its first layer over the n_in features only, on the
    device of ``features``; ``weights`` and ``biases`` come from
    :func:`pack_trained` on that device."""
    x = padded_rows(trained, features, weights.shape[-1])
    n_in = trained.params[0][0].shape[0]
    return trained.ms_from_log(fused_mlp(x, weights, biases,
                                         in_features=n_in))
