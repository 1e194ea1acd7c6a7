"""The fused multi-kind MLP scorer: two Hopper kernels and their plain versions.

The fleet engine (``core/batched.py``) prices kernel-varying ops with one
MLP per op kind (conv2d / linear / bmm / recurrent).  All kinds' layers
are packed into one stack, padded to one hidden size H:

  weights (K, L, H, H), biases (K, L, H)   -- ``pack_mlp_params`` per kind
  x       (B, H)                           -- rows padded to whole blocks

and a row's prediction is column 0 of its kind's last layer (ReLU between
layers, none after the last).  Two spellings of which kind a row takes:

* :func:`fused_mlp_score` — block-mapped: rows come grouped by kind and
  padded per kind to whole ``block_m`` blocks; ``block_kinds`` gives each
  block's kind (full sweeps);
* :func:`fused_mlp_score_rows` — row-mapped: ``row_kinds`` gives each
  row's own kind, so any kind mix scores in one launch (cell-masked
  sweeps).  Padding rows carry a valid kind; their outputs are garbage.

Each wrapper launches its CUDA kernel (``csrc/``, built on first use) for
CUDA tensors and counts the launch in :data:`LAUNCHES`; for CPU tensors,
and only for them, it computes the plain PyTorch version beside it.  A
CUDA device that is not sm_90, a failed build or a failed launch raises.
Both kernels run one 3xTF32 tensor-core GEMM a layer (``csrc/mlp_gemm.cuh``;
the entry point launches the L layers, so a call counts one launch), each
row tile once per kind present in it, and, given ``in_features``, their
first layer over those columns only: ``pack_mlp_params`` leaves the rows
past them of every ``W[., 0]`` zero.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build

#: launches of each kernel, bumped only where the kernel is launched
LAUNCHES: Dict[str, int] = {"fused_mlp_score": 0, "fused_mlp_score_rows": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def bucket_blocks(n_blocks: int) -> int:
    """Pad a row-block count to its bucket: powers of two up to 32 blocks,
    multiples of 32 beyond, so the launch shapes stay O(log) many.
    Padding blocks carry kind 0 and zero rows; callers slice them off.

    ``bucket_blocks(0) == 0`` (an empty batch stays empty: callers never
    launch a zero-block kernel) and a negative count raises."""
    n_blocks = int(n_blocks)
    if n_blocks < 0:
        raise ValueError(f"n_blocks must be >= 0, got {n_blocks}")
    if n_blocks == 0:
        return 0
    if n_blocks <= 32:
        return 1 << max(n_blocks - 1, 0).bit_length()
    return -(-n_blocks // 32) * 32


def bucket_rows(n_rows: int) -> int:
    """Pad a row count to its bucket (the stacked CPU lowering): powers of
    two up to 512 rows, multiples of 512 beyond.  Same edge contract as
    :func:`bucket_blocks`: 0 stays 0, negative raises."""
    n_rows = int(n_rows)
    if n_rows < 0:
        raise ValueError(f"n_rows must be >= 0, got {n_rows}")
    if n_rows == 0:
        return 0
    if n_rows <= 512:
        return 1 << max(n_rows - 1, 0).bit_length()
    return -(-n_rows // 512) * 512


def pad_rows_to_blocks(xn: torch.Tensor, kind_ids: torch.Tensor,
                       hidden: int, block_m: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """m >= 1 rows ``xn`` (m, F) of kinds ``kind_ids`` (m,) -> the
    row-mapped kernel's input: x (P, hidden) float32 and row_kinds (P,)
    int32, P = m rounded up to a multiple of ``block_m``.  Real rows keep
    their values, zero-padded to ``hidden``; padding rows are zero and
    carry the last real row's kind, so the tail tile holds one kind.  No
    bucket: a CUDA kernel compiles nothing per shape."""
    m = xn.shape[0]
    padded = -(-m // block_m) * block_m
    x = torch.zeros((padded, hidden), dtype=torch.float32, device=xn.device)
    x[:m, :xn.shape[1]] = xn
    row_kinds = torch.empty(padded, dtype=torch.int32, device=xn.device)
    row_kinds[:m] = kind_ids
    row_kinds[m:] = kind_ids[m - 1]
    return x, row_kinds


def pack_mlp_params(params: Sequence[Tuple[np.ndarray, np.ndarray]],
                    in_features: int, hidden: int,
                    device: torch.device) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Pack an MLP's ``[(w, b), ...]`` (w of shape (in, out)) into uniform
    zero-padded (L, H, H) weights and (L, H) biases, float32.

    Rows ``in_features..H`` of the first layer's block stay zero, the
    contract under which the kernels' first layer reads ``in_features``
    columns of x; a first weight with a non-zero row past them raises
    ``ValueError`` (checked here, on the host, once)."""
    ws = torch.zeros((len(params), hidden, hidden), dtype=torch.float32)
    bs = torch.zeros((len(params), hidden), dtype=torch.float32)
    for li, (w, b) in enumerate(params):
        w = torch.as_tensor(np.asarray(w, np.float32))
        b = torch.as_tensor(np.asarray(b, np.float32))
        ws[li, :w.shape[0], :w.shape[1]] = w
        bs[li, :b.shape[0]] = b
    if len(params) and bool(ws[0, in_features:].any()):
        raise ValueError(f"the first layer has non-zero weights in rows past "
                         f"in_features={in_features}")
    return ws.to(device), bs.to(device)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (mirror repro/kernels/fused_mlp_score_ref.py)
# ---------------------------------------------------------------------------
def fused_mlp_score_plain(x: torch.Tensor, block_kinds: torch.Tensor,
                          weights: torch.Tensor, biases: torch.Tensor,
                          in_features: Optional[int] = None) -> torch.Tensor:
    """x (B, H); block_kinds (nb,); weights (K, L, H, H); biases (K, L, H)
    -> (B,).  Each kind's blocks go through that kind's chain together
    (the same rows-times-weights products as gathering a weight stack
    per block, without materializing (nb, L, H, H)).  ``in_features`` is
    taken and ignored: every column goes in, and under its contract the
    columns past it add exact zeros."""
    bsz, hdim = x.shape
    nb = block_kinds.shape[0]
    bm = bsz // nb
    nk, nl = weights.shape[0], weights.shape[1]
    h = x.reshape(nb, bm, hdim).to(torch.float32)
    kinds = block_kinds.to(torch.long)
    out = torch.full((nb, bm), float("nan"), dtype=torch.float32,
                     device=x.device)
    for k in range(nk):
        sel = torch.nonzero(kinds == k).flatten()
        if not sel.numel():
            continue
        hk = h[sel].reshape(-1, hdim)
        for li in range(nl):
            z = torch.addmm(biases[k, li].to(torch.float32), hk,
                            weights[k, li].to(torch.float32))
            hk = z if li == nl - 1 else torch.relu(z)
        out[sel] = hk[:, 0].reshape(-1, bm)
    return out.reshape(bsz)


def fused_mlp_score_rows_plain(x: torch.Tensor, row_kinds: torch.Tensor,
                               weights: torch.Tensor,
                               biases: torch.Tensor) -> torch.Tensor:
    """x (B, H); row_kinds (B,); weights (K, L, H, H); biases (K, L, H)
    -> (B,).  Every kind's layer output in ONE (B, H) x (H, K*H) product
    per layer, then each row gathers its own — selection, not
    approximation."""
    nk, nl = weights.shape[0], weights.shape[1]
    hdim = x.shape[1]
    h = x.to(torch.float32)
    idx = row_kinds.to(torch.long)
    for li in range(nl):
        wl = (weights[:, li].to(torch.float32).permute(1, 0, 2)
              .reshape(hdim, nk * hdim))
        zk = (h @ wl).reshape(-1, nk, hdim)
        z = (torch.take_along_dim(zk, idx[:, None, None], dim=1)[:, 0]
             + biases[idx, li].to(torch.float32))
        h = z if li == nl - 1 else torch.relu(z)
    return h[:, 0]


def fused_mlp_score_stacked_plain(xs: torch.Tensor, weights: torch.Tensor,
                                  biases: torch.Tensor) -> torch.Tensor:
    """xs (K, B, H) per-kind row stacks; weights (K, L, H, H);
    biases (K, L, H) -> (K, B): every kind's chain as one K-batched
    product per layer (the CPU lowering of the row-mapped scorer)."""
    nl = weights.shape[1]
    h = xs.to(torch.float32)
    for li in range(nl):
        z = torch.baddbmm(biases[:, li, None, :].to(torch.float32), h,
                          weights[:, li].to(torch.float32))
        h = z if li == nl - 1 else torch.relu(z)
    return h[..., 0]


# ---------------------------------------------------------------------------
# Wrappers: kernel on CUDA tensors, plain version on CPU tensors
# ---------------------------------------------------------------------------
def _check_stack(x: torch.Tensor, weights: torch.Tensor,
                 biases: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be (B, H), got shape {tuple(x.shape)}")
    hdim = x.shape[1]
    if weights.dim() != 4 or tuple(weights.shape[2:]) != (hdim, hdim):
        raise ValueError(f"weights shape {tuple(weights.shape)} is not "
                         f"(K, L, {hdim}, {hdim})")
    if tuple(biases.shape) != tuple(weights.shape[:3]):
        raise ValueError(f"biases shape {tuple(biases.shape)} is not "
                         f"{tuple(weights.shape[:3])}")


def check_cuda_tensors(name: str, x: torch.Tensor, *named) -> None:
    """What every MLP launcher assumes of its tensors: ``x`` and each
    ``(tensor, what, dtype)`` of ``named`` on one sm_90 CUDA device, of
    the stated type, contiguous and 16-byte aligned, and ``x`` float32."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {x.device} are neither CPU "
                         f"nor CUDA")
    for t, what, dtype in ((x, "x", torch.float32), *named):
        if t.device != x.device:
            raise ValueError(f"{name}: {what} on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned")
    cap = torch.cuda.get_device_capability(x.device)
    if cap != (9, 0):
        raise RuntimeError(
            f"{name} is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(x.device)} has capability {cap}")


def _check_cuda(name: str, x: torch.Tensor, kinds: torch.Tensor,
                weights: torch.Tensor, biases: torch.Tensor) -> None:
    """Everything the CUDA launcher assumes, checked before launching."""
    check_cuda_tensors(name, x, (kinds, "kinds", torch.int32),
                       (weights, "weights", torch.float32),
                       (biases, "biases", torch.float32))
    nk, hdim = weights.shape[0], x.shape[1]
    if not 0 < nk <= 32 or hdim % 4 or hdim > 1024:
        raise ValueError(f"{name}: needs 1 <= K <= 32 kinds and H a "
                         f"multiple of 4 up to 1024, got K={nk}, H={hdim}")
    if x.shape[0] == 0:
        raise ValueError(f"{name}: empty batch (callers never launch one)")


def _ptrs(*tensors) -> list:
    return [t.data_ptr() for t in tensors]


def check_in_features(in_features: Optional[int], hdim: int) -> int:
    """The columns of x a chain's first layer reads: ``in_features``, or
    all ``hdim`` for None."""
    if in_features is None:
        return hdim
    if not 0 < int(in_features) <= hdim:
        raise ValueError(f"in_features must be in 1..{hdim}, got "
                         f"{in_features}")
    return int(in_features)


def chain_scratch(x: torch.Tensor, layers: int) -> torch.Tensor:
    """The two (B, H) float32 activation buffers a tensor-core chain
    passes its layers through (none needed for one layer)."""
    rows = x.shape[0] if layers > 1 else 0
    return torch.empty((2, rows, x.shape[1]), dtype=torch.float32,
                       device=x.device)


def fused_mlp_score(x: torch.Tensor, block_kinds: torch.Tensor,
                    weights: torch.Tensor, biases: torch.Tensor,
                    block_m: int = 128,
                    in_features: Optional[int] = None) -> torch.Tensor:
    """x (B, H) kind-grouped rows; block_kinds (B // block_m,);
    weights (K, L, H, H); biases (K, L, H) -> (B,) float32.

    ``B`` must be a whole number of ``block_m`` blocks and every row of
    block ``i`` must belong to kind ``block_kinds[i]``.  Given
    ``in_features``, rows ``in_features..H`` of every ``weights[k, 0]``
    must be zero (as ``pack_mlp_params`` leaves them), and the kernel's
    first layer reads only the first ``in_features`` columns of x: the same
    function for any x.  None means H, every column."""
    _check_stack(x, weights, biases)
    bsz, hdim = x.shape
    k_in = check_in_features(in_features, hdim)
    nb = block_kinds.shape[0]
    if nb * block_m != bsz:
        raise ValueError(f"x rows ({bsz}) != blocks x block_m "
                         f"({nb} x {block_m})")
    if x.device.type == "cpu":
        return fused_mlp_score_plain(x, block_kinds, weights, biases)
    _check_cuda("fused_mlp_score", x, block_kinds, weights, biases)
    if block_m % 16:
        raise ValueError(f"block_m ({block_m}) must be a multiple of 16")
    out = torch.empty(bsz, dtype=torch.float32, device=x.device)
    nk, nl = weights.shape[0], weights.shape[1]
    scratch = chain_scratch(x, nl)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        build.launch("fused_mlp_score",
                     *_ptrs(x, block_kinds, weights, biases, out,
                            scratch[0], scratch[1]),
                     bsz, hdim, nl, nk, block_m, k_in, stream)
    LAUNCHES["fused_mlp_score"] += 1
    return out


def fused_mlp_score_rows(x: torch.Tensor, row_kinds: torch.Tensor,
                         weights: torch.Tensor, biases: torch.Tensor,
                         block_m: int = 128,
                         in_features: Optional[int] = None) -> torch.Tensor:
    """x (B, H) rows in ANY kind order; row_kinds (B,) int32;
    weights (K, L, H, H); biases (K, L, H) -> (B,) float32.

    ``B`` must be a whole number of ``block_m`` blocks; padding rows must
    carry a valid kind and their outputs are garbage by contract.  Given
    ``in_features``, rows ``in_features..H`` of every ``weights[k, 0]``
    must be zero and the kernel's first layer reads only that many columns
    of x, as in :func:`fused_mlp_score`.  Beyond the reference's contract,
    the kernel gives NaN for a row whose kind lies outside ``[0, K)`` and
    leaves the other rows as they are."""
    _check_stack(x, weights, biases)
    bsz, hdim = x.shape
    k_in = check_in_features(in_features, hdim)
    if tuple(row_kinds.shape) != (bsz,):
        raise ValueError(f"row_kinds shape {tuple(row_kinds.shape)} != "
                         f"({bsz},)")
    if bsz % block_m:
        raise ValueError(f"x rows ({bsz}) not a multiple of block_m "
                         f"({block_m})")
    if x.device.type == "cpu":
        return fused_mlp_score_rows_plain(x, row_kinds, weights, biases)
    _check_cuda("fused_mlp_score_rows", x, row_kinds, weights, biases)
    out = torch.empty(bsz, dtype=torch.float32, device=x.device)
    nk, nl = weights.shape[0], weights.shape[1]
    scratch = chain_scratch(x, nl)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        build.launch("fused_mlp_score_rows",
                     *_ptrs(x, row_kinds, weights, biases, out,
                            scratch[0], scratch[1]),
                     bsz, hdim, nl, nk, k_in, stream)
    LAUNCHES["fused_mlp_score_rows"] += 1
    return out
