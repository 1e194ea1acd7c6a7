"""Mamba2 (state-space duality / SSD) blocks (port of ``repro.models.ssm``).

``ssd_chunked`` is the chunked SSD algorithm of arXiv:2405.21060 in plain
PyTorch and ``ssd_reference`` the naive sequential recurrence, both as in
the reference.  The model's prefill scan (:func:`mamba_block`) runs on
the Hopper SSD kernel (:mod:`repro_torch.kernels.ssd`), which on CPU
tensors computes its plain version; the one-token decode step is plain
PyTorch, as it is plain jnp in the reference.

Shapes: x (B, L, H, P)   dt (B, L, H)   A (H,)   B, C (B, L, G, N), G=1.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ssd as ssd_k
from repro_torch.models.layers import init_dense, rms_norm
from repro_torch.parallel import ctx


def ssd_reference(x, dt, a, b, c, d_skip=None):
    """Sequential SSD recurrence: S_t = S_{t-1} exp(dt_t A) + dt_t B_t x_t."""
    bs, l, h, p = x.shape
    n = b.shape[-1]
    g = b.shape[2]
    rep = h // g
    bh = torch.repeat_interleave(b, rep, dim=2).to(torch.float32)
    ch = torch.repeat_interleave(c, rep, dim=2).to(torch.float32)
    xf = x.to(torch.float32)
    dtf = dt.to(torch.float32)
    s = torch.zeros((bs, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(l):
        decay = torch.exp(dtf[:, t] * a)[..., None, None]          # (B,H,1,1)
        s = s * decay + (dtf[:, t, :, None] * bh[:, t])[..., :, None] \
            * xf[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", ch[:, t], s))
    y = torch.stack(ys, dim=1)
    if d_skip is not None:
        y = y + d_skip[None, None, :, None] * xf
    return y.to(x.dtype)


def ssd_chunked(x, dt, a, b, c, d_skip=None, chunk: int = 256,
                return_final=False):
    """Chunked SSD (the paper's hardware-efficient dual form)."""
    bs, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    q = min(chunk, l)
    pad = (-l) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    lp = l + pad
    nc = lp // q
    xc = x.reshape(bs, nc, q, h, p).to(torch.float32)
    dtc = dt.reshape(bs, nc, q, h).to(torch.float32)
    bc = b.reshape(bs, nc, q, g, n).to(torch.float32)
    cc = c.reshape(bs, nc, q, g, n).to(torch.float32)
    rep = h // g
    bhc = torch.repeat_interleave(bc, rep, dim=3)          # (B,nc,Q,H,N)
    chc = torch.repeat_interleave(cc, rep, dim=3)

    adt = dtc * a                                          # (B,nc,Q,H), negative
    cum = torch.cumsum(adt, dim=2)

    # ---- intra-chunk (quadratic within chunk) -----------------------------
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,Qi,Qj,H)
    ii = torch.arange(q, device=x.device)
    causal = (ii[:, None] >= ii[None, :])
    decay = torch.exp(seg.masked_fill(~causal[None, None, :, :, None],
                                      float("-inf")))
    scores = torch.einsum("bcihn,bcjhn->bcijh", chc, bhc)
    att = scores * decay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att, xc)

    # ---- chunk states -------------------------------------------------------
    tail = torch.exp(cum[:, :, -1:, :] - cum)              # (B,nc,Q,H)
    weighted = (tail * dtc)[..., None] * bhc               # (B,nc,Q,H,N)
    states = torch.einsum("bcqhn,bcqhp->bchnp", weighted, xc)

    # ---- inter-chunk recurrence ---------------------------------------------
    chunk_decay = torch.exp(cum[:, :, -1, :])              # (B,nc,H)
    s = torch.zeros((bs, h, n, p), dtype=torch.float32, device=x.device)
    s_prevs = []
    for ci in range(nc):
        s_prevs.append(s)
        s = s * chunk_decay[:, ci, :, None, None] + states[:, ci]
    s_prevs = torch.stack(s_prevs, dim=1)                  # (B,nc,H,N,P)

    y_inter = torch.einsum("bcqhn,bchnp->bcqhp",
                           chc * torch.exp(cum)[..., None], s_prevs)
    y = (y_intra + y_inter).reshape(bs, lp, h, p)[:, :l]
    if d_skip is not None:
        y = y + d_skip[None, None, :, None] * x.reshape(bs, lp, h, p)[:, :l]
    y = y.to(torch.float32)
    if return_final:
        return y, s
    return y


# ---------------------------------------------------------------------------
# Full Mamba2 block
# ---------------------------------------------------------------------------
def init_mamba_block(cfg, dtype: torch.dtype,
                     generator: torch.Generator) -> Dict[str, torch.Tensor]:
    d, di = cfg.d_model, cfg.d_inner
    g, n, h, k = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    conv_dim = di + 2 * g * n
    dev = generator.device
    return {
        "in_proj": init_dense((d, 2 * di + 2 * g * n + h), dtype, generator),
        "conv_w": init_dense((k, conv_dim), dtype, generator, scale=0.5),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "a_log": torch.log(torch.as_tensor(
            np.linspace(1.0, 16.0, h, dtype=np.float32), device=dev)),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=dev),
        "norm": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": init_dense((di, d), dtype, generator),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor = None):
    """Depthwise causal conv along seq.  xbc: (B, L, C); w: (K, C)."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = state
    xp = torch.cat([pad, xbc], dim=1)
    out = sum(xp[:, i:i + xbc.shape[1]] * w[i] for i in range(k))
    new_state = xp[:, -(k - 1):] if k > 1 else pad
    return F.silu(out + b), new_state


def _split_proj(cfg, proj):
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    z = proj[..., :di]
    xbc = proj[..., di:2 * di + 2 * g * n]
    dt = proj[..., 2 * di + 2 * g * n:]
    return z, xbc, dt


#: the Mamba2 block's parameters, in the order :func:`_mamba_per_shard`
#: passes them
BLOCK_PARAMS = ("in_proj", "conv_w", "conv_b", "dt_bias", "a_log", "d_skip",
                "norm", "out_proj")


def mamba_block(params, x: torch.Tensor, cfg, return_state=False):
    """Prefill Mamba2 block.  x: (B, L, D) -> (B, L, D).

    The SSD scan is kernel 2, at the kernel's chunk (``cfg.ssm_chunk``
    capped at ``ssd.MAX_CHUNK``: the chunk changes only the rounding);
    its gradient is ``ssd_chunked``'s at ``cfg.ssm_chunk``, the chunk the
    reference trains with.  B and C of the one group reach it as
    head-broadcast views, and the D-skip is added here, as the
    reference's ``ssd_chunked`` adds it.  On a mesh whose every dim
    splits x's tokens (the ``dp`` and ``sp`` profiles) and has more than
    one rank, without the decode states, the block runs per shard
    (:func:`_mamba_per_shard`); elsewhere the scan runs through the op's
    DTensor sharding rule."""
    if not return_state and _per_shard_mesh(x):
        return _mamba_per_shard(params, x, cfg)
    return _mamba_block(params, x, cfg, return_state)


def _per_shard_mesh(x) -> bool:
    """Whether ``x`` is a DTensor on a mesh of more than one rank whose
    every mesh dim of more than one rank splits its batch or its
    sequence."""
    if not ctx.is_dtensor(x) or x.device_mesh.size() == 1:
        return False
    from torch.distributed.tensor import Shard
    return all(x.device_mesh.size(i) == 1 or p in (Shard(0), Shard(1))
               for i, p in enumerate(x.placements))


def _mamba_per_shard(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """:func:`mamba_block` on each rank's own sequences (``local_map``),
    every placement and gradient placement given, as FSDP runs a layer:
    the block's weights are gathered whole (``in_proj`` and ``out_proj``
    split over the mesh under ``dp``), and their gradients are partial
    sums over the dims that split the batch, reduced back to the weights'
    placements (a reduce-scatter, not an all-reduce of the whole
    gradient).  x keeps its batch split; a dim that splits its sequence
    (``sp``) gathers it, as the scan runs over the whole sequence, and
    every rank of that dim runs the same block (the weights' gradients
    whole over it).  So the scan op runs on the rank's plain sequences:
    DTensor plans none of the block's products, and no view of the block
    cuts a split dim (some torch releases refuse to flatten the batch
    beside a split sequence)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    px = tuple(x.placements)
    p_x = tuple(Shard(0) if p == Shard(0) else Replicate() for p in px)
    whole = tuple(Replicate() for _ in px)
    g_w = tuple(Partial() if p == Shard(0) else Replicate() for p in p_x)
    weights = [params[k] for k in BLOCK_PARAMS]

    def block(x_, *ws):
        return _mamba_block(dict(zip(BLOCK_PARAMS, ws)), x_, cfg)
    out = local_map(block, out_placements=(p_x,),
                    in_placements=(p_x,) + (whole,) * len(weights),
                    in_grad_placements=(p_x,) + (g_w,) * len(weights),
                    device_mesh=mesh, redistribute_inputs=True)(x, *weights)
    return out.redistribute(mesh, px)


def _mamba_block(params, x: torch.Tensor, cfg, return_state=False):
    """:func:`mamba_block` as it runs on plain tensors, or on DTensors
    with the products and views left to DTensor."""
    bs, l, _ = x.shape
    di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    p = cfg.ssm_head_dim
    proj = x @ params["in_proj"]
    z, xbc_raw, dt_raw = _split_proj(cfg, proj)
    xbc, conv_state = _causal_conv(xbc_raw, params["conv_w"],
                                   params["conv_b"])
    xs = xbc[..., :di].reshape(bs, l, h, p)
    bmat = xbc[..., di:di + g * n].reshape(bs, l, g, n).expand(bs, l, h, n)
    cmat = xbc[..., di + g * n:].reshape(bs, l, g, n).expand(bs, l, h, n)
    dt = F.softplus(dt_raw.to(torch.float32) + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    y, s_final = ssd_k.ssd(xs.transpose(1, 2), dt.transpose(1, 2), a,
                           bmat.transpose(1, 2), cmat.transpose(1, 2),
                           chunk=min(cfg.ssm_chunk, ssd_k.MAX_CHUNK),
                           vjp_chunk=cfg.ssm_chunk)
    y = y.transpose(1, 2) + params["d_skip"][None, None, :, None] \
        * xs.to(torch.float32)
    y = ctx.heads_in_grad(y.reshape(bs, l, di), 2, h).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    out = y @ params["out_proj"]
    if return_state:
        return out, {"conv": conv_state, "ssm": s_final}
    return out


def mamba_state_shapes(cfg, batch: int, dtype: torch.dtype
                       ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """The decode state's (shape, dtype) by name: the conv window and the
    fp32 SSM state."""
    di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    return {"conv": ((batch, cfg.ssm_conv - 1, di + 2 * g * n), dtype),
            "ssm": ((batch, h, n, cfg.ssm_head_dim), torch.float32)}


def init_mamba_state(cfg, batch: int, dtype: torch.dtype,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in mamba_state_shapes(cfg, batch,
                                                     dtype).items()}


def _read_state(ch: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``einsum("bhn,bhnp->bhp", ch, s)``.  On a mesh it runs on each
    rank's shard of the state, as the state is split (a split N gives a
    partial sum): some torch releases' DTensor cannot flatten the batch
    and a split head dim into the product's batch."""
    if not ctx.is_dtensor(s):
        return torch.einsum("bhn,bhnp->bhp", ch, s)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    ps = tuple(s.placements)
    p_ch = tuple(p if isinstance(p, Shard) and p.dim < 3 else Replicate()
                 for p in ps)
    p_y = tuple(Partial() if p == Shard(2) else
                Shard(2) if p == Shard(3) else p for p in ps)
    return local_map(lambda c, st: torch.einsum("bhn,bhnp->bhp", c, st),
                     out_placements=(p_y,), in_placements=(p_ch, ps),
                     device_mesh=s.device_mesh,
                     redistribute_inputs=True)(ch, s)


def mamba_decode_step(params, x: torch.Tensor, state: Dict,
                      cfg) -> Tuple[torch.Tensor, Dict]:
    """One-token decode.  x: (B, 1, D).

    On a mesh ``in_proj`` and ``out_proj`` run per shard
    (``ctx.product``, planned by the bytes a rank receives): the few
    tokens move to the weights' D split over ``data``, and ``model``
    splits ``in_proj``'s columns (3352 at Mamba2-130M, cut unevenly over
    16 ranks) or ``out_proj``'s d_inner, so no ``model`` rank runs a
    product another runs.  The state update and its read stay on the
    state's own split (``cache_specs`` splits N over ``model`` where the
    24 heads cannot be).  What stays repeated on each ``model`` rank is
    elementwise work on the rank's tokens: dt's softplus and decay, the
    skip term, the gate and the norm, about 10 FLOPs an element of
    (tokens, d_inner), 1.2e5 a layer for the 8 tokens of a production
    decode rank against its 2.6e6 of ``in_proj`` products."""
    bs = x.shape[0]
    di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    p = cfg.ssm_head_dim
    proj = ctx.product(x, params["in_proj"])
    z, xbc, dt_raw = _split_proj(cfg, proj)
    xbc, conv_state = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                   state["conv"])
    # the conv ran on the channels' split (``conv_w``'s); gathered once,
    # not once for each of x, B and C cut from it
    xbc = ctx.whole(xbc, 2)
    xs = xbc[..., :di].reshape(bs, h, p)
    bmat = xbc[..., di:di + g * n].reshape(bs, g, n)
    cmat = xbc[..., di + g * n:].reshape(bs, g, n)
    rep = h // g
    bh = torch.repeat_interleave(bmat, rep, dim=1).to(torch.float32)
    ch = torch.repeat_interleave(cmat, rep, dim=1).to(torch.float32)
    dt = F.softplus(dt_raw.to(torch.float32) + params["dt_bias"])[:, 0]
    a = -torch.exp(params["a_log"])
    decay = torch.exp(dt * a)[..., None, None]
    s = state["ssm"] * decay + \
        (dt[..., None] * bh)[..., :, None] \
        * xs.to(torch.float32)[..., None, :]
    y = _read_state(ch, s)
    y = y + params["d_skip"][None, :, None] * xs.to(torch.float32)
    # P whole before the flatten: some torch releases' DTensor cannot
    # flatten heads beside a split head dim
    y = ctx.whole(y, 2).reshape(bs, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    return ctx.product(y, params["out_proj"]), {"conv": conv_state, "ssm": s}
