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
from repro_torch.parallel.ctx import chunk_ranges, take_ranges


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
    reference's ``ssd_chunked`` adds it.  On a mesh of more than one
    rank the block runs per shard: where every mesh dim of more than one
    rank splits x's tokens (the ``dp`` and ``sp`` profiles), without the
    decode states, on each rank's own sequences
    (:func:`_mamba_per_shard`); where ``model`` does not split them (the
    ``2d`` serving mesh, the decode states too), on each ``model`` rank's
    range of the heads (:func:`_mamba_heads`).  Elsewhere (a one-rank
    mesh) the scan runs through the op's DTensor sharding rule."""
    if _per_shard_mesh(x) and not return_state:
        return _mamba_per_shard(params, x, cfg)
    dim = _heads_dim(x)
    if dim is not None:
        return _mamba_heads(params, x, cfg, dim, return_state)
    return _mamba_block(params, x, cfg, return_state)


def _heads_dim(x):
    """The mesh dim ``model`` where the Mamba2 block may cut its heads over
    it (:func:`_mamba_heads`): x is a DTensor on a mesh of more than one
    rank, ``model`` has more than one rank and splits neither x's batch
    nor its sequence.  None elsewhere."""
    if not ctx.is_dtensor(x) or x.device_mesh.size() == 1:
        return None
    from torch.distributed.tensor import Shard
    names = ctx.axis_names(x.device_mesh)
    if "model" not in names:
        return None
    dim = names.index("model")
    if x.device_mesh.size(dim) == 1 or x.placements[dim] in (Shard(0),
                                                             Shard(1)):
        return None
    return dim


#: the dim of each Mamba2 parameter that a ``model`` rank cuts by heads
#: (:func:`_needs`)
_HEAD_AXIS = {"in_proj": 1, "conv_w": 1, "conv_b": 0, "dt_bias": 0,
              "a_log": 0, "d_skip": 0, "norm": 0, "out_proj": 0}


def _needs(cfg, heads) -> Dict[str, list]:
    """The ``[start, end)`` ranges of each Mamba2 parameter (by name,
    along :data:`_HEAD_AXIS`) that the heads ``[h0, h1)`` need: their z,
    x and dt columns of ``in_proj`` and the one group's B and C columns
    (every rank's), the same channels of the conv, their scalars, rows
    of the norm's scale and of ``out_proj``.  Empty ranges are left
    out."""
    h0, h1 = heads
    p, di = cfg.ssm_head_dim, cfg.d_inner
    gn2 = 2 * cfg.ssm_groups * cfg.ssm_state
    hx = (h0 * p, h1 * p)

    def ranges(*rs):
        return [r for r in rs if r[1] > r[0]]
    conv = ranges(hx, (di, di + gn2))
    return {"in_proj": ranges(hx, (di + hx[0], di + hx[1]),
                              (2 * di, 2 * di + gn2),
                              (2 * di + gn2 + h0, 2 * di + gn2 + h1)),
            "conv_w": conv, "conv_b": conv, "dt_bias": ranges((h0, h1)),
            "a_log": ranges((h0, h1)), "d_skip": ranges((h0, h1)),
            "norm": ranges(hx), "out_proj": ranges(hx)}


class _SumOver(torch.autograd.Function):
    """An all-reduce (sum) over one mesh dim, with its gradient (the sum
    of every rank's gradient, as each rank's output feeds that rank's own
    work): some torch releases give the functional all-reduce none."""

    @staticmethod
    def forward(fctx, t, group):
        import torch.distributed._functional_collectives as funcol
        fctx.group = group
        return funcol.wait_tensor(funcol.all_reduce(t, "sum", group))

    @staticmethod
    def backward(fctx, grad):
        import torch.distributed._functional_collectives as funcol
        return funcol.wait_tensor(funcol.all_reduce(
            grad.contiguous(), "sum", fctx.group)), None


def _mamba_heads(params, x: torch.Tensor, cfg, dim: int,
                 return_state=False):
    """:func:`mamba_block` on each rank's shard (``local_map``), the heads
    cut over mesh dim ``dim`` (``model``) with ``torch.chunk``'s sizes (24
    heads on 16 ranks: 2 a rank on ranks 0-11, none on 12-15), every
    placement and gradient placement stated.

    Each ``model`` rank takes x's own sequences (a dim that splits the
    batch keeps it; x's D split over ``model``, the norm's, is gathered
    in the body, its gradient reduce-scattered back) and only its own
    parameters' ranges (:func:`_needs`): its heads' z, x and dt columns
    of ``in_proj`` and the group's B and C columns, the same conv
    channels (the conv is depthwise), its heads' scalars and rows of the
    norm's scale and of ``out_proj``.  B and C, which every rank needs,
    are each rank's partial sums over its range of D, summed over
    ``model`` (a (B, L, 2 N) all-reduce), not computed whole on every
    rank: at Mamba2-130M that would repeat 256 of a rank's 514 columns
    16 times (1.45x the reference's FLOPs on a CPU trace, 0.96x so).
    They are cut inside the body (:func:`take_ranges`): a parameter whole
    over ``model`` locally, one split over ``model`` (zamba2's
    ``in_proj``, 653 of its 10448 columns a rank) by one all-to-all of
    just the ranges each rank needs, so no rank gathers ``in_proj``
    whole and none gathers its output.  The weights' splits over the
    other dims are gathered whole (FSDP's gather of a layer), their
    gradients partial sums over the dims that split the batch, reduced
    back to the weights' placements.  The scan runs on the rank's plain
    heads; a rank with none launches no kernel (a grid of no CTAs is not
    a launch) and its scan's outputs are empty.  The gated RMS norm over
    d_inner sums its squares over ``model`` (a (B, L, 1) fp32 partial a
    rank), so it is the whole row's norm.  ``out_proj`` on the rank's
    rows leaves a partial sum over ``model``, reduced to the residual
    stream's placement (whole over ``model``), and x's gradient is a
    partial sum over ``model`` too.

    The decode states leave as partial sums over ``model`` (each rank's
    heads' conv channels and SSM states, zeros elsewhere; the B and C
    channels on ``model`` rank 0 only), which ``transformer.prefill``
    reduce-scatters into the cache's placement (``sharding.
    cache_specs``: the conv's channels, and the SSM state's N or heads,
    over ``model``).  That costs a layer each rank's (B, H, N, P) fp32
    and (B, K - 1, conv channels) buffers: about 1.5 MB a device for
    Mamba2-130M's 2 sequences a data rank (24 x 128 x 64 x 4 bytes a
    sequence), a reduce-scatter that receives a sixteenth of it."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    ways, rank = mesh.size(dim), mesh.get_local_rank(dim)
    heads = chunk_ranges(cfg.ssm_heads, ways)
    needs = [_needs(cfg, hr) for hr in heads]
    rows = [i != dim and p == Shard(0) for i, p in enumerate(x.placements)]
    # x's D split over model (the norm's scale) stays: the body gathers it
    x_split = x.placements[dim] == Shard(2)
    p_res = tuple(Shard(0) if r else Replicate() for r in rows)
    p_x = tuple(Shard(2) if i == dim and x_split else p
                for i, p in enumerate(p_res))
    g_x = tuple(Partial() if i == dim and not x_split else p
                for i, p in enumerate(p_x))
    p_part = tuple(Partial() if i == dim else p for i, p in enumerate(p_res))
    weights = [params[k] for k in BLOCK_PARAMS]
    p_w, g_w, split = [], [], []
    for name, w in zip(BLOCK_PARAMS, weights):
        axis = _HEAD_AXIS[name]
        kept = w.placements[dim] == Shard(axis)
        split.append(kept)
        p_w.append(tuple((Shard(axis) if kept else Replicate()) if i == dim
                         else Replicate() for i in range(mesh.ndim)))
        g_w.append(tuple((Shard(axis) if kept else Partial()) if i == dim
                         else Partial() if rows[i] else Replicate()
                         for i in range(mesh.ndim)))
    group = (mesh, dim)
    h0, h1 = heads[rank]
    hl, p = h1 - h0, cfg.ssm_head_dim
    di, h, gn = cfg.d_inner, cfg.ssm_heads, cfg.ssm_groups * cfg.ssm_state
    d0, d1 = chunk_ranges(x.shape[-1], ways)[rank]

    def block(x_, *ws):
        import torch.distributed._functional_collectives as funcol
        w = {name: take_ranges(t, _HEAD_AXIS[name],
                               params[name].shape[_HEAD_AXIS[name]], kept,
                               [n[name] for n in needs], rank, group)
             for name, t, kept in zip(BLOCK_PARAMS, ws, split)}
        if x_split:
            xk, x_ = x_, funcol.wait_tensor(funcol.all_gather_tensor_autograd(
                x_, 2, group))
        else:
            xk = x_.narrow(-1, d0, d1 - d0)
        bs, l, _ = x_.shape
        w_in = w["in_proj"]
        zx, w_bc = w_in.narrow(1, 0, 2 * hl * p), w_in.narrow(1, 2 * hl * p,
                                                                2 * gn)
        proj = x_ @ torch.cat([zx, w_in.narrow(1, 2 * hl * p + 2 * gn, hl)],
                              1)
        # B and C, which every rank needs: each rank's partial sum over its
        # range of D, summed over model (not run whole on every rank)
        bc = _SumOver.apply(xk @ w_bc.narrow(0, d0, d1 - d0), group)
        z = proj.narrow(-1, 0, hl * p)
        xbc, conv_state = _causal_conv(
            torch.cat([proj.narrow(-1, hl * p, hl * p), bc], -1),
            w["conv_w"], w["conv_b"])
        dt_raw = proj.narrow(-1, 2 * hl * p, hl)
        xs = xbc.narrow(-1, 0, hl * p).reshape(bs, l, hl, p)
        bmat = xbc.narrow(-1, hl * p, gn).reshape(bs, l, 1, gn)
        cmat = xbc.narrow(-1, hl * p + gn, gn).reshape(bs, l, 1, gn)
        bmat, cmat = bmat.expand(bs, l, hl, gn), cmat.expand(bs, l, hl, gn)
        dt = F.softplus(dt_raw.to(torch.float32) + w["dt_bias"])
        a = -torch.exp(w["a_log"])
        args = (xs.transpose(1, 2), dt.transpose(1, 2), a,
                bmat.transpose(1, 2), cmat.transpose(1, 2))
        if hl:
            y, s_final = ssd_k.ssd(*args,
                                   chunk=min(cfg.ssm_chunk, ssd_k.MAX_CHUNK),
                                   vjp_chunk=cfg.ssm_chunk)
        else:
            y, s_final = _no_heads(*args)
        y = y.transpose(1, 2) + w["d_skip"][None, None, :, None] \
            * xs.to(torch.float32)
        g = (y.reshape(bs, l, hl * p).to(x_.dtype) * F.silu(z)).to(
            torch.float32)
        var = _SumOver.apply(torch.sum(torch.square(g), -1, keepdim=True),
                             group) / di
        g = ((g * torch.rsqrt(var + cfg.norm_eps))
             * w["norm"].to(torch.float32)).to(x_.dtype)
        out = g @ w["out_proj"]
        if not return_state:
            return out
        zeros = conv_state.new_zeros
        conv = torch.cat([zeros((bs, conv_state.shape[1], h0 * p)),
                          conv_state.narrow(-1, 0, hl * p),
                          zeros((bs, conv_state.shape[1], di - h1 * p)),
                          conv_state.narrow(-1, hl * p, 2 * gn) if rank == 0
                          else zeros((bs, conv_state.shape[1], 2 * gn))], -1)
        zs = s_final.new_zeros
        ssm = torch.cat([zs((bs, h0) + s_final.shape[2:]), s_final,
                         zs((bs, h - h1) + s_final.shape[2:])], 1)
        return out, conv, ssm
    outs = local_map(block, out_placements=(p_part,) * (3 if return_state
                                                       else 1),
                     in_placements=(p_x,) + tuple(p_w),
                     in_grad_placements=(g_x,) + tuple(g_w),
                     device_mesh=mesh, redistribute_inputs=True)(x, *weights)
    out = (outs[0] if return_state else outs).redistribute(mesh, p_res)
    if return_state:
        return out, {"conv": outs[1], "ssm": outs[2]}
    return out


def _no_heads(x, dt, a, b, c):
    """The scan's (y, final state) for a rank with no heads: empty, and
    made from every input, so that autograd gives each one its (empty)
    gradient and the rank's backward runs the collectives every other
    rank runs."""
    y = x.to(torch.float32) * (dt * a[:, None])[..., None] \
        + torch.einsum("bhln,bhln->bhl", b.to(torch.float32),
                       c.to(torch.float32))[..., None]
    s = torch.einsum("bhln,bhlp->bhnp", b.to(torch.float32),
                     x.to(torch.float32))
    return y, s


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


def _split_columns(proj: torch.Tensor, pieces) -> list:
    """``proj`` (B, 1, W), a DTensor whose W is split over ``model``
    (``torch.chunk``'s sizes, as ``ctx.product`` leaves an N it splits),
    cut into the column ranges ``pieces``, each ``(start, end, split)``:
    each piece comes back split over ``model`` the same way (``split``)
    or whole on every rank.  One all-to-all over ``model`` of just the
    columns each rank's pieces need (:func:`take_ranges`): a DTensor
    slice of the split dim would gather all W columns first (zamba2's
    10448 a layer).  Off such a mesh, the plain slices."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dim = _model_split(proj, 2)
    if dim is None:
        return [proj[..., a:b] for a, b, _ in pieces]
    mesh = proj.device_mesh
    ways, rank = mesh.size(dim), mesh.get_local_rank(dim)

    def ranges(r):
        out = []
        for a, b, split in pieces:
            lo, hi = chunk_ranges(b - a, ways)[r] if split else (0, b - a)
            if hi > lo:
                out.append((a + lo, a + hi))
        return out
    got = take_ranges(proj.to_local(), 2, proj.shape[2], True,
                      [ranges(r) for r in range(ways)], rank, (mesh, dim))
    out, at = [], 0
    for a, b, split in pieces:
        lo, hi = chunk_ranges(b - a, ways)[rank] if split else (0, b - a)
        shape = tuple(proj.shape[:2]) + (b - a,)
        pl = [(Shard(2) if split else Replicate()) if i == dim else p
              for i, p in enumerate(proj.placements)]
        out.append(DTensor.from_local(
            got.narrow(2, at, hi - lo), mesh, pl, run_check=False,
            shape=torch.Size(shape), stride=ctx.contiguous_stride(shape)))
        at += hi - lo
    return out


def _model_split(t: torch.Tensor, axis: int):
    """The mesh dim ``model`` where the DTensor ``t`` (B, 1, W) has its
    dim ``axis`` split over ``model`` alone, and its tokens not
    (:func:`_heads_dim`); else None (a plain tensor, or W split over
    another mesh dim too: the 2-pod mesh's nested split of a one-slot
    ``in_proj`` output over ``pod`` and ``model``)."""
    from torch.distributed.tensor import Shard
    dim = _heads_dim(t)
    if dim is None or any((p == Shard(axis)) != (i == dim)
                          for i, p in enumerate(t.placements)):
        return None
    return dim


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    """``rms_norm(y * silu(z), scale)`` over d_inner.  Where z's d_inner is
    split over ``model`` as the scale's is (:func:`_split_columns`), each
    rank gates and scales its own columns and the row's sum of squares is
    summed over ``model`` (a (B, 1, 1) fp32 partial a rank), so z is not
    gathered."""
    from torch.distributed.tensor import Shard
    dim = _model_split(z, 2)
    if dim is None or scale.placements[dim] != Shard(0):
        return rms_norm(y * F.silu(z), scale, eps)
    from torch.distributed.tensor.experimental import local_map
    mesh, n = z.device_mesh, z.shape[-1]
    p_z = tuple(z.placements)

    def norm(y_, z_, w_):
        g = (y_ * F.silu(z_)).to(torch.float32)
        var = _SumOver.apply(torch.sum(torch.square(g), -1, keepdim=True),
                             (mesh, dim)) / n
        return ((g * torch.rsqrt(var + eps)) * w_.to(torch.float32)).to(
            y_.dtype)
    return local_map(norm, out_placements=(p_z,),
                     in_placements=(p_z, p_z, tuple(scale.placements)),
                     device_mesh=mesh, redistribute_inputs=True)(y, z, scale)


def mamba_decode_step(params, x: torch.Tensor, state: Dict,
                      cfg) -> Tuple[torch.Tensor, Dict]:
    """One-token decode.  x: (B, 1, D).

    On a mesh ``in_proj`` and ``out_proj`` run per shard
    (``ctx.product``, planned by the bytes a rank receives): the few
    tokens move to the weights' D split over ``data``, and ``model``
    splits ``in_proj``'s columns (3352 at Mamba2-130M, cut unevenly over
    16 ranks) or ``out_proj``'s d_inner, so no ``model`` rank runs a
    product another runs.  ``in_proj``'s output stays split over
    ``model``: z, x/B/C and dt are taken from it by one all-to-all of
    the tokens' columns (:func:`_split_columns`; zamba2's 10448 a layer
    were gathered whole before), z onto the norm's split of d_inner,
    where the gate and the norm run (:func:`_gated_norm`), x/B/C onto
    the conv's.  The state update and its read stay on the state's own
    split: where ``cache_specs`` splits its heads over ``model``
    (zamba2's 80 on 16), the conv's x channels go to the rank's heads
    and B and C whole, one more all-to-all; where it splits N (24 heads
    cannot be), the conv's output is gathered once.  What stays repeated
    on each ``model`` rank is elementwise work on the rank's tokens:
    dt's softplus and decay and the skip term, a few FLOPs an element of
    (tokens, heads) or (tokens, d_inner)."""
    bs = x.shape[0]
    di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    p = cfg.ssm_head_dim
    # in_proj's columns left split over model (no rank gathers them
    # whole): z on the norm's split, x/B/C on the conv's, dt whole
    proj = ctx.product(x, params["in_proj"], out="N")
    z, xbc, dt_raw = _split_columns(proj, (
        (0, di, _split_over_model(params["norm"], 0)),
        (di, 2 * di + 2 * g * n, _split_over_model(params["conv_w"], 1)),
        (2 * di + 2 * g * n, proj.shape[-1], False)))
    xbc, conv_state = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                   state["conv"])
    # the conv ran on the channels' split (``conv_w``'s).  Where the SSM
    # state's heads split over model, x's channels go to that split
    # (whole heads a rank) and B and C whole, one move; else all of it
    # gathered once, not once for each of x, B and C cut from it
    heads = _split_over_model(state["ssm"], 1)
    if heads:
        xs, bmat, cmat = _split_columns(xbc, ((0, di, True),
                                              (di, di + g * n, False),
                                              (di + g * n, di + 2 * g * n,
                                               False)))
        xs = ctx.split_last(xs, h)[:, 0]
    else:
        xbc = ctx.whole(xbc, 2)
        xs = xbc[..., :di].reshape(bs, h, p)
        bmat, cmat = xbc[..., di:di + g * n], xbc[..., di + g * n:]
    bmat, cmat = bmat.reshape(bs, g, n), cmat.reshape(bs, g, n)
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
    if heads:
        # the heads' split becomes d_inner's, the norm's and z's
        y = ctx.merge_last(y)[:, None].to(x.dtype)
    else:
        # P whole before the flatten: some torch releases' DTensor cannot
        # flatten heads beside a split head dim
        y = ctx.whole(y, 2).reshape(bs, 1, di).to(x.dtype)
    y = _gated_norm(y, z, params["norm"], cfg.norm_eps)
    return ctx.product(y, params["out_proj"]), {"conv": conv_state, "ssm": s}


def _split_over_model(w: torch.Tensor, axis: int) -> bool:
    """Whether the DTensor ``w`` is split over ``model`` along ``axis``."""
    if not ctx.is_dtensor(w):
        return False
    from torch.distributed.tensor import Shard
    names = ctx.axis_names(w.device_mesh)
    return "model" in names and \
        w.placements[names.index("model")] == Shard(axis)
