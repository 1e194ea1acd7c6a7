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
the Mamba2 scan runs kernel 2; both kernels are dispatcher ops with a
gradient, so ``loss_fn`` trains through them.  MoE layers add their
load-balancing loss to ``forward``'s aux loss, which ``loss_fn`` adds to
the cross-entropy.  On a mesh, attention runs on each rank's shard as
XLA partitions the reference's: prefill and training split the query
heads over ``model`` (:func:`_flash_attend`), and decode reads a cache
whose sequence is split from per-shard softmax partials
(:func:`_decode_attend`).

With ``cfg.remat``, ``forward`` checkpoints each layer body (hybrid: each
group, and each Mamba2 layer inside it) as the reference wraps its scan
bodies in ``jax.checkpoint``: non-reentrant
``torch.utils.checkpoint``, so the backward runs each layer's forward
again (the kernels included) before its gradient; ``remat_policy="dots"``
keeps the outputs of the matmuls without batch dimensions (``mm``,
``addmm``: JAX's ``checkpoint_dots_with_no_batch_dims``).  Without grad
mode there is nothing to save, and the bodies run as they are.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.devices import torch_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, cross_entropy, init_dense,
                                       rms_norm, swiglu)
from repro_torch.parallel import ctx

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def _shard_act(x: torch.Tensor) -> torch.Tensor:
    """Keep (B, S, D) activations batch- (and, under the sequence-parallel
    profile, sequence-) sharded through the layers (a no-op off a
    mesh)."""
    return ctx.constrain(x, "batch", "seq", None)


def _shard_decode(x: torch.Tensor) -> torch.Tensor:
    """Decode's (B, 1, D) residual stream held as :func:`_shard_act` holds
    it where the mesh splits the batch; left as it is where it does not
    (one slot, ``long_500k``: every rank holds the row anyway, and the
    hint would only replicate the layer's products)."""
    mesh = ctx.current_mesh()
    if mesh is None or ctx.resolve(tuple(x.shape), ("batch",), mesh)[0] \
            is None:
        return x
    return _shard_act(x)


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
    on (``models.evalzoo``, ``train.train_step.init_state``)."""

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

    def map(self, fn: Callable[[str, torch.Tensor], torch.Tensor]
            ) -> "LMParams":
        """A new ``LMParams`` of the same structure holding ``fn(name,
        tensor)`` for each of ``named_parameters()``, each with its
        parameter's ``requires_grad`` (the reference's ``jax.tree.map``
        over a parameter tree)."""
        top = {k: fn(k, t) for k, t in self.named_parameters(recurse=False)}
        layers = [{k: fn(f"layers.{i}.{k}", t) for k, t in blk.items()}
                  for i, blk in enumerate(self.layers)]
        shared = None if self.shared is None else {
            k: fn(f"shared.{k}", t) for k, t in self.shared.items()}
        out = LMParams(top, layers, shared)
        for new, old in zip(out.parameters(), self.parameters()):
            new.requires_grad_(old.requires_grad)
        return out

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


class _MetaGenerator:
    """Stands in for the generator on the ``meta`` device, which has none:
    the init's draws there allocate and draw nothing."""
    device = torch.device("meta")


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> LMParams:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (default ``cuda``), with the reference's distributions; on ``meta``,
    their shapes and dtypes only (``launch.specs.abstract_params``)."""
    _check_family(cfg)
    dev = torch_device(device)
    gen = (_MetaGenerator() if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
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
def _split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, S, n * hd) -> (B, S, n, hd), whole heads on a mesh, where the
    reshape runs on each rank's shard (``ctx.gather_heads``: a split of
    the columns that does not divide the heads is gathered, and its
    gradient reduce-scattered back)."""
    return ctx.gather_heads(t, n)


def _qkv(blk, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
         out: str = "N"):
    """q, k and v (B, S, heads, hd) of the residual stream x, each
    projection per shard (``ctx.product``, one move of x where the three
    plans agree), its output ``out`` on the mesh dims that leave the
    tokens whole: ``"N"`` split over the heads where the plan splits
    them, ``"R"`` whole (the zig-zag prefill's, whose heads cannot
    split)."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    hn = rms_norm(x, blk["ln1"], cfg.norm_eps)
    q, k, v = ctx.product(hn, (blk["wq"], blk["wk"], blk["wv"]), out=out)
    q = _split_heads(q, h, hd)
    k = _split_heads(k, kv, hd)
    v = _split_heads(v, kv, hd)
    if cfg.qk_norm:
        # the (hd,) scales whole: split over model (the rules' split of
        # their stacked (L, hd)), they would cut q's and k's head dim,
        # which the rotary embedding then gathers back
        q = rms_norm(q, ctx.whole(blk["q_norm"], 0), cfg.norm_eps)
        k = rms_norm(k, ctx.whole(blk["k_norm"], 0), cfg.norm_eps)
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


def _head_split(q: torch.Tensor, kv: int) -> Optional[int]:
    """The mesh dim ``model`` (the reference's tensor-parallel axis, over
    which ``wq`` splits its heads) where a DTensor q (B, S, H, hd) may
    split its heads over it: it has more than one rank, does not split
    q's batch, divides H, and each rank's ``Hl = H / model`` query heads
    read whole KV heads of their own, because ``Hl`` divides ``rep = H /
    KV`` (the rank's heads share one KV head) or ``rep`` divides ``Hl``
    (they read ``Hl / rep`` of them).  None off a mesh and where that
    fails (4 heads on ``model=16``; ``Hl`` 3 beside ``rep`` 2)."""
    if not ctx.is_dtensor(q):
        return None
    return _head_split_of(q, q.shape[2], kv)


def _head_split_of(x: torch.Tensor, h: int, kv: int) -> Optional[int]:
    """:func:`_head_split` for the ``h`` query heads of a DTensor ``x``
    whose batch is its dim 0 (the residual stream, before the
    projections)."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    names = ctx.axis_names(mesh)
    if "model" not in names:
        return None
    dim = names.index("model")
    ways = mesh.size(dim)
    if ways == 1 or x.placements[dim] == Shard(0) or h % ways or h % kv:
        return None
    hl, rep = h // ways, h // kv
    return dim if rep % hl == 0 or hl % rep == 0 else None


def _flash_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: int) -> torch.Tensor:
    """Causal kernel-1 attention, (B, S, H, hd) out.  Where q's heads can
    split over ``model`` (:func:`_head_split`), the op runs on each
    rank's shard, as XLA partitions the reference's attention: the
    rank's query heads ``[h0, h0 + Hl)`` of its batch rows, against KV
    heads ``[h0 // rep, (h0 + Hl - 1) // rep]`` of those rows, which are
    its own shard of k and v where their heads split alike (``model``
    divides KV), else a slice of them gathered over ``model``.  The
    output stays split over the heads into ``wo``.  The backward is the
    op's VJP on the plain shards; the gradients of gathered k and v are
    partial sums over the ranks that read the same KV head.  Elsewhere
    the op runs on the DTensors under its own sharding rule (a prefill
    whose heads cannot split takes :func:`_zigzag_attend` before this)."""
    dim = _head_split(q, k.shape[2])
    if dim is None:
        return attn_mod.flash_attention(q, k, v, causal=True, window=window)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    h, kv, ways = q.shape[2], k.shape[2], mesh.size(dim)
    rep, hl = h // kv, h // ways
    own = kv % ways == 0            # each rank's KV heads are its k shard
    rows = [p == Shard(0) and q.shape[0] > 1 for p in q.placements]
    p_q = tuple(Shard(2) if i == dim else Shard(0) if rows[i]
                else Replicate() for i in range(mesh.ndim))
    p_kv = tuple(Replicate() if i == dim and not own else p
                 for i, p in enumerate(p_q))
    g_kv = tuple(Partial() if i == dim and not own else p
                 for i, p in enumerate(p_q))
    h0 = mesh.get_local_rank(dim) * hl
    lo, hi = h0 // rep, (h0 + hl - 1) // rep + 1

    def attend(q_, k_, v_):
        if not own:
            # narrow, not a slice: indexing returns the tensor itself for
            # a slice of the whole dim, which would give the ranks whose
            # slice it is an autograd graph of other nodes, their
            # backward collectives in another order, and a deadlock
            k_, v_ = k_.narrow(2, lo, hi - lo), v_.narrow(2, lo, hi - lo)
        return attn_mod.flash_attention(q_, k_, v_, causal=True,
                                        window=window)
    return local_map(attend, out_placements=(p_q,),
                     in_placements=(p_q, p_kv, p_kv),
                     in_grad_placements=(p_q, g_kv, g_kv),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def _zigzag(s: int, ways: int, rank: int, window: int
            ) -> List[Tuple[int, int, int]]:
    """The query chunks of ``rank`` in a zig-zag split of ``s`` positions
    over ``ways`` ranks: chunks ``rank`` and ``2 * ways - 1 - rank`` of
    ``s / (2 * ways)`` rows, each as (first query, end, first key).  Its
    keys are ``[first key, end)``: from 0, or with a window from where the
    window of its first query starts.  Causal, every rank's two chunks
    then hold the same number of (query, key) pairs; with a window, every
    rank's but rank 0's, whose first chunk holds the window's first
    rows."""
    c = s // (2 * ways)
    out = []
    for j in (rank, 2 * ways - 1 - rank):
        q0 = j * c
        out.append((q0, q0 + c, max(0, q0 - window + 1) if window > 0
                    else 0))
    return out


def _zigzag_split(q: torch.Tensor, kv: int) -> Optional[int]:
    """The mesh dim ``model`` where prefill's query sequence splits over
    it (:func:`_zigzag_attend`): q (B, S, H, hd) is a DTensor whose heads
    cannot split over ``model`` (:func:`_head_split` is None: 4 heads, or
    24, on ``model=16``), ``model`` has more than one rank and does not
    split q's batch, and ``2 * model`` divides S.  None elsewhere, S not
    dividing included (the op then runs on the DTensors under its own
    rule, every ``model`` rank running every head of its batch rows)."""
    if not ctx.is_dtensor(q) or _head_split(q, kv) is not None:
        return None
    from torch.distributed.tensor import Shard
    names = ctx.axis_names(q.device_mesh)
    if "model" not in names:
        return None
    dim = names.index("model")
    ways = q.device_mesh.size(dim)
    if ways == 1 or q.placements[dim] == Shard(0) or \
            q.shape[1] % (2 * ways):
        return None
    return dim


def _unzigzag(y: torch.Tensor, ways: int) -> torch.Tensor:
    """(B, S, D) rows in rank order, rank r's chunks r and ``2 * ways - 1
    - r`` side by side, back in sequence order."""
    b, s, d = y.shape
    y = y.reshape(b, ways, 2, s // (2 * ways), d)
    return torch.cat([y[:, :, 0], y[:, :, 1].flip(1)], 1).reshape(b, s, d)


def _zigzag_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   window: int, wo: torch.Tensor, dim: int) -> torch.Tensor:
    """Causal kernel-1 attention and its output projection, ``o @ wo``
    (B, S, D), with the query sequence split over mesh dim ``dim``
    (``model``, :func:`_zigzag_split`), as the heads cannot be.  Each
    rank takes its batch rows and the two chunks :func:`_zigzag` gives
    it, and makes one op call a chunk at the chunk's ``q_offset``, its
    keys cut to ``[first key, end)``; k and v stay as they are placed
    (whole over ``model``: their KV heads do not split it either).  So
    every rank runs every head on 1 / ``model`` of the sequence, and the
    traced rank counts a rank's share of the causal work.

    The output: each rank's chunks go through ``wo`` per shard
    (``ctx.product``: their rows split over ``model`` and the dims that
    split the batch, so ``wo`` is gathered whole, FSDP's gather of a
    weight, and its gradient, a partial sum over those dims, is
    reduce-scattered back), and the projected rows are gathered over
    ``model`` and put back in sequence order, whole over ``model`` as
    :func:`_shard_act` holds the residual stream.  That moves ``wo``
    (``H hd x D``, a few MB) and one (B, S, D) gather of the rank's rows.
    Gathering the attention output instead moves (B, S, H hd), as large,
    and then the product with ``wo``'s ``model``-split rows leaves a
    partial sum over ``model`` whose all-reduce moves the (B, S, D) rows
    again: so ``wo`` is gathered.

    The backward is the op's VJP on the chunks: q's gradient is nonzero
    only on the rank's chunks and k's and v's cover the keys its chunks
    read, so all three are partial sums over ``model``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    b, s = q.shape[:2]
    ways = mesh.size(dim)
    rows = [i != dim and p == Shard(0) and b > 1
            for i, p in enumerate(q.placements)]
    p_in = tuple(Shard(0) if r else Replicate() for r in rows)
    g_in = tuple(Partial() if i == dim else p for i, p in enumerate(p_in))
    # the rank's chunks side by side: read as a split of the sequence in
    # rank order, which the gather below keeps and _unzigzag undoes
    p_out = tuple(Shard(1) if i == dim else p for i, p in enumerate(p_in))
    chunks = _zigzag(s, ways, mesh.get_local_rank(dim), window)

    def attend(q_, k_, v_):
        # narrow, not slices: see _flash_attend
        outs = []
        for q0, q1, k0 in chunks:
            o = attn_mod.flash_attention(
                q_.narrow(1, q0, q1 - q0), k_.narrow(1, k0, q1 - k0),
                v_.narrow(1, k0, q1 - k0), causal=True, window=window,
                q_offset=q0 - k0)
            outs.append(o.reshape(o.shape[0], q1 - q0, -1))
        return torch.cat(outs, 1)
    o = local_map(attend, out_placements=(p_out,),
                  in_placements=(p_in, p_in, p_in),
                  in_grad_placements=(g_in, g_in, g_in),
                  device_mesh=mesh, redistribute_inputs=True)(q, k, v)
    y = ctx.product(o, wo).redistribute(mesh, p_in)
    return local_map(functools.partial(_unzigzag, ways=ways),
                     out_placements=(p_in,), in_placements=(p_in,),
                     device_mesh=mesh)(y)


def _attention_out(blk, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cfg: ModelConfig, window: int) -> torch.Tensor:
    """Causal attention of q (B, S, H, hd) over k, v and its output
    projection ``wo``: (B, S, D)."""
    if not cfg.use_flash:
        o = attn_mod.dense_attention(q, k, v, causal=True, window=window)
    else:
        dim = _zigzag_split(q, k.shape[2])
        if dim is not None:
            return _zigzag_attend(q, k, v, window, blk["wo"], dim)
        o = _flash_attend(q, k, v, window)
    # per shard, as q, k and v (``ctx.product``): DTensor plans neither
    # the product nor its backward
    return ctx.product(ctx.merge_last(o), blk["wo"])


def _attn_mlp_block(blk, x: torch.Tensor, cfg: ModelConfig, window: int,
                    positions: torch.Tensor):
    """(x after the block, its aux loss or None, (k, v))."""
    # where q's heads cannot split over model, attention takes q, k and v
    # whole over it (the zig-zag chunks): so the projections leave them so
    whole = cfg.use_flash and ctx.is_dtensor(x) and \
        _head_split_of(x, cfg.n_heads, cfg.n_kv_heads) is None
    q, k, v = _qkv(blk, x, cfg, positions, "R" if whole else "N")
    x = _shard_act(x + _attention_out(blk, q, k, v, cfg, window))
    m, aux = _mlp(blk, x, cfg)
    return _shard_act(x + m), aux, (k, v)


def _mamba_layer(layer, x: torch.Tensor, cfg: ModelConfig,
                 return_state=False):
    hn = rms_norm(x, layer["ln"], cfg.norm_eps)
    if return_state:
        out, st = ssm_mod.mamba_block(layer, hn, cfg, return_state=True)
        return _shard_act(x + out), st
    return _shard_act(x + ssm_mod.mamba_block(layer, hn, cfg))


def _embed(params: LMParams, cfg: ModelConfig,
           tokens: torch.Tensor) -> torch.Tensor:
    emb = params["embed"]
    # sqrt(d_model) rounded to the parameter dtype, as the reference rounds
    # it, and handed over as a Python number (a device scalar made from the
    # host would make the host wait for the device)
    scale = torch.tensor(math.sqrt(cfg.d_model), dtype=emb.dtype).item()
    return _lookup(emb, tokens) * scale


def _lookup_plan(emb: torch.Tensor, tokens: torch.Tensor) -> Tuple:
    """Which of the mesh dims that split the (V, D) table ``emb`` keep it
    split in :func:`_lookup` (the others gather it), by the bytes a rank
    receives: (the kept vocab dims, the kept D dims).  The lookup is the
    product of the tokens' one-hot rows with the table, priced by
    ``ctx.product_cost`` as every per-shard product is, with the tokens'
    ids free to move (``x_width`` 0); its plans are its own (a split of
    the table kept or gathered, at least one vocab split kept), chosen
    by bytes alone, since the work a rank repeats is a gather of rows,
    and a tie goes to the plan that keeps fewer splits.

    A dim that gathers the table receives ``(n - 1) / n`` of the gathered
    slice, ``V_f x D_f`` (the rows and columns that the kept dims leave a
    rank); FSDP gathers a weight so.  A dim that keeps it gathers the
    tokens that it splits instead (a few bytes each) and moves the
    looked-up rows, ``T_f x D_f`` (``T_f`` the rank's tokens times the
    kept dims that split them): ``(n - 1) / n`` of them by a
    reduce-scatter of the vocab shards' partial sums or an all-to-all
    that gives the D slices back to the tokens' ranks, where the dim
    splits the tokens; where it does not, an all-reduce (twice that) or
    an all-gather of the D slices (``n - 1`` times).  So the rule for D's
    split over ``data`` reads: gather the table slice, ``V / model x D``,
    where it moves fewer bytes than the data group's tokens' rows, ``T x
    D / data`` for each of its ``data`` ranks: in decode the tokens are
    few and the slice stays split; in a 32k prefill the slice is gathered.
    At least one vocab dim keeps its split, so no rank ever holds the
    whole table or its gradient.  Where one tensor dim is split over
    several mesh dims (the ``dp`` profile's vocab over (data, model)),
    only an inner run of them is gathered (one all-gather each; an outer
    one would gather through the inner ones).  Where other mesh dims
    split the same token dim as a dim that keeps D split (``n_o`` ranks
    of them), DTensor's all-to-all of the D slices back to their tokens
    first gathers ``n_o`` squared times the dim's rows (the ``dp``
    profile's batch over (data, model), where a vocab that does not
    divide the mesh leaves D split: granite's 49155 gathered (4096, 4096,
    96), 16 times the global batch's rows), so they are priced so: in
    training the table slice is gathered instead; in decode, the 2-pod
    mesh's few tokens over (pod, data), the slice stays split."""
    from torch.distributed.tensor import Shard
    mesh = emb.device_mesh
    place = tokens.placements
    plan = _plan_lookup(
        tuple(mesh.size(i) for i in range(mesh.ndim)),
        tuple("T" if isinstance(p, Shard) else "R" for p in place),
        tuple({Shard(0): "K", Shard(1): "N"}.get(p, "R")
              for p in emb.placements),
        tuple(p.dim if isinstance(p, Shard) else None for p in place),
        tokens.numel(), emb.shape[0], emb.shape[1])
    return ([i for i, c in enumerate(plan) if c == ctx.KEEP_K],
            [i for i, c in enumerate(plan) if c == ctx.KEEP_N])


@functools.lru_cache(maxsize=256)
def _plan_lookup(sizes, xk, wk, xd, t: int, v: int, d: int):
    """:func:`_lookup_plan`'s choice on each mesh dim (``ctx``'s kinds:
    x the tokens, w the (V, D) table)."""
    vocab = [i for i, kind in enumerate(wk) if kind == "K"]
    best = None
    for plan in itertools.product((ctx.GATHER, ctx.KEEP_K, ctx.KEEP_N),
                                  repeat=len(sizes)):
        if vocab and plan[vocab[0]] != ctx.KEEP_K or any(
                c != ctx.GATHER and kind == "R"
                for c, kind in zip(plan, wk)):
            continue
        priced = ctx.product_cost(plan, sizes, xk, wk, xd, t, v, d,
                                  x_width=0.0)
        if priced is None:
            continue
        key = (priced[0], plan.count(ctx.KEEP_K), plan.count(ctx.KEEP_N))
        if best is None or key < best[0]:
            best = (key, plan)
    return best[1]


def _lookup(emb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``emb[tokens]``.  On a mesh each rank looks tokens up only in its
    own shard of the table, placed as :func:`_lookup_plan` keeps it: on a
    dim that keeps the vocab split, every token of the dim's group in the
    rank's vocab rows, those outside them giving 0 (as ``layers.
    _label_logits`` gathers the labels), so the rows are a partial sum
    over the vocab shards; on a dim that keeps D split, the group's
    tokens in the rank's D columns.  The rows are then reduced to the
    tokens' own placement (the activation's).  Where such a dim splits
    the tokens, the rank gathers its group's tokens and reduce-scatters
    the rows itself (inner mesh dims gathered first, outer ones scattered
    first), so each rank gets back its own rows: where the tokens split
    over several mesh dims (the ``dp`` profile's batch over (data,
    model)), DTensor's reduction of a partial sum over an outer dim
    beside an inner split gathers the global batch's rows first.  The
    table's gradient stays on the rank's shard: complete over the kept
    dims, whose ranks saw every token of the group, and a partial sum
    over the other dims that split the tokens, reduced back to the
    parameter's placement."""
    if not ctx.is_dtensor(emb):
        return emb[tokens.to(torch.long)]
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import local_map
    mesh = emb.device_mesh
    keep_v, keep_d = _lookup_plan(emb, tokens)
    p_tok = tuple(tokens.placements)
    p_emb, p_in, p_out, g_emb, own = [], [], [], [], []
    for i, p in enumerate(p_tok):
        split = isinstance(p, Shard)
        kept = Shard(0) if i in keep_v else Shard(1) if i in keep_d else None
        p_emb.append(kept or Replicate())
        g_emb.append(kept or (Partial() if split else Replicate()))
        if i in keep_v and split:
            # the body gathers the group's tokens, scatters the rows back
            own.append((i, p.dim))
            p_in.append(p)
            p_out.append(p)
        elif kept:
            p_in.append(Replicate())
            p_out.append(Partial() if i in keep_v else Shard(2))
        else:
            p_in.append(p)
            p_out.append(p)
    local, offset = compute_local_shape_and_global_offset(
        tuple(emb.shape), mesh, tuple(p_emb))
    first, rows = int(offset[0]), int(local[0])

    def look(e, t):
        for i, dim in reversed(own):
            t = funcol.all_gather_tensor(t, dim, (mesh, i))
        idx = t.to(torch.long) - first
        mine = (idx >= 0) & (idx < rows)
        got = e[idx.clamp(0, rows - 1)]
        got = torch.where(mine[..., None], got, torch.zeros_like(got))
        for i, dim in own:
            got = funcol.reduce_scatter_tensor_autograd(
                got, "sum", dim, (mesh, i))
        return got
    out = local_map(look, out_placements=(tuple(p_out),),
                    in_placements=(tuple(p_emb), tuple(p_in)),
                    in_grad_placements=(tuple(g_emb), tuple(p_in)),
                    device_mesh=mesh, redistribute_inputs=True)(emb, tokens)
    return out.redistribute(mesh, p_tok)


def _embed_inputs(params: LMParams, cfg: ModelConfig, tokens: torch.Tensor,
                  prefix_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """Token embeddings, after the projected ``prefix_embeds`` (B, P,
    frontend_dim) where the config has a frontend and a prefix is given."""
    x = _embed(params, cfg, tokens)
    if cfg.frontend and prefix_embeds is not None:
        pre = prefix_embeds.to(x.device, _dtype(cfg)) \
            @ params["frontend_proj"]
        x = torch.cat([pre, x], dim=1)
    return _shard_act(x)


def _head(params: LMParams, cfg: ModelConfig) -> torch.Tensor:
    """The (D, V) output projection: ``embed``'s transpose where tied."""
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """``x @ head``, x (B, S, D) and the (D, V) output projection.  On a
    mesh the product runs per shard (``ctx.product``), planned by the
    bytes a rank receives, every placement given, so that no rank
    gathers activations or logits of sequences that are not its own, and
    the logits are left as the product leaves them (split over the
    vocab, or a partial sum over a split of D).  On each mesh dim:

      * that splits x's tokens (its batch, or its sequence): where the
        tokens are many (training, whose logits feed the loss), the head
        is gathered over it, as FSDP gathers a weight, and its gradient
        reduced back to its placement (a reduce-scatter of the table's
        split under ``dp``, whose vocab splits over the same dims as the
        batch); where they are few (decode, a prefill's last position),
        the head keeps its split of D and the tokens move to it: an
        all-to-all of the group's few rows, and a reduce-scatter of the
        rank's vocab slice of their logits back to the tokens' ranks;
      * that leaves x's tokens whole: the head's vocab split is kept, or,
        where the vocab does not divide the dim (50280, 92553 on
        ``model=16``) and the head is whole there, cut with
        ``torch.chunk``'s sizes, and the logits stay split over the
        vocab (no rank of the dim runs the whole head, and none gathers
        it); where x's D is split (one decode slot under ``2d``), the
        head's D splits alike and the logits are a partial sum over it.

    Left to DTensor, the product's plan gathered the activations of the
    dims that split the vocab and the batch alike (``dp``) and made a
    vocab-wide logits block of many sequences on every rank."""
    return ctx.product(x, head, out="P")


def _positions(s: int, device) -> torch.Tensor:
    """The positions ``0 .. s-1`` of a forward's or a prefill's rows, (1,
    s): every row has the same, so they carry no batch dim, and the
    rotary tables (``layers.apply_rope``) broadcast over the batch.  On a
    mesh they are a plain tensor that implicit replication hands to
    DTensor whole, and each op cuts them to the rank's own rows: a
    sequence split over a mesh dim takes its range of them, and the
    zig-zag prefill's query chunks, cut from q after the rotary
    embedding, theirs.  Where they held the batch, ``(B, S)`` made every
    rank build the angles, cos and sin of the global batch (gemma3's 32
    x 32768 x 128 fp32, 1.5 of its 1.94 GiB prefill peak) before cutting
    its rows; a DTensor placed as the activation's tokens would cut
    them, but a (1, s) table is already no larger than one row."""
    return torch.arange(s, device=device)[None, :]


def _layer_groups(params: LMParams, cfg: ModelConfig):
    """Hybrid: (group index, its ``attn_every`` (index, layer) pairs)."""
    n = cfg.attn_every
    for g in range(_n_groups(cfg)):
        yield g, [(i, params.layers[i]) for i in range(g * n, (g + 1) * n)]


#: the matmuls ``remat_policy="dots"`` keeps: those without batch dims
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, func, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if func in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn: Callable, cfg: ModelConfig, policy: bool = True) -> Callable:
    """``fn`` under the configured activation checkpointing (the
    reference's ``_remat``; ``policy=False`` is its plain
    ``jax.checkpoint``, which the hybrid's inner layers get)."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    kwargs: Dict[str, Any] = {"use_reentrant": False}
    if policy and cfg.remat_policy == "dots":
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return lambda *args: checkpoint(fn, *args, **kwargs)


def forward(params: LMParams, cfg: ModelConfig, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits over the token positions (B, S, V), the
    aux loss: the MoE layers' load-balancing terms summed, else 0)."""
    _check_family(cfg)
    x = _embed_inputs(params, cfg, tokens, prefix_embeds)
    positions = _positions(x.shape[1], x.device)
    auxs = []
    if cfg.family == "ssm":
        body = _remat(lambda layer, h: _mamba_layer(layer, h, cfg), cfg)
        for layer in params.layers:
            x = body(layer, x)
    elif cfg.family == "hybrid":
        inner = _remat(lambda layer, h: _mamba_layer(layer, h, cfg), cfg,
                       policy=False)

        def group_body(layers, h):
            for layer in layers:
                h = inner(layer, h)
            h, aux, _ = _attn_mlp_block(params.shared, h, cfg, 0, positions)
            return h, aux
        group_body = _remat(group_body, cfg)
        for _, group in _layer_groups(params, cfg):
            x, aux = group_body([layer for _, layer in group], x)
            auxs.append(aux)
    else:
        def body(layer, h, window):
            h, aux, _ = _attn_mlp_block(layer, h, cfg, window, positions)
            return h, aux
        body = _remat(body, cfg)
        for layer, window in zip(params.layers, layer_windows(cfg)):
            x, aux = body(layer, x, int(window))
            auxs.append(aux)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.frontend and prefix_embeds is not None:
        x = x[:, prefix_embeds.shape[1]:]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for aux in auxs:
        if aux is not None:
            aux_total = aux_total + aux
    logits = ctx.constrain(_logits(x, _head(params, cfg)), "batch", None,
                           "model")
    return logits, aux_total


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
                      device=None, make: Optional[Callable] = None
                      ) -> Dict[str, Any]:
    """Per-slot positions (``index``) and, per family, the Mamba2 states
    stacked by layer, ``ssm_layers`` (L, B, ...), and the KV caches
    (n, B, max_seq, KV, hd), n one a layer or, for hybrid, one a group.
    The reference stacks hybrid states (n_groups, attn_every, B, ...);
    here they are one a layer, so every state has the batch on axis 1.
    Each leaf is ``make(shape, dtype)``, zeros on ``device`` by default
    (prefill on a mesh makes each rank's shard of them instead)."""
    _check_family(cfg)
    if make is None:
        dev = torch_device(device)

        def make(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)
    dtype = _dtype(cfg)
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    state: Dict[str, Any] = {"index": make((batch,), torch.int32)}
    if cfg.family in ("ssm", "hybrid"):
        state["ssm_layers"] = {
            k: make((cfg.n_layers,) + shape, dt) for k, (shape, dt) in
            ssm_mod.mamba_state_shapes(cfg, batch, dtype).items()}
    if cfg.family != "ssm":
        n = _n_groups(cfg) if cfg.family == "hybrid" else cfg.n_layers
        shape = (n, batch, max_seq, kv, hd)
        state["k"] = make(shape, dtype)
        state["v"] = make(shape, dtype)
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
    positions = _positions(s, x.device)
    mesh = ctx.current_mesh()
    if mesh is None:
        state = init_decode_state(cfg, b, max_seq, device=x.device)
        state["index"].fill_(s)
    else:
        # each rank makes only its shard of the caches, placed by
        # cache_specs (the whole state is a global KV cache): the layout
        # is shapes and dtypes, no tensor
        from types import SimpleNamespace
        from repro_torch.parallel import sharding
        like = init_decode_state(cfg, b, max_seq, make=lambda shape, dtype:
                                 SimpleNamespace(shape=shape, dtype=dtype))
        state = sharding.distribute(like, sharding.tree_shardings(
            sharding.cache_specs(like, mesh, b, cfg), mesh),
            put=lambda t, sh: sharding.shard_of(
                t, sh, x.device, fill=s if t is like["index"] else 0))

    def mamba(i, layer, x):
        x, st = _mamba_layer(layer, x, cfg, return_state=True)
        for key, val in st.items():
            _write_layer(state["ssm_layers"][key], i, val)
        return x

    def attend(i, blk, x, window):
        x, _, (k, v) = _attn_mlp_block(blk, x, cfg, window, positions)
        _write_prefix(state["k"][i], k)
        _write_prefix(state["v"][i], v)
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
    return _logits(x, _head(params, cfg)), state


def _write_layer(stack: torch.Tensor, i: int, val: torch.Tensor) -> None:
    """``stack[i] = val`` in place, a decode state's layer: on a mesh
    ``val`` (a partial sum over ``model``, as ``ssm._mamba_heads`` leaves
    the Mamba2 states) reduced to the placement of the stack's layer
    first (a reduce-scatter into the cache's split), which DTensor's
    in-place copy would otherwise choose."""
    if ctx.is_dtensor(val) and ctx.is_dtensor(stack):
        from torch.distributed.tensor import Shard
        pl = stack.placements
        if not any(p == Shard(0) for p in pl):
            val = val.redistribute(stack.device_mesh, [
                Shard(p.dim - 1) if isinstance(p, Shard) else p for p in pl])
    stack[i] = val


def _cache_shards(cache: torch.Tensor):
    """A (B, S, KV, hd) cache DTensor's local shard and how to place what
    is written into it: (local cache, this rank's first position, the
    placements of a (B, ..., KV, hd) write split as the cache's batch and
    KV heads are and whole on the mesh dims that split the sequence)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    pc = tuple(cache.placements)
    _, offset = compute_local_shape_and_global_offset(
        tuple(cache.shape), cache.device_mesh, pc)
    keep = [p if isinstance(p, Shard) and p.dim != 1 else Replicate()
            for p in pc]
    return cache.to_local(), int(offset[1]), keep


def _write_prefix(cache: torch.Tensor, new: torch.Tensor) -> None:
    """``cache[:, :s] = new`` in place: cache (B, S, KV, hd), new (B, s,
    KV, hd).  On a mesh each rank writes the positions of its own shard
    (its slots and KV heads, and, where the sequence is split, its range
    of it)."""
    s = new.shape[1]
    if not ctx.is_dtensor(cache):
        cache[:, :s] = new
        return
    local, first, keep = _cache_shards(cache)
    new = new.redistribute(cache.device_mesh, keep).to_local()
    lo, hi = first, min(first + local.shape[1], s)
    if hi > lo:
        local[:, :hi - lo] = new[:, lo:hi]


def _write_slots(cache: torch.Tensor, at: torch.Tensor,
                 new: torch.Tensor) -> None:
    """``cache[b, at[b]] = new[b]`` for every slot b, in place: cache (B,
    S, KV, hd), at (B,), new (B, KV, hd).  On a mesh (DTensor has no
    in-place strategy for the scatter) each rank writes its own shard: its
    slots and KV heads, and where the sequence is split over the mesh,
    only the slots whose position falls in its range of it."""
    if not ctx.is_dtensor(cache):
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, at] = new
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache.device_mesh
    local, first, keep = _cache_shards(cache)
    # the cache's dims (B, S, KV, hd) as new's (B, KV, hd) and at's (B,)
    p_new = [Shard({0: 0, 2: 1, 3: 2}[p.dim]) if isinstance(p, Shard)
             else Replicate() for p in keep]
    p_at = [p if p == Shard(0) else Replicate() for p in p_new]
    at = at.redistribute(mesh, p_at).to_local() - first
    new = new.redistribute(mesh, p_new).to_local()
    mine = (at >= 0) & (at < local.shape[1])
    at = at.clamp(0, local.shape[1] - 1)
    rows = torch.arange(local.shape[0], device=local.device)
    local[rows, at] = torch.where(mine[:, None, None], new, local[rows, at])


def _decode_attend(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, index: torch.Tensor,
                   window: int) -> torch.Tensor:
    """``attention.decode_attention`` on the caches.  On a mesh it runs on
    each rank's shard: the slots and KV heads as the cache splits them
    (q's heads split alike, since query head h reads KV head h // rep),
    whole over the mesh dims that split the cache's sequence.  Where
    dims of more than one rank split it, each rank reads only its own
    range of it, ``[first, first + S_l)``, with
    ``attention.decode_attention_split``: its max logit all-reduced
    (max) and its exponentials' sums and products with v all-reduced
    (sum) over exactly those dims (one all-reduce a dim, which every
    rank runs in the same order), as XLA combines softmax partials over
    a split sequence; no rank gathers the cache.  Where nothing splits
    it, the read is the plain one on the rank's shard."""
    if not ctx.is_dtensor(k_cache):
        return attn_mod.decode_attention(q, k_cache, v_cache, index, window)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = k_cache.device_mesh
    _, first, keep = _cache_shards(k_cache)
    p_q = tuple(keep)        # q (B, 1, H, hd): dims 0 and 2 as the cache's
    p_index = tuple(p if p == Shard(0) else Replicate() for p in keep)
    p_cache = tuple(k_cache.placements)
    seq = tuple(i for i, p in enumerate(p_cache)
                if p == Shard(1) and mesh.size(i) > 1)

    def all_reduce(t, op):
        import torch.distributed._functional_collectives as funcol
        for dim in seq:
            t = funcol.all_reduce(t, op, (mesh, dim))
        return t

    def read(q_, k_, v_, i_):
        if not seq:
            return attn_mod.decode_attention(q_, k_, v_, i_, window)
        return attn_mod.decode_attention_split(q_, k_, v_, i_, window,
                                               first, all_reduce)
    return local_map(read, out_placements=(p_q,),
                     in_placements=(p_q, p_cache, p_cache, p_index),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k_cache, v_cache, index)


def _decode_attention_block(blk, x: torch.Tensor, cfg: ModelConfig,
                            window: int, index: torch.Tensor,
                            k_cache: torch.Tensor, v_cache: torch.Tensor):
    """x: (B, 1, D); index: (B,) per-slot positions.  Writes this token's
    k and v into the caches in place.  On a mesh the residual stream is
    held batch-split and whole over ``model`` after the attention and
    after the MLP (:func:`_shard_decode`), as prefill holds it: left to
    DTensor, the attention's output projection leaves it a partial sum
    over ``model``, and each product of the MLP then gathered its whole
    weight, or ran on the data group's whole batch, on every rank."""
    b = x.shape[0]
    q, k, v = _qkv(blk, x, cfg, index[:, None])
    # each slot writes at its own position, clamped into the cache as the
    # reference's dynamic_update_slice clamps (idle slots keep counting)
    at = index.to(torch.long).clamp(max=k_cache.shape[1] - 1)
    _write_slots(k_cache, at, k[:, 0])
    _write_slots(v_cache, at, v[:, 0])
    o = _decode_attend(q, k_cache, v_cache, index, window)
    x = _shard_decode(x + ctx.product(o.reshape(b, 1, -1), blk["wo"]))
    m, _ = _mlp(blk, x, cfg)
    return _shard_decode(x + m)


def _decode_mamba(layer, x: torch.Tensor, cfg: ModelConfig, sts: Dict,
                  i: int) -> torch.Tensor:
    """One token through Mamba2 layer ``i``; its state updated in place
    (the residual held as :func:`_decode_attention_block` holds it)."""
    hn = rms_norm(x, layer["ln"], cfg.norm_eps)
    out, st = ssm_mod.mamba_decode_step(
        layer, hn, {k: v[i] for k, v in sts.items()}, cfg)
    for key, val in st.items():
        sts[key][i] = val
    return _shard_decode(x + out)


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
    return _logits(x, _head(params, cfg)), new_state
