"""The rank program of ``tests/test_torch_sharding.py`` (not a test file):

    python tests/sharding_ranks.py <cases> <rank> <world> <dir>

Each rank joins a gloo group of ``world`` ranks through a ``FileStore``
in ``<dir>`` (no TCP port, so concurrent runs cannot collide), pins one
intra-op thread, and runs every case of the set ``<cases>`` (``mesh8``:
the 4x2 and 2x4 cases on 8 ranks, which also save a sharded checkpoint;
``mesh4``: the elastic restore of that checkpoint on 4 ranks;
``guard``: the 8-rank cases that differ by torch release, the
data-parallel training steps and gradients, which ``chip_smoke.py``
runs on the card's release).  Rank 0 writes ``{case: result}`` to
``<dir>/<cases>.json``, with each case's seconds under ``seconds``; a
case that raises on any rank records its traceback there instead, and
:func:`failures` reads a result file against the tolerances below.
Every case compares against the same computation on plain tensors in
the same process (the port's single-device step, itself held against
the reference's by ``tests/test_torch_train_step.py``).
"""

import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
sys.path.insert(0, str(SRC))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.hlo_analysis import collective_class  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_smoke_mesh  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.config import smoke_config  # noqa: E402
from repro_torch.parallel import ctx, sharding  # noqa: E402
from repro_torch.train import checkpoint  # noqa: E402
from repro_torch.train.optim import adamw  # noqa: E402
from repro_torch.train.train_step import (init_state,  # noqa: E402
                                          make_train_step)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

SEED = 0
#: the reference's tolerances (``tests/test_sharding.py:63-69``): the loss,
#: and every parameter or gradient; logits and caches of a prefill or a
#: decode (sums over split dims in another order)
LOSS_TOL, PARAM_TOL, SERVE_TOL = 1e-4, 2e-4, 1e-4
#: the batch axes of the ``dp`` profile, as the dry run sets them: the
#: batch, and the MoE's dispatch groups, over the whole mesh
DP_AXES = ("pod", "data", "model")


def _batch(cfg, b=8, s=16):
    gen = torch.Generator().manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           dtype=torch.int32)
    return {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}


def _name(p) -> str:
    """A placement as ``Shard(d)``, ``Replicate`` or ``Partial``."""
    return f"Shard({p.dim})" if hasattr(p, "dim") else type(p).__name__


def _full(t):
    return t.full_tensor() if ctx.is_dtensor(t) else t


def _shardings(tree, mesh, profile, cfg):
    return sharding.tree_shardings(
        sharding.param_specs(tree, mesh, profile, cfg=cfg), mesh)


@contextlib.contextmanager
def _axes(seq_axes=(), batch_axes=("pod", "data")):
    """The mesh's sequence and batch axes for the activations, put back
    after."""
    ctx.set_seq_axes(seq_axes)
    ctx.set_batch_axes(batch_axes)
    try:
        yield
    finally:
        ctx.set_seq_axes(())
        ctx.set_batch_axes(("pod", "data"))


def _train_step(cfg, mesh, profile="2d", seq_axes=(), accum=1,
                batch_axes=("pod", "data"), around=contextlib.nullcontext):
    """One AdamW step on plain tensors and the same on ``mesh`` (inside
    ``around()``): (loss gap, the largest parameter gap, the placements
    the state took)."""
    opt = adamw(lr=1e-3)
    batch = _batch(cfg)
    s0 = init_state(cfg, SEED, opt, device="cpu")
    step = make_train_step(cfg, opt, accum_steps=accum)
    s1, m1 = step(s0, batch)
    with ctx.use_mesh(mesh), _axes(seq_axes, batch_axes):
        s0s = sharding.distribute(s0, _shardings(s0, mesh, profile, cfg))
        bs = sharding.distribute(batch, sharding.tree_shardings(
            sharding.batch_specs(batch, mesh, profile=profile), mesh))
        with around():
            s1s, m1s = step(s0s, bs)
    gap = max(float((a.detach() - _full(b).detach()).abs().max())
              for a, b in zip(s1.params.parameters(),
                              s1s.params.parameters()))
    split = sum(any(type(p).__name__ == "Shard" for p in t.placements)
                for t in s1s.params.parameters())
    return {"loss": float(m1["loss"]),
            "loss_gap": abs(float(m1["loss"]) - float(_full(m1s["loss"]))),
            "param_gap": gap, "leaves": len(list(s1.params.parameters())),
            "split_leaves": split}


def case_2d(mesh8):
    return _train_step(smoke_config(get_config("qwen3-0.6b")), mesh8)


def case_dp(mesh8):
    return _train_step(smoke_config(get_config("qwen3-0.6b")), mesh8, "dp")


def case_sp(mesh8):
    return _train_step(smoke_config(get_config("mamba2-130m")), mesh8, "sp",
                       seq_axes=("model",))


def case_accum(mesh8):
    return _train_step(smoke_config(get_config("qwen3-0.6b")), mesh8,
                       accum=2)


def case_gqa(mesh8, mesh24):
    cfg = smoke_config(get_config("qwen3-0.6b"))
    out = _train_step(cfg, mesh24)
    out["heads"], out["kv_heads"] = cfg.n_heads, cfg.n_kv_heads
    return out


def _granite4():
    """Smoke granite-moe with 4 experts, top-2, at lossless capacity."""
    return dataclasses.replace(smoke_config(get_config(
        "granite-moe-3b-a800m")), n_experts=4, top_k=2, capacity_factor=4.0)


class _Groups:
    """Records the dispatch groups of each MoE layer the model runs on a
    mesh."""

    def __init__(self):
        self.groups = []
        self._fn = moe_mod._dispatch_groups

    def __enter__(self):
        def groups(t):
            got = self._fn(t)
            if ctx.current_mesh() is not None:
                self.groups.append(got)
            return got
        moe_mod._dispatch_groups = groups
        return self

    def __exit__(self, *exc):
        moe_mod._dispatch_groups = self._fn


def case_ep(mesh8, mesh24, train=True):
    """:func:`_train_step` of :func:`_granite4` on the 2x4 mesh under
    ``2d`` and the experts' split (not without ``train``), and every
    parameter's gradient gap with the dispatch groups the layers took."""
    cfg = _granite4()
    out = {}
    if train:
        out = _train_step(cfg, mesh24)
        p = tfm.init_params(cfg, SEED, device="cpu")
        spec = _shardings(p, mesh24, "2d", cfg)["layers.0.w_gate"]
        out["expert_split"] = [_name(x) for x in spec.placements]
    with _Groups() as rec:
        out["grads"] = _grad_gaps(cfg, mesh24)
    out["grads"]["groups"] = rec.groups
    return out


def case_ep_dp(mesh24):
    """Every parameter's gradient gap of :func:`_granite4` on the 2x4 mesh
    under ``dp`` with the batch over the whole mesh (the dry run's
    axes), where the dispatch groups span both mesh dims."""
    with _Groups() as rec:
        out = _grad_gaps(_granite4(), mesh24, "dp", batch_axes=DP_AXES)
    out["groups"] = rec.groups
    return out


class _Collectives(TorchDispatchMode):
    """Records the class and output shape of every collective that the
    ranks' ops issue.  An op on DTensors is handed back (NotImplemented),
    so that DTensor runs it, and the local ops and collectives it issues
    come through the mode."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        cls = collective_class(func)
        if cls:
            first = out[0] if isinstance(out, (list, tuple)) else out
            self.seen.append((cls, list(getattr(first, "shape", ()))))
        return out


def _crossing(seen, rank_rows: int, batch: int, vocab: int) -> list:
    """The collectives of ``seen`` that give a rank a vocab-wide block
    (logits) of more sequences than its own ``rank_rows``, or the global
    ``batch``'s activations (3 dims or more, led by the batch)."""
    return [c for c in seen if len(c[1]) >= 3 and (
        c[1][0] >= batch or c[1][0] > rank_rows and c[1][-1] == vocab)]


def case_tied_dp(mesh8):
    """Smoke gemma3 (the output projection tied to the embedding table)
    under ``dp`` on the 4x2 mesh, the batch and the table's vocab both
    split over the whole mesh: the logits and every gradient, the table's
    among them, against plain tensors, and the collectives' outputs."""
    cfg = smoke_config(get_config("gemma3-1b"))
    rec = _Collectives()
    out = _grad_gaps(cfg, mesh8, "dp", batch_axes=DP_AXES,
                     around=lambda: rec)
    out["crossing"] = _crossing(rec.seen, 1, 8, cfg.vocab_size)
    out["collectives"] = len(rec.seen)
    out["tied"] = cfg.tie_embeddings
    return out


class _SsdCalls:
    """Records each SSD op call the Mamba2 block makes, as (on DTensors,
    the batch it ran on)."""

    def __init__(self):
        self.calls = []
        self._op = ssm_mod.ssd_k.ssd

    def __enter__(self):
        def op(x, *args, **kwargs):
            self.calls.append((ctx.is_dtensor(x), x.shape[0]))
            return self._op(x, *args, **kwargs)
        ssm_mod.ssd_k.ssd = op
        return self

    def __exit__(self, *exc):
        ssm_mod.ssd_k.ssd = self._op


def case_zamba2_dp(mesh8):
    """A training step of smoke zamba2 under ``dp`` on the 4x2 mesh, the
    batch over the whole mesh (one sequence a rank), against plain
    tensors: the SSD op's calls on the mesh, and the all-reduces of a
    whole Mamba2 projection's gradient (its shape)."""
    cfg = smoke_config(get_config("zamba2-2.7b"))
    rec = {}

    @contextlib.contextmanager
    def spies():
        with _SsdCalls() as calls, _Collectives() as coll:
            rec["ssd"], rec["coll"] = calls, coll
            yield
    out = _train_step(cfg, mesh8, "dp", batch_axes=DP_AXES, around=spies)
    p = tfm.init_params(cfg, SEED, device="cpu")
    whole = [list(p.layers[0][k].shape) for k in ("in_proj", "out_proj")]
    out["ssd_calls"] = rec["ssd"].calls
    out["whole_reduced"] = [c for c in rec["coll"].seen
                            if c[0] == "all-reduce" and c[1] in whole]
    out["crossing"] = _crossing(rec["coll"].seen, 1, 8, cfg.vocab_size)
    return out


def _weight_shapes(cfg, names) -> list:
    """The shapes of the parameters ``names`` of a layer of ``cfg``'s
    model (its first layer's, or the shared block's)."""
    p = tfm.init_params(cfg, SEED, device="cpu")
    blk = p.layers[0] if names[0] in p.layers[0] else p.shared
    return [list(blk[k].shape) for k in names]


def case_dp_kv(mesh24):
    """A ``dp`` training step's gradients of smoke qwen3 whose 2 KV heads
    do not divide ``model=4`` (4 query heads), on the 2x4 mesh with the
    batch over the whole mesh (the dry run's axes), against plain
    tensors, and the all-reduces of a whole attention projection's
    gradient (its shape): each is gathered per shard for the microbatch
    (``ctx.product``) and its gradient reduce-scattered back."""
    cfg = smoke_config(get_config("qwen3-0.6b"))
    rec = _Collectives()
    out = _grad_gaps(cfg, mesh24, "dp", batch_axes=DP_AXES,
                     around=lambda: rec)
    whole = _weight_shapes(cfg, ("wq", "wk", "wv", "wo"))
    out["whole_reduced"] = [c for c in rec.seen
                            if c[0] == "all-reduce" and c[1] in whole]
    out["kv_heads"] = cfg.n_kv_heads
    return out


class _Plans:
    """Records each per-shard product's plan (``ctx.product_plan``):
    (w's output width, the plan, whether it repeats the product on a
    mesh dim of more than one rank whose x holds the same tokens, and
    whether it cuts a whole w's N unevenly there)."""

    def __init__(self):
        self.plans = []
        self._plan = ctx.product_plan

    def __enter__(self):
        def plan(x, w, lead=0, out="R"):
            got = self._plan(x, w, lead, out)
            mesh, last = x.device_mesh, x.ndim - 1
            kinds = [ctx._kind(p, lead, last) for p in x.placements]
            live = [mesh.size(i) > 1 for i in range(mesh.ndim)]
            repeats = any(live[i] and c == ctx.GATHER and kinds[i] != "T"
                          for i, c in enumerate(got))
            uneven = any(live[i] and c == ctx.KEEP_N and
                         w.shape[-1] % mesh.size(i) != 0
                         for i, c in enumerate(got))
            self.plans.append((int(w.shape[-1]), list(got), repeats,
                               uneven))
            return got
        ctx.product_plan = plan
        return self

    def __exit__(self, *exc):
        ctx.product_plan = self._plan


def _serve_gaps(cfg, mesh, b=4, prompt=12, ticks=3, max_seq=16,
                index=None):
    """A prefill of ``prompt`` tokens and ``ticks`` decode ticks of ``b``
    slots with the parameters on ``mesh`` (``2d``) and the cache placed by
    ``cache_specs``, against plain tensors: the largest logit and cache
    gaps, and the placements the KV cache took.  ``index`` (one position
    a slot) sets the slots' lengths after the prefill, as a continuous
    batch holds slots of different lengths."""
    p = tfm.init_params(cfg, SEED, device="cpu")
    batch = _batch(cfg, b, prompt)["tokens"]
    steps = _batch(cfg, b, ticks)["tokens"]

    def serve(params, place):
        logits, st = tfm.prefill(params, cfg, place(batch), max_seq)
        if index is not None:
            st["index"] = _like(torch.tensor(index, dtype=torch.int32),
                                st["index"])
        outs = [logits]
        for i in range(steps.shape[1]):
            logits, st = tfm.decode_step(params, cfg,
                                         place(steps[:, i:i + 1]), st)
            outs.append(logits)
        return outs, st
    with torch.no_grad():
        want, st0 = serve(p, lambda t: t)
        with ctx.use_mesh(mesh):
            ps = sharding.distribute(p, _shardings(p, mesh, "2d", cfg))

            def place(t):
                specs = sharding.batch_specs({"t": t}, mesh)
                return sharding.distribute(
                    {"t": t}, sharding.tree_shardings(specs, mesh))["t"]
            with _Plans() as spy:
                got, st = serve(ps, place)
    out = {"logit_gap": max(float((a - _full(b_)).abs().max())
                            for a, b_ in zip(want, got))}
    if "k" in st0:
        out.update(
            k_gap=float((st0["k"] - _full(st["k"])).abs().max()),
            v_gap=float((st0["v"] - _full(st["v"])).abs().max()),
            k_placements=[_name(x) for x in st["k"].placements])
    if "ssm_layers" in st0:
        out["state_gap"] = max(
            float((t - _full(st["ssm_layers"][key])).abs().max())
            for key, t in st0["ssm_layers"].items())
    out["repeated"] = sorted({n for n, _, rep, _ in spy.plans if rep})
    out["uneven"] = sorted({n for n, _, _, cut in spy.plans if cut})
    return out


def _like(t, ref):
    """``t`` placed as the DTensor ``ref`` is (``t`` itself off a mesh)."""
    if not ctx.is_dtensor(ref):
        return t
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, ref.device_mesh, ref.placements)


class _OpCalls:
    """Records each flash-op call the model makes, as (on DTensors, query
    heads, KV heads): a call on plain tensors is one on a rank's shard."""

    def __init__(self):
        self.calls = []
        self.offsets = []
        self._op = tfm.attn_mod.flash_attention

    def __enter__(self):
        def op(q, k, v, **kwargs):
            self.calls.append((ctx.is_dtensor(q), q.shape[2], k.shape[2]))
            self.offsets.append((q.shape[1], k.shape[1],
                                 kwargs.get("q_offset", 0)))
            return self._op(q, k, v, **kwargs)
        tfm.attn_mod.flash_attention = op
        return self

    def __exit__(self, *exc):
        tfm.attn_mod.flash_attention = self._op


def _prefill_heads(cfg, mesh, b=2, prompt=16):
    """A prefill of ``b`` x ``prompt`` tokens with the parameters on
    ``mesh`` against plain tensors: the largest logit gap, and the flash
    op's calls on the mesh."""
    p = tfm.init_params(cfg, SEED, device="cpu")
    tokens = _batch(cfg, b, prompt)["tokens"]
    with torch.no_grad():
        want, _ = tfm.prefill(p, cfg, tokens, prompt)
        with ctx.use_mesh(mesh):
            ps = sharding.distribute(p, _shardings(p, mesh, "2d", cfg))
            ts = sharding.distribute({"t": tokens}, sharding.tree_shardings(
                sharding.batch_specs({"t": tokens}, mesh), mesh))["t"]
            with _OpCalls() as rec:
                got, _ = tfm.prefill(ps, cfg, ts, prompt)
    return {"logit_gap": float((want - _full(got)).abs().max()),
            "calls": rec.calls}


def case_prefill_heads(mesh8, mesh24):
    """Smoke qwen3 (4 heads, 2 KV heads) prefill with its query heads
    split over ``model``: 2 a rank on the 4x2 mesh, reading their own KV
    head's shard, and 1 a rank on the 2x4 mesh, reading a slice of the
    gathered KV heads (2 ranks a KV head)."""
    cfg = smoke_config(get_config("qwen3-0.6b"))
    return {"4x2": _prefill_heads(cfg, mesh8, b=8),
            "2x4": _prefill_heads(cfg, mesh24)}


def case_grads_heads(mesh24):
    """The gradients of every layer's ``wq``, ``wk`` and ``wv`` from smoke
    qwen3's loss on the 2x4 mesh (query heads split one a ``model`` rank,
    k and v gathered, so each KV head's gradient sums over the two ranks
    that read it) against plain tensors."""
    cfg = smoke_config(get_config("qwen3-0.6b"))
    batch = _batch(cfg)
    params = init_state(cfg, SEED, adamw(), device="cpu").params
    names = [n for n, _ in params.named_parameters()
             if n.rsplit(".", 1)[-1] in ("wq", "wk", "wv")]

    def grads(ps, b):
        loss, _ = tfm.loss_fn(ps, cfg, b)
        named = dict(ps.named_parameters())
        return torch.autograd.grad(loss, [named[n] for n in names])
    want = grads(params, batch)
    with ctx.use_mesh(mesh24):
        ps = sharding.distribute(params, _shardings(params, mesh24, "2d",
                                                    cfg))
        bs = sharding.distribute(batch, sharding.tree_shardings(
            sharding.batch_specs(batch, mesh24), mesh24))
        with _OpCalls() as rec:
            got = grads(ps, bs)
    return {"grad_gap": {n: float((a - _full(g)).abs().max())
                         for n, a, g in zip(names, want, got)},
            "grad_scale": max(float(a.abs().max()) for a in want),
            "calls": rec.calls}


def _grad_gaps(cfg, mesh, profile="2d", seq_axes=(),
               batch_axes=("pod", "data"), around=contextlib.nullcontext,
               b=8):
    """Every parameter's gradient of ``cfg``'s loss on ``b`` x 16 tokens
    with the parameters and the batch on ``mesh`` (``profile``) against
    plain tensors (the mesh's forward and backward inside ``around()``):
    the largest gap by name, the largest gradient, the flash op's calls
    and the logits' gap."""
    batch = _batch(cfg, b)
    params = init_state(cfg, SEED, adamw(), device="cpu").params

    def grads(ps, b):
        logits, _ = tfm.forward(ps, cfg, b["tokens"])
        loss, _ = tfm.loss_fn(ps, cfg, b)
        named = dict(ps.named_parameters())
        return logits, dict(zip(named, torch.autograd.grad(
            loss, list(named.values()))))
    want_logits, want = grads(params, batch)
    with ctx.use_mesh(mesh), _axes(seq_axes, batch_axes):
        ps = sharding.distribute(params, _shardings(params, mesh, profile,
                                                    cfg))
        bs = sharding.distribute(batch, sharding.tree_shardings(
            sharding.batch_specs(batch, mesh, profile=profile), mesh))
        with _OpCalls() as rec, around():
            logits, got = grads(ps, bs)
    return {"grad_gap": {n: float((a - _full(got[n])).abs().max())
                         for n, a in want.items()},
            "grad_scale": max(float(a.abs().max()) for a in want.values()),
            "logit_gap": float((want_logits - _full(logits).detach())
                               .abs().max()),
            "calls": rec.calls, "offsets": rec.offsets}


def _six_heads(window):
    """Smoke qwen3 with 6 query heads over 2 KV heads, which do not divide
    ``model=4``; with a window of 5 on its first layer."""
    cfg = dataclasses.replace(smoke_config(get_config("qwen3-0.6b")),
                              n_heads=6, n_kv_heads=2)
    if window:
        cfg = dataclasses.replace(cfg, sliding_window=window,
                                  global_every=2)
    return cfg


def case_zigzag(mesh24, serve=True):
    """Prefill and training where the heads do not divide ``model``: 6
    query heads over 2 KV heads on the 2x4 mesh, 16 positions split into
    8 chunks of 2, two a ``model`` rank (the zig-zag), with and without a
    window: a 16-token prefill and 2 ticks (logits and both caches; not
    without ``serve``) and the loss's gradients, against plain tensors."""
    out = {}
    for tag, window in (("causal", 0), ("window", 5)):
        cfg = _six_heads(window)
        got = {}
        if serve:
            try:
                with _OpCalls() as rec:
                    got = _serve_gaps(cfg, mesh24, prompt=16, ticks=2,
                                      max_seq=20)
                got["offsets"] = rec.offsets
            except Exception:
                got = {"error": traceback.format_exc()}
        try:
            got["grads"] = _grad_gaps(cfg, mesh24)
        except Exception:
            # recorded on its own: the prefill's results stand beside it
            got["grads"] = {"error": traceback.format_exc()}
        out[tag] = got
    return out


def case_lookup(mesh8, profiles=("2d", "dp", "sp")):
    """The per-shard embedding lookup under ``2d`` and ``dp`` (smoke qwen3
    on the 4x2 mesh) and ``sp`` (smoke mamba2, as ``case_sp`` trains it:
    the sequence over 'model'): logits and every gradient, the table's
    among them, against plain tensors, and the dims that keep the table
    split."""
    out = {}
    for profile, seq, arch in (("2d", (), "qwen3-0.6b"),
                               ("dp", (), "qwen3-0.6b"),
                               ("sp", ("model",), "mamba2-130m")):
        if profile not in profiles:
            continue
        try:
            out[profile] = _lookup_gaps(arch, mesh8, profile, seq)
        except Exception:
            # recorded on its own: the other profiles' results stand
            out[profile] = {"error": traceback.format_exc()}
    return out


def _lookup_gaps(arch, mesh8, profile, seq):
    """:func:`_grad_gaps` of ``arch`` under ``profile``, and the lookup's
    plan and the table's placements."""
    cfg = smoke_config(get_config(arch))
    got = _grad_gaps(cfg, mesh8, profile, seq)
    p = tfm.init_params(cfg, SEED, device="cpu")
    batch = _batch(cfg)
    with ctx.use_mesh(mesh8):
        ctx.set_seq_axes(seq)
        try:
            ps = sharding.distribute(p, _shardings(p, mesh8, profile, cfg))
            bs = sharding.distribute(batch, sharding.tree_shardings(
                sharding.batch_specs(batch, mesh8, profile=profile), mesh8))
            got["plan"] = [list(x) for x in tfm._lookup_plan(
                ps["embed"], bs["tokens"])]
            got["embed"] = [_name(x) for x in ps["embed"].placements]
        finally:
            ctx.set_seq_axes(())
    return got


def case_swiglu(mesh8, mesh24):
    """``layers.swiglu`` per shard on x (8, 16, 64) and weights of F 128
    placed by the ``2d`` rules (x batch-split over 'data', F over
    'model') on both meshes and by ``dp`` (x and the weights over the
    whole mesh) on the 4x2 mesh: its output and the gradients of x and
    the three weights, against plain tensors."""
    from repro_torch.models.layers import swiglu
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn(8, 16, 64, generator=gen)
    w = {"w_gate": torch.randn(64, 128, generator=gen) / 8,
         "w_up": torch.randn(64, 128, generator=gen) / 8,
         "w_down": torch.randn(128, 64, generator=gen) / 12}
    g = torch.randn(8, 16, 64, generator=gen)
    leaves = [x] + list(w.values())

    def run(ts):
        ts = [t.detach().requires_grad_(True) for t in ts]
        y = swiglu(*ts)
        return [y] + list(torch.autograd.grad(y, ts, g if not
                                              ctx.is_dtensor(y) else
                                              _like(g, y)))
    want = run(leaves)
    out = {}
    for tag, mesh, profile in (("2d_4x2", mesh8, "2d"),
                               ("2d_2x4", mesh24, "2d"),
                               ("dp_4x2", mesh8, "dp")):
        with ctx.use_mesh(mesh):
            ws = sharding.distribute(w, sharding.tree_shardings(
                sharding.param_specs(w, mesh, profile), mesh))
            xs = sharding.distribute({"x": x}, sharding.tree_shardings(
                sharding.batch_specs({"x": x}, mesh, profile=profile),
                mesh))["x"]
            got = run([xs] + list(ws.values()))
        out[tag] = {
            "gaps": [float((a - _full(b).detach()).abs().max())
                     for a, b in zip(want, got)],
            "scale": max(float(a.abs().max()) for a in want),
            "placements": [_name(p) for p in ws["w_gate"].placements]}
    return out


#: the decode cases' widths that do not divide ``model=4``: a vocabulary
#: of 250 (63 columns a rank, 61 on the last), smoke Mamba2 at d_model 48
#: (6 SSD heads, ``in_proj`` 230 wide) and smoke internvl2 with an FFN of
#: 126 (so ``ctx.product`` cuts the head, ``in_proj`` and the FFN's F
#: with ``torch.chunk``'s uneven sizes)
UNEVEN = {"mamba2-130m": {"vocab_size": 250, "d_model": 48},
          "internvl2-2b": {"vocab_size": 250, "d_ff": 126}}


def case_decode(mesh8, mesh24):
    """A prefill and 3 decode ticks on the mesh against plain tensors:
    qwen3 and zamba2 (the hybrid's per-layer Mamba2 states) on the 4x2
    mesh, and on the 2x4 mesh smoke Mamba2 and internvl2 at the widths
    of :data:`UNEVEN`, whose head, ``in_proj`` and FFN are split over
    ``model`` unevenly in decode (each rank runs its own columns; none
    runs the whole product)."""
    out = {arch: _serve_gaps(smoke_config(get_config(arch)), mesh8)
           for arch in ("qwen3-0.6b", "zamba2-2.7b")}
    for arch, widths in UNEVEN.items():
        cfg = dataclasses.replace(smoke_config(get_config(arch)), **widths)
        out[f"{arch}/uneven"] = _serve_gaps(cfg, mesh24)
    return out


class _ScanHeads:
    """Records the heads of each SSD op call on a mesh, as (on DTensors,
    heads)."""

    def __init__(self):
        self.calls = []
        self._op = ssm_mod.ssd_k.ssd

    def __enter__(self):
        def op(x, *args, **kwargs):
            if ctx.current_mesh() is not None:
                self.calls.append((ctx.is_dtensor(x), x.shape[1]))
            return self._op(x, *args, **kwargs)
        ssm_mod.ssd_k.ssd = op
        return self

    def __exit__(self, *exc):
        ssm_mod.ssd_k.ssd = self._op


#: the ``2d`` Mamba2 cases' models: smoke Mamba2 at d_model 48 (6 heads,
#: which do not divide ``model=4``: 2 a rank on ranks 0-2, none on rank 3;
#: ``in_proj`` 230 wide, whole over ``model``), and smoke zamba2 (8
#: heads, 2 a rank; ``in_proj`` 296 wide, split over ``model``, so each
#: rank's columns come from the others' shards)
MAMBA_2D = {"mamba2-130m/uneven": ("mamba2-130m", {"d_model": 48,
                                                   "vocab_size": 250}),
            "zamba2-2.7b": ("zamba2-2.7b", {})}


def case_mamba_2d(mesh24, serve=True):
    """The Mamba2 block on each ``model`` rank's range of the heads
    (``ssm._mamba_heads``) on the 2x4 mesh under ``2d``: a prefill and 3
    decode ticks (logits and the decode states; not without ``serve``)
    and every parameter's gradient of the loss, against plain tensors,
    and the heads of each SSD op call on the traced rank (rank 0)."""
    out = {}
    for tag, (arch, widths) in MAMBA_2D.items():
        cfg = dataclasses.replace(smoke_config(get_config(arch)), **widths)
        got = {}
        if serve:
            with _ScanHeads() as rec:
                got = _serve_gaps(cfg, mesh24)
            got["scan_heads"] = rec.calls
        with _ScanHeads() as rec:
            got["grads"] = _grad_gaps(cfg, mesh24)
        got["grads"]["scan_heads"] = rec.calls
        out[tag] = got
    return out


def case_decode_seq(mesh8, mesh24):
    """Decode with the KV cache's sequence split over the mesh, read from
    per-shard softmax partials: smoke qwen3's 2 KV heads on ``model=4``
    (``cache_specs`` splits the sequence over 'model'); one slot on the
    2x4 mesh (the ``long_500k`` rule: the sequence over the whole mesh,
    2 positions a rank) and on the 4x2 mesh (over 'data', the KV heads
    over 'model').  A 12-token prefill and 4 ticks, which write into
    other ranks' ranges.  On the 2x4 mesh also slots of lengths 2, 11, 5
    and 8 (``ragged``), so that some ranks hold no live key of a slot,
    and smoke gemma3 (one KV head, a window of 8 on every other layer)
    with equal and with those lengths, where the window empties ranges
    too."""
    cfg = smoke_config(get_config("qwen3-0.6b"))
    gemma = smoke_config(get_config("gemma3-1b"))
    lengths = [2, 11, 5, 8]
    return {"model": _serve_gaps(cfg, mesh24, ticks=4),
            "whole_mesh": _serve_gaps(cfg, mesh24, b=1, ticks=4),
            "data": _serve_gaps(cfg, mesh8, b=1, ticks=4),
            "ragged": _serve_gaps(cfg, mesh24, ticks=4, index=lengths),
            "window": _serve_gaps(gemma, mesh24, ticks=4),
            "ragged_window": _serve_gaps(gemma, mesh24, ticks=4,
                                         index=lengths)}


class _SliceMoves:
    """Counts the per-shard products whose x reached the weight's kept K
    split by moving only the rank's range (``ctx.take_ranges`` called
    from ``ctx.product``: x's K split over ``model``, w's K kept over
    ``data``, the tokens whole on both)."""

    def __init__(self):
        self.n = 0
        self._take = ctx.take_ranges

    def __enter__(self):
        def take(*args, **kwargs):
            self.n += 1
            return self._take(*args, **kwargs)
        ctx.take_ranges = take
        return self

    def __exit__(self, *exc):
        ctx.take_ranges = self._take


def case_one_slot(mesh8):
    """One slot (``long_500k``'s batch) on the 4x2 mesh, where x, split
    over ``model`` by the norm's scale, meets weights whose K splits over
    ``data``: each product takes the rank's range of x from the ``model``
    rank that holds it (``ctx.slice_holder``), not x's whole D.  A
    12-token prefill and 3 decode ticks of smoke zamba2 (Mamba2's decode
    ``in_proj`` and the shared attention block) and gemma3, and every
    parameter's gradient of a one-sequence loss, against plain tensors,
    with the number of such moves (``slice_moves``)."""
    out = {}
    for arch in ("zamba2-2.7b", "gemma3-1b"):
        cfg = smoke_config(get_config(arch))
        with _SliceMoves() as rec:
            got = _serve_gaps(cfg, mesh8, b=1)
        got["slice_moves"] = rec.n
        with _SliceMoves() as rec:
            got["grads"] = _grad_gaps(cfg, mesh8, b=1)
        got["grads"]["slice_moves"] = rec.n
        out[arch] = got
    return out


def case_constrain(mesh8):
    x = torch.ones(8, 4)
    outside = ctx.constrain(x, "batch", None) is x
    with ctx.use_mesh(mesh8):
        try:
            ctx.constrain(x, "batch", None)
            raised = ""
        except TypeError as e:
            raised = str(e)
        d = sharding.distribute({"x": x}, sharding.tree_shardings(
            {"x": sharding.P(None, None)}, mesh8))["x"]
        placed = [_name(p) for p in
                  ctx.constrain(d, "batch", None).placements]
    return {"outside_is_identity": outside, "raised": raised,
            "placed": placed}


def case_production_mesh():
    """256 and 512 ranks are the production meshes' sizes; 8 are not."""
    from repro_torch.launch.mesh import make_production_mesh
    out = {}
    for multi_pod in (False, True):
        try:
            make_production_mesh(multi_pod=multi_pod, device="cpu")
            out[str(multi_pod)] = ""
        except ValueError as e:
            out[str(multi_pod)] = str(e)
    return out


def case_save(mesh8, out_dir):
    cfg = smoke_config(get_config("qwen3-0.6b"))
    s0 = init_state(cfg, SEED, adamw(), device="cpu")
    s8 = sharding.distribute(s0, _shardings(s0, mesh8, "2d", cfg))
    checkpoint.save(str(Path(out_dir) / "ckpt"), 3,
                    dataclasses.replace(s8, step=3))
    return {"saved": sorted(p.name for p in (Path(out_dir) / "ckpt")
                            .iterdir())}


def case_elastic(mesh4, out_dir):
    """The 8-rank checkpoint restored onto a 2x2 mesh of 4 ranks."""
    cfg = smoke_config(get_config("qwen3-0.6b"))
    s0 = init_state(cfg, SEED, adamw(), device="cpu")
    restored, step = checkpoint.restore(
        str(Path(out_dir) / "ckpt"), s0,
        shardings=_shardings(s0, mesh4, "2d", cfg))
    gap = max(float((a.detach() - _full(b).detach()).abs().max())
              for a, b in zip(s0.params.parameters(),
                              restored.params.parameters()))
    meshes = {tuple(p.device_mesh.mesh.shape)
              for p in restored.params.parameters()}
    moments = max(float((_full(restored.opt["m"][n]) - t).abs().max())
                  for n, t in s0.opt["m"].items())
    trainer = Trainer(cfg, 8, 16, TrainerConfig(
        checkpoint_dir=str(Path(out_dir) / "ckpt")), device="cpu")
    resumed = trainer.restore_if_available(
        shardings=_shardings(trainer.state, mesh4, "2d", cfg))
    trainer_meshes = {tuple(p.device_mesh.mesh.shape)
                      for p in trainer.state.params.parameters()}
    return {"step": step, "param_gap": gap, "moment_gap": moments,
            "meshes": [list(m) for m in meshes], "trainer_step": resumed,
            "trainer_meshes": [list(m) for m in trainer_meshes]}


#: the cases that ``chip_smoke.py`` runs on the card's torch release (the
#: ``guard`` set): the steps, gradients and lookups that differ by
#: release, decode's per-shard products (uneven splits included), the
#: Mamba2 block on each ``model`` rank's heads under ``2d``, the
#: attention projections' gradients under ``dp`` with KV heads that do
#: not divide ``model``, one slot's products fed the rank's range of x
#: (``one_slot``), and the ``2d`` step, whose loss normalizes the
#: vocab-split logits per shard
GUARD_CASES = ("sp", "dp", "gqa", "ep", "ep_dp", "tied_dp", "zamba2_dp",
               "grads_heads", "zigzag", "lookup", "decode", "mamba_2d",
               "dp_kv", "one_slot", "2d")


def _cases(cases, out_dir) -> list:
    """(name, the case's call) of the set ``cases``."""
    if cases == "mesh4":
        mesh4 = make_mesh((2, 2), ("data", "model"), device="cpu")
        return [("elastic", lambda: case_elastic(mesh4, out_dir))]
    mesh8 = make_smoke_mesh(8, model=2, device="cpu")
    mesh24 = make_smoke_mesh(8, model=4, device="cpu")
    run = {"2d": lambda: case_2d(mesh8),
           "dp": lambda: case_dp(mesh8),
           "sp": lambda: case_sp(mesh8),
           "accum": lambda: case_accum(mesh8),
           "gqa": lambda: case_gqa(mesh8, mesh24),
           "ep": lambda: case_ep(mesh8, mesh24),
           "ep_dp": lambda: case_ep_dp(mesh24),
           "tied_dp": lambda: case_tied_dp(mesh8),
           "zamba2_dp": lambda: case_zamba2_dp(mesh8),
           "decode": lambda: case_decode(mesh8, mesh24),
           "mamba_2d": lambda: case_mamba_2d(mesh24),
           "dp_kv": lambda: case_dp_kv(mesh24),
           "decode_seq": lambda: case_decode_seq(mesh8, mesh24),
           "one_slot": lambda: case_one_slot(mesh8),
           "prefill_heads": lambda: case_prefill_heads(mesh8, mesh24),
           "grads_heads": lambda: case_grads_heads(mesh24),
           "zigzag": lambda: case_zigzag(mesh24),
           "lookup": lambda: case_lookup(mesh8),
           "swiglu": lambda: case_swiglu(mesh8, mesh24),
           "constrain": lambda: case_constrain(mesh8),
           "production_mesh": case_production_mesh,
           "save": lambda: case_save(mesh8, out_dir)}
    if cases != "guard":
        return list(run.items())
    # the parts that differ by release: the gradients, the dp and sp
    # lookups
    run.update(ep=lambda: case_ep(mesh8, mesh24, train=False),
               zigzag=lambda: case_zigzag(mesh24, serve=False),
               lookup=lambda: case_lookup(mesh8, ("dp", "sp")))
    return [(name, run[name]) for name in GUARD_CASES]


#: a result's gaps by key, and the tolerance each is held to
_TOLS = {"loss_gap": LOSS_TOL, "param_gap": PARAM_TOL, "grad_gap": PARAM_TOL,
         "logit_gap": SERVE_TOL, "k_gap": SERVE_TOL, "v_gap": SERVE_TOL,
         "state_gap": SERVE_TOL}


def failures(results, where="") -> list:
    """Every error in a result file's cases, every gap over its
    tolerance (:data:`_TOLS`), every ``crossing`` or ``whole_reduced``
    collective (a rank given other ranks' sequences, a projection's
    gradient all-reduced whole), every ``repeated`` product (one that
    ran whole on every rank of a mesh dim), and ``ssd_calls`` that are
    missing or not each on a plain tensor of the rank's one sequence (the
    Mamba2 block not run per shard), as lines of text."""
    out = []
    if isinstance(results, dict):
        for key, val in results.items():
            at = f"{where}/{key}" if where else str(key)
            if key == "error":
                out.append(f"{where}: {str(val).strip().splitlines()[-1]}")
            elif key in ("crossing", "whole_reduced", "repeated") and val:
                out.append(f"{at}: {val}")
            elif key == "ssd_calls":
                if not val or any(list(c) != [False, 1] for c in val):
                    out.append(f"{at}: {val}")
            elif key in _TOLS and isinstance(val, dict):
                out += [f"{at}/{n}: {g:.3e} > {_TOLS[key]:g}"
                        for n, g in val.items() if not g < _TOLS[key]]
            elif key in _TOLS:
                if not val < _TOLS[key]:
                    out.append(f"{at}: {val:.3e} > {_TOLS[key]:g}")
            else:
                out += failures(val, at)
    return out


def main(cases, rank, world, out_dir):
    torch.set_num_threads(1)
    store = dist.FileStore(str(Path(out_dir) / f"store_{cases}"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    results = {}
    try:
        for name, fn in _cases(cases, out_dir):
            t0 = time.perf_counter()
            try:
                results[name] = fn()
            except Exception:
                results[name] = {"error": traceback.format_exc()}
            results.setdefault("seconds", {})[name] = \
                time.perf_counter() - t0
            # every rank reaches the next case together, a failed one too
            dist.barrier()
    finally:
        if rank == 0:
            tmp = Path(out_dir) / f".{cases}.json"
            tmp.write_text(json.dumps(results))
            os.replace(tmp, Path(out_dir) / f"{cases}.json")
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
