"""Port parity: the sharding rules (``repro_torch.parallel.sharding``)
against ``repro.parallel.sharding``, specs only, no ranks.

The reference's nine cases (``tests/test_sharding_rules.py``) are
restated on the port's abstract state (``meta`` tensors) and a
duck-typed ``FakeMesh``.  Then every arch x profile x mesh: each port
leaf's spec is the reference's spec for the stacked leaf that
``convert.params_from_jax`` maps it from, with the lead dims dropped;
where the reference shards a lead dim (the port's per-layer tensor is
then replicated over that axis) the leaf is one of the listed
exceptions; ``comm_volumes`` equals the reference's to the byte; and
``batch_specs`` of every cell's inputs and ``cache_specs`` of the decode
states match.  The reference's abstract state comes from its own
``launch.specs`` (``jax.eval_shape``).
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as RefP

from repro.configs import get_config as ref_get_config
from repro.launch import specs as ref_lspecs
from repro.models.config import SHAPES as REF_SHAPES
from repro.parallel import sharding as ref_sharding
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import specs as lspecs
from repro_torch.models import convert
from repro_torch.models.config import SHAPES
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import (P, _dp_leaf_spec, batch_specs,
                                           comm_volumes, param_specs)


class FakeMesh:
    """Duck-typed mesh: sharding rules only read .shape / .axis_names."""

    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


MESH = FakeMesh(data=16, model=16)
MESH3 = FakeMesh(pod=2, data=16, model=16)
MESHES = {"16x16": MESH, "2x16x16": MESH3,
          "4x2": FakeMesh(data=4, model=2), "2x4": FakeMesh(data=2, model=4)}
PROFILES = ("2d", "dp", "sp")

#: (arch, profile) -> (the per-layer leaves the reference shards on a lead
#: dim, the meshes where it does): under 2d the stacked (L, x) vectors'
#: generic rule puts L on 'data' where it divides; under dp/sp Mamba2's
#: (L, H) = (24, 24) head vectors pick L, their first largest dim
NORMS = ("ln1", "ln2")
MAMBA_VECTORS = ("a_log", "conv_b", "d_skip", "dt_bias", "ln", "norm")
HEAD_VECTORS = ("a_log", "d_skip", "dt_bias")
SMALL = ("4x2", "2x4")
LEAD_DIM_EXCEPTIONS = {
    ("musicgen-medium", "2d"): (NORMS, tuple(MESHES)),
    ("minitron-4b", "2d"): (NORMS, tuple(MESHES)),
    ("granite-moe-3b-a800m", "2d"): (NORMS, tuple(MESHES)),
    ("gemma3-1b", "2d"): (NORMS, ("2x4",)),
    ("glm4-9b", "2d"): (NORMS, SMALL),
    ("dbrx-132b", "2d"): (NORMS, SMALL),
    ("internvl2-2b", "2d"): (NORMS, SMALL),
    ("qwen3-0.6b", "2d"): (("k_norm", "ln1", "ln2", "q_norm"), SMALL),
    ("mamba2-130m", "2d"): (MAMBA_VECTORS, SMALL),
    ("zamba2-2.7b", "2d"): (MAMBA_VECTORS, ("2x4",)),
    ("mamba2-130m", "dp"): (HEAD_VECTORS, ("2x16x16",) + SMALL),
    ("mamba2-130m", "sp"): (HEAD_VECTORS, ("2x16x16",) + SMALL),
}


def _abstract_params(arch):
    return lspecs.abstract_params(get_config(arch))


def _layer(specs, name, i=0):
    return specs[f"layers.{i}.{name}"]


# ---------------------------------------------------------------------------
# the reference's cases, restated
# ---------------------------------------------------------------------------
def test_2d_dense_rules():
    cfg = get_config("glm4-9b")
    specs = param_specs(_abstract_params("glm4-9b"), MESH, cfg=cfg)
    assert _layer(specs, "wq") == P("data", "model")
    assert _layer(specs, "wo") == P("model", "data")
    assert _layer(specs, "w_down") == P("model", "data")
    assert specs["embed"] == P("model", "data")
    # the stacked (L, D) norm scale keeps the column rule, L dropped
    assert _layer(specs, "ln1") == P("model")


def test_moe_expert_parallel_when_divisible():
    cfg = get_config("dbrx-132b")                 # 16 experts % 16 == 0
    specs = param_specs(_abstract_params("dbrx-132b"), MESH, cfg=cfg)
    assert _layer(specs, "w_gate")[0] == "model"


def test_moe_fallback_when_not_divisible():
    cfg = get_config("granite-moe-3b-a800m")       # 40 % 16 != 0
    specs = param_specs(_abstract_params(cfg.name), MESH, cfg=cfg)
    wg = _layer(specs, "w_gate")
    assert wg[0] is None                           # experts NOT sharded
    assert "model" in tuple(wg)                    # ffn dims sharded instead


def test_non_divisible_dims_replicate():
    # mamba2 in_proj output dim 3352 is not divisible by 16
    cfg = get_config("mamba2-130m")
    specs = param_specs(_abstract_params(cfg.name), MESH, cfg=cfg)
    in_proj = _layer(specs, "in_proj")
    assert in_proj[-1] is None
    assert in_proj[-2] == "data"                   # d_model 768 divides


def test_dp_profile_prefers_full_mesh_coverage():
    assert _dp_leaf_spec((151936, 1024), MESH) == P(None, ("data", "model"))
    assert _dp_leaf_spec((28, 1024, 3072), MESH)[2] == ("data", "model")
    assert _dp_leaf_spec((8,), MESH) == P(None)


def _tokens(b, s):
    return {"tokens": torch.empty((b, s), dtype=torch.int32, device="meta")}


def test_batch_specs_profiles():
    s2 = batch_specs(_tokens(256, 4096), MESH, profile="2d")["tokens"]
    assert s2[0] in ("data", ("data",))
    sdp = batch_specs(_tokens(256, 4096), MESH, profile="dp")["tokens"]
    assert sdp[0] == ("data", "model")
    # batch 32 cannot cover 256: dp degrades to data-only
    sdp2 = batch_specs(_tokens(32, 4096), MESH, profile="dp")["tokens"]
    assert sdp2[0] in ("data", ("data",))
    # sp shards the sequence over model
    ssp = batch_specs(_tokens(32, 4096), MESH, profile="sp")["tokens"]
    assert ssp[0] in ("data", ("data",)) and ssp[1] in ("model", ("model",))


def test_batch_specs_multipod():
    s = batch_specs(_tokens(256, 4096), MESH3, profile="2d")["tokens"]
    assert tuple(s[0]) == ("pod", "data")


def test_cache_specs_kv_head_fallback():
    cfg = get_config("dbrx-132b")                  # kv=8 < model=16
    st = lspecs.abstract_decode_state(cfg, 128, 32768)
    cs = sharding.cache_specs(st, MESH, 128)
    # batch over data, sequence picks up 'model' because kv doesn't divide
    assert cs["k"][1] in ("data", ("data",))
    assert cs["k"][2] == "model"


def test_comm_volumes_split():
    params = {"w": torch.zeros((64, 64)), "ln": torch.zeros((64,))}
    specs = {"w": P("data", None), "ln": P(None)}
    v = comm_volumes(params, MESH, specs)
    assert v["weight_all_gather_bytes"] == 64 * 64 * 4
    assert v["grad_all_reduce_bytes"] == 64 * 4


# ---------------------------------------------------------------------------
# parity over every arch, profile and mesh
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return ref_lspecs.abstract_params(ref_get_config(arch))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return _abstract_params(arch)


@functools.lru_cache(maxsize=None)
def _sources(arch):
    """Port parameter name -> (the reference's flat leaf index, its path):
    ``params_from_jax`` run on a tree whose every leaf holds its own
    index (the layers' lead dims kept, the rest of size 1)."""
    cfg = get_config(arch)
    flat, treedef = jax.tree_util.tree_flatten_with_path(_ref_params(arch))
    lead = 2 if cfg.family == "hybrid" else 1
    ids = []
    for i, (path, leaf) in enumerate(flat):
        n = lead if path[0].key == "layers" else 0
        ids.append(np.full(tuple(leaf.shape[:n]) + (1,) * (leaf.ndim - n),
                           i, np.float32))
    mapped = convert.params_from_jax(
        cfg, jax.tree_util.tree_unflatten(treedef, ids), device="cpu")
    out = {}
    for name, t in mapped.named_parameters():
        i = int(t.reshape(-1)[0])
        out[name] = (i, "/".join(str(k.key) for k in flat[i][0]))
    return out


def _ref_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda s: isinstance(s, RefP))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, profile, mesh_name):
    mesh = MESHES[mesh_name]
    cfg = get_config(arch)
    ref_params = _ref_params(arch)
    ref_flat = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    ref_specs = _ref_leaves(ref_sharding.param_specs(ref_params, mesh,
                                                     profile))
    port = _port_params(arch)
    specs = param_specs(port, mesh, profile, cfg=cfg)
    sources = _sources(arch)
    exceptions = set()
    for name, t in port.named_parameters():
        i, path = sources[name]
        ref_shape = tuple(ref_flat[i][1].shape)
        lead = len(ref_shape) - t.dim()
        assert ref_shape[lead:] == tuple(t.shape), (name, path)
        want = tuple(ref_specs[i])
        assert specs[name] == P(*want[lead:]), (name, path, want)
        if any(ax is not None for ax in want[:lead]):
            exceptions.add(path.split("/")[-1])
    listed, meshes = LEAD_DIM_EXCEPTIONS.get((arch, profile), ((), ()))
    assert exceptions == (set(listed) if mesh_name in meshes else set())
    assert comm_volumes(port, mesh, profile=profile, cfg=cfg) == \
        ref_sharding.comm_volumes(ref_params, mesh, ref_sharding.param_specs(
            ref_params, mesh, profile))
    for shape in SHAPES:
        for shard_seq in (False, True):
            got = batch_specs(lspecs.input_specs(cfg, SHAPES[shape]), mesh,
                              shard_seq, profile)
            want = ref_sharding.batch_specs(
                ref_lspecs.input_specs(ref_get_config(arch),
                                       REF_SHAPES[shape]),
                mesh, shard_seq, profile)
            assert set(got) == set(want)
            for key in want:
                assert got[key] == P(*want[key]), (shape, key)


def _hybrid_layers_spec(ref):
    """The reference's (n_groups, attn_every, ...) state spec as the
    port's (L, ...): n_groups' spec where attn_every's is None, else
    None."""
    ref = tuple(ref)
    return P(ref[0] if ref[1] is None else None, *ref[2:])


CACHE_CASES = [("glm4-9b", 128, 1024), ("glm4-9b", 1, 2048),
               ("zamba2-2.7b", 128, 1024), ("zamba2-2.7b", 9, 1024),
               ("mamba2-130m", 24, 1024), ("dbrx-132b", 128, 32768)]


@pytest.mark.parametrize("mesh_name", list(MESHES) + ["3x2"])
@pytest.mark.parametrize("arch,batch,seq", CACHE_CASES)
def test_cache_specs_match_reference(arch, batch, seq, mesh_name):
    """glm4-9b at the reference test's batch 128 / seq 1024 and long
    context (batch 1, the sequence split); zamba2-2.7b's per-layer Mamba2
    states against the reference's grouped ones; batch 9 (zamba2's group
    count) and 24 (mamba2's layer count) on a 3x2 mesh, where the
    reference's by-size search finds a layer dim as the batch dim."""
    mesh = MESHES.get(mesh_name, FakeMesh(data=3, model=2))
    cfg = get_config(arch)
    got = sharding.cache_specs(lspecs.abstract_decode_state(cfg, batch, seq),
                               mesh, batch, cfg=cfg)
    want = ref_sharding.cache_specs(ref_lspecs.abstract_decode_state(
        ref_get_config(arch), batch, seq), mesh, batch)
    assert set(got) == set(want)
    for key in want:
        if key == "ssm_layers":
            for sub in want[key]:
                ref = want[key][sub]
                expect = _hybrid_layers_spec(ref) \
                    if cfg.family == "hybrid" else P(*ref)
                assert got[key][sub] == expect, (key, sub, ref)
        else:
            assert got[key] == P(*want[key]), key


# ---------------------------------------------------------------------------
# the abstract state and the cells' step functions
# ---------------------------------------------------------------------------
def test_abstract_state_is_shapes_only():
    """``meta`` tensors of the real shapes (dbrx-132b's 131.6 B
    parameters, as many as the reference's abstract tree holds), nothing
    drawn or allocated; the optimizer's moments keyed by parameter
    name."""
    cfg = get_config("dbrx-132b")
    st = lspecs.abstract_train_state(cfg)
    leaves = list(st.params.parameters())
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(_ref_params(cfg.name)))
    assert set(st.opt["m"]) == {n for n, _ in st.params.named_parameters()}
    assert all(t.device.type == "meta" for t in st.opt["v"].values())
    dec = lspecs.abstract_decode_state(cfg, 128, 32768)
    assert tuple(dec["k"].shape) == (cfg.n_layers, 128, 32768,
                                     cfg.n_kv_heads, cfg.resolved_head_dim)
    assert dec["k"].device.type == "meta"


def test_step_fn_for_runs_each_mode():
    """``step_fn_for``'s train, prefill and decode functions on a smoke
    model at small cells, against the functions they stand for."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.config import ShapeConfig, smoke_config
    from repro_torch.train.train_step import init_state, make_train_step
    cfg = smoke_config(get_config("qwen3-0.6b"))
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen,
                           dtype=torch.int32)
    train = lspecs.step_fn_for(cfg, ShapeConfig("t", 8, 2, "train"))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    _, got = train(init_state(cfg, 0, device="cpu"), batch)
    _, want = make_train_step(cfg)(init_state(cfg, 0, device="cpu"), batch)
    assert float(got["loss"]) == float(want["loss"])
    params = tfm.init_params(cfg, 0, device="cpu")
    with torch.no_grad():
        logits, state = lspecs.step_fn_for(
            cfg, ShapeConfig("p", 8, 2, "prefill"))(params,
                                                   {"tokens": tokens})
        want_logits, _ = tfm.prefill(params, cfg, tokens, 8)
        assert torch.equal(logits, want_logits)
        assert state["k"].shape[2] == 8          # max_seq = the cell's
        tick = lspecs.step_fn_for(cfg, ShapeConfig("d", 8, 2, "decode"))
        out, _ = tick(params, {"tokens": tokens[:, :1]}, state)
        assert out.shape == (2, 1, cfg.vocab_size)


# ---------------------------------------------------------------------------
# constrain's axis resolution and the placements a spec becomes
# ---------------------------------------------------------------------------
RESOLVE_CASES = [
    ((8, 16, 64), ("batch", "seq", None)),
    ((6, 16, 64), ("batch", "seq", None)),
    ((2, 64, 64), ("batch", None, None)),
    ((4, 2, 8, 64), ("model", "batch", None, None)),
    ((3, 2, 8, 64), ("model", "batch", None, None)),
    ((8, 16, 50280), ("batch", None, "model")),
    ((8, 16, 151936), ("batch", None, "model")),
    ((32, 4096), (("pod", "data", "model"), None)),
    ((1, 2048, 8), ("batch", "batch", "model")),
]


@pytest.mark.parametrize("seq", [(), ("model",)])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_constrain_resolves_axes_as_the_reference(monkeypatch, mesh_name,
                                                  seq):
    """``ctx.resolve`` gives the spec the reference's ``constrain`` hands
    ``with_sharding_constraint`` (captured in place of it) for every case,
    mesh and sequence-axes setting: sentinels, absent axes dropped,
    tuples shrunk until the dim divides, an axis used once."""
    from repro.parallel import ctx as ref_ctx
    from repro_torch.parallel import ctx
    mesh = MESHES[mesh_name]
    monkeypatch.setattr(ref_ctx.jax.lax, "with_sharding_constraint",
                        lambda x, spec: spec)
    monkeypatch.setattr(ref_ctx._state, "mesh", mesh, raising=False)
    monkeypatch.setattr(ref_ctx._state, "seq_axes", seq, raising=False)
    ctx.set_seq_axes(seq)
    try:
        for shape, axes in RESOLVE_CASES:
            want = ref_ctx.constrain(np.zeros(shape, np.int8), *axes)
            got = ctx.resolve(shape, axes, mesh)
            assert P(*got) == P(*want), (shape, axes, got, want)
    finally:
        ctx.set_seq_axes(())


def test_placements_of_a_spec():
    """One placement a mesh dim, in the mesh's order: a tensor dim over a
    tuple of axes is split on each (major first, the mesh's order), a
    size-1 dim left whole; an axis used twice or a tuple against the
    mesh's order is refused."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = FakeMesh(pod=2, data=4, model=2)
    assert sharding.placements(P(("data", "model"), None), mesh) == (
        Replicate(), Shard(0), Shard(0))
    assert sharding.placements(P(None, "model", "pod"), mesh) == (
        Shard(2), Replicate(), Shard(1))
    assert sharding.placements(P("data", None), mesh, (1, 8)) == (
        Replicate(), Replicate(), Replicate())
    assert sharding.Sharding(mesh, P("pod")).placements == (
        Shard(0), Replicate(), Replicate())
    with pytest.raises(ValueError, match="twice"):
        sharding.placements(P("data", "data"), mesh)
    with pytest.raises(ValueError, match="order"):
        sharding.placements(P(("model", "data")), mesh)
