"""Port parity: the hand-written optimizers (``repro_torch.train.optim``)
against ``repro.train.optim``.

The same numpy state and gradients go through both: one and three
updates of SGD (with and without momentum), Adam and AdamW give
parameters and moments within rtol 1e-6 (fp32 elementwise arithmetic;
the bias corrections' float32 powers may differ by an ulp), and the
moment dtypes follow the reference's JAX type promotion for bfloat16
parameters, with float32 (clipped) gradients and with bfloat16 ones, as
an optimizer update and as the training step gives them (clip on and
off)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.config import smoke_config as ref_smoke_config
from repro.train import optim as ref_optim
from repro.train.train_step import init_state as ref_init_state
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.configs import get_config
from repro_torch.models.config import smoke_config
from repro_torch.models.convert import state_from_jax
from repro_torch.train import optim
from repro_torch.train.data import SyntheticTokens
from repro_torch.train.train_step import make_train_step

RTOL = 1e-6

OPTIMIZERS = {
    "sgd": dict(lr=0.05),
    "sgd-momentum": dict(lr=0.05, momentum=0.9),
    "adam": dict(lr=1e-2),
    "adamw": dict(lr=1e-2, weight_decay=0.1),
}


def _make(pkg, name):
    kw = dict(OPTIMIZERS[name])
    return getattr(pkg, name.split("-")[0])(**kw)


def _tree(rng, dtype=np.float32):
    return {"w": rng.standard_normal((6, 5)).astype(dtype),
            "blk": {"b": rng.standard_normal((7,)).astype(dtype),
                    "s": rng.standard_normal((2, 3, 4)).astype(dtype)}}


def _torch_tree(tree):
    return optim.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _np(tree):
    return optim.tree_map(lambda t: np.asarray(t), tree)


def _pairs(got, want):
    """(port leaf, reference leaf) pairs, matched by key path."""
    if isinstance(got, dict):
        assert set(got) == set(want)
        return [pair for k in got for pair in _pairs(got[k], want[k])]
    if isinstance(got, (list, tuple)):
        assert len(got) == len(want)
        return [pair for g, w in zip(got, want) for pair in _pairs(g, w)]
    return [(got, want)]


def _assert_tree_close(got, want):
    for g, w in _pairs(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=RTOL,
                                   atol=RTOL * float(np.abs(w).max()))


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_updates_match_reference(name, steps):
    rng = np.random.default_rng(7)
    params = _tree(rng)
    ref, port = _make(ref_optim, name), _make(optim, name)
    r_params = jax.tree.map(jnp.asarray, params)
    r_state = ref.init(r_params)
    p_params = _torch_tree(params)
    p_state = port.init(p_params)
    for step in range(steps):
        grads = _tree(rng)
        r_params, r_state = ref.update(jax.tree.map(jnp.asarray, grads),
                                       r_state, r_params, jnp.int32(step))
        p_params, p_state = port.update(_torch_tree(grads), p_state,
                                        p_params, step)
    _assert_tree_close(p_params, r_params)
    _assert_tree_close(p_state, r_state)


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["adam", "adamw", "sgd-momentum"])
def test_update_dtypes_follow_the_reference(name, grad_dtype):
    """bfloat16 parameters with float32 (clipped) or bfloat16 gradients."""
    rng = np.random.default_rng(3)
    params = _tree(rng)
    grads = _tree(rng)
    ref, port = _make(ref_optim, name), _make(optim, name)
    r_params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    r_grads = jax.tree.map(lambda a: jnp.asarray(a, grad_dtype), grads)
    r_new, r_state = ref.update(r_grads, ref.init(r_params), r_params,
                                jnp.int32(0))
    p_params = optim.tree_map(
        lambda a: torch.from_numpy(a).to(torch.bfloat16), params)
    p_grads = optim.tree_map(
        lambda a: torch.from_numpy(a).to(getattr(torch, grad_dtype)), grads)
    p_new, p_state = port.update(p_grads, port.init(p_params), p_params, 0)
    for got, want in (_pairs(p_new, r_new) + _pairs(p_state, r_state)):
        assert str(got.dtype) == f"torch.{want.dtype}"


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_train_step_moment_dtypes_follow_the_reference(clip):
    """AdamW on bfloat16 parameters after one training step: float32
    moments with clipping on (the clipped gradients are float32), the
    parameters' own dtypes with it off (a few float32 tensors, such as
    Mamba2's ``dt_bias``, stay float32 either way)."""
    arch = "mamba2-130m"
    ref_cfg = dataclasses.replace(ref_smoke_config(ref_get_config(arch)),
                                  param_dtype="bfloat16")
    cfg = dataclasses.replace(smoke_config(get_config(arch)),
                              param_dtype="bfloat16")
    ref_opt, opt = ref_optim.adamw(lr=1e-3), optim.adamw(lr=1e-3)
    r_state = ref_init_state(ref_cfg, jax.random.PRNGKey(0), ref_opt)
    state = state_from_jax(cfg, jax.tree.map(np.asarray, r_state), "cpu")
    batch = SyntheticTokens(cfg, 2, 16).batch_at(0)
    r_new, _ = jax.jit(ref_make_train_step(ref_cfg, ref_opt,
                                           clip_norm=clip))(
        r_state, jax.tree.map(jnp.asarray, batch))
    new, _ = make_train_step(cfg, opt, clip_norm=clip)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    r_moments = state_from_jax(cfg, jax.tree.map(np.asarray, r_new),
                               "cpu").opt
    for which in ("m", "v"):
        for name, t in new.opt[which].items():
            assert t.dtype == r_moments[which][name].dtype, (which, name)
    assert {str(t.dtype) for t in new.opt["m"].values()} == (
        {"torch.float32"} if clip else {"torch.bfloat16", "torch.float32"})
