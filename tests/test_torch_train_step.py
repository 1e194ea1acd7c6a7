"""Port parity: the training step (``repro_torch.train.train_step``) and
its data against ``repro.train``.

The smoke configs of five families (dense qwen3-0.6b, moe
granite-moe-3b-a800m, ssm mamba2-130m, hybrid zamba2-2.7b, vlm
internvl2-2b) start from the reference's own ``init_state``, carried
into the port by ``state_from_jax``, and take one step on the same
``SyntheticTokens`` batch (bitwise the reference's).  Tolerances, fp32:
``loss``, ``ce``, ``aux`` and ``grad_norm`` within rtol 1e-5 (sums in
another order through every layer); with SGD the updated parameters
within atol 1e-6 (lr 0.05 times gradients that agree to about 1e-7).
With AdamW the first update is about ``lr * g / (|g| + eps)``: where the
reference's |g| is far above eps it is ``lr * sign(g)`` and the
parameters agree within atol 1e-6, but where |g| is near eps (1e-8) the
step turns on the gradients' last bits, so elements whose first moment
is below ``(1 - b1) * 1e-6`` are held within 2 lr, the most such a step
can differ by; the first moments agree within 1e-4 of each leaf's
largest.  Accumulation over 2 microbatches is held against the
reference's the same way (SGD), and against the port's own single batch
at the reference test's ``atol=2e-5`` with SGD: the reference's AdamW
version of that test fails on near-zero gradients for that reason
(``ROADMAP.md`` queue 3).  Checkpointing (``remat``) changes no bit of a
gradient."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.config import smoke_config as ref_smoke_config
from repro.train import optim as ref_optim
from repro.train.data import SyntheticTokens as RefTokens
from repro.train.train_step import init_state as ref_init_state
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.configs import get_config
from repro_torch.models import transformer as tfm
from repro_torch.models.config import smoke_config
from repro_torch.models.convert import state_from_jax
from repro_torch.train import optim
from repro_torch.train.data import Prefetcher, SyntheticTokens
from repro_torch.train.train_step import make_train_step, named_params

ARCHS = ["qwen3-0.6b", "granite-moe-3b-a800m", "mamba2-130m",
         "zamba2-2.7b", "internvl2-2b"]
METRIC_RTOL = 1e-5
SGD_ATOL = 1e-6
#: the first moment, 0.1 g, against the leaf's largest: a few leaves sum
#: per-head terms with cancellation (zamba2's ``a_log``: 1.5e-5)
MOMENT_RTOL = 1e-4
LR_SGD, LR_ADAMW = 0.05, 1e-3


def _configs(arch):
    return (ref_smoke_config(ref_get_config(arch)),
            smoke_config(get_config(arch)))


def _batch(cfg, b=4, s=16, step=0):
    return SyntheticTokens(cfg, b, s).batch_at(step)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _both_steps(arch, ref_opt, opt, **kw):
    """One step of each package from the reference's initial state:
    (reference state, its metrics, port state, its metrics, the port's
    carried initial state)."""
    ref_cfg, cfg = _configs(arch)
    r_state = ref_init_state(ref_cfg, jax.random.PRNGKey(0), ref_opt)
    state = state_from_jax(cfg, jax.tree.map(np.asarray, r_state), "cpu")
    batch = _batch(cfg)
    r_new, r_metrics = jax.jit(ref_make_train_step(ref_cfg, ref_opt, **kw))(
        r_state, jax.tree.map(jnp.asarray, batch))
    new, metrics = make_train_step(cfg, opt, **kw)(state,
                                                   _torch_batch(batch))
    return (state_from_jax(cfg, jax.tree.map(np.asarray, r_new), "cpu"),
            r_metrics, new, metrics)


def _check_metrics(metrics, r_metrics, step):
    for key in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(float(metrics[key]), float(r_metrics[key]),
                                   rtol=METRIC_RTOL, atol=1e-12, err_msg=key)
    assert metrics["step"] == int(r_metrics["step"]) == step


def _check_params(new, want, atol):
    got = named_params(new.params)
    for name, t in named_params(want.params).items():
        np.testing.assert_allclose(got[name].detach().numpy(),
                                   t.detach().numpy(), rtol=0, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_tokens_are_the_references(arch):
    ref_cfg, cfg = _configs(arch)
    for step in (0, 7):
        want = RefTokens(ref_cfg, 4, 16, seed=3).batch_at(step)
        got = SyntheticTokens(cfg, 4, 16, seed=3).batch_at(step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_prefetcher_yields_the_stream_from_its_start():
    _, cfg = _configs("qwen3-0.6b")
    source = SyntheticTokens(cfg, 2, 8, seed=1)
    pre = Prefetcher(source, start_step=3)
    try:
        for want in (3, 4, 5):
            step, batch = pre.next()
            assert step == want
            np.testing.assert_array_equal(batch["tokens"],
                                          source.batch_at(want)["tokens"])
    finally:
        pre.close()
    assert not pre._thread.is_alive()


@pytest.mark.parametrize("arch", ARCHS)
def test_sgd_step_matches_reference(arch):
    want, r_metrics, new, metrics = _both_steps(
        arch, ref_optim.sgd(lr=LR_SGD), optim.sgd(lr=LR_SGD), clip_norm=1.0)
    _check_metrics(metrics, r_metrics, 1)
    _check_params(new, want, SGD_ATOL)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-3b-a800m",
                                  "zamba2-2.7b"])
def test_adamw_step_matches_reference(arch):
    want, r_metrics, new, metrics = _both_steps(
        arch, ref_optim.adamw(lr=LR_ADAMW), optim.adamw(lr=LR_ADAMW),
        clip_norm=1.0)
    _check_metrics(metrics, r_metrics, 1)
    got = named_params(new.params)
    off = 0
    for name, t in named_params(want.params).items():
        diff = np.abs(got[name].detach().numpy() - t.detach().numpy())
        m = np.abs(want.opt["m"][name].numpy())
        near_eps = m < (1 - 0.9) * 1e-6
        off += int((diff > SGD_ATOL).sum())
        assert diff[~near_eps].max(initial=0.0) <= SGD_ATOL, name
        assert diff.max(initial=0.0) <= 2 * LR_ADAMW, name
        np.testing.assert_allclose(new.opt["m"][name].numpy(), m * np.sign(
            want.opt["m"][name].numpy()), rtol=MOMENT_RTOL,
            atol=MOMENT_RTOL * float(m.max(initial=0.0)), err_msg=name)
    assert off <= sum(t.numel() for t in got.values()) // 1000


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-3b-a800m"])
def test_accumulation_matches_reference(arch):
    """``accum_steps=2`` in both packages; the accumulated ``aux`` is zero
    in both, as the reference sets it."""
    want, r_metrics, new, metrics = _both_steps(
        arch, ref_optim.sgd(lr=LR_SGD), optim.sgd(lr=LR_SGD),
        clip_norm=1.0, accum_steps=2)
    _check_metrics(metrics, r_metrics, 1)
    assert float(metrics["aux"]) == 0.0
    _check_params(new, want, SGD_ATOL)


def test_accumulation_equivalence_with_sgd():
    """The reference test's case (qwen3 smoke, batch 4 x 16, no clipping)
    with SGD: one batch against two microbatches at its atol=2e-5."""
    ref_cfg, cfg = _configs("qwen3-0.6b")
    opt = optim.sgd(lr=1e-3)
    r_state = ref_init_state(ref_cfg, jax.random.PRNGKey(0),
                             ref_optim.sgd(lr=1e-3))
    batch = _torch_batch(_batch(cfg))
    one, _ = make_train_step(cfg, opt, accum_steps=1, clip_norm=0.0)(
        state_from_jax(cfg, jax.tree.map(np.asarray, r_state), "cpu"), batch)
    two, _ = make_train_step(cfg, opt, accum_steps=2, clip_norm=0.0)(
        state_from_jax(cfg, jax.tree.map(np.asarray, r_state), "cpu"), batch)
    _check_params(two, one, 2e-5)


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-2.7b"])
def test_remat_gives_bitwise_equal_gradients(arch, policy):
    _, cfg = _configs(arch)
    params = tfm.init_params(cfg, seed=1, device="cpu")
    params.requires_grad_(True)
    batch = _torch_batch(_batch(cfg))
    grads = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
        loss, _ = tfm.loss_fn(params, c, batch)
        grads.append(torch.autograd.grad(loss, list(params.parameters())))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
