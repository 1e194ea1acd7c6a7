"""Port parity of the MoE layer (``repro_torch.models.moe``) and of the
moe family (granite-moe-3b-a800m, dbrx-132b at their smoke configs).

``moe_layer`` is held against ``repro.models.moe.moe_layer`` on the same
numpy inputs where capacity drops tokens (asserted): outputs at rtol 1e-4
/ atol 1e-5 (fp32; the combine sums a token's k terms in another order),
the aux loss within 1e-6.  The routing is discrete, so inputs come from
seeds whose top-k margins are far above fp32 noise (asserted)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zoo_parity as zp
from repro.models import moe as ref_moe
from repro_torch.models import moe
from repro_torch.models import transformer as tfm

ARCHS = ("granite-moe-3b-a800m", "dbrx-132b")
D, F_, E = 32, 24, 8

pair = functools.lru_cache(maxsize=None)(zp.make_pair)


def _params(seed):
    rng = np.random.default_rng(seed)
    return {"router": rng.standard_normal((D, E)) / np.sqrt(D),
            "w_gate": rng.standard_normal((E, D, F_)) / np.sqrt(D),
            "w_up": rng.standard_normal((E, D, F_)) / np.sqrt(D),
            "w_down": rng.standard_normal((E, F_, D)) / np.sqrt(F_)}


def _both(params, x):
    ref = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    port = {k: torch.from_numpy(v.astype(np.float32))
            for k, v in params.items()}
    return (ref, jnp.asarray(x, jnp.float32)), (port, torch.from_numpy(
        x.astype(np.float32)))


def _kept(x, params, top_k, cf, groups):
    """Number of kept (token, k) pairs, and the least top-k margin."""
    xt = torch.from_numpy(x.astype(np.float32)).reshape(groups, -1, D)
    probs, _, top_e = moe.route(params, xt, top_k)
    tg = xt.shape[1]
    cap = moe.capacity(tg, top_k, E, cf)
    counts = torch.stack([torch.bincount(e.reshape(-1), minlength=E)
                          for e in top_e])
    srt = torch.sort(probs, dim=-1, descending=True).values
    margin = float((srt[..., top_k - 1] - srt[..., top_k]).min())
    return int(torch.clamp(counts, max=cap).sum()), tg * top_k * groups, \
        margin


@pytest.mark.parametrize("top_k,cf,groups,shape", [
    (2, 1.25, None, (2, 13)),
    (2, 0.5, None, (2, 13)),
    (4, 1.0, 2, (4, 9)),
    (1, 1.25, None, (1, 40)),
])
def test_moe_layer_matches_reference_where_tokens_drop(top_k, cf, groups,
                                                       shape):
    params = _params(1)
    x = np.random.default_rng(2).standard_normal(shape + (D,))
    (ref_p, ref_x), (p, xt) = _both(params, x)
    kept, total, margin = _kept(x, p, top_k, cf, groups or 1)
    assert kept < total            # capacity dropped some (token, k)
    assert margin > 1e-5           # no near-tie decides a route
    want, want_aux = ref_moe.moe_layer(ref_p, ref_x, top_k, cf, 0.01,
                                       groups=groups)
    got, aux = moe.moe_layer(p, xt, top_k, cf, 0.01, groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    assert aux.dtype == torch.float32
    assert abs(float(aux) - float(want_aux)) <= 1e-6


@pytest.mark.parametrize("tokens,top_k,experts,cf", [
    (4, 8, 40, 1.25), (1, 8, 40, 1.25), (2048, 8, 40, 1.25),
    (26, 2, 4, 1.25), (3, 2, 4, 1.25), (5, 1, 4, 0.5), (1031, 4, 16, 1.25)])
def test_capacity_rounds_as_the_reference(tokens, top_k, experts, cf):
    # the reference's own formula, Python's round (halves to even)
    want = int(max(1, round(tokens * top_k / experts * cf)))
    assert moe.capacity(tokens, top_k, experts, cf) == want


def test_a_token_past_capacity_passes_through_as_zero():
    params = {k: torch.from_numpy(v.astype(np.float32))
              for k, v in _params(3).items()}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 64, D)).astype(np.float32))
    out, _ = moe.moe_layer(params, x, 1, capacity_factor=1 / 64)
    # capacity 1 a expert: only each expert's first token is computed
    _, _, top_e = moe.route(params, x, 1)
    first = {int(e): t for t, e in reversed(list(enumerate(
        top_e[0, :, 0].tolist())))}
    zero = [t for t in range(64) if t not in first.values()]
    assert len(zero) >= 64 - E
    assert torch.count_nonzero(out[0, zero]) == 0
    assert all(torch.count_nonzero(out[0, t]) > 0 for t in first.values())


def test_groups_must_divide_the_tokens():
    params = {k: torch.from_numpy(v.astype(np.float32))
              for k, v in _params(1).items()}
    with pytest.raises(ValueError, match="groups"):
        moe.moe_layer(params, torch.zeros((1, 5, D)), 2, groups=2)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    zp.check_configs(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_aux_match_reference(arch):
    aux = zp.check_forward(pair(arch), with_prefix=False)
    assert aux > 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_adds_the_aux_loss(arch):
    from repro.models import transformer as ref_tfm
    ref_cfg, ref_params, cfg, params = pair(arch)
    toks = zp.tokens(5, (2, 13), cfg.vocab_size)
    labels = zp.tokens(6, (2, 13), cfg.vocab_size)
    loss, parts = tfm.loss_fn(params, cfg, {
        "tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    ref_loss, ref_parts = ref_tfm.loss_fn(ref_params, ref_cfg, {
        "tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    assert float(parts["aux"]) > 0
    assert float(loss) == pytest.approx(float(parts["ce"] + parts["aux"]))
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    assert float(parts["aux"]) == pytest.approx(float(ref_parts["aux"]),
                                                abs=1e-6)


@pytest.mark.parametrize("s", zp.PROMPT_LENS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, s):
    zp.check_prefill_and_decode(pair(arch), s, with_prefix=False)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_serves_the_reference_tokens(arch, monkeypatch):
    zp.check_engine(pair(arch), monkeypatch)
