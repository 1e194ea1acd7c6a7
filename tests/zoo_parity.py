"""Shared cases of the model-zoo parity tests (``test_torch_moe.py``,
``test_torch_zoo_dense.py``, ``test_torch_zoo_hybrid.py``): one arch's
smoke model in both packages, the reference's parameters carried into the
port by ``params_from_jax``, compared at rtol 1e-4 / atol 1e-5 (fp32
throughout; attention, the SSD scan and the MoE combine sum in another
order).  Served greedy tokens are held equal, and every decision the
port's engine took must have a top-2 logit gap above ``MIN_GAP``, so the
equality is not luck.  vlm and audio archs also run with a
``prefix_embeds`` of their smoke prefix."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.models import transformer as ref_tfm
from repro.models.config import smoke_config as ref_smoke_config
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServingEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.models import transformer as tfm
from repro_torch.models.config import smoke_config
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.engine import Request, ServingEngine

RTOL, ATOL = 1e-4, 1e-5
#: the least top-2 gap a compared greedy decision may have
MIN_GAP = 1e-3
#: prompt lengths: at most and over the smoke attn_chunk_q (8), which is
#: also gemma3's smoke window
PROMPT_LENS = (6, 13)


def make_pair(arch: str, **overrides):
    """(reference cfg, reference params, port cfg, port params) of
    ``arch``'s smoke config with ``overrides`` on both sides."""
    ref_cfg = dataclasses.replace(ref_smoke_config(ref_get_config(arch)),
                                  **overrides)
    cfg = dataclasses.replace(smoke_config(get_config(arch)), **overrides)
    ref_params = ref_tfm.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    return ref_cfg, ref_params, cfg, params


def tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def prefix(cfg, batch: int, seed: int = 7):
    """A (B, P, frontend_dim) prefix from a numpy seed, or None."""
    if not cfg.frontend:
        return None
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.frontend_prefix_len, cfg.frontend_dim)).astype(
        np.float32)


def close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want), rtol=RTOL, atol=ATOL)


def _both(pre):
    return ((None, None) if pre is None
            else (torch.from_numpy(pre), jnp.asarray(pre)))


def check_configs(arch: str):
    assert get_config(arch).__dict__ == ref_get_config(arch).__dict__
    assert smoke_config(get_config(arch)).__dict__ == \
        ref_smoke_config(ref_get_config(arch)).__dict__


def check_forward(pair, with_prefix: bool):
    ref_cfg, ref_params, cfg, params = pair
    toks = tokens(0, (2, 13), cfg.vocab_size)
    pre, ref_pre = _both(prefix(cfg, 2) if with_prefix else None)
    got, aux = tfm.forward(params, cfg, torch.from_numpy(toks), pre)
    want, ref_aux = ref_tfm.forward(ref_params, ref_cfg, jnp.asarray(toks),
                                    ref_pre)
    assert tuple(got.shape) == (2, 13, cfg.vocab_size)
    close(got, want)
    assert abs(float(aux) - float(ref_aux)) <= 1e-6
    return float(aux)


def check_prefill_and_decode(pair, s: int, with_prefix: bool):
    ref_cfg, ref_params, cfg, params = pair
    toks = tokens(s, (2, s), cfg.vocab_size)
    pre, ref_pre = _both(prefix(cfg, 2) if with_prefix else None)
    got, state = tfm.prefill(params, cfg, torch.from_numpy(toks), 32, pre)
    want, ref_state = ref_tfm.prefill(ref_params, ref_cfg, jnp.asarray(toks),
                                      32, ref_pre)
    close(got, want)
    np.testing.assert_array_equal(state["index"].numpy(),
                                  np.asarray(ref_state["index"]))
    for step in range(3):
        tok = tokens(100 + step, (2, 1), cfg.vocab_size)
        got, state = tfm.decode_step(params, cfg, torch.from_numpy(tok),
                                     state)
        want, ref_state = ref_tfm.decode_step(ref_params, ref_cfg,
                                              jnp.asarray(tok), ref_state)
        close(got, want)
    return state


def _requests(cfg, cls):
    rng = np.random.default_rng(0)
    return [cls(uid=i, prompt=rng.integers(2, cfg.vocab_size, n,
                                           dtype=np.int32),
                max_new_tokens=5) for i, n in enumerate((5, 11, 7, 13, 9))]


def check_engine(pair, monkeypatch, batch: int = 4):
    """Both engines serve the same requests to the same tokens; every
    decision of the port's engine (its prefill and tick logits, recorded
    as served, with the batch's other slots beside it) had a clear
    winner."""
    ref_cfg, ref_params, cfg, params = pair
    ref_done = RefEngine(ref_cfg, ref_params, batch=batch,
                         max_seq=32).serve(_requests(ref_cfg, RefRequest))
    gaps = []
    orig_prefill, orig_decode = tfm.prefill, tfm.decode_step

    def gap(logits):
        top = torch.topk(logits[:, -1].float(), 2, dim=-1).values
        return (top[:, 0] - top[:, 1]).numpy()

    def prefill(*args, **kwargs):
        logits, state = orig_prefill(*args, **kwargs)
        gaps.append(gap(logits))
        return logits, state

    def decode_step(*args, **kwargs):
        logits, state = orig_decode(*args, **kwargs)
        live = [i for i, r in enumerate(engine.slot_req) if r is not None]
        gaps.append(gap(logits)[live])      # idle slots decide nothing
        return logits, state

    monkeypatch.setattr(tfm, "prefill", prefill)
    monkeypatch.setattr(tfm, "decode_step", decode_step)
    engine = ServingEngine(cfg, params, batch=batch, max_seq=32,
                           device="cpu")
    done = engine.serve(_requests(cfg, Request))
    assert sorted(r.uid for r in done) == sorted(r.uid for r in ref_done)
    want = {r.uid: np.asarray(r.output).tolist() for r in ref_done}
    for r in done:
        assert r.output.tolist() == want[r.uid], r.uid
    decided = np.concatenate(gaps)
    assert len(decided) == sum(len(r.output) for r in done)
    assert np.all(decided > MIN_GAP), decided
    return done
