"""Port parity: the LM serving path (model, engine, launcher) against the
reference, for Qwen3 and Mamba2 at their smoke configs, and the launcher
for every arch (the other archs' parity cases are in
``test_torch_{moe,zoo_dense,zoo_hybrid}.py``).

The reference's parameters (``init_params(cfg, PRNGKey(0))``) are carried
into the port by ``params_from_jax``, so both packages compute the same
function; on the CPU the port's kernels compute their plain versions.
Logits are held at rtol 1e-4 (atol 1e-5): fp32 throughout, with the
attention and the SSD scan summed in another order (flash-style softmax
and a sequential scan against the reference's dense and chunked forms).
Greedy tokens are held equal, and every decision's top-2 logit gap is
asserted to be far above that tolerance, so the equality is not luck."""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tfm
from repro.models.config import smoke_config as ref_smoke_config
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServingEngine as RefEngine
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.models.config import smoke_config
from repro_torch.models.convert import params_from_jax
from repro_torch.serve.engine import Request, ServingEngine

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5
#: the least top-2 gap a compared greedy decision may have
MIN_GAP = 1e-3


@pytest.fixture(scope="module", params=["qwen3-0.6b", "mamba2-130m"])
def pair(request):
    """(reference cfg, reference params, port cfg, port params)."""
    ref_cfg = ref_smoke_config(ref_get_config(request.param))
    cfg = smoke_config(get_config(request.param))
    ref_params = ref_tfm.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    return ref_cfg, ref_params, cfg, params


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_configs_match_reference():
    for arch in ARCHS:
        assert get_config(arch).__dict__ == ref_get_config(arch).__dict__
        assert smoke_config(get_config(arch)).__dict__ == \
            ref_smoke_config(ref_get_config(arch)).__dict__


@pytest.mark.parametrize("head_dim,theta", [(16, 1e4), (128, 1e6)])
def test_rope_frequencies_match_reference(head_dim, theta):
    want = ref_layers.rope_frequencies(head_dim, theta).astype(np.float32)
    np.testing.assert_array_equal(
        layers.rope_frequencies(head_dim, theta).numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_on_one_row_of_positions(dtype):
    """``apply_rope`` on the forward's and the prefill's positions, (1, S)
    broadcast over the batch (``transformer._positions``), is bitwise the
    rope of the same positions given a row a sequence, (B, S), and in
    fp32 within the LM tolerance of the reference's rope on (B, S)."""
    b, s, h, hd, theta = 3, 37, 4, 16, 1e4
    x = np.random.default_rng(0).standard_normal((b, s, h, hd)).astype(
        np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    one = tfm._positions(s, "cpu")
    assert tuple(one.shape) == (1, s)
    got = layers.apply_rope(xt, one, theta)
    rows = torch.arange(s)[None, :].expand(b, s)
    assert torch.equal(got, layers.apply_rope(xt, rows, theta))
    if dtype == "float32":
        _close(got, ref_layers.apply_rope(
            jnp.asarray(x), jnp.broadcast_to(jnp.arange(s)[None, :],
                                             (b, s)), theta))


def test_forward_matches_reference(pair):
    ref_cfg, ref_params, cfg, params = pair
    toks = _tokens(0, (2, 13), cfg.vocab_size)
    got, _ = tfm.forward(params, cfg, torch.from_numpy(toks))
    want, _ = ref_tfm.forward(ref_params, ref_cfg, jnp.asarray(toks))
    _close(got, want)


@pytest.mark.parametrize("s", [6, 13])   # <= and > the smoke attn_chunk_q
def test_prefill_and_decode_match_reference(pair, s):
    ref_cfg, ref_params, cfg, params = pair
    assert (s > cfg.attn_chunk_q) == (s == 13)
    toks = _tokens(s, (2, s), cfg.vocab_size)
    got, state = tfm.prefill(params, cfg, torch.from_numpy(toks), 24)
    want, ref_state = ref_tfm.prefill(ref_params, ref_cfg, jnp.asarray(toks),
                                      24)
    _close(got, want)
    np.testing.assert_array_equal(state["index"].numpy(),
                                  np.asarray(ref_state["index"]))
    for step in range(3):
        tok = _tokens(100 + step, (2, 1), cfg.vocab_size)
        got, state = tfm.decode_step(params, cfg, torch.from_numpy(tok),
                                     state)
        want, ref_state = ref_tfm.decode_step(ref_params, ref_cfg,
                                              jnp.asarray(tok), ref_state)
        _close(got, want)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-130m"])
def test_bf16_distance_from_fp32_is_the_models(arch):
    """At the published dtypes (bf16) each package's smoke model lies some
    distance from the same weights in fp32; the port's distance is of the
    reference's size, so a bf16 gap on the card (about a logit for the
    random Mamba2-130M) belongs to the model, not to the port.  The two
    round in another order, so their distances are alike, not equal:
    within a factor of 3."""
    full = ref_get_config(arch)
    dtypes = dict(param_dtype=full.param_dtype, act_dtype=full.act_dtype)
    fp32 = dict(param_dtype="float32", act_dtype="float32")
    ref16 = dataclasses.replace(ref_smoke_config(full), **dtypes)
    cfg16 = dataclasses.replace(smoke_config(get_config(arch)), **dtypes)
    assert cfg16.param_dtype == "bfloat16"
    p16 = ref_tfm.init_params(ref16, jax.random.PRNGKey(0))
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32)
                       if a.dtype == jnp.bfloat16 else a, p16)
    toks = _tokens(0, (4, 32), cfg16.vocab_size)

    def ref_logits(cfg, params):
        return np.asarray(ref_tfm.forward(params, cfg, jnp.asarray(toks))[0],
                          np.float32)

    def port_logits(cfg, params):
        port = params_from_jax(cfg, jax.tree.map(np.asarray, params),
                               device="cpu")
        return tfm.forward(port, cfg, torch.from_numpy(toks))[0].float() \
            .numpy()

    truth = ref_logits(dataclasses.replace(ref16, **fp32), p32)
    scale = max(1.0, float(np.abs(truth).max()))
    ref_d = float(np.abs(ref_logits(ref16, p16) - truth).max()) / scale
    port_d = float(np.abs(
        port_logits(cfg16, p16)
        - port_logits(dataclasses.replace(cfg16, **fp32), p32)).max()) / scale
    assert ref_d > 1e-3, ref_d          # bf16 really rounded something
    assert ref_d / 3 <= port_d <= 3 * ref_d, (ref_d, port_d)


def _requests(arch, cfg, cls):
    """The requests of the reference's own engine tests (test_system.py)."""
    if arch == "qwen3-0.6b":
        rng = np.random.default_rng(0)
        return 4, [cls(uid=i, prompt=rng.integers(2, cfg.vocab_size, 5,
                                                  dtype=np.int32),
                       max_new_tokens=5) for i in range(6)]
    return 2, [cls(uid=i, prompt=np.arange(4, dtype=np.int32) + 2,
                   max_new_tokens=4) for i in range(3)]


def test_engine_serves_the_reference_tokens(pair):
    ref_cfg, ref_params, cfg, params = pair
    batch, ref_reqs = _requests(cfg.name, ref_cfg, RefRequest)
    _, reqs = _requests(cfg.name, cfg, Request)
    ref_done = RefEngine(ref_cfg, ref_params, batch=batch,
                         max_seq=32).serve(ref_reqs)
    done = ServingEngine(cfg, params, batch=batch, max_seq=32,
                         device="cpu").serve(reqs)
    assert sorted(r.uid for r in done) == sorted(r.uid for r in ref_done)
    want = {r.uid: np.asarray(r.output).tolist() for r in ref_done}
    for r in done:
        assert r.output.tolist() == want[r.uid], r.uid
        # every greedy decision had a clear winner in the reference
        seq = np.concatenate([r.prompt, r.output[:-1]])[None, :]
        logits, _ = ref_tfm.forward(ref_params, ref_cfg, jnp.asarray(seq))
        tail = np.sort(np.asarray(logits)[0, len(r.prompt) - 1:], axis=-1)
        assert np.all(tail[:, -1] - tail[:, -2] > MIN_GAP), r.uid


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_on_cpu(arch):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--smoke", "--arch", arch, "--requests", "3", "--batch", "2",
         "--max-seq", "32", "--prompt-len", "5", "--max-new", "3"],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    assert re.search(r"served 3/3 requests, \d+ tokens in", proc.stdout)
    assert len(re.findall(r"  req \d+: \[", proc.stdout)) == 3


def test_unknown_archs_and_families_are_refused():
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")
    odd = dataclasses.replace(smoke_config(get_config("qwen3-0.6b")),
                              family="diffusion")
    with pytest.raises(NotImplementedError, match="diffusion"):
        tfm.init_params(odd, device="cpu")
    with pytest.raises(NotImplementedError, match="diffusion"):
        tfm.init_decode_state(odd, 1, 8, device="cpu")


def test_engine_refuses_params_on_another_device(pair):
    _, _, cfg, params = pair
    with pytest.raises((RuntimeError, ValueError)):
        ServingEngine(cfg, params, batch=1, max_seq=8)   # default: cuda
