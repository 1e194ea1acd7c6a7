"""Port parity: the SSD scan (kernel 2's plain version) and the Mamba2
block against the reference.

On the CPU the port's ``ssd`` wrapper computes its plain version (the
sequential recurrence, with the final state), so these tests hold it
against the reference's Pallas kernel in interpret mode, its jnp oracle
and, for the state, the reference's ``ssd_chunked(..., return_final=
True)``.  The model's functions are held against ``repro.models.ssm``
with the reference's weights carried by ``params_from_jax``.  Inputs come
from one numpy seed and are fp32.  Tolerance atol 2e-4 on O(1)-O(10)
outputs: a sequential scan against a chunked one sums in another order
(the reference holds its own kernel to its oracle at 2e-3).  The CUDA
kernel itself is held against the plain version on the card
(``test_torch_kernels_cuda.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels import ops as ref_ops
from repro.kernels.ssd_ref import ssd_ref
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_tfm
from repro.models.config import smoke_config as ref_smoke_config
from repro_torch.configs import get_config
from repro_torch.kernels import ssd as ssd_k
from repro_torch.models import ssm
from repro_torch.models.config import smoke_config
from repro_torch.models.convert import params_from_jax

ATOL = 2e-4

# b, h, l, p, n, chunk (the Pallas kernel's chunk): L off the chunk, both
# state sizes of the card phase (N = 64, 128) at P = 64, and small ones
CASES = [
    (1, 2, 64, 16, 32, 16),
    (2, 3, 100, 32, 16, 32),
    (1, 2, 70, 64, 128, 32),
    (1, 1, 45, 64, 64, 16),
]


def _inputs(case, seed=0):
    b, h, l, p, n, _ = case
    rng = np.random.default_rng(seed + sum(case))
    x = (rng.standard_normal((b, h, l, p)) * 0.5).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (b, h, l)).astype(np.float32)
    a = -rng.uniform(0.5, 4.0, (h,)).astype(np.float32)
    bm = (rng.standard_normal((b, h, l, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, h, l, n)) * 0.5).astype(np.float32)
    return x, dt, a, bm, cm


@pytest.mark.parametrize("case", CASES)
def test_ssd_plain_matches_reference_kernel_oracle_and_state(case):
    x, dt, a, bm, cm = _inputs(case)
    before = dict(ssd_k.LAUNCHES)
    y, state = ssd_k.ssd(*map(torch.from_numpy, (x, dt, a, bm, cm)),
                         chunk=16)
    assert ssd_k.LAUNCHES == before   # CPU tensors never reach the kernel
    j = tuple(map(jnp.asarray, (x, dt, a, bm, cm)))
    interp = ref_ops.ssd(*j, chunk=case[-1], impl="interpret")
    np.testing.assert_allclose(y.numpy(), np.asarray(interp), atol=ATOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(ssd_ref(*j)),
                               atol=ATOL)
    # the final state: the reference model's chunked scan, (B, L, H, *)
    _, s_final = ref_ssm.ssd_chunked(
        j[0].transpose(0, 2, 1, 3), j[1].transpose(0, 2, 1), j[2],
        j[3].transpose(0, 2, 1, 3), j[4].transpose(0, 2, 1, 3),
        chunk=case[-1], return_final=True)
    np.testing.assert_allclose(state.numpy(), np.asarray(s_final),
                               atol=ATOL)


def _model_inputs(seed=3, bs=2, l=37, h=4, p=16, n=8):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((bs, l, h, p)) * 0.5).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (bs, l, h)).astype(np.float32)
    a = -rng.uniform(0.5, 4.0, (h,)).astype(np.float32)
    b = (rng.standard_normal((bs, l, 1, n)) * 0.5).astype(np.float32)
    c = (rng.standard_normal((bs, l, 1, n)) * 0.5).astype(np.float32)
    d = rng.uniform(0.5, 1.5, (h,)).astype(np.float32)
    return x, dt, a, b, c, d


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_chunked_with_skip_and_state_matches_reference(chunk):
    args = _model_inputs()
    y, s = ssm.ssd_chunked(*map(torch.from_numpy, args), chunk=chunk,
                           return_final=True)
    ry, rs = ref_ssm.ssd_chunked(*map(jnp.asarray, args), chunk=chunk,
                                 return_final=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=ATOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), atol=ATOL)


def test_ssd_reference_matches_reference():
    args = _model_inputs(seed=4)
    got = ssm.ssd_reference(*map(torch.from_numpy, args))
    want = ref_ssm.ssd_reference(*map(jnp.asarray, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.fixture(scope="module")
def mamba():
    """The smoke Mamba2's first layer in both packages, same weights."""
    ref_cfg = ref_smoke_config(ref_get_config("mamba2-130m"))
    cfg = smoke_config(get_config("mamba2-130m"))
    ref_params = ref_tfm.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    ref_layer = jax.tree.map(lambda t: t[0], ref_params["layers"]["mamba"])
    return ref_cfg, cfg, ref_layer, params.layers[0]


def test_mamba_block_and_state_match_reference(mamba):
    ref_cfg, cfg, ref_layer, layer = mamba
    x = (np.random.default_rng(5).standard_normal((2, 21, cfg.d_model))
         * 0.5).astype(np.float32)
    out, st = ssm.mamba_block(layer, torch.from_numpy(x), cfg,
                              return_state=True)
    ref_out, ref_st = ref_ssm.mamba_block(ref_layer, jnp.asarray(x), ref_cfg,
                                          return_state=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=ATOL)
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(st[key].numpy(), np.asarray(ref_st[key]),
                                   atol=ATOL)


def test_mamba_decode_step_matches_reference(mamba):
    """Prefill a prompt, then three single-token steps from its state."""
    ref_cfg, cfg, ref_layer, layer = mamba
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, 9, cfg.d_model)) * 0.5).astype(np.float32)
    _, st = ssm.mamba_block(layer, torch.from_numpy(x), cfg,
                            return_state=True)
    _, ref_st = ref_ssm.mamba_block(ref_layer, jnp.asarray(x), ref_cfg,
                                    return_state=True)
    for _ in range(3):
        tok = (rng.standard_normal((2, 1, cfg.d_model)) * 0.5).astype(
            np.float32)
        out, st = ssm.mamba_decode_step(layer, torch.from_numpy(tok), st,
                                        cfg)
        ref_out, ref_st = ref_ssm.mamba_decode_step(ref_layer,
                                                    jnp.asarray(tok), ref_st,
                                                    ref_cfg)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                                   atol=ATOL)
        np.testing.assert_allclose(st["ssm"].numpy(),
                                   np.asarray(ref_st["ssm"]), atol=ATOL)


def test_ssd_wrapper_rejects_bad_shapes_and_chunks():
    x, dt, a, bm, cm = map(torch.from_numpy, _inputs(CASES[0]))
    with pytest.raises(ValueError, match="chunk"):
        ssd_k.ssd(x, dt, a, bm, cm, chunk=ssd_k.MAX_CHUNK + 1)
    with pytest.raises(ValueError, match="dt"):
        ssd_k.ssd(x, dt[:, :, 1:], a, bm, cm)
