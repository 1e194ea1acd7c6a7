"""Port parity: the single-MLP chain ``fused_mlp`` on the CPU.

On CPU tensors the wrapper computes its plain version (the CUDA kernel is
held against that version on the card, in ``test_torch_kernels_cuda.py``).
Here the plain chain meets the reference's Pallas kernel in interpret mode
and its jnp oracle at the reference's own test shapes (atol 1e-4, as
``tests/test_kernels.py`` holds the kernel), and a trained predictor
served through it meets ``TrainedMLP.predict_ms`` (rtol 1e-4, the
reference's ``test_fused_mlp_serves_trained_predictor`` rule)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.core import dataset as pt_dataset
from repro_torch.core import mlp as pt_mlp
from repro_torch.kernels import fused_mlp as fm


def _chain(bsz, hidden, layers, seed=0):
    rng = np.random.default_rng(seed)
    ws = (rng.standard_normal((layers, hidden, hidden)) * 0.2).astype(
        np.float32)
    bs = (rng.standard_normal((layers, hidden)) * 0.1).astype(np.float32)
    x = rng.standard_normal((bsz, hidden)).astype(np.float32)
    return x, ws, bs


@pytest.mark.parametrize("impl", ["interpret", "jnp"])
@pytest.mark.parametrize("bsz,hidden,layers", [(8, 64, 3), (37, 128, 4),
                                               (256, 64, 9)])
def test_plain_matches_reference_kernel(bsz, hidden, layers, impl):
    x, ws, bs = _chain(bsz, hidden, layers)
    want = np.asarray(ref_ops.fused_mlp(jnp.asarray(x), jnp.asarray(ws),
                                        jnp.asarray(bs), impl=impl))
    got = fm.fused_mlp(*map(torch.from_numpy, (x, ws, bs)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (bsz,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    x, ws, bs = map(torch.from_numpy, _chain(19, 32, 3, seed=1))
    before = dict(fm.LAUNCHES)
    assert torch.equal(fm.fused_mlp(x, ws, bs), fm.fused_mlp_plain(x, ws, bs))
    assert fm.LAUNCHES == before


def test_wrapper_shape_contract():
    x, ws, bs = map(torch.from_numpy, _chain(4, 16, 2))
    with pytest.raises(ValueError, match=r"\(B, H\)"):
        fm.fused_mlp(x[0], ws, bs)
    with pytest.raises(ValueError, match="weights shape"):
        fm.fused_mlp(x, ws[:, :8], bs)
    with pytest.raises(ValueError, match="biases shape"):
        fm.fused_mlp(x, ws, bs[:1])


@pytest.fixture(scope="module")
def trained():
    ds = pt_dataset.build_dataset("bmm", 150, device_names=["T4"])
    cfg = pt_mlp.MLPConfig(hidden_layers=2, hidden_size=64, epochs=3)
    return ds, pt_mlp.train(ds, cfg, device="cpu")


@pytest.mark.parametrize("rows", [1, 16, 37])
def test_serves_port_trained_predictor(trained, rows):
    """Normalize, pad to H, chain, ms — as the reference serves a trained
    MLP through its kernel — equals ``predict_ms`` at rtol 1e-4."""
    ds, model = trained
    w, b = fm.pack_trained(model, "cpu")
    assert tuple(w.shape) == (3, 64, 64) and tuple(b.shape) == (3, 64)
    got = fm.serve_trained(model, torch.as_tensor(ds.x[:rows]), w, b)
    np.testing.assert_allclose(got.numpy(),
                               model.predict_ms(ds.x[:rows], device="cpu"),
                               rtol=1e-4)


def test_pack_trained_pads_to_the_wider_of_input_and_hidden():
    ds = pt_dataset.build_dataset("linear", 20, device_names=["T4"])
    model = pt_mlp.train(ds, pt_mlp.MLPConfig(hidden_layers=1, hidden_size=6,
                                              epochs=1), device="cpu")
    w, b = fm.pack_trained(model, "cpu")
    assert tuple(w.shape) == (2, 16, 16)        # 13 inputs -> 16
    np.testing.assert_allclose(
        fm.serve_trained(model, torch.as_tensor(ds.x), w, b).numpy(),
        model.predict_ms(ds.x, device="cpu"), rtol=1e-4)
