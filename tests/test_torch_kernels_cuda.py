"""The port's Hopper kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without an sm_90 GPU (the kernels have
no CPU mode).  This file imports neither JAX nor the reference package,
so it runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerance: max |kernel - plain| <= 1e-4 * max(1, max |plain|) — fp32
sums over long dot products in another order, across the layers."""

import numpy as np
import pytest
import torch

from repro_torch.core import batched, devices, dataset, mlp
from repro_torch.core.predictor import HabitatPredictor
from repro_torch.kernels import fused_mlp_score as fms


@pytest.fixture
def sm90():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90); the kernels have no CPU mode")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


def _stack(seed, k, l, h, device):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, l, h, h)) * np.sqrt(2.0 / h)).astype(
        np.float32)
    b = (rng.standard_normal((k, l, h)) * 0.1).astype(np.float32)
    return torch.from_numpy(w).to(device), torch.from_numpy(b).to(device)


def _close(got, want):
    torch.cuda.synchronize()
    tol = 1e-4 * max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    assert err <= tol, (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [32, 256, 1024])
def test_block_kernel_matches_plain(sm90, h):
    w, b = _stack(4, 4, 3, h, sm90)
    rng = np.random.default_rng(5)
    kinds = torch.tensor([0, 0, 3, 1, 2, 2], dtype=torch.int32,
                         device=sm90)
    x = torch.from_numpy(rng.standard_normal((6 * 128, h)).astype(
        np.float32)).to(sm90)
    before = fms.LAUNCHES["fused_mlp_score"]
    got = fms.fused_mlp_score(x, kinds, w, b, block_m=128)
    assert fms.LAUNCHES["fused_mlp_score"] == before + 1
    _close(got, fms.fused_mlp_score_plain(x, kinds, w, b))


@pytest.mark.cuda
@pytest.mark.parametrize("h", [32, 256, 1024])
def test_rows_kernel_matches_plain(sm90, h):
    w, b = _stack(6, 4, 3, h, sm90)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((3 * 128, h)).astype(
        np.float32)).to(sm90)
    kinds = torch.from_numpy(rng.integers(0, 4, 3 * 128).astype(
        np.int32)).to(sm90)
    before = fms.LAUNCHES["fused_mlp_score_rows"]
    got = fms.fused_mlp_score_rows(x, kinds, w, b, block_m=128)
    assert fms.LAUNCHES["fused_mlp_score_rows"] == before + 1
    _close(got, fms.fused_mlp_score_rows_plain(x, kinds, w, b))


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(sm90):
    w, b = _stack(1, 2, 2, 32, sm90)
    x = torch.zeros((128, 32), device=sm90)
    kinds = torch.zeros(1, dtype=torch.int32, device=sm90)
    with pytest.raises(TypeError):
        fms.fused_mlp_score(x.double(), kinds, w, b)
    with pytest.raises(ValueError, match="contiguous"):
        fms.fused_mlp_score(torch.zeros((32, 128), device=sm90).t(),
                            kinds, w, b)
    with pytest.raises(ValueError, match="multiple of 4"):
        fms.fused_mlp_score(torch.zeros((128, 2048), device=sm90), kinds,
                            *_stack(1, 2, 2, 2048, sm90))


@pytest.mark.cuda
def test_masked_sweep_launches_the_row_kernel_once(sm90):
    """The engine on the card: a cold sweep is one block-kernel launch, a
    cell-masked sweep one row-kernel launch, and both agree with the
    plain scorer."""
    cfg = mlp.MLPConfig(in_features=13, hidden_layers=2, hidden_size=64)
    rng = np.random.default_rng(0)
    mlps = {}
    for kind in ("bmm", "conv2d", "linear", "recurrent"):
        sizes = [13, 64, 64, 1]
        params = [(rng.standard_normal((a, c)).astype(np.float32)
                   * np.float32(np.sqrt(2.0 / a)), np.zeros(c, np.float32))
                  for a, c in zip(sizes[:-1], sizes[1:])]
        norm = dataset.build_dataset(kind, 30).normalized()
        mlps[kind] = mlp.TrainedMLP.from_numpy(
            kind, cfg, params, norm.feature_mean, norm.feature_std)
    from repro_torch.core.trace import TrackedTrace
    traces = []
    for i in range(4):
        ops = []
        for k, kind in enumerate(sorted(mlps)):
            ops += dataset.sample_ops(kind, 6, seed=10 * i + k)
        traces.append(TrackedTrace(ops=ops, origin_device="T4",
                                   label=f"t{i}").measure())
    devs = sorted(devices.all_devices())
    mask = rng.random((4, len(devs))) < 0.5
    mask[:, 0] = True
    pred = HabitatPredictor(mlps, device=sm90)
    plain = HabitatPredictor(mlps, device=sm90, sweep_scorer="plain")
    fms.reset_launches()
    full = pred.predict_sweep(traces, devs)
    masked = pred.predict_sweep(traces, devs, cell_mask=mask)
    assert fms.LAUNCHES == {"fused_mlp_score": 1,
                            "fused_mlp_score_rows": 1}
    want = plain.predict_sweep(traces, devs).total_ms
    np.testing.assert_allclose(full.total_ms, want, rtol=1e-4)
    np.testing.assert_allclose(masked.total_ms[mask], want[mask], rtol=1e-4)
    assert batched.SCORER_DISPATCHES.snapshot()["fused"] >= 2
