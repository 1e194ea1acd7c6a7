"""The port's Hopper kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without an sm_90 GPU (the kernels have
no CPU mode).  This file imports neither JAX nor the reference package,
so it runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerance: max |kernel - plain| <= 1e-4 * max(1, max |plain|) — fp32
sums over long dot products in another order (across the layers, the
softmax, the chunks) — except flash attention's bfloat16 output, held to
8e-3 * max(1, max |plain|): about two bf16 ulps, since kernel and plain
round their fp32 results to bf16 separately."""

import numpy as np
import pytest
import torch

from repro_torch.core import batched, devices, dataset, mlp
from repro_torch.core.predictor import HabitatPredictor
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_mlp as fm
from repro_torch.kernels import fused_mlp_score as fms
from repro_torch.kernels import ssd as ssd_k


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


def _close(got, want, rel=1e-4):
    torch.cuda.synchronize()
    want = want.float()
    tol = rel * max(1.0, want.abs().max().item())
    err = (got.float() - want).abs().max().item()
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


# b, h, kv, sq, skv, d, causal, window: GQA rep 1, 2 and 4, both head
# dims of the zoo, Sq and Skv off the 64-row tiles, a window that starts
# inside a tile, and a window wider than the sequence
FLASH_CASES = [
    (1, 16, 8, 300, 300, 128, True, 0),
    (2, 4, 4, 130, 130, 64, True, 0),
    (1, 8, 2, 200, 200, 64, True, 37),
    (1, 4, 1, 777, 777, 128, True, 256),
    (2, 4, 2, 70, 150, 64, False, 0),
    (1, 4, 2, 100, 100, 128, False, 33),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(sm90, case, dtype):
    b, h, kv, sq, skv, d, causal, window = case
    gen = torch.Generator(device=sm90).manual_seed(sum(case[:6]))
    q, k, v = (torch.randn((b, n, s_, d), generator=gen, device=sm90)
               .to(dtype) for n, s_ in ((h, sq), (kv, skv), (kv, skv)))
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (b, h, sq, d)
    _close(got, fa.flash_attention_plain(q, k, v, causal, window),
           rel=8e-3 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.cuda
def test_flash_attention_kernel_reads_model_layout_views(sm90):
    """(B, S, H, D) activations go in as permuted views, no copy."""
    gen = torch.Generator(device=sm90).manual_seed(3)
    q = torch.randn((2, 190, 8, 64), generator=gen, device=sm90)
    k = torch.randn((2, 190, 4, 64), generator=gen, device=sm90)
    v = torch.randn((2, 190, 4, 64), generator=gen, device=sm90)
    views = [t.permute(0, 2, 1, 3) for t in (q, k, v)]
    got = fa.flash_attention(*views, causal=True, window=50)
    want = fa.flash_attention_plain(*[t.contiguous() for t in views],
                                    True, 50)
    _close(got, want)


# b, h, l, p, n, chunk: L off the chunk, both state sizes, a short chunk
SSD_CASES = [
    (1, 3, 200, 64, 128, 64),
    (2, 2, 130, 64, 64, 64),
    (1, 2, 77, 64, 128, 16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_kernel_matches_plain(sm90, case, dtype):
    b, h, l, p, n, chunk = case
    gen = torch.Generator(device=sm90).manual_seed(sum(case))
    x = torch.randn((b, h, l, p), generator=gen, device=sm90).to(dtype)
    dt = 0.01 + 0.19 * torch.rand((b, h, l), generator=gen, device=sm90)
    a = -(0.5 + 3.5 * torch.rand((h,), generator=gen, device=sm90))
    # one group shared by every head: an expanded view, head stride 0
    bm = torch.randn((b, 1, l, n), generator=gen,
                     device=sm90).to(dtype).expand(b, h, l, n)
    cm = torch.randn((b, 1, l, n), generator=gen,
                     device=sm90).to(dtype).expand(b, h, l, n)
    before = ssd_k.LAUNCHES["ssd"]
    y, state = ssd_k.ssd(x, dt, a, bm, cm, chunk=chunk)
    assert ssd_k.LAUNCHES["ssd"] == before + 1
    want_y, want_state = ssd_k.ssd_plain(x, dt, a, bm, cm)
    _close(y, want_y)
    _close(state, want_state)


@pytest.mark.cuda
def test_new_wrappers_refuse_what_the_kernels_do_not_take(sm90):
    q = torch.zeros((1, 4, 8, 48), device=sm90)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), q.half(), q.half())
    x = torch.zeros((1, 2, 8, 64), device=sm90)
    dt = torch.zeros((1, 2, 8), device=sm90)
    bm = torch.zeros((1, 2, 8, 16), device=sm90)
    with pytest.raises(ValueError, match="chunk"):
        ssd_k.ssd(x, dt, -torch.ones(2, device=sm90), bm, bm, chunk=128)
    with pytest.raises(TypeError):
        ssd_k.ssd(x, dt.double(), -torch.ones(2, device=sm90), bm, bm)


# (L, H) of fused_mlp: the reference's test shapes, the default predictor's
# (4, 256) and the paper's (9, 1024); rows ragged and whole
FUSED_MLP_SHAPES = [(3, 64), (4, 128), (9, 64), (4, 256), (9, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 37, 256, 6000])
@pytest.mark.parametrize("shape", FUSED_MLP_SHAPES)
def test_fused_mlp_kernel_matches_plain(sm90, shape, rows):
    nl, h = shape
    w, b = _stack(nl + h, 1, nl, h, sm90)
    w, b = w[0].contiguous(), b[0].contiguous()
    x = torch.from_numpy(np.random.default_rng(rows).standard_normal(
        (rows, h)).astype(np.float32)).to(sm90)
    before = fm.LAUNCHES["fused_mlp"]
    got = fm.fused_mlp(x, w, b)
    assert fm.LAUNCHES["fused_mlp"] == before + 1
    assert tuple(got.shape) == (rows,)
    _close(got, fm.fused_mlp_plain(x, w, b))


@pytest.mark.cuda
def test_fused_mlp_refuses_what_the_kernel_does_not_take(sm90):
    w, b = _stack(2, 1, 2, 64, sm90)
    w, b = w[0].contiguous(), b[0].contiguous()
    x = torch.zeros((40, 64), device=sm90)
    before = fm.LAUNCHES["fused_mlp"]
    with pytest.raises(TypeError):
        fm.fused_mlp(x.double(), w, b)
    with pytest.raises(ValueError, match="contiguous"):
        fm.fused_mlp(torch.zeros((64, 40), device=sm90).t(), w, b)
    big_w, big_b = _stack(2, 1, 2, 2048, sm90)
    with pytest.raises(ValueError, match="up to 1024"):
        fm.fused_mlp(torch.zeros((40, 2048), device=sm90), big_w[0],
                     big_b[0])
    assert fm.LAUNCHES["fused_mlp"] == before


@pytest.mark.cuda
def test_scalar_paths_score_on_the_card(sm90):
    """``predict_trace_scalar`` and ``predict_op_ms`` of a ``cuda``
    predictor run the MLP on the card (its stack lives there, none on the
    CPU) and agree with the same MLPs on a CPU predictor."""
    cfg = mlp.MLPConfig(in_features=13, hidden_layers=2, hidden_size=64)
    rng = np.random.default_rng(3)
    sizes = [13, 64, 64, 1]
    params = [(rng.standard_normal((a, c)).astype(np.float32)
               * np.float32(np.sqrt(2.0 / a)), np.zeros(c, np.float32))
              for a, c in zip(sizes[:-1], sizes[1:])]
    norm = dataset.build_dataset("linear", 30).normalized()
    on_card = mlp.TrainedMLP.from_numpy("linear", cfg, params,
                                        norm.feature_mean, norm.feature_std)
    on_host = mlp.TrainedMLP.from_numpy("linear", cfg, params,
                                        norm.feature_mean, norm.feature_std)
    from repro_torch.core.trace import TrackedTrace
    trace = TrackedTrace(ops=dataset.sample_ops("linear", 8, seed=1),
                         origin_device="T4", label="t").measure()
    pred = HabitatPredictor({"linear": on_card}, device=sm90)
    cpu = HabitatPredictor({"linear": on_host}, device="cpu")
    got = pred.predict_trace_scalar(trace, "V100").run_time_ms
    one = pred.predict_op_ms(trace.ops[0], devices.get("T4"),
                             devices.get("V100"))
    keys = list(on_card._on_device)
    assert any(k.startswith("cuda") for k in keys) and "cpu" not in keys
    assert got == pytest.approx(
        cpu.predict_trace_scalar(trace, "V100").run_time_ms, rel=1e-4)
    assert one == pytest.approx(cpu.predict_op_ms(
        trace.ops[0], devices.get("T4"), devices.get("V100")), rel=1e-4)
