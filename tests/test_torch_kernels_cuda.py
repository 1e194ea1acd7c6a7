"""The port's Hopper kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without an sm_90 GPU (the kernels have
no CPU mode).  This file imports neither JAX nor the reference package,
so it runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerance: max |kernel - plain| <= 1e-4 * max(1, max |plain|) — fp32
sums over long dot products in another order (across the layers, the
softmax, the chunks) — except flash attention, held row by row: each
output row within rel * max(max |plain row|, 1e-3), rel 1e-4 in fp32 and
8e-3 in bfloat16 (about two bf16 ulps of the row, since kernel and plain
round their fp32 results to bf16 separately).  Per row, because a long
causal row averages to a few hundredths while row 0 is v_0: a tolerance
from the whole tensor's max would let a dropped late tile pass.  The
flash-attention and SSD ops' gradients (their PyTorch VJP backward) are
held in fp32 against the plain versions' autograd gradients, within 1e-4
of each gradient's largest element."""

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


def _close_rows(got, want, rel):
    """Flash attention's gate, every row (b, h, s) on its own scale."""
    torch.cuda.synchronize()
    want = want.float()
    err = (got.float() - want).abs().amax(-1)
    tol = rel * want.abs().amax(-1).clamp_min(1e-3)
    i = int((err / tol).argmax())
    assert bool((err <= tol).all()), (err.flatten()[i].item(),
                                      tol.flatten()[i].item())


# H of the MLP chains: on the 128-column tile and off the 8-column MMA tile
MLP_WIDTHS = [32, 36, 64, 100, 128, 256, 1020, 1024]


@pytest.mark.cuda
@pytest.mark.parametrize("h", MLP_WIDTHS)
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
@pytest.mark.parametrize("block_m", [16, 64, 128])
def test_block_kernel_kinds_change_at_every_block(sm90, block_m):
    """Row tiles of 16, 64 and 128 rows (the largest dividing block_m),
    every block a new kind, 37 blocks; an out-of-range kind gives NaN."""
    w, b = _stack(8, 4, 3, 1024, sm90)
    rng = np.random.default_rng(block_m)
    kinds = torch.tensor([i % 4 for i in range(37)], dtype=torch.int32,
                         device=sm90)
    x = torch.from_numpy(rng.standard_normal((37 * block_m, 1024)).astype(
        np.float32)).to(sm90)
    before = fms.LAUNCHES["fused_mlp_score"]
    got = fms.fused_mlp_score(x, kinds, w, b, block_m=block_m)
    assert fms.LAUNCHES["fused_mlp_score"] == before + 1
    _close(got, fms.fused_mlp_score_plain(x, kinds, w, b))
    kinds[3] = 4
    got = fms.fused_mlp_score(x, kinds, w, b, block_m=block_m)
    torch.cuda.synchronize()
    blocks = got.reshape(37, block_m)
    assert bool(blocks[3].isnan().all())
    assert bool(torch.isfinite(blocks[torch.arange(37) != 3]).all())


def _zero_tail_rows(w, in_features):
    """W[..., 0, in_features:, :] = 0, as the packing leaves it."""
    w = w.clone()
    w[..., 0, in_features:, :] = 0.0
    return w


@pytest.mark.cuda
@pytest.mark.parametrize("h", [36, 256, 1024])
def test_block_kernel_first_layer_over_in_features(sm90, h):
    """in_features = 13 with zero W[., 0] rows past it: the kernel reads 16
    columns of x and agrees with the plain chain over all of them, for an
    x whose tail past 13 is not zero."""
    w, b = _stack(9, 4, 4, h, sm90)
    w = _zero_tail_rows(w, 13)
    kinds = torch.tensor([1, 3, 0, 2], dtype=torch.int32, device=sm90)
    x = torch.from_numpy(np.random.default_rng(h).standard_normal(
        (4 * 128, h)).astype(np.float32)).to(sm90)
    before = fms.LAUNCHES["fused_mlp_score"]
    got = fms.fused_mlp_score(x, kinds, w, b, block_m=128, in_features=13)
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


def _rows_launch(x, kinds, w, b, **kwargs):
    """One row-kernel call, asserting it counts exactly one launch."""
    before = fms.LAUNCHES["fused_mlp_score_rows"]
    got = fms.fused_mlp_score_rows(x, kinds, w, b, **kwargs)
    assert fms.LAUNCHES["fused_mlp_score_rows"] == before + 1
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("h", [32, 256, 1024])
def test_rows_kernel_kinds_change_at_every_row(sm90, h):
    """Row i of kind i % 4: every 16-row MMA tile and every row tile runs
    four passes, each row written in its own kind's."""
    w, b = _stack(10, 4, 3, h, sm90)
    x = torch.from_numpy(np.random.default_rng(h).standard_normal(
        (3 * 128, h)).astype(np.float32)).to(sm90)
    kinds = (torch.arange(3 * 128, device=sm90) % 4).to(torch.int32)
    _close(_rows_launch(x, kinds, w, b, block_m=128),
           fms.fused_mlp_score_rows_plain(x, kinds, w, b))


@pytest.mark.cuda
def test_rows_kernel_all_kinds_in_one_mma_tile(sm90):
    """K = 16 kinds, every 16-row MMA tile a shuffle of all 16: sixteen
    passes a row tile."""
    w, b = _stack(11, 16, 3, 64, sm90)
    rng = np.random.default_rng(12)
    kinds = torch.from_numpy(rng.permuted(
        np.tile(np.arange(16, dtype=np.int32), (16, 1)), axis=1
    ).reshape(-1)).to(sm90)
    x = torch.from_numpy(rng.standard_normal((256, 64)).astype(
        np.float32)).to(sm90)
    _close(_rows_launch(x, kinds, w, b, block_m=128),
           fms.fused_mlp_score_rows_plain(x, kinds, w, b))


@pytest.mark.cuda
@pytest.mark.parametrize("h", [36, 256, 1024])
def test_rows_kernel_first_layer_over_in_features(sm90, h):
    """in_features = 13 with zero W[., 0] rows past it and an x tail that
    is not zero, kinds in any order."""
    w, b = _stack(13, 4, 4, h, sm90)
    w = _zero_tail_rows(w, 13)
    rng = np.random.default_rng(h + 1)
    x = torch.from_numpy(rng.standard_normal((4 * 128, h)).astype(
        np.float32)).to(sm90)
    kinds = torch.from_numpy(rng.integers(0, 4, 4 * 128).astype(
        np.int32)).to(sm90)
    _close(_rows_launch(x, kinds, w, b, block_m=128, in_features=13),
           fms.fused_mlp_score_rows_plain(x, kinds, w, b))


@pytest.mark.cuda
def test_rows_kernel_out_of_range_kind_is_nan_on_its_row_alone(sm90):
    w, b = _stack(14, 4, 3, 256, sm90)
    rng = np.random.default_rng(15)
    x = torch.from_numpy(rng.standard_normal((256, 256)).astype(
        np.float32)).to(sm90)
    kinds = torch.from_numpy(rng.integers(0, 4, 256).astype(np.int32)).to(
        sm90)
    bad = torch.tensor([5, 200], device=sm90)
    kinds[5], kinds[200] = 4, -1
    got = _rows_launch(x, kinds, w, b, block_m=128)
    torch.cuda.synchronize()
    assert bool(got[bad].isnan().all())
    kinds[bad] = 0
    keep = torch.ones(256, dtype=torch.bool, device=sm90)
    keep[bad] = False
    _close(got[keep], fms.fused_mlp_score_rows_plain(x, kinds, w, b)[keep])


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [128, 256, 32896])
def test_rows_kernel_batch_sizes(sm90, rows):
    """One row tile, two, and 257 (the masked sweep's size) with the rows
    grouped by kind as the engine appends them."""
    w, b = _stack(16, 4, 3, 1024, sm90)
    rng = np.random.default_rng(rows)
    x = torch.from_numpy(rng.standard_normal((rows, 1024)).astype(
        np.float32)).to(sm90)
    kinds = torch.from_numpy(np.sort(rng.integers(0, 4, rows)).astype(
        np.int32)).to(sm90)
    _close(_rows_launch(x, kinds, w, b, block_m=128),
           fms.fused_mlp_score_rows_plain(x, kinds, w, b))


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
# b, h, kv, sq, skv, d, causal, window: the bf16 kernel packs the rep =
# h / kv query heads of a kv head into 128-row CTAs of 16-row warps over
# 64-key tiles, so lengths around 16 and 64 (partial fragments and tiles),
# windows that start inside a key tile, non-causal Sq != Skv, rep 1-8 and
# every head dim are the risky cases
FLASH_CASES = [
    (1, 16, 8, 300, 300, 128, True, 0),
    (2, 4, 4, 130, 130, 64, True, 0),
    (1, 8, 2, 200, 200, 64, True, 37),
    (1, 4, 1, 777, 777, 128, True, 256),
    (2, 4, 2, 70, 150, 64, False, 0),
    (1, 4, 2, 100, 100, 128, False, 33),
    (1, 2, 2, 1, 1, 64, True, 0),
    (1, 4, 2, 15, 15, 32, True, 0),
    (1, 2, 1, 16, 16, 128, True, 0),
    (1, 8, 1, 17, 17, 64, True, 0),
    (1, 4, 1, 64, 64, 16, True, 0),
    (1, 2, 1, 65, 65, 32, True, 0),
    (1, 4, 2, 300, 300, 128, True, 100),
    (2, 8, 1, 90, 333, 64, False, 0),
    (1, 4, 4, 333, 90, 16, False, 0),
    # the zoo's shapes: zamba2's D 80 (H 32 over KV 32), gemma3's D 256
    # (H 4 over KV 1, window 1024, prompts past it), glm4's GQA rep 16
    (1, 32, 32, 1000, 1000, 80, True, 0),
    (1, 4, 2, 130, 130, 80, True, 37),
    (2, 4, 4, 70, 150, 80, False, 0),
    (1, 4, 1, 1100, 1100, 256, True, 1024),
    (1, 4, 1, 2048, 2048, 256, True, 1024),
    (1, 4, 1, 300, 300, 256, True, 0),
    (1, 2, 1, 65, 90, 256, False, 0),
    (1, 32, 2, 300, 300, 128, True, 0),
    (1, 32, 2, 1031, 1031, 128, True, 0),
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
    _close_rows(got, fa.flash_attention_plain(q, k, v, causal, window),
                rel=8e-3 if dtype == torch.bfloat16 else 1e-4)


#: b, h, kv, sq, skv, d, window, q_offset: query chunks of a longer
#: sequence (the zig-zag prefill's first and last chunk of 256 at 32 x 256
#: positions; keys cut where a window starts), offsets off the 64-row and
#: 64-key tiles, every head dim's tiling (D 256: one m-tile a warp), GQA
#: rep 1-16
FLASH_OFFSET_CASES = [
    (1, 16, 8, 256, 256, 128, 0, 0),
    (1, 16, 8, 256, 8192, 128, 0, 7936),
    (1, 4, 1, 256, 1279, 256, 1024, 1023),
    (1, 24, 8, 100, 1037, 64, 0, 937),
    (2, 8, 8, 77, 300, 64, 100, 223),
    (1, 32, 2, 130, 200, 128, 0, 70),
    (1, 32, 32, 65, 130, 80, 0, 65),
    (1, 4, 4, 33, 50, 16, 0, 17),
    (1, 4, 2, 40, 43, 32, 9, 3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_OFFSET_CASES)
def test_flash_attention_kernel_at_a_query_offset(sm90, case, dtype):
    """Query row r at position ``q_offset + r``: the causal and window
    bounds of the tiles, the tile skip and the element masks all move by
    the offset (on the position, not on GQA's packed row index)."""
    b, h, kv, sq, skv, d, window, q_offset = case
    gen = torch.Generator(device=sm90).manual_seed(sum(case))
    q, k, v = (torch.randn((b, n, s_, d), generator=gen, device=sm90)
               .to(dtype) for n, s_ in ((h, sq), (kv, skv), (kv, skv)))
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, causal=True, window=window,
                             q_offset=q_offset)
    assert fa.LAUNCHES["flash_attention"] == before + 1
    _close_rows(got, fa.flash_attention_plain(q, k, v, True, window,
                                              q_offset),
                rel=8e-3 if dtype == torch.bfloat16 else 1e-4)


@pytest.mark.cuda
def test_flash_attention_kernel_at_offset_0_is_the_same(sm90):
    """``q_offset=0`` computes bit for bit what the call without it does."""
    gen = torch.Generator(device=sm90).manual_seed(9)
    q = torch.randn((1, 16, 513, 128), generator=gen,
                    device=sm90).to(torch.bfloat16)
    k = torch.randn((1, 8, 513, 128), generator=gen,
                    device=sm90).to(torch.bfloat16)
    a = fa.flash_attention(q, k, k, causal=True, window=100)
    b = fa.flash_attention(q, k, k, causal=True, window=100, q_offset=0)
    assert torch.equal(a, b)


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
    _close_rows(got, want, rel=1e-4)


@pytest.mark.cuda
def test_flash_attention_kernel_takes_unaligned_bf16_views(sm90):
    """A bf16 view off 16-byte rows is cloned, not refused."""
    gen = torch.Generator(device=sm90).manual_seed(5)
    base = torch.randn((1, 4, 101, 65), generator=gen,
                       device=sm90).to(torch.bfloat16)
    q = base[..., 1:]                 # data pointer 2 bytes off
    k = v = base[:, :2, :, :64]       # row stride 65
    got = fa.flash_attention(q, k, v, causal=True, window=0)
    _close_rows(got, fa.flash_attention_plain(q, k, v, True, 0), rel=8e-3)


# b, h, l, p, n, chunk, shared: L off the chunk, both state sizes, a
# short chunk; L = 1, L under one chunk, L a whole number of chunks, the
# path's L 4096 at H 24; b and c one group shared by the heads (head
# stride 0) or one per head; B = 2; P, N and the chunk off the kernel's
# 16-padding with rows off 16 bytes (staged without cp.async)
SSD_CASES = [
    (1, 3, 200, 64, 128, 64, True),
    (2, 2, 130, 64, 64, 64, True),
    (1, 2, 77, 64, 128, 16, True),
    (1, 2, 1, 64, 128, 64, True),
    (1, 2, 40, 64, 128, 64, True),
    (1, 2, 128, 64, 128, 64, False),
    (2, 3, 96, 64, 64, 16, False),
    (1, 24, 4096, 64, 128, 64, True),
    (1, 2, 50, 20, 24, 10, True),
    (1, 80, 2048, 64, 64, 64, True),    # zamba2-2.7b's prefill
]


def _ssd_inputs(case, dtype, device):
    b, h, l, p, n, chunk, shared = case
    gen = torch.Generator(device=device).manual_seed(sum(case[:6]))
    x = torch.randn((b, h, l, p), generator=gen, device=device).to(dtype)
    dt = 0.01 + 0.19 * torch.rand((b, h, l), generator=gen, device=device)
    a = -(0.5 + 3.5 * torch.rand((h,), generator=gen, device=device))
    # one group shared by every head: an expanded view, head stride 0
    bm, cm = (torch.randn((b, 1 if shared else h, l, n), generator=gen,
                          device=device).to(dtype).expand(b, h, l, n)
              for _ in range(2))
    return x, dt, a, bm, cm


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_kernel_matches_plain(sm90, case, dtype):
    x, dt, a, bm, cm = _ssd_inputs(case, dtype, sm90)
    before = ssd_k.LAUNCHES["ssd"]
    y, state = ssd_k.ssd(x, dt, a, bm, cm, chunk=case[5])
    assert ssd_k.LAUNCHES["ssd"] == before + 1
    want_y, want_state = ssd_k.ssd_plain(x, dt, a, bm, cm)
    _close(y, want_y)
    _close(state, want_state)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_final_state_on_a_chunk_boundary(sm90, chunk):
    """A prompt that ends exactly on a chunk boundary: the state the
    decode continues from is the last chunk's, passed on once."""
    case = (1, 4, 4 * chunk + 1, 64, 128, chunk, True)
    x, dt, a, bm, cm = _ssd_inputs(case, torch.bfloat16, sm90)
    first = [t[:, :, :-1] for t in (x, dt, bm, cm)]
    _, state = ssd_k.ssd(first[0], first[1], a, first[2], first[3],
                         chunk=chunk)
    _close(state, ssd_k.ssd_plain(first[0], first[1], a, first[2],
                                  first[3])[1])
    # the decode's next step from that state is the plain scan's last
    dt1 = dt[:, :, -1, None, None]
    stepped = state * torch.exp(dt1 * a[None, :, None, None]) + \
        (dt1 * bm[:, :, -1, :, None].float()) * x[:, :, -1, None, :].float()
    _close(stepped, ssd_k.ssd_plain(x, dt, a, bm, cm)[1])


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
# (4, 256) and the paper's (9, 1024), one layer alone, and H off the
# 8-column MMA tile; rows ragged and whole
FUSED_MLP_SHAPES = [(3, 64), (4, 128), (9, 64), (4, 256), (9, 1024), (1, 64),
                    (3, 36), (4, 100), (3, 1020)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 37, 129, 256, 6000])
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
@pytest.mark.parametrize("rows", [1, 37, 129, 6000])
@pytest.mark.parametrize("shape", [(4, 256), (9, 1024), (2, 36)])
def test_fused_mlp_first_layer_over_in_features(sm90, shape, rows):
    nl, h = shape
    w, b = _stack(nl * h + 1, 1, nl, h, sm90)
    w, b = _zero_tail_rows(w[0], 13).contiguous(), b[0].contiguous()
    x = torch.from_numpy(np.random.default_rng(rows + 1).standard_normal(
        (rows, h)).astype(np.float32)).to(sm90)
    before = fm.LAUNCHES["fused_mlp"]
    got = fm.fused_mlp(x, w, b, in_features=13)
    assert fm.LAUNCHES["fused_mlp"] == before + 1
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


def _close_to_scale(got, want, rel=1e-4):
    """A gradient within ``rel`` of its own largest element."""
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err <= rel * want.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 33)])
def test_flash_attention_op_gradient_on_the_card(sm90, causal, window):
    """The op's backward (the chunked attention's VJP) on CUDA inputs,
    in fp32, against the autograd gradient of the plain version, and one
    forward launch a call (the backward launches no kernel of ours)."""
    g = torch.Generator(device=sm90).manual_seed(3)
    q, k, v = (torch.randn(shape, generator=g, device=sm90)
               .requires_grad_(True)
               for shape in ((1, 300, 8, 64), (1, 300, 4, 64),
                             (1, 300, 4, 64)))
    views = [t.transpose(1, 2) for t in (q, k, v)]
    before = fa.LAUNCHES["flash_attention"]
    out = fa.flash_attention(*views, causal=causal, window=window)
    cot = torch.randn(out.shape, generator=g, device=sm90)
    got = torch.autograd.grad(out, (q, k, v), cot)
    assert fa.LAUNCHES["flash_attention"] == before + 1
    plain = fa.flash_attention_plain(*views, causal=causal, window=window)
    want = torch.autograd.grad(plain, (q, k, v), cot)
    for a, b in zip(got, want):
        _close_to_scale(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 33])
def test_flash_attention_op_gradient_at_an_offset(sm90, window):
    """The op's backward at ``q_offset`` 200 (a chunk of 100 queries
    against 300 keys) against the plain version's autograd gradient."""
    g = torch.Generator(device=sm90).manual_seed(13)
    q, k, v = (torch.randn(shape, generator=g, device=sm90)
               .requires_grad_(True)
               for shape in ((1, 8, 100, 64), (1, 4, 300, 64),
                             (1, 4, 300, 64)))
    out = fa.flash_attention(q, k, v, causal=True, window=window,
                             q_offset=200)
    cot = torch.randn(out.shape, generator=g, device=sm90)
    got = torch.autograd.grad(out, (q, k, v), cot)
    plain = fa.flash_attention_plain(q, k, v, True, window, 200)
    want = torch.autograd.grad(plain, (q, k, v), cot)
    for a, b in zip(got, want):
        _close_to_scale(a, b)


@pytest.mark.cuda
def test_ssd_op_gradient_on_the_card(sm90):
    """The op's backward (``ssd_chunked``'s VJP) on CUDA inputs in fp32,
    b and c head-broadcast views, against the plain version's autograd
    gradient (the sequential scan: fp32 sums in another order)."""
    g = torch.Generator(device=sm90).manual_seed(4)
    b, l, h, p, n = 1, 200, 4, 16, 32
    x = torch.randn((b, l, h, p), generator=g, device=sm90)
    dt = torch.rand((b, l, h), generator=g, device=sm90) * 0.2
    a = -torch.rand((h,), generator=g, device=sm90) - 0.5
    bm = torch.randn((b, l, 1, n), generator=g, device=sm90)
    cm = torch.randn((b, l, 1, n), generator=g, device=sm90)
    leaves = [t.requires_grad_(True) for t in (x, dt, a, bm, cm)]
    args = (x.transpose(1, 2), dt.transpose(1, 2), a,
            bm.expand(b, l, h, n).transpose(1, 2),
            cm.expand(b, l, h, n).transpose(1, 2))
    y, s = ssd_k.ssd(*args, vjp_chunk=64)
    gy = torch.randn(y.shape, generator=g, device=sm90)
    gs = torch.randn(s.shape, generator=g, device=sm90)
    got = torch.autograd.grad((y, s), leaves, (gy, gs))
    yp, sp = ssd_k.ssd_plain(*args)
    want = torch.autograd.grad((yp, sp), leaves, (gy, gs))
    for u, w in zip(got, want):
        _close_to_scale(u, w)
