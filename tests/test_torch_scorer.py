"""Port parity: the fused MLP scorer, its kernels' plain versions and the
bucket helpers.

On the CPU every kernel wrapper computes its plain version, so these
tests hold the plain versions against the reference's jnp oracles and
the port's ``FusedMLPScorer`` against the reference scorer run in Pallas
interpret mode and on its jnp oracle.  Tolerance rtol 1e-5, atol 1e-6:
fp32 sums in another order (the reference's own interpret kernel and
oracle differ by ~5.6e-6 relative).  The kernels themselves run only on
an sm_90 GPU: ``test_torch_kernels_cuda.py`` holds them against the
plain versions there."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import batched as ref_batched
from repro.core import dataset as ref_dataset
from repro.core import devices as ref_devices
from repro.kernels import fused_mlp_score as ref_fms
from repro.kernels import fused_mlp_score_ref as ref_oracle
from repro_torch.core import batched
from repro_torch.core.predictor import HabitatPredictor
from repro_torch.kernels import fused_mlp_score as fms
from test_sweep_properties import _make_stack
from test_torch_engine import DEVS, carried_mlps, port_traces

RTOL, ATOL = 1e-5, 1e-6
K, L, H, BM = 4, 3, 32, 8


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 31, 32, 33, 64, 65, 100, 511,
                               512, 513, 2000])
def test_bucket_helpers_match_reference(n):
    assert fms.bucket_blocks(n) == ref_fms.bucket_blocks(n)
    assert fms.bucket_rows(n) == ref_fms.bucket_rows(n)


def test_bucket_helpers_edge_contract():
    assert fms.bucket_blocks(0) == 0 and fms.bucket_rows(0) == 0
    for fn in (fms.bucket_blocks, fms.bucket_rows):
        with pytest.raises(ValueError):
            fn(-1)


def _stack(seed: int, k: int = K, l: int = L, h: int = H):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, l, h, h)) * np.sqrt(2.0 / h)).astype(
        np.float32)
    b = (rng.standard_normal((k, l, h)) * 0.1).astype(np.float32)
    return w, b


@pytest.mark.parametrize("seed", [0, 1])
def test_block_plain_matches_oracle(seed):
    w, b = _stack(seed)
    rng = np.random.default_rng(seed + 10)
    nb = 5
    x = rng.standard_normal((nb * BM, H)).astype(np.float32)
    kinds = rng.integers(0, K, nb).astype(np.int32)
    want = np.asarray(ref_oracle.fused_mlp_score_ref(
        jnp.asarray(x), jnp.asarray(kinds), jnp.asarray(w), jnp.asarray(b)))
    got = fms.fused_mlp_score_plain(torch.from_numpy(x),
                                    torch.from_numpy(kinds),
                                    torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the CPU wrapper is the plain version, and launches nothing
    before = dict(fms.LAUNCHES)
    via_wrapper = fms.fused_mlp_score(
        torch.from_numpy(x), torch.from_numpy(kinds), torch.from_numpy(w),
        torch.from_numpy(b), block_m=BM)
    np.testing.assert_array_equal(via_wrapper.numpy(), got.numpy())
    assert fms.LAUNCHES == before


@pytest.mark.parametrize("seed", [0, 1])
def test_rows_plain_matches_oracle(seed):
    w, b = _stack(seed)
    rng = np.random.default_rng(seed + 20)
    x = rng.standard_normal((6 * BM, H)).astype(np.float32)
    kinds = rng.integers(0, K, 6 * BM).astype(np.int32)
    want = np.asarray(ref_oracle.fused_mlp_score_rows_ref(
        jnp.asarray(x), jnp.asarray(kinds), jnp.asarray(w), jnp.asarray(b)))
    got = fms.fused_mlp_score_rows(torch.from_numpy(x),
                                   torch.from_numpy(kinds),
                                   torch.from_numpy(w), torch.from_numpy(b),
                                   block_m=BM)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_stacked_plain_matches_oracle(seed):
    w, b = _stack(seed)
    rng = np.random.default_rng(seed + 30)
    xs = rng.standard_normal((K, 16, H)).astype(np.float32)
    want = np.asarray(ref_oracle.fused_mlp_score_stacked_ref(
        jnp.asarray(xs), jnp.asarray(w), jnp.asarray(b)))
    got = fms.fused_mlp_score_stacked_plain(
        torch.from_numpy(xs), torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_wrapper_shape_contracts():
    w, b = _stack(0)
    x = torch.zeros((3 * BM, H))
    with pytest.raises(ValueError, match="blocks x block_m"):
        fms.fused_mlp_score(x, torch.zeros(2, dtype=torch.int32),
                            torch.from_numpy(w), torch.from_numpy(b),
                            block_m=BM)
    with pytest.raises(ValueError, match="multiple of block_m"):
        fms.fused_mlp_score_rows(x[:-1], torch.zeros(3 * BM - 1,
                                                     dtype=torch.int32),
                                 torch.from_numpy(w), torch.from_numpy(b),
                                 block_m=BM)
    with pytest.raises(ValueError, match="weights shape"):
        fms.fused_mlp_score(x, torch.zeros(3, dtype=torch.int32),
                            torch.from_numpy(w[:, :, :4]),
                            torch.from_numpy(b), block_m=BM)


def test_pack_matches_reference():
    from repro.kernels import ops as ref_ops
    ref_mlps, pt_mlps = carried_mlps(hidden_layers=L - 1, hidden=H)
    m = ref_mlps["bmm"]
    rw, rb = ref_ops.pack_mlp_params(m.params, 13, H)
    pw, pb = fms.pack_mlp_params(pt_mlps["bmm"].params, 13, H, "cpu")
    np.testing.assert_array_equal(pw.numpy(), np.asarray(rw))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(rb))


def _packed_kinds(seed: int, n_in: int = 13):
    """K kinds of L-layer MLPs with ``n_in`` inputs, packed to H."""
    rng = np.random.default_rng(seed)
    sizes = [n_in] + [H] * (L - 1) + [1]
    ws, bs = zip(*(fms.pack_mlp_params(
        [(rng.standard_normal((a, c)).astype(np.float32),
          rng.standard_normal(c).astype(np.float32))
         for a, c in zip(sizes[:-1], sizes[1:])], n_in, H, "cpu")
        for _ in range(K)))
    return torch.stack(ws), torch.stack(bs)


def test_block_plain_ignores_the_x_tail_past_in_features():
    """With the zero rows ``pack_mlp_params`` leaves in W[., 0], the block
    chain's output does not depend, bit for bit, on the columns of x past
    ``in_features``: what the kernel's first layer skips adds nothing.
    The wrapper on the CPU takes ``in_features`` and computes the same."""
    w, b = _packed_kinds(3)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((4 * BM, H)).astype(
        np.float32))
    other = x.clone()
    other[:, 13:] = torch.from_numpy(
        rng.standard_normal((4 * BM, H - 13)).astype(np.float32) * 1e3)
    kinds = torch.tensor([2, 0, 3, 1], dtype=torch.int32)
    want = fms.fused_mlp_score_plain(x, kinds, w, b)
    assert torch.equal(fms.fused_mlp_score_plain(other, kinds, w, b), want)
    assert torch.equal(fms.fused_mlp_score(other, kinds, w, b, block_m=BM,
                                           in_features=13), want)


def test_packers_refuse_non_zero_rows_past_in_features():
    rng = np.random.default_rng(5)
    params = [(rng.standard_normal((13, H)).astype(np.float32),
               np.zeros(H, np.float32)),
              (rng.standard_normal((H, 1)).astype(np.float32),
               np.zeros(1, np.float32))]
    w, _ = fms.pack_mlp_params(params, 13, H, "cpu")
    assert not bool(w[0, 13:].any())
    with pytest.raises(ValueError, match="in_features=10"):
        fms.pack_mlp_params(params, 10, H, "cpu")
    params[0][0][10:] = 0.0                 # zero rows pass at any width
    fms.pack_mlp_params(params, 10, H, "cpu")


@pytest.mark.parametrize("in_features", [0, -1, H + 1])
def test_block_wrapper_refuses_in_features_off_the_width(in_features):
    w, b = _stack(0)
    with pytest.raises(ValueError, match="in_features"):
        fms.fused_mlp_score(torch.zeros((BM, H)),
                            torch.zeros(1, dtype=torch.int32),
                            torch.from_numpy(w), torch.from_numpy(b),
                            block_m=BM, in_features=in_features)


def test_rows_wrapper_ignores_the_x_tail_past_in_features():
    """The row wrapper on the CPU takes ``in_features`` and computes the
    same as without it, bit for bit, for an x whose tail past 13 is not
    zero under the zero W[., 0] rows ``pack_mlp_params`` leaves."""
    w, b = _packed_kinds(6)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((4 * BM, H)).astype(
        np.float32))
    other = x.clone()
    other[:, 13:] = torch.from_numpy(
        rng.standard_normal((4 * BM, H - 13)).astype(np.float32) * 1e3)
    kinds = torch.from_numpy(rng.integers(0, K, 4 * BM).astype(np.int32))
    want = fms.fused_mlp_score_rows(x, kinds, w, b, block_m=BM)
    assert torch.equal(fms.fused_mlp_score_rows_plain(other, kinds, w, b),
                       want)
    assert torch.equal(fms.fused_mlp_score_rows(other, kinds, w, b,
                                                block_m=BM, in_features=13),
                       want)


@pytest.mark.parametrize("in_features", [0, -1, H + 1])
def test_rows_wrapper_refuses_in_features_off_the_width(in_features):
    w, b = _stack(0)
    with pytest.raises(ValueError, match="in_features"):
        fms.fused_mlp_score_rows(torch.zeros((BM, H)),
                                 torch.zeros(BM, dtype=torch.int32),
                                 torch.from_numpy(w), torch.from_numpy(b),
                                 block_m=BM, in_features=in_features)


@pytest.mark.parametrize("m", [1, 127, 128, 129, 32850])
def test_pad_rows_to_blocks(m):
    """``score_rows_ms``'s padding on CUDA: whole blocks, no bucket, real
    rows untouched, padding rows zero and of the last real row's kind."""
    rng = np.random.default_rng(m)
    xn = torch.from_numpy(rng.standard_normal((m, 13)))
    kind_ids = torch.from_numpy(np.sort(rng.integers(0, K, m)).astype(
        np.int32))
    x, row_kinds = fms.pad_rows_to_blocks(xn, kind_ids, H, 128)
    padded = -(-m // 128) * 128
    assert x.shape == (padded, H) and row_kinds.shape == (padded,)
    assert x.dtype == torch.float32 and row_kinds.dtype == torch.int32
    assert torch.equal(x[:m, :13], xn.to(torch.float32))
    assert not bool(x[:m, 13:].any()) and not bool(x[m:].any())
    assert torch.equal(row_kinds[:m], kind_ids)
    assert bool((row_kinds[m:] == kind_ids[-1]).all())


def _pair_rows(per_kind: int, seed: int = 0, kinds=None):
    """Interleaved raw feature rows + kind ids (sorted kind order)."""
    rng = np.random.default_rng(seed)
    dev = ref_devices.get("V100")
    feats, kind_ids = [], []
    for ki, kind in enumerate(sorted(("conv2d", "linear", "bmm",
                                      "recurrent"))):
        if kinds is not None and kind not in kinds:
            continue
        for op in ref_dataset.sample_ops(kind, per_kind, seed=seed + ki):
            feats.append(ref_dataset.op_features(op, dev))
            kind_ids.append(ki)
    order = rng.permutation(len(feats))
    return (np.asarray(feats, np.float32)[order],
            np.asarray(kind_ids, np.int32)[order])


@pytest.mark.parametrize("impl", ["interpret", "jnp"])
@pytest.mark.parametrize("port_impl", ["cuda", "plain"])
@pytest.mark.parametrize("kinds", [None, ("bmm",)], ids=["mixed", "single"])
def test_score_rows_matches_reference_scorer(impl, port_impl, kinds):
    ref_mlps, pt_mlps = carried_mlps(hidden_layers=L - 1, hidden=H)
    ref = ref_batched.FusedMLPScorer(ref_mlps, block_m=BM, impl=impl)
    port = batched.FusedMLPScorer(pt_mlps, block_m=BM, impl=port_impl,
                                  device="cpu")
    feats, kind_ids = _pair_rows(per_kind=7, kinds=kinds)
    want = ref.score_rows_ms(feats, kind_ids)
    got = port.score_rows_ms(torch.from_numpy(feats), kind_ids)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("impl", ["interpret", "jnp"])
@pytest.mark.parametrize("port_impl", ["cuda", "plain"])
def test_score_ms_matches_reference_scorer(impl, port_impl):
    ref_mlps, pt_mlps = carried_mlps(hidden_layers=L - 1, hidden=H)
    ref = ref_batched.FusedMLPScorer(ref_mlps, block_m=BM, impl=impl)
    port = batched.FusedMLPScorer(pt_mlps, block_m=BM, impl=port_impl,
                                  device="cpu")
    feats, kind_ids = _pair_rows(per_kind=9, seed=3)
    by_kind = {kind: feats[kind_ids == ki]
               for ki, kind in enumerate(port.kinds)
               if (kind_ids == ki).any()}
    want = ref.score_ms(by_kind)
    got = port.score_ms({k: torch.from_numpy(v) for k, v in by_kind.items()})
    assert set(got) == set(want)
    for kind in want:
        np.testing.assert_allclose(got[kind].numpy(), want[kind],
                                   rtol=RTOL, atol=ATOL, err_msg=kind)


def test_empty_inputs_never_launch():
    _, pt_mlps = carried_mlps(hidden_layers=L - 1, hidden=H)
    port = batched.FusedMLPScorer(pt_mlps, block_m=BM, device="cpu")
    before = batched.SCORER_DISPATCHES.snapshot()
    assert port.score_rows_ms(torch.zeros((0, 13)), []).shape == (0,)
    out = port.score_ms({"bmm": torch.zeros((0, 13))})
    assert out["bmm"].shape == (0,)
    assert batched.SCORER_DISPATCHES.snapshot() == before


@pytest.mark.parametrize("scorer", ["cuda", "plain"])
def test_cell_masked_sweep_is_one_dispatch(scorer):
    """A cell-masked sweep scores every kind's cold cells in ONE fused
    dispatch, whatever the kind mix; a full sweep likewise."""
    _, pt_mlps = carried_mlps(hidden_layers=L - 1, hidden=H)
    traces = port_traces(_make_stack(21, 10))
    pred = HabitatPredictor(mlps=pt_mlps, device="cpu", sweep_scorer=scorer)
    rng = np.random.default_rng(0)
    mask = rng.random((len(traces), len(DEVS))) < 0.5
    mask[:, 0] = True
    batched.SCORER_DISPATCHES.reset()
    pred.predict_sweep(traces, DEVS, cell_mask=mask)
    assert batched.SCORER_DISPATCHES.snapshot() == {"fused": 1,
                                                    "per_kind": 0}
    pred.predict_sweep(traces, DEVS)
    assert batched.SCORER_DISPATCHES.snapshot() == {"fused": 2,
                                                    "per_kind": 0}


def test_auto_scorer_on_cpu_is_per_kind():
    """"auto" keeps per-kind forwards off the GPU, as the reference keeps
    its fused kernel to the TPU."""
    _, pt_mlps = carried_mlps(hidden_layers=L - 1, hidden=H)
    traces = port_traces(_make_stack(22, 4))
    pred = HabitatPredictor(mlps=pt_mlps, device="cpu")
    batched.SCORER_DISPATCHES.reset()
    pred.predict_sweep(traces, DEVS)
    snap = batched.SCORER_DISPATCHES.snapshot()
    assert snap["fused"] == 0 and snap["per_kind"] >= 1


def test_mixed_architectures_fall_back_only_under_auto():
    _, small = carried_mlps(hidden_layers=1, hidden=16,
                            kinds=("conv2d", "linear"))
    _, big = carried_mlps(hidden_layers=2, hidden=32, kinds=("bmm",))
    mixed = {**small, **big}
    assert batched._resolve_scorer("auto", mixed,
                                   torch.device("cpu")) is None
    with pytest.raises(ValueError, match="architecture-uniform"):
        batched._resolve_scorer("plain", mixed, torch.device("cpu"))
    with pytest.raises(ValueError, match="unknown scorer"):
        batched._resolve_scorer("pallas", mixed, torch.device("cpu"))
