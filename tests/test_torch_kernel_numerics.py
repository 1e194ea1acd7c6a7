"""The roundings of the port's tensor-core kernels, emulated on the CPU.

The bf16 flash-attention kernel (``csrc/flash_attention.cu``) and the SSD
scan (``csrc/ssd.cu``) run their products as bf16 tensor-core MMAs with
fp32 sums, which the CPU tests cannot reach: on CPU tensors the wrappers
compute their plain versions.  So this file repeats in torch, on the CPU,
every rounding those kernels make, in the order they make it, and holds
the result against the plain versions within the tolerances
``chip_smoke.py`` holds the kernels to on the card:

* flash attention, bf16: 64-key tiles with an online softmax in log2
  units, the finite -1e30 mask, P rounded to bf16 for P V, every sum in
  fp32, the output rounded to bf16: each output row within 8e-3 *
  max(max |plain row|, 1e-3);
* the SSD scan: chunked as the kernel chunks, every product with one
  operand exact in bf16 (x, b, c) and the fp32 operand (att, b w, the
  carried state) as two bf16 terms, hi = bf16(v), lo = bf16(v - hi):
  within 1e-4 * max(1, max |plain|).  One bf16 term instead of two fails
  that gate, which is why the kernel keeps the split.

* the MLP chains (``csrc/mlp_gemm.cuh``: both scorers and
  ``fused_mlp``): one GEMM a layer on tf32 MMAs of depth 8, every fp32
  operand v as hi = tf32(v), lo = tf32(v - hi) rounded as ``cvt.rna``
  rounds (to nearest, ties away from zero), each product as lo·hi + hi·lo
  + hi·hi into fp32 sums, the first layer over ``in_features`` rounded up
  to 8 and the last layer's column 0 only: within 1e-4 * max(1, max
  |plain|) and within 1e-4 absolute on log-ms (phase 12's rtol 1e-4 on
  ms = exp(log-ms)).  One tf32 term instead of three fails.  The row
  scorer runs that chain once per kind in a row tile and keeps each row's
  own kind's output.

A product of two bf16 values is exact in fp32, and so is a product of two
tf32 values, so an fp32 matmul over such operands is the MMA up to the
order of its fp32 sums.
"""

import contextlib
import functools
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_mlp as fm
from repro_torch.kernels import fused_mlp_score as fms
from repro_torch.kernels import ssd as ssd_k

FLASH_TILE = 64     # keys per tile of the bf16 kernel
FLASH_REL = 8e-3    # chip_smoke.py's bf16 flash gate, per output row
FLASH_ROW_FLOOR = 1e-3
SSD_REL = 1e-4      # chip_smoke.py's SSD gate, both dtypes
MLP_REL = 1e-4      # chip_smoke.py's MLP kernel gate on log-ms
MLP_ABS = 1e-4      # phase 12's rtol 1e-4 on ms, absolute on log-ms


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even) and widen back to fp32."""
    return t.to(torch.bfloat16).to(torch.float32)


def _err(got: torch.Tensor, want: torch.Tensor, rel: float):
    want = want.to(torch.float32)
    return (float((got.to(torch.float32) - want).abs().max()),
            rel * max(1.0, float(want.abs().max())))


def _row_err(got: torch.Tensor, want: torch.Tensor, rel: float):
    """The (err, tol) of the output row (b, h, s) with the largest
    err / tol, each row held to rel * max(max |plain row|, floor)."""
    want = want.to(torch.float32)
    err = (got.to(torch.float32) - want).abs().amax(-1).flatten()
    tol = (rel * want.abs().amax(-1).clamp_min(FLASH_ROW_FLOOR)).flatten()
    i = int((err / tol).argmax())
    return float(err[i]), float(tol[i])


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
def flash_bf16_emulated(q, k, v, causal: bool, window: int,
                        tile: int = FLASH_TILE,
                        round_p: bool = True) -> torch.Tensor:
    """The bf16 kernel's arithmetic: S = Q K^T in fp32 over bf16 operands,
    scaled to log2 units and masked with -1e30, an online softmax over
    ``tile``-key tiles, P rounded to bf16 for P V, the row sums over the
    unrounded P, the output rounded to bf16."""
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    rep = h // kv
    qf = q.to(torch.float32)
    kf = torch.repeat_interleave(k, rep, dim=1).to(torch.float32)
    vf = torch.repeat_interleave(v, rep, dim=1).to(torch.float32)
    scale_log2 = d ** -0.5 * math.log2(math.e)
    m = torch.full((b, h, sq), fa.NEG_INF)
    l = torch.zeros((b, h, sq))
    acc = torch.zeros((b, h, sq, d))
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, skv, tile):
        kpos = torch.arange(k0, min(k0 + tile, skv))[None, :]
        s = qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2) * scale_log2
        ok = torch.ones((sq, kpos.shape[1]), dtype=torch.bool)
        if causal:
            ok = ok & (kpos <= qpos)
        if window > 0:
            ok = ok & (qpos - kpos < window)
        s = s.masked_fill(~ok, fa.NEG_INF)
        mn = torch.maximum(m, s.amax(-1))
        corr = torch.exp2(m - mn)
        p = torch.exp2(s - mn[..., None])
        l = l * corr + p.sum(-1)
        pv = _bf16(p) if round_p else p
        acc = acc * corr[..., None] + pv @ vf[:, :, k0:k0 + tile]
        m = mn
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def _flash_inputs(b, h, kv, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(torch.bfloat16)
            for shape in ((b, h, sq, d), (b, kv, skv, d), (b, kv, skv, d))]


# b, h, kv, sq, skv, d, causal, window: several 64-key tiles, GQA, windows
# that start inside a tile, a ragged last tile, non-causal Sq != Skv
FLASH_CASES = [
    (1, 4, 2, 200, 200, 64, True, 0),
    (1, 4, 2, 300, 300, 32, True, 100),
    (2, 2, 1, 130, 130, 128, True, 37),
    (1, 8, 2, 90, 333, 16, False, 0),
    (1, 2, 2, 257, 257, 64, False, 70),
    # the zoo's other head dims: zamba2's 80 (five 16-column steps) and
    # gemma3's 256, windowed and GQA rep 4 as gemma3 runs it
    (1, 4, 2, 200, 200, 80, True, 0),
    (1, 2, 2, 130, 90, 80, False, 0),
    (1, 4, 1, 300, 300, 256, True, 100),
    (1, 4, 1, 140, 140, 256, True, 0),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_bf16_p_rounding_within_the_bf16_gate(case):
    b, h, kv, sq, skv, d, causal, window = case
    q, k, v = _flash_inputs(b, h, kv, sq, skv, d, seed=sum(case[:6]))
    got = flash_bf16_emulated(q, k, v, causal, window)
    want = fa.flash_attention_plain(q, k, v, causal, window)
    err, tol = _row_err(got, want, FLASH_REL)
    assert err <= tol, (err, tol)


def test_flash_emulation_is_the_plain_softmax_without_the_p_rounding():
    """With P kept in fp32 the tiled online softmax in log2 units is the
    plain softmax up to fp32 sums (fp32 inputs and output): the bf16 P
    and the bf16 output are the only roundings the kernel adds."""
    q, k, v = _flash_inputs(1, 4, 2, 200, 200, 64, seed=7)
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    got = flash_bf16_emulated(qf, kf, vf, True, 50, round_p=False)
    err, tol = _err(got, fa.flash_attention_plain(qf, kf, vf, True, 50),
                    1e-5)
    assert err <= tol, (err, tol)


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------
def _terms(v: torch.Tensor, terms: int) -> torch.Tensor:
    """v as the kernel feeds it to a bf16 MMA: hi (+ lo) = bf16(v) (+
    bf16(v - hi)); each term's products are then exact in fp32."""
    hi = _bf16(v)
    return hi + _bf16(v - hi) if terms == 2 else hi


def ssd_split_emulated(x, dt, a, bmat, cmat, chunk: int, att_terms: int = 2,
                       bw_terms: int = 2, state_terms: int = 2):
    """The SSD kernel's three stages and their roundings: per chunk the
    cumulative decay, the local state (b w)^T x, the state passed along
    the chunks in fp32, then y = att x + exp(cum) c S_prev with
    att = (c b^T) exp(cum_i - cum_j) dt_j for j <= i.  x, b, c are bf16;
    the fp32 operand of each product goes in as ``*_terms`` bf16 terms."""
    bsz, h, l, p = x.shape
    n = bmat.shape[-1]
    pad = (-l) % chunk
    nc = (l + pad) // chunk

    def chunks(t):
        t = torch.nn.functional.pad(t.to(torch.float32),
                                    (0, 0) * (t.dim() - 3) + (0, pad))
        return t.reshape(bsz, h, nc, chunk, *t.shape[3:])

    xc, bc, cc = chunks(x), chunks(bmat), chunks(cmat)
    dtc = chunks(dt[..., None])[..., 0]
    cum = torch.cumsum(dtc * a[None, :, None, None], dim=-1)
    last = cum[..., -1]
    w = torch.exp(last[..., None] - cum) * dtc
    local = _terms(bc * w[..., None], bw_terms).transpose(-1, -2) @ xc
    s = torch.zeros((bsz, h, n, p))
    prev = []
    for ci in range(nc):
        prev.append(s)
        s = s * torch.exp(last[:, :, ci])[..., None, None] + local[:, :, ci]
    s_prev = torch.stack(prev, dim=2)
    seg = cum[..., :, None] - cum[..., None, :]
    causal = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    att = (cc @ bc.transpose(-1, -2)) * \
        torch.exp(seg.masked_fill(~causal, 0.0)) * dtc[..., None, :]
    att = att.masked_fill(~causal, 0.0)
    y = _terms(att, att_terms) @ xc + \
        torch.exp(cum)[..., None] * (cc @ _terms(s_prev, state_terms))
    return y.reshape(bsz, h, nc * chunk, p)[:, :, :l], s


def _ssd_inputs(b, h, l, p, n, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, h, l, p)).astype(
        np.float32)).to(torch.bfloat16)
    dt = torch.from_numpy((0.01 + 0.19 * rng.random((b, h, l))).astype(
        np.float32))
    a = torch.from_numpy(-(0.5 + 3.5 * rng.random(h)).astype(np.float32))
    bm, cm = (torch.from_numpy(rng.standard_normal((b, 1, l, n)).astype(
        np.float32)).to(torch.bfloat16).expand(b, h, l, n) for _ in range(2))
    return x, dt, a, bm, cm


# b, h, l, p, n, chunk: several chunks, L off the chunk, both state sizes
SSD_CASES = [
    (1, 2, 200, 64, 128, 64),
    (2, 2, 130, 32, 64, 16),
    (1, 3, 256, 64, 64, 64),
]


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_two_term_split_within_the_fp32_gate(case):
    x, dt, a, bm, cm = _ssd_inputs(*case[:5], seed=sum(case))
    y, state = ssd_split_emulated(x, dt, a, bm, cm, chunk=case[5])
    want_y, want_state = ssd_k.ssd_plain(x, dt, a, bm, cm)
    for got, want in ((y, want_y), (state, want_state)):
        err, tol = _err(got, want, SSD_REL)
        assert err <= tol, (err, tol)


@pytest.mark.parametrize("single", ["att", "bw", "state"])
def test_ssd_one_bf16_term_fails_the_gate(single):
    """Rounding the fp32 operand of att x, (b w)^T x or c S_prev to one
    bf16 term moves y by 6-24 times the gate: the split stays."""
    case = SSD_CASES[0]
    x, dt, a, bm, cm = _ssd_inputs(*case[:5], seed=sum(case))
    y, _ = ssd_split_emulated(x, dt, a, bm, cm, chunk=case[5],
                              **{f"{single}_terms": 1})
    err, tol = _err(y, ssd_k.ssd_plain(x, dt, a, bm, cm)[0], SSD_REL)
    assert err > 3 * tol, (err, tol)


# ---------------------------------------------------------------------------
# the MLP chains on tf32 tensor cores (3xTF32)
# ---------------------------------------------------------------------------
def _tf32(v: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to tf32 (10 mantissa bits) as ``cvt.rna.tf32.f32``
    rounds: to nearest, ties away from zero.  fp32 bits are sign and
    magnitude, so adding half of the dropped 13 bits' range to the bits
    rounds the magnitude up at a tie whatever the sign."""
    bits = v.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _rz(v: torch.Tensor) -> torch.Tensor:
    """float64 rounded toward zero to fp32's 24 significant bits, kept in
    float64, as a tensor-core MMA rounds its sum (its products are exact,
    its adder truncates): the 29 low mantissa bits dropped."""
    return (v.view(torch.int64) & -(1 << 29)).view(torch.float64)


@contextlib.contextmanager
def _one_thread():
    """Hundreds of small ops in a row: one intra-op thread keeps them cheap
    beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _mma_sums(p: torch.Tensor, q: torch.Tensor, groups: int) -> torch.Tensor:
    """The exact sum of each depth-8 MMA's products, p (rows, k) by
    q (k, n), as (groups, k / 8 / groups, rows, n) float64: MMA j of group
    g is depth chunk g * (k / 8 / groups) + j (zero MMAs pad the last)."""
    rows, k = p.shape
    per = -(-k // 8 // groups)
    sums = torch.bmm(p.double().reshape(rows, k // 8, 8).transpose(0, 1),
                     q.double().reshape(k // 8, 8, -1))
    pad = groups * per - k // 8
    sums = torch.cat([sums, sums.new_zeros((pad,) + sums.shape[1:])])
    return sums.reshape(groups, per, rows, -1)


def mlp_tf32_emulated(x, w, b, in_features: int, terms: int = 3,
                      step: int = 32):
    """The tensor-core chain's arithmetic: per layer, MMAs of depth 8,
    each adding its products lo·hi, hi·lo, hi·hi (``terms`` 3) or hi·hi
    alone (``terms`` 1) to a partial sum rounded toward zero; a partial
    starts at zero every ``step`` columns of the depth and is then added
    to the layer's fp32 sum (``step`` None: one partial over the whole
    depth); ReLU between layers; the first layer over ``in_features``
    rounded up to 8, the last over its column 0 (an 8-column tile)."""
    nl, hdim = w.shape[0], w.shape[-1]
    h = x.to(torch.float32)
    with _one_thread():
        for li in range(nl):
            last = li == nl - 1
            k = min(-(-in_features // 8) * 8, hdim) if li == 0 else hdim
            a, wl = h[:, :k], w[li, :k, :8 if last else hdim]
            ah, bh = _tf32(a), _tf32(wl)
            al, bl = _tf32(a - ah), _tf32(wl - bh)
            pairs = ([(al, bh), (ah, bl)] if terms == 3 else []) + [(ah, bh)]
            groups = 1 if step is None else -(-k // step)
            sums = [_mma_sums(p, q, groups) for p, q in pairs]
            part = torch.zeros(sums[0].shape[:1] + sums[0].shape[2:],
                               dtype=torch.float64)
            for j in range(sums[0].shape[1]):      # in order within a group
                for s in sums:
                    part = _rz(part + s[:, j])
            part = part.to(torch.float32)          # exact
            acc = torch.zeros_like(part[0])
            for g in range(groups):                # fp32 FADDs, in order
                acc = acc + part[g]
            z = acc + b[li, :wl.shape[1]]
            h = z if last else torch.relu(z)
    return h[:, 0]


def _mlp_chain(nl: int, hdim: int, rows: int, seed: int):
    """A He-init chain packed as ``pack_mlp_params`` packs it: 13 real
    inputs (rows 13.. of W[0] zero), x's 13 features normal and, past
    them, a tail of any values, which the tensor-core chain skips."""
    rng = np.random.default_rng(seed)
    w = np.zeros((nl, hdim, hdim), np.float32)
    w[0, :13] = rng.standard_normal((13, hdim)) * np.sqrt(2.0 / 13)
    w[1:] = rng.standard_normal((nl - 1, hdim, hdim)) * np.sqrt(2.0 / hdim)
    b = (rng.standard_normal((nl, hdim)) * 0.01).astype(np.float32)
    x = rng.standard_normal((rows, hdim)).astype(np.float32)
    return tuple(map(torch.from_numpy, (x, w, b)))


# (L, H, rows): the paper's MLPConfig packed and the default predictor's
MLP_CASES = [(9, 1024, 64), (4, 256, 512)]


def test_tf32_rounds_to_nearest_with_ties_away_from_zero():
    ulp = 2.0 ** -10                  # tf32's spacing in [1, 2)
    v = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + 3 * ulp / 2,
                      1 + 0.49 * ulp, -(1 + 0.51 * ulp), 3.0e-3])
    got = _tf32(v)
    want = [1 + ulp, -(1 + ulp), 1 + 2 * ulp, 1.0, -(1 + ulp)]
    assert got[:5].tolist() == want
    assert not bool((got.view(torch.int32) & 0x1FFF).any())
    assert abs(float(got[5]) / 3.0e-3 - 1) <= 2.0 ** -11


@functools.lru_cache(maxsize=None)
def _mlp_emulation_err(case, terms: int = 3, step=32):
    """(max |emulated - plain|, the kernel gate's tolerance) on log-ms for
    one of MLP_CASES, computed once per arithmetic."""
    nl, hdim, rows = case
    x, w, b = _mlp_chain(nl, hdim, rows, seed=nl + hdim)
    got = mlp_tf32_emulated(x, w, b, in_features=13, terms=terms, step=step)
    return _err(got, fm.fused_mlp_plain(x, w, b), MLP_REL)


@pytest.mark.parametrize("case", MLP_CASES)
def test_mlp_3xtf32_within_the_gates(case):
    err, tol = _mlp_emulation_err(case)
    assert err <= tol and err <= MLP_ABS, (err, tol)


@pytest.mark.parametrize("case", MLP_CASES)
def test_mlp_one_tf32_term_fails_the_gate(case):
    """hi·hi alone, the plain TF32 product, moves log-ms by 6-18 times
    the kernel gate and 31-40 times phase 12's; three terms stay within
    0.07 of either: the split stays."""
    err, tol = _mlp_emulation_err(case, terms=1)
    assert err > 3 * tol and err > 3 * MLP_ABS, (err, tol)


@pytest.mark.parametrize("case", MLP_CASES)
def test_mlp_truncated_sums_need_a_partial_per_k_step(case):
    """The MMA's adder truncates: one partial over the whole depth (1024 at
    H 1024, 3 MMAs each 8 deep) drifts several times further from the
    plain chain than partials of one 32-deep k-step added in fp32 (33
    times at L 9, H 1024, 6 at L 4, H 256)."""
    stepped, _ = _mlp_emulation_err(case)
    whole, _ = _mlp_emulation_err(case, step=None)
    assert whole > 4 * stepped, (whole, stepped)


def test_rows_tile_of_all_kinds_within_the_gates():
    """The row scorer's arithmetic on one 128-row tile whose 16-row MMA
    tiles each hold rows of all four kinds, at L 9, H 1024: each kind's
    pass is the 3xTF32 chain above, and each row keeps its own kind's
    output.  A row's output depends on that row alone, so each kind's pass
    is emulated on its own rows and selected per row."""
    nk, nl, hdim, rows = 4, 9, 1024, 128
    chains = [_mlp_chain(nl, hdim, rows, seed=100 + k) for k in range(nk)]
    x = chains[0][0]
    w = torch.stack([c[1] for c in chains])
    b = torch.stack([c[2] for c in chains])
    rng = np.random.default_rng(11)
    kinds = torch.from_numpy(rng.permuted(
        np.tile(np.arange(16, dtype=np.int32) % nk, (rows // 16, 1)),
        axis=1).reshape(-1))
    got = torch.empty(rows)
    for k in range(nk):
        sel = torch.nonzero(kinds == k).flatten()
        got[sel] = mlp_tf32_emulated(x[sel], w[k], b[k], in_features=13)
    err, tol = _err(got, fms.fused_mlp_score_rows_plain(x, kinds, w, b),
                    MLP_REL)
    assert err <= tol and err <= MLP_ABS, (err, tol)
