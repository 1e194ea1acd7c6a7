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

A product of two bf16 values is exact in fp32, so an fp32 matmul over
bf16-valued operands is the MMA up to the order of its fp32 sums.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd as ssd_k

FLASH_TILE = 64     # keys per tile of the bf16 kernel
FLASH_REL = 8e-3    # chip_smoke.py's bf16 flash gate, per output row
FLASH_ROW_FLOOR = 1e-3
SSD_REL = 1e-4      # chip_smoke.py's SSD gate, both dtypes


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
