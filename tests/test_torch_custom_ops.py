"""Port parity: flash attention and the SSD scan as dispatcher ops with a
gradient (``repro_torch::flash_attention``, ``repro_torch::ssd``).

On the CPU each op's forward is its kernel's plain version and its
backward the vector-Jacobian product of the function the reference
trains through: the chunked online-softmax attention
(``repro.models.attention.flash_attention``) and ``ssd_chunked``.  These
tests run ``torch.library.opcheck`` on both ops (the schema, the fake
implementation's shapes and strides, the autograd registration), hold
each op's gradient against the autograd gradient of the plain version
and against ``jax.vjp`` of the reference's function on the same numpy
inputs, and check that the tracker records one op a call, priced as the
kernel's bound counts it.  Inputs are fp32 from one numpy seed.
Tolerance: every gradient within 1e-5 of its largest element, relative
(fp32 sums over chunks against the sequential or score-matrix plain
version, or against XLA's order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro.models import ssm as ref_ssm
from repro_torch.core.trace import OperationTracker
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd as sk
from repro_torch.models import attention as attn

RTOL = 1e-5

# b, h, kv, s, d, causal, window: GQA rep 1 and 2, off the chunks
FLASH_CASES = [
    (1, 2, 2, 37, 16, True, 0),
    (2, 4, 2, 37, 16, True, 0),
    (1, 4, 2, 29, 16, False, 0),
    (1, 4, 4, 45, 32, True, 11),
    (2, 4, 2, 40, 16, False, 7),
]
#: the chunks the op's backward takes in these tests, so that a length
#: crosses several query and key blocks (and a window skips some)
CHUNKS = (16, 8)
# b, h, l, p, n, vjp chunk
SSD_CASES = [(1, 3, 11, 4, 5, 4), (2, 2, 24, 8, 4, 8), (1, 4, 30, 8, 6, 7)]


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


def _flash_inputs(case):
    b, h, kv, s, d = case[:5]
    rng = np.random.default_rng(sum(case[:5]))
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, kv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, kv, s, d)).astype(np.float32)
    g = rng.standard_normal((b, h, s, d)).astype(np.float32)
    return q, k, v, g


def _ssd_inputs(case):
    b, h, l, p, n, _ = case
    rng = np.random.default_rng(sum(case))
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = rng.uniform(0.05, 0.5, (b, l, h)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, (h,)).astype(np.float32)
    bm = rng.standard_normal((b, l, 1, n)).astype(np.float32)
    cm = rng.standard_normal((b, l, 1, n)).astype(np.float32)
    gy = rng.standard_normal((b, l, h, p)).astype(np.float32)
    gs = rng.standard_normal((b, h, n, p)).astype(np.float32)
    return x, dt, a, bm, cm, gy, gs


def _leaf(a):
    return torch.from_numpy(a).requires_grad_(True)


def _ssd_op_grads(arrays, chunk):
    """The op's gradients, inputs given in the model's (B, L, ...) layout
    as the Mamba2 block hands them: transposed views, b and c
    head-broadcast views of one group."""
    x, dt, a, bm, cm, gy, gs = arrays
    h = x.shape[2]
    leaves = [_leaf(t) for t in (x, dt, a, bm, cm)]
    lx, ldt, la, lb, lc = leaves
    shape = lb.shape[:2] + (h, lb.shape[3])
    y, s = sk.ssd(lx.transpose(1, 2), ldt.transpose(1, 2), la,
                  lb.expand(shape).transpose(1, 2),
                  lc.expand(shape).transpose(1, 2), vjp_chunk=chunk)
    grads = torch.autograd.grad(
        (y, s), leaves, (torch.from_numpy(gy).transpose(1, 2),
                         torch.from_numpy(gs)))
    return [g.numpy() for g in grads]


def test_opcheck_flash_attention():
    """Plain inputs and the model's transposed views (B, S, H, D) ->
    (B, H, S, D), causal with a window and not, and a query chunk at a
    ``q_offset`` (the schema's default 0 where it is left out)."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 9, 4, 16)).astype(
        np.float32)).requires_grad_(True)
    k = torch.from_numpy(rng.standard_normal((1, 9, 2, 16)).astype(
        np.float32)).requires_grad_(True)
    v = torch.from_numpy(rng.standard_normal((1, 9, 2, 16)).astype(
        np.float32)).requires_grad_(True)
    op = torch.ops.repro_torch.flash_attention.default
    for args in ((q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  True, 3),
                 (q.detach().transpose(1, 2).contiguous(),
                  k.detach().transpose(1, 2).contiguous(),
                  v.detach().transpose(1, 2).contiguous(), False, 0),
                 (q.transpose(1, 2)[:, :, 4:], k.transpose(1, 2),
                  v.transpose(1, 2), True, 3, 4)):
        result = torch.library.opcheck(op, args)
        assert set(result.values()) == {"SUCCESS"}, result


def test_opcheck_ssd():
    """x a transposed view; b and c head-broadcast (stride 0) views."""
    x, dt, a, bm, cm, _, _ = _ssd_inputs(SSD_CASES[0])
    h = x.shape[2]
    lb, lc = _leaf(bm), _leaf(cm)
    shape = lb.shape[:2] + (h, lb.shape[3])
    args = (_leaf(x).transpose(1, 2), _leaf(dt).transpose(1, 2), _leaf(a),
            lb.expand(shape).transpose(1, 2),
            lc.expand(shape).transpose(1, 2), 4, 4)
    result = torch.library.opcheck(torch.ops.repro_torch.ssd.default, args)
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_gradient_matches_plain_and_reference(case, monkeypatch):
    monkeypatch.setattr(fa, "VJP_CHUNKS", CHUNKS)
    causal, window = case[5], case[6]
    q, k, v, g = _flash_inputs(case)
    leaves = [_leaf(t) for t in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal, window=window)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    plain = fa.flash_attention_plain(*leaves, causal=causal, window=window)
    want = torch.autograd.grad(plain, leaves, torch.from_numpy(g))
    for name, a, b in zip("qkv", got, want):
        _close(a.numpy(), b.numpy(), f"d{name} vs plain")

    def ref(q_, k_, v_):   # the reference's chunked attention, (B, S, H, D)
        return ref_attn.flash_attention(
            q_, k_, v_, causal=causal, window=window,
            chunk_q=CHUNKS[0], chunk_kv=CHUNKS[1])
    bshd = lambda t: jnp.asarray(t).transpose(0, 2, 1, 3)
    _, vjp = jax.vjp(ref, bshd(q), bshd(k), bshd(v))
    ref_grads = vjp(bshd(g))
    for name, a, b in zip("qkv", got, ref_grads):
        _close(a.numpy(), np.asarray(b).transpose(0, 2, 1, 3),
               f"d{name} vs reference")


@pytest.mark.parametrize("case", FLASH_CASES)
def test_chunked_attention_matches_reference(case):
    """The port's ``chunked_attention`` forward, with the static block
    skipping, against the reference's at the same chunks (without the
    causal mask the port also skips the blocks below a window's band,
    which the reference computes and masks out)."""
    causal, window = case[5], case[6]
    q, k, v, _ = _flash_inputs(case)
    bshd = lambda t: t.transpose(0, 2, 1, 3).copy()
    got = attn.chunked_attention(*(torch.from_numpy(bshd(t))
                                   for t in (q, k, v)),
                                 causal=causal, window=window,
                                 chunk_q=CHUNKS[0], chunk_kv=CHUNKS[1])
    want = ref_attn.flash_attention(*(jnp.asarray(bshd(t))
                                      for t in (q, k, v)),
                                    causal=causal, window=window,
                                    chunk_q=CHUNKS[0], chunk_kv=CHUNKS[1])
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_gradient_matches_plain_and_reference(case):
    arrays = _ssd_inputs(case)
    got = _ssd_op_grads(arrays, case[5])
    x, dt, a, bm, cm, gy, gs = arrays
    h = x.shape[2]
    leaves = [_leaf(t) for t in (x, dt, a, bm, cm)]
    lx, ldt, la, lb, lc = leaves
    shape = lb.shape[:2] + (h, lb.shape[3])
    y, s = sk.ssd_plain(lx.transpose(1, 2), ldt.transpose(1, 2), la,
                        lb.expand(shape).transpose(1, 2),
                        lc.expand(shape).transpose(1, 2))
    want = torch.autograd.grad((y, s), leaves,
                               (torch.from_numpy(gy).transpose(1, 2),
                                torch.from_numpy(gs)))
    for name, u, w in zip(("x", "dt", "a", "b", "c"), got, want):
        _close(u, w.numpy(), f"d{name} vs plain")

    def ref(x_, dt_, a_, b_, c_):
        return ref_ssm.ssd_chunked(x_, dt_, a_, b_, c_, chunk=case[5],
                                   return_final=True)
    _, vjp = jax.vjp(ref, *map(jnp.asarray, (x, dt, a, bm, cm)))
    ref_grads = vjp((jnp.asarray(gy), jnp.asarray(gs)))
    for name, u, w in zip(("x", "dt", "a", "b", "c"), got, ref_grads):
        _close(u, np.asarray(w), f"d{name} vs reference")


def test_gradient_of_y_alone_skips_the_state():
    """A loss of y alone (the Mamba2 block's) gets the same gradient as
    one with a zero state cotangent."""
    x, dt, a, bm, cm, gy, gs = _ssd_inputs(SSD_CASES[1])
    zero = np.zeros_like(gs)
    with_zero = _ssd_op_grads((x, dt, a, bm, cm, gy, zero), 8)
    leaves = [_leaf(t) for t in (x, dt, a, bm, cm)]
    y, _ = sk.ssd(leaves[0].transpose(1, 2), leaves[1].transpose(1, 2),
                  leaves[2], *(t.expand(t.shape[:2] + (x.shape[2],
                                                       t.shape[3]))
                               .transpose(1, 2) for t in leaves[3:]),
                  vjp_chunk=8)
    alone = torch.autograd.grad(y, leaves,
                                torch.from_numpy(gy).transpose(1, 2))
    for u, w in zip(alone, with_zero):
        _close(u.numpy(), w)


def test_tracker_records_one_op_a_call_with_the_bound_flops():
    """Flash: 4 D FLOPs per allowed (query, key) pair per head; SSD: the
    exact count at the kernel's chunk (the counts chip_smoke's bounds
    read)."""
    b, h, kv, s, d, causal, window = 1, 4, 2, 20, 16, True, 6
    q, k, v, _ = _flash_inputs((b, h, kv, s, d))
    x, dt, a, bm, cm, _, _ = _ssd_inputs((1, 3, 11, 4, 5, 4))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    sx = torch.from_numpy(x).transpose(1, 2)
    sdt = torch.from_numpy(dt).transpose(1, 2)
    sb = torch.from_numpy(bm).expand(1, 11, 3, 5).transpose(1, 2)
    sc = torch.from_numpy(cm).expand(1, 11, 3, 5).transpose(1, 2)

    def step():
        fa.flash_attention(tq, tk, tv, causal=causal, window=window)
        sk.ssd(sx, sdt, torch.from_numpy(a), sb, sc, chunk=4)
    trace = OperationTracker("cpu-host").track(step)
    names = [op.name for op in trace.ops]
    assert names == ["repro_torch::flash_attention", "repro_torch::ssd"]
    pairs = sum(min(i, s - 1) - max(0, i - window + 1) + 1
                for i in range(s))
    flash, ssd_op = trace.ops
    assert flash.cost.flops == 4.0 * b * h * d * pairs
    assert flash.cost.bytes_read == 4.0 * (q.size + k.size + v.size)
    assert flash.cost.bytes_written == 4.0 * q.size
    assert not flash.kernel_varying and flash.measured_ms > 0
    l, n, p, hh = 11, 5, 4, 3
    rows = [4, 4, 3]
    want = hh * (sum(r * (r + 1) for r in rows) * (n + p) + 4 * l * n * p
                 + len(rows) * n * p)
    assert ssd_op.cost.flops == want
    # b and c are one group's, read once for all heads
    assert ssd_op.cost.bytes_read == 4.0 * (x.size + dt.size + a.size
                                            + 2 * l * n)
    assert ssd_op.cost.bytes_written == 4.0 * hh * (l + n) * p


def test_wallclock_times_a_recorded_kernel_op_and_simulates_a_decoded_one():
    """A tracked kernel op replays its one recorded call; the same op
    decoded from a trace document has no call and is simulated."""
    from repro_torch.core import calibration
    q, k, v, _ = _flash_inputs((1, 2, 2, 12, 16))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    trace = OperationTracker("cpu-host", measure="wallclock").track(
        lambda: fa.flash_attention(tq, tk, tv))
    (op,) = trace.ops
    assert calibration.covers(op) and trace.covered_fraction == 1.0
    decoded = type(trace).from_dict(trace.to_dict()).ops[0]
    assert decoded.name == op.name and not calibration.covers(decoded)
