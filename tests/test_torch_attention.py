"""Port parity: flash attention (kernel 1's plain version) and the model's
attention functions against the reference.

On the CPU the port's ``flash_attention`` wrapper computes its plain
version, so these tests hold it against the reference's Pallas kernel run
in interpret mode and against its jnp oracle, over the cases the card
phase covers (causal and not, windows, GQA rep 1/2/4, head dims 64/128,
lengths off the kernel's 64-row tiles).  The model-layout functions are
held against ``repro.models.attention``.  Inputs come from one numpy
seed and are fp32.  Tolerance atol 2e-5 on O(1) outputs: fp32 softmax
sums in another order (the reference's own kernel-vs-oracle test uses
2e-5).  The CUDA kernel itself is held against the plain version on the
card (``test_torch_kernels_cuda.py``)."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_kernel
from repro.kernels.flash_attention_ref import flash_attention_ref
from repro.models import attention as ref_attn
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import attention as attn

ATOL = 2e-5

# b, h, kv, sq, skv, d, causal, window, (Pallas block_q, block_kv)
CASES = [
    (1, 4, 4, 70, 70, 64, True, 0, 32, 32),       # rep 1, ragged tiles
    (2, 4, 2, 45, 45, 128, True, 0, 16, 32),      # rep 2, D = 128
    (1, 8, 2, 50, 50, 64, True, 17, 16, 16),      # rep 4, window
    (1, 4, 1, 90, 90, 64, True, 256, 32, 64),     # window wider than S
    (1, 4, 2, 33, 80, 64, False, 0, 32, 32),      # non-causal, Sq != Skv
    (1, 2, 2, 40, 40, 128, False, 9, 16, 16),     # non-causal window
]


def _rand(rng, shape):
    return (rng.standard_normal(shape) * 0.5).astype(np.float32)


@pytest.mark.parametrize("case", CASES)
def test_flash_plain_matches_reference_kernel_and_oracle(case):
    b, h, kv, sq, skv, d, causal, window, bq, bkv = case
    rng = np.random.default_rng(sum(case[:6]))
    q, k, v = (_rand(rng, s) for s in ((b, h, sq, d), (b, kv, skv, d),
                                      (b, kv, skv, d)))
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal,
                             window=window).numpy()
    assert fa.LAUNCHES == before      # CPU tensors never reach the kernel
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    interp = ref_kernel(jq, jk, jv, causal=causal, window=window,
                        block_q=bq, block_kv=bkv, interpret=True)
    oracle = flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(interp), atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(oracle), atol=ATOL)


@pytest.mark.parametrize("window", [0, 11])
def test_model_layout_flash_matches_reference(window):
    b, s, h, kvh, d = 2, 40, 4, 2, 16
    rng = np.random.default_rng(window)
    q, k, v = (_rand(rng, (b, s, n, d)) for n in (h, kvh, kvh))
    got = attn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=True,
                               window=window)
    want = ref_attn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True,
                                    window=window, chunk_q=16, chunk_kv=8)
    assert tuple(got.shape) == (b, s, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("causal,window,q_offset", [(True, 0, 0),
                                                    (True, 5, 0),
                                                    (False, 0, 0),
                                                    (True, 0, 7)])
def test_dense_attention_matches_reference(causal, window, q_offset):
    rng = np.random.default_rng(1)
    q = _rand(rng, (2, 12, 4, 16))
    k = _rand(rng, (2, 19, 2, 16))
    v = _rand(rng, (2, 19, 2, 16))
    got = attn.dense_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal,
                               window=window, q_offset=q_offset)
    want = ref_attn.dense_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    window=window, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("window", [0, 4])
def test_decode_attention_per_slot_index_matches_reference(window):
    """Every slot attends over its own prefix of the cache."""
    rng = np.random.default_rng(2 + window)
    q = _rand(rng, (3, 1, 8, 16))
    kc = _rand(rng, (3, 24, 2, 16))
    vc = _rand(rng, (3, 24, 2, 16))
    index = np.array([0, 9, 23], np.int32)
    got = attn.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                torch.from_numpy(vc),
                                torch.from_numpy(index), window)
    want = ref_attn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                     jnp.asarray(vc), jnp.asarray(index),
                                     window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


class _Ranks:
    """``n`` ranks as threads, with an all-reduce over them (in rank
    order, so every rank gets the same sum)."""

    def __init__(self, n):
        self.n = n
        self.barrier = threading.Barrier(n)
        self.parts = [None] * n

    def all_reduce(self, rank, t, op):
        self.parts[rank] = t
        self.barrier.wait()
        out = self.parts[0]
        for part in self.parts[1:]:
            out = torch.maximum(out, part) if op == "max" else out + part
        self.barrier.wait()
        return out

    def run(self, fn):
        out = [None] * self.n
        threads = [threading.Thread(target=lambda r=r: out.__setitem__(
            r, fn(r))) for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        return out


@pytest.mark.parametrize("ranges", [2, 3, 4])
@pytest.mark.parametrize("window", [0, 4])
def test_decode_attention_split_matches_reference(window, ranges):
    """The read of a cache whose sequence is split into ``ranges`` equal
    ranges, one a rank, combined from per-range softmax partials, against
    the reference's read of the whole cache: slots at positions 0, 9 and
    23 (most ranges hold no live key of the first, the window empties
    more) and one past the cache at 40 (with the window, no live key
    anywhere: the uniform average).  Every rank gets the same output,
    without NaN."""
    rng = np.random.default_rng(7 + window)
    q = _rand(rng, (4, 1, 8, 16))
    kc = _rand(rng, (4, 24, 2, 16))
    vc = _rand(rng, (4, 24, 2, 16))
    index = np.array([0, 9, 23, 40], np.int32)
    want = ref_attn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                     jnp.asarray(vc), jnp.asarray(index),
                                     window)
    n = 24 // ranges
    group = _Ranks(ranges)
    outs = group.run(lambda r: attn.decode_attention_split(
        torch.from_numpy(q), torch.from_numpy(kc[:, r * n:(r + 1) * n]),
        torch.from_numpy(vc[:, r * n:(r + 1) * n]), torch.from_numpy(index),
        window, r * n, lambda t, op: group.all_reduce(r, t, op)))
    for got in outs:
        assert not torch.isnan(got).any()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


#: query offsets of the offset cases: none, one, inside a chunk, past
#: several chunks and past the window
OFFSETS = (0, 1, 37, 200)


def _offset_inputs(q_offset, window, rep, sq=40):
    """q (1, sq, 2 * rep, 16) at positions q_offset.., k and v (1, q_offset
    + sq + 5, 2, 16): keys past the last query too (causally masked)."""
    rng = np.random.default_rng(100 + q_offset + window + rep)
    skv = q_offset + sq + 5
    return (_rand(rng, (1, sq, 2 * rep, 16)), _rand(rng, (1, skv, 2, 16)),
            _rand(rng, (1, skv, 2, 16)))


@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("window", [0, 23])
@pytest.mark.parametrize("q_offset", OFFSETS)
def test_offset_attention_matches_reference(q_offset, window, rep):
    """A query chunk at ``q_offset``, causal, with and without a window,
    GQA rep 1 and 4: the port's ``chunked_attention`` (its block skip
    shifted by the offset) and ``flash_attention_plain`` (the kernel's
    oracle, (B, H, S, D)) against the reference's ``dense_attention`` and
    its chunked ``flash_attention`` at the same offset, fp32, rtol 1e-5
    (atol ATOL for outputs near 0)."""
    q, k, v = _offset_inputs(q_offset, window, rep)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    dense = np.asarray(ref_attn.dense_attention(
        jq, jk, jv, causal=True, window=window, q_offset=q_offset))
    chunked = np.asarray(ref_attn.flash_attention(
        jq, jk, jv, causal=True, window=window, q_offset=q_offset,
        chunk_q=16, chunk_kv=16))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = attn.chunked_attention(tq, tk, tv, causal=True, window=window,
                                 chunk_q=16, chunk_kv=16,
                                 q_offset=q_offset).numpy()
    plain = fa.flash_attention_plain(
        tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2), True,
        window, q_offset).transpose(1, 2).numpy()
    layout = attn.flash_attention(tq, tk, tv, causal=True, window=window,
                                  q_offset=q_offset).numpy()
    for name, out in (("chunked", got), ("plain", plain),
                      ("model layout", layout)):
        for want in (dense, chunked):
            np.testing.assert_allclose(out, want, rtol=1e-5, atol=ATOL,
                                       err_msg=name)


@pytest.mark.parametrize("window", [0, 23])
@pytest.mark.parametrize("q_offset", OFFSETS[1:])
def test_offset_gradient_matches_autograd_through_plain(q_offset, window):
    """The op's gradient at ``q_offset`` > 0 (the VJP of the chunked
    attention at the offset, in small chunks so that blocks are skipped)
    against autograd through ``flash_attention_plain``."""
    q, k, v = (torch.from_numpy(t).transpose(1, 2)
               for t in _offset_inputs(q_offset, window, 2))
    g = torch.from_numpy(_rand(np.random.default_rng(q_offset),
                               tuple(q.shape)))
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    old = fa.VJP_CHUNKS
    fa.VJP_CHUNKS = (16, 16)
    try:
        got = torch.autograd.grad(fa.flash_attention(
            *leaves, causal=True, window=window, q_offset=q_offset),
            leaves, g)
    finally:
        fa.VJP_CHUNKS = old
    want = torch.autograd.grad(fa.flash_attention_plain(
        *leaves, True, window, q_offset), leaves, g)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=ATOL, err_msg=f"d{name}")


def _pairs_by_mask(sq, skv, q_offset, window):
    """Allowed (query, key) pairs counted on the whole boolean mask."""
    qpos = q_offset + np.arange(sq)[:, None]
    kpos = np.arange(skv)[None, :]
    ok = kpos <= qpos
    if window:
        ok &= qpos - kpos < window
    return int(ok.sum())


@pytest.mark.parametrize("window", [0, 23])
@pytest.mark.parametrize("q_offset", OFFSETS)
def test_flash_cost_counts_the_offset_mask(q_offset, window):
    """``costmodel.flash_attention_cost`` at an offset: 4 D FLOPs a pair
    per head, the pairs those of a brute-force count of the mask."""
    from repro_torch.core.costmodel import flash_attention_cost
    for skv in (q_offset + 40, q_offset + 45, 30):
        q = torch.zeros(2, 3, 40, 16)
        k = torch.zeros(2, 1, skv, 16)
        cost = flash_attention_cost(q, k, k, True, window, q_offset)
        pairs = _pairs_by_mask(40, skv, q_offset, window)
        assert cost.flops == 4.0 * 2 * 3 * 16 * pairs, (skv, pairs)


@pytest.mark.parametrize("s, ways, window", [(32768, 16, 0),
                                             (32768, 16, 1024),
                                             (32832, 16, 0), (64, 4, 0),
                                             (64, 4, 5)])
def test_zigzag_chunks_give_every_rank_the_same_work(s, ways, window):
    """The query-sequence split of a prefill whose heads do not divide
    ``model`` (``transformer._zigzag``): every rank's two chunks cover
    the sequence once between them, each chunk's keys start where its
    window does, and the cost model (with the chunks' offsets, as the dry
    run counts them) sums them to the whole sequence's count.  Causal,
    every rank's pair of chunks counts the same FLOPs within 1%.  With a
    window a row's work is flat past the window's first rows, so every
    rank but rank 0 counts the same within 1%, and rank 0, whose first
    chunk holds those rows, less by their triangle."""
    from repro_torch.core.costmodel import flash_attention_cost
    from repro_torch.models.transformer import _zigzag

    def cost(sq, skv, q_offset):
        q = torch.empty(1, 1, sq, 8, device="meta")
        k = torch.empty(1, 1, skv, 8, device="meta")
        return flash_attention_cost(q, k, k, True, window, q_offset).flops
    rows, flops = [], []
    for r in range(ways):
        chunks = _zigzag(s, ways, r, window)
        assert len(chunks) == 2
        total = 0.0
        for q0, q1, k0 in chunks:
            rows.extend(range(q0, q1))
            assert k0 == (max(0, q0 - window + 1) if window else 0)
            total += cost(q1 - q0, q1 - k0, q0 - k0)
        flops.append(total)
    assert sorted(rows) == list(range(s))
    assert sum(flops) == cost(s, s, 0)
    if not window:
        assert max(flops) / min(flops) - 1 < 0.01, flops
    else:
        assert max(flops) / min(flops[1:]) - 1 < 0.01, flops
        triangle = 4.0 * 8 * window * (window - 1) / 2
        assert flops[0] == max(flops[1:]) - triangle, flops


def test_flash_wrapper_rejects_bad_shapes():
    x = torch.zeros((1, 3, 8, 16))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        fa.flash_attention(x, torch.zeros((1, 2, 8, 16)),
                           torch.zeros((1, 2, 8, 16)))
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(x, x, x, window=-1)
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention(x, x, x, q_offset=-1)
