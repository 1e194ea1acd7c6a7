#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100: python3 chip_smoke.py

Drives the port's two paths on the card and checks every phase; any
failure exits non-zero.  The prediction path runs at the full width of
the paper's MLP predictor (``MLPConfig()``: 8 hidden layers of 1024, four
op kinds); the LM serving path runs Qwen3-0.6B and Mamba2-130M at their
published configs (every layer, every width, bf16).

1. Device: a CUDA GPU of capability (9, 0); its name and power limit.
2. Build: all four CUDA kernels from ``src/repro_torch/kernels/csrc``,
   one ``nvcc`` per source, in parallel.
3. Kernels against their plain PyTorch versions on the card at the path's
   shapes (K=4, L=9, H=1024): one kind, all kinds mixed, a lone row,
   bucket padding.  Tolerance: max |kernel - plain| <= 1e-4 * max(1,
   max |plain|) on log-ms (fp32 sums over 1024-long dot products in
   another order, across 9 layers).
4. Path: ``HabitatPredictor(mlps, device="cuda")`` behind ``FleetPlanner``
   over the 3 golden traces and 29 synthetic traces of ResNet-50 size:
   (a) rank by throughput and by cost, (b) a cold sweep over the fleet
   minus 5 devices (exactly one block-kernel launch), (c) a sweep of the
   same traces plus 4 new ones over the whole fleet (cell-masked: exactly
   one row-kernel launch).  Answers are held against the same predictor
   on the CPU with the plain scorer (rtol 1e-4), and an MLP-free predictor
   on the card against every golden value (rel 1e-6).
5. Each kernel timed on the inputs the path gave it, beside its plain
   version and its bound.
6. Flash attention and the SSD scan against their plain versions on the
   card: flash in bf16 and fp32, causal or not, window 0 or 256, GQA rep
   1, 2 and 4, D 64 and 128, lengths off the 64-row tiles (bf16 output
   within 8e-3 * max(1, max |plain|), about two bf16 ulps; fp32 within
   1e-4 * that); SSD at N 64 and 128, P 64, L off the chunk, y and final
   state within 1e-4 * max(1, max |plain|) (fp32 sums in another order).
7. Serving Qwen3-0.6B (28 layers, d_model 1024, 16 / 8 heads of 128,
   vocab 151936): ``ServingEngine(batch=4, max_seq=4112)`` answers 8
   requests of 384-4096 prompt tokens and 16 new tokens each; flash
   launches = prefills x 28.  The same model with plain attention,
   teacher-forced on the same tokens (each prompt's prefill at the
   engine's shapes, then one decode step per generated token), must
   agree.  In fp32, kernel path against plain path at every position:
   logits within FP32_LOGIT_TOL * max |logit|, and equal greedy choices
   wherever the top-2 gap exceeds that.  In bf16, as served: prefill
   logits within the stated bf16 tolerance, and every served token
   wherever the plain top-2 gap exceeds it.  That tolerance is
   max(LOGIT_TOL * the request's max |logit|, twice the bf16 noise
   floor), the floor being the plain bf16 path's largest distance from
   the same model in fp32 over all requests, from which the bf16 kernel
   path may lie no farther than twice the floor.  Where that floor is
   high (Mamba2-130M) the bf16 comparison fails only a grossly wrong
   kernel and compares no token, and the fp32 comparison is the gate.
8. Serving Mamba2-130M (24 layers, d_model 768, d_state 128, 24 heads of
   64, vocab 50280) the same way; SSD launches = prefills x 24.
9. The two new kernels timed on the largest inputs their path gave them,
   beside the plain version, the bound and (flash) SDPA.
10. A line with the card's name and power limit, a ``{"kernels": [...]}``
    line with all four kernels, and last {"ok": true, "device": {...}}.

Weights are random (He init from a numpy seed for the MLPs, a seeded
``torch.Generator`` on the card for the LMs) and feature statistics come
from the port's own ``build_dataset``: nothing is downloaded.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): fp32 outside
#: the tensor cores, bf16 on the tensor cores, and HBM3 bandwidth.  The
#: kernels run fp32 FFMA; a bound counts the fastest way the card has.
FP32_PEAK_FLOPS = 67e12
BF16_PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
SEED = 0
N_SYNTHETIC = 29
VARYING_PER_KIND = 40          # x 4 kinds = 160 kernel-varying ops
N_ALIKE = 300
DROPPED = ("P4000", "RTX2070", "cpu-host", "tpu-v2", "trainium1")
ORIGINS = ("T4", "V100", "P100", "tpu-v4", "tpu-v5e", "RTX2080Ti")
KINDS = ("bmm", "conv2d", "linear", "recurrent")
ALIKE_KINDS = ("add", "mul", "tanh", "exp", "reduce_sum", "transpose")
#: the LM serving runs: prompt lengths from 384 to 4096, five of them off
#: the kernels' 64-row tiles, 16 new tokens each, 4 slots
LM_PROMPT_LENS = (4096, 384, 1000, 2047, 640, 3333, 1500, 777)
LM_MAX_NEW = 16
LM_BATCH = 4
LM_MAX_SEQ = 4112
#: prefill logits of the kernel path against the plain path in bf16: at
#: least 1/32 of the largest logit (4-8 bf16 ulps of it), and at least
#: twice the plain bf16 path's own distance from the same model in fp32
#: (bf16 rounds every layer's output, and a random deep model amplifies
#: those roundings: for Mamba2-130M the distance is near 1 logit)
LOGIT_TOL = 2.0 ** -5
#: the same comparison in fp32: sums in another order through every layer
FP32_LOGIT_TOL = 1e-3


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# inputs: full-width MLPs and traces, all from numpy seeds
# ---------------------------------------------------------------------------
def build_mlps(hidden_layers: int = 8, hidden: int = 1024,
               n_configs: int = 200, seed: int = SEED):
    """Four MLPs of the paper's architecture, He-initialized like the
    reference's ``init_params`` (normal * sqrt(2 / fan_in), zero bias),
    with feature statistics from the port's ``build_dataset``."""
    from repro_torch.core import dataset, devices, mlp
    cfg = dataclasses.replace(mlp.MLPConfig(), in_features=13,
                              hidden_layers=hidden_layers,
                              hidden_size=hidden)
    rng = np.random.default_rng(seed)
    names = sorted(devices.all_devices())
    out = {}
    for kind in KINDS:
        sizes = [cfg.in_features] + [hidden] * hidden_layers + [1]
        params = [((rng.standard_normal((a, b), np.float32)
                    * np.float32(np.sqrt(2.0 / a))),
                   np.zeros(b, np.float32))
                  for a, b in zip(sizes[:-1], sizes[1:])]
        norm = dataset.build_dataset(kind, n_configs, device_names=names,
                                     seed=seed).normalized()
        out[kind] = mlp.TrainedMLP.from_numpy(
            kind, cfg, params, norm.feature_mean, norm.feature_std)
    return out


def _alike_ops(rng, n: int):
    from repro_torch.core.costmodel import OpCost
    from repro_torch.core.trace import Op
    ops = []
    for _ in range(n):
        kind = ALIKE_KINDS[int(rng.integers(len(ALIKE_KINDS)))]
        nbytes = float(np.exp(rng.uniform(np.log(1e4), np.log(1e8))))
        flops = nbytes * float(np.exp(rng.uniform(np.log(0.01),
                                                  np.log(2.0))))
        ops.append(Op(name=kind, kind=kind,
                      cost=OpCost(flops, nbytes * 0.6, nbytes * 0.4),
                      multiplicity=int(rng.integers(1, 4))))
    return ops


def synthetic_trace(i: int, per_kind: int = VARYING_PER_KIND,
                    n_alike: int = N_ALIKE):
    """A measured trace of about ResNet-50 size: ``4 * per_kind``
    kernel-varying ops sampled over the four kinds, ``n_alike`` alike
    ops, simulated on one of ``ORIGINS``."""
    from repro_torch.core import dataset
    from repro_torch.core.trace import TrackedTrace
    rng = np.random.default_rng(1000 + i)
    ops = _alike_ops(rng, n_alike)
    for k, kind in enumerate(KINDS):
        ops += dataset.sample_ops(kind, per_kind, seed=10 * i + k)
    order = rng.permutation(len(ops))
    return TrackedTrace(ops=[ops[j] for j in order],
                        origin_device=ORIGINS[i % len(ORIGINS)],
                        label=f"synthetic-{i}").measure()


def golden():
    from repro_torch.core.trace import TrackedTrace
    blobs = [json.loads(p.read_text())
             for p in sorted((ROOT / "tests" / "golden").glob("*.json"))]
    if len(blobs) != 3:
        fail(f"expected 3 golden traces, found {len(blobs)}")
    return blobs, [TrackedTrace.from_dict(b["trace"]) for b in blobs]


# ---------------------------------------------------------------------------
# the main path, through the entry points a user calls
# ---------------------------------------------------------------------------
class Recorder:
    """Keeps the inputs each kernel wrapper receives on the path (the
    wrapper itself counts its launches)."""

    def __init__(self, fms):
        self.calls = {"fused_mlp_score": [], "fused_mlp_score_rows": []}
        self._fms = fms
        self._orig = {}
        for name in self.calls:
            orig = getattr(fms, name)
            self._orig[name] = orig

            def wrapped(*args, _name=name, _orig=orig, **kwargs):
                self.calls[_name].append((args, kwargs))
                return _orig(*args, **kwargs)
            setattr(fms, name, wrapped)

    def restore(self) -> None:
        for name, orig in self._orig.items():
            setattr(self._fms, name, orig)


def drive_path(planner, traces, new_traces, golden_mixed, fleet_minus,
               counters):
    """Requests (a)-(c); returns their answers and, per request, the wall
    seconds and the deltas of ``counters()``."""
    log_rows = []

    def request(name, fn):
        before = counters()
        t0 = time.perf_counter()
        result = fn()
        seconds = time.perf_counter() - t0
        after = counters()
        delta = {k: after[k] - before[k] for k in after}
        log_rows.append((name, seconds, delta))
        log(f"  request {name}: {seconds * 1e3:.1f} ms wall, "
            f"counts {delta}")
        return result

    rank_t = request("a-rank-throughput",
                     lambda: planner.rank(golden_mixed, 32, by="throughput"))
    rank_c = request("a-rank-cost",
                     lambda: planner.rank(golden_mixed, 32, by="cost"))
    cold = request("b-cold-sweep",
                   lambda: planner.sweep(traces, dests=fleet_minus))
    warm = request("c-masked-sweep",
                   lambda: planner.sweep(traces + new_traces))
    return (rank_t, rank_c, cold, warm), log_rows


def check_answers(answers, traces, new_traces, golden_mixed, fleet_minus,
                  mlps, devs):
    """Hold the card's answers against the same predictor on the CPU with
    the plain scorer: every cell at rtol 1e-4."""
    from repro_torch.core.predictor import HabitatPredictor
    rank_t, rank_c, cold, warm = answers
    cpu = HabitatPredictor(mlps, device="cpu", sweep_scorer="plain")
    everything = traces + new_traces
    want = cpu.predict_sweep(everything, devs).total_ms
    got = np.asarray([[row[d] for d in devs] for row in warm])
    if not np.isfinite(got).all() or (got <= 0).any():
        fail("sweep (c) returned non-finite or non-positive times")
    err = np.max(np.abs(got / want - 1.0))
    log(f"  sweep (c) vs CPU plain: max rel err {err:.3e} over "
        f"{got.size} cells")
    if err > 1e-4:
        fail(f"sweep (c) disagrees with the CPU plain path: {err:.3e}")
    cols = [devs.index(d) for d in fleet_minus]
    got_b = np.asarray([[row[d] for d in fleet_minus] for row in cold])
    err_b = np.max(np.abs(got_b / want[:len(traces)][:, cols] - 1.0))
    log(f"  sweep (b) vs CPU plain: max rel err {err_b:.3e}")
    if err_b > 1e-4:
        fail(f"sweep (b) disagrees with the CPU plain path: {err_b:.3e}")
    fleet = cpu.predict_fleet(golden_mixed, devs).as_dict()
    for choices in (rank_t, rank_c):
        for c in choices:
            if abs(c.iter_ms / fleet[c.device] - 1.0) > 1e-4:
                fail(f"rank {c.device}: {c.iter_ms} vs CPU {fleet[c.device]}")
    times = [c.iter_ms for c in rank_t]
    if times != sorted(times) or len(rank_t) != len(devs):
        fail("rank by throughput is not the whole fleet, fastest first")


def check_golden(device):
    """MLP-free predictor on ``device`` against every golden value."""
    from repro_torch.core import devices
    from repro_torch.core.predictor import HabitatPredictor
    blobs, traces = golden()
    devs = sorted(devices.all_devices())
    configs = {"default": {}, "exact_wave": {"exact_wave": True},
               "model_overhead": {"model_overhead": True}}
    worst = 0.0
    for cfg, kw in configs.items():
        pred = HabitatPredictor(device=device, **kw)
        sweep = pred.predict_sweep(traces, devs).total_ms
        for i, (blob, trace) in enumerate(zip(blobs, traces)):
            want = np.asarray([blob["expected"][cfg][d] for d in devs])
            for got in (pred.predict_fleet(trace, devs).total_ms, sweep[i]):
                worst = max(worst, float(np.max(np.abs(got / want - 1))))
    log(f"  golden: 3 traces x 3 configs x {len(devs)} devices, fleet and "
        f"ragged paths, max rel err {worst:.3e}")
    if worst > 1e-6:
        fail(f"golden values not reproduced: max rel err {worst:.3e}")


# ---------------------------------------------------------------------------
# kernels against their plain versions, timing and bounds
# ---------------------------------------------------------------------------
def kernel_cases(torch, fms, device, K=4, L=9, H=1024, bm=128):
    """(name, wrapper, plain, args) at the path's shapes: one kind, all
    kinds mixed, a lone row, bucket padding."""
    rng = np.random.default_rng(SEED + 7)
    w = torch.from_numpy(rng.standard_normal((K, L, H, H), np.float32)
                         * np.float32(np.sqrt(2.0 / H))).to(device)
    b = torch.from_numpy(rng.standard_normal((K, L, H), np.float32)
                         * np.float32(0.01)).to(device)

    def rows(n):
        x = np.zeros((n, H), np.float32)
        x[:, :13] = rng.standard_normal((n, 13))
        return x

    def put(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in arrays]

    cases = []
    blocks = {"one-kind": [2] * 4, "mixed": [0, 1, 2, 3, 3, 2, 1, 0],
              "lone-row": [3]}
    for case, kinds in blocks.items():
        x = rows(len(kinds) * bm)
        if case == "lone-row":
            x[1:] = 0.0
        cases.append(("fused_mlp_score", case,
                      put(x, np.asarray(kinds, np.int32)) + [w, b]))
    nb = fms.bucket_blocks(5)                   # 5 real blocks -> 8
    kinds = np.zeros(nb, np.int32)
    kinds[:5] = [1, 1, 3, 0, 2]
    x = rows(nb * bm)
    x[5 * bm:] = 0.0
    cases.append(("fused_mlp_score", "bucket-padding",
                  put(x, kinds) + [w, b]))

    row_kinds = {"one-kind": np.full(2 * bm, 1, np.int32),
                 "mixed": rng.integers(0, K, 4 * bm).astype(np.int32)}
    lone = np.zeros(bm, np.int32)
    lone[0] = 3
    row_kinds["lone-row"] = lone
    m = 3 * bm + 17
    padded = fms.bucket_blocks(-(-m // bm)) * bm
    pad = np.zeros(padded, np.int32)
    pad[:m] = rng.integers(0, K, m)
    row_kinds["bucket-padding"] = pad
    for case, kinds in row_kinds.items():
        x = rows(len(kinds))
        if case == "lone-row":
            x[1:] = 0.0
        if case == "bucket-padding":
            x[m:] = 0.0
        cases.append(("fused_mlp_score_rows", case,
                      put(x, kinds) + [w, b]))
    return cases


def compare(torch, fms, name, args, kwargs=None):
    """max |kernel - plain| and the stated tolerance on these inputs."""
    plain = getattr(fms, f"{name}_plain")
    want = plain(*args)
    got = getattr(fms, name)(*args, **(kwargs or {}))
    torch.cuda.synchronize()
    err = float((got - want).abs().max().item())
    tol = 1e-4 * max(1.0, float(want.abs().max().item()))
    return err, tol


def time_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Median of per-call CUDA-event times (ms)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(name, args) -> tuple:
    """(bound_ms, bound_by): the larger of FLOPs over the fp32 peak and
    bytes over HBM bandwidth, for this call's data: each row through its
    own kind's L layers of 2*H^2, each input read once (weights of the
    kinds present only), the output written once."""
    x, kinds, w, _ = args
    bsz, hdim = x.shape
    nl = w.shape[1]
    present = len(set(kinds.cpu().tolist()))
    flops = bsz * nl * 2.0 * hdim * hdim
    nbytes = (x.numel() * 4 + kinds.numel() * 4 + bsz * 4
              + present * nl * (hdim * hdim + hdim) * 4)
    t_flops = flops / FP32_PEAK_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return ((t_flops, "operations") if t_flops >= t_bytes
            else (t_bytes, "bytes"))


def breakdown(torch, batched, planner, traces, dests) -> None:
    """Where request (b)'s time goes: the host time of the traces' first
    touch (per-op extraction, memoized on each trace), then the same cold
    sweep again (fresh result, stack and factor caches; the scorer and
    libraries warm) under ``torch.profiler``, printing wall time,
    device-busy time and the device ops that take it.  It runs after the
    path's launches were read."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    for t in traces:        # a trace's first touch: per-op extraction
        t.to_arrays(refresh=True)
        t.fingerprint()
    log(f"  host: per-op array extraction + fingerprints of the "
        f"{len(traces)} traces ({sum(len(t.ops) for t in traces)} ops): "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    planner.clear_cache()
    batched.STACK_CACHE.clear()
    batched.WAVE_FACTOR_CACHE.clear()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        planner.sweep(traces, dests=dests)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = (getattr(e, "self_device_time_total", 0)
              or getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us / 1e3, e.key, e.count))
    busy_ms = sum(r[0] for r in rows)
    if not rows:
        log("  breakdown: the profiler recorded no device time")
        return
    log(f"  breakdown of a cold sweep (b) under the profiler: wall "
        f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({busy_ms / wall_ms:.1%}), idle {1 - busy_ms / wall_ms:.1%}")
    for ms, key, count in sorted(rows, reverse=True)[:8]:
        log(f"    {ms:9.3f} ms  x{count:<5d} {key[:90]}")


# ---------------------------------------------------------------------------
# the LM serving path: flash attention and the SSD scan
# ---------------------------------------------------------------------------
#: b, h, kv, sq, skv, d, causal, window
FLASH_CASES = [
    (1, 16, 8, 1000, 1000, 128, True, 0),
    (2, 8, 8, 300, 300, 64, True, 256),
    (1, 16, 4, 777, 777, 128, True, 256),
    (1, 8, 2, 200, 450, 64, False, 0),
    (1, 16, 8, 513, 513, 128, False, 256),
]
#: b, h, l, p, n, chunk
SSD_CASES = [
    (1, 24, 1000, 64, 128, 64),
    (2, 8, 333, 64, 64, 64),
]


def _max_err(torch, got, want, rel):
    """max |got - want| and the tolerance rel * max(1, max |want|)."""
    torch.cuda.synchronize()
    want = want.float()
    err = float((got.float() - want).abs().max().item())
    return err, rel * max(1.0, float(want.abs().max().item()))


def lm_kernel_checks(torch, fa, sk, device) -> dict:
    """Phase 6: both kernels against their plain versions; the worst
    |err| of each."""
    worst = {"flash_attention": 0.0, "ssd": 0.0}
    gen = torch.Generator(device=device).manual_seed(SEED + 11)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    for b, h, kv, sq, skv, d, causal, window in FLASH_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (randn(b, n, s_, d).to(dtype)
                       for n, s_ in ((h, sq), (kv, skv), (kv, skv)))
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            want = fa.flash_attention_plain(q, k, v, causal, window)
            err, tol = _max_err(torch, got, want,
                                8e-3 if dtype == torch.bfloat16 else 1e-4)
            worst["flash_attention"] = max(worst["flash_attention"], err)
            log(f"  flash {str(dtype)[6:]} B{b} H{h}/KV{kv} Sq{sq} Skv{skv} "
                f"D{d} causal={causal} window={window}: max |err| "
                f"{err:.3e} (tol {tol:.3e})")
            if not err <= tol:
                fail("flash_attention disagrees with its plain version")
    for b, h, l, p, n, chunk in SSD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            x = randn(b, h, l, p).to(dtype)
            dt = 0.01 + 0.19 * torch.rand((b, h, l), generator=gen,
                                          device=device)
            a = -(0.5 + 3.5 * torch.rand((h,), generator=gen, device=device))
            bm = randn(b, 1, l, n).to(dtype).expand(b, h, l, n)
            cm = randn(b, 1, l, n).to(dtype).expand(b, h, l, n)
            y, st = sk.ssd(x, dt, a, bm, cm, chunk=chunk)
            want_y, want_st = sk.ssd_plain(x, dt, a, bm, cm)
            for got, want, what in ((y, want_y, "y"), (st, want_st, "state")):
                err, tol = _max_err(torch, got, want, 1e-4)
                worst["ssd"] = max(worst["ssd"], err)
                log(f"  ssd {str(dtype)[6:]} B{b} H{h} L{l} P{p} N{n} "
                    f"chunk {chunk} {what}: max |err| {err:.3e} "
                    f"(tol {tol:.3e})")
                if not err <= tol:
                    fail(f"ssd {what} disagrees with its plain version")
    return worst


def device_profile(torch, fn, top: int = 6) -> None:
    """Run ``fn`` once under ``torch.profiler``; print wall, device-busy
    time and the device ops that take it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = (getattr(e, "self_device_time_total", 0)
              or getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us / 1e3, e.key, e.count))
    if not rows:
        log(f"    wall {wall_ms:.1f} ms; the profiler recorded no device "
            f"time")
        return
    busy_ms = sum(r[0] for r in rows)
    log(f"    wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({busy_ms / wall_ms:.1%}), idle {1 - busy_ms / wall_ms:.1%}")
    for ms, key, count in sorted(rows, reverse=True)[:top]:
        log(f"    {ms:9.3f} ms  x{count:<5d} {key[:90]}")


def _fp32_copy(tfm, params):
    """The same model with every bf16 tensor widened to fp32."""
    up = lambda t: t.float() if t.dtype == params["embed"].dtype else t
    top = {k: up(t) for k, t in params.named_parameters(recurse=False)}
    return tfm.LMParams(top, [{k: up(t) for k, t in layer.items()}
                              for layer in params.layers])


def serve_lm(torch, cfg, device, kmod, kname: str, kernel_mods) -> dict:
    """Phases 7-8: serve ``LM_PROMPT_LENS`` through ``ServingEngine`` with
    ``cfg`` on ``device``, with every kernel count set to 0 just before
    and read just after; then hold the answers against the same model on
    its kernel's plain version, teacher-forced.  Returns the path's
    launches of ``kname`` and the largest inputs it was given."""
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import Request, ServingEngine
    arch = cfg.name
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, seed=SEED, device=device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params.parameters())
    log(f"  {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}, {n_params / 1e6:.1f} M parameters in "
        f"{cfg.param_dtype}, made on {device} in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 21)
    reqs = [Request(uid=i, prompt=rng.integers(2, cfg.vocab_size, n,
                                               dtype=np.int32),
                    max_new_tokens=LM_MAX_NEW)
            for i, n in enumerate(LM_PROMPT_LENS)]
    engine = ServingEngine(cfg, params, batch=LM_BATCH, max_seq=LM_MAX_SEQ,
                           device=device)

    rec = {"prefill": [], "decode_ms": [], "args": None}
    orig = {"prefill": tfm.prefill, "decode_step": tfm.decode_step,
            "kernel": getattr(kmod, kname)}

    def prefill(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, state = orig["prefill"](*args)
        torch.cuda.synchronize()
        rec["prefill"].append(((time.perf_counter() - t) * 1e3,
                               logits[0, -1].float()))
        return logits, state

    def decode_step(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig["decode_step"](*args)
        torch.cuda.synchronize()
        rec["decode_ms"].append((time.perf_counter() - t) * 1e3)
        return out

    def kernel(*args, **kwargs):   # keeps the largest inputs (axis 2)
        if rec["args"] is None or \
                args[0].shape[2] >= rec["args"][0][0].shape[2]:
            rec["args"] = (args, kwargs)
        return orig["kernel"](*args, **kwargs)

    tfm.prefill, tfm.decode_step = prefill, decode_step
    setattr(kmod, kname, kernel)
    try:
        for mod in kernel_mods:
            mod.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = engine.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for mod in kernel_mods
                    for k, v in mod.LAUNCHES.items()}
    finally:
        tfm.prefill, tfm.decode_step = orig["prefill"], orig["decode_step"]
        setattr(kmod, kname, orig["kernel"])

    n_pre = len(rec["prefill"])
    toks = sum(len(r.output) for r in done)
    pre_ms = [ms for ms, _ in rec["prefill"]]
    log(f"  served {len(done)}/{len(reqs)} requests, {toks} tokens in "
        f"{wall:.2f} s ({toks / wall:.1f} tok/s); {n_pre} prefills, "
        f"{len(rec['decode_ms'])} decode ticks")
    log("  prefill ms per prompt: " + ", ".join(
        f"{n}: {ms:.1f}" for n, ms in zip(LM_PROMPT_LENS, pre_ms)))
    dec = np.asarray(rec["decode_ms"])
    log(f"  decode ms per tick (batch {LM_BATCH}, cache {LM_MAX_SEQ}): "
        f"median {np.median(dec):.2f}, min {dec.min():.2f}, "
        f"max {dec.max():.2f}")
    log(f"  launches on the path: {launches}")
    if len(done) != len(reqs) or n_pre != len(reqs):
        fail(f"{arch}: served {len(done)} of {len(reqs)} requests with "
             f"{n_pre} prefills")
    if launches[kname] != n_pre * cfg.n_layers:
        fail(f"{arch}: {kname} launched {launches[kname]} times, want "
             f"{n_pre} prefills x {cfg.n_layers} layers")
    for other, n in launches.items():
        if other != kname and n:
            fail(f"{arch}: {other} launched {n} times on this path")

    # the kernel against its plain version on the largest inputs the
    # path gave it (these launches are not the path's)
    plain = getattr(kmod, f"{kname}_plain")
    args, kwargs = rec["args"]
    got = orig["kernel"](*args, **kwargs)
    want = plain(*args, **{k: v for k, v in kwargs.items() if k != "chunk"})
    rel = 8e-3 if kname == "flash_attention" and \
        args[0].dtype == torch.bfloat16 else 1e-4
    path_err = 0.0
    for g, w in (zip(got, want) if isinstance(got, tuple) else [(got, want)]):
        err, tol = _max_err(torch, g, w, rel)
        path_err = max(path_err, err)
        if not err <= tol:
            fail(f"{kname} on the path's inputs: |err| {err:.3e} > {tol:.3e}")
    log(f"  {kname} on the path's largest inputs "
        f"({'x'.join(str(n) for n in args[0].shape)}): max |kernel - plain| "
        f"{path_err:.3e}")
    del got, want

    # the same model on the plain version, teacher-forced on the same
    # tokens: each prompt's prefill (the engine's shapes), then one decode
    # step per generated token; in bf16 as served, and in fp32 through the
    # kernel and through the plain version
    def plain_call(*args, **kwargs):
        kwargs.pop("chunk", None)          # the plain scan has no chunk
        return plain(*args, **kwargs)

    def teacher_forced(impl, model, model_cfg, req, out):
        """Logits (len(out), V) fp32: the prompt's last position, then
        after each generated token but the last."""
        setattr(kmod, kname, impl)
        try:
            prompt = torch.as_tensor(req.prompt[None, :], device=device)
            logits, state = orig["prefill"](model, model_cfg, prompt,
                                            LM_MAX_SEQ)
            rows = [logits[0, -1].float()]
            for tok in out[:-1]:
                tok = torch.full((1, 1), int(tok), device=device)
                logits, state = orig["decode_step"](model, model_cfg, tok,
                                                    state)
                rows.append(logits[0, -1].float())
            return torch.stack(rows)
        finally:
            setattr(kmod, kname, orig["kernel"])

    def decisions(rows, out, tol):
        """(compared, skipped): ``out`` must be the argmax of ``rows``
        wherever the top-2 gap exceeds ``tol``."""
        top = torch.topk(rows, 2, dim=-1)
        gaps = (top.values[:, 0] - top.values[:, 1]).cpu().numpy()
        best = top.indices[:, 0].cpu().numpy()
        clear = gaps > tol
        if (best[clear] != np.asarray(out)[clear]).any():
            fail(f"{arch}: greedy tokens disagree where the top-2 gap "
                 f"exceeds {tol:.3e}")
        return int(clear.sum()), int((~clear).sum())

    p32 = _fp32_copy(tfm, params)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    by_uid = {r.uid: r for r in done}
    t0 = time.perf_counter()
    dist = lambda u, v: float((u - v).abs().max().item())
    worst32, counts32 = 0.0, [0, 0]
    bf16 = []       # per request: (plain rows, tokens, scale, distances)
    for i, req in enumerate(reqs):
        out = by_uid[i].output
        got = rec["prefill"][i][1]
        if not torch.isfinite(got).all():
            fail(f"{arch}: non-finite prefill logits for request {i}")
        rows = teacher_forced(plain_call, params, cfg, req, out)
        truth = teacher_forced(plain_call, p32, cfg32, req, out)
        kernel32 = teacher_forced(orig["kernel"], p32, cfg32, req, out)
        scale = max(1.0, float(truth.abs().max().item()))
        err32 = dist(kernel32, truth)
        tol32 = FP32_LOGIT_TOL * scale
        worst32 = max(worst32, err32 / scale)
        if not err32 <= tol32:
            fail(f"{arch}: request {i} logits differ from the plain path by "
                 f"{err32:.3e} > {tol32:.3e} (fp32)")
        c = decisions(truth, kernel32.argmax(-1).cpu().numpy(), tol32)
        counts32 = [counts32[0] + c[0], counts32[1] + c[1]]
        bf16.append((rows, out, scale, dist(rows[0], truth[0]),
                     dist(got, truth[0]), dist(got, rows[0])))
        del truth, kernel32
    del p32

    # bf16, as served.  The noise floor is the plain bf16 path's largest
    # distance from the same model in fp32 over every request; the bf16
    # kernel path may lie no farther than twice that from fp32, and its
    # prefill logits no farther than the bf16 tolerance from the plain
    # path's, max(LOGIT_TOL * the request's max |logit|, twice the floor)
    floor = max(r[3] for r in bf16)
    tols = [max(LOGIT_TOL * r[2], 2 * floor) for r in bf16]
    counts16 = [0, 0]
    for i, ((rows, out, _, _, far, err), tol) in enumerate(zip(bf16, tols)):
        if not far <= 2 * floor:
            fail(f"{arch}: request {i}'s bf16 kernel path lies {far:.4f} "
                 f"from the fp32 model, over twice the floor {floor:.4f}")
        if not err <= tol:
            fail(f"{arch}: request {i} prefill logits differ from the plain "
                 f"path by {err:.3e} > {tol:.3e} (bf16)")
        c = decisions(rows, out, tol)
        counts16 = [counts16[0] + c[0], counts16[1] + c[1]]
    log(f"  teacher-forced on all {len(reqs)} requests "
        f"({time.perf_counter() - t0:.1f} s).  fp32: logits max |kernel - "
        f"plain| {worst32:.2e} of the scale (tol {FP32_LOGIT_TOL:g}), "
        f"greedy choices equal at {counts32[0]} positions ({counts32[1]} "
        f"within the tolerance skipped).  bf16: noise floor {floor:.4f} "
        f"(largest logit {max(r[2] for r in bf16):.3f}), kernel path at "
        f"most {max(r[4] for r in bf16):.4f} from fp32 (limit "
        f"{2 * floor:.4f}), prefill logits max |kernel - plain| "
        f"{max(r[5] for r in bf16):.4f} (tol {min(tols):.4f}-"
        f"{max(tols):.4f} by request), served tokens "
        f"equal the plain greedy choice at {counts16[0]} positions "
        f"({counts16[1]} skipped)")
    if counts16[0] == 0:
        # a floor this high (the random bf16 Mamba2-130M) lets the bf16
        # comparison fail only a grossly wrong kernel and compare no token
        log("  the bf16 tolerance leaves no greedy decision to compare: in "
            "bf16 only a grossly wrong kernel fails; the fp32 comparison is "
            "this path's gate")
    del bf16

    longest = torch.as_tensor(reqs[0].prompt[None, :], device=device)
    log(f"  breakdown of one prefill of {longest.shape[1]} tokens under "
        f"the profiler:")
    device_profile(torch, lambda: tfm.prefill(params, cfg, longest,
                                              LM_MAX_SEQ))
    token = torch.as_tensor(engine.last_token, device=device)
    log(f"  breakdown of one decode tick (batch {LM_BATCH}, cache "
        f"{LM_MAX_SEQ}):")
    device_profile(torch, lambda: tfm.decode_step(params, cfg, token,
                                                  engine.state))
    del engine, params
    torch.cuda.empty_cache()
    return {"launches": launches[kname], "args": rec["args"],
            "max_abs_err": path_err}


def flash_bound(args) -> tuple:
    """(bound_ms, bound_by) of one flash call: 4 D FLOPs per allowed
    (query, key) pair per head (q.k and p.v) over the bf16 tensor-core
    peak (fp32 inputs: the fp32 peak), against q, k, v read once and o
    written once over HBM bandwidth."""
    (q, k, v), kw = args[0][:3], args[1]
    b, h, sq, d = q.shape
    skv = k.shape[2]
    causal, window = kw.get("causal", True), int(kw.get("window", 0))
    i = np.arange(sq)
    hi = np.minimum(i, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros(sq)
    pairs = float(np.maximum(0, hi - lo + 1).sum())
    flops = 4.0 * b * h * d * pairs
    peak = FP32_PEAK_FLOPS if q.dtype.itemsize == 4 else BF16_PEAK_FLOPS
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    t_flops = flops / peak * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return ((t_flops, "operations") if t_flops >= t_bytes
            else (t_bytes, "bytes"))


def ssd_bound(args) -> tuple:
    """(bound_ms, bound_by) of one SSD call: the scan's cheapest exact
    FLOP count, whatever the kernel's own chunk, over the fp32 peak;
    against x, dt, a, b, c (each stored element once: b and c are shared
    by the heads) read once and y and the state written once.  In chunks
    of Q the scan costs per (b, h), over chunks of r rows, r(r+1)(N + P)
    FLOPs for the causal scores and their product with x, 4 r N P for the
    readout and rank-1 update against the carried state, and N P for the
    state's decay once a chunk; the bound takes the least over Q (Q = 1 is
    the sequential recurrence)."""
    x, dt, a, bm = args[0][:4]
    b, h, l, p = x.shape
    n = bm.shape[-1]

    def per_head(q: int) -> float:
        rows = np.full(l // q, q, np.float64)
        if l % q:
            rows = np.append(rows, l % q)
        return float((rows * (rows + 1) * (n + p)).sum()
                     + (4 * l + len(rows)) * n * p)

    flops = b * h * min(per_head(q) for q in range(1, min(l, 256) + 1))
    heads = 1 if bm.stride(1) == 0 else h
    nbytes = (x.numel() * x.element_size() + dt.numel() * 4 + a.numel() * 4
              + 2 * b * heads * l * n * bm.element_size()
              + b * h * l * p * 4 + b * h * n * p * 4)
    t_flops = flops / FP32_PEAK_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return ((t_flops, "operations") if t_flops >= t_bytes
            else (t_bytes, "bytes"))


def sdpa_ms(torch, args):
    """Time of PyTorch's fused attention on the same inputs (yardstick
    only: the port never calls it), and its max |diff| from the plain
    version."""
    import torch.nn.functional as F
    (q, k, v), kw = args[0][:3], args[1]
    causal = kw.get("causal", True)
    if int(kw.get("window", 0)):
        return None, None       # SDPA has no sliding window
    call = lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True)
    return time_ms(torch, call), call()


def main() -> int:
    # -- 1. device ----------------------------------------------------------
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no repro_torch package under {SRC}: run from a checkout")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    cap = torch.cuda.get_device_capability(0)
    name = torch.cuda.get_device_name(0)
    log(f"[1 device] {name}, capability {cap}, "
        f"{torch.cuda.device_count()} visible, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    if cap != (9, 0):
        fail(f"needs capability (9, 0) (Hopper), got {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout else ""
    if smi.returncode != 0 or not smi_line:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")

    # -- 2. build -----------------------------------------------------------
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_mlp_score as fms
    seconds = build.build_all()
    built = sorted(build.BUILD_LOG)
    log(f"[2 build] {seconds:.1f} s (nvcc, sm_90a); built now: "
        f"{built or 'none, the libraries were already built'}")
    for kname, text in build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {kname}: {line.strip()}")

    # -- 3. kernels against their plain versions ----------------------------
    log("[3 kernels vs plain] K=4, L=9, H=1024, block_m=128")
    worst = {"fused_mlp_score": 0.0, "fused_mlp_score_rows": 0.0}
    for kname, case, args in kernel_cases(torch, fms, device):
        err, tol = compare(torch, fms, kname, args, {"block_m": 128})
        worst[kname] = max(worst[kname], err)
        log(f"  {kname} {case}: rows {args[0].shape[0]}, max |err| "
            f"{err:.3e} (tol {tol:.3e})")
        if not err <= tol:
            fail(f"{kname} {case} disagrees with its plain version")

    # -- 4. the main path ---------------------------------------------------
    from repro_torch.core import batched, devices
    from repro_torch.core.predictor import HabitatPredictor
    from repro_torch.serve.fleet import FleetPlanner
    log("[4 path] building MLPs (MLPConfig(): 8 x 1024, 4 kinds) and "
        "traces")
    t0 = time.perf_counter()
    mlps = build_mlps()
    blobs, gold = golden()
    traces = gold + [synthetic_trace(i) for i in range(N_SYNTHETIC)]
    new_traces = [synthetic_trace(100 + i) for i in range(4)]
    golden_mixed = next(t for t in gold if t.label == "golden-mixed")
    devs = sorted(devices.all_devices())
    fleet_minus = [d for d in devs if d not in DROPPED]
    n_var = sum(int(t.to_arrays().kernel_varying.sum()) for t in traces)
    log(f"  inputs ready in {time.perf_counter() - t0:.1f} s: "
        f"{len(traces)} traces ({n_var} kernel-varying ops), "
        f"{len(new_traces)} new, fleet {len(devs)} / minus "
        f"{len(fleet_minus)}")
    planner = FleetPlanner(HabitatPredictor(mlps, device="cuda"))
    recorder = Recorder(fms)

    def counters():
        return {**fms.LAUNCHES, **{f"dispatch_{k}": v for k, v in
                                    batched.SCORER_DISPATCHES.snapshot()
                                    .items()}}

    fms.reset_launches()
    batched.SCORER_DISPATCHES.reset()
    answers, rows = drive_path(planner, traces, new_traces, golden_mixed,
                               fleet_minus, counters)
    launches = dict(fms.LAUNCHES)
    recorder.restore()
    deltas = {r[0]: r[2] for r in rows}
    if deltas["b-cold-sweep"]["fused_mlp_score"] != 1 or \
            deltas["b-cold-sweep"]["fused_mlp_score_rows"] != 0:
        fail(f"sweep (b) must launch the block kernel once: "
             f"{deltas['b-cold-sweep']}")
    if deltas["c-masked-sweep"]["fused_mlp_score_rows"] != 1 or \
            deltas["c-masked-sweep"]["fused_mlp_score"] != 0:
        fail(f"sweep (c) must launch the row kernel once: "
             f"{deltas['c-masked-sweep']}")
    for kname, n in launches.items():
        if n < 1:
            fail(f"{kname} was never launched on the main path")
    log(f"  launches on the path: {launches}")
    log(f"  answers: {len(answers[2])} x {len(fleet_minus)} (b), "
        f"{len(answers[3])} x {len(devs)} (c); fastest for golden-mixed: "
        f"{answers[0][0].device}, best samples/$: {answers[1][0].device}")
    check_answers(answers, traces, new_traces, golden_mixed, fleet_minus,
                  mlps, devs)
    check_golden(device)

    # -- 5. kernel timings on the path's own inputs -------------------------
    log("[5 timing] on the inputs the path gave each kernel")
    sources = {"fused_mlp_score": ("fused_mlp_score.cu", 125),
               "fused_mlp_score_rows": ("fused_mlp_score_rows.cu", 237)}
    kernels = []
    for kname, calls in recorder.calls.items():
        args, kwargs = calls[-1]
        err, tol = compare(torch, fms, kname, args, kwargs)
        if not err <= tol:
            fail(f"{kname} on the path's inputs: |err| {err:.3e} > {tol:.3e}")
        worst[kname] = max(worst[kname], err)
        plain = getattr(fms, f"{kname}_plain")
        kernel = getattr(fms, kname)
        ms = time_ms(torch, lambda: kernel(*args, **kwargs))
        plain_ms = time_ms(torch, lambda: plain(*args), iters=5)
        bound_ms, bound_by = bound(kname, args)
        src, line = sources[kname]
        log(f"  {kname}: rows {args[0].shape[0]}, {ms:.3f} ms (plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms by {bound_by} at "
            f"fp32 {FP32_PEAK_FLOPS / 1e12:g} TFLOP/s and HBM "
            f"{HBM_BYTES_PER_S / 1e12:g} TB/s: {bound_ms / ms:.1%} of peak)")
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/fused_mlp_score.py:{line}",
            "launches": launches[kname], "max_abs_err": worst[kname],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None})

    breakdown(torch, batched, planner, traces, fleet_minus)

    # -- 6. the LM path's kernels against their plain versions --------------
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd as sk
    log("[6 LM kernels vs plain] flash attention and the SSD scan")
    lm_worst = lm_kernel_checks(torch, fa, sk, device)
    kernel_mods = (fms, fa, sk)

    # -- 7-8. the LM serving path -------------------------------------------
    lm_runs = {}
    from repro_torch.configs import get_config
    for phase, arch, kmod, kname in ((7, "qwen3-0.6b", fa, "flash_attention"),
                                     (8, "mamba2-130m", sk, "ssd")):
        log(f"[{phase} serve] {arch}: {len(LM_PROMPT_LENS)} requests, "
            f"prompts {min(LM_PROMPT_LENS)}-{max(LM_PROMPT_LENS)} tokens, "
            f"{LM_MAX_NEW} new tokens, batch {LM_BATCH}, max_seq "
            f"{LM_MAX_SEQ}")
        lm_runs[kname] = serve_lm(torch, get_config(arch), device, kmod,
                                  kname, kernel_mods)

    # -- 9. the LM kernels timed on the largest inputs their path gave ------
    log("[9 timing] flash attention and the SSD scan on their path's "
        "largest inputs")
    lm_sources = {"flash_attention": ("flash_attention", 78, flash_bound),
                  "ssd": ("ssd", 72, ssd_bound)}
    for kmod, kname in ((fa, "flash_attention"), (sk, "ssd")):
        args, kwargs = lm_runs[kname]["args"]
        kernel = getattr(kmod, kname)
        plain = getattr(kmod, f"{kname}_plain")
        plain_kwargs = {k: v for k, v in kwargs.items() if k != "chunk"}
        lm_worst[kname] = max(lm_worst[kname], lm_runs[kname]["max_abs_err"])
        ms = time_ms(torch, lambda: kernel(*args, **kwargs))
        plain_ms = time_ms(torch, lambda: plain(*args, **plain_kwargs),
                           iters=10 if kname == "flash_attention" else 3,
                           warmup=1)
        library_ms = None
        if kname == "flash_attention":
            library_ms, lib_out = sdpa_ms(torch, (args, kwargs))
            if lib_out is not None:
                diff = _max_err(torch, lib_out,
                                plain(*args, **plain_kwargs), 8e-3)[0]
                log(f"  SDPA vs plain on these inputs: max |diff| "
                    f"{diff:.3e}")
        src, line, bound_fn = lm_sources[kname]
        bound_ms, bound_by = bound_fn((args, kwargs))
        shape = "x".join(str(n) for n in args[0].shape)
        log(f"  {kname}: {args[0].dtype} {shape}, {ms:.3f} ms (plain "
            f"{plain_ms:.3f} ms, library "
            f"{'none' if library_ms is None else f'{library_ms:.3f} ms'}, "
            f"bound {bound_ms:.4f} ms by {bound_by}: {bound_ms / ms:.1%} of "
            f"peak)")
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}.cu",
            "replaces": f"src/repro/kernels/{src}.py:{line}",
            "launches": lm_runs[kname]["launches"],
            "max_abs_err": lm_worst[kname], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms})

    # -- 10. result lines ---------------------------------------------------
    print(smi_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
