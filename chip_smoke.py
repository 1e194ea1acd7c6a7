#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100: python3 chip_smoke.py

Drives the port's prediction path on the card at the full width of the
paper's MLP predictor (``MLPConfig()``: 8 hidden layers of 1024, four op
kinds) and checks every phase; any failure exits non-zero.

1. Device: a CUDA GPU of capability (9, 0); its name and power limit.
2. Build: both CUDA kernels from ``src/repro_torch/kernels/csrc``.
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
   version and its bound, printed as one JSON line.
6. Last line: {"ok": true, "device": {...}}.

Weights are random (He init from a numpy seed) and feature statistics
come from the port's own ``build_dataset``: nothing is downloaded.
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
#: the tensor cores, and HBM3 bandwidth.  The kernels run fp32 FFMA.
FP32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
SEED = 0
N_SYNTHETIC = 29
VARYING_PER_KIND = 40          # x 4 kinds = 160 kernel-varying ops
N_ALIKE = 300
DROPPED = ("P4000", "RTX2070", "cpu-host", "tpu-v2", "trainium1")
ORIGINS = ("T4", "V100", "P100", "tpu-v4", "tpu-v5e", "RTX2080Ti")
KINDS = ("bmm", "conv2d", "linear", "recurrent")
ALIKE_KINDS = ("add", "mul", "tanh", "exp", "reduce_sum", "transpose")


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


def breakdown(torch, batched, fms, planner, traces, dests) -> None:
    """Where request (b)'s time goes: the host time of the traces' first
    touch (per-op extraction, memoized on each trace), then the same cold
    sweep again (fresh result, stack and factor caches; the scorer and
    libraries warm) under ``torch.profiler``, printing wall time,
    device-busy time and the device ops that take it.  Its kernel
    launches are not the path's."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    for t in traces:        # a trace's first touch: per-op extraction
        t.to_arrays(refresh=True)
        t.fingerprint()
    log(f"  host: per-op array extraction + fingerprints of the "
        f"{len(traces)} traces ({sum(len(t.ops) for t in traces)} ops): "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    saved = dict(fms.LAUNCHES)
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
    fms.LAUNCHES.update(saved)
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
        saved = dict(fms.LAUNCHES)
        ms = time_ms(torch, lambda: kernel(*args, **kwargs))
        plain_ms = time_ms(torch, lambda: plain(*args), iters=5)
        fms.LAUNCHES.update(saved)      # timing launches are not the path's
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

    breakdown(torch, batched, fms, planner, traces, fleet_minus)

    # -- 6. result lines ----------------------------------------------------
    print(smi_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
