#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100: python3 chip_smoke.py

Drives the port's three paths on the card and checks every phase; any
failure exits non-zero.  The prediction path runs at the full width of
the paper's MLP predictor (``MLPConfig()``: 8 hidden layers of 1024, four
op kinds); the LM serving path runs Qwen3-0.6B and Mamba2-130M at their
published configs (every layer, every width, bf16); the training path
trains the default predictor and the paper's full-width MLPs on the card
and serves them through the ``fused_mlp`` kernel.

1. Device: a CUDA GPU of capability (9, 0); its name and power limit.
2. Build: all five CUDA kernels from ``src/repro_torch/kernels/csrc``,
   one ``nvcc`` per source, in parallel; ptxas's registers and spills per
   entry function, and counts of the tensor-core MMAs, ``ldmatrix``
   loads, ``cp.async`` copies and FFMAs in each library's SASS
   (``cuobjdump -sass``): flash attention and the SSD scan must hold bf16
   ``HMMA``s, both scorers and ``fused_mlp`` tf32 ones (3xTF32).
3. Kernels against their plain PyTorch versions on the card at the path's
   shapes (K=4, L=9, H=1024): one kind, all kinds mixed, a lone row,
   bucket padding, and the first layer over ``in_features`` = 13 (zero
   W[., 0] rows past it, an x tail that is not zero); for the row scorer
   also kinds changing within every 16-row MMA tile, and one row of an
   out-of-range kind (NaN on that row only).  Tolerance: max |kernel -
   plain| <= 1e-4 * max(1, max |plain|) on log-ms (fp32 sums over
   1024-long dot products in another order, across 9 layers).
4. Path: ``HabitatPredictor(mlps, device="cuda")`` behind ``FleetPlanner``
   over the 3 golden traces and 29 synthetic traces of ResNet-50 size:
   (a) rank by throughput and by cost, (b) a cold sweep over the fleet
   minus 5 devices (exactly one block-kernel launch), (c) a sweep of the
   same traces plus 4 new ones over the whole fleet (cell-masked: exactly
   one row-kernel launch).  Answers are held against the same predictor
   on the CPU with the plain scorer (rtol 1e-4), and an MLP-free predictor
   on the card against every golden value (rel 1e-6).
5. Each kernel timed on the inputs the path gave it, beside its plain
   version and its bound (both: 3xTF32 on the tensor cores, which the
   kernels line carries, and fp32 FFMA, in the log); sweep (c)'s real and
   padded row counts and the kind mix of its row tiles, and the row
   scorer timed again on those rows padded to the engine's earlier
   ``bucket_blocks`` bucket, the rows its FFMA kernel was timed on; then
   requests (b) and (c) again under ``torch.profiler`` (device busy time
   and the kernels that take it).
6. Flash attention and the SSD scan against their plain versions on the
   card: flash in bf16 (the tensor-core kernel) and fp32 (FFMA), causal
   or not, window 0, 100 or 256, GQA rep 1, 2, 4 and 8, D 16 to 128,
   lengths off the 16-row fragments and 64-key tiles (each output row
   within FLASH_BF16_REL = 8e-3 * max(max |plain row|, FLASH_ROW_FLOOR)
   in bf16, one to two bf16 ulps of the row; fp32 within 1e-4 * that);
   SSD in bf16 (tensor cores, fp32 operands split in two bf16 terms) and
   fp32 at N 64 and 128, P 64, L from 1 to the path's 4096 at H 24, off
   the chunk and on it, chunk 16 and 64, b and c shared by the heads or
   not, y and final state within 1e-4 * max(1, max |plain|) (fp32 sums
   in another order).
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
9. The two LM kernels timed on the largest inputs their path gave them,
   beside the plain version, the bound, (flash) SDPA and, in the log
   text only, the first kernel's time before the tensor-core redesign (a
   constant from PERF.md).  Phases 5, 9 and 13 time every call twice:
   with a spin kernel ahead (the device time, in the kernels line) and
   without (the host's enqueue inside the events too).
10. Training, default predictor: ``default_predictor(force_retrain=True)``
    trains the four kinds (3 x 256, 30 epochs) on the card from the port's
    datasets (2,000 configurations x 15 devices) and seals them under
    ``artifacts/mlps/``; each kind's test MAPE within TEST_MAPE_BAND of the
    reference's.  ``train_mlps()`` then loads all four without training,
    to the same numbers exactly, and ``TrackedTrace.to_device`` and
    ``rank_devices(predictor=None)`` on the golden traces agree with the
    same MLPs on the CPU (rtol 1e-4).
11. Training at full width: ``MLPConfig()`` (8 x 1024, batch 512, 80
    epochs) for the four kinds on the same datasets, after a gate that the
    card takes the CPU's first TRAIN_PARITY_STEPS steps (each from the
    CPU's state: see ``train_parity``); the device busy share of training
    steps.
12. ``fused_mlp``: the eight trained MLPs served through the kernel over
    their kinds' 6,000 test rows (every kernel count set to 0 before phase
    10 and read here: one launch a served MLP), the first layer over the
    features as ``serve_trained`` calls it, held against the plain chain
    (1e-4 * max(1, max |plain|) on log-ms) and ``predict_ms`` (rtol
    1e-4); then constructed cases, B 1-6000, (L, H) up to (9, 1024), with
    the launches counted exactly.
13. ``fused_mlp`` timed on the path's largest inputs (L 9, H 1024, 6,000
    rows) and at the default predictor's L 4, H 256, with both bounds.
14. A line with the card's name and power limit, a ``{"kernels": [...]}``
    line with all five kernels, and last {"ok": true, "device": {...}}.

Weights are random (He init from a numpy seed for the serving MLPs, a
seeded ``torch.Generator`` on the card for the LMs) or trained here, and
feature statistics and training data come from the port's own
``build_dataset``: nothing is downloaded.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): fp32 outside
#: the tensor cores, bf16 and tf32 on the tensor cores (dense), and HBM3
#: bandwidth.  A bound counts the work at the rate of the units the kernel
#: runs it on: an fp32 product in 3xTF32 as three tf32 products.
FP32_PEAK_FLOPS = 67e12
BF16_PEAK_FLOPS = 989e12
TF32_PEAK_FLOPS = 495e12
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
#: test MAPE of the reference's default predictor (``DEFAULT_MLP_CFG``: 3
#: hidden layers of 256, 30 epochs, seed 0, on 2,000 configurations over the
#: 15-device registry), computed by the JAX package on the CPU and read from
#: its sealed artifacts under ``artifacts/mlps/``: accuracy, not speed
REFERENCE_TEST_MAPE = {"bmm": 0.0846, "conv2d": 0.1509, "linear": 0.0764,
                       "recurrent": 0.1463}
#: each kind's test MAPE, trained on the card, may lie at most this factor
#: above the reference's (the port's own spread over seeds is in PERF.md)
TEST_MAPE_BAND = 1.5
#: the card against the CPU over the first steps of a full-width training,
#: each step from the CPU's state on the CPU's batch: the step's loss and
#: the next batch's loss after the card's update within this relative
#: tolerance (fp32 sums in another order, through one Adam update)
TRAIN_PARITY_STEPS = 20
TRAIN_PARITY_RTOL = 1e-4
#: the paper's MLPConfig() trains 80 epochs, the lr switching at 40
FULL_WIDTH_EPOCHS = 80
#: fused_mlp's constructed cases: (L, H) by rows, ragged and whole tiles
FUSED_MLP_SHAPES = ((3, 64), (4, 128), (9, 64), (4, 256), (9, 1024))
FUSED_MLP_ROWS = (1, 37, 256, 6000)


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
    wrapper itself counts its launches) and, per row-scorer call, the real
    and padded row counts (``pad_rows_to_blocks``)."""

    def __init__(self, fms):
        self.calls = {"fused_mlp_score": [], "fused_mlp_score_rows": []}
        self.row_counts = []
        self._fms = fms
        self._orig = {}
        for name in self.calls:
            orig = getattr(fms, name)
            self._orig[name] = orig

            def wrapped(*args, _name=name, _orig=orig, **kwargs):
                self.calls[_name].append((args, kwargs))
                return _orig(*args, **kwargs)
            setattr(fms, name, wrapped)
        pad = self._orig["pad_rows_to_blocks"] = fms.pad_rows_to_blocks

        def padded(xn, *args, **kwargs):
            out = pad(xn, *args, **kwargs)
            self.row_counts.append((xn.shape[0], out[0].shape[0]))
            return out
        fms.pad_rows_to_blocks = padded

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
    """(name, case, args, kwargs) at the path's shapes: one kind, all
    kinds mixed, a lone row, bucket padding and the first layer over
    ``in_features`` = 13 for both scorers; for the row scorer also kinds
    changing within every 16-row MMA tile (all four kinds in each)."""
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
                      put(x, np.asarray(kinds, np.int32)) + [w, b], {}))
    nb = fms.bucket_blocks(5)                   # 5 real blocks -> 8
    kinds = np.zeros(nb, np.int32)
    kinds[:5] = [1, 1, 3, 0, 2]
    x = rows(nb * bm)
    x[5 * bm:] = 0.0
    cases.append(("fused_mlp_score", "bucket-padding",
                  put(x, kinds) + [w, b], {}))
    w13 = w.clone()                 # the packing's zero rows past 13
    w13[:, 0, 13:] = 0.0
    x = rng.standard_normal((16 * bm, H)).astype(np.float32)
    cases.append(("fused_mlp_score", "in-features",
                  put(x, np.arange(16, dtype=np.int32) % K) + [w13, b],
                  {"in_features": 13}))

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
    # every 16-row MMA tile a shuffle of four rows of each kind
    row_kinds["every-mma-tile-mixed"] = rng.permuted(
        np.tile(np.arange(16, dtype=np.int32) % K, (2 * bm // 16, 1)),
        axis=1).reshape(-1)
    for case, kinds in row_kinds.items():
        x = rows(len(kinds))
        if case == "lone-row":
            x[1:] = 0.0
        if case == "bucket-padding":
            x[m:] = 0.0
        cases.append(("fused_mlp_score_rows", case,
                      put(x, kinds) + [w, b], {}))
    x = rng.standard_normal((4 * bm, H)).astype(np.float32)
    cases.append(("fused_mlp_score_rows", "in-features",
                  put(x, rng.integers(0, K, 4 * bm).astype(np.int32))
                  + [w13, b], {"in_features": 13}))
    return cases


def out_of_range_kind_case(torch, fms, device, K=4, L=9, H=1024, bm=128):
    """The row kernel with one row of kind K among 2 * bm rows: NaN on that
    row, every other row within the kernel gate of the plain version (run
    with that row's kind set to 0).  Returns (max |err|, tolerance)."""
    rng = np.random.default_rng(SEED + 8)
    w = torch.from_numpy(rng.standard_normal((K, L, H, H), np.float32)
                         * np.float32(np.sqrt(2.0 / H))).to(device)
    b = torch.from_numpy(rng.standard_normal((K, L, H), np.float32)
                         * np.float32(0.01)).to(device)
    x = torch.from_numpy(rng.standard_normal((2 * bm, H), np.float32)
                         ).to(device)
    kinds = torch.from_numpy(rng.integers(0, K, 2 * bm).astype(np.int32)
                             ).to(device)
    bad = 37
    kinds[bad] = K
    got = fms.fused_mlp_score_rows(x, kinds, w, b, block_m=bm)
    kinds[bad] = 0
    want = fms.fused_mlp_score_rows_plain(x, kinds, w, b)
    torch.cuda.synchronize()
    others = torch.arange(2 * bm, device=device) != bad
    if not bool(got[bad].isnan()):
        fail(f"fused_mlp_score_rows: row {bad} of kind {K} gave "
             f"{float(got[bad])}, not NaN")
    err = float((got[others] - want[others]).abs().max().item())
    return err, 1e-4 * max(1.0, float(want[others].abs().max().item()))


def compare(torch, fms, name, args, kwargs=None):
    """max |kernel - plain| and the stated tolerance on these inputs."""
    plain = getattr(fms, f"{name}_plain")
    want = plain(*args)
    got = getattr(fms, name)(*args, **(kwargs or {}))
    torch.cuda.synchronize()
    err = float((got - want).abs().max().item())
    tol = 1e-4 * max(1.0, float(want.abs().max().item()))
    return err, tol


#: clock cycles of the spin kernel ahead of each timed call (about 1 ms)
SPIN_CYCLES = 2_000_000


#: kernels whose products run on the tensor cores, and the operand type
#: of the MMA phase 2 requires in their SASS (``HMMA.16816.F32.BF16``,
#: ``HMMA.1688.F32.TF32``)
TENSOR_CORE_KERNELS = {"flash_attention": "BF16", "ssd": "BF16",
                       "fused_mlp_score": "TF32",
                       "fused_mlp_score_rows": "TF32", "fused_mlp": "TF32"}


def sass_ops(text: str) -> dict:
    """Counts of the tensor-core MMAs (HMMA), the shared-memory matrix
    loads (LDSM), the asynchronous copies (LDGSTS) and the fp32 FMAs
    (FFMA) in a SASS listing."""
    ops = re.findall(r"\b((?:HMMA|LDSM|LDGSTS)\.[\w.]+|FFMA(?:\.[\w.]+)?)\b",
                     text)
    return dict(sorted(collections.Counter(ops).items()))


def has_mma(ops: dict, operand: str) -> bool:
    """Does a ``sass_ops`` count hold a tensor-core MMA on ``operand``?"""
    return any(op.startswith("HMMA.") and op.endswith("." + operand)
               for op in ops)


def ptxas_lines(text: str) -> list:
    """ptxas's ``-v`` report as (entry function, registers, spill line)."""
    rows, entry, spill = [], "?", ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry, spill = m.group(1), ""
        elif "spill" in line:
            spill = line.strip()
        else:
            m = re.search(r"Used (\d+) registers", line)
            if m:
                rows.append((entry, int(m.group(1)), spill))
    return rows


def time_ms(torch, fn, iters: int = 10, warmup: int = 2,
            spin: bool = True) -> float:
    """Median of per-call CUDA-event times (ms) of the device work ``fn``
    enqueues.  With ``spin`` a spin kernel of about 1 ms
    (``torch.cuda._sleep``) goes ahead of each timed call, so the host's
    time to enqueue it (a wrapper's checks and allocations, about 0.1 ms
    on that host) passes behind the spin and the events bracket the
    device work; a call whose host work outlasts the spin (the plain SSD
    scan's thousands of launches) is timed with its host gaps.  Without
    it the events, recorded on an idle card, also hold the enqueue."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def time_both(torch, fn, **kw) -> tuple:
    """(ms, ms without the spin) of ``time_ms`` in one run: the first is
    the device time that the kernels line carries, the second holds the
    host's enqueue too, so a change of timing method and a change of
    kernel can be told apart."""
    return time_ms(torch, fn, **kw), time_ms(torch, fn, spin=False, **kw)


def ms_text(t: tuple) -> str:
    """A ``time_both`` pair as log text."""
    return f"{t[0]:.3f} ms [{t[1]:.3f} without the spin]"


def chain_work(x, w) -> tuple:
    """(FLOPs, bytes) that one packed MLP's chain ``w`` (L, H, H) needs for
    the rows ``x`` (n, H), each input read once: the first layer over the
    input columns that are non-zero in both x and W[0] (the packing pads
    the 13 features with zeros), the hidden layers whole, and only column
    0 of the last layer, which is all the function returns."""
    nl, hdim = w.shape[0], w.shape[-1]
    k_in = int(((x != 0).any(0) & (w[0] != 0).any(1)).sum())
    widths = [k_in] + [hdim] * (nl - 1) + [1]
    pairs = list(zip(widths[:-1], widths[1:]))
    flops = x.shape[0] * sum(2.0 * a * b for a, b in pairs)
    nbytes = (x.shape[0] * k_in + sum(a * b + b for a, b in pairs)) * 4
    return flops, nbytes


def roofline(flops: float, nbytes: float,
             peak: float = FP32_PEAK_FLOPS) -> tuple:
    """(bound_ms, bound_by): the larger of FLOPs over ``peak`` and bytes
    over HBM bandwidth."""
    t_flops = flops / peak * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return ((t_flops, "operations") if t_flops >= t_bytes
            else (t_bytes, "bytes"))


def chain_bounds(name, flops: float, nbytes: float) -> tuple:
    """(bound, FFMA bound), each (bound_ms, bound_by): the work at the
    rate of the units kernel ``name`` runs it on (3xTF32: each fp32
    product as three tf32 products at the dense tf32 peak), and the same
    work on fp32 FFMA, the bound of the earlier FFMA kernels, for
    comparison."""
    ffma = roofline(flops, nbytes)
    if TENSOR_CORE_KERNELS.get(name) == "TF32":
        return roofline(3 * flops, nbytes, TF32_PEAK_FLOPS), ffma
    return ffma, ffma


def bound_text(bounds: tuple, ms: float) -> str:
    """A ``chain_bounds`` pair and the share of each as log text."""
    (b, by), (f, _) = bounds
    text = f"bound {b:.4f} ms by {by}: {b / ms:.1%} of peak"
    if b != f:
        text += f"; FFMA bound {f:.4f} ms: {f / ms:.1%}"
    return text


def bound(name, args) -> tuple:
    """``chain_bounds`` of one scorer call for this call's data: each row
    through what its own kind's chain needs (``chain_work``), the kinds
    read once, the output written once."""
    x, kinds, w, _ = args
    bsz = x.shape[0]
    row_kinds = (kinds if kinds.numel() == bsz
                 else kinds.repeat_interleave(bsz // kinds.numel()))
    flops, nbytes = 0.0, (kinds.numel() + bsz) * 4
    for k in sorted(set(kinds.cpu().tolist())):
        f, nb = chain_work(x[row_kinds == k], w[k])
        flops, nbytes = flops + f, nbytes + nb
    return chain_bounds(name, flops, nbytes)


def rows_on_the_old_bucket(torch, fms, recorder) -> None:
    """Phase 5, the row scorer on sweep (c): its real and padded row
    counts, how many of its row tiles hold 1, 2, 3 and 4 kinds, and the
    kernel timed again on the same real rows padded as the engine padded
    them before (a ``bucket_blocks`` bucket of zero rows of kind 0), the
    rows the FFMA kernel was timed on; log text only."""
    args, kwargs = recorder.calls["fused_mlp_score_rows"][-1]
    m, padded = recorder.row_counts[-1]
    x, kinds, w, b = args
    bm = kwargs["block_m"]
    mix = collections.Counter(
        len(np.unique(tile)) for tile in kinds.reshape(-1, bm).cpu().numpy())
    log(f"  sweep (c): {m} real rows padded to {padded}; its {padded // bm} "
        f"tiles of {bm} rows holding 1, 2, 3, 4 kinds: "
        f"{[mix.get(n, 0) for n in range(1, 5)]}")
    nb = fms.bucket_blocks(-(-m // bm)) * bm
    xb = torch.zeros((nb, x.shape[1]), dtype=x.dtype, device=x.device)
    kb = torch.zeros(nb, dtype=kinds.dtype, device=x.device)
    xb[:m], kb[:m] = x[:m], kinds[:m]
    bucketed = (xb, kb, w, b)
    err, tol = compare(torch, fms, "fused_mlp_score_rows", bucketed, kwargs)
    if not err <= tol:
        fail(f"fused_mlp_score_rows on the bucketed rows: |err| {err:.3e} > "
             f"{tol:.3e}")
    ms = time_both(torch, lambda: fms.fused_mlp_score_rows(*bucketed,
                                                           **kwargs))
    ffma = FFMA_KERNEL_MS["fused_mlp_score_rows"]
    log(f"  fused_mlp_score_rows on those rows in the old bucket: rows {nb}, "
        f"max |err| {err:.3e} (tol {tol:.3e}), {ms_text(ms)} "
        f"({bound_text(bound('fused_mlp_score_rows', bucketed), ms[0])}; "
        f"the FFMA kernel {ffma:.3f} ms on such rows, {ffma / ms[0]:.2f}x)")


def device_rows(torch, prof) -> list:
    """(device ms, name, count) of each device op the profiler recorded.
    User annotations (``Optimizer.step#AdamW.step``) span the kernels they
    enclose on the device timeline and are left out, as torch's own table
    leaves them out of its device total."""
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False):
            continue
        us = (getattr(e, "self_device_time_total", 0)
              or getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us / 1e3, e.key, e.count))
    return rows


def breakdown(torch, batched, planner, traces, new_traces, dests) -> None:
    """Where requests (b) and (c) spend their time: the host time of the
    traces' first touch (per-op extraction, memoized on each trace), then
    the same cold sweep (b) again (fresh result, stack and factor caches;
    the scorer and libraries warm) and after it the same cell-masked sweep
    (c), each under ``torch.profiler``, printing wall time, device-busy
    time and the device ops that take it.  It runs after the path's
    launches were read."""
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
    for name, fn in (("a cold sweep (b)",
                      lambda: planner.sweep(traces, dests=dests)),
                     ("a cell-masked sweep (c)",
                      lambda: planner.sweep(traces + new_traces))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = device_rows(torch, prof)
        busy_ms = sum(r[0] for r in rows)
        if not rows:
            log(f"  breakdown of {name}: the profiler recorded no device "
                f"time")
            continue
        log(f"  breakdown of {name} under the profiler: wall "
            f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
            f"({busy_ms / wall_ms:.1%}), idle {1 - busy_ms / wall_ms:.1%}")
        for ms, key, count in sorted(rows, reverse=True)[:8]:
            log(f"    {ms:9.3f} ms  x{count:<5d} {key[:90]}")


# ---------------------------------------------------------------------------
# the LM serving path: flash attention and the SSD scan
# ---------------------------------------------------------------------------
#: b, h, kv, sq, skv, d, causal, window; the bf16 kernel's risky cases too:
#: lengths around its 16-row fragments and 64-key tiles, GQA rep 1-8, a
#: window starting inside a key tile, every head dim
FLASH_CASES = [
    (1, 16, 8, 1000, 1000, 128, True, 0),
    (2, 8, 8, 300, 300, 64, True, 256),
    (1, 16, 4, 777, 777, 128, True, 256),
    (1, 8, 2, 200, 450, 64, False, 0),
    (1, 16, 8, 513, 513, 128, False, 256),
    (1, 16, 8, 17, 17, 128, True, 0),
    (1, 8, 1, 65, 65, 64, True, 100),
    (2, 4, 4, 64, 64, 32, True, 0),
    (1, 4, 1, 333, 90, 16, False, 0),
]
#: b, h, l, p, n, chunk, b and c shared by the heads (head stride 0); the
#: last case's P, N and chunk are off the kernel's 16-padding and its rows
#: off 16 bytes (staged element by element, not by cp.async)
SSD_CASES = [
    (1, 24, 1000, 64, 128, 64, True),
    (2, 8, 333, 64, 64, 64, True),
    (1, 24, 4096, 64, 128, 64, True),
    (1, 2, 1, 64, 128, 64, True),
    (2, 3, 128, 64, 128, 16, False),
    (1, 2, 50, 20, 24, 10, True),
]


def _max_err(torch, got, want, rel):
    """max |got - want| and the tolerance rel * max(1, max |want|)."""
    torch.cuda.synchronize()
    want = want.float()
    err = float((got.float() - want).abs().max().item())
    return err, rel * max(1.0, float(want.abs().max().item()))


#: flash attention's bf16 gate, per output row: one to two bf16 ulps of
#: the row's largest value (kernel and plain round fp32 results apart)
FLASH_BF16_REL = 8e-3
#: the floor under a row's max |plain| in flash's gate (a row of zeros)
FLASH_ROW_FLOOR = 1e-3


def _flash_err(torch, got, want, rel):
    """Flash attention's gate, row by row: every output row (b, h, s)
    within rel * max(max |plain row|, FLASH_ROW_FLOOR).  Returns the
    (err, tol) of the row with the largest err / tol, and the max |err|
    over all rows.  Per row because a causal row's scale falls with its
    length: row 0 is v_0, of order 1, while a row over 4096 keys averages
    to a few hundredths, so a tile dropped or mis-masked late in a long
    row moves it far less than a tolerance taken from the whole tensor's
    max."""
    torch.cuda.synchronize()
    want = want.float()
    err = (got.float() - want).abs().amax(-1).flatten()
    tol = (rel * want.abs().amax(-1).clamp_min(FLASH_ROW_FLOOR)).flatten()
    i = int((err / tol).argmax())
    return float(err[i]), float(tol[i]), float(err.max())


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
            err, tol, top = _flash_err(torch, got, want, FLASH_BF16_REL
                                       if dtype == torch.bfloat16 else 1e-4)
            worst["flash_attention"] = max(worst["flash_attention"], top)
            log(f"  flash {str(dtype)[6:]} B{b} H{h}/KV{kv} Sq{sq} Skv{skv} "
                f"D{d} causal={causal} window={window}: worst row max "
                f"|err| {err:.3e} (its tol {tol:.3e}, {err / tol:.3f} of "
                f"it); max |err| {top:.3e}")
            if not err <= tol:
                fail("flash_attention disagrees with its plain version")
    for b, h, l, p, n, chunk, shared in SSD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            x = randn(b, h, l, p).to(dtype)
            dt = 0.01 + 0.19 * torch.rand((b, h, l), generator=gen,
                                          device=device)
            a = -(0.5 + 3.5 * torch.rand((h,), generator=gen, device=device))
            g = 1 if shared else h
            bm = randn(b, g, l, n).to(dtype).expand(b, h, l, n)
            cm = randn(b, g, l, n).to(dtype).expand(b, h, l, n)
            y, st = sk.ssd(x, dt, a, bm, cm, chunk=chunk)
            want_y, want_st = sk.ssd_plain(x, dt, a, bm, cm)
            for got, want, what in ((y, want_y, "y"), (st, want_st, "state")):
                err, tol = _max_err(torch, got, want, 1e-4)
                worst["ssd"] = max(worst["ssd"], err)
                log(f"  ssd {str(dtype)[6:]} B{b} H{h} L{l} P{p} N{n} "
                    f"chunk {chunk} b, c {'shared' if shared else 'per head'}"
                    f" {what}: max |err| {err:.3e} "
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
    rows = device_rows(torch, prof)
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
    path_err, checks = 0.0, []
    for g, w in (zip(got, want) if isinstance(got, tuple) else [(got, want)]):
        if kname == "flash_attention":
            err, tol, top = _flash_err(
                torch, g, w, FLASH_BF16_REL
                if args[0].dtype == torch.bfloat16 else 1e-4)
        else:
            err, tol = _max_err(torch, g, w, 1e-4)
            top = err
        path_err = max(path_err, top)
        checks.append(f"{err:.3e} (tol {tol:.3e})")
        if not err <= tol:
            fail(f"{kname} on the path's inputs: |err| {err:.3e} > {tol:.3e}")
    what = ("worst row max |kernel - plain|" if kname == "flash_attention"
            else "max |kernel - plain| of y, state")
    log(f"  {kname} on the path's largest inputs "
        f"({'x'.join(str(n) for n in args[0].shape)}): {what} "
        f"{', '.join(checks)}; max |kernel - plain| {path_err:.3e}")
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
    return roofline(flops, nbytes, peak)


def ssd_bound(args) -> tuple:
    """(bound_ms, bound_by) of one SSD call: the scan's cheapest exact
    FLOP count, whatever the kernel's own chunk, each FLOP at the rate the
    kernel runs it; against x, dt, a, b, c (each stored element once: b
    and c are shared by the heads) read once and y and the state written
    once.  In chunks of Q the scan costs per (b, h), over chunks of r
    rows, r(r+1) N FLOPs for the causal scores c b^T, r(r+1) P for their
    product with x, 4 r N P for the readout and rank-1 update against the
    carried state, and N P for the state's decay once a chunk; the bound
    takes the least time over Q (Q = 1 is the sequential recurrence).
    fp32 inputs: every FLOP at the fp32 peak.  bf16 inputs run the
    products on the bf16 tensor cores, the scores once (both operands
    exact in bf16) and the other three as two bf16 products each (the
    fp32 operand split in two terms), so those FLOPs count twice at the
    bf16 peak and the decay at the fp32 peak: the share of the bound is
    not flattered by the split."""
    x, dt, a, bm = args[0][:4]
    b, h, l, p = x.shape
    n = bm.shape[-1]
    tc = x.dtype.itemsize == 2
    mma_peak = BF16_PEAK_FLOPS if tc else FP32_PEAK_FLOPS
    split = 2.0 if tc else 1.0

    def per_head_s(q: int) -> float:
        rows = np.full(l // q, q, np.float64)
        if l % q:
            rows = np.append(rows, l % q)
        pairs = float((rows * (rows + 1)).sum())
        mma = pairs * n + split * (pairs * p + 4 * l * n * p)
        return mma / mma_peak + len(rows) * n * p / FP32_PEAK_FLOPS

    seconds = b * h * min(per_head_s(q) for q in range(1, min(l, 256) + 1))
    heads = 1 if bm.stride(1) == 0 else h
    nbytes = (x.numel() * x.element_size() + dt.numel() * 4 + a.numel() * 4
              + 2 * b * heads * l * n * bm.element_size()
              + b * h * l * p * 4 + b * h * n * p * 4)
    t_ops, t_bytes = seconds * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sdpa_ms(torch, args):
    """``time_both`` of PyTorch's fused attention on the same inputs
    (yardstick only: the port never calls it), and its output."""
    import torch.nn.functional as F
    (q, k, v), kw = args[0][:3], args[1]
    causal = kw.get("causal", True)
    if int(kw.get("window", 0)):
        return None, None       # SDPA has no sliding window
    call = lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True)
    return time_both(torch, call), call()


# ---------------------------------------------------------------------------
# the MLP training path and the fused_mlp kernel
# ---------------------------------------------------------------------------
def train_default(torch, device) -> tuple:
    """Phase 10: ``default_predictor(force_retrain=True)`` trains the four
    kinds on ``device`` and seals them; ``train_mlps()`` then loads all
    four from the cache without training, to the same numbers; the trained
    predictor behind ``TrackedTrace.to_device`` and ``rank_devices`` agrees
    with the same MLPs on a CPU predictor.  Returns (datasets by kind, the
    trained MLPs)."""
    from repro_torch.core import cost, devices, mlp, predictor
    from repro_torch.core import dataset as dataset_mod
    from repro_torch.core.predictor import HabitatPredictor
    builds, trains = {}, []
    orig_build, orig_train = dataset_mod.build_dataset, mlp.train

    def build(kind, *args, **kwargs):
        t0 = time.perf_counter()
        ds = orig_build(kind, *args, **kwargs)
        builds[kind] = (time.perf_counter() - t0, ds)
        return ds

    def train(ds, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_train(ds, *args, **kwargs)
        torch.cuda.synchronize()
        trains.append((ds.kind, time.perf_counter() - t0))
        return out

    cfg = predictor.DEFAULT_MLP_CFG
    dataset_mod.build_dataset, mlp.train = build, train
    try:
        fresh = dict(predictor.default_predictor(force_retrain=True,
                                                 device=device).mlps)
        n_trained = len(trains)
        again = predictor.train_mlps(device=device)
        retrained = len(trains) - n_trained
    finally:
        dataset_mod.build_dataset, mlp.train = orig_build, orig_train
    seconds = dict(trains[:n_trained])
    datasets = {k: ds for k, (_, ds) in builds.items()}
    for kind in KINDS:
        n_rows = int(0.8 * len(datasets[kind].y))
        steps = cfg.epochs * -(-n_rows // cfg.batch_size)
        m = fresh[kind]
        log(f"  {kind}: dataset {len(datasets[kind].y)} rows in "
            f"{builds[kind][0]:.2f} s; trained {steps} steps in "
            f"{seconds[kind]:.2f} s ({seconds[kind] / steps * 1e3:.3f} ms a "
            f"step); test_mape {m.test_mape:.4f} (reference "
            f"{REFERENCE_TEST_MAPE[kind]:.4f}, ratio "
            f"{m.test_mape / REFERENCE_TEST_MAPE[kind]:.3f})")
        if not m.test_mape <= TEST_MAPE_BAND * REFERENCE_TEST_MAPE[kind]:
            fail(f"{kind}: test_mape {m.test_mape:.4f} is over "
                 f"{TEST_MAPE_BAND} x the reference's "
                 f"{REFERENCE_TEST_MAPE[kind]:.4f}")
    if retrained or sorted(again) != sorted(KINDS):
        fail(f"train_mlps() retrained {retrained} kinds instead of loading "
             f"all four from the cache")
    for kind in KINDS:
        feats = torch.as_tensor(datasets[kind].x[:2000]).to(device)
        same = all(np.array_equal(a, b) for pa, pb in
                   zip(again[kind].params, fresh[kind].params)
                   for a, b in zip(pa, pb))
        if not same or not torch.equal(again[kind].predict_ms(feats),
                                       fresh[kind].predict_ms(feats)):
            fail(f"{kind}: the cached artifact does not reproduce the "
                 f"freshly trained model exactly")
    log("  train_mlps(): all four kinds loaded from the cache, 0 trained; "
        "parameters and predictions equal to the fresh ones exactly")

    cpu = HabitatPredictor(fresh, device="cpu")
    _, gold = golden()
    devs = sorted(devices.all_devices())
    worst = 0.0
    for trace in gold:
        for dest in devs:
            got = trace.to_device(dest, device=device).run_time_ms
            want = cpu.predict_trace(trace, dest).run_time_ms
            worst = max(worst, abs(got / want - 1.0))
        ranked = cost.rank_devices(trace, 32, devs, device=device)
        want = {c.device: c.iter_ms for c in
                cost.rank_devices(trace, 32, devs, predictor=cpu)}
        if sorted(c.device for c in ranked) != devs:
            fail("rank_devices did not rank the whole fleet")
        for c in ranked:
            worst = max(worst, abs(c.iter_ms / want[c.device] - 1.0))
        times = [c.iter_ms for c in ranked]
        if times != sorted(times):
            fail("rank_devices by throughput is not fastest first")
    log(f"  to_device and rank_devices(predictor=None) on the 3 golden "
        f"traces x {len(devs)} devices: max rel err {worst:.3e} against the "
        f"same MLPs on the CPU")
    if worst > 1e-4:
        fail(f"the trained predictor on {device} disagrees with the CPU: "
             f"{worst:.3e}")
    return datasets, fresh


def train_parity(torch, ds, cfg, device) -> None:
    """The gate of phase 11: the card takes the CPU's training steps.

    Full-width training is chaotic: from initial weights that differ by
    1e-7 relative, the CPU's own losses part by about 1e-2 within 20
    steps (Adam moves every weight by about the learning rate, whatever
    the sign noise of its gradient).  So each of the first
    TRAIN_PARITY_STEPS steps starts on the card from the CPU's state
    (parameters, Adam moments, step count) on the CPU's batch: the step's
    loss and the loss of the card's updated parameters on the next batch
    must match the CPU's within TRAIN_PARITY_RTOL.  The free-running card
    and a CPU run from perturbed weights are printed beside, ungated."""
    from repro_torch.core import mlp
    cpu = torch.device("cpu")
    norm = ds.normalized()
    tr, _ = norm.split(0.8, seed=cfg.seed)
    cfg = dataclasses.replace(cfg, in_features=tr.x.shape[1])
    init = mlp.init_params(cfg, "cpu")
    perm = np.random.default_rng(cfg.seed).permutation(len(tr.y))
    data = {d: (torch.as_tensor(tr.x).to(d),
                torch.as_tensor(np.log(np.maximum(tr.y, 1e-9))).to(d))
            for d in (cpu, device)}

    def batch(d, step):
        idx = torch.as_tensor(perm[step * cfg.batch_size:
                                   (step + 1) * cfg.batch_size]).to(d)
        return data[d][0][idx], data[d][1][idx]

    def trainer(d, scale=1.0):
        params = [((w * scale).to(d).requires_grad_(),
                   b.clone().to(d).requires_grad_()) for w, b in init]
        return params, mlp._optimizer(params, cfg)

    def flat(params):
        return [t for pair in params for t in pair]

    def run(d, scale=1.0):
        params, opt = trainer(d, scale)
        return np.asarray([float(mlp._train_step(params, opt, *batch(d, k),
                                                 cfg.lr))
                           for k in range(TRAIN_PARITY_STEPS)])

    host, host_opt = trainer(cpu)
    card, card_opt = trainer(device)
    step_rel, next_rel, card_next, losses = 0.0, 0.0, None, []
    for k in range(TRAIN_PARITY_STEPS):
        with torch.no_grad():
            for h, c in zip(flat(host), flat(card)):
                c.copy_(h)
                state = host_opt.state.get(h)
                card_opt.state.pop(c, None)
                if state:
                    card_opt.state[c] = {n: v.clone().to(device)
                                         for n, v in state.items()}
        loss = float(mlp._train_step(host, host_opt, *batch(cpu, k), cfg.lr))
        got = float(mlp._train_step(card, card_opt, *batch(device, k),
                                    cfg.lr))
        step_rel = max(step_rel, abs(got / loss - 1.0))
        if card_next is not None:
            next_rel = max(next_rel, abs(card_next / loss - 1.0))
        if k + 1 < TRAIN_PARITY_STEPS:
            with torch.no_grad():
                card_next = float(mlp.male_loss(card, *batch(device, k + 1)))
        losses.append(loss)
    free = np.abs(run(device) / np.asarray(losses) - 1.0)
    floor = np.abs(run(cpu, 1.0 + 1e-7) / np.asarray(losses) - 1.0)
    log(f"  {ds.kind}: the first {TRAIN_PARITY_STEPS} steps, each from the "
        f"CPU's state on the CPU's batch: step loss max rel diff "
        f"{step_rel:.3e}, next-batch loss after the card's update "
        f"{next_rel:.3e} (tol {TRAIN_PARITY_RTOL:g}); losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    log(f"  ungated: the free-running card against the CPU, max rel diff "
        f"{free.max():.3e} (at step {int(free.argmax()) + 1}); the CPU "
        f"from weights x (1 + 1e-7), {floor.max():.3e} (at step "
        f"{int(floor.argmax()) + 1})")
    if not (step_rel <= TRAIN_PARITY_RTOL and next_rel <= TRAIN_PARITY_RTOL):
        fail(f"training on {device} departs from the CPU's steps: "
             f"{step_rel:.3e}, {next_rel:.3e}")


def train_full_width(torch, device, datasets, cfg=None) -> dict:
    """Phase 11: the paper's ``MLPConfig()`` (8 x 1024, batch 512; or
    ``cfg``) trained on ``device`` for all four kinds, after the gate of
    ``train_parity``; the device busy share of training steps under the
    profiler.  Returns the trained MLPs."""
    from repro_torch.core import mlp
    cfg = cfg or dataclasses.replace(mlp.MLPConfig(),
                                     epochs=FULL_WIDTH_EPOCHS)
    kind = KINDS[0]
    train_parity(torch, datasets[kind], cfg, device)
    out = {}
    n_rows = int(0.8 * len(datasets[kind].y))
    steps = cfg.epochs * -(-n_rows // cfg.batch_size)
    for kind in KINDS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[kind] = mlp.train(datasets[kind], cfg, device=device)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        log(f"  {kind}: {cfg.hidden_layers} x {cfg.hidden_size}, "
            f"{cfg.epochs} epochs, {steps} steps in {secs:.2f} s "
            f"({secs / steps * 1e3:.3f} ms a step); test_mape "
            f"{out[kind].test_mape:.4f}")

    # ten steady steps under the profiler
    cfg = dataclasses.replace(cfg, in_features=13)
    params = [(w.requires_grad_(), b.requires_grad_())
              for w, b in mlp.init_params(cfg, device)]
    opt = mlp._optimizer(params, cfg)
    gen = torch.Generator(device=device).manual_seed(SEED)
    x = torch.randn((cfg.batch_size, 13), generator=gen, device=device)
    logy = torch.randn((cfg.batch_size,), generator=gen, device=device)
    step = lambda: mlp._train_step(params, opt, x, logy, cfg.lr)
    for _ in range(3):
        step()
    log(f"  breakdown of 10 training steps ({cfg.hidden_layers} x "
        f"{cfg.hidden_size}, batch {cfg.batch_size}) under the profiler:")
    device_profile(torch, lambda: [step() for _ in range(10)])
    return out


def _served_inputs(torch, fm, mlp_sets, datasets, device) -> list:
    """(label, MLP, raw test rows, packed weights, biases) for each trained
    MLP: its kind's 20% test split at the MLP's seed."""
    inputs = []
    for set_name, mlps in mlp_sets:
        for kind in KINDS:
            m = mlps[kind]
            _, test = datasets[kind].split(0.8, seed=m.cfg.seed)
            w, b = fm.pack_trained(m, device)
            inputs.append((f"{set_name} {kind}", m,
                           torch.as_tensor(test.x).to(device), w, b))
    return inputs


def fused_mlp_checks(torch, fm, device, inputs, kernel_mods) -> tuple:
    """Phase 12: the trained MLPs served through ``fused_mlp``, the end of
    the path whose kernel counts were set to 0 before phase 10 and are read
    here: exactly one ``fused_mlp`` launch a served MLP, the block scorer
    behind ``to_device`` and ``rank_devices``, no LM kernel.  The served
    answers are held against the plain chain and ``TrainedMLP.predict_ms``;
    then the kernel against its plain version on constructed cases.
    Returns (the path's ``fused_mlp`` launches, the worst |kernel - plain|
    on log-ms)."""
    served = [fm.serve_trained(m, feats, w, b)
              for _, m, feats, w, b in inputs]
    torch.cuda.synchronize()
    launches = {k: v for mod in kernel_mods for k, v in mod.LAUNCHES.items()}
    log(f"  served {len(inputs)} trained MLPs through fused_mlp; launches "
        f"on the path of phases 10-12: {launches}")
    if launches["fused_mlp"] != len(inputs):
        fail(f"fused_mlp launched {launches['fused_mlp']} times for "
             f"{len(inputs)} calls")
    if launches["fused_mlp_score"] < 1:
        fail("the trained predictor on the card never launched the scorer")
    if launches["flash_attention"] or launches["ssd"]:
        fail(f"an LM kernel launched on the MLP path: {launches}")

    worst = 0.0
    for (label, m, feats, w, b), ms in zip(inputs, served):
        xp = fm.padded_rows(m, feats, w.shape[-1])
        err, tol = _max_err(torch, fm.fused_mlp(xp, w, b,
                                                in_features=feats.shape[1]),
                            fm.fused_mlp_plain(xp, w, b), 1e-4)
        rel = float(((ms / m.predict_ms(feats)) - 1.0).abs().max().item())
        worst = max(worst, err)
        log(f"  {label}: {feats.shape[0]} test rows, L {w.shape[0]}, H "
            f"{w.shape[-1]}: log-ms max |kernel - plain| {err:.3e} (tol "
            f"{tol:.3e}); ms vs predict_ms max rel {rel:.3e} (tol 1e-4)")
        if not err <= tol or not rel <= 1e-4 or \
                not torch.isfinite(ms).all():
            fail(f"fused_mlp disagrees on the trained {label} MLP")

    rng = np.random.default_rng(SEED + 13)
    before, calls = fm.LAUNCHES["fused_mlp"], 0
    for nl, hdim in FUSED_MLP_SHAPES:
        w = torch.from_numpy((rng.standard_normal((nl, hdim, hdim))
                              * np.sqrt(2.0 / hdim)).astype(np.float32))
        b = torch.from_numpy((rng.standard_normal((nl, hdim)) * 0.1)
                             .astype(np.float32))
        w, b = w.to(device), b.to(device)
        for rows in FUSED_MLP_ROWS:
            x = torch.from_numpy(rng.standard_normal((rows, hdim))
                                 .astype(np.float32)).to(device)
            err, tol = _max_err(torch, fm.fused_mlp(x, w, b),
                                fm.fused_mlp_plain(x, w, b), 1e-4)
            calls += 1
            worst = max(worst, err)
            if not err <= tol:
                fail(f"fused_mlp B{rows} L{nl} H{hdim}: |err| {err:.3e} > "
                     f"{tol:.3e}")
    counted = fm.LAUNCHES["fused_mlp"] - before
    log(f"  constructed cases: B {FUSED_MLP_ROWS} x (L, H) "
        f"{FUSED_MLP_SHAPES}: {calls} calls, {counted} launches counted; "
        f"max |kernel - plain| over everything {worst:.3e}")
    if counted != calls:
        fail(f"fused_mlp counted {counted} launches for {calls} calls")
    return launches["fused_mlp"], worst


def fused_mlp_bound(x, w) -> tuple:
    """``chain_bounds`` of one ``fused_mlp`` call: what the chain needs
    for x's rows (``chain_work``), the output written once."""
    flops, nbytes = chain_work(x, w)
    return chain_bounds("fused_mlp", flops, nbytes + x.shape[0] * 4)


#: the FFMA kernels' device times before the tensor-core redesign
#: (PERF.md's kernel table: H100 80GB HBM3 at 700 W; the row scorer's on
#: sweep (c)'s rows padded to a ``bucket_blocks`` bucket, 36,864 rows);
#: log text only, the kernels line holds what this run measured
FFMA_KERNEL_MS = {"fused_mlp_score": 23.586, "fused_mlp_score_rows": 26.743,
                  "fused_mlp L 9": 3.973, "fused_mlp L 4": 0.258}


def time_fused_mlp(torch, fm, inputs) -> dict:
    """Phase 13: ``fused_mlp`` on the path's largest inputs (a trained
    8 x 1024 MLP over its 6,000 test rows) and on the default predictor's
    (L 4, H 256), called as the path calls it (first layer over the
    features), beside its plain version and its bounds."""
    timed = []
    for label, m, feats, w, b in (inputs[-1], inputs[len(inputs) // 2 - 1]):
        xp = fm.padded_rows(m, feats, w.shape[-1])
        n_in = feats.shape[1]
        ms = time_both(torch, lambda: fm.fused_mlp(xp, w, b,
                                                   in_features=n_in))
        plain_ms = time_both(torch, lambda: fm.fused_mlp_plain(xp, w, b))
        bounds = fused_mlp_bound(xp, w)
        earlier = FFMA_KERNEL_MS.get(f"fused_mlp L {w.shape[0]}")
        log(f"  fused_mlp ({label}): rows {xp.shape[0]}, L {w.shape[0]}, H "
            f"{w.shape[-1]}: {ms_text(ms)} (plain {ms_text(plain_ms)}, "
            f"library none, {bound_text(bounds, ms[0])}"
            + ("" if earlier is None else
               f"; the FFMA kernel {earlier:.3f} ms") + ")")
        timed.append((ms[0], plain_ms[0], *bounds[0]))
    return timed[0]


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
        for entry, regs, spill in ptxas_lines(text):
            log(f"  {kname}: {entry}: {regs} registers; {spill}")
    for kname in sorted(build.KERNELS):
        ops = sass_ops(build.sass(kname))
        log(f"  {kname} SASS: {ops}")
        operand = TENSOR_CORE_KERNELS.get(kname)
        if operand and not has_mma(ops, operand):
            fail(f"{kname}: no {operand} tensor-core MMA in its SASS")

    # -- 3. kernels against their plain versions ----------------------------
    log("[3 kernels vs plain] K=4, L=9, H=1024, block_m=128")
    worst = {"fused_mlp_score": 0.0, "fused_mlp_score_rows": 0.0}
    for kname, case, args, kwargs in kernel_cases(torch, fms, device):
        err, tol = compare(torch, fms, kname, args,
                           {"block_m": 128, **kwargs})
        worst[kname] = max(worst[kname], err)
        log(f"  {kname} {case}: rows {args[0].shape[0]}, max |err| "
            f"{err:.3e} (tol {tol:.3e})")
        if not err <= tol:
            fail(f"{kname} {case} disagrees with its plain version")
    err, tol = out_of_range_kind_case(torch, fms, device)
    worst["fused_mlp_score_rows"] = max(worst["fused_mlp_score_rows"], err)
    log(f"  fused_mlp_score_rows out-of-range-kind: rows 256, NaN on "
        f"that row only, the others max |err| {err:.3e} (tol {tol:.3e})")
    if not err <= tol:
        fail("fused_mlp_score_rows out-of-range-kind: the other rows "
             "disagree with the plain version")

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
        ms = time_both(torch, lambda: kernel(*args, **kwargs))
        plain_ms = time_both(torch, lambda: plain(*args), iters=5)
        bounds = bound(kname, args)
        bound_ms, bound_by = bounds[0]
        src, line = sources[kname]
        earlier = (f"; the FFMA kernel {FFMA_KERNEL_MS[kname]:.3f} ms"
                   if kname == "fused_mlp_score" else "")
        log(f"  {kname}: rows {args[0].shape[0]}, {kwargs}, {ms_text(ms)} "
            f"(plain {ms_text(plain_ms)}, {bound_text(bounds, ms[0])}, at "
            f"tf32 {TF32_PEAK_FLOPS / 1e12:g} / fp32 "
            f"{FP32_PEAK_FLOPS / 1e12:g} TFLOP/s and HBM "
            f"{HBM_BYTES_PER_S / 1e12:g} TB/s{earlier})")
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/fused_mlp_score.py:{line}",
            "launches": launches[kname], "max_abs_err": worst[kname],
            "ms": ms[0], "plain_ms": plain_ms[0], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None})

    rows_on_the_old_bucket(torch, fms, recorder)
    breakdown(torch, batched, planner, traces, new_traces, fleet_minus)

    # -- 6. the LM path's kernels against their plain versions --------------
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd as sk
    log("[6 LM kernels vs plain] flash attention and the SSD scan")
    lm_worst = lm_kernel_checks(torch, fa, sk, device)
    from repro_torch.kernels import fused_mlp as fm
    kernel_mods = (fms, fa, sk, fm)

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
    #: the first kernels' times on the same inputs, before the tensor-core
    #: redesign (PERF.md's kernel table: H100 80GB HBM3 at 700 W, events
    #: without the spin); log text only, the kernels line holds what this
    #: run measured
    earlier_ms = {"flash_attention": 3.506, "ssd": 5.662}
    for kmod, kname in ((fa, "flash_attention"), (sk, "ssd")):
        args, kwargs = lm_runs[kname]["args"]
        kernel = getattr(kmod, kname)
        plain = getattr(kmod, f"{kname}_plain")
        plain_kwargs = {k: v for k, v in kwargs.items() if k != "chunk"}
        lm_worst[kname] = max(lm_worst[kname], lm_runs[kname]["max_abs_err"])
        ms = time_both(torch, lambda: kernel(*args, **kwargs))
        plain_ms = time_both(torch, lambda: plain(*args, **plain_kwargs),
                             iters=10 if kname == "flash_attention" else 3,
                             warmup=1)
        library_ms = None
        if kname == "flash_attention":
            library_ms, lib_out = sdpa_ms(torch, (args, kwargs))
            if lib_out is not None:
                diff, tol, _ = _flash_err(torch, lib_out,
                                          plain(*args, **plain_kwargs),
                                          FLASH_BF16_REL)
                log(f"  SDPA vs plain on these inputs: worst row max "
                    f"|diff| {diff:.3e} (that row's flash tolerance "
                    f"{tol:.3e})")
        src, line, bound_fn = lm_sources[kname]
        bound_ms, bound_by = bound_fn((args, kwargs))
        shape = "x".join(str(n) for n in args[0].shape)
        log(f"  {kname}: {args[0].dtype} {shape}, {ms_text(ms)} (plain "
            f"{ms_text(plain_ms)}, library "
            f"{'none' if library_ms is None else ms_text(library_ms)}, "
            f"bound {bound_ms:.4f} ms by {bound_by}: {bound_ms / ms[0]:.1%} "
            f"of peak; the first kernel {earlier_ms[kname]:.3f} ms without "
            f"the spin)")
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}.cu",
            "replaces": f"src/repro/kernels/{src}.py:{line}",
            "launches": lm_runs[kname]["launches"],
            "max_abs_err": lm_worst[kname], "ms": ms[0],
            "plain_ms": plain_ms[0], "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None if library_ms is None else library_ms[0]})

    # -- 10-12. the MLP training path and the fused_mlp kernel -------------
    for mod in kernel_mods:
        mod.reset_launches()
    log(f"[10 train, default predictor] default_predictor(force_retrain="
        f"True) on {device}: 4 kinds, 3 x 256, 30 epochs, 2000 "
        f"configurations x 15 devices")
    t0 = time.perf_counter()
    datasets, default_mlps = train_default(torch, device)
    log(f"  phase 10: {time.perf_counter() - t0:.1f} s")
    log(f"[11 train, full width] MLPConfig(): 8 x 1024, batch 512, "
        f"{FULL_WIDTH_EPOCHS} epochs, 4 kinds on {device}")
    t0 = time.perf_counter()
    full_mlps = train_full_width(torch, device, datasets)
    log(f"  phase 11: {time.perf_counter() - t0:.1f} s")
    log("[12 fused_mlp] the trained MLPs served through the kernel, then "
        "constructed cases against the plain chain")
    inputs = _served_inputs(torch, fm, (("default", default_mlps),
                                        ("full-width", full_mlps)),
                            datasets, device)
    fm_launches, fm_worst = fused_mlp_checks(torch, fm, device, inputs,
                                             kernel_mods)

    # -- 13. fused_mlp timed ------------------------------------------------
    log("[13 timing] fused_mlp on the path's largest inputs and at the "
        "default predictor's width")
    ms, plain_ms, bound_ms, bound_by = time_fused_mlp(torch, fm, inputs)
    kernels.append({
        "name": "fused_mlp", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_mlp.cu",
        "replaces": "src/repro/kernels/fused_mlp.py:51",
        "launches": fm_launches, "max_abs_err": fm_worst, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None})

    # -- 14. result lines ---------------------------------------------------
    print(smi_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
