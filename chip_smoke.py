#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100: python3 chip_smoke.py

Drives the port's eight paths on the card and checks every phase; any
failure exits non-zero.  The prediction path runs at the full width of
the paper's MLP predictor (``MLPConfig()``: 8 hidden layers of 1024, four
op kinds); the LM serving path runs Qwen3-0.6B and Mamba2-130M at their
published configs (every layer, every width, bf16); the training path
trains the default predictor and the paper's full-width MLPs on the card
and serves them through the ``fused_mlp`` kernel; the tracking path
records a training iteration of each of the paper's five Table-4 nets on
the card, times every op there, and predicts the iterations on the
registry through both scorer kernels (the paper's Listing 1); the
serving path answers rank, sweep and what-if requests through the
coalescing prediction service, its HTTP front ends, the router and the
network cache, on the scorer kernels; the zoo path serves the seven
other archs that fit one card, every family among them, at their
published configs; the LM training path trains Qwen3-0.6B and
Mamba2-130M at their published configs through flash attention and the
SSD scan, which are dispatcher ops with a gradient, resumes a crashed
run, and predicts the tracked training step on other devices; the
sharded LM training path trains the same two with their state as
DTensors on a one-card mesh, through the ops' DTensor sharding rules,
restores its checkpoint onto a fresh mesh and serves on the mesh.

1. Device: a CUDA GPU of capability (9, 0); its name and power limit;
   ``calibrate_spec("cuda")``'s achieved fp32 GEMM rate and copy
   bandwidth beside the ``H100-SXM`` spec's datasheet values.
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
   or not, window 0, 100, 256 or 1024, GQA rep 1, 2, 4, 8 and 16, D 16,
   32, 64, 80, 128 and 256 (phase 17's shapes among them), lengths off
   the 16-row fragments and 64-key tiles, query chunks at a ``q_offset``
   (both chunks of a zig-zag rank, D 256 with its window's keys, D 64,
   offsets off the tiles) (each output row
   within FLASH_BF16_REL = 8e-3 * max(max |plain row|, FLASH_ROW_FLOOR)
   in bf16, one to two bf16 ulps of the row; fp32 within 1e-4 * that);
   SSD in bf16 (tensor cores, fp32 operands split in two bf16 terms) and
   fp32 at N 64 and 128, P 64, L from 1 to the path's 4096 at H 24 and
   zamba2's 2048 at H 80, off the chunk and on it, chunk 16 and 64, b and
   c shared by the heads or
   not, y and final state within 1e-4 * max(1, max |plain|) (fp32 sums
   in another order).
7. Serving Qwen3-0.6B (28 layers, d_model 1024, 16 / 8 heads of 128,
   vocab 151936): ``ServingEngine(batch=4, max_seq=4112)`` answers 8
   requests of 384-4096 prompt tokens and 16 new tokens each; flash
   launches = prefills x 28.  The same model with plain attention,
   teacher-forced on the engine's own events (each admitted prompt's
   prefill, then every decode tick with the tokens the engine fed it,
   the batch's slots as served), must agree.  In fp32, kernel path
   against plain path at every position:
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
   constant from PERF.md); flash also on the last half of its queries at
   ``q_offset`` S / 2 against all the keys (``offset_*`` keys of the
   kernels line).  Phases 5, 9 and 13 time every call twice:
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
14. Tracking: ``make_train_iteration`` of ResNet-50 (batch 32 at 224),
    the Inception-style net (32 at 224), DCGAN (128), GNMT (64 x 50,
    hidden 512, vocab 32000, 4 layers) and the Transformer (32 x 128,
    d_model 512, 6 layers, vocab 32000), each tracked once with
    ``OperationTracker("H100-SXM", measure="wallclock")``: every op timed
    on the card by CUDA events (3 warm-ups, the mean of 3).  Gates: more
    than 20 ops and at least one kernel-varying op a net, every
    ``measured_ms`` finite and > 0, and the card's op list equal to the
    CPU's for the same net at the CPU tests' small widths (names, kinds,
    params, FLOPs and shapes, exactly: the backward ops, which autograd
    runs on its device thread on the card, included).  Logged: ops per
    kind, the covered fraction, the sum of op ms x multiplicity beside the
    iteration's own time on the card (CUDA events, median of 5 after 2
    warm-ups), tracking seconds and peak memory.
15. The five tracked traces through ``FleetPlanner(HabitatPredictor(
    mlps, device="cuda"))`` with phase 4's full-width MLPs: (a) each
    ranked by throughput and by cost on the registry, (b) a cold sweep of
    the five over the fleet minus 5 devices, (c) a sweep of the five plus
    DCGAN tracked at batch 64 over the whole fleet (cell-masked).  Gates:
    each scorer kernel launched at least once (counts set to 0 before (a)
    and read after (c)), every answer within rtol 1e-4 of the same
    predictor on the CPU with the plain scorer, and a ``SqliteCache``
    planner in a temporary directory answering the sweep twice, the
    second time all hits with equal answers.  Then the CLI,
    ``repro_torch.launch.serve.main(["--arch", "qwen3-0.6b", "--fleet",
    "--sweep", ...])`` on the card at the published config with four
    short requests.
16. The prediction service: ``PredictionService(predictor=
    HabitatPredictor(phase 4's mlps, device="cuda"))`` behind the threaded
    ``PredictionServer`` and the ``AsyncPredictionServer``, both in
    process on port 0.  Each takes a cold burst and then the same burst
    warm: 64 concurrent ``/rank`` clients over the 37 traces (phase 4's 32
    and phase 14's 5) with the fleet minus five or the registry's six
    GPUs, then 8 ``/sweep``s of 4-6 traces (the 37 and phase 4's 4 new
    ones), 16 ``/rank``s and 2 ``/optimize``s over the whole registry,
    and on the asyncio server one ``/sweep/stream``; a shed request is
    sent again after its ``Retry-After``.  Gates: every answer 200 and
    within rtol 1e-4 of the CPU plain path, engine passes fewer than
    requests, each scorer kernel launched by the served union passes
    (counts set to 0 before the first burst, read after the cold ones),
    the warm burst all result-cache hits with 0 launches and equal
    answers, the SSE rows equal to ``/sweep``'s, a burst over an
    admission limit shed with 429/503 and ``Retry-After`` (never 500),
    ``deadline_ms`` 1 answered 504, a ``SnapshotManager`` snapshot
    restored into a fresh service answering the first round again with
    0 engine passes and equal bytes, and a drain quiescing.  Logged:
    requests/s and p50/p99 latency per route, engine passes per request,
    union and split counts, the fitted pass model, one cold and one
    cell-masked coalesced union pass under ``torch.profiler`` (the
    scorer's launches, its layer GEMMs' device ms, the device busy
    share), snapshot bytes and restore seconds.  Then as processes:
    ``launch.serve --cache-server`` and ``launch.serve --serve --router
    --workers 2 --fleet-mlps --cache tcp://...`` (phase 10's trained
    MLPs): 16 ``/rank`` through the router, each trace on one worker,
    each worker's ``scorer_dispatches.fused`` at least 1, a SIGKILLed
    worker failed over and restarted by the supervisor (meanwhile
    ``launch.serve --optimize`` prints a frontier), and exit 0 on
    SIGTERM.
17. The rest of the model zoo: glm4-9b, minitron-4b, gemma3-1b,
    granite-moe-3b-a800m, zamba2-2.7b, internvl2-2b and musicgen-medium,
    each at its published config (every layer, every width, bf16, random
    weights from the seed), served one at a time as in phase 7 by
    ``ServingEngine(batch=4, max_seq=2064)``: 4 requests of 384, 1031,
    1500 and 2048 prompt tokens (two past gemma3's 1024-token window, all
    off the 64-key tiles), 8 new tokens each.  Launches counted exactly:
    flash = prefills x attention layers (zamba2: x its 9 groups' shared
    block), SSD = prefills x 54 for zamba2.  The gates of phase 7, and
    for the MoE (a flipped router choice moves a logit by far more than
    any float tolerance, and capacity couples a tick's tokens): the fp32
    kernel replay is routed as the fp32 plain replay routed, so every
    request is held at the fp32 tolerance under one routing, and each
    layer's own top-k sets on the two paths are recorded beside it.
    Since the forced replay's hidden states track the plain path's, a
    token whose own top-k differs is a flip of that layer, never the
    consequence of an earlier one: its router margins p(k-th) -
    p(k+1-th) must lie below ROUTER_TIE = 1e-5 on both paths (a true
    near-tie), and a flip at a wider margin fails.
    The bf16 gates hold every request: their floor, the plain bf16
    path's distance from fp32, already holds the routing flips of bf16
    rounding.  internvl2-2b and musicgen-medium also run one fp32
    prefill after a ``prefix_embeds`` of their published prefix (256 x
    1024, 64 x 768) against the plain path.  Each model is freed before
    the next.  Logged per arch: parameters, prefill ms, decode ms a tick,
    tokens/s, a prefill's device-busy share, peak memory, and each kernel
    timed on the largest inputs of its path (flash at D 80 and 256 among
    them) beside its plain version, bound and SDPA.  dbrx-132b does not
    fit one card and is not run.
18. Training the LMs: Qwen3-0.6B (flash attention) and Mamba2-130M (the
    SSD scan) at their published configs (bf16, remat, AdamW, clip 1.0).
    (a) One ``loss_fn`` gradient on 1 x 2048 tokens of ``SyntheticTokens``
    through the kernel ops against the plain path (dense attention;
    ``ssd_chunked`` at ``cfg.ssm_chunk``): in fp32 the loss within
    GRAD_LOSS_REL and every gradient leaf within max(GRAD_REL, twice the
    floor) of its own largest element from both the plain fp32 path and
    the same plain path in fp64, the floor being the plain fp32 path's
    distance from the fp64 one; in bf16 the
    phase-7 method, the plain bf16 path's largest distance from the fp32
    gradients being the floor, from which the kernel path may lie no
    farther than twice (held where twice the floor lies below 1, so that
    a zero gradient fails: flash; the random Mamba2's floor is above it),
    and the bf16 loss within a limit that a broken kernel (attention
    without its mask, the scan without its carry) must exceed.  At the op,
    each layer's inputs from a bf16 forward at (b)'s batch (flash also
    the first layer's last half of queries at their ``q_offset``): y row
    by row against the plain function, a broken kernel's y outside that
    gate,
    and the op's gradient against autograd through the function its
    backward differentiates.  Every layer's ``wq``, ``wk``, ``wv``,
    ``q_norm``, ``k_norm`` (``in_proj``'s x, B, C and dt columns,
    ``conv_w``, ``a_log``, ``dt_bias``) with a non-zero gradient.  (b)
    ``Trainer(cfg, batch=2, seq=4096)``: 4 steps with an async
    checkpoint every 2, then a run crashed at step 3 by the failure
    injector and a fresh trainer that restores step 2 and runs to 4;
    every loss finite, the resumed losses of steps 3-4 bitwise the
    uninterrupted run's, and each run's launches exactly steps x layers
    x 2 (the forward and remat's recompute).  Logged: ms a step (median
    after 2 warm-ups), tokens/s, peak memory, checkpoint bytes and the
    seconds the loop waited on them, the device-busy share of 3 more
    steps under ``torch.profiler`` with the forward kernels' device ms,
    and one op call's forward kernel and backward VJP device ms.  (c)
    ``python -m repro_torch.launch.train --arch qwen3-0.6b --steps 3
    --batch 2 --seq 4096 --predict-on <the registry's GPUs>`` as a
    process: exit 0, a ranking of every named GPU, the block scorer
    launched, and its tracked step (``--trace-out``) holding 28 x 2
    ``repro_torch::flash_attention`` ops, each with a finite positive
    ``measured_ms``.  (d) ``distributed.predict_step`` on that trace,
    pure data parallelism over 8 cards with the parameters' bytes as
    the all-reduce, on the card against the CPU's plain scorer (rtol
    1e-4).
19. Training the LMs sharded: a 1-rank NCCL group and a (data 1, model
    1) ``DeviceMesh`` of the card (``launch.mesh.make_mesh``).  One card
    cannot show partitioning (every axis has size 1); the phase shows
    that the kernels run through their DTensor sharding rules, and what
    DTensor's dispatch costs.  (a) Qwen3-0.6B and Mamba2-130M as in phase
    18 (bf16, remat, AdamW, clip 1.0): ``SHARDED_STEPS`` steps of
    ``make_train_step`` on 2 x 4096 tokens on plain tensors, then the same
    steps from the same seed with the state distributed by
    ``param_specs`` (``2d``) and the batch by ``batch_specs``: every loss
    and every updated parameter bitwise (where one is not, the first ops
    whose outputs part in a forward on both are named, and the loss gap
    held within phase 18 (a)'s bf16 limit), and the mesh's launches
    exactly steps x layers x 2 by the kernels' own counters (so the CUDA
    kernels ran under DTensor, not the plain versions).  Logged: ms a
    step on the mesh and on plain tensors (median after the warm-up)
    beside phase 18's.  (b) ``checkpoint.save`` of (a)'s sharded Qwen3
    state (gathered, written by rank 0), then ``restore(...,
    shardings=...)`` onto a freshly built mesh: every leaf bitwise.  (c)
    One Qwen3-0.6B prefill of ``SHARDED_PREFILL`` tokens and
    ``SHARDED_TICKS`` decode ticks with the parameters on the mesh and
    the cache placed by ``cache_specs``: every logit bitwise the plain
    path's, flash launched once a layer.  (d) The sharded programs that
    differ by torch release, on this machine's: the ``guard`` cases of
    ``tests/sharding_ranks.py`` (the data- and sequence-parallel steps,
    the head-split and zig-zag gradients, the dp and sp lookups, the
    MoE router's gradient under ``2d`` and ``dp``, the tied head and
    zamba2's Mamba2 layers under ``dp``, decode with its products
    per shard, Mamba2's and internvl2's at widths that do not divide
    ``model``, the Mamba2 block on each ``model`` rank's heads under
    ``2d`` in prefill, decode and training, the ``dp`` step's
    attention gradients with KV heads that do not divide ``model``,
    one slot's products fed the rank's range of x, moved from the
    ``model`` rank that holds it, and the ``2d`` step, whose loss
    normalizes the vocab-split logits per shard) on
    ``GUARD_RANKS`` gloo CPU ranks within
    ``GUARD_TIMEOUT_S``, held to the test file's tolerances
    (``sharding_ranks.failures``).
20. The dry run (``repro_torch.launch.dryrun``) on the production
    meshes, read from the traced per-rank graph: ``DRYRUN_CELLS``, each
    ``python -m repro_torch.launch.dryrun --device cuda`` as a process
    of its own on a fake process group of 256 or 512 ranks (Qwen3-0.6B
    and Mamba2-130M at ``train_4k``, Qwen3-0.6B at ``prefill_32k``, whose
    16 query heads split one a ``model`` rank beside 8 KV heads that
    cannot, and at ``decode_32k``, whose KV cache splits its sequence
    over ``model``, Mamba2-130M at ``long_500k``, and a ``--multi-pod``
    decode cell, and gemma3-1b at ``train_4k`` and at ``prefill_32k``,
    whose 4 heads do not divide ``model=16``, so its query sequence
    splits over ``model``), and phase 18 (c)'s step (Qwen3-0.6B, 2 x
    4096) on a 1-rank fake mesh, and zamba2-2.7b at ``train_4k``
    (its Mamba2 layers per shard), and Mamba2-130M and internvl2-2b at
    ``decode_32k`` (their products planned per shard by
    ``parallel.ctx.product``: heads of 50280 and 92553 rows and
    Mamba2's 3352-wide ``in_proj`` split unevenly over ``model=16``),
    and Mamba2-130M and zamba2-2.7b at ``prefill_32k`` (their Mamba2
    blocks on each ``model`` rank's range of the heads,
    ``ssm._mamba_heads``), and internvl2-2b at ``prefill_32k`` (its
    lookup's rows returned by DTensor's all-to-all) and zamba2-2.7b at
    ``long_500k`` (one slot, x's slices moved to ``in_proj``'s K split),
    all at once within ``DRYRUN_TIMEOUT_S``.  Every
    cell ``ok``; each cell's compute, memory and collective terms,
    bound, useful-FLOPs ratio and peak GiB a device logged, and its peak
    over the reference's (``DRYRUN_REFERENCE_PEAK_BYTES``).  Gates: the
    prefill cell's useful-FLOPs ratio at least ``DRYRUN_PREFILL_USEFUL``
    (each head run once); both decode cells' collective bytes a device
    below ``DRYRUN_DECODE_COLLECTIVE_BYTES`` (the cache read from
    per-shard softmax partials and the embedding looked up in each
    rank's shard, neither gathered); the gemma3 cells' FLOPs a device at
    most ``DRYRUN_FLOPS_OVER_REFERENCE`` times the reference's count
    (``DRYRUN_REFERENCE_FLOPS``), and so the Mamba2 and internvl2
    decode cells' and the Mamba2 prefill cell's; those two decode
    cells', the gemma3 and zamba2 ``train_4k`` cells', the zamba2
    prefill cell's and its ``long_500k`` cell's collective bytes a
    device at most ``DRYRUN_COLLECTIVES_OVER_REFERENCE`` times the
    reference's (``DRYRUN_REFERENCE_COLLECTIVE_BYTES``; both the dry
    run's count, each collective's output bytes); the Qwen3, gemma3 and
    internvl2 prefill cells' peaks at most
    ``DRYRUN_PEAK_OVER_REFERENCE`` times the reference's; and on the
    1-rank cell,
    its roofline step below phase 18's measured ms a step, and its
    FLOPs within ``DRYRUN_TRACKER_REL`` of the FLOPs phase 18 (c)'s
    tracker summed over that step.
21. A line with the card's name and power limit, a ``{"kernels": [...]}``
    line with all five kernels (flash attention and the SSD scan also
    with their training launches and their launches on the mesh), and
    last {"ok": true, "device": {...}}.

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
#: the five Table-4 nets at the widths of the CPU parity tests (which
#: read them here: tests/test_torch_evalzoo.py), where the card's op list
#: must equal the CPU's; phase 14 tracks them at the reference's sizes
TRACK_SMALL = {
    "resnet50": dict(batch=2, image=32, width=8, blocks=(1, 1, 1, 1),
                     classes=10),
    "inception_v3": dict(batch=2, image=32, width=8, n_blocks=2,
                         classes=10),
    "dcgan": dict(batch=2, width=8, z_dim=16),
    "gnmt": dict(batch=2, seq=5, hidden=16, vocab=64, layers=2),
    "transformer": dict(batch=2, seq=8, d_model=32, n_layers=2, vocab=64),
}
#: phase 15's extra tracked batch size, which makes sweep (c) cell-masked
TRACK_EXTRA = ("dcgan", dict(batch=64))


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
    the plain scorer: every cell at rtol 1e-4.  Returns that CPU grid of
    ``traces + new_traces`` over ``devs`` (phase 16 holds its answers to
    it too)."""
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
    return want


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
    # phase 17's shapes: zamba2's D 80 (H 32 over KV 32), gemma3's D 256
    # (H 4 over KV 1, window 1024, prompts past it), glm4's GQA rep 16
    (1, 32, 32, 1000, 1000, 80, True, 0),
    (1, 4, 1, 1100, 1100, 256, True, 1024),
    (1, 4, 1, 2048, 2048, 256, True, 1024),
    (1, 32, 2, 1031, 1031, 128, True, 0),
    # a query offset (the 9th entry; 0 where absent): the two chunks of
    # zig-zag rank 0 in a prefill of 8192 over 16 ranks (the first and
    # the last 256 rows), a bf16 D 128 GQA chunk off the tiles, a D 256
    # chunk whose keys start where its window of 1024 does, D 64
    (1, 16, 8, 256, 256, 128, True, 0, 0),
    (1, 16, 8, 256, 8192, 128, True, 0, 7936),
    (1, 16, 8, 300, 1337, 128, True, 0, 1037),
    (1, 4, 1, 512, 1535, 256, True, 1024, 1023),
    (1, 24, 8, 333, 1000, 64, True, 0, 667),
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
    (1, 80, 2048, 64, 64, 64, True),     # zamba2-2.7b's prefill
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


def _row_err(torch, got, want, rel, floor):
    """Row by row (the last axis a row): every row within rel * max(max
    |want row|, floor).  Returns the (err, tol) of the row with the
    largest err / tol, and the max |err| over all rows."""
    torch.cuda.synchronize()
    want = want.float()
    err = (got.float() - want).abs().amax(-1).flatten()
    tol = (rel * want.abs().amax(-1).clamp_min(floor)).flatten()
    i = int((err / tol).argmax())
    return float(err[i]), float(tol[i]), float(err.max())


def _flash_err(torch, got, want, rel):
    """Flash attention's gate, row by row: every output row (b, h, s)
    within rel * max(max |plain row|, FLASH_ROW_FLOOR).  Per row because a
    causal row's scale falls with its length: row 0 is v_0, of order 1,
    while a row over 4096 keys averages to a few hundredths, so a tile
    dropped or mis-masked late in a long row moves it far less than a
    tolerance taken from the whole tensor's max."""
    return _row_err(torch, got, want, rel, FLASH_ROW_FLOOR)


def lm_kernel_checks(torch, fa, sk, device) -> dict:
    """Phase 6: both kernels against their plain versions; the worst
    |err| of each."""
    worst = {"flash_attention": 0.0, "ssd": 0.0}
    gen = torch.Generator(device=device).manual_seed(SEED + 11)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    for b, h, kv, sq, skv, d, causal, window, *off in FLASH_CASES:
        q_offset = off[0] if off else 0
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (randn(b, n, s_, d).to(dtype)
                       for n, s_ in ((h, sq), (kv, skv), (kv, skv)))
            got = fa.flash_attention(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
            want = fa.flash_attention_plain(q, k, v, causal, window,
                                            q_offset)
            err, tol, top = _flash_err(torch, got, want, FLASH_BF16_REL
                                       if dtype == torch.bfloat16 else 1e-4)
            worst["flash_attention"] = max(worst["flash_attention"], top)
            log(f"  flash {str(dtype)[6:]} B{b} H{h}/KV{kv} Sq{sq} Skv{skv} "
                f"D{d} causal={causal} window={window} q_offset={q_offset}: "
                f"worst row max "
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


def device_profile(torch, fn, top: int = 6) -> tuple:
    """Run ``fn`` once under ``torch.profiler``; print wall, device-busy
    time and the device ops that take it.  Returns (wall ms, busy ms),
    busy None where the profiler recorded no device time."""
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
        return wall_ms, None
    busy_ms = sum(r[0] for r in rows)
    log(f"    wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({busy_ms / wall_ms:.1%}), idle {1 - busy_ms / wall_ms:.1%}")
    for ms, key, count in sorted(rows, reverse=True)[:top]:
        log(f"    {ms:9.3f} ms  x{count:<5d} {key[:90]}")
    return wall_ms, busy_ms


def _widened(tfm, params, dtype, only=None):
    """The same model with its float tensors (those of dtype ``only``,
    where given) cast to ``dtype``."""
    up = lambda t: (t.to(dtype) if t.is_floating_point()
                    and (only is None or t.dtype == only) else t)
    top = {k: up(t) for k, t in params.named_parameters(recurse=False)}
    shared = (None if params.shared is None
              else {k: up(t) for k, t in params.shared.items()})
    return tfm.LMParams(top, [{k: up(t) for k, t in layer.items()}
                              for layer in params.layers], shared)


def _fp32_copy(tfm, params):
    """The same model with every bf16 tensor widened to fp32."""
    import torch
    return _widened(tfm, params, torch.float32, only=params["embed"].dtype)


def lm_kernels(cfg) -> dict:
    """The LM kernels a prefill of ``cfg`` launches, and how many times:
    flash attention once an attention layer (hybrid: once a group, the
    shared block), the SSD scan once a Mamba2 layer."""
    if cfg.family == "ssm":
        return {"ssd": cfg.n_layers}
    if cfg.family == "hybrid":
        return {"flash_attention": cfg.n_layers // cfg.attn_every,
                "ssd": cfg.n_layers}
    return {"flash_attention": cfg.n_layers}


#: a router flip between the fp32 kernel path and the fp32 plain path is
#: a true near-tie only where the flipped token's top-k margins lie below
#: this on both paths
ROUTER_TIE = 1e-5


class RouteLog:
    """Records each MoE layer's routing while active, as ``moe_layer``
    takes it from ``route``: per call, each token's own top-k expert set
    (sorted), its margin p(k-th) - p(k+1-th), and the experts the call
    routed to, in the router's order.  Given ``forced``, another replay's
    calls, each call routes to that call's experts instead of its own
    router's choice, weighted by its own router's probabilities of them,
    renormalised; what it records as its own choice is still its
    router's."""

    def __init__(self, moe_mod, forced=None):
        self.moe, self.forced, self.calls = moe_mod, forced, []

    def __enter__(self):
        self.orig = self.moe.route

        def recorded(params, x, top_k):
            probs, top_p, top_e = self.orig(params, x, top_k)
            top = probs.reshape(-1, probs.shape[-1]).topk(top_k + 1, -1)
            own = top_e.reshape(-1, top_k).sort(-1).values
            if self.forced is not None:
                top_e = self.forced[len(self.calls)][2].reshape(top_e.shape)
                top_p = _renormalised(probs, top_e)
            self.calls.append((own, top.values[:, top_k - 1]
                               - top.values[:, top_k],
                               top_e.reshape(-1, top_k)))
            return probs, top_p, top_e

        self.moe.route = recorded
        return self

    def __exit__(self, *exc):
        self.moe.route = self.orig


def _renormalised(probs, experts):
    """The router probabilities of ``experts``, renormalised over them."""
    p = probs.gather(-1, experts)
    return p / p.sum(-1, keepdim=True).clamp_min(1e-9)


def router_flips(plain: list, kernel: list) -> list:
    """Compare the plain replay's ``RouteLog.calls`` with those of the
    kernel replay forced to the plain routing, call by call.  Every layer
    of the forced replay reads hidden states that track the plain path's,
    so a token whose own top-k set differs there is a flip of that layer
    and never the consequence of an earlier one: it must be a near-tie on
    both paths (margin below ROUTER_TIE).  Returns each flipped token's
    margin, the wider of its two paths'; fails on one that is no
    near-tie."""
    if len(plain) != len(kernel):
        fail(f"the fp32 replays made {len(plain)} and {len(kernel)} MoE "
             f"calls")
    margins = []
    for (s1, m1, _), (s2, m2, _) in zip(plain, kernel):
        flipped = (s1 != s2).any(-1)
        margins += m1[flipped].maximum(m2[flipped]).tolist()
    if margins and not max(margins) < ROUTER_TIE:
        fail(f"router flip between the fp32 kernel and plain paths at "
             f"margin {max(margins):.3e} (>= {ROUTER_TIE:g}): not a "
             f"near-tie")
    return margins


def plain_kwargs(kwargs: dict) -> dict:
    """A kernel call's keywords without those only the kernel takes: the
    SSD scan's ``chunk`` and ``vjp_chunk`` (the plain scan has no
    chunk)."""
    return {k: v for k, v in kwargs.items() if k not in ("chunk",
                                                         "vjp_chunk")}


def serve_lm(torch, cfg, device, kernel_mods, lens=LM_PROMPT_LENS,
             max_new=LM_MAX_NEW, max_seq=LM_MAX_SEQ) -> dict:
    """Serve prompts of ``lens`` tokens through ``ServingEngine`` with
    ``cfg`` on ``device``, every kernel count set to 0 just before and
    read just after (each of ``lm_kernels(cfg)`` exactly prefills x its
    layers); then hold the answers against the same model on the kernels'
    plain versions.  The engine's admissions and ticks are recorded and
    replayed teacher-forced (each admitted prompt's prefill, then every
    tick with the tokens the engine fed it, the batch's slots as served),
    in bf16 as served and in fp32 through the kernels and through the
    plain versions.  With experts, the fp32 kernel replay is routed as
    the plain replay routed (``RouteLog``), so every request is held at
    the fp32 tolerance under one routing, and ``router_flips`` fails any
    layer whose own routing on the kernel path left the plain path's at
    more than a near-tie.  With a frontend, one
    prefill of the first prompt after a ``prefix_embeds`` of the
    published prefix is held in fp32 against the plain path.  Returns,
    ``{"kernels": {name: {"launches", "args" (the largest inputs),
    "max_abs_err" (on them)}}, "figures": {...}}``, the figures being
    what phase 17 tabulates."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd as sk
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import Request, ServingEngine, splice
    arch = cfg.name
    per_prefill = lm_kernels(cfg)
    kmods = {"flash_attention": fa, "ssd": sk}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tfm.init_params(cfg, seed=SEED, device=device)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params.parameters())
    log(f"  {arch}: {cfg.family}, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, {n_params / 1e6:.1f} M "
        f"parameters in {cfg.param_dtype}, made on {device} in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 21)
    reqs = [Request(uid=i, prompt=rng.integers(2, cfg.vocab_size, n,
                                               dtype=np.int32),
                    max_new_tokens=max_new)
            for i, n in enumerate(lens)]
    engine = ServingEngine(cfg, params, batch=LM_BATCH, max_seq=max_seq,
                           device=device)

    rec = {"prefill": [], "decode_ms": [], "args": {}}
    orig = {"prefill": tfm.prefill, "decode_step": tfm.decode_step,
            **{k: getattr(kmods[k], k) for k in per_prefill}}
    events = []     # ("admit", slot, uid) | ("tick", tokens, {slot: uid})

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

    def keeper(kname):        # keeps the largest inputs (axis 2)
        def kernel(*args, **kwargs):
            held = rec["args"].get(kname)
            if held is None or args[0].shape[2] >= held[0][0].shape[2]:
                rec["args"][kname] = (args, kwargs)
            return orig[kname](*args, **kwargs)
        return kernel

    engine_admit, engine_tick = engine.admit, engine.tick

    def admit(req):
        free = engine._free_slots()
        ok = engine_admit(req)
        if ok:
            events.append(("admit", free[0], req.uid))
        return ok

    def tick():
        live = {s: r.uid for s, r in enumerate(engine.slot_req)
                if r is not None}
        tokens = engine.last_token.copy()
        done_now = engine_tick()
        if live:
            events.append(("tick", tokens, live))
        return done_now

    engine.admit, engine.tick = admit, tick
    tfm.prefill, tfm.decode_step = prefill, decode_step
    for kname in per_prefill:
        setattr(kmods[kname], kname, keeper(kname))
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
        for kname in per_prefill:
            setattr(kmods[kname], kname, orig[kname])
        del engine.admit, engine.tick

    n_pre = len(rec["prefill"])
    toks = sum(len(r.output) for r in done)
    pre_ms = [ms for ms, _ in rec["prefill"]]
    log(f"  served {len(done)}/{len(reqs)} requests, {toks} tokens in "
        f"{wall:.2f} s ({toks / wall:.1f} tok/s); {n_pre} prefills, "
        f"{len(rec['decode_ms'])} decode ticks")
    log("  prefill ms per prompt: " + ", ".join(
        f"{n}: {ms:.1f}" for n, ms in zip(lens, pre_ms)))
    dec = np.asarray(rec["decode_ms"])
    log(f"  decode ms per tick (batch {LM_BATCH}, cache {max_seq}): "
        f"median {np.median(dec):.2f}, min {dec.min():.2f}, "
        f"max {dec.max():.2f}")
    log(f"  launches on the path: {launches}")
    if len(done) != len(reqs) or n_pre != len(reqs):
        fail(f"{arch}: served {len(done)} of {len(reqs)} requests with "
             f"{n_pre} prefills")
    for kname, n in per_prefill.items():
        if launches[kname] != n_pre * n:
            fail(f"{arch}: {kname} launched {launches[kname]} times, want "
                 f"{n_pre} prefills x {n} layers")
    for other, n in launches.items():
        if other not in per_prefill and n:
            fail(f"{arch}: {other} launched {n} times on this path")

    # each kernel against its plain version on the largest inputs the
    # path gave it (these launches are not the path's)
    path_err = {}
    for kname in per_prefill:
        kmod = kmods[kname]
        plain = getattr(kmod, f"{kname}_plain")
        args, kwargs = rec["args"][kname]
        got = orig[kname](*args, **kwargs)
        want = plain(*args, **plain_kwargs(kwargs))
        path_err[kname], checks = 0.0, []
        for g, w in (zip(got, want) if isinstance(got, tuple)
                     else [(got, want)]):
            if kname == "flash_attention":
                err, tol, top = _flash_err(
                    torch, g, w, FLASH_BF16_REL
                    if args[0].dtype == torch.bfloat16 else 1e-4)
            else:
                err, tol = _max_err(torch, g, w, 1e-4)
                top = err
            path_err[kname] = max(path_err[kname], top)
            checks.append(f"{err:.3e} (tol {tol:.3e})")
            if not err <= tol:
                fail(f"{kname} on the path's inputs: |err| {err:.3e} > "
                     f"{tol:.3e}")
        what = ("worst row max |kernel - plain|" if kname == "flash_attention"
                else "max |kernel - plain| of y, state")
        log(f"  {kname} on the path's largest inputs "
            f"({'x'.join(str(n) for n in args[0].shape)}): {what} "
            f"{', '.join(checks)}; max |kernel - plain| "
            f"{path_err[kname]:.3e}")
        del got, want

    # the same model on the plain versions, teacher-forced on the engine's
    # events: in bf16 as served, and in fp32 through the kernels and
    # through the plain versions
    def plain_of(kname):
        plain = getattr(kmods[kname], f"{kname}_plain")

        def call(*args, **kwargs):
            return plain(*args, **plain_kwargs(kwargs))
        return call

    plains = {k: plain_of(k) for k in per_prefill}
    kernels = {k: orig[k] for k in per_prefill}
    by_uid = {r.uid: r for r in done}

    def replay(impls, model, model_cfg):
        """Per uid, the logits (len(output), V) fp32 of the engine's
        events replayed with the kernels set to ``impls``."""
        for kname, impl in impls.items():
            setattr(kmods[kname], kname, impl)
        try:
            state = tfm.init_decode_state(model_cfg, LM_BATCH, max_seq,
                                          device)
            rows = {r.uid: [] for r in done}
            for ev in events:
                if ev[0] == "admit":
                    _, slot, uid = ev
                    prompt = torch.as_tensor(reqs[uid].prompt[None, :],
                                             device=device)
                    logits, one = orig["prefill"](model, model_cfg, prompt,
                                                  max_seq)
                    splice(state, one, slot)
                    rows[uid].append(logits[0, -1].float())
                else:
                    _, tokens, live = ev
                    logits, state = orig["decode_step"](
                        model, model_cfg, torch.as_tensor(
                            tokens, dtype=torch.long, device=device), state)
                    for slot, uid in live.items():
                        rows[uid].append(logits[slot, 0].float())
            return {uid: torch.stack(r) for uid, r in rows.items()}
        finally:
            for kname in per_prefill:
                setattr(kmods[kname], kname, orig[kname])

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
    t0 = time.perf_counter()
    dist = lambda u, v: float((u - v).abs().max().item())
    rows16 = replay(plains, params, cfg)
    with RouteLog(moe_mod) as plain_routes:
        truth = replay(plains, p32, cfg32)
    with RouteLog(moe_mod, forced=plain_routes.calls) as kernel_routes:
        kernel32 = replay(kernels, p32, cfg32)
    if cfg.n_experts:
        margins = router_flips(plain_routes.calls, kernel_routes.calls)
        log(f"  routing (fp32 replays, {len(plain_routes.calls)} MoE calls "
            f"each, the kernel path routed as the plain path): "
            f"{len(margins)} tokens whose own top-k differs between the "
            f"paths" + (f", margins at the flip {min(margins):.3e}-"
                        f"{max(margins):.3e} (near-tie below "
                        f"{ROUTER_TIE:g})" if margins else ""))
    del plain_routes, kernel_routes
    worst32, counts32 = 0.0, [0, 0]
    bf16 = []       # per request: (plain rows, tokens, scale, distances)
    for i, req in enumerate(reqs):
        out = by_uid[i].output
        got = rec["prefill"][i][1]
        if not len(out) == len(rows16[i]) == len(truth[i]):
            fail(f"{arch}: the replay gave request {i} {len(truth[i])} "
                 f"rows for {len(out)} served tokens")
        if not torch.isfinite(got).all():
            fail(f"{arch}: non-finite prefill logits for request {i}")
        scale = max(1.0, float(truth[i].abs().max().item()))
        bf16.append((rows16[i], out, scale, dist(rows16[i][0], truth[i][0]),
                     dist(got, truth[i][0]), dist(got, rows16[i][0])))
        err32 = dist(kernel32[i], truth[i])
        tol32 = FP32_LOGIT_TOL * scale
        worst32 = max(worst32, err32 / scale)
        if not err32 <= tol32:
            fail(f"{arch}: request {i} logits differ from the plain path by "
                 f"{err32:.3e} > {tol32:.3e} (fp32)")
        c = decisions(truth[i], kernel32[i].argmax(-1).cpu().numpy(), tol32)
        counts32 = [counts32[0] + c[0], counts32[1] + c[1]]
    del truth, kernel32, rows16

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
    log(f"  teacher-forced on the engine's {len(events)} events "
        f"({time.perf_counter() - t0:.1f} s).  fp32: logits max "
        f"|kernel - plain| "
        f"{worst32:.2e} of the scale (tol {FP32_LOGIT_TOL:g}), greedy "
        f"choices equal at {counts32[0]} positions ({counts32[1]} within "
        f"the tolerance skipped).  bf16: noise floor {floor:.4f} (largest "
        f"logit {max(r[2] for r in bf16):.3f}), kernel path at most "
        f"{max(r[4] for r in bf16):.4f} from fp32 (limit "
        f"{2 * floor:.4f}), prefill logits max |kernel - plain| "
        f"{max(r[5] for r in bf16):.4f} (tol {min(tols):.4f}-"
        f"{max(tols):.4f} by request), served tokens equal the plain "
        f"greedy choice at {counts16[0]} positions ({counts16[1]} "
        f"skipped)")
    if counts16[0] == 0:
        # a floor this high (the random bf16 Mamba2-130M) lets the bf16
        # comparison fail only a grossly wrong kernel and compare no token
        log("  the bf16 tolerance leaves no greedy decision to compare: in "
            "bf16 only a grossly wrong kernel fails; the fp32 comparison is "
            "this path's gate")
    del bf16

    if cfg.frontend:
        prefix_check(torch, cfg32, p32, reqs[0].prompt, max_seq, device,
                     kmods, plains, kernel_mods)
    del p32

    longest = torch.as_tensor(reqs[int(np.argmax(lens))].prompt[None, :],
                              device=device)
    log(f"  breakdown of one prefill of {longest.shape[1]} tokens under "
        f"the profiler:")
    pre_wall, pre_busy = device_profile(
        torch, lambda: tfm.prefill(params, cfg, longest, max_seq))
    token = torch.as_tensor(engine.last_token, device=device)
    log(f"  breakdown of one decode tick (batch {LM_BATCH}, cache "
        f"{max_seq}):")
    device_profile(torch, lambda: tfm.decode_step(params, cfg, token,
                                                  engine.state))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  peak device memory {peak:.1f} GiB")
    del engine, params
    torch.cuda.empty_cache()
    return {"kernels": {k: {"launches": launches[k], "args": rec["args"][k],
                            "max_abs_err": path_err[k]}
                        for k in per_prefill},
            "figures": {"params_m": n_params / 1e6,
                        "prefill_ms": pre_ms[int(np.argmax(lens))],
                        "tick_ms": float(np.median(dec)),
                        "tok_s": toks / wall,
                        "busy": (None if pre_busy is None
                                 else pre_busy / pre_wall),
                        "peak_gib": peak}}


def prefix_check(torch, cfg32, p32, prompt, max_seq, device, kmods, plains,
                 kernel_mods) -> None:
    """One fp32 prefill of ``prompt`` after a ``prefix_embeds`` of the
    published prefix (frontend_prefix_len x frontend_dim, from the seed),
    through the kernels (each launched once a layer) and through the plain
    versions: last-position logits within FP32_LOGIT_TOL of the scale."""
    from repro_torch.models import transformer as tfm
    gen = torch.Generator(device=device).manual_seed(SEED + 31)
    pre = torch.randn((1, cfg32.frontend_prefix_len, cfg32.frontend_dim),
                      generator=gen, device=device)
    tokens = torch.as_tensor(prompt[None, :], device=device)
    for mod in kernel_mods:
        mod.reset_launches()
    got, state = tfm.prefill(p32, cfg32, tokens, max_seq, pre)
    torch.cuda.synchronize()
    launches = {k: v for mod in kernel_mods for k, v in mod.LAUNCHES.items()}
    saved = {k: getattr(kmods[k], k) for k in plains}
    for kname, impl in plains.items():
        setattr(kmods[kname], kname, impl)
    try:
        want, _ = tfm.prefill(p32, cfg32, tokens, max_seq, pre)
    finally:
        for kname, impl in saved.items():
            setattr(kmods[kname], kname, impl)
    scale = max(1.0, float(want.abs().max().item()))
    err = float((got - want).abs().max().item())
    positions = cfg32.frontend_prefix_len + len(prompt)
    log(f"  prefix: prefill of {len(prompt)} tokens after a "
        f"{cfg32.frontend_prefix_len} x {cfg32.frontend_dim} "
        f"prefix_embeds ({cfg32.frontend}), fp32: index "
        f"{int(state['index'][0])}, launches {launches}, last logits max "
        f"|kernel - plain| {err:.3e} (tol {FP32_LOGIT_TOL * scale:.3e})")
    if int(state["index"][0]) != positions:
        fail(f"{cfg32.name}: prefix prefill index {int(state['index'][0])}, "
             f"want {positions}")
    if launches["flash_attention"] != cfg32.n_layers:
        fail(f"{cfg32.name}: prefix prefill launched flash "
             f"{launches['flash_attention']} times, want {cfg32.n_layers}")
    if not err <= FP32_LOGIT_TOL * scale:
        fail(f"{cfg32.name}: prefix prefill logits differ from the plain "
             f"path by {err:.3e}")


# ---------------------------------------------------------------------------
# phase 17: the rest of the model zoo
# ---------------------------------------------------------------------------
#: the archs that fit one H100 at their published configs, in bf16
ZOO_ARCHS = ("glm4-9b", "minitron-4b", "gemma3-1b", "granite-moe-3b-a800m",
             "zamba2-2.7b", "internvl2-2b", "musicgen-medium")
#: prompts past gemma3's 1024-token window (two of them) and off the
#: 64-key tiles
ZOO_PROMPT_LENS = (384, 1031, 1500, 2048)
ZOO_MAX_NEW = 8
ZOO_MAX_SEQ = 2064


def serve_zoo(torch, device, kernel_mods) -> None:
    """Phase 17: each of ZOO_ARCHS served by ``serve_lm`` at its published
    config (every layer, every width, bf16, random weights from the seed)
    with ZOO_PROMPT_LENS, one model at a time, freed before the next;
    then each kernel timed on the largest inputs each arch's path gave
    it, beside its plain version, its bound and (flash) SDPA, and a table
    of the archs' figures.  dbrx-132b is not run: it fits no single
    card."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd as sk
    kmods = {"flash_attention": fa, "ssd": sk}
    figures = {}
    for arch in ZOO_ARCHS:
        t0 = time.perf_counter()
        log(f"  -- {arch}: {len(ZOO_PROMPT_LENS)} requests of "
            f"{', '.join(map(str, ZOO_PROMPT_LENS))} prompt tokens, "
            f"{ZOO_MAX_NEW} new tokens, batch {LM_BATCH}, max_seq "
            f"{ZOO_MAX_SEQ}")
        run = serve_lm(torch, get_config(arch), device, kernel_mods,
                       lens=ZOO_PROMPT_LENS, max_new=ZOO_MAX_NEW,
                       max_seq=ZOO_MAX_SEQ)
        log(f"  {arch} timed on the largest inputs of its path:")
        for kname, k in run["kernels"].items():
            args, kwargs = k["args"]
            time_lm_kernel(torch, kmods[kname], kname, args, kwargs)
        del run["kernels"]
        torch.cuda.empty_cache()
        figures[arch] = run["figures"] | {
            "seconds": time.perf_counter() - t0}
    log("  dbrx-132b: registered and held against the reference on the "
        "CPU at its smoke config (tests/test_torch_moe.py); not run on "
        "the card: about 132 B parameters, some 264 GB in bf16, fit no "
        "single H100, so its card run waits for the sharding of the "
        "parallelism slice (ROADMAP.md queue 1 item 6)")
    log("  arch | M params | longest prefill ms | decode ms a tick | "
        "tok/s | prefill device busy | peak GiB | s")
    for arch, f in figures.items():
        busy = "n/a" if f["busy"] is None else f"{f['busy']:.1%}"
        log(f"  {arch} | {f['params_m']:.1f} | {f['prefill_ms']:.1f} | "
            f"{f['tick_ms']:.2f} | {f['tok_s']:.1f} | {busy} | "
            f"{f['peak_gib']:.1f} | {f['seconds']:.1f}")


def flash_bound(args) -> tuple:
    """(bound_ms, bound_by) of one flash call: the FLOPs and bytes the
    cost model prices the op at (``costmodel.flash_attention_cost``: 4 D
    FLOPs per allowed (query, key) pair per head, q, k, v read once and o
    written once), the FLOPs over the bf16 tensor-core peak (fp32 inputs:
    the fp32 peak), the bytes over HBM bandwidth."""
    from repro_torch.core.costmodel import flash_attention_cost
    (q, k, v), kw = args[0][:3], args[1]
    cost = flash_attention_cost(q, k, v, kw.get("causal", True),
                                int(kw.get("window", 0)),
                                int(kw.get("q_offset", 0)))
    peak = FP32_PEAK_FLOPS if q.dtype.itemsize == 4 else BF16_PEAK_FLOPS
    return roofline(cost.flops, cost.bytes_accessed, peak)


def ssd_bound(args) -> tuple:
    """(bound_ms, bound_by) of one SSD call: the scan's cheapest exact
    FLOP count, whatever the kernel's own chunk, each FLOP at the rate the
    kernel runs it; against the bytes the cost model prices the op at
    (``costmodel.ssd_cost``: x, dt, a, b, c read once, each stored element
    once, and y and the state written once).  The FLOPs are
    ``costmodel.ssd_flop_terms`` in chunks of Q, and the bound takes the
    least time over Q (Q = 1 is the sequential recurrence).  fp32 inputs:
    every FLOP at the fp32 peak.  bf16 inputs run the products on the
    bf16 tensor cores, the scores once (both operands exact in bf16) and
    the other products as two bf16 products each (the fp32 operand split
    in two terms), so those FLOPs count twice at the bf16 peak and the
    decay at the fp32 peak: the share of the bound is not flattered by
    the split."""
    from repro_torch.core.costmodel import ssd_cost, ssd_flop_terms
    x, dt, a, bm, cm = args[0][:5]
    b, h, l, p = x.shape
    n = bm.shape[-1]
    tc = x.dtype.itemsize == 2
    mma_peak = BF16_PEAK_FLOPS if tc else FP32_PEAK_FLOPS
    split = 2.0 if tc else 1.0

    def per_head_s(q: int) -> float:
        scores, products, decay = ssd_flop_terms(l, n, p, q)
        return (scores + split * products) / mma_peak \
            + decay / FP32_PEAK_FLOPS

    seconds = b * h * min(per_head_s(q) for q in range(1, min(l, 256) + 1))
    # (the bytes do not depend on the chunk)
    nbytes = ssd_cost(x, dt, a, bm, cm, l).bytes_accessed
    t_ops, t_bytes = seconds * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sdpa_ms(torch, args):
    """``time_both`` of PyTorch's fused attention on the same inputs
    (yardstick only: the port never calls it), and its output.  SDPA has
    no sliding window: a windowed call gets the causal band as a boolean
    ``attn_mask`` (so SDPA picks a kernel that reads a mask)."""
    import torch.nn.functional as F
    (q, k, v), kw = args[0][:3], args[1]
    causal = kw.get("causal", True)
    window = int(kw.get("window", 0))
    if window:
        qpos = torch.arange(q.shape[2], device=q.device)[:, None]
        kpos = torch.arange(k.shape[2], device=q.device)[None, :]
        mask = qpos - kpos < window
        if causal:
            mask = mask & (kpos <= qpos)
        call = lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)
    else:
        call = lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)
    return time_both(torch, call), call()


def time_lm_kernel(torch, kmod, kname: str, args, kwargs,
                   earlier: str = "") -> dict:
    """An LM kernel timed on ``args`` beside its plain version, its bound
    and (flash) SDPA, logged as one line (``earlier`` appended): the
    numbers of the kernels line, ``ms`` etc. the first of ``time_both``'s
    pair."""
    kernel = getattr(kmod, kname)
    plain = getattr(kmod, f"{kname}_plain")
    plain_only = plain_kwargs(kwargs)
    ms = time_both(torch, lambda: kernel(*args, **kwargs))
    plain_ms = time_both(torch, lambda: plain(*args, **plain_only),
                         iters=10 if kname == "flash_attention" else 3,
                         warmup=1)
    library_ms = None
    if kname == "flash_attention":
        library_ms, lib_out = sdpa_ms(torch, (args, kwargs))
        diff, tol, _ = _flash_err(torch, lib_out,
                                  plain(*args, **plain_only),
                                  FLASH_BF16_REL)
        log(f"  SDPA vs plain on these inputs: worst row max |diff| "
            f"{diff:.3e} (that row's flash tolerance {tol:.3e})")
        del lib_out
    bound_fn = flash_bound if kname == "flash_attention" else ssd_bound
    bound_ms, bound_by = bound_fn((args, kwargs))
    shape = "x".join(str(n) for n in args[0].shape)
    extra = (f", window {int(kwargs.get('window', 0))}"
             if kname == "flash_attention" else "")
    log(f"  {kname}: {args[0].dtype} {shape}{extra}, {ms_text(ms)} (plain "
        f"{ms_text(plain_ms)}, library "
        f"{'none' if library_ms is None else ms_text(library_ms)}, "
        f"bound {bound_ms:.4f} ms by {bound_by}: {bound_ms / ms[0]:.1%} "
        f"of peak{earlier})")
    return {"ms": ms[0], "plain_ms": plain_ms[0], "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None if library_ms is None else library_ms[0]}


def time_flash_offset(torch, fa, args, kwargs) -> dict:
    """Flash attention timed at a query offset on the path's largest
    inputs: the last half of q's rows at ``q_offset`` S / 2 against all
    S keys (the heavier chunk of a two-way query split), beside its plain
    version and its bound; held against the plain version first, at the
    bf16 gate.  Log text and ``offset_*`` keys of the kernels line."""
    (q, k, v), kw = args[:3], dict(kwargs)
    half = q.shape[2] // 2
    kw["q_offset"] = half
    qh = q[:, :, half:]
    got = fa.flash_attention(qh, k, v, **kw)
    want = fa.flash_attention_plain(qh, k, v, kw.get("causal", True),
                                    int(kw.get("window", 0)), half)
    err, tol, _ = _flash_err(torch, got, want, FLASH_BF16_REL)
    del got, want
    if not err <= tol:
        fail("flash_attention at a query offset disagrees with its plain "
             "version on the path's inputs")
    ms = time_both(torch, lambda: fa.flash_attention(qh, k, v, **kw))
    plain = time_both(torch, lambda: fa.flash_attention_plain(
        qh, k, v, kw.get("causal", True), int(kw.get("window", 0)), half),
        iters=10, warmup=1)
    bound_ms, bound_by = flash_bound(((qh, k, v), kw))
    log(f"  flash_attention at q_offset {half}: q {tuple(qh.shape)} against "
        f"{k.shape[2]} keys, {ms_text(ms)} (plain {ms_text(plain)}, bound "
        f"{bound_ms:.4f} ms by {bound_by}: {bound_ms / ms[0]:.1%} of peak); "
        f"worst row {err / tol:.3f} of its tolerance")
    return {"offset_ms": ms[0], "offset_plain_ms": plain[0],
            "offset_bound_ms": bound_ms, "q_offset": half}


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


# ---------------------------------------------------------------------------
# tracking a training iteration on the card (phases 14-15)
# ---------------------------------------------------------------------------
def op_list(trace) -> list:
    """Everything a tracked op records but its time: the card's list must
    equal the CPU's."""
    return [(op.name, op.kind, sorted(op.params.items()), op.cost.flops,
             op.in_shapes, op.out_shapes, op.dtype, op.multiplicity)
            for op in trace.ops]


def card_matches_cpu(torch, device) -> None:
    """Each net at the test widths, tracked on ``device`` and on the CPU:
    equal op lists."""
    from repro_torch.core.trace import OperationTracker
    from repro_torch.models import evalzoo
    for name, kw in TRACK_SMALL.items():
        lists = []
        for dev in (device, "cpu"):
            it, params, batch = evalzoo.make_train_iteration(
                name, device=dev, **kw)
            lists.append(op_list(OperationTracker().track(it, params,
                                                          batch)))
        if lists[0] != lists[1]:
            names = [collections.Counter(op[:2] for op in ops)
                     for ops in lists]
            at = next((i for i, (a, b) in enumerate(zip(*lists)) if a != b),
                      min(map(len, lists)))
            fail(f"{name}: the op list on {device} differs from the CPU's "
                 f"({len(lists[0])} vs {len(lists[1])} ops; only on "
                 f"{device}: {dict(names[0] - names[1])}, only on the CPU: "
                 f"{dict(names[1] - names[0])}; first difference at op "
                 f"{at}: {lists[0][at:at + 1]} vs {lists[1][at:at + 1]})")
        log(f"  {name} at the test widths: {len(lists[0])} ops, the same "
            f"list on {device} and the CPU")


def iteration_ms(torch, it, params, batch, device) -> float:
    """The iteration's own time: CUDA events, median of 5 after 2
    warm-ups (the host clock on a CPU rehearsal)."""
    if torch.device(device).type == "cuda":
        return time_ms(torch, lambda: it(params, batch), iters=5, warmup=2,
                       spin=False)
    it(params, batch)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        it(params, batch)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def track_net(torch, name, device, origin="H100-SXM", **kw):
    """One training iteration of ``name`` tracked with ``wallclock`` on
    ``device``, gated and logged (phase 14).  Returns the trace."""
    from repro_torch.core.trace import OperationTracker
    from repro_torch.models import evalzoo
    on_card = torch.device(device).type == "cuda"
    it, params, batch = evalzoo.make_train_iteration(name, device=device,
                                                     **kw)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trace = OperationTracker(origin, measure="wallclock").track(
        it, params, batch, label=f"{name}" + "".join(
            f"-{k}{v}" for k, v in kw.items()))
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else 0.0
    kinds = collections.Counter(op.kind for op in trace.ops)
    varying = {k: kinds[k] for k in KINDS if kinds[k]}
    if len(trace.ops) <= 20 or not varying:
        fail(f"{trace.label}: {len(trace.ops)} ops, kernel-varying "
             f"{varying}: not a training iteration")
    ms = np.asarray([op.measured_ms for op in trace.ops], np.float64)
    if not (np.isfinite(ms).all() and (ms > 0).all()):
        fail(f"{trace.label}: measured_ms not all finite and > 0")
    own = iteration_ms(torch, it, params, batch, device)
    top = sorted(trace.breakdown().items(), key=lambda kv: -kv[1])[:4]
    log(f"  {trace.label}: {len(trace.ops)} ops ({varying}, "
        f"{len(trace.ops) - sum(varying.values())} kernel-alike over "
        f"{len(kinds) - len(varying)} kinds), covered "
        f"{trace.covered_fraction:.1%}, sum of op ms {trace.run_time_ms:.3f} "
        f"ms vs the iteration's own {own:.3f} ms "
        f"({trace.run_time_ms / own:.2f}x; most by kind: "
        f"{', '.join(f'{k} {v:.2f}' for k, v in top)} ms), tracked in "
        f"{seconds:.1f} s, peak {peak:.2f} GiB")
    del it, params, batch
    if on_card:
        torch.cuda.empty_cache()
    return trace


def check_tracked_answers(ranks, cold, warm, traces, fleet_minus, mlps,
                          devs) -> None:
    """Phase 15's answers against the same predictor on the CPU with the
    plain scorer: every cell at rtol 1e-4."""
    from repro_torch.core.predictor import HabitatPredictor
    cpu = HabitatPredictor(mlps, device="cpu", sweep_scorer="plain")
    want = cpu.predict_sweep(traces, devs).total_ms
    got = np.asarray([[row[d] for d in devs] for row in warm])
    if not np.isfinite(got).all() or (got <= 0).any():
        fail("tracked sweep (c) returned non-finite or non-positive times")
    worst = float(np.max(np.abs(got / want - 1.0)))
    cols = [devs.index(d) for d in fleet_minus]
    got_b = np.asarray([[row[d] for d in fleet_minus] for row in cold])
    worst = max(worst, float(np.max(np.abs(
        got_b / want[:len(cold)][:, cols] - 1.0))))
    for trace, (rank_t, rank_c) in zip(traces, ranks):
        fleet = cpu.predict_fleet(trace, devs).as_dict()
        for c in rank_t + rank_c:
            worst = max(worst, abs(c.iter_ms / fleet[c.device] - 1.0))
        times = [c.iter_ms for c in rank_t]
        if times != sorted(times) or len(rank_t) != len(devs):
            fail(f"{trace.label}: rank by throughput is not the whole "
                 f"fleet, fastest first")
    log(f"  answers vs the CPU plain path: max rel err {worst:.3e} (ranks, "
        f"sweep (b) and (c))")
    if worst > 1e-4:
        fail(f"tracked answers disagree with the CPU plain path: {worst:.3e}")


def fleet_from_tracked(torch, fms, batched, mlps, traces, extra,
                       trained=None, device="cuda", **predictor_kw) -> dict:
    """Phase 15: the tracked traces through the planner on ``device``;
    with ``trained`` (phase 10's MLPs) also logs what a trained predictor
    makes of them.  Returns the scorer launches of requests (a)-(c)."""
    import tempfile

    from repro_torch.core import devices
    from repro_torch.core.predictor import HabitatPredictor
    from repro_torch.serve.fleet import FleetPlanner
    devs = sorted(devices.all_devices())
    fleet_minus = [d for d in devs if d not in DROPPED]
    planner = FleetPlanner(HabitatPredictor(mlps, device=device,
                                            **predictor_kw))
    fms.reset_launches()
    batched.SCORER_DISPATCHES.reset()
    t0 = time.perf_counter()
    ranks = [(planner.rank(t, 32, by="throughput"),
              planner.rank(t, 32, by="cost")) for t in traces]
    t1 = time.perf_counter()
    cold = planner.sweep(traces, dests=fleet_minus)
    t2 = time.perf_counter()
    warm = planner.sweep(traces + [extra])
    t3 = time.perf_counter()
    launches = dict(fms.LAUNCHES)
    log(f"  (a) 5 traces ranked twice: {(t1 - t0) * 1e3:.1f} ms; (b) cold "
        f"sweep 5 x {len(fleet_minus)}: {(t2 - t1) * 1e3:.1f} ms; (c) "
        f"masked sweep 6 x {len(devs)}: {(t3 - t2) * 1e3:.1f} ms; "
        f"launches {launches}, dispatches "
        f"{batched.SCORER_DISPATCHES.snapshot()}")
    for kname, n in launches.items():
        if n < 1:
            fail(f"{kname} was never launched on the tracked traces")
    for trace, (rank_t, rank_c) in zip(traces, ranks):
        rentable = [c for c in rank_c if c.cost_per_hour]
        log(f"  {trace.label}: {trace.run_time_ms:.2f} ms on "
            f"{trace.origin_device} (sum of op ms); "
            f"fastest {rank_t[0].device} {rank_t[0].iter_ms:.2f} ms, "
            f"slowest {rank_t[-1].device} {rank_t[-1].iter_ms:.2f} ms, best "
            f"samples/$ {rentable[0].device if rentable else 'none'}")
    check_tracked_answers(ranks, cold, warm, traces + [extra], fleet_minus,
                          mlps, devs)
    with tempfile.TemporaryDirectory() as tmp:
        shared = FleetPlanner(HabitatPredictor(mlps, device=device,
                                               **predictor_kw),
                              cache=Path(tmp) / "fleet.sqlite")
        first = shared.sweep(traces)
        misses = shared.stats.misses
        second = shared.sweep(traces)
        hits = shared.stats.hits
        shared.cache.close()
    if second != first or hits != len(traces) * len(devs) or \
            shared.stats.misses != misses:
        fail(f"sqlite planner: second sweep hits {hits}, misses "
             f"{shared.stats.misses - misses} more, equal {second == first}")
    log(f"  sqlite planner: sweep twice, the second {hits} hits and equal "
        f"answers")
    if trained is not None:
        pred = HabitatPredictor(trained, device=device, **predictor_kw)
        grid = pred.predict_sweep(traces, devs).total_ms
        show = ("V100", "T4", "P100", "tpu-v5e")
        log("  phase 10's trained default MLPs (3 x 256), predicted "
            "iteration ms from the H100-SXM traces (log only):")
        for trace, row in zip(traces, grid):
            log(f"    {trace.label}: " + ", ".join(
                f"{d} {row[devs.index(d)]:.2f}" for d in show))
    return launches


def cli_fleet(torch) -> None:
    """Phase 15's CLI run: Qwen3-0.6B served at its published config,
    then ``--fleet --sweep`` on the tracked decode step."""
    import contextlib
    import io
    from repro_torch.launch import serve
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", "qwen3-0.6b", "--requests", "4",
                    "--prompt-len", "32", "--max-new", "4", "--batch", "4",
                    "--max-seq", "64", "--fleet", "--sweep"])
    text = out.getvalue()
    for want in ("served 4/4 requests", "fleet ranking for one decode step",
                 "origin H100-SXM", "what-if sweep: 3 traces"):
        if want not in text:
            fail(f"launch.serve --fleet --sweep: no {want!r} in its output")
    log(f"  launch.serve --arch qwen3-0.6b --fleet --sweep on the card in "
        f"{time.perf_counter() - t0:.1f} s:")
    for line in text.splitlines():
        log(f"    {line}")


# ---------------------------------------------------------------------------
# phase 16: the prediction service on the card
# ---------------------------------------------------------------------------
#: the registry's six GPUs: one of phase 16's rank fleets
SERVE_GPUS = ("P100", "P4000", "RTX2070", "RTX2080Ti", "T4", "V100")
SERVE_RANK_CLIENTS = 64
#: a front end's admission limit in the overload gate (requests in flight)
SERVE_OVERLOAD_QUEUE = 8
#: how long a burst client keeps sending a shed request (429/503) again
#: after its Retry-After, as the wire protocol asks a client to
SERVE_PATIENCE_S = 60.0
#: most sheds a cold burst may take, a request on average: 64 cold
#: clients at once exceed the 4 s in-flight budget, so some are shed and
#: sent again; a warm burst, which runs no engine work, may take none
SERVE_COLD_SHEDS_A_REQUEST = 1.0


def _http(url: str, path: str, payload=None, timeout: float = 300.0):
    """(status, decoded body, headers, seconds) of one request; an HTTP
    error status is an answer, not an exception.  ``/sweep/stream``'s
    body is its list of SSE events."""
    import urllib.error
    import urllib.request
    from repro_torch.serve.aserver import iter_sse
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url + path, data=data, headers={"Content-Type": "application/json"},
        method="GET" if data is None else "POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body = (list(iter_sse(resp)) if path == "/sweep/stream"
                    else json.loads(resp.read()))
            out = resp.status, body, dict(resp.headers)
    except urllib.error.HTTPError as e:
        with e:
            out = e.code, json.loads(e.read() or b"{}"), dict(e.headers)
    return (*out, time.perf_counter() - t0)


def _burst(url: str, calls: list, patience_s: float = SERVE_PATIENCE_S):
    """Fire ``calls`` ((route, payload)) from one thread each,
    barrier-started.  A client whose request is shed (429/503 with
    ``Retry-After``) waits that long, or longer as its sheds repeat
    (0.2 s doubling to 4 s), and sends it again, for up to
    ``patience_s`` seconds.  Returns, in call order, the last answer of
    each call with its seconds over all attempts and its sheds (status,
    body, headers, seconds, sheds), and the burst's wall seconds.
    ``patience_s`` 0 takes the first answer."""
    import threading
    results = [None] * len(calls)
    barrier = threading.Barrier(len(calls))

    def run(i):
        route, payload = calls[i]
        barrier.wait()
        t0, sheds = time.perf_counter(), []
        try:
            while True:
                out = _http(url, route, payload)
                if out[0] not in (429, 503) or "Retry-After" not in out[2] \
                        or time.perf_counter() - t0 > patience_s:
                    break
                sheds.append(out[0])    # Retry-After, backing off
                time.sleep(max(float(out[1].get("retry_after_s", 1.0)),
                               min(0.1 * 2 ** len(sheds), 4.0)))
            results[i] = (*out[:3], time.perf_counter() - t0, sheds)
        except Exception as e:          # surfaced by the gates
            results[i] = (-1, repr(e), {}, time.perf_counter() - t0, sheds)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(calls))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, time.perf_counter() - t0


def serve_traffic(everyone, new_traces, tracked, extra, fleet_minus, doc,
                  stream: bool):
    """Phase 16's cold burst in two rounds, as lists of (route, payload).

    Round 1: ``SERVE_RANK_CLIENTS`` ``/rank`` clients, one of the 37
    traces each, over the registry minus phase 4's five dropped devices
    or its six GPUs: their union pass misses every cell, so it runs the
    block scorer.  Round 2, once round 1 has answered: 8 ``/sweep``s of
    4-6 traces (the 37 between them, and phase 4's 4 new ones), 16
    ``/rank``s and 2 ``/optimize``s over the whole registry (and one
    ``/sweep/stream`` where the front end has it): traces warm on round
    1's devices meet the three it left out, so the union pass is
    cell-masked and runs the row scorer.  After round 2 every trace is
    warm on every device: a union pass also prices the cells its
    co-batched requests did not ask for, so a replay batched otherwise
    would miss on a trace round 1 priced on a subset alone."""
    n = len(everyone)
    round1 = [("/rank", {"trace": doc(everyone[k % n]),
                         "batch_size": 32,
                         "by": ("throughput", "cost")[k // 2 % 2],
                         "dests": (fleet_minus if k % 2 == 0
                                   else list(SERVE_GPUS))})
              for k in range(SERVE_RANK_CLIENTS)]
    round2 = []
    for j, part in enumerate(np.array_split(np.arange(n), 8)):
        members = [everyone[i] for i in part] + list(new_traces[j:j + 1])
        round2.append(("/sweep", {"traces": [doc(t) for t in members]}))
    round2 += [("/rank", {"trace": doc(everyone[3 * k % n]),
                          "batch_size": 32}) for k in range(16)]
    dcgan = next(t for t in tracked if t.label.split("-")[0] == "dcgan")
    round2 += [("/optimize", {"traces": [doc(extra), doc(dcgan)],
                              "batch_sizes": [64, 128], "max_replicas": 8,
                              "seed": 1}),
               ("/optimize", {"traces": [doc(t) for t in everyone[3:6]],
                              "batch_sizes": [16, 32, 64], "max_replicas": 8,
                              "seed": 2})]
    if stream:
        round2.append(("/sweep/stream",
                       {"traces": [doc(t) for t in everyone[8:12]]}))
    return round1, round2


def _percentile_ms(seconds: list, q: float) -> float:
    return float(np.percentile(np.asarray(seconds) * 1e3, q))


def check_served(calls, results, want_of, devs, by_label) -> float:
    """Every served answer against the CPU plain grid: each (trace,
    device) cell within rtol 1e-4; the worst relative error."""
    worst = 0.0
    for (route, payload), (status, body, *_) in zip(calls, results):
        if status != 200:
            fail(f"{route} answered {status}: {str(body)[:300]}")
        if route == "/rank":
            want = want_of(payload["trace"])
            rows = body["ranking"]
            if len(rows) != len(payload.get("dests") or devs):
                fail(f"/rank answered {len(rows)} devices")
            for r in rows:
                if type(r["iter_ms"]) is not float:
                    fail(f"/rank iter_ms is not a float: {r}")
                worst = max(worst, abs(r["iter_ms"] / want[r["device"]] - 1))
        elif route == "/sweep":
            for tdoc, row in zip(payload["traces"], body["times"]):
                want = want_of(tdoc)
                if sorted(row) != sorted(devs):
                    fail("/sweep answered another fleet")
                for d, ms in row.items():
                    worst = max(worst, abs(ms / want[d] - 1))
        elif route == "/optimize":
            if not body["frontier"]:
                fail("/optimize answered an empty frontier")
            for c in body["frontier"]:
                want = by_label[c["label"]]
                worst = max(worst, abs(c["iter_ms"] / want[c["device"]] - 1))
        elif route == "/sweep/stream":
            rows = [p for e, p in body if e == "row"]
            if body[-1] != ("done", {"count": len(payload["traces"]),
                                     "errors": 0}):
                fail(f"/sweep/stream did not finish cleanly: {body[-1]}")
            for r in rows:
                want = want_of(payload["traces"][r["index"]])
                for d, ms in r["times"].items():
                    worst = max(worst, abs(ms / want[d] - 1))
    return worst


def _answer(body):
    """A response body, SSE events keyed by row index (they arrive in
    completion order)."""
    if isinstance(body, list):
        return {p.get("index", -1): p for _, p in body}
    return body


def front_end_bursts(fms, kind, server, service, rounds, check) -> dict:
    """Phase 16 (a) on one front end: the cold burst (``rounds``, one
    after the other), then the same burst again warm; gates and logs.
    Returns the cold results, a list a round, and their scorer
    launches."""
    out = {}
    for phase in ("cold", "warm"):
        before_l, before_s = dict(fms.LAUNCHES), service.stats()
        results, wall, n = [], 0.0, 0
        for calls in rounds:
            res, sec = _burst(server.url, calls)
            results.append(res)
            wall += sec
            n += len(calls)
        after_l, after_s = dict(fms.LAUNCHES), service.stats()
        launches = {k: after_l[k] - before_l[k] for k in after_l}
        passes = after_s["engine_passes"] - before_s["engine_passes"]
        misses = after_s["cache"]["misses"] - before_s["cache"]["misses"]
        hits = after_s["cache"]["hits"] - before_s["cache"]["hits"]
        co_a, co_b = after_s["coalescing"], before_s["coalescing"]
        co = {k: co_a[k] - co_b[k] for k in ("batches", "union_batches",
                                             "split_batches", "split_passes",
                                             "sliced_columns")}
        by_route = collections.defaultdict(list)
        for calls, res in zip(rounds, results):
            for (route, _), r in zip(calls, res):
                by_route[route].append(r[3])
        lat = ", ".join(
            f"{route} x{len(s)} p50 {_percentile_ms(s, 50):.1f} / p99 "
            f"{_percentile_ms(s, 99):.1f} ms"
            for route, s in sorted(by_route.items()))
        log(f"  {kind} {phase}: {n} requests in {wall:.2f} s "
            f"({n / wall:.1f} req/s); {lat}")
        sheds = collections.Counter(
            code for res in results for r in res for code in r[4])
        log(f"    engine passes {passes} ({passes / n:.3f} a request), "
            f"coalescing {co}, result cache +{hits} hits +{misses} misses, "
            f"scorer launches {launches}; shed and retried after "
            f"Retry-After: {dict(sheds) or 'none'}")
        n_shed = sum(sheds.values())
        if n_shed > (SERVE_COLD_SHEDS_A_REQUEST * n if phase == "cold"
                     else 0):
            fail(f"{kind} {phase} burst: {n_shed} sheds for {n} requests")
        worst = max(check(c, r) for c, r in zip(rounds, results))
        log(f"    answers vs the CPU plain path: max rel err {worst:.3e}")
        if worst > 1e-4:
            fail(f"{kind} {phase}: answers off the CPU plain path by "
                 f"{worst:.3e}")
        if phase == "cold":
            if not passes < n:
                fail(f"{kind}: {passes} engine passes for {n} requests")
            out["cold"], out["launches"] = results, launches
        else:
            if misses or passes or any(launches.values()):
                fail(f"{kind} warm burst: {misses} misses, {passes} passes, "
                     f"launches {launches}")
            for cold, warm in zip(out["cold"], results):
                for c, w in zip(cold, warm):
                    if c[0] != w[0] or _answer(c[1]) != _answer(w[1]):
                        fail(f"{kind}: a warm answer differs from the cold")
    samples = np.asarray(service.export_pass_samples(),
                         np.float64).reshape(-1, 3)
    cold, warm = samples[samples[:, 0] > 0], samples[samples[:, 0] == 0]
    log(f"    its last {len(samples)} engine passes (their threads' CPU "
        f"time): {len(cold)} cold, p50 "
        f"{np.median(cold[:, 2]) * 1e3 if len(cold) else 0:.1f} ms for "
        f"p50 {np.median(cold[:, 0]) if len(cold) else 0:.0f} cold "
        f"op-cells; {len(warm)} warm, p50 "
        f"{np.median(warm[:, 2]) * 1e3 if len(warm) else 0:.1f} ms")
    sm = service.stats()["split_model"]
    log(f"    fitted pass model: {sm['pass_overhead_ms']:.3f} ms a pass + "
        f"{sm['cell_cost_ns']:.2f} ns an op-cell (warm discount "
        f"{sm['warm_discount']:.3f}, {sm['samples']} samples; seeds 1.5 ms "
        f"and 40 ns)")
    return out


def profile_union_passes(torch, fms, predictor, everyone,
                         fleet_minus) -> None:
    """One coalesced cold union pass (16 ranks over the fleet minus five:
    the block scorer) and one cell-masked union pass (the same traces
    and 4 cold ones swept over the registry: the row scorer), each under
    ``torch.profiler``: wall, device busy share, the scorer's layer GEMMs
    and launches."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.service import PredictionService
    service = PredictionService(predictor=predictor,
                                coalesce_window_ms=1000.0, flush_at=16,
                                adaptive_window=False)
    batch = everyone[:16]
    steps = (("cold union pass, 16 /rank", 16, "fused_mlp_score",
              lambda: [service.submit_rank(t, 32, dests=fleet_minus)
                       for t in batch]),
             ("cell-masked union pass, 4 /sweep", 4, "fused_mlp_score_rows",
              lambda: [service.submit_sweep(batch[4 * i:4 * i + 4]
                                            + [everyone[16 + i]])
                       for i in range(4)]))
    for name, flush, kname, submit in steps:
        service.flush_at = flush
        before = dict(fms.LAUNCHES)
        passes = service.stats()["engine_passes"]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for h in submit():
                h.get(timeout=300)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        launched = {k: v - before[k] for k, v in fms.LAUNCHES.items()}
        rows = device_rows(torch, prof)
        busy = sum(r[0] for r in rows)
        gemm = [r for r in rows if "layer_kernel" in r[1]]
        log(f"  profile, {name}: {service.stats()['engine_passes'] - passes}"
            f" engine pass, launches {launched}; wall {wall_ms:.1f} ms, "
            f"device busy {busy:.1f} ms ({busy / wall_ms:.1%}), scorer "
            f"layer GEMMs {sum(r[0] for r in gemm):.3f} ms in "
            f"{sum(r[2] for r in gemm)} kernels")
        for ms, key, count in sorted(rows, reverse=True)[:5]:
            log(f"    {ms:9.3f} ms  x{count:<5d} {key[:90]}")
        if launched != {k: int(k == kname) for k in launched}:
            fail(f"the {name} launched {launched}, not {kname} once")


def overload_and_deadline(predictor, everyone, cold_doc) -> None:
    """A burst over an admission limit sheds with 429/503 and
    ``Retry-After``, never 500; ``deadline_ms`` 1 answers 504."""
    from repro_torch.serve.admission import AdmissionController
    from repro_torch.serve.http import PredictionServer
    from repro_torch.serve.service import PredictionService
    service = PredictionService(
        predictor=predictor,
        admission=AdmissionController(max_queue=SERVE_OVERLOAD_QUEUE))
    server = PredictionServer(service).start()
    try:
        calls = [("/sweep", {"traces": [everyone[k % len(everyone)]
                                        .to_dict()]})
                 for k in range(SERVE_RANK_CLIENTS)]
        results, wall = _burst(server.url, calls, patience_s=0.0)
        codes = collections.Counter(r[0] for r in results)
        shed = [r for r in results if r[0] in (429, 503)]
        log(f"  overload: {len(calls)} concurrent /sweep against max_queue "
            f"{SERVE_OVERLOAD_QUEUE}: statuses {dict(codes)} in {wall:.2f} s")
        if not shed or set(codes) - {200, 429, 503}:
            fail(f"overload burst: statuses {dict(codes)}")
        if any("Retry-After" not in r[2] for r in shed):
            fail("a shed answer carries no Retry-After")
        status, body, _, sec = _http(server.url, "/rank", {
            "trace": cold_doc, "batch_size": 32, "deadline_ms": 1})
        log(f"  deadline_ms 1 on a cold trace: {status} in {sec * 1e3:.1f} "
            f"ms ({body.get('error', '')[:80]})")
        if status != 504:
            fail(f"deadline_ms 1 answered {status}, not 504")
    finally:
        server.shutdown()


def snapshot_round_trip(predictor, service, calls, results) -> None:
    """Snapshot the warm service, restore into a fresh one: the repeat of
    the burst's first round runs 0 engine passes, bitwise equal."""
    import tempfile
    from repro_torch.serve.service import PredictionService
    from repro_torch.serve.snapshot import SnapshotManager
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "worker.snap"
        t0 = time.perf_counter()
        if not SnapshotManager(path, service, interval_s=0).save():
            fail("snapshot save failed")
        save_s = time.perf_counter() - t0
        fresh = PredictionService(predictor=predictor)
        manager = SnapshotManager(path, fresh, interval_s=0)
        t0 = time.perf_counter()
        if not manager.restore():
            fail("snapshot restore failed")
        restore_s = time.perf_counter() - t0
        nbytes = path.stat().st_size
    for (route, payload), (_, body, *_) in zip(calls, results):
        if fresh.rank_request(json.dumps(payload)) != body:
            fail("a restored answer differs from the served one")
    passes = fresh.stats()["engine_passes"]
    log(f"  snapshot: {nbytes} bytes, saved in {save_s:.3f} s, restored "
        f"{manager.restored_entries} entries in {restore_s:.3f} s; "
        f"{len(calls)} repeat /rank: {passes} engine passes, bitwise equal")
    if passes:
        fail(f"the restored service ran {passes} engine passes")


def check_stream(url, calls, results) -> None:
    """The SSE rows of the burst's ``/sweep/stream`` equal ``/sweep``'s
    answer to the same payload."""
    (_, payload), (_, events, *_) = next(
        (c, r) for c, r in zip(calls, results) if c[0] == "/sweep/stream")
    status, body, *_ = _http(url, "/sweep", payload)
    rows = {p["index"]: p["times"] for e, p in events if e == "row"}
    if status != 200 or [rows[i] for i in range(len(rows))] != body["times"]:
        fail("the SSE rows differ from /sweep's answer")
    log(f"  /sweep/stream: {len(rows)} rows equal to /sweep's")


def serve_in_process(torch, fms, batched, mlps, everyone, new_traces,
                     tracked, extra, doc, want_of, by_label, devs,
                     fleet_minus, cold_doc, device="cuda") -> None:
    """Phase 16 (a): both front ends in process at full width."""
    from repro_torch.core.predictor import HabitatPredictor
    from repro_torch.serve.aserver import AsyncPredictionServer
    from repro_torch.serve.http import PredictionServer
    from repro_torch.serve.service import PredictionService
    predictor = HabitatPredictor(mlps, device=device)
    check = lambda calls, res: check_served(calls, res, want_of, devs,
                                            by_label)
    fms.reset_launches()
    batched.SCORER_DISPATCHES.reset()
    launched = collections.Counter()
    services = []
    for kind, cls in (("threaded", PredictionServer),
                      ("asyncio", AsyncPredictionServer)):
        service = PredictionService(predictor=predictor)
        server = cls(service).start()
        services.append((server, service))
        rounds = serve_traffic(everyone, new_traces, tracked, extra,
                               fleet_minus, doc,
                               stream=cls is AsyncPredictionServer)
        out = front_end_bursts(fms, kind, server, service, rounds, check)
        launched.update(out["launches"])
        if cls is AsyncPredictionServer:
            check_stream(server.url, rounds[1], out["cold"][1])
        else:
            served = (service, rounds[0], out["cold"][0])
    log(f"  scorer launches over both cold bursts: {dict(launched)}")
    for kname in ("fused_mlp_score", "fused_mlp_score_rows"):
        if launched[kname] < 1:
            fail(f"{kname} was never launched by a served union pass")
    if device == "cuda":
        profile_union_passes(torch, fms, predictor, everyone, fleet_minus)
    overload_and_deadline(predictor, everyone, cold_doc)
    snapshot_round_trip(predictor, *served)
    for server, service in services:
        t0 = time.perf_counter()
        quiesced = service.drain(timeout=10.0)
        log(f"  drain: quiesced={quiesced} in "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        if not quiesced:
            fail("a front end did not quiesce on drain")
        server.shutdown()


def _readiness(proc, lines: list, timeout: float = 300.0) -> str:
    """The url of a ``serving on <url>`` line, keeping the lines before
    it; fails when the process exits first."""
    deadline = time.monotonic() + timeout
    for line in proc.stdout:
        lines.append(line)
        if line.startswith("serving on "):
            return line.split("serving on ", 1)[1].strip()
        if time.monotonic() > deadline:
            break
    fail(f"no readiness line from {proc.args[2:5]}: {''.join(lines)[-2000:]}")


def _child_pids(parent: int, marker: bytes) -> list:
    """Processes whose parent is ``parent`` and whose command line holds
    ``marker`` (read from ``/proc``: each pid's ``stat`` names its
    parent)."""
    pids = []
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            ppid = int((d / "stat").read_text().rsplit(")", 1)[1].split()[1])
            if ppid == parent and marker in (d / "cmdline").read_bytes():
                pids.append(int(d.name))
        except (OSError, IndexError, ValueError):
            continue            # gone, or not ours to read
    return pids


class Cluster:
    """Phase 16 (b): ``launch.serve --cache-server`` and a routed,
    supervised pair of workers (``launch.serve --serve --router``) as
    processes on the card.  :meth:`start` spawns them and returns at
    once (a worker takes seconds to load torch, CUDA and its MLPs; phase
    16 starts them only after (a), whose admission gates read the host's
    clocks and would otherwise share its cores with three processes
    starting up); :meth:`drive` waits for the router, sends the
    traffic and kills a worker; :meth:`finish` waits for its restart and
    ends the launcher; :meth:`stop` ends every process this started."""

    def __init__(self, device="cuda"):
        import os
        self.env = dict(os.environ)
        self.env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(SRC), self.env.get("PYTHONPATH")) if p)
        self.device = device
        self.procs, self.lines = [], {"cache": [], "fleet": []}
        self.url, self.t0 = None, 0.0

    def start(self) -> "Cluster":
        import threading
        launcher = [sys.executable, "-m", "repro_torch.launch.serve"]
        self.t0 = time.perf_counter()
        cache = subprocess.Popen(launcher + ["--cache-server", "--port", "0"],
                                 stdout=subprocess.PIPE, text=True,
                                 env=self.env)
        self.procs.append(cache)
        self.address = _readiness(cache, self.lines["cache"])
        self.fleet = subprocess.Popen(
            launcher + ["--serve", "--router", "--workers", "2", "--port",
                        "0", "--device", self.device, "--fleet-mlps",
                        "--cache", self.address],
            stdout=subprocess.PIPE, text=True, env=self.env)
        self.procs.append(self.fleet)
        self.ready = threading.Event()

        def pump():
            for line in self.fleet.stdout:
                self.lines["fleet"].append(line)
                if self.url is None and line.startswith("serving on "):
                    self.url = line.split("serving on ", 1)[1].strip()
                    self.ready_s = time.perf_counter() - self.t0
                    self.ready.set()
            self.ready.set()            # exited: drive() reports it
        threading.Thread(target=pump, daemon=True).start()
        return self

    def drive(self, everyone) -> None:
        import os
        import signal
        from repro_torch.serve.router import FingerprintRouter
        self.ready.wait(timeout=300)
        url = self.url
        if url is None:
            fail(f"the router never came up: "
                 f"{''.join(self.lines['fleet'])[-2000:]}")
        log(f"  cluster: cache server {self.address}; router {url} and 2 "
            f"workers ready {self.ready_s:.1f} s after they were started")
        workers = sorted(_http(url, "/stats")[1]["router"]["workers"])
        ring = FingerprintRouter(workers)
        owned = {w: [t for t in everyone
                     if ring.owner(t.fingerprint()) == w][:4]
                 for w in workers}
        ring.close()
        picked = [t for w in workers for t in owned[w]]
        forwarded = lambda: [v["forwarded"] for v in _http(url, "/stats")[1]
                             ["router"]["workers"].values()]
        seconds = []
        for t in picked:            # 16 /rank: each trace twice
            before = forwarded()
            for _ in range(2):
                status, body, _, sec = _http(url, "/rank", {
                    "trace": t.to_dict(), "batch_size": 32})
                seconds.append(sec)
                if status != 200:
                    fail(f"router /rank answered {status}: {body}")
            if sorted(a - b for a, b in zip(forwarded(), before)) != [0, 2]:
                fail(f"{t.label} did not stay on one worker")
        for w in workers:
            fused = _http(w, "/stats")[1]["engine_caches"][
                "scorer_dispatches"]["fused"]
            log(f"  worker {w}: scorer_dispatches.fused {fused}")
            if fused < 1:
                fail(f"worker {w} never ran the fused scorer")
        log(f"  {len(seconds)} /rank through the router, each trace on one "
            f"worker: p50 {_percentile_ms(seconds, 50):.1f} / p99 "
            f"{_percentile_ms(seconds, 99):.1f} ms")
        pids = _child_pids(self.fleet.pid, b"repro_torch.serve.http")
        if len(pids) != 2:
            fail(f"the launcher runs {len(pids)} workers, not 2")
        os.kill(pids[0], signal.SIGKILL)
        t0 = time.perf_counter()
        first = None
        for t in picked:
            status, body, _, sec = _http(url, "/rank", {
                "trace": t.to_dict(), "batch_size": 32})
            if status != 200:
                fail(f"after the kill /rank answered {status}: {body}")
            first = first or time.perf_counter() - t0
        self.killed_at = t0
        log(f"  SIGKILL of a worker: all {len(picked)} traces answered in "
            f"{time.perf_counter() - t0:.2f} s (first {first * 1e3:.1f} "
            f"ms)")

    def finish(self) -> None:
        """The killed worker back (the supervisor's restart), then
        SIGTERM to the launcher: exit 0."""
        import signal
        back = lambda: any("worker back on" in ln
                           for ln in self.lines["fleet"])
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not back():
            time.sleep(0.1)
        if not back():
            fail("the supervisor did not restart the killed worker")
        log(f"  the supervisor had the killed worker back "
            f"{time.perf_counter() - self.killed_at:.1f} s after the kill")
        self.fleet.send_signal(signal.SIGTERM)
        rc = self.fleet.wait(timeout=120)
        log(f"  SIGTERM to the launcher: exit {rc}; "
            + "; ".join(ln.strip() for ln in self.lines["fleet"]
                        if ln.startswith(("supervisor", "drain"))))
        if rc != 0:
            fail(f"the launcher exited {rc} on SIGTERM")

    def stop(self) -> None:
        import signal
        for p in self.procs:
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()


def cli_optimize() -> None:
    """Phase 16 (c): ``launch.serve --optimize`` on the card."""
    import contextlib
    import io
    from repro_torch.launch import serve
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", "qwen3-0.6b", "--requests", "4",
                    "--prompt-len", "32", "--max-new", "4", "--optimize"])
    text = out.getvalue()
    for want in ("served 4/4 requests", "what-if optimizer: time-vs-cost "
                 "frontier", "candidates /", "engine passes for the whole "
                 "search"):
        if want not in text:
            fail(f"launch.serve --optimize: no {want!r} in its output")
    log(f"  launch.serve --arch qwen3-0.6b --optimize on the card in "
        f"{time.perf_counter() - t0:.1f} s:")
    for line in text.splitlines()[-8:]:
        log(f"    {line}")


def serve_predictions(torch, fms, batched, mlps, traces, new_traces,
                      tracked, extra, want, devs, fleet_minus,
                      device="cuda") -> None:
    """Phase 16: the prediction service in process (a), as processes (b)
    and through the CLI (c).  ``want`` is phase 4's CPU plain grid of
    ``traces + new_traces`` over ``devs``."""
    from repro_torch.core.predictor import HabitatPredictor
    more = list(tracked) + [extra]
    every = list(traces) + list(new_traces) + more
    t0 = time.perf_counter()
    cpu = HabitatPredictor(mlps, device="cpu", sweep_scorer="plain")
    grid = np.concatenate([want, cpu.predict_sweep(more, devs).total_ms])
    docs = {id(t): t.to_dict() for t in every}
    rows = {id(docs[id(t)]): dict(zip(devs, g.tolist()))
            for t, g in zip(every, grid)}
    by_label = {t.label: rows[id(docs[id(t)])] for t in every}
    if len(by_label) != len(every):
        fail("phase 16's traces need distinct labels")
    cold_doc = synthetic_trace(200).to_dict()
    log(f"  {len(every)} traces and their CPU plain answers ready in "
        f"{time.perf_counter() - t0:.1f} s")
    everyone = list(traces) + list(tracked)
    serve_in_process(torch, fms, batched, mlps, everyone, new_traces,
                     tracked, extra, lambda t: docs[id(t)],
                     lambda d: rows[id(d)], by_label, devs, fleet_minus,
                     cold_doc, device=device)
    procs = Cluster(device=device).start()
    try:
        procs.drive(everyone)
        cli_optimize()              # while the killed worker restarts
        procs.finish()
    finally:
        procs.stop()


# ---------------------------------------------------------------------------
# phase 18: training the LMs on the card
# ---------------------------------------------------------------------------
#: the LMs phase 18 trains at their published configs, and the kernel
#: each trains through
TRAIN_ARCHS = {"qwen3-0.6b": "flash_attention", "mamba2-130m": "ssd"}
#: (a): one batch of 1 x GRAD_SEQ tokens.  fp32: the kernel path's loss
#: within GRAD_LOSS_REL of the plain path's, and its gradients within
#: max(GRAD_REL, twice the fp32 floor) of both the plain fp32 path's and
#: the fp64 plain path's, each leaf against its own largest element.  The
#: fp32 floor is the plain fp32 path's largest such distance from the
#: same plain path run in fp64: what fp32 rounding alone moves the
#: gradients of this model.  GRAD_REL is narrowed from the 1e-3 first
#: asked for, which random Mamba2-130M's own fp32 rounding exceeds (on an
#: H100 80GB HBM3 at 700 W its plain fp32 conv_b lay 6.8e-3 of its scale
#: from fp64, seed 0; the kernel path 3.2e-3; Qwen3's leaves all within
#: 1.9e-5)
GRAD_SEQ = 2048
GRAD_LOSS_REL = 1e-5
GRAD_REL = 1e-4
#: bf16, as trained (the phase-7 method): the gradients' largest distance
#: from the fp32 plain path, the kernel path's within twice the plain
#: bf16 path's (the floor).  A zero or unrelated gradient reads about 1,
#: so the gate can fail one only while twice the floor lies below 1: it
#: holds the kernels named here and fails if that no longer holds.  The
#: random Mamba2-130M's floor is 2.5-7.6 (seeds 1 and 0: its bf16
#: gradients are noise against fp32's, so a model-level gate would pass
#: anything); the scan's bf16 gradient is held at the op instead
BF16_GRAD_GATED = ("flash_attention",)
#: the bf16 loss's distance from the fp32 plain loss, relative to it: each
#: kernel path's limit, set between what correct bf16 paths read and what
#: a broken kernel reads (the plain path with a fault a kernel could have,
#: ``broken_path``); the broken path must lie beyond the limit, or the
#: gate could not catch it and fails.  On an H100 80GB HBM3 at 700 W,
#: seeds 0 and 1, kernel and plain paths against the broken one: Qwen3
#: 9.5e-6-2.8e-5 against 7.9e-5-2.7e-4; Mamba2 2.0e-5-3.6e-4 against
#: 5.4e-4-8.2e-4.  At random weights a broken kernel moves the loss only
#: a few times bf16's own noise, so this gate is thin; the op gate below
#: is the one that separates them widely
BF16_LOSS_REL = {"flash_attention": 5e-5, "ssd": 4.5e-4}
#: (a) at the op: every layer's inputs to the op in a bf16 forward at
#: (b)'s batch, y held row by row against the plain function (flash:
#: phase 6's gate; the scan: ``ssd_chunked`` at ``cfg.ssm_chunk``, within
#: OP_SSD_ROW_REL of the row's largest |y|, floored at OP_ROW_FLOOR of
#: the layer's largest: the kernel and ``ssd_chunked`` each lie up to
#: 1.9e-4 of a row from the sequential fp32 oracle, a scan without its
#: carry about 1.2), and the op's gradient against autograd through the
#: function its backward differentiates, with the same cotangent, each
#: input within OP_GRAD_REL of its own largest element (the same
#: function on the same inputs: equal but for the order of reductions;
#: bitwise on the card)
OP_SSD_ROW_REL = 1e-3
OP_ROW_FLOOR = 1e-3
OP_GRAD_REL = 2.0 ** -8
#: parameters that reach the loss only through the kernel op: each must
#: get a non-zero gradient on the kernel path in every layer (in_proj
#: also feeds the gate, and is checked on its x, B, C and dt columns)
THROUGH_KERNEL = {"flash_attention": ("wq", "wk", "wv", "q_norm", "k_norm"),
                  "ssd": ("in_proj", "conv_w", "a_log", "dt_bias")}
#: (b): Trainer(cfg, batch=2, seq=4096), train_4k's sequence length
TRAIN_BATCH, TRAIN_SEQ = 2, 4096
TRAIN_STEPS, TRAIN_EVERY, TRAIN_CRASH = 4, 2, 3
TRAIN_PROFILE_STEPS = 3
#: op calls (each with its gradient) profiled for the VJP's device ms
VJP_CALLS = 3
#: (c)-(d): the CLI's tracked step and the distributed prediction
CLI_STEPS = 3
DP_DEGREE = 8


def _names(params):
    return [n for n, _ in params.named_parameters()]


def lm_grads(torch, tfm, params, cfg, batch) -> tuple:
    """(loss, {name: fp32 gradient}) of one ``loss_fn`` on ``batch``."""
    params.requires_grad_(True)
    loss, _ = tfm.loss_fn(params, cfg, batch)
    got = torch.autograd.grad(loss, list(params.parameters()),
                              allow_unused=True)
    grads = {n: (torch.zeros_like(p, dtype=torch.float32) if g is None
                 else g.float()) for (n, p), g in
             zip(params.named_parameters(), got)}
    return float(loss.detach()), grads


def _swapped(mod, name: str, fn):
    """A context in which ``mod.name`` is ``fn``."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        orig = getattr(mod, name)
        setattr(mod, name, fn)
        try:
            yield
        finally:
            setattr(mod, name, orig)
    return ctx()


def plain_path(cfg, kname: str):
    """A context in which the model runs its plain path for ``kname``:
    dense attention, or the port's ``ssd_chunked`` at ``cfg.ssm_chunk``
    (the reference's training path)."""
    from repro_torch.kernels import ssd as sk
    from repro_torch.models import attention as attn
    from repro_torch.models import ssm as ssm_mod
    if kname == "flash_attention":
        return _swapped(attn, "flash_attention", attn.dense_attention)

    def ssd(x, dt, a, bmat, cmat, chunk=sk.MAX_CHUNK,
            vjp_chunk=sk.VJP_CHUNK):
        y, s = ssm_mod.ssd_chunked(
            x.transpose(1, 2), dt.transpose(1, 2), a, bmat.transpose(1, 2),
            cmat.transpose(1, 2), chunk=vjp_chunk, return_final=True)
        return y.transpose(1, 2), s
    return _swapped(sk, "ssd", ssd)


def dropped_carry(x, dt, a, bmat, cmat, chunk):
    """The scan in the kernel's layout with the state dropped between
    chunks of ``chunk`` rows: each chunk scanned from a zero state, as a
    kernel that lost its state pass would.  Returns (y, the last chunk's
    final state)."""
    from repro_torch.models import ssm as ssm_mod
    b, h, l, p = x.shape
    if l % chunk:
        fail(f"dropped_carry: length {l} is not a multiple of {chunk}")

    def rows(t):              # (B, H, L, ...) -> (B L / chunk, chunk, H, ...)
        t = t.transpose(1, 2)
        return t.reshape(b * (l // chunk), chunk, *t.shape[2:])
    y, s = ssm_mod.ssd_chunked(rows(x), rows(dt), a, rows(bmat), rows(cmat),
                               chunk=chunk, return_final=True)
    return (y.reshape(b, l, h, p).transpose(1, 2),
            s.reshape(b, l // chunk, *s.shape[1:])[:, -1])


def broken_path(cfg, kname: str):
    """A context in which the model runs the plain path with a fault a
    kernel could have: attention without its causal mask (the future
    read), or the scan with its state dropped between the kernel's
    chunks."""
    from repro_torch.kernels import ssd as sk
    from repro_torch.models import attention as attn
    if kname == "flash_attention":
        return _swapped(attn, "flash_attention",
                        lambda q, k, v, causal=True, window=0:
                        attn.dense_attention(q, k, v, causal=False,
                                             window=window))

    def ssd(x, dt, a, bmat, cmat, chunk=sk.MAX_CHUNK,
            vjp_chunk=sk.VJP_CHUNK):
        return dropped_carry(x, dt, a, bmat, cmat, chunk)
    return _swapped(sk, "ssd", ssd)


def fp64_path(torch):
    """A context in which the model computes in fp64 where it names fp32:
    its code casts to ``torch.float32`` for its fp32 islands (norms, rope,
    the softmax, the scan, the cross-entropy), so with fp64 parameters
    and ``torch.float32`` read as fp64 the whole step is fp64."""
    return _swapped(torch, "float32", torch.float64)


def grad_distance(grads, ref) -> tuple:
    """(max over leaves of max |g - ref| / max |ref|, that leaf's name):
    each leaf against its own scale."""
    return max((float((grads[n] - r).abs().max())
                / max(float(r.abs().max()), 1e-30), n)
               for n, r in ref.items())


def gradient_gate(torch, cfg, device, kname) -> None:
    """Phase 18 (a) for one model: the gradient through the kernel op
    against the plain path, in fp32 (the floor from an fp64 plain pass)
    and in bf16 as trained; the bf16 loss against a broken kernel's."""
    from repro_torch.models import transformer as tfm
    from repro_torch.train.data import SyntheticTokens
    from repro_torch.train.trainer import to_device
    batch = to_device(SyntheticTokens(cfg, 1, GRAD_SEQ).batch_at(0), device)

    def grads(p, *contexts):
        import contextlib
        with contextlib.ExitStack() as stack:
            for c in contexts:
                stack.enter_context(c)
            return lm_grads(torch, tfm, p, cfg, batch)
    params = tfm.init_params(cfg, seed=SEED, device=device)
    p64 = _widened(tfm, params, torch.float64)
    loss_64, g_64 = grads(p64, plain_path(cfg, kname), fp64_path(torch))
    del p64
    p32 = _fp32_copy(tfm, params)
    loss_p, g_p = grads(p32, plain_path(cfg, kname))
    floor, floor_leaf = grad_distance(g_p, g_64)
    loss_k, g_k = grads(p32)
    kernel_64, kernel_64_leaf = grad_distance(g_k, g_64)
    del g_64
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    worst, worst_leaf = grad_distance(g_k, g_p)
    tol = max(GRAD_REL, 2 * floor)
    log(f"  {cfg.name} fp32, 1 x {GRAD_SEQ}: loss {loss_k:.6f} (plain "
        f"{loss_p:.6f}, rel {loss_rel:.2e}, tol {GRAD_LOSS_REL:g}; fp64 "
        f"{loss_64:.6f}); gradients, each leaf against its own largest "
        f"element: kernel path from plain {worst:.2e} ({worst_leaf}); from "
        f"the fp64 plain path, the plain fp32 path (the floor) {floor:.2e} "
        f"({floor_leaf}) and the kernel path {kernel_64:.2e} "
        f"({kernel_64_leaf}); tol, for both, max({GRAD_REL:g}, twice the "
        f"floor) = {tol:.2e}")
    if not loss_rel <= GRAD_LOSS_REL:
        fail(f"{cfg.name}: the fp32 kernel path's loss is {loss_rel:.2e} "
             f"from the plain path's")
    if not worst <= tol:
        fail(f"{cfg.name}: gradient {worst_leaf} through the kernel lies "
             f"{worst:.2e} of its scale from the plain path's")
    if not kernel_64 <= tol:
        fail(f"{cfg.name}: gradient {kernel_64_leaf} through the kernel "
             f"lies {kernel_64:.2e} of its scale from the fp64 path's")
    check_nonzero(cfg, g_k, kname)
    del g_k
    loss_pb, g_pb = grads(params, plain_path(cfg, kname))
    bf16_floor, floor_leaf = grad_distance(g_pb, g_p)
    del g_pb
    loss_kb, g_kb = grads(params)
    dist, leaf = grad_distance(g_kb, g_p)
    check_nonzero(cfg, g_kb, kname)
    del g_kb, g_p
    with torch.no_grad(), broken_path(cfg, kname):
        loss_broken = float(tfm.loss_fn(params, cfg, batch)[0])
    gated = kname in BF16_GRAD_GATED
    log(f"  {cfg.name} bf16: gradients' largest distance from the fp32 "
        f"plain path, each leaf against its own scale: kernel path "
        f"{dist:.3e} ({leaf}), plain path (the floor) {bf16_floor:.3e} "
        f"({floor_leaf}); " + ("limit twice the floor" if gated else
                               "not gated: twice the floor passes a zero "
                               "gradient (the op-level gate holds it)"))
    if gated:
        if not 2 * bf16_floor < 1:
            fail(f"{cfg.name}: twice the bf16 floor, {2 * bf16_floor:.3e}, "
                 f"would pass a zero gradient")
        if not dist <= 2 * bf16_floor:
            fail(f"{cfg.name}: bf16 gradients through the kernel lie "
                 f"{dist:.3e} from fp32, over twice the plain path's "
                 f"{bf16_floor:.3e}")
    rel = lambda v: abs(v - loss_p) / abs(loss_p)
    limit = BF16_LOSS_REL[kname]
    log(f"  {cfg.name} bf16 loss from the fp32 plain loss, relative: kernel "
        f"path {rel(loss_kb):.3e} ({loss_kb:.6f}), plain path "
        f"{rel(loss_pb):.3e} ({loss_pb:.6f}), broken kernel "
        f"{rel(loss_broken):.3e} ({loss_broken:.6f}); limit {limit:.3e}")
    if not rel(loss_kb) <= limit:
        fail(f"{cfg.name}: the bf16 loss through the kernel lies "
             f"{rel(loss_kb):.3e} from fp32, over {limit:.3e}")
    if not rel(loss_broken) > limit:
        fail(f"{cfg.name}: a broken kernel's bf16 loss lies within the "
             f"limit ({rel(loss_broken):.3e}): the gate cannot catch it")
    del params, p32
    torch.cuda.empty_cache()


def op_inputs(torch, cfg, device, kname) -> list:
    """Every call's inputs to the kernel op in a bf16 forward of ``cfg``
    on (b)'s first batch, as (args, kwargs) in the kernel's layout."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd as sk
    from repro_torch.models import transformer as tfm
    from repro_torch.train.data import SyntheticTokens
    from repro_torch.train.trainer import to_device
    mod = fa if kname == "flash_attention" else sk
    orig, calls = getattr(mod, kname), []

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return orig(*args, **kwargs)
    params = tfm.init_params(cfg, seed=SEED, device=device)
    batch = to_device(SyntheticTokens(cfg, TRAIN_BATCH, TRAIN_SEQ)
                      .batch_at(0), device)
    with torch.no_grad(), _swapped(mod, kname, record):
        tfm.loss_fn(params, cfg, batch)
    return calls


def op_gate(torch, cfg, device, kname) -> None:
    """Phase 18 (a) at the op, for one model: the bf16 op on every layer's
    inputs at (b)'s shapes, its y row by row against the plain function
    and its gradient against autograd through the function its backward
    differentiates; and, for scale, a broken kernel's y."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd as sk
    from repro_torch.models import attention as attn
    from repro_torch.models import ssm as ssm_mod
    g = torch.Generator(device=device).manual_seed(SEED + 18)
    y_worst = grad_worst = (0.0, "")
    broken_worst = float("inf")
    calls = op_inputs(torch, cfg, device, kname)
    if kname == "flash_attention":
        # and the first layer's last half of queries at their offset, as a
        # query-split prefill calls the op
        (q, k, v), kw = calls[0][0][:3], calls[0][1]
        half = q.shape[2] // 2
        calls.append(((q[:, :, half:], k, v), dict(kw, q_offset=half)))
    for layer, (args, kwargs) in enumerate(calls):
        where = (f"layer {layer}" if not kwargs.get("q_offset") else
                 f"layer 0 at q_offset {kwargs['q_offset']}")
        if kname == "flash_attention":
            q, k, v = (t.detach().requires_grad_(True) for t in args[:3])
            leaves, causal = [q, k, v], kwargs.get("causal", True)
            window = kwargs.get("window", 0)
            q_offset = kwargs.get("q_offset", 0)
            y = fa.flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
            with torch.no_grad():
                want = fa.flash_attention_plain(q, k, v, causal, window,
                                                q_offset)
                err, tol, _ = _flash_err(torch, y, want, FLASH_BF16_REL)
                b_err, b_tol, _ = _flash_err(torch, fa.flash_attention_plain(
                    q, k, v, False, window, q_offset), want,
                    FLASH_BF16_REL)
                del want

            def plain():
                o = attn.chunked_attention(
                    *(t.transpose(1, 2) for t in leaves), causal=causal,
                    window=window, chunk_q=fa.VJP_CHUNKS[0],
                    chunk_kv=fa.VJP_CHUNKS[1], q_offset=q_offset)
                return o.transpose(1, 2)
        else:
            x, dt, a, bm, cm = args[:5]
            chunk, vjp_chunk = kwargs["chunk"], kwargs["vjp_chunk"]
            b, h = x.shape[:2]
            # B and C as the model hands them over: the group's (B, L, 1,
            # N) tensor, broadcast over the heads
            x, dt, a = (t.detach().requires_grad_(True) for t in (x, dt, a))
            bases = [t[:, :1].detach().clone().requires_grad_(True)
                     for t in (bm, cm)]
            leaves = [x, dt, a] + bases
            bc = [t.expand(b, h, *t.shape[2:]) for t in bases]
            y, _ = sk.ssd(x, dt, a, *bc, chunk=chunk, vjp_chunk=vjp_chunk)

            def plain():
                return ssm_mod.ssd_chunked(
                    x.transpose(1, 2), dt.transpose(1, 2), a,
                    *(t.transpose(1, 2) for t in bc),
                    chunk=vjp_chunk).transpose(1, 2)
            with torch.no_grad():
                want = plain()
                floor = OP_ROW_FLOOR * float(want.abs().max())
                err, tol, _ = _row_err(torch, y, want, OP_SSD_ROW_REL, floor)
                b_err, b_tol, _ = _row_err(
                    torch, dropped_carry(x, dt, a, *bc, chunk)[0],
                    want, OP_SSD_ROW_REL, floor)
        cot = torch.randn(y.shape, generator=g, device=device).to(y.dtype)
        got = torch.autograd.grad(y, leaves, cot)
        want_g = torch.autograd.grad(plain(), leaves, cot)
        for name, gk, gp in zip(("q", "k", "v") if len(leaves) == 3 else
                                ("x", "dt", "a", "b", "c"), got, want_g):
            d = float((gk.float() - gp.float()).abs().max()) / max(
                float(gp.float().abs().max()), 1e-30)
            grad_worst = max(grad_worst, (d, f"{where} d{name}"))
        y_worst = max(y_worst, (err / tol, where))
        broken_worst = min(broken_worst, b_err / b_tol)
        del y, got, want_g, leaves
    del calls
    torch.cuda.empty_cache()
    offset = " and layer 0's last half of queries at their offset" \
        if kname == "flash_attention" else ""
    log(f"  {cfg.name} at the op, bf16, {kname} on each of the "
        f"{layer + 1} inputs (the layers' at {TRAIN_BATCH} x {TRAIN_SEQ}"
        f"{offset}): y "
        f"against plain, worst row {y_worst[0]:.3f} of its tolerance "
        f"({y_worst[1]}); a broken kernel's y in the layer it fits best "
        f"{broken_worst:.1f} of it; gradient against the VJP of the "
        f"function it differentiates, worst input {grad_worst[0]:.3e} of "
        f"its scale ({grad_worst[1]}; tol {OP_GRAD_REL:.3e})")
    if not y_worst[0] <= 1:
        fail(f"{cfg.name}: the bf16 {kname} op's y disagrees with its plain "
             f"function at the training shapes ({y_worst[1]})")
    if not broken_worst > 1:
        fail(f"{cfg.name}: a broken {kname} kernel's y passes the op gate")
    if not grad_worst[0] <= OP_GRAD_REL:
        fail(f"{cfg.name}: the bf16 {kname} op's gradient disagrees with "
             f"the VJP it stands for ({grad_worst[1]})")


def check_nonzero(cfg, grads, kname) -> None:
    """Every layer's parameters that reach the loss only through the
    kernel op have a non-zero gradient (in_proj on its x, B, C and dt
    columns, past the gate's)."""
    for name, g in grads.items():
        leaf = name.split(".")[-1]
        if leaf not in THROUGH_KERNEL[kname]:
            continue
        if leaf == "in_proj":
            g = g[:, cfg.d_inner:]
        if not float(g.abs().max()) > 0:
            fail(f"{cfg.name}: {name} gets no gradient through {kname}")


def profile_rows(torch, fn) -> tuple:
    """(wall ms, device rows as ``device_rows`` gives them) of ``fn``
    once under ``torch.profiler``, recording the device's activity alone
    and reading its records straight from the profiler's trace: a
    training step launches tens of thousands of kernels, and building
    the profiler's per-op tables for 5 steps took 22-47 s."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    sums = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA or \
                e.is_user_annotation():
            continue
        row = sums[e.name()]
        row[0] += e.duration_ns() / 1e6
        row[1] += 1
    return wall_ms, [(ms, key, n) for key, (ms, n) in sums.items()
                     if ms > 0]


#: the CUDA kernels of each LM kernel, by function name
KERNEL_FUNCTIONS = {
    "flash_attention": ("flash_bf16_kernel", "flash_fp32_kernel"),
    "ssd": ("ssd_chunk_state_kernel", "ssd_state_pass_kernel",
            "ssd_output_kernel")}


def kernel_rows_ms(rows, kname) -> float:
    """Device ms of the profiler rows that are ``kname``'s CUDA kernels."""
    return sum(ms for ms, key, _ in rows
               if any(f in key for f in KERNEL_FUNCTIONS[kname]))


def vjp_device_ms(torch, cfg, device, kname) -> tuple:
    """(forward kernel ms, backward VJP ms) a call of the op and its
    gradient at (b)'s shapes and layouts (bf16), device time under the
    profiler over VJP_CALLS calls: the VJP is every device op but the
    kernel's."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd as sk
    g = torch.Generator(device=device).manual_seed(SEED)
    bf = torch.bfloat16
    rnd = lambda *shape, dtype=bf: torch.randn(
        shape, generator=g, device=device).to(dtype).requires_grad_(True)
    b, s = TRAIN_BATCH, TRAIN_SEQ
    if kname == "flash_attention":
        hd = cfg.resolved_head_dim
        q = rnd(b, s, cfg.n_heads, hd)
        k, v = rnd(b, s, cfg.n_kv_heads, hd), rnd(b, s, cfg.n_kv_heads, hd)
        leaves = [q, k, v]

        def call():
            o = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2))
            torch.autograd.grad(o, leaves, torch.ones_like(o))
    else:
        h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        x = rnd(b, s, h, p)
        dt = (torch.rand((b, s, h), generator=g, device=device) * 0.1
              ).requires_grad_(True)
        a = (-torch.rand((h,), generator=g, device=device) - 0.5
             ).requires_grad_(True)
        bm, cm = rnd(b, s, 1, n), rnd(b, s, 1, n)
        leaves = [x, dt, a, bm, cm]

        def call():
            y, _ = sk.ssd(x.transpose(1, 2), dt.transpose(1, 2), a,
                          bm.expand(b, s, h, n).transpose(1, 2),
                          cm.expand(b, s, h, n).transpose(1, 2),
                          chunk=min(cfg.ssm_chunk, sk.MAX_CHUNK),
                          vjp_chunk=cfg.ssm_chunk)
            torch.autograd.grad(y, leaves, torch.ones_like(y))
    def calls():
        # the profiler can miss the first kernels after it starts: a spin
        # kernel goes first, and is not counted
        torch.cuda._sleep(SPIN_CYCLES)
        for _ in range(VJP_CALLS):
            call()
    call()
    _, rows = profile_rows(torch, calls)
    rows = [r for r in rows if "spin_kernel" not in r[1]]
    fwd = kernel_rows_ms(rows, kname)
    return fwd / VJP_CALLS, (sum(ms for ms, _, _ in rows) - fwd) / VJP_CALLS


def train_lm(torch, cfg, device, kname, kmod, tmp) -> dict:
    """Phase 18 (b) for one model: TRAIN_STEPS steps uninterrupted, then
    a run crashed at step TRAIN_CRASH and a fresh trainer resumed from its
    step-TRAIN_EVERY checkpoint; launches counted exactly in each run; the
    resumed losses bitwise the uninterrupted run's."""
    from repro_torch.train.trainer import Trainer, TrainerConfig, to_device
    per_step = 2 * cfg.n_layers     # forward + remat's recompute

    def trainer(name, injector=None):
        return Trainer(cfg, TRAIN_BATCH, TRAIN_SEQ, TrainerConfig(
            checkpoint_dir=str(Path(tmp) / name), checkpoint_every=TRAIN_EVERY,
            async_checkpoint=True, log_every=5, max_steps=TRAIN_STEPS),
            seed=SEED, failure_injector=injector, device=device)

    def counted(run_name, t, steps, **kw):
        kmod.reset_launches()
        t.run(TRAIN_STEPS, log=lambda m: log(f"    {run_name}: {m}"), **kw)
        got = kmod.LAUNCHES[kname]
        if got != steps * per_step:
            fail(f"{cfg.name} {run_name}: {kname} launched {got} times, "
                 f"not {steps} steps x {per_step}")
        return got

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    a = trainer("a")
    launches = counted("uninterrupted", a, TRAIN_STEPS)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps_ms = np.asarray(a.step_times[2:]) * 1e3
    step_ms = float(np.median(steps_ms))
    ckpt = Path(tmp) / "a" / f"step_{TRAIN_STEPS}"
    ckpt_bytes = sum(f.stat().st_size for f in ckpt.iterdir())
    losses = [a.losses[s] for s in range(TRAIN_STEPS)]
    if not all(np.isfinite(losses)):
        fail(f"{cfg.name}: a loss is not finite: {losses}")
    log(f"  {cfg.name}: {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"in {seconds:.1f} s; {step_ms:.2f} ms a step (median of steps 3-"
        f"{TRAIN_STEPS}; min {steps_ms.min():.2f}, max "
        f"{steps_ms.max():.2f}), {TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3:.0f}"
        f" tokens/s; peak {peak:.2f} GiB; losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; {kname} launches {launches} ({per_step} a step)")
    log(f"  checkpoints: {ckpt_bytes:,} bytes each, the loop waited "
        f"{a.checkpoint_wait_s:.2f} s on {TRAIN_STEPS // TRAIN_EVERY + 1} "
        f"saves (device-to-host copies and joins)")

    # the device's busy share over TRAIN_PROFILE_STEPS more steps, and
    # where it goes
    def more():
        for s in range(TRAIN_STEPS, TRAIN_STEPS + TRAIN_PROFILE_STEPS):
            a.state, m = a.train_step(
                a.state, to_device(a.data.batch_at(s), device))
        float(m["loss"])
    t0 = time.perf_counter()
    wall, rows = profile_rows(torch, more)
    busy = sum(ms for ms, _, _ in rows)
    fwd = kernel_rows_ms(rows, kname)
    log(f"  {TRAIN_PROFILE_STEPS} steps under the profiler: wall "
        f"{wall:.1f} ms, device busy {busy:.1f} ms ({busy / wall:.1%}); "
        f"{kname} forward kernels {fwd:.2f} ms; profiled and parsed in "
        f"{time.perf_counter() - t0:.1f} s")
    for ms, key, count in sorted(rows, reverse=True)[:6]:
        log(f"    {ms:9.3f} ms  x{count:<5d} {key[:90]}")
    del a
    torch.cuda.empty_cache()

    class Crash(Exception):
        pass

    def injector(step):
        if step == TRAIN_CRASH:
            raise Crash()
    t0 = time.perf_counter()
    b = trainer("b", injector)
    kmod.reset_launches()
    try:
        b.run(TRAIN_STEPS, log=lambda m: None)
        fail(f"{cfg.name}: the failure injector did not crash the run")
    except Crash:
        pass
    if kmod.LAUNCHES[kname] != TRAIN_CRASH * per_step:
        fail(f"{cfg.name} crashed run: {kmod.LAUNCHES[kname]} launches, not "
             f"{TRAIN_CRASH} steps x {per_step}")
    b.wait_for_checkpoint()    # the crashed job's last snapshot lands
    del b
    torch.cuda.empty_cache()
    c = trainer("b")
    launches += counted("resumed", c, TRAIN_STEPS - TRAIN_EVERY)
    launches += TRAIN_CRASH * per_step
    resumed = sorted(c.losses)
    if resumed != list(range(TRAIN_EVERY, TRAIN_STEPS)):
        fail(f"{cfg.name}: the resumed run ran steps {resumed}")
    differ = [s for s in resumed if c.losses[s] != losses[s]]
    log(f"  crash at step {TRAIN_CRASH}, a fresh Trainer restored step "
        f"{TRAIN_EVERY} and ran to {TRAIN_STEPS}: losses of steps "
        f"{TRAIN_EVERY + 1}-{TRAIN_STEPS} bitwise the uninterrupted run's: "
        f"{not differ} (both runs in {time.perf_counter() - t0:.1f} s)")
    if differ:
        fail(f"{cfg.name}: resumed losses differ at steps {differ}: "
             f"{[(c.losses[s], losses[s]) for s in differ]}")
    del c
    torch.cuda.empty_cache()
    fwd_ms, vjp_ms = vjp_device_ms(torch, cfg, device, kname)
    log(f"  one {kname} call and its gradient at these shapes, device "
        f"time: forward kernel {fwd_ms:.3f} ms, backward VJP (PyTorch) "
        f"{vjp_ms:.3f} ms; a step's {per_step // 2} VJPs, at that, "
        f"{vjp_ms * per_step / 2:.1f} ms of device time")
    return {"launches": launches, "step_ms": step_ms, "peak_gib": peak,
            "busy": busy / wall, "fwd_ms": fwd_ms, "vjp_ms": vjp_ms}


def cli_train(torch, tmp) -> tuple:
    """Phase 18 (c): ``launch.train --predict-on`` as a process on the
    card; returns (the tracked trace, its config)."""
    import os
    from repro_torch.configs import get_config
    from repro_torch.core.trace import TrackedTrace
    cfg = get_config("qwen3-0.6b")
    trace_path = Path(tmp) / "trace.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           cfg.name, "--steps", str(CLI_STEPS), "--batch", str(TRAIN_BATCH),
           "--seq", str(TRAIN_SEQ), "--predict-on", ",".join(SERVE_GPUS),
           "--checkpoint-dir", str(Path(tmp) / "cli"), "--trace-out",
           str(trace_path)]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=str(ROOT), timeout=900)
    seconds = time.perf_counter() - t0
    log(f"  {' '.join(cmd[1:6])} ... exit {proc.returncode} in "
        f"{seconds:.1f} s:")
    for line in proc.stdout.splitlines():
        log(f"    {line}")
    if proc.returncode != 0:
        log(proc.stderr[-4000:])
        fail(f"launch.train --predict-on exited {proc.returncode}")
    lines = proc.stdout.splitlines()
    head = next(i for i, ln in enumerate(lines) if ln.startswith("device"))
    ranked = [ln.split()[0] for ln in lines[head + 1:head + 1 +
                                           len(SERVE_GPUS)]]
    if sorted(ranked) != sorted(SERVE_GPUS):
        fail(f"launch.train ranked {ranked}, not {SERVE_GPUS}")
    counts = json.loads(next(ln for ln in lines if ln.startswith(
        "kernel launches:")).split(":", 1)[1])
    if counts.get("fused_mlp_score", 0) < 1:
        fail(f"launch.train ranked without the block scorer kernel: "
             f"{counts}")
    trace = TrackedTrace.from_json(trace_path.read_text())
    flash = [op for op in trace.ops
             if op.name == "repro_torch::flash_attention"]
    want = 2 * cfg.n_layers
    if len(flash) != want:
        fail(f"the tracked step holds {len(flash)} flash ops, not "
             f"{cfg.n_layers} layers x 2 (forward, remat)")
    if not all(op.measured_ms is not None and np.isfinite(op.measured_ms)
               and op.measured_ms > 0 for op in flash):
        fail("a tracked flash op has no finite positive measured_ms")
    kinds = collections.Counter(op.kind for op in trace.ops)
    log(f"  tracked step: {len(trace.ops)} ops "
        f"({', '.join(f'{k} {n}' for k, n in kinds.most_common(6))}), "
        f"{trace.run_time_ms:.1f} ms summed; flash ops {len(flash)}, "
        f"{sum(op.measured_ms for op in flash):.2f} ms; kernel launches "
        f"{counts}")
    return trace, cfg


def predict_distributed(torch, trace, cfg, mlps) -> None:
    """Phase 18 (d): ``distributed.predict_step`` of (c)'s trace under pure
    data parallelism over the registry's GPUs, on the card against the
    same MLPs on the CPU with the plain scorer (rtol 1e-4)."""
    from repro_torch.core import distributed
    from repro_torch.core.predictor import HabitatPredictor, \
        default_predictor
    grad_bytes = float(cfg.n_params()) * 2      # bf16 gradients
    plan = distributed.MeshPlan(data=DP_DEGREE, grad_bytes=grad_bytes)
    card = default_predictor(device="cuda")
    cpu = HabitatPredictor(mlps, device="cpu")
    worst = 0.0
    for dest in SERVE_GPUS:
        got = distributed.predict_step(trace, dest, plan, predictor=card)
        want = distributed.predict_step(trace, dest, plan, predictor=cpu)
        for field in ("compute_ms", "collective_ms", "step_ms"):
            a, b = getattr(got, field), getattr(want, field)
            worst = max(worst, abs(a / b - 1.0) if b else abs(a))
        log(f"    {dest}: step {got.step_ms:.1f} ms (compute "
            f"{got.compute_ms:.1f}, all-reduce {got.collective_ms:.1f}, "
            f"exposed {got.exposed_collective_ms:.1f})")
    log(f"  predict_step, data={DP_DEGREE}, grad_bytes {grad_bytes:.3e}: "
        f"max rel err {worst:.3e} against the CPU (tol 1e-4)")
    if worst > 1e-4:
        fail(f"distributed.predict_step on the card disagrees with the "
             f"CPU: {worst:.3e}")


def train_lms(torch, device, kernel_mods, mlps) -> dict:
    """Phase 18: (a) the gradient gates, (b) training with a crash and a
    resume, (c) the CLI, (d) the distributed prediction.  Returns each
    LM kernel's training launches and figures."""
    import tempfile
    from repro_torch.configs import get_config
    mods = {"flash_attention": kernel_mods[1], "ssd": kernel_mods[2]}
    out = {}
    for arch, kname in TRAIN_ARCHS.items():
        cfg = get_config(arch)
        log(f"  (a) {arch}: one loss_fn gradient through {kname} against "
            f"the plain path, and the op on the training step's inputs")
        gradient_gate(torch, cfg, device, kname)
        op_gate(torch, cfg, device, kname)
    with tempfile.TemporaryDirectory() as tmp:
        for arch, kname in TRAIN_ARCHS.items():
            cfg = get_config(arch)
            log(f"  (b) {arch}: Trainer(batch={TRAIN_BATCH}, seq="
                f"{TRAIN_SEQ}), {cfg.param_dtype}, remat {cfg.remat}, "
                f"AdamW, clip 1.0, checkpoint every {TRAIN_EVERY}")
            out[kname] = train_lm(torch, cfg, device, kname, mods[kname],
                                  str(Path(tmp) / arch))
        log("  (c) python -m repro_torch.launch.train --predict-on the "
            "registry's GPUs")
        trace, cfg = cli_train(torch, tmp)
        out["tracked_flops"] = float(sum(op.cost.flops for op in trace.ops))
        log("  (d) distributed.predict_step on the tracked step")
        predict_distributed(torch, trace, cfg, mlps)
    return out


#: phase 19: the LMs of phase 18 trained on a (data 1, model 1) mesh of
#: the card, a 1-rank NCCL group: steps of TRAIN_BATCH x TRAIN_SEQ, the
#: first a warm-up; then a prefill of SHARDED_PREFILL tokens and
#: SHARDED_TICKS decode ticks on the mesh
SHARDED_STEPS = 3
SHARDED_PREFILL = 2048
SHARDED_TICKS = 4


def _full(torch, t):
    """A DTensor's whole value; a plain tensor as it is."""
    from repro_torch.parallel.ctx import is_dtensor
    return t.full_tensor() if is_dtensor(t) else t


def _bitwise(torch, a, b) -> bool:
    a, b = _full(torch, a), _full(torch, b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        bool(torch.equal(a, b))


def _step_ms(times) -> float:
    """The median of the steps after the first (the warm-up), in ms."""
    return float(np.median(np.asarray(times[1:]) * 1e3))


def parting_ops(torch, fn_plain, fn_sharded, limit: int = 3) -> list:
    """The first ops whose outputs differ between a plain forward and the
    same forward on the mesh: each run under a dispatch mode that records
    every op's name and a bitwise digest of its output (its fp64 sum and
    largest |x|); the two op streams are walked in step, the mesh's extra
    ops (views and copies DTensor adds) skipped by name."""
    from torch.utils._python_dispatch import TorchDispatchMode

    def digest(out):
        out = _full(torch, out) if isinstance(out, torch.Tensor) else out
        if not isinstance(out, torch.Tensor) or not out.is_floating_point():
            return None
        x = out.detach().to(torch.float64)
        return (float(x.sum()), float(x.abs().max())) if x.numel() else None

    def record(fn):
        rows = []

        class Rec(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                first = out[0] if isinstance(out, (tuple, list)) and out \
                    else out
                rows.append((str(func), digest(first)))
                return out
        with Rec(), torch.no_grad():
            fn()
        return rows
    plain, sharded = record(fn_plain), record(fn_sharded)
    found, j = [], 0
    for i, (name, d) in enumerate(plain):
        while j < len(sharded) and sharded[j][0] != name:
            j += 1
        if j == len(sharded):
            found.append((i, name, "not run on the mesh"))
            break
        if d != sharded[j][1]:
            found.append((i, name, f"plain {d}, mesh {sharded[j][1]}"))
            if len(found) == limit:
                break
        j += 1
    return found


def sharded_train(torch, cfg, device, kname, kmod, mesh) -> dict:
    """Phase 19 (a) for one model: SHARDED_STEPS steps on plain tensors,
    then the same steps from the same seed with the state distributed by
    ``param_specs`` (``2d``) and the batch by ``batch_specs`` on ``mesh``;
    every loss and updated parameter bitwise, launches exact."""
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel import ctx, sharding
    from repro_torch.train.data import SyntheticTokens
    from repro_torch.train.optim import adamw
    from repro_torch.train.train_step import init_state, make_train_step
    from repro_torch.train.trainer import to_device
    opt = adamw()
    step = make_train_step(cfg, opt)
    data = SyntheticTokens(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED)
    batches = [to_device(data.batch_at(i), device)
               for i in range(SHARDED_STEPS)]

    def run(state, place):
        losses, times = [], []
        for b in batches:
            t0 = time.perf_counter()
            state, m = step(state, place(b))
            losses.append(_full(torch, m["loss"]).float().item())
            times.append(time.perf_counter() - t0)
        return state, losses, times

    torch.cuda.empty_cache()
    s, plain_losses, plain_times = run(init_state(cfg, SEED, opt, device),
                                       lambda b: b)
    plain = {n: t.detach() for n, t in s.params.named_parameters()}
    del s
    torch.cuda.empty_cache()
    with ctx.use_mesh(mesh):
        s0 = init_state(cfg, SEED, opt, device)
        specs = sharding.param_specs(s0, mesh, "2d", cfg=cfg)
        s = sharding.distribute(s0, sharding.tree_shardings(specs, mesh))
        del s0
        bsh = sharding.tree_shardings(sharding.batch_specs(batches[0], mesh),
                                      mesh)
        kmod.reset_launches()
        s, losses, times = run(s, lambda b: sharding.distribute(b, bsh))
        launches = kmod.LAUNCHES[kname]
    per_step = 2 * cfg.n_layers
    if launches != SHARDED_STEPS * per_step:
        fail(f"{cfg.name} on the mesh: {kname} launched {launches} times, "
             f"not {SHARDED_STEPS} steps x {per_step}")
    placements = collections.Counter(
        str(tuple(p.placements)) for p in s.params.parameters())
    differ = [n for n, p in s.params.named_parameters()
              if not _bitwise(torch, p, plain[n])]
    same_losses = losses == plain_losses
    log(f"  {cfg.name}: {SHARDED_STEPS} steps on the mesh, {kname} "
        f"launches {launches} ({per_step} a step, counted by the kernel's "
        f"own counter); losses {losses} against plain {plain_losses}: "
        f"bitwise {same_losses}; parameters bitwise: "
        f"{len(plain) - len(differ)} of {len(plain)}; placements "
        f"{dict(placements)}")
    sharded_ms, plain_ms = _step_ms(times), _step_ms(plain_times)
    with ctx.use_mesh(mesh):
        wall, rows = profile_rows(torch, lambda: _full(torch, step(
            s, sharding.distribute(batches[0], bsh))[1]["loss"]).item())
    busy = sum(ms for ms, _, _ in rows)
    log(f"  {cfg.name}: {sharded_ms:.2f} ms a step on the mesh, "
        f"{plain_ms:.2f} ms on plain tensors (median after the warm-up; "
        f"steps {[round(t * 1e3, 2) for t in times]} and "
        f"{[round(t * 1e3, 2) for t in plain_times]} ms); one more step "
        f"on the mesh under the profiler: wall {wall:.1f} ms, device busy "
        f"{busy:.1f} ms ({busy / wall:.1%})")
    if differ or not same_losses:
        p0 = tfm.init_params(cfg, SEED, device)
        with ctx.use_mesh(mesh):
            ps = sharding.distribute(p0, sharding.tree_shardings(
                sharding.param_specs(p0, mesh, "2d", cfg=cfg), mesh))
            bs = sharding.distribute(batches[0], bsh)
            parts = parting_ops(torch, lambda: tfm.loss_fn(p0, cfg,
                                                           batches[0]),
                                lambda: tfm.loss_fn(ps, cfg, bs))
        rel = max(abs(a / b - 1.0) for a, b in zip(losses, plain_losses))
        log(f"  {cfg.name}: the first ops that part in the forward: "
            f"{parts or 'none (the forward agrees; the gradient or update '
                        'parts)'}; loss gap {rel:.3e} of the plain loss, "
            f"differing parameters {differ[:6]}")
        if not rel <= BF16_LOSS_REL[kname]:
            fail(f"{cfg.name} on the mesh: loss gap {rel:.3e} beyond phase "
                 f"18 (a)'s bf16 limit {BF16_LOSS_REL[kname]:g}")
    return {"state": s, "launches": launches, "ms": sharded_ms,
            "plain_ms": plain_ms, "busy": busy / wall,
            "bitwise": same_losses and not differ}


def sharded_restore(torch, state, cfg, device, tmp) -> None:
    """Phase 19 (b): ``checkpoint.save`` of the sharded state, then
    ``restore(..., shardings=...)`` onto a freshly built mesh: every leaf
    bitwise."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sharding
    from repro_torch.parallel.ctx import is_dtensor
    from repro_torch.train import checkpoint
    from repro_torch.train.train_step import TrainState
    t0 = time.perf_counter()
    checkpoint.save(tmp, state.step, state)
    saved_s = time.perf_counter() - t0
    fresh = make_mesh((1, 1), ("data", "model"), device)
    like = TrainState(params=state.params.map(lambda _, t: _full(torch, t)),
                      opt=state.opt, step=state.step)
    sh = sharding.tree_shardings(
        sharding.param_specs(like, fresh, "2d", cfg=cfg), fresh)
    t0 = time.perf_counter()
    restored, step = checkpoint.restore(tmp, like, shardings=sh)
    restore_s = time.perf_counter() - t0
    want = checkpoint.flatten(state)[0]
    got = checkpoint.flatten(restored)[0]
    differ = [k for k in want if not np.array_equal(want[k], got[k])]
    on_fresh = all(is_dtensor(p) and p.device_mesh == fresh
                   for p in restored.params.parameters())
    log(f"  (b) {cfg.name}: saved the sharded state (step {state.step}) in "
        f"{saved_s:.1f} s, restored onto a freshly built mesh in "
        f"{restore_s:.1f} s: step {step}, {len(want) - len(differ)} of "
        f"{len(want)} leaves bitwise, on the fresh mesh: {on_fresh}")
    if step != state.step or differ or not on_fresh:
        fail(f"sharded restore: step {step}, differing leaves {differ[:6]}, "
             f"on the fresh mesh {on_fresh}")


def sharded_serve(torch, cfg, device, fa, mesh) -> int:
    """Phase 19 (c): one prefill of SHARDED_PREFILL tokens and
    SHARDED_TICKS decode ticks of ``cfg`` with the parameters on the mesh
    and the cache placed by ``cache_specs``, against the same on plain
    tensors (the same tokens fed to both): every logit bitwise; returns
    the flash launches of the mesh's run."""
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel import ctx, sharding
    gen = np.random.default_rng(SEED)
    tokens = torch.as_tensor(gen.integers(0, cfg.vocab_size,
                                          (1, SHARDED_PREFILL)),
                             dtype=torch.int32, device=device)
    ticks = torch.as_tensor(gen.integers(0, cfg.vocab_size,
                                         (SHARDED_TICKS, 1, 1)),
                            dtype=torch.int32, device=device)
    max_seq = SHARDED_PREFILL + SHARDED_TICKS
    params = tfm.init_params(cfg, SEED, device)

    def serve(p, place):
        out = []
        logits, st = tfm.prefill(p, cfg, place(tokens), max_seq)
        out.append(logits)
        for i in range(SHARDED_TICKS):
            logits, st = tfm.decode_step(p, cfg, place(ticks[i]), st)
            out.append(logits)
        return out, st
    with torch.no_grad():
        plain, _ = serve(params, lambda t: t)
        with ctx.use_mesh(mesh):
            ps = sharding.distribute(params, sharding.tree_shardings(
                sharding.param_specs(params, mesh, "2d", cfg=cfg), mesh))

            def place(t):
                return sharding.distribute({"t": t}, sharding.tree_shardings(
                    sharding.batch_specs({"t": t}, mesh), mesh))["t"]
            fa.reset_launches()
            got, st = serve(ps, place)
            launches = fa.LAUNCHES["flash_attention"]
    same = [_bitwise(torch, a, b) for a, b in zip(got, plain)]
    log(f"  (c) {cfg.name}: a {SHARDED_PREFILL}-token prefill and "
        f"{SHARDED_TICKS} ticks on the mesh, the cache on "
        f"{tuple(st['k'].placements)}: logits bitwise the plain path's: "
        f"{same}; flash launches {launches}")
    if not all(same):
        fail(f"{cfg.name} on the mesh: prefill/decode logits differ from "
             f"the plain path's: {same}")
    if launches != cfg.n_layers:
        fail(f"{cfg.name} on the mesh: flash launched {launches} times in "
             f"a prefill, not {cfg.n_layers}")
    return launches


def train_sharded(torch, device, kernel_mods, trained) -> dict:
    """Phase 19: (a) the LMs' training steps on a (data 1, model 1) mesh
    against plain tensors, (b) the sharded checkpoint restored onto a
    fresh mesh, (c) Qwen3's prefill and decode on the mesh.  Returns each
    LM kernel's launches on the mesh."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    mods = {"flash_attention": kernel_mods[1], "ssd": kernel_mods[2]}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=f"file://{tmp}/group", rank=0, world_size=1)
        try:
            mesh = make_mesh((1, 1), ("data", "model"), device)
            log(f"  mesh {mesh}, {dist.get_backend()}, world size "
                f"{dist.get_world_size()}")
            for arch, kname in TRAIN_ARCHS.items():
                cfg = get_config(arch)
                log(f"  (a) {arch}: make_train_step on the mesh (2d), "
                    f"{TRAIN_BATCH} x {TRAIN_SEQ}, {cfg.param_dtype}, "
                    f"remat {cfg.remat}, AdamW, clip 1.0")
                got = sharded_train(torch, cfg, device, kname, mods[kname],
                                    mesh)
                before = trained.get(kname, {}).get("step_ms")
                log(f"  {arch}: DTensor's dispatch, a step: "
                    f"{got['ms'] - got['plain_ms']:+.2f} ms ({got['ms']:.2f} "
                    f"on the mesh, {got['plain_ms']:.2f} plain in this "
                    f"phase; phase 18's unsharded Trainer "
                    f"{'%.2f' % before if before else 'not run'} ms)")
                out[kname] = {"launches": got["launches"]}
                if kname == "flash_attention":
                    sharded_restore(torch, got["state"], cfg, device,
                                    str(Path(tmp) / "ckpt"))
                del got
                torch.cuda.empty_cache()
            cfg = get_config("qwen3-0.6b")
            out["flash_attention"]["launches"] += sharded_serve(
                torch, cfg, device, mods["flash_attention"], mesh)
        finally:
            dist.destroy_process_group()
    return out


#: phase 19 (d): the ``guard`` cases of ``tests/sharding_ranks.py`` on 8
#: gloo CPU ranks of this machine's torch release, within this limit
GUARD_RANKS = 8
GUARD_TIMEOUT_S = 150


def sharding_guard() -> None:
    """Phase 19 (d): the sharded cases whose DTensor programs differ by
    torch release (the data- and sequence-parallel steps, the head-split
    and zig-zag gradients, the dp and sp lookups, the MoE router's
    gradient under ``2d`` and ``dp``, the tied head and zamba2's Mamba2
    layers under ``dp``, decode's per-shard products, the Mamba2 block
    on each ``model`` rank's heads under ``2d``, the ``dp`` attention
    gradients with KV heads that do not divide ``model``) on GUARD_RANKS
    gloo CPU ranks, one process a rank, as
    ``tests/test_torch_sharding.py`` runs them: fails on any case's
    error, any gap over the test file's tolerances, any collective that
    gives a rank other ranks' sequences and any product repeated on a
    mesh dim's ranks (``sharding_ranks.failures``), or past
    GUARD_TIMEOUT_S."""
    import os
    import signal
    import tempfile
    sys.path.insert(0, str(ROOT / "tests"))
    import sharding_ranks
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "sharding_ranks.py"),
             "guard", str(rank), str(GUARD_RANKS), tmp], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True) for rank in range(GUARD_RANKS)]
        logs = []
        try:
            for proc in procs:
                left = GUARD_TIMEOUT_S - (time.perf_counter() - t0)
                logs.append(proc.communicate(timeout=max(left, 1.0))[0])
        except subprocess.TimeoutExpired:
            fail(f"the guard cases took over {GUARD_TIMEOUT_S} s")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
        wall = time.perf_counter() - t0
        found = Path(tmp) / "guard.json"
        if not found.exists():
            log("\n".join(text[-3000:] for text in logs))
            fail("the guard cases wrote no results")
        results = json.loads(found.read_text())
    missing = [c for c in sharding_ranks.GUARD_CASES if c not in results]
    bad = sharding_ranks.failures(results)
    seconds = results.get("seconds", {})
    log(f"  (d) {len(sharding_ranks.GUARD_CASES)} guard cases on "
        f"{GUARD_RANKS} gloo ranks in {wall:.1f} s (limit "
        f"{GUARD_TIMEOUT_S} s): " + ", ".join(
            f"{c} {seconds.get(c, 0.0):.1f} s" for c in results
            if c != "seconds"))
    router = [g for c in (results.get("ep", {}).get("grads", {}),
                          results.get("ep_dp", {}))
              for n, g in c.get("grad_gap", {}).items()
              if n.endswith(".router")]
    log(f"  torch {sharding_ranks.torch.__version__}: the MoE router's "
        f"gradient gaps under 2d and dp {router} (below "
        f"{sharding_ranks.PARAM_TOL:g}); failures: {bad or 'none'}")
    if missing or bad:
        fail(f"the guard cases: missing {missing}, failures {bad[:6]}")


# ---------------------------------------------------------------------------
# phase 20: the dry run on the production meshes
# ---------------------------------------------------------------------------
#: the dry run's cells, each ``python -m repro_torch.launch.dryrun
#: --device cuda`` as a process of its own (one fake process group a
#: process), all at once: (arch, shape, multi-pod)
DRYRUN_CELLS = (("qwen3-0.6b", "train_4k", False),
                ("mamba2-130m", "train_4k", False),
                ("qwen3-0.6b", "prefill_32k", False),
                ("qwen3-0.6b", "decode_32k", False),
                ("mamba2-130m", "long_500k", False),
                ("qwen3-0.6b", "decode_32k", True),
                ("gemma3-1b", "train_4k", False),
                ("gemma3-1b", "prefill_32k", False),
                ("zamba2-2.7b", "train_4k", False),
                ("mamba2-130m", "decode_32k", False),
                ("internvl2-2b", "decode_32k", False),
                ("mamba2-130m", "prefill_32k", False),
                ("zamba2-2.7b", "prefill_32k", False),
                ("internvl2-2b", "prefill_32k", False),
                ("zamba2-2.7b", "long_500k", False))
#: the phase's limit: every process is killed past it
DRYRUN_TIMEOUT_S = 110
#: the 1-rank cell: phase 18 (c)'s step (Qwen3-0.6B, TRAIN_BATCH x
#: TRAIN_SEQ) on a (1, 1) fake mesh, ``SHAPES["train_4k"]`` patched
DRYRUN_ONE_RANK = """
import json
import sys
from pathlib import Path
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.config import ShapeConfig
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
dryrun.make_production_mesh = lambda multi_pod=False, device=None: \\
    make_mesh((1, 1), ("data", "model"), device=device)
dryrun.SHAPES["train_4k"] = ShapeConfig("train_4k", int(sys.argv[1]),
                                        int(sys.argv[2]), "train")
cell = dryrun.run_cell("qwen3-0.6b", "train_4k", device="cuda")
out = Path(sys.argv[3])
out.mkdir(parents=True)
(out / "qwen3-0.6b_train_4k_1rank.json").write_text(json.dumps(cell))
"""
#: the 1-rank cell's FLOPs against phase 18 (c)'s tracked step's
DRYRUN_TRACKER_REL = 0.10
#: Qwen3-0.6B ``prefill_32k``'s useful-FLOPs ratio, at least: its 16
#: query heads split one a ``model`` rank (0.02 while every ``model``
#: rank ran all of them)
DRYRUN_PREFILL_USEFUL = 0.10
#: collective bytes a device of each Qwen3-0.6B ``decode_32k`` cell, below:
#: its cache's sequence split over ``model`` is read from per-shard softmax
#: partials (about 30 GB while every rank gathered the whole cache), and
#: each rank looks tokens up in its own shard of the embedding table (311
#: MB a step while every rank gathered the whole table)
DRYRUN_DECODE_COLLECTIVE_BYTES = 0.25e9
#: the reference's FLOPs a device of gemma3-1b's cells on 256 devices (its
#: HLO count, ``python -m repro.launch.dryrun --arch gemma3-1b --shape
#: ...`` on a CPU host, which the card has no JAX to run), as PERF.md §5
#: records it: the port's count in the card's dry run before the per-shard
#: SwiGLU and the query split (``python -m repro_torch.launch.dryrun
#: --device cuda``: 8.306724e13 for ``train_4k``, 2.930838e13 for
#: ``prefill_32k``) over its ratio to the reference's there (2.51x, 2.23x)
DRYRUN_REFERENCE_FLOPS = {"gemma3-1b_train_4k_1pod": 8.306724e13 / 2.51,
                          "gemma3-1b_prefill_32k_1pod": 2.930838e13 / 2.23,
                          # its HLO count on a CPU host itself (``--arch
                          # mamba2-130m --shape decode_32k``, ``--arch
                          # internvl2-2b ...``)
                          "mamba2-130m_decode_32k_1pod": 2.0843e8,
                          "internvl2-2b_decode_32k_1pod": 2.7997e10,
                          "mamba2-130m_prefill_32k_1pod": 1177762120220.0}
#: the port's FLOPs a device of those cells over the reference's, at most:
#: training runs the SwiGLU on each rank's own tokens (2.51x while DTensor
#: planned its backward on 16 gathered sequences), and a prefill whose 4
#: heads do not divide ``model=16`` splits its query sequence (2.23x while
#: every ``model`` rank ran every head)
DRYRUN_FLOPS_OVER_REFERENCE = {"gemma3-1b_train_4k_1pod": 1.2,
                               "gemma3-1b_prefill_32k_1pod": 1.5,
                               # decode's products per shard: Mamba2's
                               # in_proj (3352 columns) and tied head
                               # (50280) cut unevenly over model=16 (8.13x
                               # while every model rank ran them whole);
                               # 1.5, not 1.0: the reference counts its
                               # scan's cache moves as work, the port its
                               # products (0.88x on a CPU host)
                               "mamba2-130m_decode_32k_1pod": 1.5,
                               # internvl2's untied head (92553 rows) cut
                               # over model=16: 0.234x (6.5630e9); 0.34x
                               # (9.4053e9) while every model rank ran
                               # (8, 2048) x (2048, 92553) whole
                               "internvl2-2b_decode_32k_1pod": 0.3,
                               # the Mamba2 block on each model rank's
                               # heads (24 on model=16: 2 a rank on ranks
                               # 0-11), B and C's columns as partial sums
                               # over model: 2.13x while the SSD op's
                               # DTensor rule ran all 24 heads on every
                               # model rank of a CUDA mesh
                               "mamba2-130m_prefill_32k_1pod": 1.0}
#: the reference's collective bytes a device of the ``dp`` train cells,
#: the Mamba2 and internvl2 decode cells, zamba2's prefill and its
#: ``long_500k`` on 256 devices
#: (``collective_bytes_per_device`` of ``python -m repro.launch.dryrun
#: --arch ARCH --shape SHAPE`` on a CPU host)
DRYRUN_REFERENCE_COLLECTIVE_BYTES = {
    "gemma3-1b_train_4k_1pod": 13205952048.0,
    "zamba2-2.7b_train_4k_1pod": 43750168920.0,
    "mamba2-130m_decode_32k_1pod": 3.4355e7,
    "internvl2-2b_decode_32k_1pod": 3.2791e8,
    "zamba2-2.7b_prefill_32k_1pod": 166005999624.0,
    "zamba2-2.7b_long_500k_1pod": 844548.0}
#: the port's collective bytes a device of those cells over the
#: reference's, at most.  Both sides hold one count, the dry run's: each
#: collective's output bytes a device, as the reference's
#: ``hlo_analysis`` counts them (``repro_torch.launch.hlo_analysis``'s
#: docstring; not ``parallel.ctx.product_cost``'s elements a rank
#: receives, by which the port plans its products).  The tied output
#: projection gathered as FSDP
#: gathers a weight (gemma3 read 3.51x while every rank gathered 16
#: sequences' logits), and zamba2's Mamba2 layers per shard, their
#: weights gathered and their gradients reduce-scattered back (34.1x
#: while DTensor planned them)
DRYRUN_COLLECTIVES_OVER_REFERENCE = {"gemma3-1b_train_4k_1pod": 1.2,
                                     "zamba2-2.7b_train_4k_1pod": 2.0,
                                     # decode moves its few tokens to the
                                     # weights' splits: the heads are
                                     # neither gathered whole (77 MB and
                                     # 379 MB a step before: 2.67x, 1.77x)
                                     # nor run whole on a model rank
                                     "mamba2-130m_decode_32k_1pod": 1.0,
                                     "internvl2-2b_decode_32k_1pod": 1.0,
                                     # zamba2's Mamba2 layers on each model
                                     # rank's heads, in_proj's columns
                                     # taken by one all-to-all: 1.92x
                                     # while in_proj's output was gathered
                                     # for each of z, xBC and dt (and, on
                                     # a CUDA mesh, over the whole batch)
                                     "zamba2-2.7b_prefill_32k_1pod": 1.1,
                                     # one slot: x, split over model by
                                     # the norm's scale, reaches in_proj's
                                     # K split over data as the rank's
                                     # 160 columns from the model rank
                                     # that holds them (ctx.slice_holder):
                                     # 1.08x while all 2560 were gathered
                                     "zamba2-2.7b_long_500k_1pod": 1.0}
#: the reference's peak bytes a device (XLA's ``memory_analysis``: temp +
#: arguments + outputs - aliases, ``python -m repro.launch.dryrun --arch
#: ARCH --shape SHAPE [--multi-pod]`` on a CPU host) of every cell of
#: DRYRUN_CELLS the reference runs, each cell's peak logged over it
DRYRUN_REFERENCE_PEAK_BYTES = {
    "qwen3-0.6b_train_4k_1pod": 8630836728.0,
    "mamba2-130m_train_4k_1pod": 2960950450.0,
    "qwen3-0.6b_prefill_32k_1pod": 1648134920.0,
    "qwen3-0.6b_decode_32k_1pod": 6763275656.0,
    "mamba2-130m_long_500k_1pod": 21738656.0,
    "qwen3-0.6b_decode_32k_2pod": 3407695464.0,
    "gemma3-1b_train_4k_1pod": 15885154368.0,
    "gemma3-1b_prefill_32k_1pod": 1443895024.0,
    "zamba2-2.7b_train_4k_1pod": 6956637148.0,
    "mamba2-130m_decode_32k_1pod": 58625424.0,
    "internvl2-2b_decode_32k_1pod": 5911923208.0,
    "mamba2-130m_prefill_32k_1pod": 1118616080.0,
    "zamba2-2.7b_prefill_32k_1pod": 3193341768.0,
    "internvl2-2b_prefill_32k_1pod": 2767748676.0,
    "zamba2-2.7b_long_500k_1pod": 792414848.0}
#: the port's peak bytes a device of these prefill cells over the
#: reference's, at most
DRYRUN_PEAK_OVER_REFERENCE = {
    # the rotary tables made for one row (1, S) and broadcast over the
    # rank's rows (transformer._positions): 1.44x (1.94 GiB) while every
    # rank made the cos and sin of the global batch's 32 x 32768 x 128
    "gemma3-1b_prefill_32k_1pod": 1.0,
    # the same tables: 1.19x (1.83 GiB)
    "qwen3-0.6b_prefill_32k_1pod": 1.0,
    # the lookup's rows returned by DTensor's all-to-all charged at their
    # own 256 MiB (hlo_analysis._live_ranges), as the card's op allocates
    # them: 1.67x (4.31 GiB) while the fake kernel's view charged its
    # 4 GiB storage of the data group's 32 sequences
    "internvl2-2b_prefill_32k_1pod": 1.0}


def dry_run(trained) -> None:
    """Phase 20: the dry run's cells at once, then the gates of the
    sharded attention (the Qwen3 prefill cell's useful-FLOPs ratio, the
    decode cells' collective bytes), the gemma3 and the Mamba2 and
    internvl2 decode cells' FLOPs, the dp train, those decode cells' and
    zamba2's prefill and ``long_500k`` cells' collective bytes and the
    three prefill cells' peaks against the reference's, and the two
    of the 1-rank cell: its
    roofline step below phase 18's measured ms a step (a bound above the
    measurement would mean the count is wrong) and its FLOPs within
    DRYRUN_TRACKER_REL of the tracker's for that step."""
    import os
    import tempfile
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for arch, shape, multi in DRYRUN_CELLS:
            tag = f"{arch}_{shape}_{'2pod' if multi else '1pod'}"
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--device", "cuda", "--arch", arch, "--shape", shape,
                   "--out", str(Path(tmp) / tag)] + \
                (["--multi-pod"] if multi else [])
            procs[tag] = cmd
        procs["one_rank"] = [sys.executable, "-c", DRYRUN_ONE_RANK,
                             str(TRAIN_SEQ), str(TRAIN_BATCH),
                             str(Path(tmp) / "one_rank")]
        t0 = time.perf_counter()
        running = {tag: subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=str(ROOT))
            for tag, cmd in procs.items()}
        logs = {}
        try:
            for tag, proc in running.items():
                left = DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)
                logs[tag] = proc.communicate(timeout=max(left, 1.0))[0]
        except subprocess.TimeoutExpired:
            fail(f"the dry run's cells took over {DRYRUN_TIMEOUT_S} s")
        finally:
            for proc in running.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        log(f"  {len(procs)} cells in {time.perf_counter() - t0:.1f} s, "
            f"one process each")
        cells = {}
        for tag, proc in running.items():
            found = list((Path(tmp) / tag).glob("*.json"))
            cell = json.loads(found[0].read_text()) if found else {}
            if proc.returncode != 0 or cell.get("status") != "ok":
                log(logs[tag][-4000:])
                fail(f"dry-run cell {tag}: exit {proc.returncode}, "
                     f"{cell.get('status')} {cell.get('error', '')}")
            cells[tag] = cell
            log(f"  {tag} ({cell['chips']} ranks, {cell['profile']}): "
                f"compute {cell['compute_s'] * 1e3:.2f} ms, memory "
                f"{cell['memory_s'] * 1e3:.2f} ms, collective "
                f"{cell['collective_s'] * 1e3:.2f} ms -> {cell['bound']}-"
                f"bound; useful FLOPs {cell['useful_flops_ratio']:.2f}; peak "
                f"{cell['peak_bytes_per_device'] / 2**30:.2f} GiB a device "
                f"({'fits' if cell['peak_bytes_per_device'] <= 80e9 else 'over'}"
                f" 80 GB); traced in {cell['compile_s']:.1f} s, "
                f"{cell['graph_nodes']} nodes")
    prefill = cells["qwen3-0.6b_prefill_32k_1pod"]
    log(f"  Qwen3-0.6B prefill_32k: useful FLOPs "
        f"{prefill['useful_flops_ratio']:.4f} (at least "
        f"{DRYRUN_PREFILL_USEFUL}), {prefill['flops_per_device']:.4e} FLOPs "
        f"a device")
    if not prefill["useful_flops_ratio"] >= DRYRUN_PREFILL_USEFUL:
        fail(f"Qwen3-0.6B prefill_32k's useful-FLOPs ratio "
             f"{prefill['useful_flops_ratio']:.4f} is below "
             f"{DRYRUN_PREFILL_USEFUL}: the heads are not split over model")
    for tag, limit in DRYRUN_FLOPS_OVER_REFERENCE.items():
        ratio = (cells[tag]["flops_per_device"]
                 / DRYRUN_REFERENCE_FLOPS[tag])
        log(f"  {tag}: {cells[tag]['flops_per_device']:.4e} FLOPs a device, "
            f"{ratio:.3f}x the reference's {DRYRUN_REFERENCE_FLOPS[tag]:.4e} "
            f"(at most {limit}x)")
        if not ratio <= limit:
            fail(f"{tag} reads {ratio:.3f}x the reference's FLOPs a device, "
                 f"above {limit}x: a rank does another rank's work")
    for tag, limit in DRYRUN_COLLECTIVES_OVER_REFERENCE.items():
        coll = cells[tag]["collective_bytes_per_device"]
        ratio = coll / DRYRUN_REFERENCE_COLLECTIVE_BYTES[tag]
        log(f"  {tag}: {coll:.4e} collective bytes a device "
            f"({cells[tag]['collective_detail']}), {ratio:.3f}x the "
            f"reference's {DRYRUN_REFERENCE_COLLECTIVE_BYTES[tag]:.4e} (at "
            f"most {limit}x)")
        if not ratio <= limit:
            fail(f"{tag} reads {ratio:.3f}x the reference's collective "
                 f"bytes a device, above {limit}x: a rank gathers what "
                 f"the reference's partitioned program does not")
    for tag, ref in DRYRUN_REFERENCE_PEAK_BYTES.items():
        peak = cells[tag]["peak_bytes_per_device"]
        limit = DRYRUN_PEAK_OVER_REFERENCE.get(tag)
        log(f"  {tag}: peak {peak:.6e} bytes a device, {peak / ref:.3f}x "
            f"the reference's {ref:.6e}"
            + (f" (at most {limit}x)" if limit else ""))
        if limit and not peak / ref <= limit:
            fail(f"{tag}'s peak reads {peak / ref:.3f}x the reference's, "
                 f"above {limit}x: a rank holds what the reference's "
                 f"partitioned program does not")
    for tag in ("qwen3-0.6b_decode_32k_1pod", "qwen3-0.6b_decode_32k_2pod"):
        coll = cells[tag]["collective_bytes_per_device"]
        log(f"  {tag}: {coll:.4e} collective bytes a device "
            f"({cells[tag]['collective_detail']}), below "
            f"{DRYRUN_DECODE_COLLECTIVE_BYTES:.3g}")
        if not coll < DRYRUN_DECODE_COLLECTIVE_BYTES:
            fail(f"{tag} reads {coll:.4e} collective bytes a device, not "
                 f"below {DRYRUN_DECODE_COLLECTIVE_BYTES:.3g}: the cache "
                 f"or the embedding table is gathered")
    one = cells["one_rank"]
    step_ms = trained["flash_attention"]["step_ms"]
    bound_ms = one["step_s"] * 1e3
    log(f"  1-rank Qwen3-0.6B step ({TRAIN_BATCH} x {TRAIN_SEQ}): roofline "
        f"{bound_ms:.2f} ms against phase 18's {step_ms:.2f} ms a step "
        f"({bound_ms / step_ms:.1%})")
    if not bound_ms < step_ms:
        fail(f"the 1-rank roofline step ({bound_ms:.2f} ms) is not below "
             f"the measured step ({step_ms:.2f} ms): the count is wrong")
    ratio = one["flops_per_device"] / trained["tracked_flops"]
    log(f"  its FLOPs {one['flops_per_device']:.4e} against the tracked "
        f"step's {trained['tracked_flops']:.4e} (phase 18 (c)): "
        f"{ratio:.4f}")
    if abs(ratio - 1.0) > DRYRUN_TRACKER_REL:
        fail(f"the 1-rank dry run's FLOPs lie {ratio:.4f} of the tracker's "
             f"(limit {DRYRUN_TRACKER_REL})")


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
    from repro_torch.core import calibration
    from repro_torch.core import devices as devices_mod
    measured = calibration.calibrate_spec(device)
    spec = devices_mod.get("H100-SXM")
    log(f"  calibrate_spec: fp32 GEMM (4096, TF32 off) "
        f"{measured['peak_flops'] / 1e12:.1f} TFLOP/s, copy "
        f"{measured['mem_bandwidth'] / 1e12:.3f} TB/s; H100-SXM spec "
        f"(datasheet) {spec.peak_flops / 1e12:.1f} TFLOP/s fp32, "
        f"{spec.mem_bandwidth / 1e12:.3f} TB/s (80% of 3.35); {smi_line}")

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
    cpu_grid = check_answers(answers, traces, new_traces, golden_mixed,
                             fleet_minus, mlps, devs)
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
    for phase, arch in ((7, "qwen3-0.6b"), (8, "mamba2-130m")):
        log(f"[{phase} serve] {arch}: {len(LM_PROMPT_LENS)} requests, "
            f"prompts {min(LM_PROMPT_LENS)}-{max(LM_PROMPT_LENS)} tokens, "
            f"{LM_MAX_NEW} new tokens, batch {LM_BATCH}, max_seq "
            f"{LM_MAX_SEQ}")
        lm_runs.update(serve_lm(torch, get_config(arch), device,
                                kernel_mods)["kernels"])

    # -- 9. the LM kernels timed on the largest inputs their path gave ------
    log("[9 timing] flash attention and the SSD scan on their path's "
        "largest inputs")
    lm_sources = {"flash_attention": ("flash_attention", 78),
                  "ssd": ("ssd", 72)}
    #: the first kernels' times on the same inputs, before the tensor-core
    #: redesign (PERF.md's kernel table: H100 80GB HBM3 at 700 W, events
    #: without the spin); log text only, the kernels line holds what this
    #: run measured
    earlier_ms = {"flash_attention": 3.506, "ssd": 5.662}
    for kmod, kname in ((fa, "flash_attention"), (sk, "ssd")):
        args, kwargs = lm_runs[kname]["args"]
        lm_worst[kname] = max(lm_worst[kname], lm_runs[kname]["max_abs_err"])
        times = time_lm_kernel(
            torch, kmod, kname, args, kwargs,
            earlier=f"; the first kernel {earlier_ms[kname]:.3f} ms "
                    f"without the spin")
        if kname == "flash_attention":
            times.update(time_flash_offset(torch, fa, args, kwargs))
        src, line = lm_sources[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}.cu",
            "replaces": f"src/repro/kernels/{src}.py:{line}",
            "launches": lm_runs[kname]["launches"],
            "max_abs_err": lm_worst[kname], **times})

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

    # -- 14. tracking the five Table-4 nets on the card ---------------------
    from repro_torch.models import evalzoo
    log("[14 track] one training iteration of each Table-4 net at the "
        "reference's default sizes, OperationTracker(\"H100-SXM\", "
        "measure=\"wallclock\")")
    t0 = time.perf_counter()
    card_matches_cpu(torch, device)
    tracked = [track_net(torch, name, device) for name in evalzoo.ZOO]
    log(f"  phase 14: {time.perf_counter() - t0:.1f} s")

    # -- 15. the tracked iterations through the fleet planner --------------
    log("[15 fleet from tracked steps] the five traces (and DCGAN at batch "
        "64) through FleetPlanner(HabitatPredictor(mlps, device=cuda))")
    t0 = time.perf_counter()
    extra = track_net(torch, TRACK_EXTRA[0], device, **TRACK_EXTRA[1])
    fleet_from_tracked(torch, fms, batched, mlps, tracked, extra,
                       trained=default_mlps)
    cli_fleet(torch)
    log(f"  phase 15: {time.perf_counter() - t0:.1f} s")

    # -- 16. the prediction service on the card ----------------------------
    log("[16 serve predictions] PredictionService over HabitatPredictor("
        "phase 4's mlps, device=cuda): both front ends in process, then "
        "the router, workers and cache server as processes, then the CLI's "
        "--optimize")
    t0 = time.perf_counter()
    serve_predictions(torch, fms, batched, mlps, traces, new_traces,
                      tracked, extra, cpu_grid, devs, fleet_minus)
    log(f"  phase 16: {time.perf_counter() - t0:.1f} s")

    # -- 17. the rest of the model zoo -------------------------------------
    log(f"[17 serve the zoo] {', '.join(ZOO_ARCHS)} at their published "
        f"configs, bf16, one at a time")
    t0 = time.perf_counter()
    serve_zoo(torch, device, kernel_mods)
    log(f"  phase 17: {time.perf_counter() - t0:.1f} s")

    # -- 18. training the LMs ---------------------------------------------
    log(f"[18 train the LMs] {', '.join(TRAIN_ARCHS)} at their published "
        f"configs: gradient gates, Trainer with a crash and a resume, "
        f"launch.train --predict-on, distributed.predict_step")
    t0 = time.perf_counter()
    trained = train_lms(torch, device, kernel_mods, default_mlps)
    for entry in kernels:
        if entry["name"] in trained:
            entry["train_launches"] = trained[entry["name"]]["launches"]
    log(f"  phase 18: {time.perf_counter() - t0:.1f} s")

    # -- 19. training the LMs sharded over a mesh --------------------------
    log(f"[19 train the LMs on a mesh] {', '.join(TRAIN_ARCHS)} with their "
        f"state as DTensors on a (data 1, model 1) mesh of the card: steps "
        f"against plain tensors, a sharded checkpoint restored onto a fresh "
        f"mesh, a prefill and decode on the mesh")
    t0 = time.perf_counter()
    sharded = train_sharded(torch, device, kernel_mods, trained)
    for entry in kernels:
        if entry["name"] in sharded:
            entry["mesh_launches"] = sharded[entry["name"]]["launches"]
    sharding_guard()
    log(f"  phase 19: {time.perf_counter() - t0:.1f} s")

    # -- 20. the dry run on the production meshes --------------------------
    log(f"[20 dry run] {len(DRYRUN_CELLS)} cells on fake 256- and 512-rank "
        f"meshes and phase 18's step on one rank, each a process, read "
        f"from the traced per-rank graph")
    t0 = time.perf_counter()
    dry_run(trained)
    log(f"  phase 20: {time.perf_counter() - t0:.1f} s")

    # -- 21. result lines ---------------------------------------------------
    print(smi_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
