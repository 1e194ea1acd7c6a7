"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``) on smoke configs.

Both packages run qwen3-0.6b, granite-moe-3b-a800m and zamba2-2.7b smoke
configs in train, prefill and decode on a (4, 2) mesh of 8: each
package's ``make_production_mesh``, ``get_config`` and ``SHAPES`` are
monkeypatched in its ``dryrun`` module, inside a subprocess of its own
(the reference sets 512 host devices when imported; the port starts a
fake process group, one default group a process).  The shapes keep the
cells' names and modes at CPU sizes: train 16 x 256, prefill 8 x 512,
decode 16 slots over a 512-deep cache.  The reference's attention
chunks are set to what the port runs (with the smoke config's 8, XLA
compiles a 32-chunk loop for about 35 s a cell on a CPU): 1024 in
training, the chunks of the flash op's VJP, and 64 in prefill and
decode, where the kernel skips masked tiles of 64 keys.  The reference
runs one subprocess a cell, beside the port's, all at once.

Held, with each tolerance's reason:

  * ``chips``, ``mesh`` and ``model_flops`` equal (rel 1e-12: the same
    formula on the same config);
  * ``flops_per_device`` within 10% of the reference's HLO count
    (:data:`FLOPS_REL`) where both programs do the same work: the train
    and the qwen3 and granite prefill cells and qwen3's decode.  The
    other three read within :data:`FLOPS_BAND` (a count of the global
    op, or of one rank's op on another rank's share, would read 8x):
    zamba2's prefill counts the SSD kernel as ``core.costmodel`` does,
    the causal half of each chunk's score block, where the reference's
    jnp scan computes whole blocks; granite's decode reads 0.71 because
    the reference counts its KV cache moves as work (the fusions of its
    ``dynamic-update-slice``, ``dynamic-slice``, ``scatter`` and
    transposing copies of the cache), where the
    port counts each cache write once, as its ``index_put_``'s output
    (the cache shard), and its views nothing; zamba2's decode reads 1.35 because DTensor plans the
    shared block's SwiGLU and the LM head on the data group's whole
    batch and vocab (it gathers the activations, which are smaller at
    decode than the FSDP-split weights XLA gathers), so the rank's
    products count more than the reference's.  Each ratio is printed
    (``-s``);
  * on the ``dp`` train cell, all-reduce plus reduce-scatter bytes a rank
    of at least the model's parameter bytes: a data-parallel step must
    reduce every gradient;
  * ``peak_bytes_per_device`` at least the train state's bytes a rank;
  * on a 1-rank fake mesh, the dry run's FLOPs for a smoke Qwen3 and
    Mamba2 train step (2 x 128) within 10% of what the port's
    ``OperationTracker`` sums over the same eager step on the CPU (the
    tracker weighs transcendental ops and counts a reduction's inputs,
    the dry run counts 1 a output element: 2-4% apart here);
  * the CLI writes a production cell (256 and, with ``--multi-pod``, 512
    ranks) with the H100 roofline terms; ``long_500k`` is skipped for a
    full-attention arch; a cell refuses to run inside a real process
    group.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.core import devices

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-0.6b", "granite-moe-3b-a800m", "zamba2-2.7b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
FLOPS_REL = 0.10
FLOPS_BAND = (0.5, 2.0)
#: cells whose programs differ in their work (the module docstring
#: names each cause)
NOT_PRODUCTS = {("zamba2-2.7b", "prefill_32k"),
                ("granite-moe-3b-a800m", "decode_32k"),
                ("zamba2-2.7b", "decode_32k")}
TRACKER_REL = 0.10

_SHAPES_CODE = """
SHAPES = {"train_4k": ShapeConfig("train_4k", 256, 16, "train"),
          "prefill_32k": ShapeConfig("prefill_32k", 512, 8, "prefill"),
          "decode_32k": ShapeConfig("decode_32k", 512, 16, "decode")}
"""

_REFERENCE = textwrap.dedent("""
    import dataclasses, json, sys
    from repro.launch import dryrun
    from repro.launch.mesh import make_mesh
    from repro.configs import get_config
    from repro.models.config import ShapeConfig, smoke_config
""") + _SHAPES_CODE + textwrap.dedent("""
    dryrun.make_production_mesh = lambda multi_pod=False: make_mesh(
        (4, 2), ("data", "model"))
    chunk = 1024 if SHAPES[sys.argv[2]].mode == "train" else 64
    dryrun.get_config = lambda a: dataclasses.replace(
        smoke_config(get_config(a)), attn_chunk_q=chunk, attn_chunk_kv=chunk)
    dryrun.SHAPES = SHAPES
    print(json.dumps(dryrun.run_cell(sys.argv[1], sys.argv[2],
                                     verbose=False)))
""")

_PORT = textwrap.dedent("""
    import json
    import torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.config import ShapeConfig, smoke_config
""") + _SHAPES_CODE + textwrap.dedent("""
    out = {"cells": {}, "tracked": {}}
    mesh = [(4, 2)]
    dryrun.make_production_mesh = lambda multi_pod=False, device=None: \\
        make_mesh(mesh[0], ("data", "model"), device=device)
    dryrun.get_config = lambda a: smoke_config(get_config(a))
    dryrun.SHAPES = SHAPES
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    for arch in %(archs)r:
        for s in SHAPES:
            out["cells"][arch + "/" + s] = dryrun.run_cell(
                arch, s, verbose=False, device="cpu")
    dryrun.SHAPES["long_500k"] = ShapeConfig("long_500k", 1024, 1,
                                             "decode")
    out["skipped"] = dryrun.run_cell("qwen3-0.6b", "long_500k",
                                     device="cpu")
    dist.destroy_process_group()

    # one rank: the dry run against the tracker on the same eager step
    from repro_torch.core import OperationTracker
    from repro_torch.train.optim import adamw
    from repro_torch.train.train_step import init_state, make_train_step
    mesh[0] = (1, 1)
    dryrun.SHAPES = {"train_4k": ShapeConfig("train_4k", 128, 2, "train")}
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=1)
    for arch in ("qwen3-0.6b", "mamba2-130m"):
        cell = dryrun.run_cell(arch, "train_4k", verbose=False,
                               device="cpu")
        cfg = smoke_config(get_config(arch))
        opt = adamw()
        state = init_state(cfg, 0, opt, device="cpu")
        gen = torch.Generator().manual_seed(0)
        tokens = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen,
                               dtype=torch.int32)
        batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
        trace = OperationTracker().track(make_train_step(cfg, opt), state,
                                         batch)
        out["tracked"][arch] = [cell["flops_per_device"],
                                sum(op.cost.flops for op in trace.ops)]
    dist.destroy_process_group()

    # a real process group in this process: the dry run refuses it
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        dryrun.run_cell("qwen3-0.6b", "train_4k", device="cpu")
        out["refused"] = ""
    except RuntimeError as e:
        out["refused"] = str(e)
    dist.destroy_process_group()
    print(json.dumps(out))
""" % {"archs": ARCHS})


def _start(args, env):
    return subprocess.Popen(
        [sys.executable] + args, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=str(ROOT),
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), **env))


def _json(proc, what):
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, f"{what}: {err[-3000:]}"
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every subprocess at once: the reference a cell a process, the
    port's cells, and two production cells through the CLI."""
    out_dir = tmp_path_factory.mktemp("dryrun")
    env = {"OMP_NUM_THREADS": "1"}
    refs = {(a, s): _start(["-c", _REFERENCE, a, s],
                           dict(env, JAX_PLATFORMS="cpu"))
            for a in ARCHS for s in SHAPES}
    port = _start(["-c", _PORT], env)
    cli = [_start(["-m", "repro_torch.launch.dryrun", "--device", "cpu",
                   "--arch", "mamba2-130m", "--shape", shape, "--out",
                   str(out_dir / tag)] + flags, env)
           for tag, shape, flags in (("1pod", "decode_32k", []),
                                     ("2pod", "long_500k", ["--multi-pod"]))]
    got = {"port": _json(port, "port"),
           "ref": {k: _json(p, k) for k, p in refs.items()}}
    for proc in cli:
        out, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err[-3000:]
    got["cli"] = {tag: json.loads(next((out_dir / tag).glob("*.json"))
                                  .read_text())
                  for tag in ("1pod", "2pod")}
    return got


def _pair(runs, arch, shape):
    return (runs["port"]["cells"][f"{arch}/{shape}"],
            runs["ref"][arch, shape])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_matches_the_reference(runs, arch, shape):
    port, ref = _pair(runs, arch, shape)
    assert port["status"] == ref["status"] == "ok"
    assert port["chips"] == ref["chips"] == 8
    assert port["mesh"] == ref["mesh"] == {"data": 4, "model": 2}
    assert port["model_flops"] == pytest.approx(ref["model_flops"],
                                                rel=1e-12)
    ratio = port["flops_per_device"] / ref["flops_per_device"]
    print(f"{arch} {shape}: port/reference FLOPs a device {ratio:.3f}")
    if (arch, shape) in NOT_PRODUCTS:
        assert FLOPS_BAND[0] < ratio < FLOPS_BAND[1], ratio
    else:
        assert ratio == pytest.approx(1.0, rel=FLOPS_REL), ratio


def test_data_parallel_step_reduces_every_gradient(runs):
    from repro_torch.configs import get_config
    from repro_torch.models.config import smoke_config
    cell = runs["port"]["cells"]["qwen3-0.6b/train_4k"]
    assert cell["profile"] == "dp"
    cfg = smoke_config(get_config("qwen3-0.6b"))
    param_bytes = cfg.n_params() * 4        # fp32 smoke parameters
    reduced = (cell["collective_detail"]["all-reduce"]
               + cell["collective_detail"]["reduce-scatter"])
    assert reduced >= param_bytes, (reduced, param_bytes)


@pytest.mark.parametrize("arch", ARCHS)
def test_peak_holds_the_train_state(runs, arch):
    cell = runs["port"]["cells"][f"{arch}/train_4k"]
    assert cell["peak_bytes_per_device"] >= cell["state_bytes_per_device"]
    assert cell["state_bytes_per_device"] > 0


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-130m"])
def test_one_rank_dry_run_matches_the_tracker(runs, arch):
    dry, tracked = runs["port"]["tracked"][arch]
    print(f"{arch}: dry run / tracker FLOPs {dry / tracked:.3f}")
    assert dry == pytest.approx(tracked, rel=TRACKER_REL)


@pytest.mark.parametrize("tag, chips", [("1pod", 256), ("2pod", 512)])
def test_cli_writes_a_production_cell(runs, tag, chips):
    cell = runs["cli"][tag]
    assert cell["status"] == "ok", cell.get("error")
    assert cell["chips"] == chips
    assert cell["compute_s"] == pytest.approx(
        cell["flops_per_device"] / devices.ROOFLINE_PEAK_FLOPS)
    assert cell["memory_s"] == pytest.approx(
        cell["bytes_per_device"] / devices.ROOFLINE_HBM_BW)
    assert cell["collective_s"] == pytest.approx(
        cell["collective_bytes_per_device"] / devices.ROOFLINE_LINK_BW)
    assert cell["step_s"] == max(cell["compute_s"], cell["memory_s"],
                                 cell["collective_s"])


def test_long_context_skips_full_attention(runs):
    assert runs["port"]["skipped"]["status"] == "skipped"


def test_refuses_a_real_process_group(runs):
    assert "fake process group" in runs["port"]["refused"]
