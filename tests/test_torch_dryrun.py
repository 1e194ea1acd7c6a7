"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``) on smoke configs.

Both packages run qwen3-0.6b, granite-moe-3b-a800m and zamba2-2.7b smoke
configs in train, prefill and decode (and smoke Mamba2 in decode) on a
(4, 2) mesh of 8, smoke gemma3
and zamba2 in train on a (2, 4) mesh, and smoke
qwen3 in prefill and decode on that mesh, where its 4 query heads
split one a ``model`` rank beside 2 KV heads that cannot, and its decode
cache's sequence is split over ``model``: each package's
``make_production_mesh``, ``get_config`` and ``SHAPES`` are
monkeypatched in its ``dryrun`` module, inside a subprocess of its own
(the reference sets 512 host devices when imported; the port starts a
fake process group, one default group a process).  The shapes keep the
cells' names and modes at CPU sizes: train 16 x 256, prefill 8 x 512 (2
x 512 on the (2, 4) mesh, one row a data rank), decode 16 slots over a
512-deep cache.  The reference's attention chunks are set to what the
port runs (with the smoke config's 8, XLA compiles a 32-chunk loop for
about 35 s a cell on a CPU): 1024 in training, the chunks of the flash
op's VJP, and 64 in prefill and decode, where the kernel skips masked
tiles of 64 keys.  The reference runs one subprocess a cell, beside the
port's, all at once, and also reports the FLOPs of the dots of its
compiled program (each loop body times its trips).

Held, with each tolerance's reason:

  * ``chips``, ``mesh`` and ``model_flops`` equal (rel 1e-12: the same
    formula on the same config);
  * ``flops_per_device`` within 10% of the reference's HLO count
    (:data:`FLOPS_REL`) where both programs count the same work: the
    train cells, the qwen3 and granite prefill cells (and qwen3's on the
    (2, 4) mesh, where each rank runs its own query head: 2.23x before
    the split) and zamba2's decode.  The other three read within
    :data:`FLOPS_BAND` (a count of the global op, or of one rank's op on
    another rank's share, would read 8x): zamba2's prefill counts the
    SSD kernel as ``core.costmodel`` does, the causal half of each
    chunk's score block, where the reference's jnp scan computes whole
    blocks; qwen3's and granite's decode read 0.67 and 0.65 because the
    reference counts its KV cache moves as work (the fusions of its
    scan's ``dynamic-update-slice`` and ``dynamic-slice`` of the stacked
    cache, its ``scatter`` and transposing copies of it), where the port
    counts each cache write once, as its ``index_put_``'s output (the
    cache shard), and its views nothing.  So every decode cell is also
    held on its products: the port's matmul FLOPs (``flop_registry``'s
    count) within FLOPS_REL of the reference's dots, each slot's layers
    run once on the rank's own slots (equal to the FLOP in each cell
    here).
    Each ratio is printed (``-s``);
  * on the (2, 4) mesh, decode's collective bytes a device at most
    :data:`SPLIT_COLLECTIVES` times the reference's: the sequence-split
    cache is read from per-shard softmax partials, not gathered (20x
    before), and FLOPs within FLOPS_BAND;
  * on the ``dp`` train cell, the bytes its reductions sum (an
    all-reduce's output, a reduce-scatter's input) at least the model's
    parameter bytes: a data-parallel step must reduce every gradient;
    and no all-reduce outputs a weight's shape (each weight's gradient
    is reduce-scattered back to its split);
  * smoke dbrx's ``2d`` train cell on the (2, 4) mesh (2 KV heads on
    ``model=4``): no all-reduce of k's or v's heads' gradient (each is
    reduce-scattered back to the projection's split of the columns);
  * smoke Mamba2 (at d_model 48: 6 heads) and zamba2 in prefill on the
    (2, 4) mesh: each SSD op call runs on the traced rank's range of the
    heads, the FLOPs at most FLOPS_REL above the reference's, and no
    all-gather outputs ``in_proj``'s width;
  * smoke gemma3 (its output projection tied to the embedding table) and
    zamba2 in train on the (2, 4) mesh under ``dp`` (16 sequences, two a
    rank, the table's vocab over the whole mesh too): no collective
    outputs a vocab-wide block of more sequences than the rank holds or
    the global batch's activations, the FLOPs within FLOPS_REL of the
    reference's, and the collective bytes a device at most
    :data:`DP_COLLECTIVES` times the reference's (1.48x and 1.19x here:
    the smoke cells' fixed costs; the production cells read 0.40x and
    0.45x on the card);
  * smoke Mamba2's decode collective bytes a device at most
    :data:`DECODE_EXTRA_COLLECTIVES` times the reference's;
  * the product planner (``parallel.ctx.plan_product``) on production
    placements: decode's few tokens move to the weights' splits, a
    training microbatch or a prefill gathers the weight, and a width
    that does not divide ``model`` is split unevenly, not repeated;
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
#: decode cells run beside the others on the (4, 2) mesh: smoke Mamba2,
#: whose ``in_proj`` ran whole on both ``model`` ranks, and whose output
#: projection was gathered whole, before its decode products were
#: planned per shard
DECODE_EXTRA = ("mamba2-130m",)
#: their collective bytes a device over the reference's, at most: a CPU
#: group has no all-to-all, so each of the tokens' all-to-alls reads as
#: an all-gather of ``data=4`` times its bytes here
DECODE_EXTRA_COLLECTIVES = 2.0
FLOPS_REL = 0.10
FLOPS_BAND = (0.5, 2.0)
#: cells whose programs differ in their work (the module docstring
#: names each cause)
NOT_PRODUCTS = {("zamba2-2.7b", "prefill_32k"),
                ("granite-moe-3b-a800m", "decode_32k"),
                ("qwen3-0.6b", "decode_32k")}
TRACKER_REL = 0.10

_SHAPES_CODE = """
SHAPES = {"train_4k": ShapeConfig("train_4k", 256, 16, "train"),
          "prefill_32k": ShapeConfig("prefill_32k", 512, 8, "prefill"),
          "decode_32k": ShapeConfig("decode_32k", 512, 16, "decode")}
SPLIT_SHAPES = {"prefill_32k": ShapeConfig("prefill_32k", 512, 2, "prefill"),
                "decode_32k": ShapeConfig("decode_32k", 512, 16, "decode")}
"""
#: the (2, 4) mesh's cells: smoke qwen3's 4 heads split one a ``model``
#: rank in prefill (2 x 512: one row a data rank), and its 2 KV heads,
#: which do not divide ``model=4``, leave the decode cache's sequence
#: split over ``model``
SPLIT_MESH = (2, 4)
SPLIT_CELLS = ("prefill_32k", "decode_32k")
#: the split mesh's decode collective bytes a device over the
#: reference's, at most
SPLIT_COLLECTIVES = 2.0
#: the (1, 8) mesh: smoke qwen3's 4 heads do not divide ``model=8``, so
#: prefill splits the query sequence over ``model`` (two chunks of 32 of
#: the 512 positions a rank)
ZIGZAG_MESH = (1, 8)
#: the train cells read on the (2, 4) mesh under ``dp`` (16 sequences,
#: two a rank): smoke gemma3, whose output projection is the embedding
#: table tied, and smoke zamba2, whose Mamba2 layers run per shard
DP_ARCHS = ("gemma3-1b", "zamba2-2.7b")
#: their collective bytes a device over the reference's, at most
DP_COLLECTIVES = 2.0

#: the Mamba2 blocks cut over ``model`` by heads in prefill
#: (``ssm._mamba_heads``), on the (2, 4) mesh: smoke Mamba2 at d_model 48
#: (6 heads: 2 a rank on ranks 0-2, none on rank 3; ``in_proj`` 230
#: wide, whole over ``model``, as Mamba2-130M's 3352 on ``model=16``) and
#: smoke zamba2 (8 heads, 2 a rank; ``in_proj`` 296 wide, split over
#: ``model``, as zamba2-2.7b's 10448)
HEADS_ARCHS = ("mamba2-130m", "zamba2-2.7b")
HEADS_WIDTHS = {"mamba2-130m": {"d_model": 48}}

_REFERENCE = textwrap.dedent("""
    import dataclasses, json, re, sys
    from repro.launch import dryrun, hlo_analysis
    from repro.launch.mesh import make_mesh
    from repro.configs import get_config
    from repro.models.config import ShapeConfig, smoke_config
""") + _SHAPES_CODE + textwrap.dedent("""
    mesh = tuple(int(n) for n in sys.argv[3].split(","))
    widths = json.loads(sys.argv[4]) if len(sys.argv) > 4 else {}
    dryrun.make_production_mesh = lambda multi_pod=False: make_mesh(
        mesh, ("data", "model"))
    chunk = 1024 if SHAPES[sys.argv[2]].mode == "train" else 64
    dryrun.get_config = lambda a: dataclasses.replace(
        smoke_config(get_config(a)), attn_chunk_q=chunk, attn_chunk_kv=chunk,
        **widths)
    dryrun.SHAPES = SHAPES if mesh == (4, 2) else \
        {**SPLIT_SHAPES, "train_4k": SHAPES["train_4k"]}
    texts = []
    analyze = hlo_analysis.analyze
    dryrun.hlo_analysis.analyze = lambda compiled, chips: (
        texts.append(compiled.as_text()) or analyze(compiled, chips))
    cell = dryrun.run_cell(sys.argv[1], sys.argv[2], verbose=False)
    mod = hlo_analysis.HloModule(texts[0])

    def dots(name):
        # the reference's own dot count, each loop body times its trips
        total, lines, symtab = 0.0, mod.computations.get(name, []), {}
        for line in lines:
            m = hlo_analysis._INSTR_RE.match(line)
            if m and hlo_analysis._shape_dims(m.group(2)):
                symtab[m.group(1)] = hlo_analysis._shape_dims(m.group(2))[0][1]
        for line in lines:
            m = hlo_analysis._INSTR_RE.match(line)
            if not m:
                continue
            op = m.group(3)
            if op == "dot":
                total += mod._dot_flops(hlo_analysis._shape_dims(m.group(2)),
                                        line, symtab)
            elif op == "while":
                trips = re.search(r"known_trip_count[^\\d]*(\\d+)", line)
                body = re.search(r"body=%?([\\w.\\-]+)", line).group(1)
                total += dots(body) * (float(trips.group(1)) if trips else 1)
            else:
                for c in re.finditer(r"(?:to_apply|calls|called_computations)"
                                     r"=%?\\{?%?([\\w.\\-]+)", line):
                    total += dots(c.group(1))
        return total
    cell["dot_flops"] = dots(mod.entry)
    print(json.dumps(cell))
""")

_PORT = textwrap.dedent("""
    import dataclasses, json
    import torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.config import ShapeConfig, smoke_config
""") + _SHAPES_CODE + textwrap.dedent("""
    out = {"cells": {}, "tracked": {}, "split": {}}
    mesh = [(4, 2)]
    # each traced graph's kernel-op FLOPs, and the output shapes of the
    # collectives recorded while the embedding lookup ran, written into
    # the cell they were read for
    from repro_torch.launch import hlo_analysis
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel import ctx
    seen = {"lookup": [], "x_gathers": [], "products": 0, "loss": []}
    inside = []
    losing = []
    # the per-shard products entered and not yet at their product
    products = []
    lookup, record, analyze = (tfm._lookup, hlo_analysis._Recorder._record,
                               hlo_analysis.analyze)
    product = ctx.product
    mms = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)
    loss = tfm.cross_entropy

    def losing_(*args):
        losing.append(True)
        try:
            return loss(*args)
        finally:
            losing.pop()

    def producing(*args, **kwargs):
        products.append(True)
        seen["products"] += 1
        try:
            return product(*args, **kwargs)
        finally:
            products.pop()

    def looking(*args):
        inside.append(True)
        try:
            return lookup(*args)
        finally:
            inside.pop()

    def noting(self, func, args, kwargs, out):
        if inside and hlo_analysis.collective_class(func):
            seen["lookup"].append(list(getattr(out, "shape", ())))
        if losing and hlo_analysis.collective_class(func):
            seen["loss"].append([hlo_analysis.collective_class(func),
                                 list(getattr(out, "shape", ()))])
        if products and products[-1]:
            # before a product's matmul: x's moves (an activation, 3-D
            # here) and its weights' (2-D)
            if func in mms:
                products[-1] = False
            elif hlo_analysis.collective_class(func) == "all-gather" and \
                    getattr(out, "ndim", 0) >= 3:
                seen["x_gathers"].append(list(out.shape))
        return record(self, func, args, kwargs, out)

    def spy(graphs, chips):
        kernel = 0.0
        reduced = 0.0
        shapes = set()
        scans = []
        rope = []
        for g in hlo_analysis._graphs(graphs):
            for node in g.nodes:
                if node.op != "call_function":
                    continue
                if node.target in (torch.ops.aten.cos.default,
                                   torch.ops.aten.sin.default):
                    rope.append(list(node.meta.get("val").shape))
                if getattr(node.target, "namespace", "") == "repro_torch":
                    kernel += hlo_analysis.node_flops(
                        node.target, hlo_analysis._vals(node.args),
                        hlo_analysis._vals(node.kwargs),
                        node.meta.get("val"))[0]
                    if "ssd" in str(node.target):
                        scans.append(list(hlo_analysis._vals(
                            node.args)[0].shape))
                cls = hlo_analysis.collective_class(node.target)
                if cls:
                    shapes.add((cls, tuple(getattr(node.meta.get("val"),
                                                   "shape", ()))))
                # the bytes each reduction sums: an all-reduce's output,
                # a reduce-scatter's input (its output is a shard of it)
                if cls == "all-reduce":
                    reduced += hlo_analysis._nbytes(node.meta.get("val"))
                elif cls == "reduce-scatter":
                    reduced += hlo_analysis._nbytes(
                        hlo_analysis._vals(node.args)[0])
        seen["kernel_flops"] = kernel
        seen["collective_shapes"] = sorted(shapes)
        seen["scan_shapes"] = scans
        seen["reduced_bytes"] = reduced
        seen["rope_shapes"] = rope
        return analyze(graphs, chips)
    tfm._lookup, hlo_analysis._Recorder._record = looking, noting
    ctx.product = producing
    tfm.cross_entropy = losing_
    hlo_analysis.analyze = spy
    run_cell = dryrun.run_cell

    def run_and_spy(*args, **kwargs):
        seen.update(lookup=[], x_gathers=[], products=0, loss=[])
        cell = run_cell(*args, **kwargs)
        cell["loss_collectives"] = seen["loss"]
        cell["x_gathers"] = seen["x_gathers"]
        cell["products"] = seen["products"]
        cell["rope_shapes"] = seen.get("rope_shapes", [])
        cell["lookup_collectives"] = seen["lookup"]
        cell["kernel_flops"] = seen.get("kernel_flops", 0.0)
        cell["collective_shapes"] = seen.get("collective_shapes", [])
        cell["scan_shapes"] = seen.get("scan_shapes", [])
        cell["reduced_bytes"] = seen.get("reduced_bytes", 0.0)
        return cell
    dryrun.run_cell = run_and_spy
    dryrun.make_production_mesh = lambda multi_pod=False, device=None: \\
        make_mesh(mesh[0], ("data", "model"), device=device)
    widths = {}
    dryrun.get_config = lambda a: dataclasses.replace(
        smoke_config(get_config(a)), **widths.get(a, {}))
    dryrun.SHAPES = SHAPES
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    for arch in %(archs)r:
        for s in SHAPES:
            out["cells"][arch + "/" + s] = dryrun.run_cell(
                arch, s, verbose=False, device="cpu")
    for arch in %(decode_extra)r:
        out["cells"][arch + "/decode_32k"] = dryrun.run_cell(
            arch, "decode_32k", verbose=False, device="cpu")
    dryrun.SHAPES["long_500k"] = ShapeConfig("long_500k", 1024, 1,
                                             "decode")
    out["skipped"] = dryrun.run_cell("qwen3-0.6b", "long_500k",
                                     device="cpu")
    out["long"] = dryrun.run_cell("zamba2-2.7b", "long_500k", verbose=False,
                                  device="cpu")
    mesh[0] = %(split_mesh)r
    dryrun.SHAPES = SPLIT_SHAPES
    for s in SPLIT_SHAPES:
        out["split"][s] = dryrun.run_cell("qwen3-0.6b", s, verbose=False,
                                          device="cpu")
    widths.update(%(heads_widths)r)
    out["heads"] = {arch: dryrun.run_cell(arch, "prefill_32k",
                                          verbose=False, device="cpu")
                    for arch in %(heads_archs)r}
    widths.clear()
    mesh[0] = %(zigzag_mesh)r
    out["zigzag"] = dryrun.run_cell("qwen3-0.6b", "prefill_32k",
                                    verbose=False, device="cpu")
    mesh[0] = %(split_mesh)r
    dryrun.SHAPES = {"train_4k": SHAPES["train_4k"]}
    out["dp"] = {arch: dryrun.run_cell(arch, "train_4k", verbose=False,
                                       device="cpu")
                 for arch in %(dp_archs)r}
    out["kv_2d"] = dryrun.run_cell("dbrx-132b", "train_4k", verbose=False,
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
""" % {"archs": ARCHS, "decode_extra": DECODE_EXTRA,
       "split_mesh": SPLIT_MESH, "heads_widths": HEADS_WIDTHS,
       "heads_archs": HEADS_ARCHS,
       "zigzag_mesh": ZIGZAG_MESH, "dp_archs": DP_ARCHS})


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
    ref_env = dict(env, JAX_PLATFORMS="cpu")
    refs = {(a, s): _start(["-c", _REFERENCE, a, s, "4,2"], ref_env)
            for a in ARCHS for s in SHAPES}
    refs.update({(a, "decode_32k"): _start(
        ["-c", _REFERENCE, a, "decode_32k", "4,2"], ref_env)
        for a in DECODE_EXTRA})
    split = ",".join(str(n) for n in SPLIT_MESH)
    refs.update({("split", s): _start(["-c", _REFERENCE, "qwen3-0.6b", s,
                                       split], ref_env)
                 for s in SPLIT_CELLS})
    refs.update({("dp", a): _start(["-c", _REFERENCE, a, "train_4k", split],
                                   ref_env) for a in DP_ARCHS})
    refs.update({("heads", a): _start(
        ["-c", _REFERENCE, a, "prefill_32k", split,
         json.dumps(HEADS_WIDTHS.get(a, {}))], ref_env) for a in HEADS_ARCHS})
    refs["zigzag", "prefill_32k"] = _start(
        ["-c", _REFERENCE, "qwen3-0.6b", "prefill_32k",
         ",".join(str(n) for n in ZIGZAG_MESH)], ref_env)
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


@pytest.mark.parametrize("shape", SPLIT_CELLS)
def test_split_mesh_cell_matches_the_reference(runs, shape):
    """Smoke qwen3 on the (2, 4) mesh, where its 4 query heads split over
    ``model=4`` beside 2 KV heads that cannot: prefill runs each head
    once (FLOPs within FLOPS_REL of the reference's); decode reads the
    sequence-split cache from per-shard softmax partials (FLOPs within
    FLOPS_BAND, collective bytes at most SPLIT_COLLECTIVES times the
    reference's: no rank gathers the cache)."""
    port, ref = runs["port"]["split"][shape], runs["ref"]["split", shape]
    assert port["status"] == ref["status"] == "ok"
    assert port["mesh"] == ref["mesh"] == {"data": 2, "model": 4}
    assert port["profile"] == "2d"
    assert port["model_flops"] == pytest.approx(ref["model_flops"],
                                                rel=1e-12)
    ratio = port["flops_per_device"] / ref["flops_per_device"]
    coll = (port["collective_bytes_per_device"]
            / ref["collective_bytes_per_device"])
    print(f"(2, 4) {shape}: port/reference FLOPs a device {ratio:.3f}, "
          f"collective bytes {coll:.3f}")
    if shape == "prefill_32k":
        assert ratio == pytest.approx(1.0, rel=FLOPS_REL), ratio
    else:
        assert FLOPS_BAND[0] < ratio < FLOPS_BAND[1], ratio
        assert coll <= SPLIT_COLLECTIVES, coll


def test_zigzag_prefill_cell_matches_the_reference(runs):
    """Smoke qwen3's prefill on the (1, 8) mesh, where its 4 heads do not
    divide ``model=8``: each rank runs every head on its two chunks of the
    query sequence (FLOPs within FLOPS_REL of the reference's; every rank
    ran the whole sequence before), and gathers the projected rows, not
    the attention's output and a partial sum (collective bytes at most
    SPLIT_COLLECTIVES times the reference's)."""
    port, ref = runs["port"]["zigzag"], runs["ref"]["zigzag", "prefill_32k"]
    assert port["status"] == ref["status"] == "ok"
    assert port["mesh"] == ref["mesh"] == {"data": 1, "model": 8}
    ratio = port["flops_per_device"] / ref["flops_per_device"]
    coll = (port["collective_bytes_per_device"]
            / max(ref["collective_bytes_per_device"], 1.0))
    print(f"(1, 8) prefill_32k: port/reference FLOPs a device {ratio:.3f}, "
          f"collective bytes {coll:.3f}")
    assert ratio == pytest.approx(1.0, rel=FLOPS_REL), ratio
    assert coll <= SPLIT_COLLECTIVES, coll


def _config(arch, widths=None):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.config import smoke_config
    return dataclasses.replace(smoke_config(get_config(arch)),
                               **(widths or {}))


@pytest.mark.parametrize("arch", HEADS_ARCHS)
def test_mamba2_prefill_scans_the_rank_heads(runs, arch):
    """A Mamba2 prefill on the (2, 4) mesh (``2d``): every SSD op call of
    the traced rank 0 runs on its own sequence and its range of the heads
    (2 of 6, or of 8: ``torch.chunk``'s sizes over ``model=4``), not on
    every head (every ``model`` rank ran all of them while the op's
    DTensor rule planned the scan on a CUDA mesh); the FLOPs a device
    within FLOPS_REL of the reference's, or below them (rank 0 holds 2
    heads where the 6 average 1.5 a rank)."""
    from repro_torch.models.ssm import chunk_ranges
    port, ref = runs["port"]["heads"][arch], runs["ref"]["heads", arch]
    assert port["status"] == ref["status"] == "ok"
    assert port["mesh"] == ref["mesh"] == {"data": 2, "model": 4}
    cfg = _config(arch, HEADS_WIDTHS.get(arch))
    h0, h1 = chunk_ranges(cfg.ssm_heads, 4)[0]
    want = [1, h1 - h0, 512, cfg.ssm_head_dim]
    layers = cfg.n_layers
    assert port["scan_shapes"] == [want] * layers, port["scan_shapes"]
    ratio = port["flops_per_device"] / ref["flops_per_device"]
    print(f"{arch} (2, 4) prefill_32k: port/reference FLOPs a device "
          f"{ratio:.3f}")
    assert ratio <= 1.0 + FLOPS_REL, ratio


@pytest.mark.parametrize("arch", HEADS_ARCHS)
def test_no_collective_gathers_in_proj_width(runs, arch):
    """The same cells: no all-gather outputs ``in_proj``'s width as an
    activation (each rank computes only its heads' columns, and the
    decode states' columns go to the cache's split by a reduce-scatter),
    and where ``in_proj`` is split over ``model`` (zamba2), none outputs
    it at all: each rank's columns come from the others' shards by one
    all-to-all of just those columns, not the weight gathered whole."""
    port = runs["port"]["heads"][arch]
    cfg = _config(arch, HEADS_WIDTHS.get(arch))
    width = 2 * cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state \
        + cfg.ssm_heads
    split = width % 4 == 0
    gathered = [(c, shape) for c, shape in port["collective_shapes"]
                if c == "all-gather" and shape and shape[-1] == width
                and (len(shape) >= 3 or split)]
    assert port["collective_shapes"] and gathered == [], gathered


def test_dp_train_reduces_no_whole_weight_gradient(runs):
    """Smoke qwen3's ``dp`` train cell on the (4, 2) mesh (the batch over
    the whole mesh, every weight split over it): no all-reduce outputs a
    weight's shape.  The attention projections run per shard
    (``ctx.product``: each weight gathered for the microbatch, its
    gradient reduce-scattered back), as the FFN's did; left to DTensor,
    ``wq``/``wo`` and ``wk``/``wv`` gradients were all-reduced whole
    (minitron-4b's ``(3072, 3072)`` and ``(3072, 1024)``, 12.9 GB a
    device)."""
    cell = runs["port"]["cells"]["qwen3-0.6b/train_4k"]
    assert cell["profile"] == "dp"
    p = tfm_params("qwen3-0.6b")
    weights = {tuple(t.shape) for t in p.parameters() if t.ndim >= 2}
    whole = [(c, shape) for c, shape in cell["collective_shapes"]
             if c == "all-reduce" and tuple(shape) in weights]
    assert cell["collective_shapes"] and whole == [], whole


def test_2d_train_scatters_the_kv_heads_gradient(runs):
    """Smoke dbrx's ``2d`` train cell on the (2, 4) mesh: its 2 KV heads
    do not divide ``model=4``, so k's and v's columns, split over
    ``model`` by the projection, are gathered into whole heads for the
    head-split attention (``ctx.gather_heads``).  Their gradient, a
    partial sum over the ranks that read a head, is reduce-scattered
    straight back to the columns' split: no all-reduce outputs k's or
    v's heads (dbrx-132b's ``(2, 4096, 8, 128)``, 640 of them and 10.7
    GB a device on the card before)."""
    cell = runs["port"]["kv_2d"]
    assert cell["status"] == "ok" and cell["profile"] == "2d", cell
    cfg = _config("dbrx-132b")
    heads = (cfg.n_kv_heads, cfg.resolved_head_dim)
    reduced = [(c, shape) for c, shape in cell["collective_shapes"]
               if c == "all-reduce" and len(shape) == 4
               and tuple(shape[2:]) == heads]
    assert cell["collective_shapes"] and reduced == [], reduced
    width = cfg.n_kv_heads * cfg.resolved_head_dim // 4
    assert any(c == "reduce-scatter" and shape[-1] == width
               for c, shape in cell["collective_shapes"]), \
        cell["collective_shapes"]


def tfm_params(arch):
    from repro_torch.models import transformer as tfm
    return tfm.init_params(_config(arch), 0, device="meta")


@pytest.mark.parametrize("arch", DP_ARCHS)
def test_dp_collectives_stay_on_the_ranks_sequences(runs, arch):
    """A train cell under ``dp`` on the (2, 4) mesh, where the batch (16
    sequences, two a rank) and the embedding table's vocab both split
    over the whole mesh: no collective outputs a vocab-wide block of
    more sequences than the rank holds (the logits of other ranks'
    sequences: the tied output projection is gathered as FSDP gathers a
    weight), and none outputs the global batch's activations (the
    lookup's rows come back to their ranks by a reduce-scatter of the
    data group's); the FLOPs within FLOPS_REL of the reference's."""
    port, ref = runs["port"]["dp"][arch], runs["ref"]["dp", arch]
    assert port["status"] == ref["status"] == "ok"
    assert port["mesh"] == ref["mesh"] == {"data": 2, "model": 4}
    assert port["profile"] == "dp"
    from repro_torch.configs import get_config
    from repro_torch.models.config import smoke_config
    vocab = smoke_config(get_config(arch)).vocab_size
    crossing = [(cls, shape) for cls, shape in port["collective_shapes"]
                if len(shape) >= 3 and (shape[0] >= 16 or
                                        shape[0] > 2 and shape[-1] == vocab)]
    assert port["collective_shapes"] and crossing == [], crossing
    ratio = port["flops_per_device"] / ref["flops_per_device"]
    print(f"{arch} dp train_4k: port/reference FLOPs a device {ratio:.3f}")
    assert ratio == pytest.approx(1.0, rel=FLOPS_REL), ratio


@pytest.mark.parametrize("arch", DP_ARCHS)
def test_dp_train_collectives_near_the_reference(runs, arch):
    """The same cells' collective bytes a device at most DP_COLLECTIVES
    times the reference's (zamba2's Mamba2 layers per shard, their
    weights gathered and their gradients reduce-scattered back: the
    production cell read 34.1x while DTensor planned them)."""
    port, ref = runs["port"]["dp"][arch], runs["ref"]["dp", arch]
    coll = (port["collective_bytes_per_device"]
            / ref["collective_bytes_per_device"])
    print(f"{arch} dp train_4k: port/reference collective bytes {coll:.3f}")
    assert 0 < coll <= DP_COLLECTIVES, coll


@pytest.mark.parametrize("arch", ARCHS)
def test_train_products_match_the_reference(runs, arch):
    """A train cell's products: the port's matmul FLOPs and its kernel
    ops' (attention's q.k and p.v, the SSD scan's) within FLOPS_REL of
    the dots of the reference's compiled program: the MLP's products run
    per shard (``layers.swiglu``), each rank's own tokens against the
    gathered weights, as XLA runs them."""
    port, ref = _pair(runs, arch, "train_4k")
    products = port["xla_cost_analysis"]["flops"] + port["kernel_flops"]
    ratio = products / ref["dot_flops"]
    print(f"{arch} train_4k: port/reference product FLOPs a device "
          f"{ratio:.3f}")
    assert ratio == pytest.approx(1.0, rel=FLOPS_REL), ratio


def _table_shapes(cell, arch):
    from repro_torch.configs import get_config
    from repro_torch.models.config import smoke_config
    cfg = smoke_config(get_config(arch))
    v, d = cfg.vocab_size, cfg.d_model
    return {(v, d), (v, d // cell["mesh"]["data"])}


@pytest.mark.parametrize("cell", [f"{a}/{s}" for a in ARCHS for s in SHAPES]
                         + [f"{a}/decode_32k" for a in DECODE_EXTRA]
                         + ["split/prefill_32k", "split/decode_32k",
                            "zigzag/prefill_32k"])
def test_no_collective_gathers_the_embedding_table(runs, cell):
    """No collective of the embedding lookup (``transformer._lookup``,
    the collectives recorded while it runs) outputs the table's (V, D) or
    (V, D / data) shape: each rank looks tokens up in its own vocab rows,
    and no rank gathers the table's vocab split.  (The output projection
    of a model with tied embeddings is a product of its own: under
    ``dp`` it gathers the table as FSDP gathers a weight.)  Every cell's
    lookup moves something: tokens or rows."""
    group, shape = cell.split("/")
    port = (runs["port"]["split"][shape] if group == "split" else
            runs["port"]["zigzag"] if group == "zigzag" else
            runs["port"]["cells"][cell])
    arch = "qwen3-0.6b" if group in ("split", "zigzag") else group
    table = _table_shapes(port, arch)
    assert port["lookup_collectives"], port["collective_detail"]
    gathered = [s for s in port["lookup_collectives"] if tuple(s) in table]
    assert not gathered, (gathered, port["lookup_collectives"])


#: production lookups whose tokens split over two mesh dims: (mesh
#: sizes, table (V, D) and its placements, tokens' shape and placements,
#: the plan).  granite's ``dp`` train cell keeps no split (keeping D's
#: would gather 16 times the global batch's rows); the 2-pod Qwen3 decode
#: cell keeps both, its few tokens' rows cheaper than the table's slice.
NESTED_LOOKUPS = {
    "granite_dp_train": ((16, 16), (49155, 1536), ("S1", "S1"),
                         (256, 4096), ("S0", "S0"), ([], [])),
    "qwen3_2pod_decode": ((2, 16, 16), (151936, 1024), ("R", "S1", "S0"),
                          (128, 1), ("S0", "S0", "R"), ([2], [1]))}


@pytest.mark.parametrize("case", sorted(NESTED_LOOKUPS))
def test_lookup_plan_prices_a_nested_token_split(case):
    """``transformer._lookup_plan`` on the production cells' placements
    (as the dry run logs them) where another mesh dim splits the tokens
    beside one that keeps the table's D split: the plan by bytes, not a
    rule that never keeps such a split (that gathered the 2-pod decode
    cell's table slice, 1.2x its collective bytes)."""
    from types import SimpleNamespace

    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models import transformer as tfm
    sizes, v_d, p_emb, t_shape, p_tok, plan = NESTED_LOOKUPS[case]
    place = {"R": Replicate(), "S0": Shard(0), "S1": Shard(1)}
    mesh = SimpleNamespace(ndim=len(sizes), size=lambda i: sizes[i])
    emb = SimpleNamespace(device_mesh=mesh, shape=v_d,
                          placements=tuple(place[p] for p in p_emb))
    n = t_shape[0] * t_shape[1]
    tokens = SimpleNamespace(placements=tuple(place[p] for p in p_tok),
                             numel=lambda: n)
    assert tfm._lookup_plan(emb, tokens) == plan


#: production products on the (16, 16) mesh: (x's kinds on (data,
#: model), w's kinds, x's tokens, K, N, the plan).  ``T`` splits x's
#: tokens, ``K`` the contraction, ``N`` w's output, ``R`` is whole
#: (``ctx._kind``).
PRODUCTS = {
    # decode, 8 tokens a rank: internvl2's FFN gate keeps its D split
    # over data (the tokens move: an all-to-all and a reduce-scatter of
    # (128, 512) partials) and its F split over model
    "decode_moves_the_tokens": (("T", "R"), ("K", "N"), 128, 2048, 8192,
                                ("keep_k", "keep_n")),
    # a 4096-token microbatch a rank: the same weight gathered over data
    # (FSDP), F kept split over model (Megatron)
    "microbatch_gathers_w": (("T", "R"), ("K", "N"), 16 * 4096, 2048, 8192,
                             ("gather", "keep_n")),
    # Mamba2's in_proj in decode: x's D split over model by the norm's
    # scale, 3352 columns that do not divide model=16 (the weight whole
    # there): the tokens move over data, and model splits N unevenly
    # rather than run the whole product on each of its 16 ranks
    "uneven_in_proj": (("T", "K"), ("K", "R"), 128, 768, 3352,
                       ("keep_k", "keep_n")),
    # the same weight in a 32-sequence prefill's rows, 65536 a rank: D
    # gathered over data, N still split over model
    "prefill_in_proj": (("T", "K"), ("K", "R"), 32 * 32768, 768, 3352,
                        ("gather", "keep_n")),
    # one slot (long_500k): x whole on both dims, no rank repeats the
    # product: K stays split over data (an all-reduce of the partial
    # sums) and N over model
    "one_slot": (("R", "R"), ("K", "N"), 1, 2560, 10448,
                 ("keep_k", "keep_n"))}


@pytest.mark.parametrize("case", sorted(PRODUCTS))
def test_product_plan_moves_the_few_tokens_not_the_weights(case):
    """``ctx.plan_product`` on production products (placements as the
    dry run logs them): decode's few tokens move to the weights' splits,
    a training microbatch or a prefill gathers the weight (FSDP), and a
    width that does not divide ``model`` is split unevenly there, so no
    plan runs the product on every rank of a dim whose ranks hold the
    same tokens."""
    from repro_torch.parallel import ctx
    xk, wk, t, k, n, plan = PRODUCTS[case]
    xd = tuple(0 if kind == "T" else None for kind in xk)
    got = ctx.plan_product((16, 16), xk, wk, xd, t, k, n)
    assert got == plan
    assert ctx.product_cost(got, (16, 16), xk, wk, xd, t, k, n)[1] == 1
    if case == "uneven_in_proj":
        # the kept N split is a cut of the whole weight (210 columns a
        # rank, 202 on the last); gathering it there instead would run
        # the product on each of model's 16 ranks
        assert ctx.product_cost(("keep_k", "gather"), (16, 16), xk, wk, xd,
                                t, k, n)[1] == 16


@pytest.mark.parametrize("cell", [f"{a}/decode_32k"
                                  for a in ARCHS + DECODE_EXTRA]
                         + ["split/decode_32k"])
def test_decode_products_match_the_reference(runs, cell):
    """Decode's products: the FLOPs of the port's matmuls
    (``flop_registry``'s count, ``xla_cost_analysis``) within FLOPS_REL
    of the dots of the reference's compiled program, each loop body
    counted times its trips.  Each slot's layers run once, on the rank's
    own slots and its share of each weight, as XLA runs them (without the
    decode path's residual constraints DTensor ran the MLPs, and
    zamba2's Mamba2 projections, on the data group's whole batch)."""
    group, shape = cell.split("/")
    port = (runs["port"]["split"][shape] if group == "split"
            else runs["port"]["cells"][cell])
    ref = runs["ref"][group, shape]
    ratio = port["xla_cost_analysis"]["flops"] / ref["dot_flops"]
    print(f"{cell}: port/reference product FLOPs a device {ratio:.3f}")
    assert ratio == pytest.approx(1.0, rel=FLOPS_REL), ratio


@pytest.mark.parametrize("arch", DECODE_EXTRA)
def test_decode_extra_collectives_near_the_reference(runs, arch):
    """Smoke Mamba2's decode on the (4, 2) mesh: collective bytes a device
    at most DECODE_EXTRA_COLLECTIVES times the reference's (the output
    projection's D split kept, the few tokens moved to it; the head was
    gathered whole on every rank before)."""
    port, ref = _pair(runs, arch, "decode_32k")
    assert port["status"] == ref["status"] == "ok"
    coll = (port["collective_bytes_per_device"]
            / ref["collective_bytes_per_device"])
    print(f"{arch} decode_32k: port/reference collective bytes {coll:.3f}")
    assert 0 < coll <= DECODE_EXTRA_COLLECTIVES, coll


def test_data_parallel_step_reduces_every_gradient(runs):
    from repro_torch.configs import get_config
    from repro_torch.models.config import smoke_config
    cell = runs["port"]["cells"]["qwen3-0.6b/train_4k"]
    assert cell["profile"] == "dp"
    cfg = smoke_config(get_config("qwen3-0.6b"))
    param_bytes = cfg.n_params() * 4        # fp32 smoke parameters
    # the bytes the step's reductions sum (a reduce-scatter's input, as
    # each rank keeps only its shard of what it sums)
    reduced = cell["reduced_bytes"]
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


@pytest.mark.parametrize("cell", ["qwen3-0.6b/prefill_32k",
                                  "qwen3-0.6b/train_4k", "dp/gemma3-1b",
                                  "dp/zamba2-2.7b"])
def test_rotary_tables_hold_one_row_not_the_batch(runs, cell):
    """A prefill (8 sequences, 2 a rank) and ``dp`` train cells (16, 2 a
    rank): every cos and sin the traced rank computes is the rotary table
    of one row, (1, S, hd / 2), broadcast over the rank's rows
    (``transformer._positions``); with (B, S) positions each rank made
    the tables of the global batch, 1.5 of gemma3-1b's 1.94 GiB
    ``prefill_32k`` peak."""
    got = runs["port"]["dp"][cell[3:]] if cell.startswith("dp/") else \
        runs["port"]["cells"][cell]
    assert got["status"] == "ok"
    assert got["rope_shapes"], "no rotary table traced"
    assert all(shape[0] == 1 for shape in got["rope_shapes"]), \
        got["rope_shapes"]


def test_one_slot_decode_moves_only_the_ranks_slice_of_x(runs):
    """Smoke zamba2's ``long_500k`` (one slot, 1024 deep) on the (4, 2)
    mesh: x, split over ``model`` by the norm's scale, reaches each
    product without an all-gather of its D; where a weight keeps its K
    split over ``data`` the rank's range comes from the ``model`` rank
    that holds it, by one all-to-all (``ctx.slice_holder``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import smoke_config
    cell = runs["port"]["long"]
    assert cell["status"] == "ok", cell.get("error")
    assert cell["products"] > 0
    assert cell["x_gathers"] == [], cell["x_gathers"]
    d = smoke_config(get_config("zamba2-2.7b")).d_model
    assert ["all-to-all", [d // 4, 1, 1]] in cell["collective_shapes"], \
        cell["collective_shapes"]


def test_2d_train_loss_gathers_no_logits(runs):
    """Smoke dbrx's ``2d`` train cell on the (2, 4) mesh, whose logits
    split their vocab over ``model``: the loss's collectives are
    all-reduces of a number or two a row (the max, the sum of
    exponentials and the label's logit, ``layers._logsumexp``), none
    with a vocab dim; DTensor's ``logsumexp`` gathered the data group's
    rows of the rank's vocab slice (dbrx-132b: (32, 4096, 6272) fp32 a
    microbatch)."""
    cell = runs["port"]["kv_2d"]
    assert cell["status"] == "ok", cell.get("error")
    got = cell["loss_collectives"]
    assert got, "no collective in the loss"
    for cls, shape in got:
        assert cls == "all-reduce", got
        assert len(shape) == 2 or shape[-1] == 1, got


def _collective_graph(target, args, out):
    import torch
    import torch.fx
    g = torch.fx.Graph()
    node = g.call_function(target, tuple(g.placeholder(f"in{i}")
                                         for i in range(len(args))))
    for ph, val in zip(g.nodes, args):
        ph.meta["val"] = val
    node.meta["val"] = out
    g.output((node,))
    return g


#: one collective each on a group of 4, x (8, 16) fp32: (class, op, the
#: op's input, its output); the dry run counts the output's bytes, as
#: the reference's ``hlo_analysis`` counts each collective's
COUNTS = {
    "all-gather": ("all_gather_into_tensor", (8, 16), (32, 16)),
    "reduce-scatter": ("reduce_scatter_tensor", (8, 16), (2, 16)),
    "all-reduce": ("all_reduce", (8, 16), (8, 16)),
    "all-to-all": ("all_to_all_single", (8, 16), (8, 16)),
}


@pytest.mark.parametrize("cls", sorted(COUNTS))
def test_a_collective_counts_its_output_bytes(cls):
    """The count every dry-run gate holds (``hlo_analysis``'s docstring):
    a collective's output bytes, once (an all-reduce once, not twice; a
    reduce-scatter at its output, not its input), and nothing else."""
    import torch
    import torch.distributed  # noqa: F401  (registers the c10d ops)
    from repro_torch.launch import hlo_analysis
    name, shape_in, shape_out = COUNTS[cls]
    target = getattr(torch.ops._c10d_functional, name).default
    assert hlo_analysis.collective_class(target) == cls
    x = torch.empty(shape_in, device="meta")
    out = torch.empty(shape_out, device="meta")
    cost = hlo_analysis.graph_cost(_collective_graph(target, [x], out))
    assert cost.coll == {c: (out.numel() * 4 if c == cls else 0.0)
                         for c in hlo_analysis.COLLECTIVES}
    assert cost.coll_counts[cls] == 1
    assert cost.flops == 0


def test_refuses_a_real_process_group(runs):
    assert "fake process group" in runs["port"]["refused"]
