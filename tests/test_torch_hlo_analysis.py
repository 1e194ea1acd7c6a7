"""The port's roofline walker (``repro_torch.launch.hlo_analysis``) on
programs of known cost: the reference's six cases
(``tests/test_hlo_analysis.py``) restated on the traced FX graph.

The reference compiles each program with ``jax.jit`` and walks its HLO;
here each is traced once by ``hlo_analysis.trace`` on ``meta`` tensors
(nothing allocated or computed).  A Python loop stands in for
``lax.scan``: the graph records every trip, so the trip-count weighting
the reference needs is implicit, and the tolerances are the reference's
(rel 0.05 for the loop and the matmul, 0.1 for bytes and the nested
loop).  Where the reference shows that XLA's own cost analysis
undercounts a scan, the port shows that ``torch.utils.flop_counter``'s
``FlopCounterMode`` over a step on DTensors reads the global op while
the walker reads the rank's.  The fake-mesh cases run in one subprocess
(``torch.distributed``'s fake backend: one default group a process, and
xdist workers are shared).
"""

import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.core import devices
from repro_torch.launch import hlo_analysis

ROOT = Path(__file__).resolve().parents[1]


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def cost_of(fn, *args):
    graph, _ = hlo_analysis.trace(fn, *args)
    return hlo_analysis.graph_cost(graph)


def test_loop_trips_are_each_counted():
    def g(w, x):
        c = x
        for _ in range(28):
            c = torch.tanh(c @ w)
        return c.sum()
    cost = cost_of(g, meta(512, 512), meta(512, 512))
    assert cost.flops == pytest.approx(28 * 2 * 512 ** 3, rel=0.05)
    assert cost.registry_flops == 28 * 2 * 512 ** 3


def test_plain_matmul_flops():
    cost = cost_of(lambda a, b: a @ b, meta(256, 384, dtype=torch.bfloat16),
                   meta(384, 128, dtype=torch.bfloat16))
    assert cost.flops == pytest.approx(2 * 256 * 384 * 128, rel=0.05)


def test_bytes_scale_with_dtype():
    def f(x):
        return x * 2.0 + 1.0
    b16 = cost_of(f, meta(1024, 1024, dtype=torch.bfloat16)).bytes
    b32 = cost_of(f, meta(1024, 1024)).bytes
    assert b32 == pytest.approx(2 * b16, rel=0.1)


def test_nested_loops_multiply():
    def g(x):
        for _ in range(5):
            for _ in range(3):
                x = torch.tanh(x @ x)
        return x.sum()
    cost = cost_of(g, meta(128, 128))
    assert cost.flops == pytest.approx(15 * 2 * 128 ** 3, rel=0.1)


def test_roofline_terms_and_bound():
    r = hlo_analysis.Roofline(
        flops_per_device=989e12, bytes_per_device=3.35e12 / 2,
        collective_bytes_per_device=50e9 * 3, chips=256,
        collective_detail={}, collective_counts={}, xla_cost_analysis={})
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(0.5)
    assert r.collective_s == pytest.approx(3.0)
    assert r.bound == "collective"
    assert r.step_s == pytest.approx(3.0)


def test_roofline_constants_are_chip_smokes():
    """The dry run's peaks are the ones chip_smoke.py bounds kernels by
    (datasheet values of the H100 SXM at 700 W), and no TPU value."""
    text = (ROOT / "chip_smoke.py").read_text()

    def const(name):
        return float(re.search(rf"^{name} = ([0-9.e]+)", text, re.M)
                     .group(1))
    assert devices.ROOFLINE_PEAK_FLOPS == const("BF16_PEAK_FLOPS") == 989e12
    assert devices.ROOFLINE_HBM_BW == const("HBM_BYTES_PER_S") == 3.35e12
    assert devices.ROOFLINE_LINK_BW == 50e9


def test_peak_bytes_hold_inputs_and_the_widest_step():
    """Live storage: both inputs throughout, and at each matmul its input
    and its output together (4 MiB for two 1 MiB inputs)."""
    def g(w, x):
        c = x
        for _ in range(3):
            c = torch.tanh(c @ w)
        return c
    graph, _ = hlo_analysis.trace(g, meta(512, 512), meta(512, 512))
    assert hlo_analysis.peak_bytes(graph) == 4 * 2 ** 20


def _all_to_all_view(target):
    """A graph of x (4, 3, 8) fp32 -> ``target``'s node, whose output (2,
    3, 16) is a view of a (4, 3, 16) storage, as the fake kernel of
    ``_dtensor::shard_dim_alltoall`` makes it on a group of 2 (the
    group's copies of x concatenated on dim 2, dim 0 narrowed) -> its
    negation, the graph's output: the node's storage, and a read of it."""
    g = torch.fx.Graph()
    x = g.placeholder("x")
    x.meta["val"] = meta(4, 3, 8)
    node = g.call_function(target, (x,))
    node.meta["val"] = meta(4, 3, 16).narrow(0, 0, 2)
    neg = g.call_function(torch.ops.aten.neg.default, (node,))
    neg.meta["val"] = meta(2, 3, 16)
    g.output((neg,))
    return g


@pytest.mark.parametrize("collective", [True, False],
                         ids=["collective", "view_of_an_op"])
def test_a_collectives_output_is_charged_at_its_own_bytes(collective):
    """A collective's output that is a view of a larger storage (the fake
    all-to-all's) is charged at its own 384 bytes, as the card's op
    allocates it; an ordinary op's view shares, and is charged with,
    its whole 768-byte storage.  x and the negation are 384 bytes each,
    live beside it at the negation."""
    import torch.distributed.tensor  # noqa: F401  (registers _dtensor)
    target = torch.ops._dtensor.shard_dim_alltoall.default if collective \
        else torch.ops.aten.cat.default
    graph = _all_to_all_view(target)
    held = 384 if collective else 768
    assert hlo_analysis.peak_bytes(graph) == 384 + held + 384
    peak, live = hlo_analysis.live_at_peak(graph)
    assert (held, str(target), (2, 3, 16), 384, 768) in live


def test_a_collectives_wait_and_autograd_wrapper_share_its_storage():
    """x (4, 16) fp32 -> an all-gather (32, 16) -> the wrapper that gives
    it to autograd -> its wait -> the sum of the wait's output and the
    gather's: the wrapper's and the wait's fakes each return a new
    tensor, but the card's ops return the gather's own (or a wrapper of
    it), so three storages (x, the gather, the sum) and a peak of 256 +
    2048 + 2048 bytes, not the two or three copies of the gather that
    the fakes' storages would hold at the sum."""
    import torch.distributed._functional_collectives  # noqa: F401
    ops = torch.ops._c10d_functional
    chain = [ops.all_gather_into_tensor.default]
    if hasattr(ops, "_wrap_tensor_autograd"):
        chain.append(ops._wrap_tensor_autograd.default)
    chain.append(ops.wait_tensor.default)
    g = torch.fx.Graph()
    node = g.placeholder("x")
    node.meta["val"] = meta(4, 16)
    made = []
    for target in chain:
        node = g.call_function(target, (node,))
        node.meta["val"] = meta(32, 16)
        made.append(node)
    add = g.call_function(torch.ops.aten.add.Tensor, (node, made[0]))
    add.meta["val"] = meta(32, 16)
    g.output((add,))
    assert len(hlo_analysis._live_ranges(g)[0]) == 3
    assert hlo_analysis.peak_bytes(g) == 256 + 2048 + 2048
    # and they move no bytes of their own: the gather's and the sum's
    # operands and outputs
    assert hlo_analysis.graph_cost(g).bytes == (256 + 2048) + 3 * 2048


#: two gloo ranks: the real ``_dtensor::shard_dim_alltoall`` (x (4, 3, 8)
#: split on dim 2, out split on dim 0), then its fake on the same input
_ALLTOALL_RANK = textwrap.dedent("""
    import json, sys
    import torch, torch.distributed as dist
    import torch.distributed.tensor  # registers the _dtensor ops
    from torch._subclasses.fake_tensor import FakeTensorMode
    rank, where = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", store=dist.FileStore(where, 2),
                            rank=rank, world_size=2)
    group = dist.group.WORLD.group_name
    x = torch.arange(96, dtype=torch.float32).reshape(4, 3, 8) + 100 * rank
    out = torch.ops._dtensor.shard_dim_alltoall(x, 2, 0, group)
    want = torch.cat([torch.arange(96, dtype=torch.float32).reshape(4, 3, 8)
                      [2 * rank:2 * rank + 2] + 100 * r for r in range(2)],
                     2)
    with FakeTensorMode() as mode:
        fake = torch.ops._dtensor.shard_dim_alltoall(mode.from_tensor(x), 2,
                                                     0, group)
    print(json.dumps({
        "shape": list(out.shape), "right": bool(out.equal(want)),
        "own": out.numel() * out.element_size(),
        "storage": out.untyped_storage().nbytes(),
        "fake_shape": list(fake.shape),
        "fake_storage": fake.untyped_storage().nbytes()}))
    dist.destroy_process_group()
""")


def test_the_real_all_to_all_returns_its_own_storage(tmp_path):
    """On 2 gloo ranks the real ``shard_dim_alltoall`` returns a tensor of
    its own, 384 bytes, where its fake returns a view of a 768-byte
    storage: so the dry run charges a collective's output at its own
    bytes (:func:`hlo_analysis._live_ranges`).  Fails if torch's real op
    comes to return a view of the group's rows."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _ALLTOALL_RANK, str(r),
         str(tmp_path / "store")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env) for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    for out, _ in outs:
        got = json.loads(out.strip().splitlines()[-1])
        assert got["shape"] == got["fake_shape"] == [2, 3, 16]
        assert got["right"]
        assert got["storage"] == got["own"] == 384
        assert got["fake_storage"] == 768


#: the fake-mesh cases, each printing one JSON line
_MESH_CASES = textwrap.dedent("""
    import json, sys
    import torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import hlo_analysis

    def dt(local, mesh, placements, shape):
        return DTensor.from_local(torch.empty(local, device="meta"), mesh,
                                  placements, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=torch.empty(shape).stride())

    out = {}
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("d",))

    # the 28-trip loop on a batch split 8 ways: the walker reads the
    # rank's 64 rows, FlopCounterMode the global op
    def loop(w, x):
        c = x
        for _ in range(28):
            c = torch.tanh(c @ w)
        return c.sum()
    x = dt((64, 512), mesh, [Shard(0)], (512, 512))
    w = dt((512, 512), mesh, [Replicate()], (512, 512))
    graph, _ = hlo_analysis.trace(loop, w, x)
    counter = FlopCounterMode(display=False)
    with counter:
        loop(w, x)
    out["rank_flops"] = hlo_analysis.graph_cost(graph).flops
    out["counter_flops"] = counter.get_total_flops()

    # x.sum(0) of a (64, 1024) fp32 batch split 8 ways, replicated
    x = dt((8, 1024), mesh, [Shard(0)], (64, 1024))
    graph, _ = hlo_analysis.trace(
        lambda t: t.sum(0).redistribute(mesh, [Replicate()]), x)
    cost = hlo_analysis.graph_cost(graph)
    out["coll"] = cost.coll
    dist.destroy_process_group()

    # the motivating case on a (16, 16) mesh of 256 ranks: A (4096, 8192)
    # [Shard(0), Replicate()] @ W (8192, 8192) [Replicate(), Shard(0)]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("a", "b"))
    a = dt((256, 8192), mesh, [Shard(0), Replicate()], (4096, 8192))
    w = dt((512, 8192), mesh, [Replicate(), Shard(0)], (8192, 8192))
    graph, _ = hlo_analysis.trace(lambda a, w: a @ w, a, w)
    out["mm_flops"] = hlo_analysis.graph_cost(graph).registry_flops
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def mesh_cases():
    out = subprocess.run(
        [sys.executable, "-c", _MESH_CASES], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_walker_reads_the_ranks_op_not_the_global_one(mesh_cases):
    global_flops = 28 * 2 * 512 ** 3
    assert mesh_cases["rank_flops"] == pytest.approx(global_flops / 8,
                                                     rel=0.05)
    # DTensor's global op as the counter sees it (it may also see the
    # local one beneath, as it did in torch 2.13)
    assert mesh_cases["counter_flops"] >= 0.95 * global_flops


def test_a_ranks_matmul_on_a_256_rank_mesh(mesh_cases):
    assert mesh_cases["mm_flops"] == 2 * 256 * 512 * 8192


def test_collective_bytes_on_an_8_rank_mesh(mesh_cases):
    total = sum(mesh_cases["coll"].values())
    assert total >= 1024 * 4, mesh_cases["coll"]   # one (1024,) f32 reduce
    assert mesh_cases["coll"]["all-reduce"] >= 1024 * 4
