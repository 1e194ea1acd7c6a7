"""Roofline terms read from the traced per-rank graph (port of
``repro.launch.hlo_analysis``).

  compute    = FLOPs / 989e12 (H100 SXM, dense bf16)
  memory     = bytes / 3.35e12 (HBM3)
  collective = collective bytes / 50e9 (one GPU's NDR InfiniBand link)

per device (``core.devices.ROOFLINE_*``, datasheet values).

The reference walks the optimized per-device HLO text that XLA's SPMD
partitioner leaves.  The port has no HLO: it reads the FX graph of one
rank's step, which :func:`trace` records while the step runs once on
the rank's state (``launch.dryrun``: DTensors on a fake process group
whose local tensors live on the ``meta`` device, so nothing is
allocated and no kernel launches).  A dispatch mode below DTensor
appends one ``torch.fx`` node for every aten op and functional
collective that reaches the rank's local tensors: the forward, the
backward autograd runs (with remat's recompute), the optimizer and every
redistribution DTensor chose, in the order they ran, as one graph.  So
every count is per device, as the reference's are, and no op can run
outside the graph.  DTensor's sharding propagation runs ops of the
global shapes on FakeTensors (and meta kernels under them); those are
not the rank's and are not recorded.

Two other capture routes were tried and not kept: ``torch.compile``
with a backend that keeps the AOTAutograd graphs breaks the graph at
``torch.autograd.grad`` and at host reads, and in torch 2.13 the
compiled backward of a DTensor forward split by a break fails (a missing
tangent); ``make_fx`` records the same program but takes about twice
the eager run's time.

The walker:

  * FLOPs: ``torch.utils.flop_counter``'s formulas (``flop_registry``)
    for the aten ops it knows (matmuls, convolutions, attention); the
    port's kernel ops (``repro_torch::flash_attention``,
    ``repro_torch::ssd``) as ``core.costmodel`` counts them; 1 FLOP per
    output element of elementwise, reduction, scatter and sort ops, the
    reference's rule for its fusions and reduces;
  * bytes: operands + outputs of every node that materializes; views,
    ``getitem``, ``wait_tensor``, bare allocations and placeholders are
    free (the reference's ``_FREE_OPS``).  The port runs eager, one
    kernel an op, so this unfused count is its real traffic model; no
    fusion is imitated;
  * collectives: each ``_c10d_functional`` node's output bytes by class
    (:data:`COLLECTIVES`), as the reference counts them;
  * peak bytes a device: the high-water mark of live storage over the
    graph, each storage live from the node that makes it to the last node
    that reads it, the step's inputs (the state) and outputs live
    throughout, a collective's output at its own bytes (the card's op
    allocates its own; a fake kernel may return a view of more), and its
    wait's and autograd wrapper's outputs as that same storage (the
    card's ops allocate nothing; their fakes return new tensors).  Python
    may hold a tensor past its last read, so this is a floor of what the
    eager step holds.

Which count a gate holds.  Every gate on a dry-run cell (``chip_smoke.py``
phase 20, ``tests/test_torch_dryrun.py``) holds the count above: each
collective's output bytes a device, by class, as the reference's
``hlo_analysis`` counts them (an all-reduce and a reduce-scatter once
each, at their output's bytes).  The product planner
(``parallel.ctx.product_cost``) prices another quantity, the elements a
rank receives; the two may rank two plans differently, and only this
count is compared with the reference's.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.fx
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import costmodel
from repro_torch.core.devices import (ROOFLINE_HBM_BW, ROOFLINE_LINK_BW,
                                      ROOFLINE_PEAK_FLOPS)

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: the namespaces of torch.distributed's collectives (``_dtensor``:
#: DTensor's all-to-all between two shardings of a tensor)
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "c10d", "_dtensor")
#: collective class by a substring of the op's name (send, recv and a
#: rooted broadcast are point-to-point transfers: XLA's permutes)
_COLLECTIVE_OF = (("all_gather", "all-gather"), ("all_reduce", "all-reduce"),
                  ("reduce_scatter", "reduce-scatter"),
                  ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
                  ("broadcast", "collective-permute"),
                  ("send", "collective-permute"),
                  ("recv", "collective-permute"),
                  ("permute", "collective-permute"))

#: aten ops that touch no memory on their own: views and bookkeeping
#: (schema views are found by ``OpOverload.is_view``), and allocations
#: that write nothing
_FREE_OPS = {
    "view", "_unsafe_view", "t", "transpose", "permute", "expand",
    "detach", "alias", "split", "split_with_sizes", "unbind", "squeeze",
    "unsqueeze", "select", "slice", "as_strided", "diagonal",
    "lift_fresh", "wait_tensor", "_wrap_tensor_autograd", "empty",
    "empty_like", "empty_strided",
    "new_empty", "new_empty_strided", "_local_scalar_dense",
}

#: aten ops priced at 1 FLOP per output element beside the pointwise ones
#: (reductions, scatters, sorts: the reference's ``reduce*``,
#: ``scatter``, ``select-and-scatter`` and ``sort``)
_PER_OUTPUT = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "std",
    "var_mean", "std_mean", "norm", "linalg_vector_norm", "logsumexp",
    "any", "all", "argmax", "argmin", "cumsum", "cumprod",
    "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "nll_loss_forward", "nll_loss_backward",
    "index_put", "_index_put_impl", "scatter", "scatter_add",
    "scatter_reduce", "index_add", "embedding_dense_backward",
    "masked_scatter", "sort", "topk",
}


def _packet(target) -> str:
    return costmodel.packet_name(target)


def _base_name(target) -> str:
    """The op's name with an in-place trailing ``_`` dropped."""
    name = _packet(target)
    return name[:-1] if name.endswith("_") and not name.startswith("_") \
        else name


def collective_class(target) -> Optional[str]:
    """The :data:`COLLECTIVES` class of a collective op, else None."""
    if getattr(target, "namespace", None) not in _COLLECTIVE_NAMESPACES:
        return None
    name = _packet(target)
    for key, cls in _COLLECTIVE_OF:
        if key in name:
            return cls
    return None


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(x) -> float:
    return float(sum(t.numel() * t.element_size() for t in _tensors(x)))


def _numel(x) -> float:
    return float(sum(t.numel() for t in _tensors(x)))


# ---------------------------------------------------------------------------
# Capture: the rank's step as an FX graph
# ---------------------------------------------------------------------------
def _is_subclass_dispatch(types) -> bool:
    """Whether a wrapper subclass (DTensor) takes the call first: the
    recorder sees the local ops it then runs."""
    return any(hasattr(t, "__tensor_flatten__") for t in types)


class _Recorder(TorchDispatchMode):
    """Appends one node a call on the rank's local (``meta``) tensors."""

    def __init__(self):
        super().__init__()
        self.graph = torch.fx.Graph()
        self._node: Dict[int, torch.fx.Node] = {}
        self._n_inputs = 0

    def placeholder(self, t: torch.Tensor) -> torch.fx.Node:
        node = self._node.get(id(t))
        if node is None:
            node = self.graph.placeholder(f"in{self._n_inputs}")
            self._n_inputs += 1
            node.meta["val"] = t
            self._node[id(t)] = node
        return node

    def _arg(self, x):
        if isinstance(x, torch.Tensor):
            return self.placeholder(x)
        if isinstance(x, (list, tuple)):
            return type(x)(self._arg(v) for v in x)
        return x

    def _record(self, func, args, kwargs, out) -> None:
        node = self.graph.call_function(func, self._arg(tuple(args)),
                                        {k: self._arg(v)
                                         for k, v in kwargs.items()})
        node.meta["val"] = out
        if isinstance(out, torch.Tensor):
            self._node[id(out)] = node
        elif isinstance(out, (list, tuple)):
            for i, t in enumerate(out):
                if isinstance(t, torch.Tensor):
                    item = self.graph.call_function(operator.getitem,
                                                    (node, i))
                    item.meta["val"] = t
                    self._node[id(t)] = item

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _is_subclass_dispatch(types):
            return NotImplemented
        out = func(*args, **kwargs)
        if torch._C._meta_in_tls_dispatch_include():
            return out       # inside a FakeTensor's meta kernel
        from torch._subclasses.fake_tensor import FakeTensor
        seen = _tensors(args) + _tensors(kwargs) + _tensors(out)
        if seen and all(t.is_meta and not isinstance(t, FakeTensor)
                        for t in seen):
            self._record(func, args, kwargs, out)
        return out


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if hasattr(t, "_local_tensor") else t


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a step's state or output tree (dataclasses, dicts,
    lists, tuples, modules' parameters), DTensors as their local
    tensors."""
    if isinstance(tree, torch.Tensor):
        return [_local(tree)]
    if isinstance(tree, torch.nn.Module):
        return [_local(p) for p in tree.parameters()]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return []


def trace(fn, *args, **kwargs) -> Tuple[torch.fx.GraphModule, Any]:
    """Run ``fn(*args, **kwargs)`` once and record the rank's program:
    (its graph, ``fn``'s output).  The tensors of ``args`` (their local
    tensors, for DTensors) are the graph's placeholders and those of the
    output its outputs.  Only calls on ``meta`` tensors are recorded, so
    the state's local tensors must be on ``meta``."""
    rec = _Recorder()
    for t in leaves((args, kwargs)):
        rec.placeholder(t)
    with rec:
        out = fn(*args, **kwargs)
    rec.graph.output(tuple(rec._node[id(t)] for t in leaves(out)
                           if id(t) in rec._node))
    return torch.fx.GraphModule(torch.nn.Module(), rec.graph), out


# ---------------------------------------------------------------------------
# The walker
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in COLLECTIVES})
    coll_counts: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in COLLECTIVES})
    #: the FLOPs ``torch.utils.flop_counter``'s formulas alone count
    registry_flops: float = 0.0


def _vals(x):
    """Node args with each node replaced by its recorded value."""
    if isinstance(x, torch.fx.Node):
        return x.meta.get("val")
    if isinstance(x, (list, tuple)):
        return type(x)(_vals(v) for v in x)
    if isinstance(x, dict):
        return {k: _vals(v) for k, v in x.items()}
    return x


def _is_free(target) -> bool:
    if target is operator.getitem:
        return True
    if getattr(target, "namespace", None) == "prim":
        return True
    return _base_name(target) in _FREE_OPS or \
        bool(getattr(target, "is_view", False))


def node_flops(target, args, kwargs, out) -> Tuple[float, float]:
    """(FLOPs, the part of them ``flop_registry`` counts) of one call."""
    from torch.utils.flop_counter import flop_registry
    if getattr(target, "namespace", None) == "repro_torch":
        return costmodel.op_cost(target, args, out)[0].flops, 0.0
    packet = getattr(target, "overloadpacket", None)
    if packet in flop_registry:
        n = float(flop_registry[packet](*args, **kwargs, out_val=out))
        return n, n
    if torch.Tag.pointwise in getattr(target, "tags", ()) or \
            _base_name(target) in _PER_OUTPUT:
        return _numel(out), 0.0
    return 0.0, 0.0


def graph_cost(graphs) -> Cost:
    """FLOPs, bytes and collective bytes of one graph or a sequence of
    them (each a ``GraphModule`` or a ``Graph``)."""
    cost = Cost()
    for g in _graphs(graphs):
        for node in g.nodes:
            if node.op != "call_function" or _is_free(node.target):
                continue
            args, kwargs = _vals(node.args), _vals(node.kwargs)
            out = node.meta.get("val")
            moved = _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
            cls = collective_class(node.target)
            if cls is not None:
                cost.coll[cls] += _nbytes(out)
                cost.coll_counts[cls] += 1
                cost.bytes += moved
                continue
            flops, reg = node_flops(node.target, args, kwargs, out)
            cost.flops += flops
            cost.registry_flops += reg
            cost.bytes += moved
    return cost


def _graphs(graphs) -> List[torch.fx.Graph]:
    if isinstance(graphs, (torch.fx.GraphModule, torch.fx.Graph)):
        graphs = [graphs]
    return [g.graph if isinstance(g, torch.fx.GraphModule) else g
            for g in graphs]


#: ops whose real kernel returns its first input, or a wrapper of it,
#: while their fake (meta) kernel returns a new tensor: a collective's
#: wait, and the wrapper that gives a functional collective's output to
#: autograd (``_c10d_functional._wrap_tensor_autograd``, whose fake is
#: ``empty_like``)
_ALIAS_OPS = {"wait_tensor", "_wrap_tensor_autograd"}


def _storage(t: torch.Tensor) -> Tuple[int, float]:
    st = t.untyped_storage()
    return st._cdata, float(st.nbytes())


def _live_ranges(graphs):
    """Each storage of the graphs run in order as (first node, last node,
    bytes, the node that first holds it), by storage key, and the node
    count: a storage is live from the node that first holds it through
    the last node that reads it (so a node's inputs and output are live
    together); placeholders and outputs live throughout.

    A storage that a collective makes is charged at its outputs' own
    bytes (numel times element size), not the storage's: the card's op
    returns a tensor of its own, but the fake kernel that a traced step
    runs may return a view of a larger one (torch's
    ``_dtensor::shard_dim_alltoall`` fake concatenates the group's
    copies of its input and narrows them, so its output's storage is
    ``group_size`` times the output).  An ordinary view still shares,
    and is charged with, its base; so does the output of an op of
    :data:`_ALIAS_OPS`, which the card's kernel returns without
    allocating (their fakes make a new storage, so every functional
    collective's output was held two or three times)."""
    first: Dict[int, int] = {}
    last: Dict[int, int] = {}
    size: Dict[int, float] = {}
    made: Dict[int, torch.fx.Node] = {}
    alias: Dict[int, int] = {}

    def key_of(t):
        key = _storage(t)[0]
        return alias.get(key, key)
    nodes: List[torch.fx.Node] = [n for g in _graphs(graphs)
                                  for n in g.nodes]
    end = len(nodes)
    for pos, node in enumerate(nodes):
        if node.op == "output":
            for t in _tensors(_vals(node.args)):
                last[key_of(t)] = end
            continue
        own = node.op == "call_function" and \
            collective_class(node.target) is not None
        if node.op == "call_function" and getattr(
                node.target, "namespace", None) in _COLLECTIVE_NAMESPACES \
                and _base_name(node.target) in _ALIAS_OPS:
            src = _tensors(_vals(node.args))
            if src:
                for t in _tensors(node.meta.get("val")):
                    if _storage(t)[0] not in first:
                        alias[_storage(t)[0]] = key_of(src[0])
        for t in _tensors(node.meta.get("val")):
            key, n = key_of(t), _storage(t)[1]
            if key not in first:
                first[key] = 0 if node.op == "placeholder" else pos
                size[key] = 0.0 if own else n
                made[key] = node
                last[key] = end if node.op == "placeholder" else pos
            if own and made[key] is node:
                size[key] = min(size[key] + _nbytes(t), n)
        for t in _tensors(_vals(node.args)) + _tensors(_vals(node.kwargs)):
            key = key_of(t)
            if key in last:
                last[key] = max(last[key], pos)
    return {k: (first[k], last[k], size[k], made[k]) for k in first}, end


def _peak(ranges, end: int) -> Tuple[float, int]:
    """(the high-water mark of live storage, the first node at it)."""
    delta = [0.0] * (end + 2)
    for start, stop, n, _ in ranges.values():
        delta[start] += n
        delta[stop + 1] -= n
    live = peak = 0.0
    at = 0
    for pos, d in enumerate(delta):
        live += d
        if live > peak:
            peak, at = live, pos
    return peak, at


def peak_bytes(graphs) -> float:
    """The high-water mark of live storage over the graphs run in order
    (:func:`_live_ranges`)."""
    return _peak(*_live_ranges(graphs))[0]


def live_at_peak(graphs) -> Tuple[float, List[tuple]]:
    """(the peak of :func:`peak_bytes`, the storages live at it as (bytes
    charged, the op that made it, its output's shape, that output's own
    bytes, the storage's bytes), largest first): what holds the peak.
    The step's inputs (the state) read as ``placeholder``; an output
    whose own bytes are fewer than its storage's is a view of a larger
    storage (charged whole, unless a collective made it)."""
    ranges, end = _live_ranges(graphs)
    peak, at = _peak(ranges, end)
    live = []
    for key, (start, stop, n, node) in ranges.items():
        if start <= at <= stop:
            val = [t for t in _tensors(node.meta.get("val"))
                   if _storage(t)[0] == key]
            shape = tuple(val[0].shape) if val else ()
            op = "placeholder" if node.op == "placeholder" else \
                str(node.target)
            live.append((n, op, shape, _nbytes(val),
                         _storage(val[0])[1] if val else n))
    return peak, sorted(live, key=lambda r: -r[0])


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    chips: int
    collective_detail: Dict[str, float]
    collective_counts: Dict[str, float]
    #: the reference's ``xla_cost_analysis``: the library's own count of
    #: the same program (here ``flop_registry``'s FLOPs alone)
    xla_cost_analysis: Dict[str, float]
    peak_bytes_per_device: Optional[float] = None

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / ROOFLINE_PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / ROOFLINE_HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / ROOFLINE_LINK_BW

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bound": self.bound,
            "step_s": self.step_s,
            "collective_detail": self.collective_detail,
            "collective_counts": self.collective_counts,
            "xla_cost_analysis": self.xla_cost_analysis,
            "peak_bytes_per_device": self.peak_bytes_per_device,
        }


def analyze(graphs, chips: int) -> Roofline:
    """The roofline of a rank's traced step (one graph or several, run in
    order) on a mesh of ``chips`` devices."""
    cost = graph_cost(graphs)
    return Roofline(
        flops_per_device=cost.flops, bytes_per_device=cost.bytes,
        collective_bytes_per_device=sum(cost.coll.values()), chips=chips,
        collective_detail=dict(cost.coll),
        collective_counts=dict(cost.coll_counts),
        xla_cost_analysis={"flops": cost.registry_flops,
                           "bytes_accessed": cost.bytes},
        peak_bytes_per_device=peak_bytes(graphs))
