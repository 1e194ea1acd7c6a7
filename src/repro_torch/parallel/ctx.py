"""Mesh context for interior sharding constraints (port of
``repro.parallel.ctx``).

Model code calls ``constrain(x, 'axis0', 'axis1', ...)`` to hint
activation shardings (MoE dispatch buffers, attention activations).
Outside a mesh context (unit tests, single-device runs) it returns ``x``
unchanged; inside, axes missing from the mesh or non-divisible dims
degrade to None exactly as in the reference, so the same model code runs
on any mesh shape.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose dim names
are the reference's axis names (``pod``, ``data``, ``model``); the rules
also read a duck-typed mesh with a ``shape`` dict and ``axis_names``, as
the reference's tests do.  Where the reference hands
``with_sharding_constraint`` a ``PartitionSpec``, ``constrain``
redistributes a ``DTensor`` to the placements that spec gives
(:func:`repro_torch.parallel.sharding.placements`).  Inside a mesh a
plain tensor raises: an activation that escaped sharding is a fault, not
something to hint.

``use_mesh`` also turns on DTensor's implicit replication: the model's
constants (positions, masks, rope tables, running softmax state) are
plain tensors made on the device, and every rank makes the same ones, so
DTensor may treat them as replicated.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import math
import sys
import threading
from typing import Any, Dict, Optional, Tuple

import torch

_state = threading.local()


def current_mesh() -> Optional[Any]:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate ``mesh`` for ``constrain`` calls (and DTensor's implicit
    replication of the model's plain constants)."""
    from torch.distributed.tensor.experimental import implicit_replication
    register_kernel_rules()
    prev = current_mesh()
    _state.mesh = mesh
    try:
        with implicit_replication():
            yield mesh
    finally:
        _state.mesh = prev


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor, which no
    tensor can be before it is imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def local_shards(tensors, mesh, placements_of) -> list:
    """Each of ``tensors`` (None passes through) redistributed on ``mesh``
    to the placements ``placements_of(i)`` gives it, as its local tensor;
    a plain tensor (autograd's zeros for an unused output) is taken as
    replicated, as implicit replication takes it."""
    from torch.distributed.tensor import DTensor, Replicate
    out = []
    for i, t in enumerate(tensors):
        if t is not None and not is_dtensor(t):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        out.append(None if t is None else
                   t.redistribute(mesh, placements_of(i)).to_local())
    return out


def contiguous_stride(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape`` (worked out, not
    read off an allocation, which a traced step would record)."""
    out, step = [], 1
    for n in reversed(tuple(shape)):
        out.append(step)
        step *= max(int(n), 1)
    return tuple(reversed(out))


def from_shards(grads, like, placements_of) -> tuple:
    """Local gradients as DTensors of their inputs' global shapes on
    ``placements_of(i)`` (None passes through)."""
    from torch.distributed.tensor import DTensor
    return tuple(None if g is None else DTensor.from_local(
        g, ref.device_mesh, placements_of(i), run_check=False,
        shape=ref.shape, stride=contiguous_stride(ref.shape))
        for i, (g, ref) in enumerate(zip(grads, like)))


def _divides(x, dim: int, n: int) -> bool:
    """Whether ``x``'s split of ``dim`` over the mesh divides ``n``."""
    from torch.distributed.tensor import Shard
    ways = 1
    for i, p in enumerate(x.placements):
        if p == Shard(dim):
            ways *= x.device_mesh.size(i)
    return n % ways == 0


def whole(x, dim: int):
    """``x`` with ``dim`` gathered on every mesh dim that splits it; ``x``
    itself off a mesh."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    return x.redistribute(x.device_mesh, [
        Replicate() if p == Shard(dim) else p for p in x.placements])


def whole_heads(x, dim: int, n: int):
    """``x`` with ``dim`` gathered where, on a mesh, its split does not
    divide ``n``, the heads a reshape cuts it into (2 KV heads beside
    ``model=4``); ``x`` itself otherwise.  DTensor cannot cut a split dim
    into heads unevenly."""
    if not is_dtensor(x) or _divides(x, dim, n):
        return x
    return whole(x, dim)


def gather_heads(x, n: int):
    """``x`` (..., n * m), its last dim split over the mesh where the split
    does not divide the n heads (8 KV heads' columns over ``model=16``),
    gathered and cut into (..., n, m) on every rank, whole heads (as
    :func:`whole_heads` then :func:`split_last`).  The gradient, a
    partial sum over the ranks that read a head (the head-split
    attention's k and v), goes straight back to x's split: one
    reduce-scatter, where an all-reduce of the whole heads and then a
    local cut of the rank's columns would move them twice.  Off a mesh,
    or where the split divides n, :func:`split_last` of
    :func:`whole_heads`."""
    if not is_dtensor(x) or _divides(x, x.ndim - 1, n):
        return split_last(whole_heads(x, x.ndim - 1, n), n)
    return _GatherHeads.apply(x, n)


class _GatherHeads(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, n):
        fctx.placements, fctx.mesh = tuple(x.placements), x.device_mesh
        return split_last(whole(x, x.ndim - 1), n)

    @staticmethod
    def backward(fctx, grad):
        flat = _reshape_per_shard(grad, grad.ndim - 2, grad.shape[-2],
                                  lambda t: t.reshape(*t.shape[:-2], -1))
        return flat.redistribute(fctx.mesh, fctx.placements), None


def split_last(x, n: int):
    """``x`` (..., n * m) as (..., n, m).  On a mesh the reshape runs on
    each rank's shard (``local_map``) with its placements stated both
    ways: a split of the last dim becomes a split of the n heads, the
    other dims keep theirs, and the gradient arrives on the output's
    placements before it is reshaped back.  DTensor's own view rules
    differ by torch release: some refuse, or mis-shard, a view of a
    gradient that another op left split on ``m``.  The caller makes a
    split of the last dim divide n (:func:`whole_heads`)."""
    if not is_dtensor(x):
        return x.reshape(*x.shape[:-1], n, x.shape[-1] // n)
    m = x.shape[-1] // n
    return _reshape_per_shard(
        x, x.ndim - 1, n, lambda t: t.reshape(*t.shape[:-1], -1, m))


def merge_last(x):
    """``x`` (..., n, m) as (..., n * m), on a mesh per shard as
    :func:`split_last` (a split of m is gathered first, a split of n
    becomes a split of the merged dim)."""
    if not is_dtensor(x):
        return x.reshape(*x.shape[:-2], -1)
    from torch.distributed.tensor import Replicate, Shard
    if any(p == Shard(x.ndim - 1) for p in x.placements):
        x = x.redistribute(x.device_mesh, [
            Replicate() if p == Shard(x.ndim - 1) else p
            for p in x.placements])
    return _reshape_per_shard(x, x.ndim - 2, x.shape[-2],
                              lambda t: t.reshape(*t.shape[:-2], -1))


def _reshape_per_shard(x, dim: int, n: int, fn):
    """``fn`` (a reshape of ``x``'s dims from ``dim`` on, whose first
    output dim, of ``n``, keeps ``dim``'s index) on each rank's shard,
    every placement kept (a partial sum stays one: the reshape is
    linear, and its gradient is whole on each rank); DTensor's own
    reshape where ``x``'s split of ``dim`` does not divide ``n``."""
    if not _divides(x, dim, n):
        return fn(x)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    pl = tuple(x.placements)
    grad = tuple(Replicate() if p.is_partial() else p for p in pl)
    return local_map(fn, out_placements=(pl,), in_placements=(pl,),
                     in_grad_placements=(grad,), device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x)


def heads_in_grad(x, dim: int, n: int):
    """``x``, whose gradient is put back on ``x``'s own placements where,
    on a mesh, its split of ``dim`` divides no head of the ``n`` that the
    reshape before ``x`` cut: some torch releases' DTensor cannot cut such
    a gradient into heads (zamba2's 5120-wide d_inner over 256 ranks, 80
    heads), and ``x``'s split cuts, or the forward would have failed."""
    if not is_dtensor(x):
        return x
    return _HeadsInGrad.apply(x, dim, n)


class _HeadsInGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, n):
        ctx.dim, ctx.n = dim, n
        ctx.placements, ctx.mesh = tuple(x.placements), x.device_mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if not _divides(grad, ctx.dim, ctx.n):
            grad = grad.redistribute(ctx.mesh, ctx.placements)
        return grad, None, None


def chunk_ranges(n: int, ways: int) -> list:
    """The ``[start, end)`` of each of ``ways`` pieces of ``n`` as
    ``torch.chunk`` (and DTensor's ``Shard``) cuts it: ``ceil(n / ways)``
    each, the last ones shorter or empty (24 heads on 16 ranks: 2 each on
    ranks 0-11, none on 12-15)."""
    c = -(-n // ways)
    return [(min(r * c, n), min((r + 1) * c, n)) for r in range(ways)]


def take_ranges(t: torch.Tensor, axis: int, size: int, split: bool,
                needs: list, rank: int, group) -> torch.Tensor:
    """The ``[start, end)`` ranges ``needs[rank]`` of dim ``axis`` of a
    tensor of ``size`` there, concatenated in order, inside a per-shard
    body on the ranks of ``group`` (one mesh dim), each rank's own
    ranges in ``needs``.  Where ``t`` is the whole tensor (not
    ``split``), cut locally (``narrow``); where it is this rank's
    ``Shard(axis)`` over the group (``torch.chunk``'s sizes), each rank
    sends each other rank the part of its shard that rank needs, one
    all-to-all of only the ranges (and nothing moves where every rank's
    ranges lie in its own shard).  Autograd carries the gradient back the
    same way, so a split ``t``'s gradient is whole over the group."""
    mine = needs[rank]
    if not split:
        lo = 0
    else:
        own = chunk_ranges(size, len(needs))
        local = all(own[r][0] <= a and b <= own[r][1]
                    for r, rs in enumerate(needs) for a, b in rs)
        lo = own[rank][0]
        if not local:
            import torch.distributed._functional_collectives as funcol
            hi = own[rank][1]
            tt = t.movedim(axis, 0)
            sends, sizes_in = [], []
            for rs in needs:
                cut = [(max(a, lo), min(b, hi)) for a, b in rs
                       if max(a, lo) < min(b, hi)]
                sends += [tt.narrow(0, a - lo, b - a) for a, b in cut]
                sizes_in.append(sum(b - a for a, b in cut))
            sizes_out = [sum(max(0, min(b, o1) - max(a, o0)) for a, b in mine)
                         for o0, o1 in own]
            got = funcol.all_to_all_single_autograd(
                torch.cat(sends, 0) if sends else tt.narrow(0, 0, 0),
                sizes_out, sizes_in, group)
            return funcol.wait_tensor(got).movedim(0, axis)
    if not mine:
        return t.narrow(axis, 0, 0)
    return torch.cat([t.narrow(axis, a - lo, b - a) for a, b in mine], axis)


# ---------------------------------------------------------------------------
# Per-shard products: one plan, priced by the bytes a rank receives
# ---------------------------------------------------------------------------
#: a product's choices on one mesh dim (:func:`plan_product`)
GATHER, KEEP_K, KEEP_N, BATCH = "gather", "keep_k", "keep_n", "batch"


def _kind(p, lead: int, last: int, w: bool = False) -> str:
    """A placement of a product's operand as the planner reads it: ``E``
    (a split of the lead, expert, dims both operands share), ``K`` (the
    contraction), ``N`` (w's output dim), ``T`` (one of x's token dims)
    or ``R`` (whole; a partial sum of x is reduced before planning)."""
    from torch.distributed.tensor import Shard
    if not isinstance(p, Shard):
        return "R"
    if p.dim < lead:
        return "E"
    if w:
        return "K" if p.dim == lead else "N"
    return "K" if p.dim == last else "T"


def slice_holder(plan, sizes, xk, k: float) -> Optional[int]:
    """The mesh dim ``i`` that splits x's K where, under ``plan``, each
    rank takes just its K range from the rank of its dim-``i`` group that
    holds it, by one all-to-all of that range (:func:`product`), rather
    than gather x's K whole first; else None.  That is where x's K is
    split over ``i`` alone, the plan splits w's N there (so x's gradient
    is a partial sum over ``i``, which the all-to-all's backward sums at
    the holder) and keeps w's K split over one other dim on which x is
    whole, each of whose ranges lies inside one of ``i``'s: a one-slot
    decode's x, split over ``model`` by the norm's scale, beside a
    weight whose K splits over ``data`` (zamba2's ``in_proj``: 160 of
    2560 columns moved, where a gather moved 2400)."""
    split = [i for i, kind in enumerate(xk) if kind == "K"]
    keep = [j for j, c in enumerate(plan) if c == KEEP_K]
    if len(split) != 1 or len(keep) != 1:
        return None
    i, j = split[0], keep[0]
    if plan[i] != KEEP_N or xk[j] != "R":
        return None
    held = chunk_ranges(int(k), sizes[i])
    if all(any(a <= lo and hi <= b for a, b in held)
           for lo, hi in chunk_ranges(int(k), sizes[j])):
        return i
    return None


def product_cost(plan, sizes, xk, wk, xd, t: float, k: float, n: float,
                 e: float = 1.0, x_width: float = 1.0, out=None):
    """(elements a rank receives, the factor by which the product is
    repeated) of ``x @ w`` run per shard by ``plan`` (one choice a mesh
    dim), or None where the operands do not allow the plan.

    This is the planner's own price, not the count the dry run reports
    and its gates hold (``launch.hlo_analysis``: each collective's
    output bytes, as the reference counts them).  The two differ by
    class: the dry run counts a reduce-scatter and an all-reduce once
    each, at their output's bytes, where a rank receives as much in a
    reduce-scatter as in the all-gather of its input, and twice that in
    an all-reduce (a reduce-scatter and an all-gather), so the planner
    prices them so.  Two plans may therefore rank one way by the bytes
    received and the other by the dry run's count (a CPU mesh read
    minitron's and glm4's prefill up to x1.2 of an earlier count for
    fewer bytes received).

    ``sizes`` are the mesh dims' ranks; ``xk`` and ``wk`` each operand's
    kind on each (:func:`_kind`); ``xd`` the tensor dim x splits there
    (two mesh dims that split the same token dim are nested); ``t``, ``k``, ``n`` and ``e`` the
    global tokens, contraction, output width and lead (expert) count;
    ``x_width`` the elements of x a token holds for each of w's K rows (0
    for a lookup's token ids, ``transformer._lookup_plan``); ``out`` the
    kind the output must end in on each dim that does not split x's
    tokens (``R`` whole, ``N`` split over N, ``P`` as the product leaves
    it: a partial sum or a split of N; default ``R``).  On a mesh dim of
    ``s`` ranks, with ``f = (s - 1) / s`` and the rank's slice of each
    operand after the plan's kept splits:

      * ``gather``: w's split there is gathered, ``f`` of the rank's
        slice (FSDP); x keeps its token split, or its D split is
        gathered, and where x's tokens are whole there every rank of the
        dim runs the same product (the repeat factor);
      * ``keep_k``: w keeps its K split (a whole w is cut locally); x's
        tokens move to the K split (an all-to-all, ``f`` of the rank's
        new x; a whole x is cut locally), and the output, a partial sum,
        is reduce-scattered back to the tokens' ranks, or all-reduced
        (twice ``f``) where x's tokens are whole;
      * ``keep_n``: w keeps its N split (a whole w is cut with
        ``torch.chunk``'s sizes, unevenly where N does not divide); x's
        group's tokens are gathered (``f`` of them), the output columns
        go back to the tokens' ranks by an all-to-all, or, where x's
        tokens are whole, are gathered (``s - 1`` times the rank's
        columns) unless ``out`` keeps them split;
      * ``batch``: x and w split their lead dims alike (expert
        parallelism).

    The moves are priced in the order :func:`product` makes them: x's D
    split gathered on the rank's own tokens before its tokens move (or,
    where :func:`slice_holder` names the dim, only the rank's K range
    moved there, ``f`` of it); the
    output's partial sums reduced to the tokens' ranks first (so a later
    move carries the rank's own tokens), then the other reductions (into
    ``out``'s split of N only where no other dim splits N, else whole),
    then the all-to-alls, then the gathers.  An all-to-all on a dim whose token
    dim other mesh dims (``n_o`` ranks) split too costs ``n_o`` squared
    times as much: DTensor moves the other dims' rows with it
    (``transformer._lookup_plan``'s finding).  A dim of one rank that
    gathers moves nothing and costs nothing.  Not a plan (None): a
    choice its operands do not allow, or w's kept splits of one tensor
    dim not an outer run of its mesh dims (an inner one kept would be
    gathered through)."""
    m = len(sizes)
    out = out or ("R",) * m
    live = [s > 1 or c != GATHER for s, c in zip(sizes, plan)]
    for i, c in enumerate(plan):
        if live[i] and (xk[i] == "E") != (c == BATCH):
            return None
        if c == KEEP_K and wk[i] not in ("K", "R") or \
                c == KEEP_N and wk[i] not in ("N", "R"):
            return None
    for kind, choice in (("K", KEEP_K), ("N", KEEP_N)):
        kept = [plan[i] == choice for i in range(m)
                if live[i] and wk[i] == kind]
        if kept != sorted(kept, reverse=True):
            return None

    def ranks(pred):
        return math.prod(sizes[i] for i in range(m) if pred(i))

    def nested(i):
        return ranks(lambda j: j != i and xk[j] == "T" and xd[j] == xd[i])
    e_loc = e / ranks(lambda i: plan[i] == BATCH)
    t_own = t / ranks(lambda i: xk[i] == "T")
    t_loc = t_own * ranks(lambda i: xk[i] == "T" and
                          plan[i] in (KEEP_K, KEEP_N))
    k_loc = k / ranks(lambda i: plan[i] == KEEP_K)
    n_loc = n / ranks(lambda i: plan[i] == KEEP_N)
    held = slice_holder(plan, sizes, xk, k)
    cost, repeat = 0.0, 1
    for i, c in enumerate(plan):
        s = sizes[i]
        f = (s - 1) / s
        if c in (GATHER, BATCH) and wk[i] in ("K", "N"):
            cost += f * e_loc * k_loc * n_loc
        if c == GATHER and xk[i] != "T":
            repeat *= s
        if c == KEEP_K and xk[i] == "T":
            cost += f * e_loc * t_loc * k_loc * x_width * nested(i) ** 2
        elif c == KEEP_N and xk[i] == "T":
            cost += f * e_loc * t_loc * k_loc * x_width
        elif i == held:
            cost += f * e_loc * t_own * x_width * k_loc
        elif c != KEEP_K and xk[i] == "K":
            # gathered first, on the rank's own tokens
            cost += f * e_loc * t_own * x_width * k / ranks(
                lambda j: j != i and xk[j] == "K" and plan[j] == KEEP_K)
    t_cur, n_cur = t_loc, n_loc
    for i in reversed(range(m)):
        if plan[i] == KEEP_K and xk[i] == "T":
            cost += (sizes[i] - 1) / sizes[i] * e_loc * t_cur * n_cur
            t_cur /= sizes[i]
    split_n = KEEP_N in plan
    for i in range(m):
        if plan[i] == KEEP_K and xk[i] != "T" and out[i] != "P":
            s = sizes[i]
            scatter = out[i] == "N" and not split_n
            cost += (s - 1) / s * e_loc * t_cur * n_cur * (1 if scatter
                                                            else 2)
            if scatter:
                n_cur /= s
    for i in reversed(range(m)):
        if plan[i] == KEEP_N and xk[i] == "T":
            s = sizes[i]
            cost += (s - 1) / s * e_loc * t_cur * n_cur * nested(i) ** 2
            t_cur, n_cur = t_cur / s, n_cur * s
    for i in range(m):
        if plan[i] == KEEP_N and xk[i] != "T" and out[i] == "R":
            cost += (sizes[i] - 1) * e_loc * t_cur * n_cur
            n_cur *= sizes[i]
    return cost, repeat


@functools.lru_cache(maxsize=4096)
def plan_product(sizes, xk, wk, xd, t: float, k: float, n: float,
                 e: float = 1.0, out=None) -> Tuple[str, ...]:
    """The plan of :func:`product_cost` (the same arguments, as tuples)
    that :func:`product` runs and that moves the fewest bytes, among
    those that repeat the product on no mesh dim where such a plan
    exists: a dim whose ranks hold the same tokens splits the product's
    K or N over them rather than run it on each.  :func:`product` runs
    only ``gather`` on a dim of one rank, no token split kept on a mesh
    dim with an inner dim splitting the same token dim, and no K split
    kept beside tokens moved to another.  Ties go to the first plan in
    ``itertools.product`` order (gather before keep).  A plan depends
    only on its arguments, so it is worked out once for each."""
    m = len(sizes)
    best = None
    for plan in itertools.product((GATHER, KEEP_K, KEEP_N, BATCH),
                                  repeat=m):
        kept = [i for i, c in enumerate(plan) if c in (KEEP_K, KEEP_N)]
        if any(sizes[i] == 1 and c != GATHER
               for i, c in enumerate(plan)) or any(
                xk[i] == "T" and xk[j] == "T" and xd[j] == xd[i]
                and sizes[j] > 1 for i in kept for j in range(i + 1, m)):
            continue
        keep_k = [i for i in kept if plan[i] == KEEP_K]
        if len(keep_k) > 1 and any(xk[i] == "T" for i in keep_k):
            continue
        priced = product_cost(plan, sizes, xk, wk, xd, t, k, n, e,
                              out=out)
        if priced is None:
            continue
        key = priced[::-1]
        if best is None or key < best[0]:
            best = (key, plan)
    if best is None:
        raise ValueError(f"no per-shard plan for x {xk} and w {wk} on "
                         f"mesh dims {sizes}")
    return best[1]


def _plan_args(x, w, lead: int) -> tuple:
    """:func:`plan_product`'s and :func:`product_cost`'s arguments from
    ``sizes`` to ``e`` for DTensors x and w (w may be anything with
    ``placements`` and ``shape``)."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    last = x.ndim - 1
    return (tuple(mesh.size(i) for i in range(mesh.ndim)),
            tuple(_kind(p, lead, last) for p in x.placements),
            tuple(_kind(p, lead, 0, w=True) for p in w.placements),
            tuple(p.dim if isinstance(p, Shard) else None
                  for p in x.placements),
            math.prod(x.shape[lead:-1]), x.shape[-1], w.shape[-1],
            math.prod(x.shape[:lead]))


def product_plan(x, w, lead: int = 0, out="R") -> Tuple[str, ...]:
    """:func:`plan_product` for DTensors x (..., K) and w (K, N) on one
    mesh (with ``lead`` shared leading dims, x (E, T, K) and w (E, K,
    N)), ``out`` as there (one kind for every dim where it is a
    string); a partial sum of x counts as whole (it is reduced first)."""
    if isinstance(out, str):
        out = (out,) * x.device_mesh.ndim
    return plan_product(*_plan_args(x, w, lead), out=tuple(out))


def _regather(x, w, lead: int, out):
    """``w``, or ``w`` with its N split gathered on the mesh dims where x's
    tokens are whole and ``out`` wants the output whole (``R``), where
    that prices lower (:func:`product_cost`, with the gather of the
    weight's slice, ``s - 1`` times it, added): a weight whose N split
    the output would gather back anyway may be gathered itself and cut
    over K, so the product leaves partial sums over x's own K split (a
    zig-zag prefill's q, k and v, whole over ``model``).  Decode's few
    tokens never pay for a weight's gather; a dim that splits the tokens
    keeps w as it is."""
    from types import SimpleNamespace
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    dims = [i for i, p in enumerate(w.placements)
            if p == Shard(lead + 1) and mesh.size(i) > 1 and out[i] == "R"
            and _kind(x.placements[i], lead, x.ndim - 1) != "T"]
    if not dims:
        return w

    def priced(w_):
        args = _plan_args(x, w_, lead)
        cost, repeat = product_cost(plan_product(*args, out=out), *args,
                                    out=out)
        return repeat, cost
    whole = tuple(Replicate() if i in dims else p
                  for i, p in enumerate(w.placements))
    slice_ = math.prod(w.shape) / math.prod(
        mesh.size(i) for i, p in enumerate(w.placements)
        if isinstance(p, Shard))
    repeat, cost = priced(SimpleNamespace(placements=whole, shape=w.shape))
    gather = sum(mesh.size(i) - 1 for i in dims) * slice_
    if (repeat, cost + gather) < priced(w):
        return w.redistribute(mesh, whole)
    return w


def product(x, w, lead: int = 0, out="R"):
    """``x @ w`` (a batched product over ``lead`` shared leading dims)
    on a mesh, each rank's shard run by the plan :func:`product_plan`
    prices, with every placement and gradient placement stated, so that
    DTensor plans neither the product nor its backward.  ``w`` may be a tuple of
    weights placed alike (an FFN's gate and up projections, attention's
    q, k and v): where every weight's plan is the same, x is moved once
    for them all (else each is a product of its own), and a tuple comes
    back.  ``out`` gives, on each mesh dim
    that does not split x's tokens, the kind the output ends in (``R``
    whole, ``N`` split over w's N, ``P`` as the product leaves it; one
    kind for every dim where it is a string); on a dim that splits them
    the output is split as x is.  On each mesh dim:

      * ``gather``: w gathered there, x's own tokens (its D split, if
        any, gathered); the gradient of w a partial sum over the tokens'
        ranks, reduced back to w's placement;
      * ``keep_k``: x and w both split K (x's tokens moved there by an
        all-to-all, a whole x or w cut by DTensor's local split); the
        output a partial sum; the gradients split as the operands are;
      * ``keep_n``: w split N (a whole w cut with ``torch.chunk``'s
        sizes: an uneven split where N does not divide), x whole there
        (its group's tokens gathered); the output split over N, x's
        gradient a partial sum;
      * ``batch``: x and w split their lead dims alike.

    Where x's K is split over a ``keep_n`` dim and w's K kept over
    another on which x is whole (:func:`slice_holder`), each rank takes
    only its K range, from the rank of its group that holds it, by one
    all-to-all (:func:`take_ranges`), not x's whole K.  The output then moves dim by dim, in the order the plan was priced:
    partial sums reduce-scattered back to the tokens' ranks, the other
    partial sums reduced to ``out``, the N splits of moved tokens sent
    back by an all-to-all, and the other N splits gathered where ``out``
    wants them whole.  A dim of one rank is a ``gather`` (nothing moves).
    Off a mesh, ``x @ w``."""
    many = isinstance(w, (tuple, list))
    ws = tuple(w) if many else (w,)
    if not is_dtensor(x):
        ys = tuple(torch.matmul(x, w_) for w_ in ws)
        return ys if many else ys[0]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    if any(p.is_partial() for p in x.placements):
        x = x.redistribute(mesh, [Replicate() if p.is_partial() else p
                                  for p in x.placements])
    out = (out,) * mesh.ndim if isinstance(out, str) else tuple(out)
    ws = tuple(_regather(x, w_, lead, out) for w_ in ws)
    plan = product_plan(x, ws[0], lead, out)
    if any(product_plan(x, w_, lead, out) != plan for w_ in ws[1:]):
        return tuple(product(x, w_, lead, out) for w_ in ws)
    last = x.ndim - 1
    kinds = [_kind(p, lead, last) for p in x.placements]
    p_x, p_w, g_x, g_w, p_y = [], [], [], [], []
    for i, c in enumerate(plan):
        p = x.placements[i]
        if c == BATCH:
            row = (p, p, p, p, p)
        elif c == KEEP_K:
            row = (Shard(last), Shard(lead), Shard(last), Shard(lead),
                   Partial())
        elif c == KEEP_N:
            row = (Replicate(), Shard(lead + 1), Partial(), Shard(lead + 1),
                   Shard(last))
        else:
            keep = p if kinds[i] == "T" else Replicate()
            row = (keep, Replicate(), keep,
                   Partial() if kinds[i] == "T" else Replicate(), keep)
        for lst, q in zip((p_x, p_w, g_x, g_w, p_y), row):
            lst.append(q)
    m = mesh.ndim
    keep_k = [i for i in range(m) if plan[i] == KEEP_K]
    held = slice_holder(plan, tuple(mesh.size(i) for i in range(m)),
                        tuple(kinds), x.shape[-1])
    if held is None:
        # x's D split gathered first, on the rank's own tokens
        first = [Replicate() if kinds[i] == "K" and p_x[i] == Replicate()
                 else p for i, p in enumerate(x.placements)]
        x_l = x.redistribute(mesh, first).redistribute(mesh, p_x).to_local(
            grad_placements=g_x)
    else:
        # the rank's K range of the kept split, from the rank of its
        # ``held`` group whose shard of x holds it; the other ranks along
        # the kept dim took theirs, so each rank's gradient of its own
        # shard is a partial sum over that dim
        j, k = keep_k[0], x.shape[-1]
        pre = [p if i in (held, j) else p_x[i]
               for i, p in enumerate(x.placements)]
        g_pre = [Shard(last) if i == held else Partial() if i == j
                 else g_x[i] for i in range(m)]
        own = x.redistribute(mesh, pre).to_local(grad_placements=g_pre)
        lo, hi = chunk_ranges(k, mesh.size(j))[mesh.get_local_rank(j)]
        x_l = take_ranges(own, last, k, True,
                          [[(lo, hi)] if hi > lo else []] * mesh.size(held),
                          mesh.get_local_rank(held), (mesh, held))
    keep_n = [i for i in range(m) if plan[i] == KEEP_N]
    # the output's moves, in order: (mesh dim, the placement it takes)
    moves = [(i, x.placements[i]) for i in reversed(keep_k)
             if kinds[i] == "T"]
    # a partial sum reduce-scattered into a split of N only where no
    # other dim splits N (DTensor would gather that split first)
    moves += [(i, Shard(last) if out[i] == "N" and not keep_n
               else Replicate())
              for i in keep_k if kinds[i] != "T" and out[i] != "P"]
    moves += [(i, x.placements[i]) for i in reversed(keep_n)
              if kinds[i] == "T"]
    moves += [(i, Replicate()) for i in keep_n
              if kinds[i] != "T" and out[i] == "R"]
    ys = []
    for w_ in ws:
        w_l = w_.redistribute(mesh, p_w).to_local(grad_placements=g_w)
        shape = tuple(x.shape[:-1]) + (w_.shape[-1],)
        y = DTensor.from_local(torch.matmul(x_l, w_l), mesh, p_y,
                               run_check=False, shape=shape,
                               stride=contiguous_stride(shape))
        for i, to in moves:
            y = y.redistribute(mesh, [to if j == i else q
                                      for j, q in enumerate(y.placements)])
        ys.append(y)
    return tuple(ys) if many else ys[0]


def register_kernel_rules() -> None:
    """Register the kernel ops' DTensor sharding rules (flash attention,
    the SSD scan), once."""
    from repro_torch.kernels import flash_attention, ssd
    flash_attention.register_sharding_rule()
    ssd.register_sharding_rule()


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, for a ``DeviceMesh`` (its dim names and shape)
    or a duck-typed mesh with a ``shape`` dict."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_size(mesh, axis) -> int:
    """The size of ``axis`` on ``mesh`` (a tuple of axes: the product; an
    axis the mesh lacks, or None: 1)."""
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        size = 1
        for a in axis:
            size *= axis_size(mesh, a)
        return size
    return mesh_shape(mesh).get(axis, 1)


def batch_axes() -> Tuple[str, ...]:
    """Axes the launcher designates for batch sharding (profile-aware)."""
    return getattr(_state, "batch_axes", ("pod", "data"))


def set_batch_axes(axes: Tuple[str, ...]):
    _state.batch_axes = tuple(axes)


def seq_axes() -> Tuple[str, ...]:
    """Axes for sequence sharding (sequence-parallel profile)."""
    return getattr(_state, "seq_axes", ())


def set_seq_axes(axes: Tuple[str, ...]):
    _state.seq_axes = tuple(axes)


def resolve(shape, axes, mesh) -> tuple:
    """The reference's spec for ``constrain(x, *axes)`` on a tensor of
    ``shape``: the ``"batch"`` and ``"seq"`` sentinels resolved, axes
    absent from the mesh (or already used) dropped, tuples shrunk until
    the dim divides, still-non-divisible dims None."""
    names = axis_names(mesh)
    spec = []
    used: set = set()
    for dim, ax in zip(shape, axes):
        if ax == "batch":
            ax = batch_axes()
        elif ax == "seq":
            ax = seq_axes() or None
        if isinstance(ax, (tuple, list)):
            ax = tuple(a for a in ax if a in names and a not in used)
            while ax and dim % axis_size(mesh, ax) != 0:
                ax = ax[:-1]
            ax = ax if ax else None
        elif ax is not None and (ax not in names or ax in used
                                 or dim % axis_size(mesh, ax) != 0):
            ax = None
        if ax is not None:
            used.update(ax if isinstance(ax, tuple) else (ax,))
        spec.append(ax)
    return tuple(spec)


def constrain(x, *axes):
    """``x`` redistributed to the spec :func:`resolve` gives, if a mesh is
    active; ``x`` itself otherwise.  Inside a mesh ``x`` must be a
    ``DTensor`` on it."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    from repro_torch.parallel.sharding import P, placements
    if not isinstance(x, DTensor):
        raise TypeError(
            f"constrain inside a mesh got a plain {type(x).__name__} of "
            f"shape {tuple(x.shape)}: an activation escaped the sharding")
    # redistributed even where it already has these placements: as JAX's
    # constraint does, the node also constrains the gradient, which the
    # backward would otherwise leave wherever DTensor's rules put it
    shape = tuple(x.shape)
    want = placements(P(*resolve(shape, axes, mesh)), mesh, shape)
    return x.redistribute(x.device_mesh, want)
