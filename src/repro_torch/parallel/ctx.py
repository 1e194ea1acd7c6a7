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
