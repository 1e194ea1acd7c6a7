"""Sharding rules: DP / FSDP / TP / EP / SP over a ('pod', 'data',
'model') mesh, with divisibility-aware fallback (port of
``repro.parallel.sharding``: the same rules, spec for spec).

Conventions (MaxText-style 2D weight sharding), as in the reference:
  * column-parallel weights (D -> X): (… , 'data', 'model') — FSDP over
    the input dim, TP over the output dim;
  * row-parallel weights (X -> D): (… , 'model', 'data');
  * expert weights (L, E, D, F): experts over 'model' (EP) when divisible;
  * embeddings (V, D): vocab over 'model', d_model over 'data';
  * batch over ('pod', 'data'); long-context (batch=1) decode shards the
    KV cache *sequence* dimension instead (SP).

JAX's ``PartitionSpec`` is :class:`P` here (one entry a tensor dim: an
axis name, a tuple of them, or None), its ``NamedSharding`` is
:class:`Sharding` (a mesh and a spec, whose :attr:`~Sharding.placements`
are the DTensor placements, one a mesh dim), and ``jax.device_put(tree,
shardings)`` is :func:`distribute`.

**Stacked against per-layer.**  The reference stacks its layers, (L, a,
b), and the hybrid's (n_groups, attn_every, a, b); the port holds one
tensor a layer (``LMParams``).  So each port leaf is given the rule of
the stacked leaf it is a slice of (``convert.params_from_jax``'s map),
applied to the stacked shape, and the lead dims are dropped.  Where the
reference shards a lead dim itself (the stacked (L, D) norm scales under
``2d`` when L divides over 'data'; under ``dp``/``sp``, a stacked shape
whose largest divisible dim is L), the port's per-layer tensor is
replicated over that axis.  :func:`comm_volumes` counts on the stacked
view, so it equals the reference's to the byte.  Expert weights are
known from the config (``cfg.n_experts``) and the layer they sit in (an
attention layer's MLP; the port flattens the reference's ``moe``
sub-tree into the layer, so the name alone cannot tell them), and the
hybrid's stacking from ``cfg.attn_every``: the rules for a tree holding
a model's layers take ``cfg``.

Trees are the port's: an ``LMParams`` (its spec tree is a dict by
parameter name), a ``TrainState`` (params, the optimizer's dicts by
parameter name, the step), dicts, lists and tuples of tensors.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.parallel.ctx import (axis_names, axis_size,
                                      contiguous_stride, mesh_shape,
                                      register_kernel_rules)

# weight names that are row-parallel (output dim is d_model)
_ROW_PARALLEL = ("wo", "w_down", "out_proj", "head", "lm_head")
# NOTE on norm scales: stacked (L, D) vectors are left on the generic
# column rule (D on 'model' when divisible), as in the reference, where
# the D-sharded scale pins post-norm activations model-sharded.
_EXPERT = ("w_gate", "w_up", "w_down")


class P(tuple):
    """A partition spec: one entry a tensor dim, each an axis name, a
    tuple of axis names (sharded over their product, major first) or None
    (replicated).  Compares as JAX's does: a one-axis tuple equals the
    axis name."""

    def __new__(cls, *axes):
        return super().__new__(cls, tuple(
            tuple(a) if isinstance(a, list) else a for a in axes))

    def _canon(self) -> tuple:
        return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                     for a in self)

    def __eq__(self, other):
        if not isinstance(other, tuple):
            return NotImplemented
        return self._canon() == P(*other)._canon()

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __hash__(self):
        return hash(self._canon())

    def __repr__(self):
        return f"P{tuple.__repr__(tuple(self))}" if len(self) != 1 \
            else f"P({self[0]!r})"

    def axes(self) -> Tuple[str, ...]:
        """Every axis name the spec uses, in order."""
        out = []
        for ax in self:
            if isinstance(ax, tuple):
                out.extend(ax)
            elif ax is not None:
                out.append(ax)
        return tuple(out)


def _fit(dim: int, mesh, axis) -> Optional[str]:
    """Return axis if dim is divisible by its size, else None."""
    return axis if axis and dim % axis_size(mesh, axis) == 0 else None


def _leaf_spec(path: Tuple[str, ...], shape: Tuple[int, ...], mesh) -> P:
    name = path[-1] if path else ""
    nd = len(shape)
    if nd == 0:
        return P()
    if nd == 1:  # per-layer scalars/vectors
        return P(*([None] * nd))

    # Embedding tables / lm head (2-D, not layer-stacked)
    if name == "embed":
        return P(_fit(shape[0], mesh, "model"), _fit(shape[1], mesh, "data"))
    if name in ("lm_head", "head"):
        return P(_fit(shape[0], mesh, "data"), _fit(shape[1], mesh, "model"))
    if name == "frontend_proj":
        return P(None, _fit(shape[1], mesh, "model"))

    # MoE expert weights: (L, E, D, F) or (E, D, F)
    if name in _EXPERT and nd >= 3 and "moe" in path:
        lead = (None,) * (nd - 3)
        e, a, b_ = shape[-3], shape[-2], shape[-1]
        if e % axis_size(mesh, "model") == 0:
            return P(*lead, "model", _fit(a, mesh, "data"), None)
        # fallback: shard the wide ffn/model dims instead of experts
        if name == "w_down":
            return P(*lead, None, _fit(a, mesh, "model"),
                     _fit(b_, mesh, "data"))
        return P(*lead, None, _fit(a, mesh, "data"), _fit(b_, mesh, "model"))
    if name == "router":
        lead = (None,) * (nd - 2)
        return P(*lead, _fit(shape[-2], mesh, "data"), None)

    # conv weights (L, K, C): shard channels
    if name == "conv_w":
        lead = (None,) * (nd - 2)
        return P(*lead, None, _fit(shape[-1], mesh, "model"))

    # Generic stacked 2-D weights (L, a, b) or flat (a, b)
    lead = (None,) * (nd - 2)
    a, b_ = shape[-2], shape[-1]
    if name in _ROW_PARALLEL:
        return P(*lead, _fit(a, mesh, "model"), _fit(b_, mesh, "data"))
    return P(*lead, _fit(a, mesh, "data"), _fit(b_, mesh, "model"))


def _dp_leaf_spec(shape: Tuple[int, ...], mesh) -> P:
    """Pure-FSDP spec: shard the largest divisible dim over ALL mesh axes
    (progressively dropping axes for small dims)."""
    if len(shape) == 0:
        return P()
    axes_all = [a for a in ("pod", "data", "model") if a in mesh_shape(mesh)]
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    combo = tuple(axes_all)
    while combo:  # prefer full-mesh coverage on ANY dim before degrading
        for i in order:
            if shape[i] % axis_size(mesh, combo) == 0:
                spec = [None] * len(shape)
                spec[i] = combo if len(combo) > 1 else combo[0]
                return P(*spec)
        combo = combo[:-1]
    return P(*([None] * len(shape)))


# ---------------------------------------------------------------------------
# The port's trees
# ---------------------------------------------------------------------------
def _is_leaf_spec(x) -> bool:
    return isinstance(x, (P, Sharding))


def tree_map_with_path(fn: Callable[[Tuple, Any], Any], tree: Any,
                       path: Tuple = ()) -> Any:
    """``fn(path, leaf)`` over a port tree, rebuilt with an ``LMParams``
    as a dict by parameter name (its spec tree's form)."""
    if isinstance(tree, torch.nn.Module):
        return {n: fn(path + (n,), t) for n, t in tree.named_parameters()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type) \
            and not _is_leaf_spec(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map_with_path(fn, getattr(tree, f.name),
                                       path + (f.name,))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, Mapping):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_leaf_spec(tree):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_leaves(tree: Any) -> list:
    out: list = []
    tree_map_with_path(lambda _, x: out.append(x), tree)
    return out


_LAYER = re.compile(r"^layers\.(\d+)\.(.+)$")


def _stacked_leaf(key: str, shape: Tuple[int, ...], cfg=None
                 ) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """The reference's path and stacked shape of the leaf that the port's
    parameter ``key`` (``layers.3.wq``, ``shared.wq``, ``embed``) is a
    slice of, for a model of config ``cfg`` (``convert.params_from_jax``
    read backwards).  Keys of no layer are their own stacked leaf."""
    shape = tuple(int(d) for d in shape)
    m = _LAYER.match(key)
    if m is None and not key.startswith("shared."):
        return (key,), shape
    if cfg is None:
        raise ValueError(f"the rule for {key!r} needs the model's config "
                         "(cfg=): the stacking and the experts come from it")
    name = m.group(2) if m else key.split(".", 1)[1]
    if cfg.family in ("ssm", "hybrid") and m:
        sub = () if name == "ln" else ("mamba",)
    else:
        sub = ("moe",) if (cfg.n_experts and name in _EXPERT + ("router",)
                           and (len(shape) == 3 or name == "router")) else ()
    if not m:
        return ("shared_attn",) + sub + (name,), shape
    if cfg.family == "hybrid":
        lead = (cfg.n_layers // cfg.attn_every, cfg.attn_every)
    else:
        lead = (cfg.n_layers,)
    return ("layers",) + sub + (name,), lead + shape


def _stacked_spec(path: Tuple, leaf, mesh, profile: str, cfg) -> Tuple[P, int]:
    """(the reference's spec of ``leaf``'s stacked leaf, the number of its
    lead dims the port's leaf lacks)."""
    shape = tuple(np.shape(leaf))
    key = str(path[-1]) if path else ""
    ref_path, stacked = _stacked_leaf(key, shape, cfg)
    if profile in ("dp", "sp"):
        spec = _dp_leaf_spec(stacked, mesh)
    else:
        spec = _leaf_spec(ref_path, stacked, mesh)
    return spec, len(stacked) - len(shape)


def param_specs(params: Any, mesh, profile: str = "2d", cfg=None) -> Any:
    """A spec tree matching ``params`` (an ``LMParams``, a ``TrainState``
    or any tree of tensors; a model's layers need ``cfg``).

    profile="2d": FSDP over 'data' x TP/EP over 'model' (default).
    profile="dp": pure DP/FSDP — everything sharded over the flat mesh;
    "sp" shards the weights as "dp" does."""
    def spec(path, leaf):
        s, lead = _stacked_spec(path, leaf, mesh, profile, cfg)
        return P(*s[lead:])
    return tree_map_with_path(spec, params)


def batch_specs(batch: Dict, mesh, shard_seq: bool = False,
                profile: str = "2d") -> Dict:
    """Input batch sharding: batch over ('pod','data') — plus 'model' under
    the pure-DP profile — falling back to smaller axis subsets when the
    batch does not divide; optionally the sequence dim instead
    (long-context, batch=1)."""
    shape_of = mesh_shape(mesh)
    base = ("pod", "data", "model") if profile == "dp" else ("pod", "data")
    daxes = tuple(a for a in base if a in shape_of)
    daxes = daxes if daxes else (None,)
    sp_seq = ("model",) if (profile == "sp" and "model" in shape_of) \
        else None

    def fit_axes(dim):
        combo = daxes
        while combo:
            if dim % axis_size(mesh, combo) == 0:
                return combo
            combo = combo[:-1]
        return None

    def spec(_, x):
        shape = tuple(np.shape(x))
        if len(shape) == 0:
            return P()
        if not shard_seq:
            axes = fit_axes(shape[0])
            if axes:
                rest = [None] * (len(shape) - 1)
                if sp_seq and len(shape) >= 2 and \
                        shape[1] % axis_size(mesh, sp_seq) == 0:
                    rest[0] = sp_seq  # sequence-parallel activations
                return P(axes, *rest)
        if len(shape) >= 2 and shard_seq:
            axes = fit_axes(shape[1])
            if axes:
                return P(None, axes, *([None] * (len(shape) - 2)))
        return P(*([None] * len(shape)))

    return tree_map_with_path(spec, batch)


def cache_specs(state: Any, mesh, batch: int, cfg=None) -> Any:
    """Decode-state sharding.

    KV caches (L_or_G, B, S, KV, hd): batch over ('pod','data') when it
    divides, otherwise sequence-parallel over ('pod','data') (SP — the
    long_500k case); kv heads over 'model' when they divide, else the
    sequence picks up 'model' too.  SSM states (…, B, …): batch-sharded
    when possible, state dims over 'model' as fallback.

    The hybrid's Mamba2 states are (L, B, ...) here, one a layer, where
    the reference stacks them (n_groups, attn_every, B, ...): their rule
    reads the reference's shape (so the batch dim found by size is the
    reference's, a layer count equal to the batch included), and the two
    layer dims' specs become L's: n_groups' where attn_every's is None,
    else None (a spec on attn_every is strided over L).  That needs
    ``cfg`` for a hybrid state."""
    shape_of = mesh_shape(mesh)
    daxes = tuple(a for a in ("pod", "data") if a in shape_of)
    dsize = axis_size(mesh, daxes)
    msize = axis_size(mesh, "model")

    def kv_spec(shape):
        if len(shape) != 5:
            return _state_spec(shape)
        _, b_, s, kv, hd = shape
        kv_ax = "model" if kv % msize == 0 else None
        if b_ % dsize == 0:
            seq_ax = None if kv_ax else (
                "model" if s % msize == 0 else None)
            return P(None, daxes, seq_ax, kv_ax, None)
        seq_axes = daxes if kv_ax else daxes + ("model",)
        if s % axis_size(mesh, seq_axes) == 0:
            return P(None, None, seq_axes, kv_ax, None)
        return P(None, None, None, kv_ax, None)

    def _state_spec(shape):
        if len(shape) == 0:
            return P()
        spec = [None] * len(shape)
        # find the batch dim (== requested batch size), shard it on data
        for i, d in enumerate(shape):
            if d == batch and d % dsize == 0:
                spec[i] = daxes
                break
        # shard the widest remaining dim on 'model' if divisible
        widths = [(d, i) for i, d in enumerate(shape) if spec[i] is None]
        if widths:
            d, i = max(widths)
            if d % msize == 0 and d >= msize:
                spec[i] = "model"
        return P(*spec)

    hybrid = isinstance(state, Mapping) and "ssm_layers" in state \
        and "k" in state

    def spec(path, x):
        shape = tuple(int(d) for d in np.shape(x))
        names = tuple(str(p) for p in path)
        if names and names[-1] in ("k", "v"):
            return kv_spec(shape)
        if hybrid and names[:1] == ("ssm_layers",):
            if cfg is None:
                raise ValueError("a hybrid decode state's rule needs cfg=")
            g = cfg.n_layers // cfg.attn_every
            s = _state_spec((g, cfg.attn_every) + shape[1:])
            return P(s[0] if s[1] is None else None, *s[2:])
        return _state_spec(shape)

    return tree_map_with_path(spec, state)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------
def placements(spec, mesh, shape=None) -> tuple:
    """``spec`` (one entry a tensor dim) as DTensor placements (one a mesh
    dim, in the mesh's order): ``Shard(d)`` on each mesh dim that tensor
    dim d names, ``Replicate()`` on the others.  A tensor dim over a tuple
    of axes is sharded on each, major first, which must be the mesh's
    order (the layout ``PartitionSpec`` gives it).  Given the tensor's
    ``shape``, a dim of size 1 is left whole: the rules may name it only
    over axes of size 1, where a split holds what a replica holds, and
    DTensor's view rules refuse to squeeze a split dim."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    last = {}
    for d, ax in enumerate(spec):
        if ax is None or (shape is not None and shape[d] == 1):
            continue
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a not in names:
                raise ValueError(f"axis {a!r} of {spec} is not on the mesh "
                                 f"{names}")
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"axis {a!r} is used twice in {spec}")
            if last.get(d, -1) > i:
                raise ValueError(f"the axes of dim {d} in {spec} are not in "
                                 f"the mesh's order {names}")
            last[d] = i
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A mesh and a spec: the port's ``NamedSharding``."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def tree_shardings(spec_tree: Any, mesh) -> Any:
    return tree_map_with_path(
        lambda _, s: Sharding(mesh, s) if isinstance(s, P) else s,
        spec_tree)


def _put(leaf, sharding: Sharding):
    """One leaf on ``sharding``: a tensor distributed (from its values on
    rank 0), a DTensor redistributed (through its full value where the
    mesh differs); anything else unchanged."""
    if not isinstance(leaf, torch.Tensor):
        return leaf
    from torch.distributed.tensor import DTensor, distribute_tensor
    want = placements(sharding.spec, sharding.mesh, tuple(leaf.shape))
    if isinstance(leaf, DTensor):
        if leaf.device_mesh == sharding.mesh:
            out = leaf.detach().redistribute(sharding.mesh, want)
            return out.requires_grad_(leaf.requires_grad)
        leaf = leaf.full_tensor()
    out = distribute_tensor(leaf.detach(), sharding.mesh, want)
    return out.requires_grad_(leaf.requires_grad)


def shard_of(leaf, sharding: Sharding, device, fill=None):
    """A DTensor of ``leaf``'s shape and dtype on ``sharding`` of which
    each rank makes only its own shard, on ``device``: filled with
    ``fill``, or left unset where ``fill`` is None (the dry run's
    ``meta`` shards).  Where :func:`distribute` cuts a whole tensor that
    every rank holds, this never makes more than the shard."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape = tuple(leaf.shape)
    pl = placements(sharding.spec, sharding.mesh, shape)
    local, _ = compute_local_shape_and_global_offset(shape, sharding.mesh, pl)
    t = torch.empty(tuple(local), dtype=leaf.dtype, device=device) \
        if fill is None else torch.full(tuple(local), fill, dtype=leaf.dtype,
                                        device=device)
    return DTensor.from_local(t, sharding.mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def distribute(tree: Any, shardings: Any, put: Callable = _put) -> Any:
    """``tree`` with every tensor placed as ``shardings`` (a tree of
    :class:`Sharding` of the same structure, an ``LMParams`` matched by a
    dict by name) says: the port's ``jax.device_put(tree, shardings)``.
    ``put(leaf, sharding)`` places one leaf (the dry run passes one that
    makes a DTensor of the leaf's shape without its values)."""
    register_kernel_rules()
    if isinstance(shardings, Sharding):
        return put(tree, shardings)
    if isinstance(tree, torch.nn.Module):
        return tree.map(lambda n, t: put(t, shardings[n]))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: distribute(getattr(tree, f.name),
                               getattr(shardings, f.name), put)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, Mapping):
        return {k: distribute(v, shardings[k], put) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute(v, s, put)
                          for v, s in zip(tree, shardings))
    return tree


def comm_volumes(params: Any, mesh, specs: Any = None, profile: str = "2d",
                 cfg=None) -> Dict[str, float]:
    """Per-step communication volumes (bytes) implied by the sharding plan.

    Feeds the distributed predictor (``core/distributed.py``):
      * grad all-reduce volume = bytes of params replicated across 'data'
        (their grads need reduction);
      * weight all-gather volume = bytes of params sharded over 'data'
        (FSDP gathers them per layer).

    Without ``specs`` each leaf is counted under its stacked leaf's spec
    (``profile``'s rule): the reference's volumes to the byte."""
    grad_ar = 0.0
    w_ag = 0.0
    if specs is None:
        def spec_of(path, leaf):
            return _stacked_spec(path, leaf, mesh, profile, cfg)[0]
        pairs = []
        tree_map_with_path(lambda p, x: pairs.append((x, spec_of(p, x))),
                           params)
    else:
        pairs = list(zip(tree_leaves(params), tree_leaves(specs)))
    for leaf, spec in pairs:
        if not hasattr(leaf, "dtype"):
            continue        # a host number (the step): no device bytes
        nbytes = int(np.prod(tuple(leaf.shape))) * _itemsize(leaf.dtype)
        if "data" in P(*spec).axes():
            w_ag += nbytes
        else:
            grad_ar += nbytes
    return {"grad_all_reduce_bytes": grad_ar,
            "weight_all_gather_bytes": w_ag}


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize
