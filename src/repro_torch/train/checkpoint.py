"""Asynchronous, atomic checkpoints (port of ``repro.train.checkpoint``).

Layout, as in the reference: ``<dir>/step_<N>/arrays.npz`` (the
flattened tree, one entry a leaf, keyed by its path joined with ``|``)
and ``meta.json`` (step, time, keys).  A tree is a :class:`TrainState`
(``params``, ``opt``, ``step``), an :class:`LMParams` (its
``named_parameters()`` names), or dicts, lists and tuples of tensors and
numbers; ``params|layers.3.wq`` and ``opt|m|layers.3.wq`` are the port's
own paths.  numpy has no bfloat16, so a bfloat16 tensor is stored as its
16-bit pattern and ``meta.json``'s ``dtypes`` names it.

``save`` copies the tree to the host in the caller's thread (the train
loop waits for that device-to-host copy, not for the file system) and
writes ``.tmp_step_<N>`` on a background thread, renamed to ``step_<N>``
once complete.  ``restore`` reads a checkpoint into the structure of
``like`` on a given device, checking every leaf's shape as the reference
does, in the dtypes it was saved in.

A tree of DTensors (a state sharded over a mesh) is saved whole: each
leaf is gathered (``full_tensor()``, a collective every rank joins, in
the same order), rank 0 alone writes, and every rank waits at a barrier
until the write is complete, so a sharded save blocks.  ``restore``'s
``shardings`` (a tree of ``parallel.sharding.Sharding``) distributes each
loaded leaf onto a mesh, which may differ in size from the one that saved
it: the reference's elastic rescale.  Without it, a leaf whose ``like``
is a DTensor comes back on that DTensor's mesh and placements.
"""

from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.transformer import LMParams
from repro_torch.parallel.ctx import is_dtensor
from repro_torch.train.train_step import TrainState

_SEP = "|"


def _map(fn: Callable[[str, Any], Any], tree: Any, path: str = "") -> Any:
    """``fn(key, leaf)`` over every leaf of ``tree``, rebuilt in its
    structure."""
    def sub(name) -> str:
        return f"{path}{_SEP}{name}" if path else str(name)
    if isinstance(tree, TrainState):
        return TrainState(params=_map(fn, tree.params, sub("params")),
                          opt=_map(fn, tree.opt, sub("opt")),
                          step=_map(fn, tree.step, sub("step")))
    if isinstance(tree, LMParams):
        return tree.map(lambda name, t: fn(sub(name), t))
    if isinstance(tree, dict):
        return {k: _map(fn, v, sub(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, sub(i)) for i, v in enumerate(tree))
    return fn(path, tree)


def _host(t: Any) -> Tuple[np.ndarray, Optional[str]]:
    """A leaf as a host array, and ``"bfloat16"`` where its bits stand in
    for a dtype numpy lacks."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if is_dtensor(t):
            t = t.full_tensor()         # a collective: every rank gathers
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy(), "bfloat16"
        return t.cpu().numpy(), None
    return np.asarray(t), None


def flatten(tree: Any) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """``(arrays by key, dtype names of the bfloat16 keys)``."""
    arrays: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}

    def take(key, leaf):
        arrays[key], name = _host(leaf)
        if name:
            dtypes[key] = name
        return leaf
    _map(take, tree)
    return arrays, dtypes


def save(directory: str, step: int, tree: Any,
         blocking: bool = True) -> threading.Thread:
    """Snapshot ``tree`` under ``directory/step_<step>`` atomically (a tree
    of DTensors: gathered on every rank, written by rank 0, behind a
    barrier)."""
    sharded = any(is_dtensor(leaf) for leaf in _leaves(tree))
    arrays, dtypes = flatten(tree)
    target = Path(directory) / f"step_{step}"
    tmp = Path(directory) / f".tmp_step_{step}"

    def write():
        tmp.mkdir(parents=True, exist_ok=True)
        np.savez(tmp / "arrays.npz", **arrays)
        (tmp / "meta.json").write_text(json.dumps(
            {"step": step, "time": time.time(), "keys": sorted(arrays),
             "dtypes": dtypes}))
        if target.exists():
            shutil.rmtree(target)
        tmp.rename(target)

    if sharded:
        import torch.distributed as dist
        if dist.get_rank() != 0:
            write = (lambda: None)      # noqa: E731 (rank 0 writes)
    thread = threading.Thread(target=write, daemon=True)
    thread.start()
    if blocking or sharded:
        thread.join()
    if sharded:
        dist.barrier()
    return thread


def _leaves(tree: Any) -> list:
    out: list = []
    _map(lambda _, leaf: out.append(leaf) or leaf, tree)
    return out


def latest_step(directory: str) -> Optional[int]:
    d = Path(directory)
    if not d.exists():
        return None
    steps = [int(p.name.split("_", 1)[1]) for p in d.glob("step_*")
             if (p / "meta.json").exists()]
    return max(steps) if steps else None


def restore(directory: str, like: Any, step: Optional[int] = None,
            device=None, shardings: Any = None) -> Tuple[Any, int]:
    """The checkpoint at ``step`` (default the latest) in the structure
    and ``requires_grad`` of ``like``, each tensor on ``device`` (default:
    that of its leaf in ``like``); a leaf whose shape differs from
    ``like``'s raises ``ValueError``.  Each tensor keeps the dtype it was
    saved in.  The reference casts it to ``like``'s, so a bfloat16
    model's float32 AdamW moments (clipping makes them float32 from the
    first step) would come back as the bfloat16 of a fresh state, and a
    resumed run would part from the uninterrupted one.

    ``shardings`` (a tree of ``parallel.sharding.Sharding`` like
    ``like``'s, an ``LMParams`` matched by a dict by name) distributes the
    restored tree onto its mesh (every rank reads the file; rank 0's
    values are scattered); without it a leaf whose ``like`` is a DTensor
    takes that DTensor's mesh and placements."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    path = Path(directory) / f"step_{step}"
    dtypes = json.loads((path / "meta.json").read_text()).get("dtypes", {})

    def load(key, ref):
        arr = data[key]
        if arr.shape != tuple(np.shape(ref)):
            raise ValueError(f"shape mismatch for {key}: checkpoint "
                             f"{arr.shape} vs model {tuple(np.shape(ref))}")
        if not isinstance(ref, torch.Tensor):
            return type(ref)(arr) if np.isscalar(ref) else arr
        t = torch.from_numpy(np.array(arr))
        if dtypes.get(key) == "bfloat16":
            t = t.view(torch.bfloat16)
        t = t.to(ref.device if device is None else device)
        if is_dtensor(ref) and shardings is None:
            from torch.distributed.tensor import distribute_tensor
            t = distribute_tensor(t, ref.device_mesh, ref.placements)
        return t.requires_grad_(ref.requires_grad)
    with np.load(path / "arrays.npz") as data, torch.no_grad():
        tree = _map(load, like)
    if shardings is not None:
        from repro_torch.parallel.sharding import distribute
        tree = distribute(tree, shardings)
    return tree, step
