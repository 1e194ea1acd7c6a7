"""Carry the reference's parameters into the port.

:func:`params_from_jax` takes the JAX package's parameter tree of any
family as numpy arrays (``jax.tree.map(np.asarray, params)``: layers
stacked on a leading axis, as ``lax.scan`` wants them) and returns the
port's :class:`~repro_torch.models.transformer.LMParams` holding the same
numbers, so both packages compute the same function;
:func:`evalzoo_params_from_jax` does the same for the Table-4 nets of
``models.evalzoo``.  It imports no JAX: bfloat16 arrays (numpy's
``ml_dtypes`` extension type) are reinterpreted bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from repro_torch.core.devices import torch_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import LMParams, _check_family

_TOP = ("embed", "final_norm", "lm_head", "frontend_proj")


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)         # a writable copy: JAX's host arrays are not
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _flat_block(blk: Mapping) -> Dict:
    """One layer's (or the shared block's) tree with its ``mamba`` or
    ``moe`` sub-tree flattened beside the other tensors, as the port's
    layer dicts hold them."""
    out = {k: v for k, v in blk.items() if k not in ("mamba", "moe")}
    for sub in ("mamba", "moe"):
        out.update(blk.get(sub, {}))
    return out


def params_from_jax(cfg: ModelConfig, tree: Mapping,
                    device=None) -> LMParams:
    """The reference's ``init_params(cfg, key)`` tree, as numpy, on
    ``device`` (default ``cuda``).  Attention layers carry
    ``tree["layers"]``'s tensors (a ``moe`` sub-tree flattened into the
    layer); ssm layers carry ``ln`` beside the ``mamba`` sub-tree's;
    hybrid layers, stacked (n_groups, attn_every, ...) there, become one a
    layer in order, and ``shared_attn`` the shared block."""
    _check_family(cfg)
    dev = torch_device(device)
    top = {k: _tensor(tree[k], dev) for k in _TOP if k in tree}
    stacked = _flat_block(tree["layers"])
    if cfg.family == "hybrid":
        stacked = {k: np.reshape(v, (-1,) + np.shape(v)[2:])
                   for k, v in stacked.items()}
    n = cfg.n_layers
    for k, v in stacked.items():
        if np.shape(v)[0] != n:
            raise ValueError(f"layers[{k!r}] stacks {np.shape(v)[0]} layers, "
                             f"config has {n}")
    layers: List[Dict[str, torch.Tensor]] = [
        {k: _tensor(np.asarray(v)[i], dev) for k, v in stacked.items()}
        for i in range(n)]
    shared = None
    if "shared_attn" in tree:
        shared = {k: _tensor(v, dev)
                  for k, v in _flat_block(tree["shared_attn"]).items()}
    return LMParams(top, layers, shared)


def evalzoo_params_from_jax(name: str, tree: Mapping, cfg=None,
                            device=None) -> Any:
    """The reference evalzoo net ``name``'s parameter tree, as numpy, in
    the port's layout on ``device`` (default ``cuda``), requiring grad.

    The vision nets and GNMT keep the reference's nested dicts, names
    and layouts (OIHW kernels, ``(in, out)`` dense weights), so each leaf
    converts as it is; the Transformer's stacked layers go through
    :func:`params_from_jax` with its ``cfg``
    (``evalzoo.transformer_config``)."""
    dev = torch_device(device)
    if name == "transformer":
        params = params_from_jax(cfg, tree, dev)
        for t in params.parameters():
            t.requires_grad_(True)
        return params

    def go(v):
        if isinstance(v, Mapping):
            return {k: go(x) for k, x in v.items()}
        return _tensor(v, dev).requires_grad_(True)
    return go(tree)
