"""Carry the reference's parameters into the port.

:func:`params_from_jax` takes the JAX package's parameter tree as numpy
arrays (``jax.tree.map(np.asarray, params)``: layers stacked on a leading
axis, as ``lax.scan`` wants them) and returns the port's
:class:`~repro_torch.models.transformer.LMParams` holding the same
numbers, so both packages compute the same function.  It imports no JAX:
bfloat16 arrays (numpy's ``ml_dtypes`` extension type) are reinterpreted
bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch

from repro_torch.core.devices import torch_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import LMParams, _check_family

_TOP = ("embed", "final_norm", "lm_head")


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)         # a writable copy: JAX's host arrays are not
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(cfg: ModelConfig, tree: Mapping,
                    device=None) -> LMParams:
    """The reference's ``init_params(cfg, key)`` tree, as numpy, on
    ``device`` (default ``cuda``).  Dense layers carry ``tree["layers"]``'s
    tensors; ssm layers carry ``ln`` beside the ``mamba`` sub-tree's."""
    _check_family(cfg)
    dev = torch_device(device)
    top = {k: _tensor(tree[k], dev) for k in _TOP if k in tree}
    stacked = tree["layers"]
    if cfg.family == "ssm":
        stacked = {"ln": stacked["ln"], **stacked["mamba"]}
    n = cfg.n_layers
    for k, v in stacked.items():
        if np.shape(v)[0] != n:
            raise ValueError(f"layers[{k!r}] stacks {np.shape(v)[0]} layers, "
                             f"config has {n}")
    layers: List[Dict[str, torch.Tensor]] = [
        {k: _tensor(np.asarray(v)[i], dev) for k, v in stacked.items()}
        for i in range(n)]
    return LMParams(top, layers)
