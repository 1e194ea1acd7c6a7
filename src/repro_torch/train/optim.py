"""Optimizers as pure functions over a tensor tree (port of
``repro.train.optim``).

SGD (the paper uses it for the vision models), Adam (the rest), AdamW for
the LM-family training runs, written out by hand as the reference writes
them.  ``torch.optim`` is not used: its AdamW decays the weights before
the moment update and rounds in another order.

A tree is a tensor or a dict, list or tuple of trees (the training step's
is a dict of the model's named parameters).  ``update`` returns new
tensors and never writes into its arguments, as the reference's pure
transforms return new arrays.  Dtypes follow the reference's JAX type
promotion, where a 0-d float32 array is as strong as any other array
(PyTorch lets a 0-d tensor yield to a bfloat16 one): the bias-corrected
moments are divided in float32, and float32 gradients (the training step
clips in float32) make float32 moments even for bfloat16 parameters.
Each updated parameter is computed in float32 and cast back to its
dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, int], Tuple[Any, Any]]
    # update(grads, opt_state, params, step) -> (new_params, new_opt_state)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def _f32_div(x: torch.Tensor, d: np.float32) -> torch.Tensor:
    """``x / d`` for a float32 scalar ``d`` (the reference's 0-d float32
    array), promoted as JAX promotes it."""
    return x.to(torch.promote_types(x.dtype, torch.float32)) / float(d)


def sgd(lr: float = 1e-2, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum:
            return tree_map(torch.zeros_like, params)
        return ()

    def update(grads, state, params, step):
        del step
        if momentum:
            state = tree_map(lambda m, g: momentum * m + g, state, grads)
            upd = state
        else:
            upd = grads
        new_params = tree_map(lambda p, u: p - lr * u, params, upd)
        return new_params, state

    return Optimizer(init, update)


def _adam_core(lr, b1, b2, eps, wd) -> Optimizer:
    def init(params):
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params)}

    def update(grads, state, params, step):
        # the bias corrections in float32 on the host: a device scalar made
        # from a host number would make the host wait for the device
        t = np.float32(step) + np.float32(1.0)
        c1 = np.float32(1.0) - np.float32(b1) ** t
        c2 = np.float32(1.0) - np.float32(b2) ** t
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g),
                     state["v"], grads)

        def upd(p, m_, v_):
            u = _f32_div(m_, c1) / (torch.sqrt(_f32_div(v_, c2)) + eps)
            if wd:
                u = u + wd * p
            return (p.to(torch.float32) - lr * u).to(p.dtype)
        new_params = tree_map(upd, params, m, v)
        return new_params, {"m": m, "v": v}

    return Optimizer(init, update)


def adam(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, 0.0)


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, weight_decay)
