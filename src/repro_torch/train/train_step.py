"""The training step: loss -> grads -> optimizer update (port of
``repro.train.train_step``).

Supports gradient accumulation (a loop over microbatches summing in
float32, as the reference's ``scan`` does), gradient clipping by the
float32 global norm, and any optimizer of :mod:`repro_torch.train.optim`.
Mixed precision as in the reference: parameters stay in
``cfg.param_dtype``, the clipped gradients and the optimizer's math are
float32.

A :class:`TrainState` holds the model's :class:`LMParams` (every tensor
requiring grad), the optimizer's tree keyed by the parameters' names
(``LMParams.named_parameters()``) and the step as an int.  The step is
pure like the reference's: it returns a new state with new parameter
tensors and never writes into the old one.  Gradients come from
``torch.autograd.grad`` of ``transformer.loss_fn``, through the flash
attention and SSD ops' own backward.

On a mesh (``parallel.ctx.use_mesh``, the state and batch distributed by
``parallel.sharding``) the same step runs on DTensors: the global norm is
a ``Partial`` sum over the shards made full before the clip, the
microbatches of accumulation are the reference's row blocks of the
batch-sharded global batch, each sharded again as the batch is, and the
new parameters and moments keep the placements of the parameters they
replace.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import LMParams
from repro_torch.parallel.ctx import is_dtensor
from repro_torch.train.optim import Optimizer, adamw


@dataclasses.dataclass
class TrainState:
    params: LMParams
    opt: Any
    step: int


def named_params(params: LMParams) -> Dict[str, torch.Tensor]:
    """The parameter tree the optimizer walks: name -> tensor."""
    return dict(params.named_parameters())


def init_state(cfg: ModelConfig, seed: int = 0,
               optimizer: Optional[Optimizer] = None,
               device=None) -> TrainState:
    """Parameters from ``init_params(cfg, seed, device)`` (default device
    ``cuda``), requiring grad, and the optimizer's initial state."""
    optimizer = optimizer or adamw()
    params = tfm.init_params(cfg, seed=seed, device=device)
    params.requires_grad_(True)
    with torch.no_grad():
        opt = optimizer.init(named_params(params))
    return TrainState(params=params, opt=opt, step=0)


def _replicated(x: torch.Tensor) -> torch.Tensor:
    """A DTensor reduced and replicated on every mesh dim (a ``Partial``
    sum made full); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh,
                          [Replicate()] * x.device_mesh.ndim)


def _placed_like(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """``new`` on ``old``'s placements where ``old`` is a DTensor."""
    if not is_dtensor(old) or \
            tuple(new.placements) == tuple(old.placements):
        return new
    return new.redistribute(old.device_mesh, old.placements)


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The float32 global L2 norm of a gradient tree.  Over DTensors each
    leaf's sum of squares is a ``Partial`` sum over its shards; their
    total is made full (one reduction) before the root."""
    total = None
    for g in tree.values():
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(_replicated(total))


def _microbatch(x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Rows [i size, (i + 1) size) of the global batch, as the reference
    cuts its microbatches; a batch-sharded DTensor's block is sharded
    again as the batch was."""
    size = x.shape[0] // n
    return _placed_like(x[i * size:(i + 1) * size], x)


def make_train_step(cfg: ModelConfig, optimizer: Optional[Optimizer] = None,
                    accum_steps: int = 1, clip_norm: float = 1.0,
                    loss_fn: Optional[Callable] = None) -> Callable:
    """Build ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` holds tensors on the state's device with a leading global
    batch dim; with ``accum_steps`` > 1 it is split into that many
    microbatches, run one after another.  ``metrics``: ``ce``, ``aux``,
    ``loss``, ``grad_norm`` (0-d device tensors) and ``step``; with
    accumulation ``ce`` is the mean loss and ``aux`` zero, as in the
    reference."""
    optimizer = optimizer or adamw()
    loss_fn = loss_fn or (lambda p, b: tfm.loss_fn(p, cfg, b))

    def grads_of(params: LMParams, batch: Dict):
        named = named_params(params)
        loss, metrics = loss_fn(params, batch)
        got = torch.autograd.grad(loss, list(named.values()),
                                  allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(named.items(), got)}
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def train_step(state: TrainState, batch: Dict
                   ) -> Tuple[TrainState, Dict[str, Any]]:
        params = state.params
        if accum_steps > 1:
            grads = {n: torch.zeros_like(p, dtype=torch.float32)
                     for n, p in params.named_parameters()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=params.device)
            for i in range(accum_steps):
                micro = {k: _microbatch(v, i, accum_steps)
                         for k, v in batch.items()}
                mloss, _, mgrads = grads_of(params, micro)
                grads = {n: g + mgrads[n] for n, g in grads.items()}
                loss = loss + mloss
            grads = {n: g / accum_steps for n, g in grads.items()}
            loss = loss / accum_steps
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        else:
            loss, metrics, grads = grads_of(params, batch)

        with torch.no_grad():
            gnorm = global_norm(grads)
            if clip_norm:
                scale = torch.clamp(clip_norm / torch.clamp_min(gnorm, 1e-9),
                                    max=1.0)
                grads = {n: g.to(torch.promote_types(g.dtype, torch.float32))
                         * scale for n, g in grads.items()}
            named = named_params(params)
            new_named, new_opt = optimizer.update(
                grads, state.opt, named, state.step)
            new_params = params.map(
                lambda n, _: _placed_like(new_named[n], named[n]))
            new_opt = _opt_placed_like(new_opt, named)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm,
                       step=state.step + 1)
        return TrainState(params=new_params, opt=new_opt,
                          step=state.step + 1), metrics

    return train_step


def _opt_placed_like(tree: Any, named: Dict[str, torch.Tensor]) -> Any:
    """The optimizer's tree with each leaf keyed by a parameter's name on
    that parameter's placements."""
    if isinstance(tree, dict):
        return {k: _placed_like(v, named[k]) if k in named and
                isinstance(v, torch.Tensor) else _opt_placed_like(v, named)
                for k, v in tree.items()}
    return tree
