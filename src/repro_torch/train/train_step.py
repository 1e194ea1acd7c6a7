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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import LMParams
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


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The float32 global L2 norm of a gradient tree."""
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree.values()))


def _microbatch(x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    size = x.shape[0] // n
    return x[i * size:(i + 1) * size]


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
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
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
            new_named, new_opt = optimizer.update(
                grads, state.opt, named_params(params), state.step)
            new_params = params.map(lambda n, _: new_named[n])
        metrics = dict(metrics, loss=loss, grad_norm=gnorm,
                       step=state.step + 1)
        return TrainState(params=new_params, opt=new_opt,
                          step=state.step + 1), metrics

    return train_step
