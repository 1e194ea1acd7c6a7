"""Abstract stand-ins for every (architecture x shape) cell (port of
``repro.launch.specs``).

Where the reference builds ``ShapeDtypeStruct``s with ``jax.eval_shape``,
these are tensors on the ``meta`` device: shapes and dtypes, no storage,
and nothing drawn (``init_params`` on ``meta`` skips its generator).
``input_specs`` gives a cell's step inputs, ``abstract_params`` /
``abstract_train_state`` / ``abstract_decode_state`` the model's state,
``step_fn_for`` the function the cell runs.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.train.optim import Optimizer, adamw
from repro_torch.train.train_step import (TrainState, make_train_step,
                                          named_params)

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device=META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Abstract model inputs for this cell's step function."""
    b, s = shape.global_batch, shape.seq_len
    if shape.mode in ("train", "prefill"):
        batch = {"tokens": sds((b, s), torch.int32)}
        if shape.mode == "train":
            batch["labels"] = sds((b, s), torch.int32)
        if cfg.frontend:
            batch["prefix_embeds"] = sds(
                (b, cfg.frontend_prefix_len, cfg.frontend_dim),
                torch.float32)
        return batch
    # decode: one new token against a seq_len-deep KV cache
    return {"tokens": sds((b, 1), torch.int32)}


def abstract_params(cfg: ModelConfig) -> tfm.LMParams:
    return tfm.init_params(cfg, device=META)


def abstract_train_state(cfg: ModelConfig,
                         optimizer: Optional[Optimizer] = None
                         ) -> TrainState:
    optimizer = optimizer or adamw()
    params = abstract_params(cfg)
    params.requires_grad_(True)
    with torch.no_grad():
        opt = optimizer.init(named_params(params))
    return TrainState(params=params, opt=opt, step=0)


def abstract_decode_state(cfg: ModelConfig, batch: int, max_seq: int) -> Any:
    return tfm.init_decode_state(cfg, batch, max_seq, device=META)


def step_fn_for(cfg: ModelConfig, shape: ShapeConfig,
                optimizer: Optional[Optimizer] = None,
                profile: str = "2d") -> Callable:
    """The function each cell runs: train_step / prefill / decode_step."""
    if shape.mode == "train":
        # dp cannot keep full-mesh batch coverage across microbatches
        accum = cfg.train_accum_steps if profile == "2d" else 1
        return make_train_step(cfg, optimizer or adamw(),
                               accum_steps=accum)
    if shape.mode == "prefill":
        max_seq = shape.seq_len + cfg.frontend_prefix_len

        def prefill_step(params, batch):
            return tfm.prefill(params, cfg, batch["tokens"], max_seq,
                               batch.get("prefix_embeds"))
        return prefill_step

    def serve_step(params, batch, state):
        return tfm.decode_step(params, cfg, batch["tokens"], state)
    return serve_step
