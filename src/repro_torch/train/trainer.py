"""The fault-tolerant training loop (port of ``repro.train.trainer``).

Responsibilities beyond the training step:
  * periodic async checkpoints + restore-on-start (checkpoint.py), one
    checkpoint thread in flight at a time, and a final one at the last
    step (unlike the reference, not a second time where the last
    periodic save already wrote that step),
  * deterministic data skip-ahead after restore (data.py),
  * straggler watchdog: per-step wall-clock EWMA; steps slower than
    ``straggler_factor`` x the EWMA are logged and counted (the first
    step of a run is no baseline) — on a real fleet this signal triggers
    a hot-spare swap; here it drives tests and metrics,
  * failure injection hook for the fault-tolerance tests.

A step is timed from its launch to the host's read of its loss, the
counterpart of the reference's ``jax.block_until_ready``.  Batches move
to the state's device, by default ``cuda``.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.devices import torch_device
from repro_torch.models.config import ModelConfig
from repro_torch.train import checkpoint
from repro_torch.train.data import SyntheticTokens
from repro_torch.train.optim import Optimizer, adamw
from repro_torch.train.train_step import init_state, make_train_step


def default_checkpoint_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainerConfig:
    checkpoint_dir: str = dataclasses.field(
        default_factory=default_checkpoint_dir)
    checkpoint_every: int = 50
    async_checkpoint: bool = True
    log_every: int = 10
    straggler_factor: float = 3.0
    max_steps: int = 200


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


class Trainer:
    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 tcfg: Optional[TrainerConfig] = None,
                 optimizer: Optional[Optimizer] = None,
                 train_step: Optional[Callable] = None,
                 seed: int = 0,
                 failure_injector: Optional[Callable[[int], None]] = None,
                 device=None):
        self.cfg = cfg
        self.tcfg = tcfg or TrainerConfig()
        self.device = torch_device(device)
        self.optimizer = optimizer or adamw()
        self.data = SyntheticTokens(cfg, batch, seq, seed=seed)
        self.train_step = train_step or make_train_step(cfg, self.optimizer)
        self.state = init_state(cfg, seed, self.optimizer, self.device)
        self.failure_injector = failure_injector
        self.step_times: list = []
        self.straggler_steps: list = []
        #: every step's loss, by step, over all runs of this trainer
        self.losses: Dict[int, float] = {}
        #: seconds the loop spent in ``checkpoint.save`` and joins
        self.checkpoint_wait_s = 0.0
        self._ckpt_thread = None
        self._saved_step: Optional[int] = None

    # -- fault tolerance ----------------------------------------------------
    def restore_if_available(self, shardings: Any = None) -> int:
        """Restore the latest checkpoint, if any, distributed onto
        ``shardings`` where given (``checkpoint.restore``'s elastic
        path); returns the restored step, or 0."""
        step = checkpoint.latest_step(self.tcfg.checkpoint_dir)
        if step is None:
            return 0
        self.state, step = checkpoint.restore(
            self.tcfg.checkpoint_dir, self.state, step, self.device,
            shardings=shardings)
        return int(self.state.step)

    def _maybe_checkpoint(self, step: int, force: bool = False):
        if step == self._saved_step:
            return      # the final save of a step the loop just saved
        if force or (step > 0 and step % self.tcfg.checkpoint_every == 0):
            self._saved_step = step
            t0 = time.perf_counter()
            if self._ckpt_thread is not None:
                self._ckpt_thread.join()  # one in flight at a time
            self._ckpt_thread = checkpoint.save(
                self.tcfg.checkpoint_dir, step, self.state,
                blocking=not self.tcfg.async_checkpoint)
            self.checkpoint_wait_s += time.perf_counter() - t0

    def wait_for_checkpoint(self) -> None:
        """Join the checkpoint thread in flight, if any."""
        if self._ckpt_thread is not None:
            t0 = time.perf_counter()
            self._ckpt_thread.join()
            self.checkpoint_wait_s += time.perf_counter() - t0

    # -- main loop -----------------------------------------------------------
    def run(self, n_steps: Optional[int] = None,
            log: Callable[[str], None] = print) -> Dict[str, float]:
        n_steps = n_steps or self.tcfg.max_steps
        start = self.restore_if_available()
        if start:
            log(f"[trainer] restored checkpoint at step {start}")
        ewma = None
        losses = []
        for step in range(start, n_steps):
            if self.failure_injector is not None:
                self.failure_injector(step)  # may raise (simulated crash)
            batch = to_device(self.data.batch_at(step), self.device)
            t0 = time.perf_counter()
            self.state, metrics = self.train_step(self.state, batch)
            loss = float(metrics["loss"])       # the host waits for it
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            if step == start:
                pass  # first step warms the caches; not a baseline
            elif ewma is not None and dt > self.tcfg.straggler_factor * ewma:
                self.straggler_steps.append(step)
                log(f"[trainer] straggler at step {step}: "
                    f"{dt * 1e3:.1f}ms vs EWMA {ewma * 1e3:.1f}ms")
            else:
                ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            losses.append(loss)
            self.losses[step] = loss
            if step % self.tcfg.log_every == 0:
                log(f"[trainer] step {step} loss {loss:.4f} "
                    f"{dt * 1e3:.1f}ms")
            self._maybe_checkpoint(step + 1)
        self._maybe_checkpoint(n_steps, force=True)
        self.wait_for_checkpoint()
        return {"final_loss": losses[-1] if losses else float("nan"),
                "first_loss": losses[0] if losses else float("nan"),
                "mean_step_ms": float(np.mean(self.step_times) * 1e3)
                if self.step_times else float("nan"),
                "stragglers": len(self.straggler_steps)}
