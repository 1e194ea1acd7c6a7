"""End-to-end training entry point (port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --steps 100 --batch 2 --seq 4096                  # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \\
      --steps 3 --batch 4 --seq 32

Integrates the paper's predictor as a first-class feature: pass
``--predict-on V100,T4,...`` to track the *actual* training step
(``make_train_step``'s, the optimizer update included) and print its
predicted step time, throughput and cost-normalized throughput on every
candidate device before (or, with ``--predict-only``, instead of)
training: the paper's Listing 1 on the real step.  On the GPU the step
is tracked with origin ``H100-SXM`` and each op timed on the card
(``wallclock``), and the trained-MLP ``default_predictor`` scores it
there (the scorer kernels); with ``--device cpu`` the origin is
``cpu-host`` and its times are simulated, as in the reference.
``--trace-out`` writes the tracked trace as JSON.  Training runs
:class:`~repro_torch.train.trainer.Trainer` on ``--device`` (default
``cuda``) with AdamW at ``--lr``; ``--smoke`` takes the arch's
CPU-sized config with dense attention, as the reference does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import List, Optional

from repro_torch.configs import ARCHS, get_config
from repro_torch.core import OperationTracker, cost as cost_mod
from repro_torch.core.devices import torch_device
from repro_torch.models.config import smoke_config
from repro_torch.train.optim import adamw
from repro_torch.train.train_step import init_state, make_train_step
from repro_torch.train.trainer import (Trainer, TrainerConfig,
                                       default_checkpoint_dir, to_device)


def kernel_launches() -> dict:
    """Every kernel wrapper's launch count, by kernel."""
    from repro_torch.kernels import flash_attention, fused_mlp, \
        fused_mlp_score, ssd
    return {k: v for mod in (fused_mlp_score, fused_mlp, flash_attention,
                             ssd) for k, v in mod.LAUNCHES.items()}


def predict(cfg, args, optimizer, device) -> None:
    """Track one training step of ``cfg`` on ``device`` and rank the
    ``--predict-on`` devices for it."""
    from repro_torch.core.predictor import default_predictor
    from repro_torch.train.data import SyntheticTokens
    step_fn = make_train_step(cfg, optimizer)
    state = init_state(cfg, 0, optimizer, device)
    batch = to_device(SyntheticTokens(cfg, args.batch, args.seq)
                      .batch_at(0), device)
    origin, method = (("H100-SXM", "wallclock") if device.type == "cuda"
                      else ("cpu-host", "simulate"))
    trace = OperationTracker(origin, measure=method).track(
        step_fn, state, batch, label=args.arch)
    del state, batch
    if args.trace_out:
        with open(args.trace_out, "w") as f:
            f.write(trace.to_json())
    candidates = args.predict_on.split(",")
    ranking = cost_mod.rank_devices(
        trace, args.batch, candidates,
        predictor=default_predictor(device=device))
    print(f"\nPredicted training performance for {cfg.name} "
          f"(batch={args.batch}, seq={args.seq}), traced on {origin}: "
          f"{len(trace.ops)} ops, {trace.run_time_ms:.1f} ms measured")
    print(cost_mod.format_ranking(ranking))
    print(f"kernel launches: {json.dumps(kernel_launches())}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default=default_checkpoint_dir())
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--predict-on", default=None,
                    help="comma-separated device names to cost out "
                         "(e.g. V100,T4,tpu-v5e)")
    ap.add_argument("--predict-only", action="store_true")
    ap.add_argument("--trace-out", default=None,
                    help="write the tracked step's trace (JSON) here")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train and track on "
                         "(default cuda; cpu runs the plain kernels)")
    return ap


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)

    device = torch_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
        cfg = dataclasses.replace(cfg, use_flash=False)
    optimizer = adamw(lr=args.lr)

    if args.predict_on:
        predict(cfg, args, optimizer, device)
        if args.predict_only:
            return

    trainer = Trainer(
        cfg, args.batch, args.seq,
        TrainerConfig(checkpoint_dir=args.checkpoint_dir,
                      checkpoint_every=args.checkpoint_every,
                      max_steps=args.steps),
        optimizer=optimizer, device=device)
    stats = trainer.run(args.steps)
    print(f"\ndone: {stats}")


if __name__ == "__main__":
    main()
