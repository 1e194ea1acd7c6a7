"""End-to-end example on the PyTorch port: train a reduced LM with
checkpointing, then serve a few batched requests from it.

    PYTHONPATH=src python examples/torch/train_lm.py [--device cpu] \
        [--arch mamba2-130m] [--steps 200]
"""

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np

from repro_torch.configs import ARCHS, get_config
from repro_torch.models.config import smoke_config
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.train.optim import adamw
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCHS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="default: a temporary directory, removed after")
    args = ap.parse_args(argv)

    cfg = smoke_config(get_config(args.arch))
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = args.checkpoint_dir or tmp
        trainer = Trainer(cfg, batch=8, seq=64,
                          tcfg=TrainerConfig(checkpoint_dir=ckpt,
                                             checkpoint_every=50,
                                             max_steps=args.steps,
                                             log_every=25),
                          optimizer=adamw(lr=1e-3), device=args.device)
        stats = trainer.run(args.steps)
    print(f"\ntraining done: loss {stats['first_loss']:.3f} -> "
          f"{stats['final_loss']:.3f}, "
          f"{stats['mean_step_ms']:.1f} ms/step, "
          f"{stats['stragglers']} stragglers\n")

    # serve from the trained weights
    engine = ServingEngine(cfg, trainer.state.params, batch=4, max_seq=96,
                           device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(2, cfg.vocab_size, 8,
                                               dtype=np.int32),
                    max_new_tokens=8) for i in range(6)]
    done = engine.serve(reqs)
    print(f"served {len(done)} requests; sample output: "
          f"{done[0].output.tolist()}")
    return stats, done


if __name__ == "__main__":
    main()
