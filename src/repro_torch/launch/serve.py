"""Serving driver: batched requests through the port's ServingEngine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --requests 8 --max-new 16                     # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke

The LM-serving mode of ``repro.launch.serve``: random weights from a
seeded generator, random prompts from a numpy seed, greedy decoding, and
the same summary lines.  The reference's fleet, sweep, optimizer and
HTTP-service modes are not ported yet (ROADMAP.md, queue 1 items 5-6).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.devices import torch_device
from repro_torch.models import init_params
from repro_torch.models.config import smoke_config
from repro_torch.serve.engine import Request, ServingEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced same-family config (fp32)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on ('cpu' runs the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)

    device = torch_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    params = init_params(cfg, seed=0, device=device)
    engine = ServingEngine(cfg, params, args.batch, args.max_seq,
                           device=device)

    rng = np.random.default_rng(0)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab_size, args.prompt_len,
                                        dtype=np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    done = engine.serve(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in done)
    print(f"served {len(done)}/{args.requests} requests, {toks} tokens in "
          f"{dt:.2f}s ({toks / dt:.1f} tok/s)")
    for r in done[:3]:
        print(f"  req {r.uid}: {r.output.tolist()}")


if __name__ == "__main__":
    main()
