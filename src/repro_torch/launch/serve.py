"""Serving launcher: batched requests through the port's ServingEngine,
then fleet questions about the served model's decode step.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --requests 8 --max-new 16 --fleet --sweep     # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \\
      --fleet --sweep

The LM-serving mode of ``repro.launch.serve``: random weights from a
seeded generator, random prompts from a numpy seed, greedy decoding, and
the same summary lines.  ``--fleet`` tracks one ``decode_step`` and ranks
every registered device for it; ``--sweep`` tracks it at each
``--sweep-batches`` size and predicts the grid in one ragged pass;
``--fleet-mlps`` predicts with the trained MLPs (``default_predictor``)
instead of the analytical fallback; ``--cache PATH`` shares the planner's
results through a sqlite file.  On the GPU the step is tracked with
origin ``H100-SXM`` and timed op by op on the card (``wallclock``); with
``--device cpu`` the origin is ``cpu-host`` and its times are simulated,
as in the reference.  The reference's ``--optimize`` and ``--serve``
(the what-if optimizer and the HTTP prediction service) come with the
serving stack (ROADMAP.md, queue 1 item 3) and are refused here.
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
    ap.add_argument("--fleet", action="store_true",
                    help="rank every registered device for this workload")
    ap.add_argument("--fleet-mlps", action="store_true",
                    help="use the trained-MLP predictor for --fleet/"
                         "--sweep (trains/loads artifacts; slower first "
                         "run)")
    ap.add_argument("--sweep", action="store_true",
                    help="what-if sweep: decode tracked at every "
                         "--sweep-batches size, predicted on the whole "
                         "fleet in one ragged pass")
    ap.add_argument("--sweep-batches", default="1,2,4",
                    help="comma-separated decode batch sizes for --sweep")
    ap.add_argument("--cache", default=None, metavar="PATH",
                    help="shared result cache of the fleet planner: a "
                         "sqlite file")
    ap.add_argument("--optimize", action="store_true",
                    help="not ported yet (comes with the serving stack)")
    ap.add_argument("--serve", action="store_true",
                    help="not ported yet (comes with the serving stack)")
    args = ap.parse_args(argv)
    if args.optimize or args.serve:
        ap.error("--optimize and --serve (the what-if optimizer and the "
                 "HTTP prediction service) come with the serving stack, "
                 "ROADMAP.md queue 1 item 3; they are not ported yet")

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
    if args.fleet or args.sweep:
        _fleet_modes(args, cfg, params, engine, device)


def _fleet_modes(args, cfg, params, engine: ServingEngine,
                 device: torch.device) -> None:
    """``--fleet`` / ``--sweep``: track the decode step and ask the
    planner, as the reference's CLI does."""
    from repro_torch.core.predictor import HabitatPredictor, default_predictor
    from repro_torch.core.trace import OperationTracker
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.fleet import (FleetPlanner, format_fleet,
                                         format_sweep)

    predictor = (default_predictor(device=device) if args.fleet_mlps
                 else HabitatPredictor(device=device))
    planner = FleetPlanner(predictor=predictor, cache=args.cache)
    tracker = (OperationTracker("H100-SXM", measure="wallclock")
               if device.type == "cuda" else OperationTracker("cpu-host"))

    def track(eng: ServingEngine, label: str):
        token = torch.as_tensor(eng.last_token, dtype=torch.long,
                                device=device)
        return tracker.track(
            lambda p, t, s: tfm.decode_step(p, cfg, t, s),
            params, token, eng.state, label=label)

    if args.fleet:
        trace = track(engine, f"{args.arch}-decode")
        t0 = time.perf_counter()
        ranking = planner.rank(trace, batch_size=args.batch)
        dt = (time.perf_counter() - t0) * 1e3
        print(f"\nfleet ranking for one decode step "
              f"({len(trace.ops)} ops x {len(planner.fleet)} devices, "
              f"{dt:.1f} ms; origin {trace.origin_device}):")
        print(format_fleet(ranking))
        by_cost = planner.rank(trace, batch_size=args.batch, by="cost")
        rentable = [c for c in by_cost if c.cost_per_hour]
        if rentable:
            print(f"\nbest samples/$: {rentable[0].device} "
                  f"(cache hit rate {planner.stats.hit_rate:.0%})")

    if args.sweep:
        batches = [int(b) for b in args.sweep_batches.split(",")]
        traces = [track(ServingEngine(cfg, params, b, args.max_seq,
                                      device=device),
                        f"{args.arch}-decode-b{b}") for b in batches]
        t0 = time.perf_counter()
        times = planner.sweep(traces)
        dt = (time.perf_counter() - t0) * 1e3
        n_ops = sum(len(t.ops) for t in traces)
        print(f"\nwhat-if sweep: {len(traces)} traces "
              f"({n_ops} ops total) x {len(planner.fleet)} devices in "
              f"{dt:.1f} ms (predicted iteration ms):")
        print(format_sweep([t.label for t in traces], times))
        planner.sweep(traces)   # repeat query: served from the cache
        print(f"sweep cache: hits={planner.stats.hits} "
              f"misses={planner.stats.misses} "
              f"(hit rate {planner.stats.hit_rate:.0%})")


if __name__ == "__main__":
    main()
