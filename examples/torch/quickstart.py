"""Quickstart: the paper's Listing 1 on the PyTorch port.

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

Tracks one real training iteration of a (smoke-sized) Qwen3-family model
on the device you have, then predicts its execution time on devices you
do not have, and ranks them.  On the card the origin is the H100 and
every op is timed there (``wallclock``); on the CPU the origin is
``cpu-host`` and the op times come from its simulated spec.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import torch

from repro_torch.configs import get_config
from repro_torch.core import Device, OperationTracker
from repro_torch.core import cost as cost_mod
from repro_torch.core.devices import torch_device
from repro_torch.core.predictor import default_predictor
from repro_torch.models.config import smoke_config
from repro_torch.train.optim import adamw
from repro_torch.train.train_step import init_state, make_train_step

DESTS = [Device.TPU_V5E, Device.TPU_V5P, Device.TRAINIUM2, Device.V100,
         Device.T4]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch_device(args.device)

    cfg = smoke_config(get_config("qwen3-0.6b"))
    optimizer = adamw()
    state = init_state(cfg, 0, optimizer, device=device)
    train_step = make_train_step(cfg, optimizer)
    batch = {"tokens": torch.ones((4, 64), dtype=torch.int32, device=device),
             "labels": torch.ones((4, 64), dtype=torch.int32, device=device)}

    # ----- Listing 1 -------------------------------------------------------
    if device.type == "cuda":
        tracker = OperationTracker(origin_device=Device.H100_SXM,
                                   measure="wallclock")
    else:
        tracker = OperationTracker(origin_device=Device.CPU_HOST)
    trace = tracker.track(train_step, state, batch)
    print(f"traced {len(trace.ops)} ops; "
          f"measured iteration on {trace.origin_device}: "
          f"{trace.run_time_ms:.2f} ms")

    predictor = default_predictor(device=device)
    for dest in DESTS:
        predicted = trace.to_device(dest, predictor=predictor)
        print(f"Pred. iter. exec. time on {dest:<11}: "
              f"{predicted.run_time_ms:8.3f} ms")

    print("\nRanked by throughput:")
    ranking = cost_mod.rank_devices(trace, 4, DESTS, predictor=predictor)
    print(cost_mod.format_ranking(ranking))
    return trace, ranking


if __name__ == "__main__":
    main()
