"""Fleet query example: rank EVERY registered device, from one trace.

    PYTHONPATH=src python examples/torch/fleet_rank.py [--device cpu]

The production-scale version of the Sec. 5.3 case studies on the PyTorch
port: track a (small) transformer training iteration once, then answer
"how fast, and how cheap, would this be on every device I could buy?" in
one vectorized prediction over the whole registry.  A second,
overlapping query is served from the planner's LRU cache.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

from repro_torch.core import OperationTracker, devices
from repro_torch.core.predictor import default_predictor
from repro_torch.models.evalzoo import make_train_iteration
from repro_torch.serve.fleet import FleetPlanner, format_fleet

#: a transformer small enough to track anywhere
TRANSFORMER = dict(seq=8, d_model=32, n_layers=2, vocab=64)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    batch_size = 16
    it, params, batch = make_train_iteration(
        "transformer", batch=batch_size, device=args.device, **TRANSFORMER)
    trace = OperationTracker("T4").track(it, params, batch,
                                         label="transformer")
    print(f"transformer iteration on T4: {trace.run_time_ms:.1f} ms "
          f"({len(trace.ops)} ops)\n")

    planner = FleetPlanner(predictor=default_predictor(device=args.device))

    t0 = time.perf_counter()
    by_speed = planner.rank(trace, batch_size, by="throughput")
    dt_cold = (time.perf_counter() - t0) * 1e3
    print(f"Ranked by throughput: {len(planner.fleet)} devices in "
          f"{dt_cold:.1f} ms (cold):")
    print(format_fleet(by_speed))

    t0 = time.perf_counter()
    by_cost = planner.rank(trace, batch_size, by="cost")
    dt_warm = (time.perf_counter() - t0) * 1e3
    rentable = [c for c in by_cost if c.cost_per_hour]
    print(f"\nRanked by samples/$: served from cache in {dt_warm:.2f} ms "
          f"(hit rate {planner.stats.hit_rate:.0%}):")
    print(format_fleet(rentable))

    # an overlapping follow-up query: only the new devices are predicted
    subset = devices.PAPER_GPUS + ["tpu-v6e"]
    planner.rank(trace, batch_size, dests=subset)
    print(f"\nAfter an overlapping subset query: hits={planner.stats.hits} "
          f"misses={planner.stats.misses}")
    return by_speed, planner.stats


if __name__ == "__main__":
    main()
