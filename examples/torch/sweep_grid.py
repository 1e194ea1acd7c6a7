"""Multi-trace what-if sweep: many workload variants x every device.

    PYTHONPATH=src python examples/torch/sweep_grid.py [--device cpu]

The fleet query of ``fleet_rank.py`` asks about ONE workload; capacity
planning asks about a *family* of them: "how does the best device change
as I scale the batch size?".  Each batch size is tracked once on the
PyTorch port, the traces are stacked into one ragged grid, and a single
``FleetPlanner.sweep`` pass prices every (variant, device) cell.  A
repeat query is served entirely from the per-trace fingerprint cache.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

from repro_torch.core import OperationTracker
from repro_torch.core.predictor import default_predictor
from repro_torch.models.evalzoo import make_train_iteration
from repro_torch.serve.fleet import FleetPlanner, format_sweep

#: a transformer small enough to track anywhere
TRANSFORMER = dict(seq=8, d_model=32, n_layers=2, vocab=64)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    batch_sizes = [4, 16, 64]
    tracker = OperationTracker("T4")
    traces = []
    for b in batch_sizes:
        it, params, batch = make_train_iteration(
            "transformer", batch=b, device=args.device, **TRANSFORMER)
        traces.append(tracker.track(it, params, batch,
                                    label=f"transformer-b{b}"))
    n_ops = sum(len(t.ops) for t in traces)
    print(f"traced {len(traces)} batch-size variants on T4 "
          f"({n_ops} ops total)\n")

    planner = FleetPlanner(predictor=default_predictor(device=args.device))

    t0 = time.perf_counter()
    times = planner.sweep(traces)
    dt_cold = (time.perf_counter() - t0) * 1e3
    print(f"what-if grid: {len(traces)} traces x {len(planner.fleet)} "
          f"devices in one ragged pass ({dt_cold:.1f} ms, predicted "
          f"iteration ms):")
    print(format_sweep([t.label for t in traces], times))

    t0 = time.perf_counter()
    planner.sweep(traces)
    dt_warm = (time.perf_counter() - t0) * 1e3
    print(f"\nrepeat sweep: {dt_warm:.2f} ms, hit rate "
          f"{planner.stats.hit_rate:.0%} "
          f"(hits={planner.stats.hits} misses={planner.stats.misses})")

    # the grid answers scaling questions row-wise: throughput-optimal
    # device per batch size
    for t, row in zip(traces, times):
        best = min(row, key=row.get)
        print(f"  {t.label}: best device {best} ({row[best]:.2f} ms/iter)")
    return times, planner.stats


if __name__ == "__main__":
    main()
