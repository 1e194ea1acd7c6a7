"""Case-study example: should I rent a cloud accelerator?

    PYTHONPATH=src python examples/torch/gpu_selection.py [--device cpu]

The paper's Sec. 5.3 workflow on the PyTorch port: track a (small) GNMT
training iteration, take its op times as the P4000's (simulated), predict
throughput and cost-normalized throughput for rentable devices, and print
both rankings.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

from repro_torch.core import OperationTracker
from repro_torch.core import cost as cost_mod
from repro_torch.core.predictor import default_predictor
from repro_torch.models.evalzoo import make_train_iteration

#: a GNMT small enough to track anywhere (the paper's is 4 x 512 at 32k)
GNMT = dict(seq=5, hidden=16, vocab=64, layers=2)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    batch_size = 16
    it, params, batch = make_train_iteration(
        "gnmt", batch=batch_size, device=args.device, **GNMT)
    trace = OperationTracker("P4000").track(it, params, batch, label="gnmt")
    print(f"GNMT iteration on P4000: {trace.run_time_ms:.1f} ms "
          f"({len(trace.ops)} ops)\n")

    candidates = ["P100", "T4", "V100", "tpu-v5e", "trainium1"]
    pred = default_predictor(device=args.device)

    print("Ranked by throughput (maximize speed):")
    by_speed = cost_mod.rank_devices(trace, batch_size, candidates,
                                     predictor=pred, by="throughput")
    print(cost_mod.format_ranking(by_speed))

    print("\nRanked by cost-normalized throughput (maximize samples/$):")
    by_cost = cost_mod.rank_devices(trace, batch_size, candidates,
                                    predictor=pred, by="cost")
    print(cost_mod.format_ranking(by_cost))
    return by_speed, by_cost


if __name__ == "__main__":
    main()
