"""Phase 16 (a)'s threaded cold burst of ``chip_smoke.py`` on the CPU.

Serves the phase's two rounds (64 ``/rank`` clients, then 8 ``/sweep``s,
16 ``/rank``s and 2 ``/optimize``s) from one ``PredictionServer`` over
small MLPs (2 x 64) and traces of the phase's sizes, with the clients as
threads of the same process, as the phase runs them.  Each engine pass
is timed twice, by the wall clock and by its thread's CPU time (what
``PredictionService`` records), so the two can be set side by side; each
round prints its sheds, statuses, latencies and the fitted pass model:

  PYTHONPATH=src python experiments/burst_rehearsal.py [--cpus 2] [--wall]

``--cpus N`` keeps this process on its first N allowed CPUs, to
rehearse a host whose cores the burst's threads must share.  ``--wall``
feeds the pass model each pass's wall time instead, as the reference's
service does.
"""

import argparse
import collections
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core import devices  # noqa: E402
from repro_torch.core.predictor import HabitatPredictor  # noqa: E402
from repro_torch.serve.http import PredictionServer  # noqa: E402
from repro_torch.serve.service import PredictionService  # noqa: E402

#: stand-ins for phase 14's five tracked nets, as (label, per_kind,
#: n_alike) of ``chip_smoke.synthetic_trace``: about their op counts
TRACKED = (("resnet50", 60, 2400), ("inception_v3", 40, 300),
           ("dcgan", 10, 80), ("gnmt", 10, 120), ("transformer", 40, 1600))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpus", type=int, default=0,
                    help="CPUs to keep this process on (0: all allowed)")
    ap.add_argument("--wall", action="store_true",
                    help="fit the pass model to wall-clock pass times")
    args = ap.parse_args(argv)
    if args.cpus:
        allowed = sorted(os.sched_getaffinity(0))[:args.cpus]
        os.sched_setaffinity(0, allowed)
        torch.set_num_threads(len(allowed))
    mlps = cs.build_mlps(2, 64)
    _, gold = cs.golden()
    traces = gold + [cs.synthetic_trace(i) for i in range(cs.N_SYNTHETIC)]
    new = [cs.synthetic_trace(100 + i) for i in range(4)]
    tracked = []
    for j, (name, per_kind, n_alike) in enumerate(TRACKED):
        t = cs.synthetic_trace(300 + j, per_kind=per_kind, n_alike=n_alike)
        t.label = f"{name}-stand-in"
        tracked.append(t)
    extra = cs.synthetic_trace(400)
    extra.label = "dcgan-batch64-stand-in"
    everyone = traces + tracked
    docs = {id(t): t.to_dict() for t in everyone + new + [extra]}
    devs = sorted(devices.all_devices())
    fleet_minus = [d for d in devs if d not in cs.DROPPED]

    service = PredictionService(predictor=HabitatPredictor(mlps,
                                                           device="cpu"))
    passes = []
    sweep = service.planner.sweep

    def timed_sweep(*a, **kw):
        w0, c0 = time.perf_counter(), time.thread_time()
        out = sweep(*a, **kw)
        passes.append((time.perf_counter() - w0, time.thread_time() - c0))
        return out

    service.planner.sweep = timed_sweep
    if args.wall:
        record = service._record_pass
        service._record_pass = lambda cold, rect, seconds: record(
            cold, rect, passes[-1][0])
    server = PredictionServer(service).start()
    try:
        rounds = cs.serve_traffic(everyone, new, tracked, extra, fleet_minus,
                                  lambda t: docs[id(t)], stream=False)
        for r, calls in enumerate(rounds, 1):
            passes.clear()
            res, wall = cs._burst(server.url, calls)
            sheds = collections.Counter(c for x in res for c in x[4])
            status = collections.Counter(x[0] for x in res)
            by = collections.defaultdict(list)
            for (route, _), x in zip(calls, res):
                by[route].append(x[3] * 1e3)
            lat = ", ".join(f"{k} p50 {np.median(v):.0f} max {max(v):.0f} ms"
                            for k, v in sorted(by.items()))
            print(f"round {r}: {len(calls)} requests in {wall:.2f} s, sheds "
                  f"{dict(sheds) or 'none'}, statuses {dict(status)}; {lat}")
            if passes:
                w, c = np.asarray(passes).T * 1e3
                print(f"  {len(passes)} engine passes: wall p50 "
                      f"{np.median(w):.1f} ms (max {w.max():.1f}), their "
                      f"threads' CPU p50 {np.median(c):.1f} ms (max "
                      f"{c.max():.1f})")
            sm = service.stats()["split_model"]
            print(f"  pass model: {sm['pass_overhead_ms']:.3f} ms a pass + "
                  f"{sm['cell_cost_ns']:.2f} ns an op-cell, warm discount "
                  f"{sm['warm_discount']:.3f}")
    finally:
        server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
