"""Prediction service demo: concurrent what-if queries, coalesced.

    PYTHONPATH=src python examples/torch/serve_client.py [--device cpu]

Starts the PyTorch port's HTTP prediction service in-process, then plays
a burst of concurrent clients: several threads ask "which device should
run my model?" about a family of batch-size variants at the same time.
The service coalesces the burst (requests arriving within the window are
stacked into ONE ragged ``predict_sweep`` pass) and ``/stats`` shows the
receipts: engine passes against requests, coalesced batch sizes, and
cache hits once the same model comes back around.
"""

import argparse
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

from repro_torch.core import OperationTracker
from repro_torch.core.predictor import HabitatPredictor
from repro_torch.models.evalzoo import make_train_iteration
from repro_torch.serve.http import PredictionClient, PredictionServer
from repro_torch.serve.service import PredictionService

#: a transformer small enough to track anywhere
TRANSFORMER = dict(seq=8, d_model=32, n_layers=2, vocab=64)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # -- track a family of workloads ---------------------------------------
    batch_sizes = [4, 8, 16, 32]
    tracker = OperationTracker("T4")
    traces = []
    for b in batch_sizes:
        it, params, batch = make_train_iteration(
            "transformer", batch=b, device=args.device, **TRANSFORMER)
        traces.append(tracker.track(it, params, batch,
                                    label=f"transformer-b{b}"))
    print(f"traced {len(traces)} batch-size variants on T4")

    # -- start the service (in-process; `launch/serve.py --serve --workers
    # N` runs the same thing as a multi-process pool with a shared cache)
    service = PredictionService(
        predictor=HabitatPredictor(device=args.device),
        coalesce_window_ms=20.0)
    server = PredictionServer(service).start()
    client = PredictionClient(server.url)
    print(f"service up at {server.url}\n")
    try:
        # -- a burst of concurrent clients ---------------------------------
        results = {}
        barrier = threading.Barrier(len(traces))

        def ask(tr):
            barrier.wait()                       # everyone queries at once
            results[tr.label] = client.rank(tr, batch_size=32)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=ask, args=(tr,))
                   for tr in traces]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = (time.perf_counter() - t0) * 1e3

        print(f"{len(traces)} concurrent rank queries answered in "
              f"{dt:.1f} ms:")
        for label in sorted(results):
            best = results[label][0]
            print(f"  {label:>16}: best {best['device']:<10} "
                  f"({best['iter_ms']:.2f} ms/iter, "
                  f"{best['speedup_vs_origin']:.1f}x vs T4)")

        stats = client.stats()
        co = stats["coalescing"]
        print(f"\ncoalescing: {stats['requests']['rank']} requests -> "
              f"{co['batches']} batch(es), {stats['engine_passes']} engine "
              f"pass(es), max batch {co['max_batch']}")

        # -- same models again: served from the result cache ---------------
        t0 = time.perf_counter()
        for tr in traces:
            client.rank(tr, batch_size=32)
        dt = (time.perf_counter() - t0) * 1e3
        cache = client.stats()["cache"]
        print(f"repeat queries: {dt:.1f} ms, cache hit rate "
              f"{cache['hit_rate']:.0%} (hits={cache['hits']} "
              f"misses={cache['misses']}, backend {cache['backend']})")
    finally:
        server.shutdown()
    return results, cache


if __name__ == "__main__":
    main()
