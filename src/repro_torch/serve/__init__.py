"""Serving tier of the port: from one measured trace to a fleet answer.

The port of ``repro.serve``, module for module, over the port's core:
the fleet grids run on the predictor's torch device (``cuda`` unless
the caller asks for ``cpu``), so a served ``/rank``, ``/sweep`` or
``/optimize`` reaches the Hopper MLP scorer kernels through the
coalescer's union passes.

The layers, bottom to top (data flows up, each layer only talks to its
neighbors — see ``docs/architecture.md`` for the full tour):

* :mod:`repro_torch.serve.engine` — token-serving demo loop (continuous
  batching over the transformer decode step); the *workload* the fleet
  questions are about, not part of the prediction path.
* :mod:`repro_torch.serve.fleet` — :class:`FleetPlanner`: the policy layer.
  Vectorized "which device?" ranking and multi-trace what-if sweeps over
  the Habitat-style predictor, fronted by the result cache (keyed on
  ``(trace fingerprint, device, config, fleet token)``).
* :mod:`repro_torch.serve.cache` — result-cache backends: in-process
  :class:`LRUCache`, cross-process :class:`SqliteCache`, and the
  cross-host :class:`~repro_torch.serve.netcache.NetCache` client
  (``make_backend`` picks from a path/``tcp://``/instance/None
  spelling).
* :mod:`repro_torch.serve.netcache` — the network result cache:
  :class:`CacheServer` (asyncio TCP store shared by every host) and
  :class:`NetCache` (the client backend, degrading to compute-as-miss
  when the server is unreachable).
* :mod:`repro_torch.serve.router` — :class:`FingerprintRouter` /
  :class:`RouterServer`: the cross-host coordinator.  Consistent-hashes
  trace fingerprints over N workers so each host's engine caches stay
  hot for "its" traces; health-checks and fails over around dead
  workers.
* :mod:`repro_torch.serve.service` — :class:`PredictionService`: transport-
  agnostic request coalescing.  Concurrent queries within an adaptive
  window become ONE ragged engine pass over a union device grid, with a
  cost-modeled union/split planner deciding when one rectangle beats k
  sub-passes.
* :mod:`repro_torch.serve.admission` — :class:`AdmissionController`: the
  front door's backpressure policy.  Requests are priced in estimated
  engine-seconds by the same fitted cost model the split planner uses;
  work the worker cannot afford sheds with 429/503 + Retry-After.
* :mod:`repro_torch.serve.optimizer` — :class:`WhatIfOptimizer`: the
  generation-batched Pareto search ("which fleet should I run?").
  Each generation's candidate cells are deduped into ONE coalesced
  sweep, and dominance pruning (:mod:`repro_torch.core.frontier`) shrinks the
  population before any engine work is priced.
* :mod:`repro_torch.serve.http` / :mod:`repro_torch.serve.aserver` — the
  two front ends over identical wire formats: the threaded server (baseline
  and kill switch) and the asyncio server (event-loop concurrency, SSE
  sweep streaming); both enforce admission, honor end-to-end deadlines
  (``deadline_ms`` / ``X-Deadline-Ms`` / ``REPRO_DEADLINE_MS`` -> 504),
  and drain gracefully on SIGTERM (shed 503, flush in-flight, exit 0).
* :mod:`repro_torch.serve.faults` — the fault-injection registry: named
  points in the serving hot paths (``netcache.get_many``,
  ``router.forward``, ``engine.pass``, ``worker.heartbeat``) armed via
  ``REPRO_FAULTS`` with deterministic per-point randomness; a single
  bool check when disarmed.

Cross-cutting contract: coalescing, union grids, splitting, caching,
and the choice of front end NEVER change an answer — a served ranking
is bitwise-identical (on the analytical prediction paths) to a direct
:class:`FleetPlanner` call.  Across the two packages the answers agree
to float rounding (rel 1e-12 on the analytical paths), not bit for bit:
the engines sum in different orders.
"""

from repro_torch.serve.admission import (AdmissionController,
                                         AdmissionError, Ticket)
from repro_torch.serve.cache import (CacheStats, LRUCache, SqliteCache,
                                     make_backend)
from repro_torch.serve.engine import ServingEngine, Request
from repro_torch.serve.fleet import (FleetChoice, FleetPlanner, format_fleet,
                                     format_sweep, rank_rows)
from repro_torch.serve.optimizer import (FleetConfig, OptimizeResult,
                                         WhatIfOptimizer, format_frontier)
from repro_torch.serve.service import PredictionService, adaptive_window_ms

#: lazily exported (PEP 562): netcache/router are runnable with
#: ``python -m`` — an eager import here would make runpy warn that the
#: module is already in sys.modules when it executes it as __main__
_LAZY = {"CacheServer": "repro_torch.serve.netcache",
         "NetCache": "repro_torch.serve.netcache",
         "FingerprintRouter": "repro_torch.serve.router",
         "RouterServer": "repro_torch.serve.router"}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = ["AdmissionController", "AdmissionError", "CacheServer",
           "CacheStats", "FingerprintRouter", "FleetChoice", "FleetConfig",
           "FleetPlanner", "LRUCache", "NetCache", "OptimizeResult",
           "PredictionService", "Request", "RouterServer", "ServingEngine",
           "SqliteCache", "Ticket", "WhatIfOptimizer",
           "adaptive_window_ms", "format_fleet", "format_frontier",
           "format_sweep", "make_backend", "rank_rows"]
