"""Serving launcher: batched requests through the port's ServingEngine,
fleet questions about the served model's decode step, or the HTTP
prediction service.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --requests 8 --max-new 16 --fleet --sweep --optimize  # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \\
      --fleet --sweep

The port of ``repro.launch.serve``: ``--arch`` takes every arch of
``repro_torch.configs.ARCHS`` (``--smoke`` for its CPU-sized config),
random weights from a seeded generator, random prompts from a numpy
seed, greedy decoding, and the same summary lines.  ``--fleet`` tracks one ``decode_step`` and ranks
every registered device for it; ``--sweep`` tracks it at each
``--sweep-batches`` size and predicts the grid in one ragged pass;
``--optimize`` runs the what-if optimizer (``repro_torch.serve.
optimizer``) on those traces and prints the time-vs-cost frontier;
``--fleet-mlps`` predicts with the trained MLPs (``default_predictor``)
instead of the analytical fallback; ``--cache`` shares the planner's
results through a sqlite file or a ``tcp://`` network cache.  On the GPU
the step is tracked with origin ``H100-SXM`` and timed op by op on the
card (``wallclock``); with ``--device cpu`` the origin is ``cpu-host``
and its times are simulated, as in the reference.

``--serve`` switches to prediction-service mode: an HTTP front end
(``repro_torch.serve.http``, or ``repro_torch.serve.aserver`` with
``--async``) answering ``/rank``, ``/sweep``, ``/optimize`` and
``/stats`` with request coalescing, its predictor on ``--device``.
``--workers N`` runs N worker processes (``subprocess``, never a fork of
a process that has touched CUDA) sharing one result cache; ``--router``
puts the fingerprint-sharding router on the base port with the workers
behind it; ``--cache-server`` runs the standalone network cache::

  PYTHONPATH=src python -m repro_torch.launch.serve --serve --router \\
      --workers 2 --fleet-mlps             # on the GPU
  PYTHONPATH=src python -m repro_torch.launch.serve --serve --device cpu \\
      --port 0                             # one worker on the CPU
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.batched import env_float
from repro_torch.core.devices import torch_device
from repro_torch.models import init_params
from repro_torch.models.config import smoke_config
from repro_torch.serve.engine import Request, ServingEngine


def _worker_env() -> dict:
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    return env


class _Worker:
    """One supervised worker process: its launch command (port pinned
    after the first bind), the live ``Popen``, and restart accounting."""

    def __init__(self, cmd: List[str]):
        self.cmd = list(cmd)
        self.proc: Optional[subprocess.Popen] = None
        self.url: str = ""
        self.restarts = 0
        self.backoff_s = 0.0            # set by the supervisor
        self.next_restart = 0.0         # monotonic; 0 = eligible now
        self.started_at = 0.0           # monotonic instant of last bind


class WorkerSupervisor:
    """Spawn worker processes, watch them, restart the ones that die.

    The supervision contract that makes router failover self-healing:

    * each worker restarts on the SAME port it first bound (the
      readiness line pins ephemeral ports back into the command), so
      the router's periodic health sweep re-admits it with no
      reconfiguration;
    * restarts back off exponentially (``REPRO_SUPERVISOR_BACKOFF_S``
      doubling up to ``REPRO_SUPERVISOR_BACKOFF_MAX_S``) so a worker
      that dies on arrival cannot fork-bomb the host, and the backoff
      resets once a restart sticks;
    * ``drain()`` forwards SIGTERM to every worker (triggering their
      own graceful drain: finish in-flight, shed new with 503, exit 0)
      and stops restarting — shutdown is not a crash.

    The poll period is ``REPRO_SUPERVISOR_POLL_S`` (default 0.5s)."""

    def __init__(self, env: Optional[dict] = None,
                 poll_s: Optional[float] = None,
                 backoff_s: Optional[float] = None,
                 backoff_max_s: Optional[float] = None):
        self.env = dict(env) if env is not None else _worker_env()
        self.poll_s = (poll_s if poll_s is not None
                       else env_float("REPRO_SUPERVISOR_POLL_S", 0.5))
        self.backoff_s = (backoff_s if backoff_s is not None
                          else env_float("REPRO_SUPERVISOR_BACKOFF_S", 0.5))
        self.backoff_max_s = (
            backoff_max_s if backoff_max_s is not None
            else env_float("REPRO_SUPERVISOR_BACKOFF_MAX_S", 10.0))
        self._workers: List[_Worker] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._draining = False
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------
    def _launch(self, w: _Worker) -> bool:
        """Start ``w``'s process and wait for its readiness line.

        Returns True once the worker printed ``serving on <url>``;
        False if it exited first.  On the first successful bind the
        actual port is pinned back into the command so every restart
        lands on the same address."""
        w.proc = subprocess.Popen(w.cmd, env=self.env,
                                  stdout=subprocess.PIPE, text=True)
        line = w.proc.stdout.readline()
        while line and not line.startswith("serving on "):
            line = w.proc.stdout.readline()
        if not line:
            return False
        w.url = line.split("serving on ", 1)[1].strip()
        w.started_at = time.monotonic()
        try:                            # pin ephemeral ports: restarts
            port = w.url.rsplit(":", 1)[1]  # must reuse the address the
            i = w.cmd.index("--port")       # router already knows
            w.cmd[i + 1] = port
        except (IndexError, ValueError):
            pass
        # drain the pipe on a side thread so the child never blocks on
        # a full stdout buffer (its drain accounting line still flows)
        threading.Thread(target=self._pump, args=(w.proc.stdout,),
                         daemon=True).start()
        return True

    @staticmethod
    def _pump(stream) -> None:
        try:
            for line in stream:
                print(line, end="", flush=True)
        except ValueError:
            pass                        # stream closed mid-iteration

    def spawn(self, cmd: List[str]) -> str:
        """Launch one worker; returns its url (exits on bind failure)."""
        w = _Worker(cmd)
        w.backoff_s = self.backoff_s
        if not self._launch(w):
            self.drain()
            sys.exit("a worker exited before binding its port")
        with self._lock:
            self._workers.append(w)
        return w.url

    def start(self) -> "WorkerSupervisor":
        """Begin the watch loop on a daemon thread."""
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()
        return self

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_s):
            with self._lock:
                workers = list(self._workers)
            for w in workers:
                if self._stop.is_set() or self._draining:
                    return
                now = time.monotonic()
                if w.proc is not None and w.proc.poll() is None:
                    # backoff resets only once the worker has proven
                    # stable — a bind-then-crash flapper must keep its
                    # growing penalty across "successful" restarts
                    if now - w.started_at >= self.backoff_max_s:
                        w.backoff_s = self.backoff_s
                    continue
                if now < w.next_restart:
                    continue
                w.restarts += 1
                code = w.proc.returncode if w.proc is not None else None
                print(f"supervisor: worker {w.url or w.cmd[-1]} died "
                      f"(exit {code}); restart #{w.restarts}", flush=True)
                ok = self._launch(w)
                # every restart — bind or no bind — is rate-limited by
                # the doubling backoff; stability (above) is what earns
                # the reset
                w.next_restart = time.monotonic() + w.backoff_s
                w.backoff_s = min(w.backoff_s * 2, self.backoff_max_s)
                if ok:
                    print(f"supervisor: worker back on {w.url}",
                          flush=True)

    # -- shutdown -----------------------------------------------------------
    def drain(self, timeout: float = 15.0) -> None:
        """Stop restarting, SIGTERM every worker, wait for clean exits."""
        self._draining = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.poll_s + 1.0)
        with self._lock:
            workers = list(self._workers)
        for w in workers:
            if w.proc is not None and w.proc.poll() is None:
                w.proc.terminate()      # workers drain on SIGTERM
        deadline = time.monotonic() + timeout
        for w in workers:
            if w.proc is None:
                continue
            try:
                w.proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                w.proc.kill()
                w.proc.wait()

    # -- introspection ------------------------------------------------------
    @property
    def urls(self) -> List[str]:
        with self._lock:
            return [w.url for w in self._workers]

    @property
    def procs(self) -> List[subprocess.Popen]:
        """Live process handles (chaos benches SIGKILL through these)."""
        with self._lock:
            return [w.proc for w in self._workers]

    def stats(self) -> dict:
        with self._lock:
            return {"workers": len(self._workers),
                    "restarts": sum(w.restarts for w in self._workers),
                    "per_worker": [{"url": w.url, "restarts": w.restarts,
                                    "alive": (w.proc is not None
                                              and w.proc.poll() is None)}
                                   for w in self._workers]}


def _worker_cmd(args, cache, port: int,
                snapshot: Optional[str] = None) -> List[str]:
    worker_mod = ("repro_torch.serve.aserver" if args.use_async
                  else "repro_torch.serve.http")
    cmd = [sys.executable, "-m", worker_mod,
           "--host", args.host,
           "--port", str(port),
           "--coalesce-ms", str(args.coalesce_ms),
           "--device", args.device]
    if cache is not None:
        cmd += ["--cache", cache]
    if snapshot is not None:
        # the supervisor restarts a dead worker with this same command,
        # so the successor restores the predecessor's warm state before
        # printing its readiness line
        cmd += ["--snapshot", snapshot]
    if args.fleet_mlps:
        cmd.append("--mlps")
    return cmd


def _worker_snapshot(args, i: int) -> Optional[str]:
    """Per-worker snapshot file under ``--snapshot-dir`` (index-keyed,
    stable across restarts), or ``None`` when durability is off."""
    if not getattr(args, "snapshot_dir", None):
        return None
    d = Path(args.snapshot_dir)
    d.mkdir(parents=True, exist_ok=True)
    return str(d / f"worker-{i}.snap")


def _exit_on_sigterm() -> None:
    """Route SIGTERM through the KeyboardInterrupt cleanup paths so the
    launcher drains its workers instead of abandoning them."""
    def _handler(signum, frame):
        raise KeyboardInterrupt
    try:
        signal.signal(signal.SIGTERM, _handler)
    except ValueError:
        pass                            # not the main thread (tests)


def serve_router(args, cache) -> None:
    """``--router``: supervised workers on consecutive ports behind a
    fingerprint-sharding coordinator on the base port.

    Workers are spawned with piped stdout so their ``serving on ...``
    readiness lines give us the actual urls (ephemeral ports included);
    the supervisor then restarts any that crash on the same port, so
    the router's health sweep re-admits them automatically."""
    from repro_torch.serve.router import FingerprintRouter, RouterServer

    _exit_on_sigterm()
    sup = WorkerSupervisor()
    urls = [sup.spawn(_worker_cmd(args, cache,
                                  args.port + 1 + i if args.port else 0,
                                  snapshot=_worker_snapshot(args, i)))
            for i in range(args.workers)]
    sup.start()
    print(f"router fleet: {len(urls)} workers on "
          f"{', '.join(urls)} (cache: {cache})", flush=True)
    router = FingerprintRouter(urls)
    server = RouterServer(router, host=args.host, port=args.port)
    print(f"serving on {server.url}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        sup.drain()
        s = sup.stats()
        print(f"supervisor shutdown: workers={s['workers']} "
              f"restarts={s['restarts']}", flush=True)


def serve_http(args) -> None:
    """Run the prediction service: in-process for one worker, a
    subprocess pool (sharing one result cache) for several, optionally
    behind the fingerprint router; or the standalone cache store."""
    from repro_torch.serve.http import PredictionServer, build_service

    if args.cache_server:
        from repro_torch.serve.netcache import CacheServer

        # the standalone store: one process every worker's --cache
        # tcp://host:port points at (prints "serving on tcp://..." once
        # bound, same readiness protocol as the workers)
        CacheServer(host=args.host, port=args.port,
                    capacity=args.cache_capacity).serve_forever()
        return

    cache = args.cache
    if args.workers > 1 and args.port == 0 and not args.router:
        # each child would bind an unrelated ephemeral port and the
        # "consecutive ports" contract (and our printed range) would lie
        # (--router is exempt: it discovers worker urls from their
        # readiness lines)
        sys.exit("--port 0 (ephemeral) is only valid with --workers 1 "
                 "or --router; pick a base port for a worker pool")
    if args.workers > 1 and cache is None:
        cache = str(Path(tempfile.mkdtemp(prefix="fleet-cache-"))
                    / "cache.sqlite")
        print(f"shared result cache: {cache}", flush=True)

    if args.router:
        serve_router(args, cache)
        return

    if args.workers == 1:
        from repro_torch.serve.http import install_drain_handlers, \
            log_engine_caches

        service = build_service(cache=cache, coalesce_ms=args.coalesce_ms,
                                mlps=args.fleet_mlps, device=args.device)
        snap_path = _worker_snapshot(args, 0)
        snapshot = None
        if snap_path is not None:
            from repro_torch.serve.snapshot import SnapshotManager

            snapshot = SnapshotManager(snap_path, service)
            if snapshot.restore():
                print(f"restored {snapshot.restored_entries} warm "
                      f"entries from {snap_path}", flush=True)
            snapshot.start()
        if args.use_async:
            from repro_torch.serve.aserver import AsyncPredictionServer

            server = AsyncPredictionServer(service, host=args.host,
                                           port=args.port)
            server.snapshot = snapshot  # final snapshot on drain
            try:
                server.serve_forever()  # prints "serving on ..." itself
            finally:                    # (and drains on SIGTERM/SIGINT)
                log_engine_caches(service)
            return
        server = PredictionServer(service, host=args.host, port=args.port)
        install_drain_handlers(server, service, snapshot=snapshot)
        print(f"serving on {server.url}", flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            # factor/stack-cache effectiveness is invisible per request;
            # the shutdown line is the operator's signal (workers in the
            # pool print their own via repro_torch.serve.http)
            log_engine_caches(service)
        return

    _exit_on_sigterm()
    sup = WorkerSupervisor()
    for i in range(args.workers):
        sup.spawn(_worker_cmd(args, cache, args.port + i,
                              snapshot=_worker_snapshot(args, i)))
    sup.start()
    print(f"launched {args.workers} supervised workers on ports "
          f"{args.port}..{args.port + args.workers - 1} "
          f"(shared cache: {cache})", flush=True)
    try:
        while True:                     # supervisor keeps the pool alive
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        sup.drain()
        s = sup.stats()
        print(f"supervisor shutdown: workers={s['workers']} "
              f"restarts={s['restarts']}", flush=True)


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
                    help="comma-separated decode batch sizes for --sweep "
                         "and --optimize")
    ap.add_argument("--optimize", action="store_true",
                    help="what-if optimizer: Pareto search over (device, "
                         "replicas, batch size) fleet candidates for the "
                         "tracked decode step (time vs $/hr frontier)")
    ap.add_argument("--max-replicas", type=int, default=8,
                    help="replica-count ceiling for --optimize "
                         "(powers of two up to this)")
    ap.add_argument("--serve", action="store_true",
                    help="run the HTTP prediction service instead of the "
                         "token-serving demo")
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="asyncio front end (SSE streaming + admission "
                         "control on an event loop); omit for the "
                         "threaded baseline")
    ap.add_argument("--workers", type=int, default=1,
                    help="HTTP worker processes (consecutive ports, one "
                         "shared result cache)")
    ap.add_argument("--router", action="store_true",
                    help="front the workers with the fingerprint-"
                         "sharding router on the base port (workers on "
                         "port+1..); traces stick to the worker whose "
                         "engine caches are hot for them")
    ap.add_argument("--cache-server", action="store_true",
                    help="run the standalone network result-cache store "
                         "instead of any workers (point --cache "
                         "tcp://host:port at it)")
    ap.add_argument("--cache-capacity", type=int, default=262144,
                    help="entry bound of the --cache-server store")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8100)
    ap.add_argument("--cache", default=None, metavar="PATH_OR_URL",
                    help="shared result cache: a sqlite path (one host) "
                         "or tcp://host:port of a --cache-server (cross-"
                         "host); auto-created sqlite when --workers > 1")
    ap.add_argument("--coalesce-ms", type=float, default=5.0,
                    help="request-coalescing window for --serve")
    ap.add_argument("--snapshot-dir", default=None, metavar="DIR",
                    help="durable warm state for --serve: each worker "
                         "snapshots its caches to DIR/worker-<i>.snap "
                         "(every REPRO_SNAPSHOT_INTERVAL_S and on drain) "
                         "and restores on restart")
    args = ap.parse_args(argv)

    if args.serve or args.cache_server:
        serve_http(args)
        return

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
    if args.fleet or args.sweep or args.optimize:
        _fleet_modes(args, cfg, params, engine, device)


def _fleet_modes(args, cfg, params, engine: ServingEngine,
                 device: torch.device) -> None:
    """``--fleet`` / ``--sweep`` / ``--optimize``: track the decode step
    and ask the planner, as the reference's CLI does."""
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

    if args.sweep or args.optimize:
        batches = [int(b) for b in args.sweep_batches.split(",")]
        traces = [track(ServingEngine(cfg, params, b, args.max_seq,
                                      device=device),
                        f"{args.arch}-decode-b{b}") for b in batches]

    if args.sweep:
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

    if args.optimize:
        from repro_torch.serve.optimizer import format_frontier
        from repro_torch.serve.service import PredictionService

        # a zero-window, non-adaptive service: the CLI is the only
        # client, so each generation should fire immediately
        service = PredictionService(planner=planner,
                                    coalesce_window_ms=0.0,
                                    adaptive_window=False)
        passes0 = planner.engine_pass_count()   # --sweep may have run
        t0 = time.perf_counter()
        result = service.optimize(traces, batches,
                                  max_replicas=args.max_replicas)
        dt = (time.perf_counter() - t0) * 1e3
        print(f"\nwhat-if optimizer: time-vs-cost frontier over "
              f"{len(traces)} batch sizes x {len(planner.fleet)} devices "
              f"x replicas<={args.max_replicas} in {dt:.1f} ms:")
        print(format_frontier(result))
        print(f"engine passes for the whole search: "
              f"{planner.engine_pass_count() - passes0} "
              f"(<= {result.generations} generations)")


if __name__ == "__main__":
    main()
