"""Fingerprint-sharded worker fleet: the cross-host coordinator.

A copy of ``repro.serve.router``: the same sha1 ring and
``REPRO_ROUTER_REPLICAS``, so both packages shard a fingerprint to the
same worker index.

N workers behind a shared result cache still duplicate their *engine*
warmth: STACK_CACHE stacks, wave-factor grids, and jit shapes are
per-process, so a trace bouncing between workers re-pays those builds on
every host it lands on.  The router fixes the placement half of the
problem: it consistent-hashes each request's **trace fingerprint** (the
same content hash the planner uses as its result-cache key) onto a ring
of workers, so a given trace always lands on the same host and that
host's engine caches stay hot for "its" traces.

* :class:`FingerprintRouter` — the ring + forwarding logic.  Consistent
  hashing (sha1, ``REPRO_ROUTER_REPLICAS`` virtual nodes per worker)
  means adding/removing one worker remaps only ~1/N of the fingerprint
  space instead of reshuffling everything.  A background thread
  health-checks every worker's ``/healthz`` each
  ``REPRO_ROUTER_HEALTH_S`` seconds; requests re-hash around workers
  marked down, and a forward that fails at the *transport* level
  (refused / reset / timeout) marks the worker down and retries the
  next ring owner — the request survives a worker kill.  An HTTP error
  *status* is a worker ANSWER (400 bad trace, 429/503 shed) and is
  passed through untouched, never failed over: retrying a shed request
  on another worker would defeat admission control.
* :class:`RouterServer` — the HTTP face: same ``/rank``, ``/sweep``,
  ``/stats``, ``/healthz`` surface as a worker, so
  :class:`~repro_torch.serve.http.PredictionClient` points at a router
  unchanged.  ``/rank`` bodies are forwarded and answered byte-for-byte
  verbatim; ``/sweep`` fans out trace groups to their ring owners
  concurrently and merges rows back into input order (floats re-encode
  bitwise via shortest-repr JSON).

Module CLI (workers must already be up; see also
``python -m repro_torch.launch.serve --serve --router``)::

    PYTHONPATH=src python -m repro_torch.serve.router --port 0 \
        --workers http://127.0.0.1:8101,http://127.0.0.1:8102

``--port 0`` binds an ephemeral port; the actual address is printed as
``serving on http://host:port`` (same readiness protocol as workers).
"""

from __future__ import annotations

import argparse
import bisect
import hashlib
import json
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.batched import env_float, env_int
from repro_torch.core.trace import TrackedTrace
from repro_torch.serve import faults
from repro_torch.serve.admission import current_deadline, deadline_scope, \
    remaining_s
from repro_torch.serve.http import BurstHTTPServer

__all__ = ["FingerprintRouter", "RouterServer", "RoutedError", "main"]

_MAX_BODY = 64 * 1024 * 1024


class RoutedError(Exception):
    """A worker answered with an HTTP error status: pass it through.

    Carries the worker's exact status/body/headers so the router face
    can relay the answer (400 bad trace, 429/503 admission shed)
    verbatim — this is a worker *decision*, not a routing failure."""

    def __init__(self, status: int, body: bytes,
                 retry_after: Optional[str] = None):
        super().__init__(f"worker answered {status}")
        self.status = status
        self.body = body
        self.retry_after = retry_after


class FingerprintRouter:
    """Consistent-hash ring over prediction workers, with failover.

    Parameters (each defaulting to its env knob, see ``docs/knobs.md``):

    replicas:
        Virtual nodes per worker on the ring (``REPRO_ROUTER_REPLICAS``,
        64).  More vnodes -> smoother fingerprint distribution, linearly
        slower ring rebuilds (rebuilds only happen on health flips).
    health_s:
        Background ``/healthz`` sweep period in seconds
        (``REPRO_ROUTER_HEALTH_S``, 2.0).  A worker that failed over is
        re-admitted automatically by the next sweep that finds it alive.
    timeout_s:
        Per-forward socket deadline (connect included).
    """

    def __init__(self, workers: Sequence[str], replicas: Optional[int] = None,
                 health_s: Optional[float] = None, timeout_s: float = 60.0):
        if not workers:
            raise ValueError("router needs at least one worker url")
        self.workers = [w.rstrip("/") for w in workers]
        self.replicas = (env_int("REPRO_ROUTER_REPLICAS", 64)
                         if replicas is None else int(replicas))
        self.health_s = (env_float("REPRO_ROUTER_HEALTH_S", 2.0)
                         if health_s is None else float(health_s))
        self.timeout_s = float(timeout_s)
        self._lock = threading.Lock()
        self._alive = {w: True for w in self.workers}
        #: last probe classification per worker: "up" | "unhealthy"
        #: (alive but answering 5xx on /healthz) | "down" (transport)
        self._state = {w: "up" for w in self.workers}
        self._ring: List[Tuple[int, str]] = []
        self._rebuild_ring_locked()
        self.stats_forwarded: Dict[str, int] = {w: 0 for w in self.workers}
        self.stats_failovers = 0
        self.stats_routed_errors = 0
        self._stop = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        # fan-out pool for sweep groups (bounded by fleet size)
        self._pool = ThreadPoolExecutor(max_workers=max(4, len(self.workers)))

    # -- ring ----------------------------------------------------------------
    @staticmethod
    def _hash(text: str) -> int:
        return int.from_bytes(hashlib.sha1(text.encode()).digest()[:8],
                              "big")

    def _rebuild_ring_locked(self) -> None:
        ring = []
        for w in self.workers:
            if not self._alive[w]:
                continue
            for i in range(self.replicas):
                ring.append((self._hash(f"{w}#{i}"), w))
        ring.sort()
        self._ring = ring

    def owner(self, fingerprint: str) -> str:
        """The live worker owning this fingerprint's ring arc."""
        with self._lock:
            if not self._ring:
                raise RoutedError(503, json.dumps(
                    {"error": "no live workers"}).encode())
            h = self._hash(fingerprint)
            i = bisect.bisect_right(self._ring, (h, chr(0x10FFFF)))
            return self._ring[i % len(self._ring)][1]

    def mark_down(self, worker: str) -> None:
        with self._lock:
            if self._alive.get(worker, False):
                self._alive[worker] = False
                self._rebuild_ring_locked()

    def mark_up(self, worker: str) -> None:
        with self._lock:
            if not self._alive.get(worker, True):
                self._alive[worker] = True
                self._rebuild_ring_locked()

    # -- health --------------------------------------------------------------
    def _probe(self, worker: str) -> str:
        """Classify one worker: ``"up"`` | ``"unhealthy"`` | ``"down"``.

        The distinction matters for diagnosis and for the forward path:
        an HTTP error status on ``/healthz`` means the worker PROCESS is
        alive but refusing work (e.g. draining, or an injected
        heartbeat fault) — mark it down so traffic re-hashes, but it
        costs no transport failover.  A refused/reset/timed-out probe is
        a dead host ("down" — the failover-material case)."""
        try:
            with urllib.request.urlopen(worker + "/healthz",
                                        timeout=self.health_s) as resp:
                return "up" if resp.status == 200 else "unhealthy"
        except urllib.error.HTTPError:
            # MUST precede URLError (its superclass): a status is an
            # answer from a live process, not a dead transport
            return "unhealthy"
        except (urllib.error.URLError, OSError, ValueError):
            return "down"

    def check_health(self) -> Dict[str, bool]:
        """One synchronous sweep over every worker (the thread's body;
        also callable directly from tests/CLIs)."""
        for w in self.workers:
            state = self._probe(w)
            with self._lock:
                self._state[w] = state
            (self.mark_up if state == "up" else self.mark_down)(w)
        with self._lock:
            return dict(self._alive)

    def start_health_checks(self) -> None:
        if self._health_thread is not None:
            return

        def _loop():
            while not self._stop.wait(self.health_s):
                self.check_health()

        self._health_thread = threading.Thread(target=_loop, daemon=True)
        self._health_thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=5)
            self._health_thread = None
        self._pool.shutdown(wait=False)

    # -- forwarding ----------------------------------------------------------
    def _forward(self, worker: str, path: str, body: bytes) -> bytes:
        """POST ``body`` to one worker; transport errors raise OSError
        (failover material), HTTP statuses raise RoutedError (answers).

        When the serving thread carries a deadline scope (bound by the
        router face from ``X-Deadline-Ms``), the socket timeout shrinks
        to the remaining budget and the header is re-derived so the
        worker sees how much budget actually survives the hop."""
        faults.inject("router.forward")     # FaultInjected IS-A OSError:
        # it flows through the failover path like a real dead worker
        headers = {"Content-Type": "application/json"}
        timeout = self.timeout_s
        budget = remaining_s()
        if budget is not None:
            if budget < 0.001:
                raise RoutedError(504, json.dumps(
                    {"error": "deadline_exceeded",
                     "detail": "budget exhausted before forwarding"}
                ).encode())
            timeout = min(timeout, budget)
            headers["X-Deadline-Ms"] = f"{budget * 1e3:.0f}"
        req = urllib.request.Request(
            worker + path, data=body, headers=headers, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            # MUST precede URLError: HTTPError subclasses it, and a 4xx/
            # 5xx is a worker answer to relay, not a dead worker
            raise RoutedError(e.code, e.read(),
                              e.headers.get("Retry-After"))

    def forward(self, fingerprint: str, path: str, body: bytes) -> bytes:
        """Route one request to its fingerprint owner, failing over
        around transport-dead workers (each is marked down so subsequent
        traffic re-hashes immediately)."""
        tried = set()
        while True:
            worker = self.owner(fingerprint)
            if worker in tried:     # ring only has workers we broke on
                raise RoutedError(503, json.dumps(
                    {"error": "all live workers unreachable"}).encode())
            tried.add(worker)
            try:
                out = self._forward(worker, path, body)
            except RoutedError:
                self.stats_routed_errors += 1
                raise
            except (urllib.error.URLError, OSError):
                self.mark_down(worker)
                self.stats_failovers += 1
                continue
            with self._lock:
                self.stats_forwarded[worker] += 1
            return out

    # -- request surface -----------------------------------------------------
    @staticmethod
    def _fingerprint(doc: Dict) -> str:
        """The planner's own trace content hash — routing on it means a
        worker's engine/result caches see exactly the traces the ring
        assigns it."""
        return TrackedTrace.from_dict(doc).fingerprint()

    def rank_bytes(self, body: bytes) -> bytes:
        """Forward one /rank body verbatim; the answer returns verbatim
        (bitwise — the router never re-encodes a rank response)."""
        payload = json.loads(body)
        fp = self._fingerprint(payload["trace"])
        return self.forward(fp, "/rank", body)

    def sweep_request(self, payload: Dict) -> Dict:
        """Fan a sweep out to each trace's ring owner; merge rows back
        into input order.

        Grouping preserves the worker-side batching win (each owner
        prices its group in one ragged pass) while keeping placement
        sticky per fingerprint."""
        docs = payload["traces"]
        fps = [self._fingerprint(d) for d in docs]
        groups: Dict[str, List[int]] = {}
        for i, fp in enumerate(fps):
            groups.setdefault(self.owner(fp), []).append(i)

        extra = {k: v for k, v in payload.items() if k != "traces"}
        # the fan-out runs on pool threads; re-bind the serving thread's
        # deadline scope there so each forward derives its timeout from
        # the same remaining budget
        deadline = current_deadline()

        def _one(indices: List[int]) -> Dict:
            sub = dict(extra)
            sub["traces"] = [docs[i] for i in indices]
            # forward under the group's FIRST fingerprint: if the owner
            # died since grouping, the whole group fails over together
            with deadline_scope(deadline):
                out = self.forward(fps[indices[0]], "/sweep",
                                   json.dumps(sub).encode())
            return json.loads(out)

        futures = {self._pool.submit(_one, idx): idx
                   for idx in groups.values()}
        labels: List[Optional[str]] = [None] * len(docs)
        times: List[Optional[Dict]] = [None] * len(docs)
        for fut, indices in futures.items():
            sub = fut.result()      # RoutedError propagates to the face
            for j, i in enumerate(indices):
                labels[i] = sub["labels"][j]
                times[i] = sub["times"][j]
        return {"labels": labels, "times": times}

    def stats(self) -> Dict:
        with self._lock:
            alive = dict(self._alive)
            state = dict(self._state)
            forwarded = dict(self.stats_forwarded)
            ring_size = len(self._ring)
        return {"workers": {w: {"alive": alive[w],
                                "state": state[w],
                                "forwarded": forwarded[w]}
                            for w in self.workers},
                "live_workers": sum(alive.values()),
                "ring_size": ring_size,
                "replicas": self.replicas,
                "failovers": self.stats_failovers,
                "routed_errors": self.stats_routed_errors}


class _RouterHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def _reply_bytes(self, code: int, body: bytes,
                     retry_after: Optional[str] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if retry_after is not None:
            self.send_header("Retry-After", retry_after)
        self.end_headers()
        self.wfile.write(body)

    def _reply(self, code: int, payload: Dict) -> None:
        self._reply_bytes(code, json.dumps(payload).encode())

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        router: FingerprintRouter = self.server.router
        if self.path == "/healthz":
            self._reply(200, {"ok": True})
        elif self.path == "/stats":
            self._reply(200, {"router": router.stats()})
        else:
            self._reply(404, {"error": f"unknown path {self.path!r}"})

    def do_POST(self) -> None:  # noqa: N802
        router: FingerprintRouter = self.server.router
        if self.path not in ("/rank", "/sweep"):
            self._reply(404, {"error": f"unknown path {self.path!r}"})
            return
        length = int(self.headers.get("Content-Length", 0))
        if length <= 0 or length > _MAX_BODY:
            self._reply(400, {"error": f"bad Content-Length {length}"})
            return
        body = self.rfile.read(length)
        # an X-Deadline-Ms header binds the remaining budget for this
        # request: every downstream forward derives its socket timeout
        # from it (and re-emits the surviving budget to the worker)
        deadline = None
        header_ms = self.headers.get("X-Deadline-Ms")
        if header_ms is not None:
            try:
                ms = float(header_ms)
            except ValueError:
                self._reply(400, {"error":
                                  f"bad X-Deadline-Ms {header_ms!r}"})
                return
            if ms > 0:
                deadline = time.monotonic() + ms / 1e3
        try:
            with deadline_scope(deadline):
                if self.path == "/rank":
                    self._reply_bytes(200, router.rank_bytes(body))
                else:
                    out = router.sweep_request(json.loads(body))
                    self._reply_bytes(200, json.dumps(out).encode())
        except RoutedError as e:
            self._reply_bytes(e.status, e.body, e.retry_after)
        except (KeyError, ValueError, TypeError,
                json.JSONDecodeError) as e:
            self._reply(400, {"error": f"{type(e).__name__}: {e}"})
        except Exception as e:      # routing failure: do not kill the face
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    def log_message(self, fmt, *args) -> None:
        pass    # stdout is the launcher readiness protocol

    def handle_one_request(self) -> None:
        try:
            super().handle_one_request()
        except (ConnectionError, BrokenPipeError):
            self.close_connection = True


class RouterServer:
    """Threading HTTP face for one :class:`FingerprintRouter`."""

    def __init__(self, router: FingerprintRouter, host: str = "127.0.0.1",
                 port: int = 0):
        self.router = router
        self._httpd = BurstHTTPServer((host, port), _RouterHandler)
        self._httpd.router = router
        self._thread: Optional[threading.Thread] = None

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def serve_forever(self) -> None:
        self.router.start_health_checks()
        self._httpd.serve_forever()

    def start(self) -> "RouterServer":
        self.router.start_health_checks()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.router.close()


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="fingerprint-sharding router over prediction workers")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8100,
                    help="0 binds an ephemeral port (printed on stdout)")
    ap.add_argument("--workers", required=True,
                    help="comma-separated worker base urls "
                         "(http://host:port,...)")
    args = ap.parse_args(argv)
    router = FingerprintRouter(args.workers.split(","))
    server = RouterServer(router, host=args.host, port=args.port)
    print(f"serving on {server.url}", flush=True)   # launcher protocol
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        st = router.stats()
        print(f"router on shutdown: forwarded="
              f"{sum(w['forwarded'] for w in st['workers'].values())} "
              f"failovers={st['failovers']} "
              f"live={st['live_workers']}/{len(router.workers)}",
              flush=True)
        server.shutdown()


if __name__ == "__main__":
    main()
