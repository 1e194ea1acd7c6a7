"""HTTP front end for the prediction service (stdlib only).

A copy of ``repro.serve.http``.  ``build_service`` and the CLI take a
torch ``device`` (``cuda`` unless the caller passes ``cpu``); a worker
asked for ``cuda`` on a host without a GPU exits with
``devices.torch_device``'s error instead of serving from the CPU.

One worker process = one :class:`PredictionServer` wrapping a
:class:`~repro_torch.serve.service.PredictionService` behind a threading
``http.server``.  The threaded server matters: coalescing only happens
when concurrent requests are *in flight* together, so each request must
get its own handler thread.  Run several workers against one sqlite
cache path (``launch/serve.py --serve --workers N``) and they share one
result store while coalescing independently.

Endpoints (all JSON):

* ``POST /rank``  — ``{"trace": <TrackedTrace doc>, "batch_size": int,
  "by"?: "throughput"|"cost", "dests"?: [device, ...]}`` ->
  ``{"label", "ranking": [FleetChoice dicts, best first]}``
* ``POST /sweep`` — ``{"traces": [<trace doc>, ...], "dests"?: [...]}``
  -> ``{"labels", "times": [{device: ms}, ...]}``
* ``POST /optimize`` — ``{"traces": [...], "batch_sizes": [int, ...],
  "dests"?: [...], search knobs...}`` -> ``{"frontier": [...],
  "search": {...}}`` — the generation-batched what-if Pareto search
  (see :mod:`repro_torch.serve.optimizer`); bulk admission lane
* ``GET /stats``  — request/coalescing/cache/admission/optimizer/
  engine-pass accounting (field reference in ``docs/serving.md``)
* ``GET /healthz`` — liveness probe

Overload: both front ends run the same admission controller (see
:mod:`repro_torch.serve.admission`) — a shed request answers 429 (cost
budget) or 503 (queue full) with a ``Retry-After`` header instead of
queueing unboundedly.  The asyncio front end (:mod:`repro_torch.serve.aserver`,
``launch/serve.py --serve --async``) speaks the same wire formats and
adds SSE sweep streaming; this threaded server remains the
``--async``-off baseline and kill switch.

Trace docs are ``TrackedTrace.to_dict()`` objects (or ``to_json()``
strings); numbers round-trip through ``json`` via shortest-repr floats,
so an HTTP answer is bitwise-identical to the in-process answer.

Module CLI (one worker)::

    PYTHONPATH=src python -m repro_torch.serve.http --port 0 \
        --cache /tmp/fleet-cache.sqlite --coalesce-ms 5

``--port 0`` binds an ephemeral port; the actual address is printed as
``serving on http://host:port`` (machine-parsable, used by the
multi-worker launcher and the tests).
"""

from __future__ import annotations

import argparse
import json
import signal
import socket
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.core.batched import env_float
from repro_torch.serve import faults
from repro_torch.serve.admission import AdmissionError
from repro_torch.serve.service import PredictionService, QuarantinedTrace
from repro_torch.serve.snapshot import SnapshotManager

__all__ = ["PredictionServer", "PredictionClient", "main",
           "install_drain_handlers"]

_MAX_BODY = 64 * 1024 * 1024    # refuse absurd payloads, not big sweeps


class BurstHTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` with a listen backlog of
    ``socket.SOMAXCONN``: the stdlib's backlog of 5 resets connections
    when a burst of clients connects at once (64 concurrent clients
    did), and such a burst is the traffic coalescing exists for.  The
    reference's servers keep the stdlib's 5."""
    daemon_threads = True
    request_queue_size = socket.SOMAXCONN


class _Handler(BaseHTTPRequestHandler):
    # the service lives on the server object (set by PredictionServer)
    protocol_version = "HTTP/1.1"

    def _reply(self, code: int, payload: Dict,
               extra: Sequence[Tuple[str, str]] = ()) -> None:
        # allow_nan=False: every body must be strict RFC-8259 JSON (the
        # service spells non-finite numbers as strings on the wire); a
        # stray inf/nan raises here and surfaces as a 400/500, never as
        # an unparsable 200
        body = json.dumps(payload, allow_nan=False).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for key, value in extra:
            self.send_header(key, value)
        self.end_headers()
        self.wfile.write(body)

    def _read_json(self) -> Optional[str]:
        """The request body as its RAW string (UTF-8 checked only).

        The raw form is what the service's response cache keys on — a
        repeat request is answered from its byte-identical payload
        without parsing at all.  Malformed JSON surfaces from the
        service's own ``json.loads`` as a ``ValueError`` and 400s
        through ``do_POST``'s usual arm; parsing it here too would
        charge every cached hit a redundant full-body parse."""
        length = int(self.headers.get("Content-Length", 0))
        if length <= 0 or length > _MAX_BODY:
            self._reply(400, {"error": f"bad Content-Length {length}"})
            return None
        try:
            return self.rfile.read(length).decode("utf-8")
        except UnicodeDecodeError as e:
            self._reply(400, {"error": f"invalid JSON body: {e}"})
            return None

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        service: PredictionService = self.server.service
        if self.path == "/healthz":
            if service.draining:
                # a draining worker is alive but must attract no new
                # traffic: routers mark it down off this answer
                self._reply(503, {"ok": False, "draining": True},
                            extra=[("Retry-After", "1")])
                return
            try:
                faults.inject("worker.heartbeat")
            except faults.FaultInjected as e:
                # an injected heartbeat fault makes this worker look
                # unhealthy-but-alive — the router's 5xx classification
                self._reply(500, {"ok": False, "error": str(e)})
                return
            self._reply(200, {"ok": True})
        elif self.path == "/stats":
            self._reply(200, service.stats())       # stays live during
            # drain: operators watch the flush complete here
        else:
            self._reply(404, {"error": f"unknown path {self.path!r}"})

    def _deadline_ms(self) -> Optional[float]:
        """Parse the X-Deadline-Ms header (relative ms of budget).

        Raises ValueError on garbage so the caller's 400 path gets it —
        a corrupt deadline must not silently serve unbounded."""
        raw = self.headers.get("X-Deadline-Ms")
        if raw is None:
            return None
        return float(raw)

    def do_POST(self) -> None:  # noqa: N802
        service: PredictionService = self.server.service
        if self.path not in ("/rank", "/sweep", "/optimize"):
            self._reply(404, {"error": f"unknown path {self.path!r}"})
            return
        if service.draining:
            # stop accepting: in-flight work flushes, new work sheds
            self._reply(503, {"error": "draining", "retry_after_s": 1.0},
                        extra=[("Retry-After", "1")])
            return
        payload = self._read_json()
        if payload is None:
            return
        try:
            deadline_ms = self._deadline_ms()
            if self.path == "/rank":
                self._reply(200, service.rank_request(
                    payload, deadline_ms=deadline_ms))
            elif self.path == "/optimize":
                self._reply(200, service.optimize_request(
                    payload, deadline_ms=deadline_ms))
            else:
                self._reply(200, service.sweep_request(
                    payload, deadline_ms=deadline_ms))
        except AdmissionError as e:
            # shed, not failed: machine-actionable backoff hint (429
            # cost budget / 503 queue full / 504 deadline — see
            # repro_torch.serve.admission).  A 504 carries no Retry-After:
            # the caller's budget, not our load, was the constraint.
            extra = ([] if e.status == 504 else
                     [("Retry-After",
                       str(max(1, int(e.retry_after_s + 0.999))))])
            body = {"error": e.reason, "lane": e.lane,
                    "retry_after_s": round(e.retry_after_s, 3)}
            if e.status == 504:
                body["code"] = "deadline_exceeded"
            self._reply(e.status, body, extra=extra)
        except QuarantinedTrace as e:
            # a ValueError subclass, so this arm must come first: a
            # quarantined fingerprint is a structured 422 (the request
            # is well-formed — its *content* is known-poisonous), not a
            # generic 400
            self._reply(422, {"error": str(e), "code": "quarantined",
                              "fingerprint": e.fingerprint,
                              "reason": e.reason,
                              "retry_after_s": round(e.retry_after_s, 3)},
                        extra=[("Retry-After",
                                str(max(1, int(e.retry_after_s + 0.999))))])
        except (KeyError, ValueError, TypeError) as e:
            # malformed request / unknown device: client error, not 500
            self._reply(400, {"error": f"{type(e).__name__}: {e}"})
        except Exception as e:  # engine failure: do not kill the worker
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    def log_message(self, fmt, *args) -> None:
        pass    # request logging off: stdout is the launcher protocol


class PredictionServer:
    """A threading HTTP server bound to one PredictionService."""

    def __init__(self, service: PredictionService,
                 host: str = "127.0.0.1", port: int = 0):
        self.service = service
        self._httpd = BurstHTTPServer((host, port), _Handler)
        self._httpd.service = service
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
        """Serve on the calling thread (the worker-process entry point)."""
        self._httpd.serve_forever()

    def start(self) -> "PredictionServer":
        """Serve on a daemon thread (in-process embedding, examples)."""
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful drain: stop accepting, flush, wait for quiescence.

        Handlers shed new POSTs (and answer ``/healthz`` 503, so
        routers stop sending) the instant the service's draining flag
        is up; this then blocks until in-flight coalescing windows
        flushed (or ``timeout``).  The server keeps answering ``/stats``
        until :meth:`shutdown` — observability outlives acceptance."""
        return self.service.drain(timeout)

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


class PredictionClient:
    """Minimal JSON client for the endpoints above (stdlib urllib).

    Traces are shipped as ``TrackedTrace`` objects (encoded via
    ``to_dict``) or pre-encoded docs; responses come back as plain dicts
    exactly as the service produced them."""

    def __init__(self, url: str, timeout: float = 60.0):
        self.url = url.rstrip("/")
        self.timeout = timeout

    @staticmethod
    def _encode_trace(trace) -> Dict:
        return trace.to_dict() if hasattr(trace, "to_dict") else trace

    def _get(self, path: str) -> Dict:
        with urllib.request.urlopen(self.url + path,
                                    timeout=self.timeout) as resp:
            return json.loads(resp.read())

    def _post(self, path: str, payload: Dict) -> Dict:
        req = urllib.request.Request(
            self.url + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            return json.loads(resp.read())

    def healthz(self) -> Dict:
        return self._get("/healthz")

    def stats(self) -> Dict:
        return self._get("/stats")

    def rank(self, trace, batch_size: int, by: str = "throughput",
             dests: Optional[Sequence[str]] = None,
             deadline_ms: Optional[float] = None) -> List[Dict]:
        """Ranked fleet rows (``FleetChoice`` dicts), best first.

        ``deadline_ms`` is the end-to-end budget shipped to the server
        (wire field); a blown budget answers 504
        (``urllib.error.HTTPError``) instead of blocking."""
        payload = {"trace": self._encode_trace(trace),
                   "batch_size": batch_size, "by": by}
        if dests is not None:
            payload["dests"] = list(dests)
        if deadline_ms is not None:
            payload["deadline_ms"] = float(deadline_ms)
        rows = self._post("/rank", payload)["ranking"]
        for r in rows:      # decode the wire spelling of a free device
            if r["cost_normalized"] == "Infinity":
                r["cost_normalized"] = float("inf")
        return rows

    def sweep(self, traces, dests: Optional[Sequence[str]] = None,
              deadline_ms: Optional[float] = None
              ) -> List[Dict[str, float]]:
        """One ``{device: iter_ms}`` dict per trace, input order."""
        payload = {"traces": [self._encode_trace(t) for t in traces]}
        if dests is not None:
            payload["dests"] = list(dests)
        if deadline_ms is not None:
            payload["deadline_ms"] = float(deadline_ms)
        return self._post("/sweep", payload)["times"]

    def optimize(self, traces, batch_sizes: Sequence[int],
                 dests: Optional[Sequence[str]] = None,
                 **knobs) -> Dict:
        """What-if Pareto search (``POST /optimize``).

        Returns the full wire document: ``{"frontier": [config dicts,
        fastest first], "search": {generations, sweeps, candidates,
        cells_priced, cells_deduped, converged}}``.  ``knobs`` pass
        through to the server (``epoch_samples``, ``max_replicas``,
        ``generation_size``, ``max_generations``, ``frontier_cap``,
        ``seed``)."""
        payload = {"traces": [self._encode_trace(t) for t in traces],
                   "batch_sizes": list(batch_sizes), **knobs}
        if dests is not None:
            payload["dests"] = list(dests)
        return self._post("/optimize", payload)

    def sweep_stream(self, traces,
                     dests: Optional[Sequence[str]] = None
                     ) -> Iterator[Tuple[str, Dict]]:
        """Stream a sweep over SSE (``POST /sweep/stream``).

        Yields ``(event, payload)`` pairs as the server emits them:
        ``("row", {"index", "label", "times"})`` per trace in
        *completion* order, ``("error", {...})`` for traces that failed,
        then ``("done", {"count", "errors"})``.  Only the asyncio front
        end serves this route; against the threaded server it 404s."""
        from repro_torch.serve.aserver import iter_sse     # shared framing

        payload = {"traces": [self._encode_trace(t) for t in traces]}
        if dests is not None:
            payload["dests"] = list(dests)
        req = urllib.request.Request(
            self.url + "/sweep/stream",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json",
                     "Accept": "text/event-stream"}, method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            yield from iter_sse(resp)


def build_service(cache: Optional[str] = None, cache_size: int = 4096,
                  coalesce_ms: float = 5.0, flush_at: int = 64,
                  mlps: bool = False,
                  fleet: Optional[Sequence[str]] = None,
                  device="cuda") -> PredictionService:
    """Service factory shared by the CLI and the multi-worker launcher.

    The predictor runs on the torch ``device`` (``cuda`` unless the
    caller asks for ``cpu``); a missing GPU raises from
    ``devices.torch_device``, nothing falls back to the CPU."""
    from repro_torch.core.predictor import HabitatPredictor, \
        default_predictor
    predictor = (default_predictor(device=device) if mlps
                 else HabitatPredictor(device=device))
    return PredictionService(predictor=predictor, fleet=fleet, cache=cache,
                            cache_size=cache_size,
                            coalesce_window_ms=coalesce_ms,
                            flush_at=flush_at)


def log_engine_caches(service: PredictionService) -> None:
    """Admission + engine-cache summary, printed on worker shutdown.

    The stack cache and the cross-stack wave-factor cache are invisible
    in per-request latencies once warm — the shutdown line is where an
    operator sees whether they actually carried the traffic (a near-zero
    hit count on a busy worker means the bounds are too tight)."""
    stats = service.stats()
    adm = stats.get("admission", {})
    shed = adm.get("shed", {})
    admitted = adm.get("admitted", {})
    print("admission on shutdown: "
          f"admitted={sum(admitted.values())} "
          f"shed_429={adm.get('shed_429', 0)} "
          f"shed_503={adm.get('shed_503', 0)} "
          f"shed_bulk={shed.get('bulk', 0)} "
          f"shed_interactive={shed.get('interactive', 0)}", flush=True)
    opt = stats.get("optimizer", {})
    print("optimizer on shutdown: "
          f"searches={opt.get('optimize_searches', 0)} "
          f"generations={opt.get('optimize_generations', 0)} "
          f"sweeps={opt.get('optimize_sweeps', 0)} "
          f"candidates={opt.get('optimize_candidates', 0)} "
          f"cells_priced={opt.get('optimize_cells_priced', 0)} "
          f"cells_deduped={opt.get('optimize_cells_deduped', 0)}",
          flush=True)
    caches = stats.get("engine_caches", {})
    parts = []
    for name, c in caches.items():
        if name == "stack_cache":       # a build is a full miss, an
            # extend a partial hit — print its real counters
            parts.append(f"{name}: hits={c['hits']} "
                         f"extends={c['extends']} builds={c['builds']} "
                         f"bytes={c.get('bytes', 0)}")
        elif name == "scorer_dispatches":
            parts.append(f"{name}: fused={c.get('fused', 0)} "
                         f"per_kind={c.get('per_kind', 0)}")
        else:                           # wave_factor_cache (and any
            # future hit/miss-shaped cache)
            parts.append(f"{name}: hits={c.get('hits', 0)} "
                         f"misses={c.get('misses', 0)} "
                         f"bytes={c.get('bytes', 0)}")
    print("engine caches on shutdown: " + "; ".join(parts), flush=True)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="one prediction-service HTTP worker")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080,
                    help="0 binds an ephemeral port (printed on stdout)")
    ap.add_argument("--cache", default=None, metavar="PATH|tcp://H:P",
                    help="shared result cache: a sqlite file path, or "
                         "tcp://host:port of a netcache server "
                         "(default: per-worker in-process LRU)")
    ap.add_argument("--cache-size", type=int, default=262144)
    ap.add_argument("--coalesce-ms", type=float, default=5.0,
                    help="request-coalescing window in milliseconds")
    ap.add_argument("--flush-at", type=int, default=64,
                    help="queue length that fires a batch early")
    ap.add_argument("--mlps", action="store_true",
                    help="trained-MLP predictor (loads/trains artifacts)")
    ap.add_argument("--fleet", default=None,
                    help="comma-separated device subset (default: all)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the predictor ('cpu' runs the "
                         "scorer kernels' plain versions)")
    ap.add_argument("--snapshot", default=None, metavar="PATH",
                    help="warm-state snapshot file: restored before "
                         "readiness, refreshed every "
                         "REPRO_SNAPSHOT_INTERVAL_S, finalized on drain")
    args = ap.parse_args(argv)

    fleet = args.fleet.split(",") if args.fleet else None
    service = build_service(cache=args.cache, cache_size=args.cache_size,
                            coalesce_ms=args.coalesce_ms,
                            flush_at=args.flush_at, mlps=args.mlps,
                            fleet=fleet, device=args.device)
    snapshot = None
    if args.snapshot:
        # restore BEFORE the readiness line: the first request a
        # supervisor-restarted worker sees must already hit warm caches
        snapshot = SnapshotManager(args.snapshot, service)
        if snapshot.restore():
            print(f"restored {snapshot.restored_entries} warm entries "
                  f"from {args.snapshot}", flush=True)
        snapshot.start()
    server = PredictionServer(service, host=args.host, port=args.port)
    install_drain_handlers(server, service, snapshot=snapshot)
    print(f"serving on {server.url}", flush=True)   # launcher/test protocol
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        log_engine_caches(service)


def install_drain_handlers(server, service: PredictionService,
                           snapshot: Optional[SnapshotManager] = None
                           ) -> None:
    """SIGTERM/SIGINT -> graceful drain -> shutdown -> exit 0.

    Shared by the threaded worker CLI and the launcher's single-worker
    mode.  The handler only flips flags and hands the blocking work to a
    thread (``server.shutdown()`` must not run on the serving thread the
    signal interrupted).  Grace period: ``REPRO_DRAIN_GRACE_S`` (10.0) —
    past it the worker exits anyway, reporting the unflushed remainder.
    With a ``snapshot`` manager attached, a final snapshot is taken
    after the drain flushes (so the successor restarts warm).  No-op
    outside the main thread (signals cannot be installed there;
    embedded servers drain via ``server.drain()`` directly)."""
    if threading.current_thread() is not threading.main_thread():
        return
    grace_s = env_float("REPRO_DRAIN_GRACE_S", 10.0)
    fired = threading.Event()

    def _drain_and_stop(signum, frame):
        if fired.is_set():      # second signal: already draining
            return
        fired.set()

        def _do():
            quiesced = server.drain(timeout=grace_s)
            adm = service.admission.stats()
            print(f"drain on shutdown: quiesced={quiesced} "
                  f"inflight={adm['inflight_requests']} "
                  f"shed_503={adm['shed_503']} "
                  f"shed_504={adm['shed_504']}", flush=True)
            if snapshot is not None:    # final snapshot after the flush
                snapshot.stop(final=True)
            server.shutdown()

        threading.Thread(target=_do, daemon=True).start()

    signal.signal(signal.SIGTERM, _drain_and_stop)
    signal.signal(signal.SIGINT, _drain_and_stop)


if __name__ == "__main__":
    main()
