"""Asyncio HTTP front end with admission control (stdlib only).

A copy of ``repro.serve.aserver``; its CLI takes ``--device`` like
:mod:`repro_torch.serve.http`'s.

The millions-of-users front door: one event loop multiplexes every
connection, so concurrency costs a coroutine (not an OS thread the way
:mod:`repro_torch.serve.http`'s ``ThreadingHTTPServer`` pays), and every
request passes the cost-priced :class:`AdmissionController` before it
may queue — an overloaded worker answers 429/503 + ``Retry-After`` in
microseconds instead of letting latency diverge for everyone.

Division of labor: the event loop ONLY parses HTTP, runs admission, and
enqueues on the :class:`~repro_torch.serve.service.PredictionService`
coalescer (``submit_rank``/``submit_sweep`` — non-blocking by design).
The engine work still runs on the service's leader thread; completion
is bridged back to the loop via ``PendingQuery.on_done`` +
``loop.call_soon_threadsafe``, so no thread is ever parked per request.

Endpoints — byte-compatible with the threaded front end (same wire
formats, same ``PredictionClient``):

* ``POST /rank``  — interactive lane; ``{"trace", "batch_size", "by"?,
  "dests"?}`` -> ``{"label", "ranking"}``
* ``POST /sweep`` — bulk lane; ``{"traces", "dests"?}`` ->
  ``{"labels", "times"}``
* ``POST /optimize`` — bulk lane; the generation-batched what-if Pareto
  search (:mod:`repro_torch.serve.optimizer`).  The search loop blocks on its
  per-generation coalescer handles, so it runs on the default executor
  (``run_in_executor``) — the loop thread keeps multiplexing while the
  search's generations ride the coalescer alongside live traffic.
* ``POST /sweep/stream`` — bulk lane, **SSE streaming**: one
  ``text/event-stream`` response with a ``row`` event per trace *as its
  batch completes* (long sweeps deliver incrementally instead of one
  giant body), then one ``done`` event.  Each trace rides its own
  coalescer handle, so rows still share engine passes.
* ``GET /stats`` / ``GET /healthz`` — same payloads as the threaded
  server (``/stats`` includes the ``admission`` block).

Overload semantics: a shed request costs no engine work and responds
immediately — 429 (cost budget / bulk share exhausted, back off
``Retry-After`` seconds) or 503 (queue hard-full).  Admitted requests
release their budget reservation in ``finally``, error paths included.

Answer fidelity: the handler calls the exact decode/encode helpers and
``rank()``/``sweep()`` spellings the threaded server uses, so an async
answer is bitwise-identical to a threaded (and in-process) answer.

Module CLI (one worker, same protocol as ``repro_torch.serve.http``)::

    PYTHONPATH=src python -m repro_torch.serve.aserver --port 0 \\
        --cache /tmp/fleet-cache.sqlite --coalesce-ms 5

``--port 0`` binds an ephemeral port; the actual address is printed as
``serving on http://host:port`` (machine-parsable, used by the
multi-worker launcher and the tests).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.core.batched import env_float
from repro_torch.serve import faults
from repro_torch.serve.admission import AdmissionError, DeadlineExceeded
from repro_torch.serve.service import PendingQuery, PredictionService, \
    QuarantinedTrace
from repro_torch.serve.snapshot import SnapshotManager

__all__ = ["AsyncPredictionServer", "iter_sse", "main"]

_MAX_BODY = 64 * 1024 * 1024    # refuse absurd payloads, not big sweeps

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            413: "Payload Too Large", 422: "Unprocessable Entity",
            429: "Too Many Requests", 500: "Internal Server Error",
            503: "Service Unavailable", 504: "Gateway Timeout"}


def _response(status: int, payload: Dict,
              extra: Sequence[Tuple[str, str]] = ()) -> bytes:
    """One full HTTP/1.1 response (connection-close framing).

    ``allow_nan=False`` for the same reason as the threaded server: a
    stray inf/nan must surface as a 500, never as unparsable JSON."""
    body = json.dumps(payload, allow_nan=False).encode()
    head = [f"HTTP/1.1 {status} {_REASONS.get(status, '')}",
            "Content-Type: application/json",
            f"Content-Length: {len(body)}",
            "Connection: close"]
    head += [f"{k}: {v}" for k, v in extra]
    return ("\r\n".join(head) + "\r\n\r\n").encode() + body


def _admission_response(e: AdmissionError) -> bytes:
    """The shed answer: machine-actionable JSON + a Retry-After header
    (integral seconds, rounded up, per RFC 9110).  A 504 (deadline)
    carries no Retry-After — the caller's budget, not our load, was the
    constraint — and is tagged ``code: deadline_exceeded``."""
    body = {"error": e.reason, "lane": e.lane,
            "retry_after_s": round(e.retry_after_s, 3)}
    if e.status == 504:
        body["code"] = "deadline_exceeded"
        return _response(e.status, body)
    return _response(
        e.status, body,
        extra=[("Retry-After", str(max(1, int(e.retry_after_s + 0.999))))])


def _quarantine_response(e: QuarantinedTrace) -> bytes:
    """The poison-trace answer: a structured 422 — the request is
    well-formed, its *content* is known to crash the engine — carrying
    the stored failure reason and the quarantine TTL remainder (same
    body shape both front ends emit)."""
    return _response(
        422, {"error": str(e), "code": "quarantined",
              "fingerprint": e.fingerprint, "reason": e.reason,
              "retry_after_s": round(e.retry_after_s, 3)},
        extra=[("Retry-After", str(max(1, int(e.retry_after_s + 0.999))))])


def iter_sse(lines) -> Iterator[Tuple[str, Dict]]:
    """Parse an SSE byte stream into ``(event, json_payload)`` pairs.

    Works on any iterable of ``bytes`` lines (an ``http.client``
    response object qualifies) — shared by ``PredictionClient
    .sweep_stream`` and the tests so client and server cannot drift on
    the framing."""
    event, data = None, []
    for raw in lines:
        line = raw.decode("utf-8").rstrip("\r\n")
        if not line:
            if data:
                yield (event or "message", json.loads("\n".join(data)))
            event, data = None, []
            continue
        if line.startswith("event:"):
            event = line[len("event:"):].strip()
        elif line.startswith("data:"):
            data.append(line[len("data:"):].strip())
    if data:    # stream closed without a trailing blank line
        yield (event or "message", json.loads("\n".join(data)))


class AsyncPredictionServer:
    """One asyncio event loop fronting one ``PredictionService``.

    Two run styles: ``serve_forever()`` owns the calling thread (the
    worker-process entry point), ``start()`` runs the loop on a daemon
    thread (in-process embedding — tests, benchmarks) and returns once
    the socket is bound; ``shutdown()`` stops the loop and joins."""

    def __init__(self, service: PredictionService,
                 host: str = "127.0.0.1", port: int = 0):
        self.service = service
        self.host = host
        self.port = port
        #: optional SnapshotManager — when set, the drain path takes a
        #: final snapshot after the flush (set by ``main`` / embedders)
        self.snapshot: Optional[SnapshotManager] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- lifecycle ----------------------------------------------------------
    async def _bind(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_connection, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    def serve_forever(self) -> None:
        """Bind and serve on the calling thread until cancelled.

        SIGTERM/SIGINT trigger a graceful drain: the service stops
        accepting (POSTs shed 503, ``/healthz`` flips so routers mark
        the worker down), in-flight coalescing windows flush, one
        accounting line prints, and the process exits 0."""
        async def _run():
            await self._bind()
            print(f"serving on {self.url}", flush=True)
            loop = asyncio.get_running_loop()
            stop = asyncio.Event()

            def _drain_then_stop() -> None:
                grace_s = env_float("REPRO_DRAIN_GRACE_S", 10.0)

                def _worker():
                    quiesced = self.service.drain(timeout=grace_s)
                    adm = self.service.admission.stats()
                    print("drain on shutdown: "
                          f"quiesced={quiesced} "
                          f"inflight={adm['inflight_requests']} "
                          f"shed_503={adm['shed_503']} "
                          f"shed_504={adm['shed_504']}", flush=True)
                    if self.snapshot is not None:
                        # final snapshot after the flush, before exit
                        self.snapshot.stop(final=True)
                    loop.call_soon_threadsafe(stop.set)

                # drain blocks on a condition variable; keep the event
                # loop free so in-flight handlers can finish delivering
                threading.Thread(target=_worker, daemon=True).start()

            try:
                for sig in (signal.SIGTERM, signal.SIGINT):
                    loop.add_signal_handler(sig, _drain_then_stop)
            except (NotImplementedError, RuntimeError):
                pass                # non-main thread or platform limits
            async with self._server:
                serve = asyncio.ensure_future(self._server.serve_forever())
                stopper = asyncio.ensure_future(stop.wait())
                await asyncio.wait({serve, stopper},
                                   return_when=asyncio.FIRST_COMPLETED)
                for task in (serve, stopper):
                    task.cancel()
                await asyncio.gather(serve, stopper,
                                     return_exceptions=True)
        try:
            asyncio.run(_run())
        except KeyboardInterrupt:
            pass

    def start(self) -> "AsyncPredictionServer":
        """Serve on a background daemon thread; returns after binding."""
        self._loop = asyncio.new_event_loop()
        bound = threading.Event()

        def _spin():
            asyncio.set_event_loop(self._loop)
            self._loop.run_until_complete(self._bind())
            bound.set()
            self._loop.run_forever()

        self._thread = threading.Thread(target=_spin, daemon=True)
        self._thread.start()
        if not bound.wait(timeout=30):
            raise RuntimeError("async server failed to bind within 30s")
        return self

    def shutdown(self) -> None:
        if self._loop is None:
            return

        def _stop():
            if self._server is not None:
                self._server.close()
            tasks = list(asyncio.all_tasks(self._loop))
            for task in tasks:
                task.cancel()       # in-flight handlers exit via their
                # CancelledError paths before the loop stops

            async def _finish():
                # let the cancellations actually unwind, then stop —
                # stopping immediately would strand pending tasks and
                # leak the loop's resources under -W error
                await asyncio.gather(*tasks, return_exceptions=True)
                self._loop.stop()

            self._loop.create_task(_finish())

        self._loop.call_soon_threadsafe(_stop)
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._loop.close()
        self._loop = None

    # -- request plumbing ---------------------------------------------------
    @staticmethod
    async def _read_request(reader: asyncio.StreamReader):
        """Parse one HTTP/1.1 request -> (method, path, headers, body).

        Returns None on a closed/garbage connection.  Raises ValueError
        for an oversized body (mapped to 413) — the front door must not
        buffer unbounded bytes on the loop's heap."""
        line = await reader.readline()
        if not line or not line.strip():
            return None
        parts = line.decode("latin-1").split()
        if len(parts) < 2:
            return None
        method, path = parts[0].upper(), parts[1]
        headers: Dict[str, str] = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            key, _, value = h.decode("latin-1").partition(":")
            headers[key.strip().lower()] = value.strip()
        length = int(headers.get("content-length", 0) or 0)
        if length > _MAX_BODY:
            raise ValueError(f"body too large ({length} bytes)")
        body = await reader.readexactly(length) if length > 0 else b""
        return method, path, headers, body

    async def _handle_connection(self, reader: asyncio.StreamReader,
                                 writer: asyncio.StreamWriter) -> None:
        """One request per connection (Connection: close framing)."""
        try:
            try:
                req = await self._read_request(reader)
            except ValueError as e:
                writer.write(_response(413, {"error": str(e)}))
                await writer.drain()
                return
            except (asyncio.IncompleteReadError, ConnectionError):
                return
            if req is None:
                return
            method, path, headers, body = req
            await self._route(method, path, headers, body, writer)
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, RuntimeError):
                pass

    async def _route(self, method: str, path: str, headers: Dict[str, str],
                     body: bytes, writer: asyncio.StreamWriter) -> None:
        service = self.service
        if method == "GET" and path == "/healthz":
            if service.draining:
                # alive but attracting no traffic: routers mark down
                writer.write(_response(
                    503, {"ok": False, "draining": True},
                    extra=[("Retry-After", "1")]))
            else:
                try:
                    faults.inject("worker.heartbeat")
                    writer.write(_response(200, {"ok": True}))
                except faults.FaultInjected as e:
                    # unhealthy-but-alive: the router's 5xx path
                    writer.write(_response(
                        500, {"ok": False, "error": str(e)}))
        elif method == "GET" and path == "/stats":
            writer.write(_response(200, service.stats()))   # live during
            # drain — operators watch the flush complete here
        elif method == "POST" and service.draining:
            writer.write(_response(
                503, {"error": "draining", "retry_after_s": 1.0},
                extra=[("Retry-After", "1")]))
        elif method == "POST" and path == "/rank":
            await self._post_rank(headers, body, writer)
        elif method == "POST" and path == "/sweep":
            await self._post_sweep(headers, body, writer)
        elif method == "POST" and path == "/optimize":
            await self._post_optimize(headers, body, writer)
        elif method == "POST" and path == "/sweep/stream":
            await self._post_sweep_stream(headers, body, writer)
        else:
            writer.write(_response(
                404, {"error": f"unknown route {method} {path!r}"}))
        await writer.drain()

    @staticmethod
    def _decode_body(body: bytes) -> Dict:
        return json.loads(body)

    @staticmethod
    def _header_deadline_ms(headers: Dict[str, str]) -> Optional[float]:
        """The X-Deadline-Ms header as relative ms (ValueError on
        garbage — handled by each route's 400 path)."""
        raw = headers.get("x-deadline-ms")
        return None if raw is None else float(raw)

    async def _await_handle(self, handle: PendingQuery,
                            timeout: float = 300.0):
        """Await a coalescer handle without parking a thread.

        The ``on_done`` hook fires on the leader thread and only
        schedules the future's resolution onto this loop.  The
        attach-after-completion race is closed by checking
        ``done.is_set()`` after assigning the hook (``finish()`` sets
        the event before reading ``on_done``, so at least one of the two
        paths always runs).

        A handle carrying a deadline is awaited only that long: on
        lapse it is CANCELLED (per-query — the shared engine pass still
        answers the other batch members) and ``DeadlineExceeded``
        propagates to the route's admission-error path (504)."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()

        def _resolve() -> None:
            if not fut.done():
                fut.set_result(None)

        handle.on_done = lambda _req: loop.call_soon_threadsafe(_resolve)
        if handle.done.is_set():
            _resolve()
        wait = timeout
        if handle.deadline is not None:
            wait = min(wait, handle.remaining_s())
        try:
            await asyncio.wait_for(fut, wait)
        except asyncio.TimeoutError:
            remaining = handle.remaining_s()
            if remaining is not None and remaining <= 0:
                err = DeadlineExceeded(
                    f"{handle.kind} deadline lapsed before the batch "
                    "answered", lane=handle.lane)
                if handle.cancel(err):
                    self.service.admission.record_deadline_shed(
                        handle.lane)
                    raise err
                # finish won the race: fall through to the answer
            else:
                raise
        return handle.get(timeout=1.0)   # completed: returns immediately

    # -- endpoints ----------------------------------------------------------
    async def _post_rank(self, headers: Dict[str, str], body: bytes,
                         writer: asyncio.StreamWriter) -> None:
        service = self.service
        rkey = service.response_key("rank", body)
        cached = service.response_lookup(rkey)
        if cached is not None:
            writer.write(_response(200, cached))
            return
        try:
            p = self._decode_body(body)
            trace, batch_size, by, dests = service.decode_rank(p)
            deadline = service.resolve_deadline(
                p, self._header_deadline_ms(headers))
        except (json.JSONDecodeError, KeyError, ValueError, TypeError,
                UnicodeDecodeError) as e:
            writer.write(_response(
                400, {"error": f"{type(e).__name__}: {e}"}))
            return
        try:
            service.check_quarantine([trace])
            ticket = service.admit_request("rank", [trace], dests,
                                           deadline=deadline)
        except QuarantinedTrace as e:
            writer.write(_quarantine_response(e))
            return
        except AdmissionError as e:
            writer.write(_admission_response(e))
            return
        try:
            handle = service.submit_rank(trace, batch_size, by, dests,
                                         deadline=deadline)
            choices = await self._await_handle(handle)
            out = service.encode_rank(trace, choices)
            service.response_store(rkey, out)
            writer.write(_response(200, out))
        except AdmissionError as e:     # deadline lapse mid-flight (504)
            writer.write(_admission_response(e))
        except (KeyError, ValueError, TypeError) as e:
            writer.write(_response(
                400, {"error": f"{type(e).__name__}: {e}"}))
        except Exception as e:      # engine failure: never kill the loop
            writer.write(_response(
                500, {"error": f"{type(e).__name__}: {e}"}))
        finally:
            service.admission.release(ticket)

    async def _post_sweep(self, headers: Dict[str, str], body: bytes,
                          writer: asyncio.StreamWriter) -> None:
        service = self.service
        rkey = service.response_key("sweep", body)
        cached = service.response_lookup(rkey)
        if cached is not None:
            writer.write(_response(200, cached))
            return
        try:
            p = self._decode_body(body)
            traces, dests = service.decode_sweep(p)
            deadline = service.resolve_deadline(
                p, self._header_deadline_ms(headers))
        except (json.JSONDecodeError, KeyError, ValueError, TypeError,
                UnicodeDecodeError) as e:
            writer.write(_response(
                400, {"error": f"{type(e).__name__}: {e}"}))
            return
        try:
            service.check_quarantine(traces)
            ticket = service.admit_request("sweep", traces, dests,
                                           deadline=deadline)
        except QuarantinedTrace as e:
            writer.write(_quarantine_response(e))
            return
        except AdmissionError as e:
            writer.write(_admission_response(e))
            return
        try:
            handle = service.submit_sweep(traces, dests,
                                          deadline=deadline)
            rows = await self._await_handle(handle)
            out = service.encode_sweep(traces, rows)
            service.response_store(rkey, out)
            writer.write(_response(200, out))
        except AdmissionError as e:     # deadline lapse mid-flight (504)
            writer.write(_admission_response(e))
        except (KeyError, ValueError, TypeError) as e:
            writer.write(_response(
                400, {"error": f"{type(e).__name__}: {e}"}))
        except Exception as e:
            writer.write(_response(
                500, {"error": f"{type(e).__name__}: {e}"}))
        finally:
            service.admission.release(ticket)

    async def _post_optimize(self, headers: Dict[str, str], body: bytes,
                             writer: asyncio.StreamWriter) -> None:
        """What-if Pareto search — bulk lane, executor-offloaded.

        Unlike rank/sweep there is no single coalescer handle to bridge:
        the optimizer is a *loop* of submissions that blocks between
        generations, so the whole search runs on the default thread-pool
        executor while its per-generation sweeps ride the coalescer like
        any other traffic.  Admission is still decided on the loop
        thread before any engine work, same as every other route."""
        service = self.service
        rkey = service.response_key("optimize", body)
        cached = service.response_lookup(rkey)
        if cached is not None:
            writer.write(_response(200, cached))
            return
        try:
            p = self._decode_body(body)
            traces, batch_sizes, dests, knobs = service.decode_optimize(p)
            deadline = service.resolve_deadline(
                p, self._header_deadline_ms(headers))
        except (json.JSONDecodeError, KeyError, ValueError, TypeError,
                UnicodeDecodeError) as e:
            writer.write(_response(
                400, {"error": f"{type(e).__name__}: {e}"}))
            return
        try:
            service.check_quarantine(traces)
            ticket = service.admit_request("optimize", traces, dests,
                                           deadline=deadline)
        except QuarantinedTrace as e:
            writer.write(_quarantine_response(e))
            return
        except AdmissionError as e:
            writer.write(_admission_response(e))
            return
        try:
            from repro_torch.serve.admission import deadline_scope
            from repro_torch.serve.optimizer import encode_optimize

            def _run():
                # executor thread: re-bind the deadline so the search's
                # internal sweeps inherit the remaining budget
                with deadline_scope(deadline):
                    return service.optimize(traces, batch_sizes,
                                            dests=dests, **knobs)

            loop = asyncio.get_running_loop()
            result = await loop.run_in_executor(None, _run)
            out = encode_optimize(result)
            service.response_store(rkey, out)
            writer.write(_response(200, out))
        except AdmissionError as e:     # deadline lapse mid-search (504)
            writer.write(_admission_response(e))
        except (KeyError, ValueError, TypeError) as e:
            writer.write(_response(
                400, {"error": f"{type(e).__name__}: {e}"}))
        except Exception as e:
            writer.write(_response(
                500, {"error": f"{type(e).__name__}: {e}"}))
        finally:
            service.admission.release(ticket)

    async def _post_sweep_stream(self, headers: Dict[str, str],
                                 body: bytes,
                                 writer: asyncio.StreamWriter) -> None:
        """SSE sweep: one ``row`` event per trace, in completion order.

        Every trace gets its own coalescer handle, so all of them share
        the same union pass(es) as a monolithic sweep — streaming
        changes delivery, not engine cost.  Admission prices the WHOLE
        sweep up front (one bulk ticket): a stream the worker cannot
        afford sheds before the first byte of the event stream.

        A client that disconnects mid-stream must not leak: the write
        error surfaces on ``drain()``, the remaining per-trace tasks
        are cancelled and awaited in ``finally`` (no stray ``Task
        exception was never retrieved``), and the one admission ticket
        releases — ``/stats`` inflight returns to zero."""
        service = self.service
        try:
            p = self._decode_body(body)
            traces, dests = service.decode_sweep(p)
            deadline = service.resolve_deadline(
                p, self._header_deadline_ms(headers))
        except (json.JSONDecodeError, KeyError, ValueError, TypeError,
                UnicodeDecodeError) as e:
            writer.write(_response(
                400, {"error": f"{type(e).__name__}: {e}"}))
            return
        try:
            service.check_quarantine(traces)
            ticket = service.admit_request("sweep", traces, dests,
                                           deadline=deadline)
        except QuarantinedTrace as e:
            writer.write(_quarantine_response(e))
            return
        except AdmissionError as e:
            writer.write(_admission_response(e))
            return
        pending: List[asyncio.Future] = []
        try:
            writer.write(b"HTTP/1.1 200 OK\r\n"
                         b"Content-Type: text/event-stream\r\n"
                         b"Cache-Control: no-store\r\n"
                         b"Connection: close\r\n\r\n")
            await writer.drain()

            async def _one(i: int, trace) -> Tuple[int, Dict]:
                handle = service.submit_sweep([trace], dests,
                                              deadline=deadline)
                rows = await self._await_handle(handle)
                return i, {"index": i, "label": trace.label,
                           "times": rows[0]}

            n_err = 0
            pending = [asyncio.ensure_future(_one(i, t))
                       for i, t in enumerate(traces)]
            for fut in asyncio.as_completed(list(pending)):
                try:
                    _, payload = await fut
                    writer.write(_sse_event("row", payload))
                except (ConnectionError, asyncio.CancelledError):
                    raise           # disconnect/shutdown: stop streaming
                except Exception as e:
                    n_err += 1
                    writer.write(_sse_event(
                        "error", {"error": f"{type(e).__name__}: {e}"}))
                await writer.drain()
            writer.write(_sse_event(
                "done", {"count": len(traces) - n_err, "errors": n_err}))
            await writer.drain()
        finally:
            for fut in pending:     # client gone or done: reap the rest
                fut.cancel()
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)
            service.admission.release(ticket)


def _sse_event(event: str, payload: Dict) -> bytes:
    return (f"event: {event}\ndata: "
            f"{json.dumps(payload, allow_nan=False)}\n\n").encode()


def main(argv: Optional[Sequence[str]] = None) -> None:
    from repro_torch.serve.http import build_service, log_engine_caches

    ap = argparse.ArgumentParser(
        description="one asyncio prediction-service worker "
                    "(admission-controlled front door)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080,
                    help="0 binds an ephemeral port (printed on stdout)")
    ap.add_argument("--cache", default=None, metavar="PATH|tcp://H:P",
                    help="shared result cache: a sqlite file path, or "
                         "tcp://host:port of a netcache server "
                         "(default: per-worker in-process LRU)")
    ap.add_argument("--cache-size", type=int, default=262144)
    ap.add_argument("--coalesce-ms", type=float, default=5.0,
                    help="base request-coalescing window in milliseconds "
                         "(the adaptive policy stretches it under light "
                         "load, up to REPRO_WINDOW_MAX_MS)")
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
    server = AsyncPredictionServer(service, host=args.host, port=args.port)
    if args.snapshot:
        # restore BEFORE serve_forever binds and prints readiness: the
        # first request a restarted worker sees must hit warm caches
        server.snapshot = SnapshotManager(args.snapshot, service)
        if server.snapshot.restore():
            print(f"restored {server.snapshot.restored_entries} warm "
                  f"entries from {args.snapshot}", flush=True)
        server.snapshot.start()
    try:
        server.serve_forever()     # prints "serving on <url>" once bound
    finally:
        log_engine_caches(service)


if __name__ == "__main__":
    main()
