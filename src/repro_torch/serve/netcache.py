"""Network result cache: the cross-host shared store (stdlib only).

A copy of ``repro.serve.netcache``: the same length-prefixed,
digest-sealed frames, so the port's client talks to the reference's
server and the other way round.

The sqlite backend (:class:`repro_torch.serve.cache.SqliteCache`) shares one
result set across worker *processes* — but only on one filesystem, which
caps the serving tier at a single host.  This module removes that cap:

* :class:`CacheServer` — a tiny asyncio TCP key-value server holding the
  authoritative store (an :class:`~repro_torch.serve.cache.LRUCache`, so
  capacity/eviction/stats semantics match the in-process backend
  exactly).  One event loop multiplexes every worker's persistent
  connection; its stats are the GLOBAL cross-worker hit/miss accounting
  (each worker's local stats stay per-worker, same split as sqlite).
* :class:`NetCache` — the client backend, implementing the full
  :data:`repro_torch.serve.cache.BACKEND_PROTOCOL` (``get``/``get_many``/
  ``put_many``/``stats``/``describe``/``clear``/``__len__``), so
  ``FleetPlanner``/``PredictionService`` run against it unchanged
  (spelled ``tcp://host:port`` anywhere a cache path is accepted).

Wire protocol — length-prefixed JSON frames, both directions::

    frame   := uint32_be(len(body)) + body
    body    := JSON object, e.g. {"op": "get_many", "keys": [...]}

Keys travel as their ``repr`` (the same deterministic cross-process
encoding ``SqliteCache`` stores); values are float64 milliseconds, which
JSON round-trips bit-exactly (shortest-repr floats), so a cell priced on
one host reads back bitwise-identical on another.

**Graceful degradation** is the client's load-bearing contract: any
transport failure — refused connection, timeout, mid-frame reset,
garbage reply — is absorbed as a cache MISS (plus a ``stats.degraded``
bump) after bounded retry/backoff, and NEVER surfaces as an exception
into the planner.  A dead cache server costs the fleet its shared
warmth, not its answers.  While the server is unreachable the client
opens a short circuit-breaker window (``REPRO_NETCACHE_RECONNECT_S``)
during which probes degrade instantly instead of re-paying the connect
timeout per call, so p99 stays bounded through an outage.

Module CLI (the standalone store; also reachable via
``python -m repro_torch.launch.serve --cache-server``)::

    PYTHONPATH=src python -m repro_torch.serve.netcache --port 9210

``--port 0`` binds an ephemeral port; the actual address is printed as
``serving on tcp://host:port`` (machine-parsable, same readiness
protocol as the HTTP workers).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import random
import socket
import struct
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core import integrity
from repro_torch.core.batched import env_float, env_int
from repro_torch.serve import faults
from repro_torch.serve.admission import remaining_s
from repro_torch.serve.cache import CacheStats, Key, LRUCache

__all__ = ["CacheServer", "NetCache", "main"]

_MAX_FRAME = 64 * 1024 * 1024   # refuse absurd frames, not big batches
_HEAD = struct.Struct("!I")


def _pack(doc: Dict) -> bytes:
    """Wire frame: length header, truncated-sha256 body digest, body.

    The digest rides every frame in both directions so a corrupted or
    desynced stream is *detected* instead of decoded into a wrong cache
    value — the client degrades the call, the server drops the
    connection (see ``integrity.COUNTERS`` ``corrupt_netcache``)."""
    body = json.dumps(doc).encode()
    return _HEAD.pack(len(body)) + integrity.digest(body) + body


def _verify_body(body: bytes, want: bytes) -> bytes:
    """Client-side digest check; a mismatch counts and raises (the
    ``IntegrityError`` is a ``ValueError``, so the existing transport
    except-clauses absorb it into degradation/breaker handling)."""
    if integrity.digest(body) != want:
        integrity.COUNTERS.bump("netcache")
        raise integrity.IntegrityError("netcache frame failed checksum")
    return body


class _CacheUnavailable(OSError):
    """Internal: every retry against the cache server failed (absorbed
    by the public NetCache methods — callers never see it)."""


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------
class CacheServer:
    """Authoritative network store: one asyncio loop, one LRU.

    Run styles mirror ``AsyncPredictionServer``: ``serve_forever()``
    owns the calling thread (the standalone-process entry point),
    ``start()`` spins the loop on a daemon thread and returns once the
    socket is bound (tests, benches); ``shutdown()`` stops and joins.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 capacity: int = 262144):
        self.host = host
        self.port = port
        # LRUCache is thread-safe and counts every probe — its stats are
        # the cross-worker global accounting the /stats "netcache" block
        # and the cluster bench read
        self.store = LRUCache(capacity)
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        return f"tcp://{self.host}:{self.port}"

    # -- protocol ------------------------------------------------------------
    def _dispatch(self, req: Dict) -> Dict:
        op = req.get("op")
        if op == "get_many":
            return {"vals": self.store.get_many(
                [(k,) for k in req["keys"]])}
        if op == "put_many":
            self.store.put_many([((k,), float(ms))
                                 for k, ms in req["items"]])
            return {"ok": True}
        if op == "stats":
            return {"stats": self.store.stats.as_dict(),
                    "entries": len(self.store),
                    "capacity": self.store.capacity}
        if op == "clear":
            self.store.clear()
            return {"ok": True}
        if op == "len":
            return {"n": len(self.store)}
        if op == "ping":
            return {"ok": True}
        return {"error": f"unknown op {op!r}"}

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        """One worker's persistent connection: frames until it closes."""
        try:
            while True:
                head = await reader.readexactly(_HEAD.size)
                (n,) = _HEAD.unpack(head)
                if n > _MAX_FRAME:
                    writer.write(_pack({"error": f"frame too large ({n})"}))
                    await writer.drain()
                    return
                want = await reader.readexactly(integrity.DIGEST_BYTES)
                body = await reader.readexactly(n)
                if integrity.digest(body) != want:
                    # an inbound frame that fails its checksum means the
                    # stream itself cannot be trusted: drop the whole
                    # connection (the client reconnects) rather than
                    # store a corrupted value for every worker to share
                    integrity.COUNTERS.bump("netcache")
                    return
                try:
                    req = json.loads(body)
                    resp = self._dispatch(req)
                except (json.JSONDecodeError, KeyError, TypeError,
                        ValueError) as e:
                    resp = {"error": f"{type(e).__name__}: {e}"}
                writer.write(_pack(resp))
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.CancelledError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, RuntimeError, OSError):
                pass

    # -- lifecycle -----------------------------------------------------------
    async def _bind(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    def serve_forever(self) -> None:
        """Bind and serve on the calling thread until interrupted."""
        async def _run():
            await self._bind()
            print(f"serving on {self.address}", flush=True)
            async with self._server:
                await self._server.serve_forever()
        try:
            asyncio.run(_run())
        except KeyboardInterrupt:
            pass

    def start(self) -> "CacheServer":
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
            raise RuntimeError("cache server failed to bind within 30s")
        return self

    def shutdown(self) -> None:
        if self._loop is None:
            return

        def _stop():
            if self._server is not None:
                self._server.close()
            tasks = list(asyncio.all_tasks(self._loop))
            for task in tasks:
                task.cancel()

            async def _finish():
                # let cancelled connection handlers actually unwind
                # before the loop stops (else "Task was destroyed but
                # it is pending" noise on teardown)
                await asyncio.gather(*tasks, return_exceptions=True)
                self._loop.stop()

            self._loop.create_task(_finish())

        self._loop.call_soon_threadsafe(_stop)
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._loop.close()
        self._loop = None


# ---------------------------------------------------------------------------
# client backend
# ---------------------------------------------------------------------------
class NetCache:
    """Result-cache backend speaking to a :class:`CacheServer`.

    Implements the full backend protocol, so it drops in anywhere
    ``LRUCache``/``SqliteCache`` do.  One persistent socket, one
    in-flight call at a time (the backend lock — same serialization
    discipline as ``SqliteCache``'s connection).

    Parameters (each defaulting to its env knob, see ``docs/knobs.md``):

    timeout_s:
        Per-call socket deadline, connect included
        (``REPRO_NETCACHE_TIMEOUT_S``, 2.0).
    retries:
        Transport retries per call beyond the first attempt, with
        exponential backoff (``REPRO_NETCACHE_RETRIES``, 2).
    backoff_s:
        Initial retry backoff; doubles per attempt
        (``REPRO_NETCACHE_BACKOFF_S``, 0.05).
    reconnect_s:
        Circuit-breaker window after every retry fails: calls inside it
        degrade instantly (miss + ``degraded``) without touching the
        network, so a dead server cannot add its connect timeout to
        every request (``REPRO_NETCACHE_RECONNECT_S``, 1.0).
    probe_s:
        Timeout of the **half-open** probe: when the breaker window
        lapses, the next call first pings with this short timeout
        instead of re-paying the full call timeout x retries against a
        still-dead server — a refused connect costs microseconds, a
        black hole costs ``probe_s``.  A failed probe re-opens the
        breaker with jitter (0.75–1.25 x ``reconnect_s``) so a worker
        fleet does not re-probe in lockstep
        (``REPRO_NETCACHE_PROBE_S``, 0.1).

    The breaker is observable: :attr:`breaker_state` is ``"closed"``
    (healthy), ``"open"`` (degrading instantly), or ``"half_open"``
    (window lapsed, next call probes), surfaced in ``/stats`` under
    ``cache.breaker_state``.
    """

    def __init__(self, address: str, timeout_s: Optional[float] = None,
                 retries: Optional[int] = None,
                 backoff_s: Optional[float] = None,
                 reconnect_s: Optional[float] = None,
                 probe_s: Optional[float] = None):
        if not address.startswith("tcp://"):
            raise ValueError(f"netcache address must be tcp://host:port, "
                             f"got {address!r}")
        hostport = address[len("tcp://"):]
        host, sep, port = hostport.rpartition(":")
        if not sep or not port.isdigit():
            raise ValueError(f"netcache address must be tcp://host:port, "
                             f"got {address!r}")
        self.address = address
        self.host = host
        self.port = int(port)
        self.timeout_s = (env_float("REPRO_NETCACHE_TIMEOUT_S", 2.0)
                          if timeout_s is None else float(timeout_s))
        self.retries = (env_int("REPRO_NETCACHE_RETRIES", 2)
                        if retries is None else int(retries))
        self.backoff_s = (env_float("REPRO_NETCACHE_BACKOFF_S", 0.05)
                          if backoff_s is None else float(backoff_s))
        self.reconnect_s = (env_float("REPRO_NETCACHE_RECONNECT_S", 1.0)
                            if reconnect_s is None else float(reconnect_s))
        self.probe_s = (env_float("REPRO_NETCACHE_PROBE_S", 0.1)
                        if probe_s is None else float(probe_s))
        self.stats = CacheStats()
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._down_until = 0.0
        self._tripped = False   # breaker opened and not yet re-proven

    def describe(self) -> str:
        return f"netcache({self.address})"

    # -- transport -----------------------------------------------------------
    @property
    def breaker_state(self) -> str:
        """``"closed"`` | ``"open"`` | ``"half_open"`` (see class doc)."""
        with self._lock:
            if not self._tripped:
                return "closed"
            return ("open" if time.monotonic() < self._down_until
                    else "half_open")

    def _connect_locked(self, timeout: float) -> socket.socket:
        if self._sock is None:
            sock = socket.create_connection((self.host, self.port),
                                            timeout=timeout)
            self._sock = sock
        self._sock.settimeout(timeout)
        return self._sock

    def _half_open_probe_locked(self) -> None:
        """Cheap liveness probe after the breaker window lapses.

        One ping frame under the short ``probe_s`` timeout: success
        closes the breaker (the probed socket is kept for the real
        call); failure re-opens it with jitter and raises — the caller
        degrades without ever paying the full timeout x retry budget
        against a server that is still dead."""
        try:
            sock = self._connect_locked(self.probe_s)
            sock.sendall(_pack({"op": "ping"}))
            head = self._recv_exact(sock, _HEAD.size)
            (n,) = _HEAD.unpack(head)
            if n > _MAX_FRAME:
                raise ConnectionError(f"oversized reply ({n})")
            want = self._recv_exact(sock, integrity.DIGEST_BYTES)
            json.loads(_verify_body(self._recv_exact(sock, n), want))
            self._tripped = False
        except (OSError, ValueError, json.JSONDecodeError,
                struct.error) as e:
            self._drop_socket_locked()
            self._down_until = time.monotonic() + self.reconnect_s * (
                0.75 + 0.5 * random.random())
            raise _CacheUnavailable(e)

    def _drop_socket_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    @staticmethod
    def _recv_exact(sock: socket.socket, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("cache server closed the connection")
            buf.extend(chunk)
        return bytes(buf)

    def _call(self, doc: Dict) -> Dict:
        """One request/response round-trip with retry + circuit breaker.

        Raises :class:`_CacheUnavailable` only after every attempt
        failed; the public methods translate that into degradation."""
        frame = _pack(doc)
        # derive the socket budget from the enclosing request deadline
        # (when one is bound): a tight budget must shrink the worst case
        # a cache stall can add, degrading to a local compute instead of
        # blocking the whole batch past its deadline
        budget = remaining_s()
        timeout = self.timeout_s
        if budget is not None:
            if budget < 0.001:
                raise _CacheUnavailable("request deadline exhausted")
            timeout = min(timeout, budget)
        with self._lock:
            if self._tripped:
                if time.monotonic() < self._down_until:
                    raise _CacheUnavailable("circuit open")
                self._half_open_probe_locked()  # raises if still dead
            last: Optional[BaseException] = None
            for attempt in range(self.retries + 1):
                if attempt:
                    time.sleep(self.backoff_s * (1 << (attempt - 1)))
                try:
                    sock = self._connect_locked(timeout)
                    sock.sendall(frame)
                    head = self._recv_exact(sock, _HEAD.size)
                    (n,) = _HEAD.unpack(head)
                    if n > _MAX_FRAME:
                        raise ConnectionError(f"oversized reply ({n})")
                    want = self._recv_exact(sock, integrity.DIGEST_BYTES)
                    resp = json.loads(
                        _verify_body(self._recv_exact(sock, n), want))
                    if "error" in resp:
                        # a protocol-level refusal is not retryable —
                        # and not a transport outage either; treat as
                        # unavailable for THIS call without tripping
                        # the breaker
                        raise _CacheUnavailable(resp["error"])
                    return resp
                except _CacheUnavailable:
                    self._drop_socket_locked()
                    raise
                except (OSError, ValueError, json.JSONDecodeError,
                        struct.error) as e:
                    last = e
                    self._drop_socket_locked()
            self._tripped = True
            self._down_until = time.monotonic() + self.reconnect_s
            raise _CacheUnavailable(last)

    # -- backend protocol ----------------------------------------------------
    @staticmethod
    def _encode(key: Key) -> str:
        # same deterministic cross-process key encoding as SqliteCache
        return repr(key)

    def get(self, key: Key) -> Optional[float]:
        return self.get_many([key])[0]

    def get_many(self, keys: Sequence[Key]) -> List[Optional[float]]:
        keys = list(keys)
        if not keys:
            return []
        try:
            faults.inject("netcache.get_many")
            vals = self._call({"op": "get_many",
                               "keys": [self._encode(k) for k in keys]}
                              )["vals"]
            if len(vals) != len(keys):
                raise _CacheUnavailable("short reply")
        except (faults.FaultInjected, _CacheUnavailable, KeyError,
                TypeError):
            with self._lock:
                self.stats.degraded += 1
                self.stats.misses += len(keys)
            return [None] * len(keys)
        out: List[Optional[float]] = []
        hits = 0
        for v in vals:
            out.append(float(v) if v is not None else None)
            hits += v is not None
        with self._lock:
            self.stats.hits += hits
            self.stats.misses += len(keys) - hits
        return out

    def put_many(self, items: Iterable[Tuple[Key, float]]) -> None:
        items = list(items)
        if not items:
            return
        try:
            self._call({"op": "put_many",
                        "items": [[self._encode(k), float(ms)]
                                  for k, ms in items]})
        except (_CacheUnavailable, KeyError, TypeError):
            # the fill is lost, the answers are not — pure warmth cost
            with self._lock:
                self.stats.degraded += 1

    def clear(self) -> None:
        """Drop all SHARED entries and reset this worker's counters."""
        try:
            self._call({"op": "clear"})
        except (_CacheUnavailable, KeyError, TypeError):
            pass
        with self._lock:
            self.stats = CacheStats()

    def __len__(self) -> int:
        try:
            return int(self._call({"op": "len"})["n"])
        except (_CacheUnavailable, KeyError, TypeError, ValueError):
            return 0

    def server_stats(self) -> Optional[Dict]:
        """GLOBAL cross-worker accounting from the server (None when
        unreachable) — surfaced as the ``cache.netcache`` /stats block.
        The reachable payload carries ``breaker_state`` too (always
        ``"closed"`` by construction — an open breaker means this very
        call degrades to None; the standalone field on the ``cache``
        /stats block is the one to alert on)."""
        try:
            resp = self._call({"op": "stats"})
            return {"entries": resp["entries"],
                    "capacity": resp["capacity"],
                    "breaker_state": self.breaker_state,
                    **resp["stats"]}
        except (_CacheUnavailable, KeyError, TypeError):
            return None

    def ping(self) -> bool:
        """Liveness probe (used by health checks and tests)."""
        try:
            return bool(self._call({"op": "ping"}).get("ok"))
        except (_CacheUnavailable, KeyError, TypeError):
            return False

    def close(self) -> None:
        with self._lock:
            self._drop_socket_locked()


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="standalone network result-cache server")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9210,
                    help="0 binds an ephemeral port (printed on stdout)")
    ap.add_argument("--capacity", type=int, default=262144,
                    help="LRU entry bound of the shared store")
    args = ap.parse_args(argv)
    server = CacheServer(host=args.host, port=args.port,
                         capacity=args.capacity)
    try:
        server.serve_forever()      # prints "serving on tcp://..." once bound
    finally:
        st = server.store.stats
        print(f"netcache on shutdown: entries={len(server.store)} "
              f"hits={st.hits} misses={st.misses} "
              f"evictions={st.evictions}", flush=True)


if __name__ == "__main__":
    main()
