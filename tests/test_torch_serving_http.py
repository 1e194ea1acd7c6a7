"""Port parity: the two HTTP front ends of the prediction service.

The cases of the reference's ``tests/test_service_http.py`` (two real
worker processes, ``python -m repro_torch.serve.http --device cpu``,
sharing one sqlite result cache) and ``tests/test_aserver.py`` (the
asyncio server in process), run on the port with ``device="cpu"``
predictors.  The traces are tracked by the reference and carried over
through ``to_dict``/``from_dict``.  Across the packages: the reference's
client against the port's servers and the port's client against the
reference's, with the same status codes and answers within rel 1e-12.
A worker started without ``--device cpu`` on a host without a GPU exits
non-zero with ``torch_device``'s error."""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import pytest

from repro.core import OperationTracker
from repro_torch.core import devices
from repro_torch.core.predictor import HabitatPredictor
from repro_torch.core.trace import TrackedTrace
from repro_torch.serve.admission import AdmissionController
from repro_torch.serve.aserver import AsyncPredictionServer, iter_sse
from repro_torch.serve.fleet import FleetPlanner
from repro_torch.serve.http import PredictionClient, PredictionServer
from repro_torch.serve.service import PredictionService

DEVS = sorted(devices.all_devices())
SRC = Path(__file__).resolve().parents[1] / "src"


def cpu_predictor(**kw) -> HabitatPredictor:
    return HabitatPredictor(device="cpu", **kw)


def _ref_trace(n, label):
    return OperationTracker("T4").track(
        lambda w, x: jnp.sum(jnp.tanh(x @ w)),
        jnp.zeros((n, 24)), jnp.zeros((8, n)), label=label)


def _trace(n, label) -> TrackedTrace:
    return TrackedTrace.from_dict(_ref_trace(n, label).to_dict())


def _worker_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(SRC), env.get("PYTHONPATH")) if p)
    return env


# ---------------------------------------------------------------------------
# worker processes (tests/test_service_http.py)
# ---------------------------------------------------------------------------
def _spawn_worker(cache_path, coalesce_ms=40.0, flush_at=64):
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serve.http", "--port", "0",
         "--device", "cpu",
         "--cache", str(cache_path), "--coalesce-ms", str(coalesce_ms),
         "--flush-at", str(flush_at)],
        env=_worker_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    deadline = time.monotonic() + 120
    line = ""
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if line.startswith("serving on "):
            return proc, line.split()[-1].strip()
        if proc.poll() is not None:
            break
    proc.kill()
    raise RuntimeError(f"worker failed to start: {line!r}")


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    """Two HTTP workers sharing one sqlite cache file."""
    cache = tmp_path_factory.mktemp("shared") / "cache.sqlite"
    procs, urls = [], []
    try:
        for _ in range(2):
            proc, url = _spawn_worker(cache)
            procs.append(proc)
            urls.append(url)
        yield urls
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()


def test_healthz_and_stats_roundtrip(workers):
    client = PredictionClient(workers[0])
    assert client.healthz() == {"ok": True}
    stats = client.stats()
    assert stats["fleet"] == DEVS
    assert {"requests", "coalescing", "cache", "engine_passes"} <= set(stats)
    assert "sqlite" in stats["cache"]["backend"]


def test_rank_roundtrip_matches_local_planner(workers):
    """An HTTP answer is bitwise-identical to the in-process answer —
    the wire format (JSON shortest-repr floats) loses nothing."""
    client = PredictionClient(workers[0])
    tr = _trace(16, "http-parity")
    remote = client.rank(tr, batch_size=32)
    local = FleetPlanner(predictor=cpu_predictor()).rank(tr, 32)
    assert [r["device"] for r in remote] == [c.device for c in local]
    assert [r["iter_ms"] for r in remote] == [c.iter_ms for c in local]
    assert [r["throughput"] for r in remote] == \
        [c.throughput for c in local]


def test_sweep_roundtrip_threaded(workers):
    client = PredictionClient(workers[0])
    traces = [_trace(12, "sw-a"), _trace(20, "sw-b")]
    rows = client.sweep(traces, dests=["T4", "V100"])
    local = FleetPlanner(predictor=cpu_predictor()).sweep(
        traces, dests=["T4", "V100"])
    assert rows == local


def test_bad_requests_are_client_errors_threaded(workers):
    req = urllib.request.Request(
        workers[0] + "/rank", data=b'{"nope": 1}',
        headers={"Content-Type": "application/json"}, method="POST")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(workers[0] + "/no-such", timeout=30)
    assert ei.value.code == 404


def test_concurrent_requests_coalesce_threaded(workers):
    """N concurrent /rank posts about one NEW trace land in few batches
    and — deduped by fingerprint — cost at most one engine pass per
    batch, with exactly one miss per unique cache key."""
    client = PredictionClient(workers[0])
    before = client.stats()
    tr = _trace(28, "coalesce-burst")
    n_clients = 6
    barrier = threading.Barrier(n_clients)
    results, errors = [None] * n_clients, []

    def fire(i):
        barrier.wait()
        try:
            results[i] = client.rank(tr, batch_size=16)
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=fire, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert all(r == results[0] for r in results)
    after = client.stats()
    d_requests = (after["requests"]["rank"] - before["requests"]["rank"])
    d_batches = after["coalescing"]["batches"] - \
        before["coalescing"]["batches"]
    d_misses = after["cache"]["misses"] - before["cache"]["misses"]
    d_passes = after["engine_passes"] - before["engine_passes"]
    assert d_requests == n_clients
    assert d_batches < n_clients            # genuinely coalesced
    assert d_passes <= d_batches            # dedup: <= one pass per batch
    assert d_misses == len(DEVS)            # one miss per unique key
    assert after["coalescing"]["max_batch"] >= 2


def test_cross_process_shared_cache_hit(workers):
    """End-to-end acceptance: a trace first predicted by worker A is a
    cache HIT on worker B (shared sqlite backend), with identical
    numbers and zero engine passes on B."""
    a, b = PredictionClient(workers[0]), PredictionClient(workers[1])
    tr = _trace(36, "cross-worker")
    b_before = b.stats()
    from_a = a.rank(tr, batch_size=8)
    from_b = b.rank(tr, batch_size=8)
    assert from_b == from_a                 # bitwise through sqlite REAL
    b_after = b.stats()
    assert (b_after["cache"]["hits"] - b_before["cache"]["hits"]
            == len(DEVS))
    assert b_after["cache"]["misses"] == b_before["cache"]["misses"]
    assert b_after["engine_passes"] == b_before["engine_passes"]


# ===========================================================================
# the asyncio front end (tests/test_aserver.py)
# ===========================================================================
@pytest.fixture(scope="module")
def server():
    service = PredictionService(predictor=cpu_predictor(),
                                coalesce_window_ms=5.0)
    srv = AsyncPredictionServer(service).start()
    yield srv
    srv.shutdown()


@pytest.fixture(scope="module")
def client(server):
    return PredictionClient(server.url)


def test_healthz_and_stats(client):
    assert client.healthz() == {"ok": True}
    stats = client.stats()
    assert stats["fleet"] == DEVS
    assert {"requests", "coalescing", "cache", "engine_passes",
            "admission"} <= set(stats)
    assert set(stats["admission"]["admitted"]) == {"interactive", "bulk"}


def test_rank_parity_with_local_planner(client):
    """An async-served answer is bitwise-identical to the in-process
    planner answer — same guarantee the threaded server is pinned to."""
    tr = _trace(16, "aserver-parity")
    remote = client.rank(tr, batch_size=32)
    local = FleetPlanner(predictor=cpu_predictor()).rank(tr, 32)
    assert [r["device"] for r in remote] == [c.device for c in local]
    assert [r["iter_ms"] for r in remote] == [c.iter_ms for c in local]


def test_sweep_roundtrip_async(client):
    traces = [_trace(12, "asw-a"), _trace(20, "asw-b")]
    rows = client.sweep(traces, dests=["T4", "V100"])
    local = FleetPlanner(predictor=cpu_predictor()).sweep(
        traces, dests=["T4", "V100"])
    assert rows == local


def test_sweep_stream_sse(client):
    """SSE: one row event per trace (any completion order), one done."""
    traces = [_trace(10 + 4 * i, f"sse-{i}") for i in range(4)]
    events = list(client.sweep_stream(traces, dests=["T4", "P100"]))
    rows = [p for e, p in events if e == "row"]
    assert [e for e, _ in events].count("done") == 1
    assert events[-1][0] == "done"
    assert events[-1][1] == {"count": 4, "errors": 0}
    assert sorted(r["index"] for r in rows) == [0, 1, 2, 3]
    local = FleetPlanner(predictor=cpu_predictor()).sweep(
        traces, dests=["T4", "P100"])
    for r in rows:
        assert r["label"] == traces[r["index"]].label
        assert r["times"] == local[r["index"]]


def test_concurrent_requests_coalesce_async(server, client):
    before = client.stats()
    tr = _trace(28, "aserver-burst")
    n_clients = 6
    barrier = threading.Barrier(n_clients)
    results, errors = [None] * n_clients, []

    def fire(i):
        barrier.wait()
        try:
            results[i] = client.rank(tr, batch_size=16)
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=fire, args=(i,))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert all(r == results[0] for r in results)
    after = client.stats()
    assert (after["requests"]["rank"] - before["requests"]["rank"]
            == n_clients)
    assert (after["coalescing"]["batches"]
            - before["coalescing"]["batches"]) < n_clients


def test_bad_requests_are_client_errors_async(server):
    req = urllib.request.Request(
        server.url + "/rank", data=b'{"nope": 1}',
        headers={"Content-Type": "application/json"}, method="POST")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(server.url + "/no-such", timeout=30)
    assert ei.value.code == 404


def test_sheds_429_with_retry_after():
    service = PredictionService(
        predictor=cpu_predictor(), coalesce_window_ms=0.0,
        admission=AdmissionController(max_queue=64, max_inflight_s=1e-12))
    srv = AsyncPredictionServer(service).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            PredictionClient(srv.url).rank(_trace(8, "shed"), batch_size=8)
        assert ei.value.code == 429
        assert int(ei.value.headers["Retry-After"]) >= 1
        body = json.loads(ei.value.read())
        ei.value.close()    # the HTTPError owns the response socket
        assert body["lane"] == "interactive"
        assert body["retry_after_s"] > 0
    finally:
        srv.shutdown()


def test_sheds_503_when_queue_full():
    service = PredictionService(
        predictor=cpu_predictor(), coalesce_window_ms=0.0,
        admission=AdmissionController(max_queue=0, max_inflight_s=10.0))
    srv = AsyncPredictionServer(service).start()
    try:
        client = PredictionClient(srv.url)
        with pytest.raises(urllib.error.HTTPError) as ei:
            client.sweep([_trace(8, "full")], dests=["T4"])
        assert ei.value.code == 503
        assert "Retry-After" in ei.value.headers
        ei.value.close()    # the HTTPError owns the response socket
        assert client.stats()["admission"]["shed_503"] == 1
    finally:
        srv.shutdown()


def test_iter_sse_framing():
    """Client and server share this parser; pin the framing rules."""
    stream = (b"event: row\n", b"data: {\"index\": 0}\n", b"\n",
              b"data: {\"x\": 1}\n", b"\n",
              b"event: done\n", b"data: {\"count\": 1}\n", b"\n")
    assert list(iter_sse(stream)) == [
        ("row", {"index": 0}),
        ("message", {"x": 1}),          # default event type
        ("done", {"count": 1}),
    ]
    # stream truncated without the trailing blank line still yields
    assert list(iter_sse((b"event: row\n", b"data: {}\n"))) == \
        [("row", {})]


def test_sse_client_disconnect_releases_ticket_and_tasks():
    """A client that vanishes mid-stream must not leak: the admission
    ticket releases, no pending query or asyncio task survives."""
    import asyncio
    import socket

    from repro_torch.serve import faults

    service = PredictionService(predictor=cpu_predictor(),
                                coalesce_window_ms=1.0)
    srv = AsyncPredictionServer(service).start()
    client = PredictionClient(srv.url)
    try:
        traces = [_trace(10 + 2 * i, f"disc-{i}") for i in range(6)]
        client.rank(traces[0], batch_size=8)        # warm the engine

        def _tasks():
            async def _count():
                return sum(1 for t in asyncio.all_tasks() if not t.done())
            return asyncio.run_coroutine_threadsafe(
                _count(), srv._loop).result(timeout=5)

        baseline_tasks = _tasks()
        faults.arm("engine.pass:delay=150ms,p=1.0")
        payload = json.dumps({
            "traces": [t.to_dict() for t in traces],
            "dests": ["T4", "V100"]}).encode()
        host, port = srv.host, srv.port
        sock = socket.create_connection((host, port), timeout=10)
        sock.sendall(
            b"POST /sweep/stream HTTP/1.1\r\n"
            b"Host: x\r\nContent-Type: application/json\r\n"
            b"Content-Length: " + str(len(payload)).encode() + b"\r\n"
            b"\r\n" + payload)
        sock.recv(256)          # the 200 + SSE headers arrived: streaming
        sock.shutdown(socket.SHUT_RDWR)     # client walks away mid-stream
        sock.close()

        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and \
                client.stats()["admission"]["inflight_requests"]:
            time.sleep(0.05)
        adm = client.stats()["admission"]
        assert adm["inflight_requests"] == 0        # ticket released
        assert adm["inflight_cost_s"] == 0.0
        # the /stats connections above each ride their own handler task;
        # give those (and the reaped stream) a beat to wind down before
        # asserting nothing leaked
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and _tasks() > baseline_tasks:
            time.sleep(0.05)
        assert _tasks() <= baseline_tasks           # no leaked task
        with service._cond:                         # no leaked query
            assert not service._pending
    finally:
        faults.disarm()
        env_spec = os.environ.get("REPRO_FAULTS", "").strip()
        if env_spec:            # keep a suite-level arming intact
            faults.arm(env_spec)
        srv.shutdown()


# ===========================================================================
# across the packages
# ===========================================================================
def _close(got, want, rel=1e-12):
    """Decoded documents: same keys and orders, numbers within ``rel``."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _close(got[k], want[k], rel)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rel)
    elif isinstance(want, float) and not isinstance(got, str):
        assert got == pytest.approx(want, rel=rel, abs=0.0)
    else:
        assert got == want


def _status(url, path, body=None):
    """(status, decoded body) of one request, errors included."""
    req = urllib.request.Request(
        url + path, data=None if body is None else body.encode(),
        headers={"Content-Type": "application/json"},
        method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        with e:
            return e.code, json.loads(e.read() or b"{}")


@pytest.fixture(scope="module")
def both_servers():
    """A threaded server of each package, analytical CPU predictors."""
    from repro.core import HabitatPredictor as RefPredictor
    from repro.serve.http import PredictionServer as RefServer
    from repro.serve.service import PredictionService as RefService
    port = PredictionServer(PredictionService(
        predictor=cpu_predictor(), coalesce_window_ms=1.0)).start()
    ref = RefServer(RefService(predictor=RefPredictor(),
                               coalesce_window_ms=1.0)).start()
    yield port, ref
    port.shutdown()
    ref.shutdown()


@pytest.mark.parametrize("client_pkg", ["reference", "port"])
def test_clients_cross_the_packages(both_servers, client_pkg):
    """Each package's client against the OTHER package's server answers
    as it does against its own: same device order, rel 1e-12."""
    from repro.serve.http import PredictionClient as RefClient
    port, ref = both_servers
    if client_pkg == "reference":
        client, server_pkg = RefClient, port
        own = RefClient(ref.url)
        traces = [_ref_trace(12 + 4 * i, f"x-{i}") for i in range(3)]
    else:
        client, server_pkg = PredictionClient, ref
        own = PredictionClient(port.url)
        traces = [_trace(12 + 4 * i, f"x-{i}") for i in range(3)]
    other = client(server_pkg.url)
    for t in traces:
        for by in ("throughput", "cost"):
            _close(other.rank(t, batch_size=16, by=by),
                   own.rank(t, batch_size=16, by=by))
    _close(other.sweep(traces, dests=["T4", "V100", "tpu-v5e"]),
           own.sweep(traces, dests=["T4", "V100", "tpu-v5e"]))
    assert other.healthz() == own.healthz() == {"ok": True}


def test_status_codes_agree_across_packages(both_servers):
    """The same request bytes get the same status and body keys from
    both packages' servers, answers within rel 1e-12."""
    port, ref = both_servers
    doc = _ref_trace(20, "codes").to_dict()
    bodies = {
        "/rank": [json.dumps({"trace": doc, "batch_size": 8}),
                  json.dumps({"trace": doc, "batch_size": 8,
                              "dests": ["T4", "no-such-device"]}),
                  json.dumps({"nope": 1}), "{not json",
                  json.dumps({"trace": doc, "batch_size": 8,
                              "by": "latency"})],
        "/sweep": [json.dumps({"traces": [doc], "dests": ["T4", "P100"]}),
                   json.dumps({"traces": []})],
        "/optimize": [json.dumps({"traces": [doc], "batch_sizes": [8],
                                  "max_replicas": 2, "seed": 1}),
                      json.dumps({"traces": [doc], "batch_sizes": [8, 16]})],
        "/no-such": [json.dumps({})],
    }
    for path, payloads in bodies.items():
        for body in payloads:
            got, want = _status(port.url, path, body), \
                _status(ref.url, path, body)
            assert got[0] == want[0], (path, body[:60], got, want)
            if want[0] == 200:
                _close(got[1], want[1])
            else:
                assert set(got[1]) == set(want[1])
    assert _status(port.url, "/healthz")[0] == 200
    assert _status(port.url, "/nowhere")[0] == \
        _status(ref.url, "/nowhere")[0] == 404


def test_worker_without_device_cpu_refuses_to_start():
    """A worker asks for ``cuda`` unless told otherwise; with no GPU it
    exits non-zero with ``torch_device``'s error, never serving from
    the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the worker would start")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve.http", "--port", "0"],
        env=_worker_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "serving on" not in proc.stdout
    assert "torch.cuda.is_available() is False" in proc.stderr


@pytest.mark.parametrize("front", ["threaded", "router"])
def test_a_burst_of_connections_is_never_reset(front):
    """128 clients connecting at once all get answers: the threaded
    servers listen with a backlog of ``socket.SOMAXCONN`` (the stdlib's
    5 resets connections under such a burst)."""
    from repro_torch.serve.router import FingerprintRouter, RouterServer
    server = PredictionServer(PredictionService(
        predictor=cpu_predictor(), coalesce_window_ms=0.0)).start()
    face = (RouterServer(FingerprintRouter([server.url]), port=0).start()
            if front == "router" else server)
    n = 128
    barrier, codes = threading.Barrier(n), []

    def hit():
        barrier.wait()
        codes.append(_status(face.url, "/healthz")[0])

    threads = [threading.Thread(target=hit) for _ in range(n)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        if face is not server:
            face.shutdown()
        server.shutdown()
    assert codes == [200] * n
