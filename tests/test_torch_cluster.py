"""Port parity: the cluster tier (network cache, router, supervisor).

The cases of the reference's ``tests/test_cluster_tier.py`` and the
cluster parts of ``tests/test_chaos.py`` (worker supervision, router
probes, the netcache breaker), run on the port with ``device="cpu"``
predictors and traces the reference tracked and carried over through
``to_dict``/``from_dict``.  Across the packages: the port's
``NetCache`` against the reference's ``CacheServer`` (and the other way
round) bitwise on values, and both routers shard a fingerprint onto the
same worker."""

import http.server
import json
import socket
import sys
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import pytest

from repro.core import OperationTracker
from repro_torch.core.predictor import HabitatPredictor
from repro_torch.core.trace import TrackedTrace
from repro_torch.serve.cache import LRUCache, make_backend
from repro_torch.serve.fleet import FleetPlanner
from repro_torch.serve.http import (PredictionClient, PredictionServer,
                                    build_service)
from repro_torch.serve.netcache import CacheServer, NetCache
from repro_torch.serve.router import (FingerprintRouter, RoutedError,
                                      RouterServer)
from repro_torch.serve.service import PredictionService


def cpu_predictor(**kw) -> HabitatPredictor:
    return HabitatPredictor(device="cpu", **kw)


def _toy_step(w, x):
    return jnp.sum(jnp.tanh(x @ w))


def _ref_trace(n: int = 32, origin: str = "T4"):
    return OperationTracker(origin).track(
        _toy_step, jnp.zeros((n, 16)), jnp.zeros((4, n)))


def _trace(n: int = 32, origin: str = "T4") -> TrackedTrace:
    return TrackedTrace.from_dict(_ref_trace(n, origin).to_dict())


_DESTS = ["T4", "V100", "tpu-v5e"]


class FlakyBackend(LRUCache):
    """An LRU whose transport 'fails' on demand — stands in for any
    backend whose get/put raises into the planner."""

    def __init__(self, capacity: int = 64):
        super().__init__(capacity)
        self.fail = False

    def get_many(self, keys):
        if self.fail:
            raise ConnectionError("backend down")
        return super().get_many(keys)

    def put_many(self, items):
        if self.fail:
            raise ConnectionError("backend down")
        super().put_many(items)


# ---------------------------------------------------------------------------
# netcache: server + client backend
# ---------------------------------------------------------------------------
@pytest.fixture()
def cache_server():
    server = CacheServer(port=0, capacity=64).start()
    yield server
    server.shutdown()


def test_netcache_roundtrip_bitwise(cache_server):
    nc = NetCache(cache_server.address)
    vals = [0.1, 1e-300, 123456.789e12, 2.0 / 3.0]
    keys = [((f"fp{i}", "T4", ("HabitatPredictor", False), "tok"),)
            for i in range(len(vals))]
    nc.put_many(list(zip(keys, vals)))
    assert nc.get_many(keys) == vals        # exact, not approx
    assert nc.get(keys[0]) == vals[0]
    assert nc.get(("absent",)) is None
    assert len(nc) == len(vals)
    assert nc.stats.hits == 5 and nc.stats.misses == 1
    server = nc.server_stats()
    assert server["entries"] == len(vals) and server["hits"] == 5
    assert nc.ping()
    nc.clear()
    assert len(nc) == 0 and nc.stats.hits == 0
    nc.close()


def test_netcache_is_a_full_backend(cache_server):
    """make_backend's tcp:// spelling passes protocol validation and the
    planner runs against it with the same answers as an in-process LRU."""
    backend = make_backend(cache_server.address)
    assert isinstance(backend, NetCache)
    assert backend.describe().startswith("netcache(tcp://")
    tr = _trace()
    a = FleetPlanner(predictor=cpu_predictor(), fleet=_DESTS,
                     cache=backend)
    oracle = FleetPlanner(predictor=cpu_predictor(), fleet=_DESTS)
    assert a.predict(tr) == oracle.predict(tr)      # bitwise via JSON
    # a second planner (= another host) hits the shared store
    b = FleetPlanner(predictor=cpu_predictor(), fleet=_DESTS,
                     cache=NetCache(cache_server.address))
    assert b.predict(tr) == oracle.predict(tr)
    assert b.stats.hits == len(_DESTS) and b.engine_passes == 0
    backend.close()
    b.cache.close()


def test_netcache_bad_address_rejected():
    with pytest.raises(ValueError, match="tcp://host:port"):
        NetCache("http://127.0.0.1:80")
    with pytest.raises(ValueError, match="tcp://host:port"):
        NetCache("tcp://nohost")


def test_netcache_dead_server_degrades_fast():
    """Every op against a dead server is a miss + ``degraded`` bump —
    never an exception — and the circuit breaker keeps repeat probes
    from re-paying the connect timeout."""
    import time

    server = CacheServer(port=0).start()
    nc = NetCache(server.address, timeout_s=0.5, retries=1,
                  backoff_s=0.01, reconnect_s=30.0)
    nc.put_many([(("k",), 1.0)])
    server.shutdown()

    assert nc.get_many([("k",), ("j",)]) == [None, None]
    assert nc.stats.degraded == 1 and nc.stats.misses == 2
    nc.put_many([(("k",), 2.0)])            # lost fill, no exception
    assert nc.stats.degraded == 2
    assert len(nc) == 0
    assert nc.server_stats() is None
    assert not nc.ping()
    t0 = time.perf_counter()
    assert nc.get(("k",)) is None           # breaker open: instant
    assert time.perf_counter() - t0 < 0.1
    nc.clear()                              # resets local counters only
    assert nc.stats.degraded == 0
    nc.close()


# ---------------------------------------------------------------------------
# degradation: planner, service, both front ends
# ---------------------------------------------------------------------------
def test_planner_degrades_on_backend_outage():
    tr = _trace()
    flaky = FlakyBackend()
    planner = FleetPlanner(predictor=cpu_predictor(), fleet=_DESTS,
                           cache=flaky)
    oracle = FleetPlanner(predictor=cpu_predictor(), fleet=_DESTS)
    flaky.fail = True
    assert planner.predict(tr) == oracle.predict(tr)
    # probe + store both degraded; the probe counted its keys as misses
    assert planner.stats.degraded == 2
    assert planner.stats.misses == len(_DESTS)
    assert planner.engine_passes == 1
    flaky.fail = False                      # backend recovers: fills work
    planner.predict(tr)
    assert planner.engine_passes == 2       # the failed fill was lost
    planner.predict(tr)
    assert planner.engine_passes == 2 and planner.stats.hits == len(_DESTS)


def test_service_degrades_on_backend_outage():
    tr = _trace()
    flaky = FlakyBackend()
    service = PredictionService(predictor=cpu_predictor(), fleet=_DESTS,
                                cache=flaky, coalesce_window_ms=0.0)
    oracle = PredictionService(predictor=cpu_predictor(), fleet=_DESTS,
                               coalesce_window_ms=0.0)
    flaky.fail = True
    payload = {"trace": tr.to_dict(), "batch_size": 4}
    assert (service.rank_request(payload)["ranking"]
            == oracle.rank_request(payload)["ranking"])
    stats = service.stats()
    assert stats["cache"]["degraded"] >= 2
    assert stats["cache"]["hits"] == 0


@pytest.mark.parametrize("front", ["threaded", "async"])
def test_front_ends_degrade_on_backend_outage(front):
    tr = _trace()
    flaky = FlakyBackend()
    flaky.fail = True
    service = PredictionService(predictor=cpu_predictor(), fleet=_DESTS,
                                cache=flaky, coalesce_window_ms=0.5)
    if front == "async":
        from repro_torch.serve.aserver import AsyncPredictionServer
        server = AsyncPredictionServer(service).start()
    else:
        server = PredictionServer(service).start()
    try:
        client = PredictionClient(server.url)
        oracle = FleetPlanner(predictor=cpu_predictor(), fleet=_DESTS)
        rows = client.rank(tr, batch_size=4)
        expected = oracle.rank(tr, batch_size=4)
        assert [r["device"] for r in rows] == [c.device for c in expected]
        assert [r["iter_ms"] for r in rows] == [c.iter_ms for c in expected]
        assert client.stats()["cache"]["degraded"] >= 2
    finally:
        server.shutdown()


def test_service_survives_netcache_server_death():
    """The tier-level outage: the cache SERVER dies under a live
    service.  Requests keep answering (computed as misses), /stats says
    degraded, and the netcache block reports unreachable (None)."""
    cache_server = CacheServer(port=0).start()
    nc = NetCache(cache_server.address, timeout_s=0.5, retries=0,
                  reconnect_s=30.0)
    service = PredictionService(predictor=cpu_predictor(), fleet=_DESTS,
                                cache=nc, coalesce_window_ms=0.0)
    oracle = PredictionService(predictor=cpu_predictor(), fleet=_DESTS,
                               coalesce_window_ms=0.0)
    t1, t2 = _trace(32), _trace(48)
    p1 = {"trace": t1.to_dict(), "batch_size": 4}
    p2 = {"trace": t2.to_dict(), "batch_size": 4}
    assert (service.rank_request(p1)["ranking"]
            == oracle.rank_request(p1)["ranking"])
    assert service.stats()["cache"]["netcache"]["entries"] == len(_DESTS)
    cache_server.shutdown()
    for p in (p1, p2):      # warm AND cold traces both still answer
        assert (service.rank_request(p)["ranking"]
                == oracle.rank_request(p)["ranking"])
    stats = service.stats()["cache"]
    assert stats["degraded"] >= 2
    assert stats["netcache"] is None
    nc.close()


# ---------------------------------------------------------------------------
# fingerprint router
# ---------------------------------------------------------------------------
def test_ring_is_deterministic_and_consistent():
    urls = [f"http://10.0.0.{i}:8100" for i in range(4)]
    a = FingerprintRouter(urls, replicas=64)
    b = FingerprintRouter(urls, replicas=64)
    fps = [f"fp-{i:04d}" for i in range(400)]
    owners = [a.owner(fp) for fp in fps]
    assert owners == [b.owner(fp) for fp in fps]    # instance-independent
    # every worker owns a non-trivial share of the space
    for url in urls:
        assert owners.count(url) > 0.1 * len(fps)
    # consistent hashing: removing one worker remaps ONLY its keys
    dead = urls[0]
    a.mark_down(dead)
    for fp, owner in zip(fps, owners):
        if owner != dead:
            assert a.owner(fp) == owner
        else:
            assert a.owner(fp) != dead
    a.mark_up(dead)
    assert [a.owner(fp) for fp in fps] == owners
    a.close()
    b.close()


def test_router_no_live_workers_is_503():
    r = FingerprintRouter(["http://10.0.0.1:1"])
    r.mark_down("http://10.0.0.1:1")
    with pytest.raises(RoutedError) as ei:
        r.owner("fp")
    assert ei.value.status == 503
    r.close()


@pytest.fixture()
def worker_pair():
    servers = [PredictionServer(build_service(coalesce_ms=0.5,
                                              device="cpu"),
                                port=0).start()
               for _ in range(2)]
    router = FingerprintRouter([s.url for s in servers], health_s=0.2)
    face = RouterServer(router, port=0).start()
    yield servers, router, face
    face.shutdown()
    for s in servers:
        s.shutdown()


def test_router_sticky_and_bitwise(worker_pair):
    servers, router, face = worker_pair
    client = PredictionClient(face.url)
    oracle = FleetPlanner(predictor=cpu_predictor())
    traces = [_trace(16 + 8 * i) for i in range(4)]
    before = {w: v["forwarded"] for w, v in router.stats()["workers"].items()}
    for _ in range(3):
        rows = client.rank(traces[0], batch_size=4)
    expected = oracle.rank(traces[0], batch_size=4)
    assert [r["iter_ms"] for r in rows] == [c.iter_ms for c in expected]
    deltas = sorted(v["forwarded"] - before[w]
                    for w, v in router.stats()["workers"].items())
    assert deltas == [0, 3]         # one owner took every repeat
    # sweeps fan out by owner and merge back in input order, bitwise
    times = client.sweep(traces)
    for got, exp in zip(times, oracle.sweep(traces)):
        assert got == exp
    assert client.healthz() == {"ok": True}
    assert client.stats()["router"]["live_workers"] == 2


def test_router_fails_over_on_worker_death(worker_pair):
    servers, router, face = worker_pair
    client = PredictionClient(face.url)
    oracle = FleetPlanner(predictor=cpu_predictor())
    traces = [_trace(16 + 8 * i) for i in range(6)]
    for t in traces:        # prime: every owner sees its traces
        client.rank(t, batch_size=4)
    servers[0].shutdown()   # hard stop, no deregistration
    for t in traces:        # every trace still answers, correctly
        rows = client.rank(t, batch_size=4)
        expected = oracle.rank(t, batch_size=4)
        assert [r["iter_ms"] for r in rows] == [c.iter_ms for c in expected]
    st = router.stats()
    assert st["live_workers"] == 1
    assert not st["workers"][servers[0].url]["alive"]


def test_router_passes_worker_errors_through(worker_pair):
    """An HTTP error STATUS is a worker answer (bad trace, shed) — the
    router must relay it verbatim, not fail over to another worker."""
    servers, router, face = worker_pair
    tr = _trace()
    payload = {"trace": tr.to_dict(), "batch_size": 4,
               "dests": ["not-a-device"]}
    req = urllib.request.Request(
        face.url + "/rank", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 400
    body = json.loads(ei.value.read())
    assert "error" in body
    st = router.stats()
    assert st["failovers"] == 0 and st["live_workers"] == 2
    assert st["routed_errors"] == 1


# ===========================================================================
# supervision, router probes, the breaker (tests/test_chaos.py)
# ===========================================================================
# -- worker supervision ------------------------------------------------------
def test_supervisor_restarts_killed_worker():
    from repro_torch.launch.serve import WorkerSupervisor

    sup = WorkerSupervisor(poll_s=0.05, backoff_s=0.1)
    cmd = [sys.executable, "-u", "-c",
           "print('serving on fake://worker'); "
           "import time; time.sleep(600)"]
    url = sup.spawn(list(cmd))
    assert url == "fake://worker"
    sup.start()
    try:
        sup.procs[0].kill()
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            s = sup.stats()
            if s["restarts"] >= 1 and s["per_worker"][0]["alive"]:
                break
            time.sleep(0.02)
        s = sup.stats()
        assert s["restarts"] >= 1
        assert s["per_worker"][0]["alive"]
    finally:
        sup.drain(timeout=5.0)
    assert sup.procs[0].poll() is not None  # drain really stopped it


def test_supervisor_backoff_on_crash_looping_worker():
    """A worker that dies on arrival must not be restarted in a hot
    loop: the per-worker backoff doubles up to its cap."""
    from repro_torch.launch.serve import WorkerSupervisor

    sup = WorkerSupervisor(poll_s=0.02, backoff_s=0.05, backoff_max_s=0.2)
    # prints readiness then exits immediately: every restart "fails"
    cmd = [sys.executable, "-u", "-c", "print('serving on fake://flappy')"]
    sup.spawn(list(cmd))
    sup.start()
    try:
        time.sleep(1.0)
        s = sup.stats()
        # a hot loop would log ~50 restarts in 1s at poll_s=0.02; the
        # doubling backoff (0.05 -> 0.1 -> 0.2 cap) keeps it single-digit
        assert 1 <= s["restarts"] <= 15
        assert sup._workers[0].backoff_s == pytest.approx(0.2)
    finally:
        sup.drain(timeout=5.0)


# -- router probe classification ---------------------------------------------
class _Unhealthy500(http.server.BaseHTTPRequestHandler):
    def do_GET(self):                       # alive process, refusing work
        body = b'{"ok": false}'
        self.send_response(500)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def test_router_probe_distinguishes_unhealthy_from_down():
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                            _Unhealthy500)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    unhealthy_url = f"http://127.0.0.1:{httpd.server_address[1]}"
    with socket.socket() as s:              # a port with nobody home
        s.bind(("127.0.0.1", 0))
        dead_port = s.getsockname()[1]
    down_url = f"http://127.0.0.1:{dead_port}"
    try:
        router = FingerprintRouter([unhealthy_url, down_url],
                                   health_s=0.5)
        assert router._probe(unhealthy_url) == "unhealthy"
        assert router._probe(down_url) == "down"
        alive = router.check_health()
        # both leave the ring — but stats tell the operator which is a
        # live-but-refusing process vs a dead host
        assert alive == {unhealthy_url: False, down_url: False}
        st = router.stats()["workers"]
        assert st[unhealthy_url]["state"] == "unhealthy"
        assert st[down_url]["state"] == "down"
        assert router.stats()["live_workers"] == 0
    finally:
        httpd.shutdown()
        httpd.server_close()


# -- netcache breaker half-open probe ----------------------------------------
def test_breaker_half_open_probe_closes_when_server_returns():
    from repro_torch.serve.netcache import CacheServer, NetCache

    server = CacheServer().start()
    port = server.port
    cache = NetCache(f"tcp://127.0.0.1:{port}", timeout_s=0.2,
                     retries=0, backoff_s=0.01, reconnect_s=0.2,
                     probe_s=0.1)
    try:
        cache.put_many([(("k",), 1.25)])
        assert cache.get(("k",)) == 1.25
        assert cache.breaker_state == "closed"
        assert cache.server_stats()["breaker_state"] == "closed"

        server.shutdown()
        assert cache.get_many([("k",)]) == [None]   # degrades to a miss
        assert cache.breaker_state == "open"
        t0 = time.perf_counter()
        assert cache.get_many([("k",)]) == [None]   # breaker short-circuit
        assert time.perf_counter() - t0 < 0.1
        time.sleep(0.3)                     # past max jittered window
        assert cache.breaker_state == "half_open"
        t0 = time.perf_counter()
        assert cache.get_many([("k",)]) == [None]   # probe fails fast
        assert time.perf_counter() - t0 < 0.15      # probe_s, not timeout
        assert cache.breaker_state == "open"        # re-opened w/ jitter

        revived = CacheServer(port=port).start()    # same address
        try:
            time.sleep(0.3)
            assert cache.breaker_state == "half_open"
            assert cache.get(("k",)) is None        # probe closes + serves
            assert cache.breaker_state == "closed"
            cache.put_many([(("k2",), 2.5)])
            assert cache.get(("k2",)) == 2.5
        finally:
            revived.shutdown()
    finally:
        cache.close()


# ===========================================================================
# across the packages
# ===========================================================================
@pytest.mark.parametrize("client_pkg", ["port", "reference"])
def test_netcache_crosses_the_packages(client_pkg):
    """One package's client on the other's server: the frames are the
    same, so values round-trip bitwise and each side reads the other's
    entries."""
    from repro.serve import netcache as ref_nc
    if client_pkg == "port":
        server, client, peer = ref_nc.CacheServer(port=0).start(), \
            NetCache, ref_nc.NetCache
    else:
        server, client, peer = CacheServer(port=0).start(), \
            ref_nc.NetCache, NetCache
    try:
        vals = [0.1, 1e-300, 123456.789e12, 2.0 / 3.0, float("inf")]
        keys = [(f"fp{i}", "T4", ("HabitatPredictor", False), "tok")
                for i in range(len(vals))]
        nc, other = client(server.address), peer(server.address)
        nc.put_many(list(zip(keys, vals)))
        assert nc.get_many(keys) == vals            # exact, not approx
        assert other.get_many(keys) == vals         # read by the peer
        other.put_many([(("peer",), 2.5)])
        assert nc.get(("peer",)) == 2.5
        assert len(nc) == len(vals) + 1
        assert nc.server_stats()["entries"] == len(vals) + 1
        nc.close()
        other.close()
    finally:
        server.shutdown()


def test_port_planner_fills_a_reference_cache_server():
    """The port's planner writes its cells through ``tcp://`` into the
    reference's server, and a second port planner (another host) is
    served from it with no engine pass."""
    from repro.serve import netcache as ref_nc
    server = ref_nc.CacheServer(port=0).start()
    try:
        tr = _trace()
        a = FleetPlanner(predictor=cpu_predictor(), fleet=_DESTS,
                         cache=server.address)
        want = a.predict(tr)
        b = FleetPlanner(predictor=cpu_predictor(), fleet=_DESTS,
                         cache=server.address)
        assert b.predict(tr) == want
        assert b.stats.hits == len(_DESTS) and b.engine_passes == 0
        assert b.cache.server_stats()["entries"] == len(_DESTS)
        a.cache.close()
        b.cache.close()
    finally:
        server.shutdown()


def test_routers_shard_a_fingerprint_alike():
    """The same ring (sha1, replicas) in both packages: a trace's
    fingerprint lands on the same worker url."""
    from repro.serve.router import FingerprintRouter as RefRouter
    urls = [f"http://10.0.0.{i}:8100" for i in range(3)]
    port, ref = FingerprintRouter(urls), RefRouter(urls)
    traces = [_ref_trace(16 + 4 * i) for i in range(12)]
    for t in traces:
        fp = t.fingerprint()
        assert TrackedTrace.from_dict(t.to_dict()).fingerprint() == fp
        assert port.owner(fp) == ref.owner(fp)
    port.close()
    ref.close()


def test_launcher_router_fleet_fails_over_and_exits_zero():
    """``launch.serve --serve --router --workers 2`` on the CPU: sticky
    routing, a SIGKILLed worker restarted on its port with every request
    still answered, and SIGTERM to the launcher exits 0."""
    import os
    import signal
    import subprocess
    from pathlib import Path
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    env["REPRO_SUPERVISOR_POLL_S"] = "0.1"
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--serve",
         "--router", "--workers", "2", "--port", "0", "--device", "cpu",
         "--coalesce-ms", "1"],
        env=env, stdout=subprocess.PIPE, text=True)
    lines = []
    try:
        line = proc.stdout.readline()
        while line and not line.startswith("serving on "):
            lines.append(line)
            line = proc.stdout.readline()
        assert line, "".join(lines)
        url = line.split("serving on ", 1)[1].strip()
        pump = threading.Thread(
            target=lambda: lines.extend(proc.stdout), daemon=True)
        pump.start()
        client = PredictionClient(url, timeout=60.0)
        traces = [_trace(16 + 8 * i) for i in range(4)]
        oracle = FleetPlanner(predictor=cpu_predictor())
        forwarded = lambda: [v["forwarded"] for v in
                             client.stats()["router"]["workers"].values()]
        for t in traces:            # the same trace, the same worker
            before = forwarded()
            for _ in range(2):
                rows = client.rank(t, batch_size=4)
                assert [r["iter_ms"] for r in rows] == \
                    [c.iter_ms for c in oracle.rank(t, 4)]
            assert sorted(a - b for a, b in zip(forwarded(), before)) \
                == [0, 2]
        # SIGKILL one worker: the router fails over, the supervisor
        # brings it back on the same port
        children = Path(f"/proc/{proc.pid}/task/{proc.pid}/children")
        workers = children.read_text().split()
        assert len(workers) == 2
        os.kill(int(workers[0]), signal.SIGKILL)
        for t in traces:
            rows = client.rank(t, batch_size=4)
            assert [r["iter_ms"] for r in rows] == \
                [c.iter_ms for c in oracle.rank(t, 4)]
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not any(
                "restart #1" in ln for ln in lines):
            time.sleep(0.1)
        assert any("restart #1" in ln for ln in lines), "".join(lines)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        pump.join(timeout=10)
        assert any("supervisor shutdown" in ln for ln in lines)
    finally:
        if proc.poll() is None:     # a failed gate: the launcher's drain
            proc.send_signal(signal.SIGTERM)    # ends its workers too
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
