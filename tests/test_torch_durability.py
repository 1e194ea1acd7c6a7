"""Port parity: durable warm state, quarantine, deadlines and drain.

The serving cases of the reference's ``tests/test_durability.py``
(crash-consistent snapshots, the wire-level response cache, poison-trace
quarantine, sqlite and netcache-frame integrity) and ``tests/
test_chaos.py`` (fault points, end-to-end deadlines, the finalize
protocol, graceful drain, a SIGTERMed worker process), run on the port
with ``device="cpu"`` predictors and traces the reference tracked and
carried over through ``to_dict``/``from_dict``.  Beyond the reference:
the engine caches' export/import hooks, whose entries in the port hold
tensors and locks that do not pickle as they stand."""

import json
import os
import pickle
import signal
import sqlite3
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import OperationTracker
from repro_torch.core import batched, integrity
from repro_torch.core.predictor import HabitatPredictor
from repro_torch.core.trace import TrackedTrace
from repro_torch.serve import faults
from repro_torch.serve.admission import (AdmissionController,
                                         DeadlineExceeded, deadline_scope,
                                         remaining_s)
from repro_torch.serve.cache import SqliteCache
from repro_torch.serve.fleet import FleetPlanner
from repro_torch.serve.http import PredictionClient, PredictionServer
from repro_torch.serve.service import (PendingQuery, PredictionService,
                                       QuarantinedTrace)
from repro_torch.serve.snapshot import SnapshotManager, empty_stats


def cpu_predictor(**kw) -> HabitatPredictor:
    return HabitatPredictor(device="cpu", **kw)


def _trace(n=12, label="durable") -> TrackedTrace:
    """A toy step the reference tracks, carried over to the port."""
    ref = OperationTracker("T4").track(
        lambda w, x: jnp.sum(jnp.tanh(x @ w)),
        jnp.zeros((n, 24)), jnp.zeros((8, n)), label=label)
    return TrackedTrace.from_dict(ref.to_dict())


def _service(**kw):
    kw.setdefault("predictor", cpu_predictor())
    kw.setdefault("coalesce_window_ms", 0.0)
    return PredictionService(**kw)


@pytest.fixture(autouse=True)
def _clean_counters():
    """Each test sees integrity counters from zero, and leaves the
    fault registry disarmed (restoring any suite-level arming)."""
    integrity.COUNTERS.reset()
    faults.disarm()
    yield
    faults.disarm()
    integrity.COUNTERS.reset()
    env_spec = os.environ.get("REPRO_FAULTS", "").strip()
    if env_spec:
        faults.arm(env_spec)


# ---------------------------------------------------------------------------
# snapshots: save/restore round-trip
# ---------------------------------------------------------------------------
def test_snapshot_roundtrip_restores_warm_state(tmp_path):
    path = tmp_path / "snap.bin"
    svc = _service()
    trace = _trace()
    before = svc.rank(trace, 32)
    mgr = SnapshotManager(path, svc, interval_s=0)
    assert mgr.save() is True
    assert path.exists() and mgr.saves == 1

    svc2 = _service()
    assert len(svc2.planner.cache.export_entries()) == 0
    mgr2 = SnapshotManager(path, svc2, interval_s=0)
    assert mgr2.restore() is True
    assert mgr2.restored and mgr2.restored_entries > 0
    assert len(svc2.planner.cache.export_entries()) > 0
    after = svc2.rank(trace, 32)
    assert [c.device for c in after] == [c.device for c in before]
    for a, b in zip(after, before):     # bitwise, not approx
        assert a.throughput == b.throughput


def test_snapshot_missing_file_is_cold_start_not_corruption(tmp_path):
    mgr = SnapshotManager(tmp_path / "never-written.bin", _service(),
                          interval_s=0)
    assert mgr.restore() is False
    assert integrity.COUNTERS.stats()["corrupt_snapshot"] == 0


@pytest.mark.parametrize("damage", ["garbage", "truncate", "flip"])
def test_snapshot_corruption_degrades_to_cold(tmp_path, damage, capsys):
    path = tmp_path / "snap.bin"
    svc = _service()
    svc.rank(_trace(), 32)
    SnapshotManager(path, svc, interval_s=0).save()
    raw = path.read_bytes()
    if damage == "garbage":
        path.write_bytes(b"not a snapshot at all")
    elif damage == "truncate":
        path.write_bytes(raw[: len(raw) // 2])
    else:
        mid = len(raw) // 2
        path.write_bytes(raw[:mid] + bytes([raw[mid] ^ 0xFF]) + raw[mid + 1:])

    mgr = SnapshotManager(path, _service(), interval_s=0)
    assert mgr.restore() is False       # cold, not raised
    assert not mgr.restored
    assert integrity.COUNTERS.stats()["corrupt_snapshot"] == 1
    assert "starting cold" in capsys.readouterr().err


def test_snapshot_version_skew_degrades_to_cold(tmp_path):
    path = tmp_path / "snap.bin"
    path.write_bytes(integrity.seal(pickle.dumps({"version": 999})))
    mgr = SnapshotManager(path, _service(), interval_s=0)
    assert mgr.restore() is False
    assert integrity.COUNTERS.stats()["corrupt_snapshot"] == 1


def test_snapshot_write_fault_keeps_previous_snapshot(tmp_path):
    path = tmp_path / "snap.bin"
    svc = _service()
    svc.rank(_trace(), 32)
    mgr = SnapshotManager(path, svc, interval_s=0)
    assert mgr.save() is True
    good = path.read_bytes()

    faults.arm("snapshot.write:error,p=1")
    assert mgr.save() is False
    assert mgr.save_errors == 1
    assert path.read_bytes() == good    # previous snapshot untouched
    assert not list(tmp_path.glob("*.tmp.*"))   # no temp litter
    faults.disarm()
    assert mgr.save() is True           # and saving recovers


def test_snapshot_load_fault_degrades_to_cold(tmp_path):
    path = tmp_path / "snap.bin"
    svc = _service()
    svc.rank(_trace(), 32)
    SnapshotManager(path, svc, interval_s=0).save()

    faults.arm("snapshot.load:error,p=1")
    mgr = SnapshotManager(path, _service(), interval_s=0)
    assert mgr.restore() is False
    assert integrity.COUNTERS.stats()["corrupt_snapshot"] == 1
    faults.disarm()
    assert mgr.restore() is True        # same file is fine without the fault


def test_snapshot_stats_shape_matches_empty_stats(tmp_path):
    mgr = SnapshotManager(tmp_path / "s.bin", _service(), interval_s=0)
    assert set(mgr.stats()) == set(empty_stats())


# ---------------------------------------------------------------------------
# wire-level response cache
# ---------------------------------------------------------------------------
def test_response_cache_off_by_default():
    svc = _service()
    assert svc.response_cache_max == 0
    assert svc.response_key("rank", '{"x": 1}') is None
    assert svc.import_response_cache([("k", "{}")]) == 0


def test_response_cache_replays_bitwise(monkeypatch):
    monkeypatch.setenv("REPRO_RESPONSE_CACHE", "32")
    svc = _service()
    body = json.dumps({"trace": _trace().to_dict(), "batch_size": 32})
    first = svc.rank_request(body)
    second = svc.rank_request(body)
    assert json.dumps(second) == json.dumps(first)      # byte-identical
    stats = svc.response_cache_stats()
    assert stats["hits"] == 1 and stats["entries"] == 1
    # hits decode fresh copies: mutating one answer cannot corrupt another
    second["ranking"].clear()
    assert svc.rank_request(body)["ranking"] == first["ranking"]


def test_response_cache_dict_payloads_bypass(monkeypatch):
    monkeypatch.setenv("REPRO_RESPONSE_CACHE", "32")
    svc = _service()
    assert svc.response_key("rank", {"trace": "..."}) is None
    svc.rank_request({"trace": _trace().to_dict(), "batch_size": 32})
    assert svc.response_cache_stats()["entries"] == 0


def test_response_cache_lru_eviction(monkeypatch):
    monkeypatch.setenv("REPRO_RESPONSE_CACHE", "2")
    svc = _service()
    for i in range(3):
        svc.response_store(svc.response_key("rank", f"body-{i}"), {"i": i})
    assert svc.response_cache_stats()["entries"] == 2
    assert svc.response_lookup(svc.response_key("rank", "body-0")) is None
    assert svc.response_lookup(svc.response_key("rank", "body-2")) == {"i": 2}


def test_response_cache_import_drops_malformed(monkeypatch):
    monkeypatch.setenv("REPRO_RESPONSE_CACHE", "32")
    svc = _service()
    n = svc.import_response_cache([
        ("good", '{"a": 1}'),
        ("bad-json", "{nope"),
        (42, '{"a": 2}'),
        ("wrong-shape",),
    ])
    assert n == 1
    assert svc.response_lookup("good") == {"a": 1}
    assert svc.response_cache_stats()["restored_entries"] == 1


def test_response_cache_rides_snapshots(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_RESPONSE_CACHE", "32")
    path = tmp_path / "snap.bin"
    svc = _service()
    body = json.dumps({"trace": _trace().to_dict(), "batch_size": 32})
    first = svc.rank_request(body)
    SnapshotManager(path, svc, interval_s=0).save()

    svc2 = _service()
    SnapshotManager(path, svc2, interval_s=0).restore()
    assert svc2.response_cache_stats()["restored_entries"] == 1
    assert json.dumps(svc2.rank_request(body)) == json.dumps(first)
    assert svc2.response_cache_stats()["hits"] == 1     # no engine pass


# ---------------------------------------------------------------------------
# poison-trace quarantine
# ---------------------------------------------------------------------------
def test_quarantine_after_threshold_crashes():
    svc = _service()
    trace = _trace(label="poison")
    boom = RuntimeError("engine exploded")
    for _ in range(svc.quarantine_threshold):
        svc._record_trace_failure(trace, boom)
    with pytest.raises(QuarantinedTrace) as exc:
        svc.check_quarantine([trace])
    assert exc.value.fingerprint == trace.fingerprint()
    assert "engine exploded" in exc.value.reason
    assert exc.value.retry_after_s > 0
    # wire entry points refuse it too (transports answer 422)
    with pytest.raises(QuarantinedTrace):
        svc.rank_request({"trace": trace.to_dict(), "batch_size": 32})
    stats = svc.quarantine_stats()
    assert stats["active"] == 1 and stats["rejected"] == 2


def test_quarantine_below_threshold_admits():
    svc = _service()
    trace = _trace(label="flaky")
    for _ in range(svc.quarantine_threshold - 1):
        svc._record_trace_failure(trace, RuntimeError("x"))
    svc.check_quarantine([trace])       # no raise
    assert svc.quarantine_stats()["active"] == 0


def test_quarantine_ttl_readmits_with_one_strike_left():
    svc = _service()
    svc.quarantine_ttl_s = 0.05
    trace = _trace(label="ttl")
    for _ in range(svc.quarantine_threshold):
        svc._record_trace_failure(trace, RuntimeError("x"))
    with pytest.raises(QuarantinedTrace):
        svc.check_quarantine([trace])
    time.sleep(0.06)
    svc.check_quarantine([trace])       # TTL lapsed: admitted again
    assert svc.quarantine_stats()["readmitted"] == 1
    # ... but with ONE strike left: the next crash re-quarantines
    svc._record_trace_failure(trace, RuntimeError("still poison"))
    with pytest.raises(QuarantinedTrace):
        svc.check_quarantine([trace])


def test_quarantine_success_clears_streak_and_lifts():
    svc = _service()
    trace = _trace(label="recovers")
    for _ in range(svc.quarantine_threshold):
        svc._record_trace_failure(trace, RuntimeError("x"))
    svc._record_trace_success([trace])
    svc.check_quarantine([trace])       # lifted early
    stats = svc.quarantine_stats()
    assert stats["active"] == 0 and stats["tracked_failures"] == 0
    assert stats["readmitted"] == 1


def test_quarantine_threshold_zero_disables(monkeypatch):
    monkeypatch.setenv("REPRO_QUARANTINE_THRESHOLD", "0")
    svc = _service()
    trace = _trace()
    for _ in range(10):
        svc._record_trace_failure(trace, RuntimeError("x"))
    svc.check_quarantine([trace])
    assert svc.quarantine_stats()["enabled"] is False


# ---------------------------------------------------------------------------
# sqlite backend integrity
# ---------------------------------------------------------------------------
def test_sqlite_corrupt_db_file_recreated_fresh(tmp_path, capsys):
    path = tmp_path / "cache.db"
    path.write_bytes(b"this is not a sqlite database, honest")
    cache = SqliteCache(path)
    assert cache.recreated == 1
    assert integrity.COUNTERS.stats()["corrupt_sqlite"] >= 1
    cache.put_many([(("T4", "fp", 32), 1.25)])  # and it works afterwards
    assert cache.get(("T4", "fp", 32)) == 1.25


def test_sqlite_tampered_row_is_a_miss_not_a_wrong_answer(tmp_path):
    path = tmp_path / "cache.db"
    cache = SqliteCache(path)
    cache.put_many([(("T4", "fp", 32), 1.25)])
    with sqlite3.connect(path) as db:   # flip the stored value only:
        db.execute("UPDATE cache SET ms = ms + 1.0")
    assert cache.get(("T4", "fp", 32)) is None      # digest no longer matches
    assert integrity.COUNTERS.stats()["corrupt_sqlite"] == 1


def test_sqlite_cache_corrupt_fault_forces_misses(tmp_path):
    cache = SqliteCache(tmp_path / "cache.db")
    cache.put_many([(("T4", "fp", 32), 1.25)])
    faults.arm("cache.corrupt:error,p=1")
    assert cache.get(("T4", "fp", 32)) is None
    assert integrity.COUNTERS.stats()["corrupt_sqlite"] == 1
    faults.disarm()
    assert cache.get(("T4", "fp", 32)) == 1.25      # row itself was fine


# ---------------------------------------------------------------------------
# netcache frame + MLP artifact integrity
# ---------------------------------------------------------------------------
def test_netcache_frame_checksum_fails_closed():
    from repro_torch.serve import netcache

    frame = netcache._pack({"op": "ping"})
    n = netcache._HEAD.size
    digest = frame[n:n + integrity.DIGEST_BYTES]
    body = frame[n + integrity.DIGEST_BYTES:]
    assert netcache._verify_body(body, digest) == body
    tampered = bytes([body[0] ^ 0x01]) + body[1:]
    with pytest.raises(integrity.IntegrityError):
        netcache._verify_body(tampered, digest)
    assert integrity.COUNTERS.stats()["corrupt_netcache"] == 1


# ===========================================================================
# deadlines, finalize, drain (tests/test_chaos.py)
# ===========================================================================
# -- deadlines ---------------------------------------------------------------
def test_resolve_deadline_precedence(monkeypatch):
    svc = PredictionService(predictor=cpu_predictor(),
                            coalesce_window_ms=0.0)
    assert svc.resolve_deadline({}, None) is None       # unbounded default
    now = time.monotonic()
    d = svc.resolve_deadline({"deadline_ms": 500}, 100.0)
    assert d == pytest.approx(now + 0.5, abs=0.05)      # payload wins
    d = svc.resolve_deadline({}, 100.0)                 # then the header
    assert d == pytest.approx(now + 0.1, abs=0.05)
    assert svc.resolve_deadline({"deadline_ms": 0}, None) is None
    monkeypatch.setenv("REPRO_DEADLINE_MS", "250")
    svc2 = PredictionService(predictor=cpu_predictor(),
                             coalesce_window_ms=0.0)
    d = svc2.resolve_deadline({}, None)                 # env default last
    assert d == pytest.approx(time.monotonic() + 0.25, abs=0.05)


def test_admission_sheds_504_when_cost_exceeds_budget():
    """A request whose priced cost cannot fit its remaining budget is
    rejected immediately — no queueing, no engine work."""
    svc = PredictionService(predictor=cpu_predictor(),
                            coalesce_window_ms=0.0)
    tr = _trace()
    passes0 = svc.stats()["engine_passes"]
    with pytest.raises(DeadlineExceeded) as ei:
        svc.rank_request({"trace": tr.to_dict(), "batch_size": 8},
                         deadline_ms=1e-6)
    assert ei.value.status == 504
    s = svc.admission.stats()
    assert s["shed_504"] == 1
    assert s["inflight_requests"] == 0      # nothing leaked
    assert svc.stats()["engine_passes"] == passes0


def test_deadline_lapse_cancels_query_but_batch_survives():
    """One member's lapsed deadline raises 504 for THAT member while the
    shared pass completes bitwise-correct for everyone else."""
    tr_a, tr_b = _trace(10, "dl-a"), _trace(14, "dl-b")
    oracle = FleetPlanner(predictor=cpu_predictor()).rank(tr_b, 8)
    svc = PredictionService(predictor=cpu_predictor(),
                            coalesce_window_ms=30.0, flush_at=2,
                            adaptive_window=False)
    svc.rank(tr_a, 8)                       # warm the engine
    faults.arm("engine.pass:delay=250ms,p=1.0")
    results, errors = {}, {}

    def bounded():
        try:
            results["a"] = svc.rank(
                tr_a, 8, deadline=time.monotonic() + 0.05)
        except BaseException as e:
            errors["a"] = e

    def unbounded():
        results["b"] = svc.rank(tr_b, 8)

    threads = [threading.Thread(target=bounded),
               threading.Thread(target=unbounded)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    faults.disarm()
    assert isinstance(errors.get("a"), DeadlineExceeded)
    assert errors["a"].lane == "interactive"
    assert [c.device for c in results["b"]] == \
        [c.device for c in oracle]
    assert [c.iter_ms for c in results["b"]] == \
        [c.iter_ms for c in oracle]
    assert time.monotonic() - t0 < 2.0


def test_coalescing_window_capped_by_tightest_deadline():
    """A 500 ms window must not hold a 60 ms-deadline query hostage:
    the batch fires at the deadline, not the window."""
    svc = PredictionService(predictor=cpu_predictor(),
                            coalesce_window_ms=500.0, flush_at=64,
                            adaptive_window=False)
    tr = _trace(10, "cap")
    svc.rank(tr, 8)                         # warm (first pass compiles)
    t0 = time.monotonic()
    rows = svc.rank(tr, 8, deadline=time.monotonic() + 0.06)
    dt = time.monotonic() - t0
    assert rows                             # answered, not rejected
    assert dt < 0.4, f"window not capped by deadline ({dt:.3f}s)"


def test_deadline_scope_nests_and_reports_remaining():
    assert remaining_s() is None
    outer = time.monotonic() + 10.0
    with deadline_scope(outer):
        assert 9.0 < remaining_s() < 10.0
        with deadline_scope(time.monotonic() + 1.0):    # innermost wins
            assert remaining_s() < 1.01
        with deadline_scope(None):          # None never widens
            assert 9.0 < remaining_s() < 10.0
        assert 9.0 < remaining_s() < 10.0
    assert remaining_s() is None


# -- finalize protocol -------------------------------------------------------
def test_finish_cancel_exactly_once_under_race():
    """N racing cancels + one finish: exactly one finalizer wins and
    ``on_done`` fires exactly once, every repetition."""
    for rep in range(50):
        fired = []
        q = PendingQuery(kind="rank", traces=[], dests=None,
                         on_done=lambda _q: fired.append(1))
        q.result = "answer"
        barrier = threading.Barrier(5)
        wins = []

        def do_cancel():
            barrier.wait()
            if q.cancel(DeadlineExceeded("lapsed")):
                wins.append("cancel")

        def do_finish():
            barrier.wait()
            q.finish()

        threads = [threading.Thread(target=do_cancel) for _ in range(4)]
        threads.append(threading.Thread(target=do_finish))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(fired) == 1, f"on_done fired {len(fired)}x (rep {rep})"
        assert len(wins) <= 1
        if wins:                            # a cancel won: error delivered
            with pytest.raises(DeadlineExceeded):
                q.get(timeout=0)
        else:                               # finish won: result delivered
            assert q.get(timeout=0) == "answer"


def test_wire_cancel_releases_ticket_exactly_once():
    """A 504-cancelled wire request must return its admission budget —
    completely, and only once — even while the batch is still running."""
    svc = PredictionService(
        predictor=cpu_predictor(), coalesce_window_ms=0.0,
        admission=AdmissionController(max_queue=64, max_inflight_s=50.0))
    tr = _trace()
    svc.rank(tr, 8)                         # warm
    faults.arm("engine.pass:delay=300ms,p=1.0")
    try:
        with pytest.raises(DeadlineExceeded):
            svc.rank_request({"trace": tr.to_dict(), "batch_size": 8},
                             deadline_ms=40.0)
    finally:
        faults.disarm()
    deadline = time.monotonic() + 2.0       # wait out the slow batch
    while svc.stats()["coalescing"]["executing"] and \
            time.monotonic() < deadline:
        time.sleep(0.01)
    s = svc.admission.stats()
    assert s["inflight_requests"] == 0
    assert s["inflight_cost_s"] == 0.0
    assert s["shed_504"] == 1


# -- graceful drain ----------------------------------------------------------
def test_drain_flushes_inflight_and_sheds_new():
    svc = PredictionService(predictor=cpu_predictor(),
                            coalesce_window_ms=0.0)
    server = PredictionServer(svc).start()
    client = PredictionClient(server.url)
    tr = _trace(10, "drain")
    oracle = client.rank(tr, batch_size=8)  # warm + oracle
    faults.arm("engine.pass:delay=300ms,p=1.0")
    inflight_result = {}

    def slow_request():
        inflight_result["rows"] = client.rank(tr, batch_size=8)

    t = threading.Thread(target=slow_request)
    try:
        t.start()
        deadline = time.monotonic() + 2.0   # request reached the engine
        while not svc.stats()["coalescing"]["executing"] and \
                time.monotonic() < deadline:
            time.sleep(0.005)
        drained = {}
        d = threading.Thread(
            target=lambda: drained.update(ok=server.drain(timeout=10.0)))
        d.start()
        deadline = time.monotonic() + 2.0
        while not svc.draining and time.monotonic() < deadline:
            time.sleep(0.005)
        assert svc.draining
        # new work sheds 503 + Retry-After while draining...
        with pytest.raises(urllib.error.HTTPError) as ei:
            client.rank(tr, batch_size=8)
        assert ei.value.code == 503
        assert json.loads(ei.value.read())["error"] == "draining"
        assert "Retry-After" in ei.value.headers
        ei.value.close()
        # ...and /healthz flips so routers mark the worker down...
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(server.url + "/healthz", timeout=5)
        assert ei.value.code == 503
        ei.value.close()
        # ...but /stats stays live for the operator
        assert client.stats()["draining"] is True
        t.join(timeout=10)
        d.join(timeout=10)
        assert drained["ok"] is True        # quiesced inside the grace
        assert inflight_result["rows"] == oracle    # in-flight flushed
    finally:
        faults.disarm()
        server.shutdown()


def test_sigterm_drain_exits_zero_with_accounting():
    """The acceptance path: SIGTERM a live worker process — it finishes,
    prints the drain accounting line, and exits 0."""
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parents[1] / "src")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serve.http", "--port", "0",
         "--coalesce-ms", "0.5", "--device", "cpu"],
        env=env, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        while line and not line.startswith("serving on "):
            line = proc.stdout.readline()
        assert line, "worker exited before binding"
        url = line.split("serving on ", 1)[1].strip()
        rows = PredictionClient(url, timeout=60.0).rank(
            _trace(10, "sigterm"), batch_size=8)
        assert rows
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
        assert proc.returncode == 0
        assert "drain on shutdown:" in out
        assert "quiesced=True" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()


# -- stats surface -----------------------------------------------------------
def test_service_stats_surface_draining_and_faults():
    svc = PredictionService(predictor=cpu_predictor(),
                            coalesce_window_ms=0.0)
    st = svc.stats()
    assert st["draining"] is False
    assert st["faults"] == {"armed": False, "points": {}}
    assert st["admission"]["shed_504"] == 0
    faults.arm("engine.pass:delay=1ms,p=0.5")
    assert svc.stats()["faults"]["armed"] is True
    assert "engine.pass" in svc.stats()["faults"]["points"]


# ===========================================================================
# the engine caches' export/import hooks (the port's tensors and locks)
# ===========================================================================
DESTS = ["T4", "V100", "tpu-v5e", "P100"]


def _warm(traces):
    """Run one sweep so both process-wide engine caches hold entries."""
    batched.STACK_CACHE.clear()
    batched.WAVE_FACTOR_CACHE.clear()
    return cpu_predictor().predict_sweep(traces, DESTS).total_ms


def test_stack_cache_export_pickles_and_restores():
    """A stack's device views and lock do not pickle; the export ships
    its host fields and the restored stack answers bit for bit."""
    traces = [_trace(10 + 4 * i, f"stack-{i}") for i in range(3)]
    want = _warm(traces)
    entries = pickle.loads(pickle.dumps(batched.STACK_CACHE.export_state()))
    assert entries and all(isinstance(f, dict) for _, f in entries)
    assert all("_views" not in f and "_views_lock" not in f
               for _, f in entries)
    fresh = batched._StackCache()
    assert fresh.import_state(entries) == len(entries)
    assert fresh.stats()["builds"] == 0       # warmth, not engine work
    key = tuple((t.fingerprint(), t.label) for t in traces)
    restored = fresh.stack(traces)
    assert fresh.stats()["hits"] == 1
    assert restored.fingerprints == [k[0] for k in key]
    got = cpu_predictor().predict_sweep(restored, DESTS).total_ms
    np.testing.assert_array_equal(got, want)


def test_factor_cache_exports_host_arrays_and_restores_on_its_device():
    traces = [_trace(10 + 4 * i, f"factor-{i}") for i in range(2)]
    _warm(traces)
    entries = batched.WAVE_FACTOR_CACHE.export_state()
    assert entries
    for key, origins, factor, overheads in entries:
        assert isinstance(factor, np.ndarray)
        assert key[4] == "cpu"
    entries = pickle.loads(pickle.dumps(entries))
    fresh = batched._WaveFactorCache()
    assert fresh.import_state(entries) == len(entries)
    from repro_torch.core import devices
    for key, origins, factor, _ in entries:
        hit = fresh.get(key, devices.arrays_for(key[1]), origins)
        assert hit is not None
        assert hit[0].device.type == "cpu"
        np.testing.assert_array_equal(hit[0].numpy(), factor)


def test_factor_entry_keyed_to_cuda_is_skipped_without_a_gpu():
    """An entry made on the card and restored in a process without a GPU
    is skipped and not counted; it never raises."""
    _warm([_trace(12, "cuda-key")])
    entries = [((*key[:4], "cuda:0"), *rest)
               for key, *rest in batched.WAVE_FACTOR_CACHE.export_state()]
    fresh = batched._WaveFactorCache()
    n = fresh.import_state(entries)
    assert n == (len(entries) if torch.cuda.is_available() else 0)
    assert fresh.stats()["entries"] == n


def test_port_snapshot_restores_warm_with_no_engine_pass(tmp_path):
    """A snapshot the port wrote restores into a fresh service (and
    fresh engine caches): the repeat request runs 0 engine passes and
    answers bitwise."""
    path = tmp_path / "warm.snap"
    traces = [_trace(10 + 2 * i, f"warm-{i}") for i in range(3)]
    svc = _service()
    first = [svc.rank(t, 32) for t in traces]
    assert SnapshotManager(path, svc, interval_s=0).save()
    batched.STACK_CACHE.clear()
    batched.WAVE_FACTOR_CACHE.clear()
    svc2 = _service()
    mgr = SnapshotManager(path, svc2, interval_s=0)
    assert mgr.restore() and mgr.restored_entries > 0
    assert batched.STACK_CACHE.stats()["entries"] > 0
    assert batched.WAVE_FACTOR_CACHE.stats()["entries"] > 0
    assert [svc2.rank(t, 32) for t in traces] == first
    assert svc2.stats()["engine_passes"] == 0
