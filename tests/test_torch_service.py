"""Port parity: the coalescing prediction service, its union/split
planner, admission control and the what-if optimizer.

The cases of the reference's ``tests/test_service.py``,
``test_split_planner.py``, ``test_admission.py`` and
``test_optimizer.py``, run on the port's ``repro_torch.serve`` with a
``device="cpu"`` predictor (the scorer kernels' plain versions).  The
traces are tracked by the reference (JAX on the CPU) and carried over
through ``to_dict``/``from_dict``.  Within the port a coalesced answer is
bitwise equal to the direct planner call on the analytical paths, as the
reference pins; across the packages the answers agree to rel 1e-12 (the
engines sum in different orders) and, with MLPs carried across, to rel
1e-5.  The last cases hold the port against the reference's documents
(``docs/serving.md``'s ``/stats`` fields, ``docs/knobs.md``'s kill
switches) and the kernel wrappers' launch counts against a race."""

import json
import re
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import OperationTracker
from repro_torch.core import devices
from repro_torch.core.frontier import dominates
from repro_torch.core.predictor import HabitatPredictor
from repro_torch.core.trace import TrackedTrace
from repro_torch.serve.admission import (AdmissionController, AdmissionError,
                                         LANES)
from repro_torch.serve.fleet import FleetPlanner
from repro_torch.serve.http import PredictionClient, PredictionServer
from repro_torch.serve.optimizer import (WhatIfOptimizer, encode_optimize,
                                         format_frontier)
from repro_torch.serve.service import PredictionService, adaptive_window_ms

ROOT = Path(__file__).resolve().parents[1]
DEVS = sorted(devices.all_devices())
FLEET_A = DEVS[:len(DEVS) // 2]
FLEET_B = DEVS[len(DEVS) // 2:]


def carry(ref_trace) -> TrackedTrace:
    """A reference trace as the port's, through the wire document."""
    return TrackedTrace.from_dict(ref_trace.to_dict())


def cpu_predictor(**kw) -> HabitatPredictor:
    return HabitatPredictor(device="cpu", **kw)


def _toy_step(w, x):
    return jnp.sum(jnp.tanh(x @ w))


def _ref_toy(n: int = 16, m: int = 32, label=None):
    return OperationTracker("T4").track(
        _toy_step, jnp.zeros((m, n)), jnp.zeros((8, m)),
        label=label or f"toy-{n}x{m}")


def _trace(n: int = 16, m: int = 32, label=None) -> TrackedTrace:
    return carry(_ref_toy(n, m, label))


@pytest.fixture(scope="module")
def traces():
    return [_trace(16 + 8 * i) for i in range(8)]


# ---------------------------------------------------------------------------
# the service (tests/test_service.py)
# ---------------------------------------------------------------------------
def _burst(service, calls):
    """Fire ``calls`` (thunks) concurrently, barrier-started; return their
    results in call order."""
    barrier = threading.Barrier(len(calls))
    results = [None] * len(calls)
    errors = []

    def run(i, fn):
        barrier.wait()
        try:
            results[i] = fn()
        except BaseException as e:   # surface in the test, not the thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, fn))
               for i, fn in enumerate(calls)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    return results


# ---------------------------------------------------------------------------
# answer parity: coalesced == direct planner, bitwise
# ---------------------------------------------------------------------------
def test_rank_matches_planner_bitwise(traces):
    service = PredictionService(predictor=cpu_predictor(),
                                coalesce_window_ms=0.0)
    direct = FleetPlanner(predictor=cpu_predictor())
    for tr in traces[:3]:
        assert service.rank(tr, batch_size=32) == direct.rank(tr, 32)
        assert (service.rank(tr, batch_size=32, by="cost")
                == direct.rank(tr, 32, by="cost"))


def test_sweep_matches_planner(traces):
    service = PredictionService(predictor=cpu_predictor(),
                                coalesce_window_ms=0.0)
    direct = FleetPlanner(predictor=cpu_predictor())
    assert service.sweep(traces) == direct.sweep(traces)


def test_rank_validates_objective(traces):
    service = PredictionService(predictor=cpu_predictor())
    with pytest.raises(ValueError, match="ranking objective"):
        service.rank(traces[0], batch_size=32, by="latency")
    # the bad request never reached the queue
    assert service.stats()["requests"]["rank"] == 0


# ---------------------------------------------------------------------------
# coalescing
# ---------------------------------------------------------------------------
def test_concurrent_identical_ranks_one_miss_per_key(traces):
    """Barrier-started threads asking about the SAME trace: coalesced into
    one batch, deduped to one engine row, exactly one miss per unique
    (trace, device, config, fleet) key — and every thread gets the same
    bitwise answer."""
    n_threads = 8
    service = PredictionService(predictor=cpu_predictor(),
                                coalesce_window_ms=200.0,
                                flush_at=n_threads)
    tr = traces[0]
    results = _burst(service, [lambda: service.rank(tr, batch_size=32)
                               for _ in range(n_threads)])
    assert all(r == results[0] for r in results)
    stats = service.stats()
    assert stats["cache"]["misses"] == len(DEVS)     # one per unique key
    assert stats["cache"]["hits"] == 0
    assert stats["engine_passes"] == 1
    assert stats["requests"]["rank"] == n_threads
    assert stats["coalescing"]["batches"] == 1
    assert stats["coalescing"]["max_batch"] == n_threads
    assert stats["coalescing"]["coalesced_requests"] == n_threads


def test_concurrent_distinct_ranks_one_engine_pass(traces):
    """Distinct traces coalesce into ONE ragged pass (not one per trace)."""
    service = PredictionService(predictor=cpu_predictor(),
                                coalesce_window_ms=200.0,
                                flush_at=len(traces))
    results = _burst(
        service, [lambda tr=tr: service.rank(tr, batch_size=32)
                  for tr in traces])
    stats = service.stats()
    assert stats["engine_passes"] == 1
    assert stats["cache"]["misses"] == len(traces) * len(DEVS)
    # and each answer matches the direct planner
    direct = FleetPlanner(predictor=cpu_predictor())
    for tr, res in zip(traces, results):
        assert res == direct.rank(tr, 32)


def test_mixed_rank_and_sweep_coalesce(traces):
    """rank + sweep requests in one window share one engine pass; the
    sweep's duplicate of a ranked trace is deduped, not re-priced."""
    service = PredictionService(predictor=cpu_predictor(),
                                coalesce_window_ms=200.0, flush_at=2)
    calls = [lambda: service.rank(traces[0], batch_size=16),
             lambda: service.sweep([traces[0], traces[1]])]
    rank_res, sweep_res = _burst(service, calls)
    stats = service.stats()
    assert stats["engine_passes"] == 1
    assert stats["cache"]["misses"] == 2 * len(DEVS)   # 2 unique traces
    assert [c.device for c in rank_res]                # ranked rows exist
    assert sweep_res[0] == dict(
        zip(DEVS, [sweep_res[0][d] for d in DEVS]))    # all devices priced


def test_requests_with_different_dests_share_one_union_pass(traces):
    """Disjoint destination fleets stack into ONE union grid; each answer
    only contains its own devices."""
    service = PredictionService(predictor=cpu_predictor(),
                                coalesce_window_ms=200.0, flush_at=2)
    calls = [
        lambda: service.rank(traces[0], batch_size=8,
                             dests=["T4", "V100"]),
        lambda: service.rank(traces[1], batch_size=8,
                             dests=["tpu-v5e"]),
    ]
    res_a, res_b = _burst(service, calls)
    assert {c.device for c in res_a} == {"T4", "V100"}
    assert {c.device for c in res_b} == {"tpu-v5e"}
    stats = service.stats()
    assert stats["coalescing"]["batches"] == 1      # one batch ...
    assert stats["engine_passes"] == 1              # ... ONE union grid
    assert stats["coalescing"]["union_batches"] == 1
    # both fleets are strict subsets of the 3-device union: every served
    # column was sliced out of the shared grid
    assert stats["coalescing"]["sliced_columns"] == 3


def test_grouped_mode_still_splits_by_spelling(traces):
    """The retained grouped batcher (union_grid=False): different fleet
    spellings cannot share a grid — one engine pass per spelling."""
    service = PredictionService(predictor=cpu_predictor(),
                                coalesce_window_ms=200.0, flush_at=2,
                                union_grid=False)
    calls = [
        lambda: service.rank(traces[0], batch_size=8,
                             dests=["T4", "V100"]),
        lambda: service.rank(traces[1], batch_size=8,
                             dests=["tpu-v5e"]),
    ]
    res_a, res_b = _burst(service, calls)
    assert {c.device for c in res_a} == {"T4", "V100"}
    assert {c.device for c in res_b} == {"tpu-v5e"}
    stats = service.stats()
    assert stats["coalescing"]["batches"] == 1      # one batch ...
    assert stats["engine_passes"] == 2              # ... two grids
    assert stats["coalescing"]["union_batches"] == 0


def test_heterogeneous_fleets_one_pass_bitwise(traces):
    """The tentpole contract: concurrent queries with subset, superset,
    overlapping, and default (None) fleets coalesce into exactly one
    engine pass, and every answer is bitwise-identical to a direct
    ``FleetPlanner`` call on the analytical path."""
    fleets = [
        None,                                       # the full fleet
        ("T4", "V100"),                             # subset
        ("T4", "V100", "tpu-v5e", "tpu-v5p"),       # superset of subset
        ("P100", "trainium1"),                      # disjoint from above
        tuple(DEVS),                                # full fleet, spelled out
    ]
    service = PredictionService(predictor=cpu_predictor(),
                                coalesce_window_ms=500.0,
                                flush_at=len(fleets) + 1)
    calls = [lambda f=f: service.rank(traces[0], batch_size=16,
                                      dests=f)
             for f in fleets]
    calls.append(lambda: service.sweep(traces[:3], dests=["T4", "P4000"]))
    results = _burst(service, calls)
    stats = service.stats()
    assert stats["engine_passes"] == 1
    assert stats["coalescing"]["batches"] == 1
    assert stats["coalescing"]["union_batches"] == 1
    direct = FleetPlanner(predictor=cpu_predictor())
    for f, res in zip(fleets, results[:-1]):
        assert res == direct.rank(traces[0], 16,
                                  dests=list(f) if f else None)
    assert results[-1] == direct.sweep(traces[:3], dests=["T4", "P4000"])
    # dedup held: one miss per unique (trace, device) cell, where the
    # rank trace was priced on the whole union and the two sweep-only
    # traces on every device the union contains (T4/P4000 are subsets)
    union_n = len(DEVS)
    assert stats["cache"]["misses"] == 3 * union_n


def test_error_isolated_to_group(traces):
    """An engine failure in one dests-group fails only that group's
    requests; the healthy group still answers."""
    service = PredictionService(predictor=cpu_predictor(),
                                coalesce_window_ms=200.0, flush_at=2)
    outcome = {}
    barrier = threading.Barrier(2)

    def good():
        barrier.wait()
        outcome["good"] = service.rank(traces[0], batch_size=8,
                                       dests=["T4", "V100"])

    def bad():
        barrier.wait()
        try:
            service.rank(traces[1], batch_size=8, dests=["T4", "no-such"])
        except KeyError as e:
            outcome["bad"] = e

    threads = [threading.Thread(target=good),
               threading.Thread(target=bad)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert isinstance(outcome["bad"], KeyError)
    assert {c.device for c in outcome["good"]} == {"T4", "V100"}


def test_trace_error_isolated_in_union_batch(traces):
    """A trace-level engine error (unmeasured op) coalesced into a union
    batch fails only its own request: the union pass aborts, the batch
    re-executes per request, and the healthy query still answers."""
    from repro_torch.core.costmodel import OpCost
    from repro_torch.core.trace import Op, TrackedTrace
    bad_trace = TrackedTrace(
        ops=[Op(name="add", kind="add", cost=OpCost(1e6, 6e5, 4e5))],
        origin_device="T4", label="unmeasured")        # measured_ms=None
    service = PredictionService(predictor=cpu_predictor(),
                                coalesce_window_ms=200.0, flush_at=2)
    outcome = {}
    barrier = threading.Barrier(2)

    def good():
        barrier.wait()
        outcome["good"] = service.rank(traces[0], batch_size=8)

    def bad():
        barrier.wait()
        try:
            service.sweep([bad_trace])
        except ValueError as e:
            outcome["bad"] = e

    threads = [threading.Thread(target=good),
               threading.Thread(target=bad)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert "no origin measurement" in str(outcome["bad"])
    assert [c.device for c in outcome["good"]] == \
        [c.device for c in FleetPlanner(
            predictor=cpu_predictor()).rank(traces[0], 8)]


def test_sequential_requests_still_answered(traces):
    """window=0 and no concurrency: every request is its own batch —
    the degenerate case must behave exactly like the planner."""
    service = PredictionService(predictor=cpu_predictor(),
                                coalesce_window_ms=0.0)
    a = service.rank(traces[0], batch_size=32)
    b = service.rank(traces[0], batch_size=32)
    assert a == b
    stats = service.stats()
    assert stats["coalescing"]["batches"] == 2
    assert stats["coalescing"]["coalesced_requests"] == 0
    assert stats["cache"]["hits"] == len(DEVS)      # second call from cache
    assert stats["engine_passes"] == 1


# ---------------------------------------------------------------------------
# planner-level concurrency (no coalescing): consistency under racing
# ---------------------------------------------------------------------------
def test_planner_concurrent_rank_consistent(traces):
    """Raw FleetPlanner.rank from many threads: accounting stays coherent
    (hits + misses == probes) and every thread sees the same answer.
    Duplicate misses are allowed here — single-miss semantics is the
    service's job (see test_concurrent_identical_ranks_one_miss_per_key)."""
    planner = FleetPlanner(predictor=cpu_predictor())
    tr = traces[0]
    n_threads = 6
    barrier = threading.Barrier(n_threads)
    results = [None] * n_threads

    def worker(i):
        barrier.wait()
        results[i] = planner.rank(tr, batch_size=32)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(r == results[0] for r in results)
    s = planner.stats
    assert s.hits + s.misses == n_threads * len(DEVS)
    assert s.misses >= len(DEVS)


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------
def test_rank_request_wire_roundtrip(traces):
    service = PredictionService(predictor=cpu_predictor(),
                                coalesce_window_ms=0.0)
    tr = traces[0]
    payload = json.dumps({"trace": json.loads(tr.to_json()),
                          "batch_size": 32})
    out = service.rank_request(payload)
    assert out["label"] == tr.label
    direct = FleetPlanner(predictor=cpu_predictor()).rank(tr, 32)
    assert [r["device"] for r in out["ranking"]] == \
        [c.device for c in direct]
    # wire-format decode must not perturb the numbers
    assert [r["iter_ms"] for r in out["ranking"]] == \
        [c.iter_ms for c in direct]


def test_free_device_rank_is_strict_json(traces, monkeypatch):
    """A free device's samples/$ is float('inf'); the wire must spell it
    as the string "Infinity" so the body stays RFC-8259-valid for strict
    clients (json.dumps would otherwise emit a bare Infinity token)."""
    import dataclasses as _dc
    free = _dc.replace(devices.get("T4"), name="free-T4",
                       cost_per_hour=0.0)
    monkeypatch.setitem(devices._REGISTRY, "free-T4", free)
    service = PredictionService(predictor=cpu_predictor(),
                                fleet=["free-T4", "V100"],
                                coalesce_window_ms=0.0)
    out = service.rank_request({"trace": traces[0].to_dict(),
                                "batch_size": 8, "by": "cost"})
    json.dumps(out, allow_nan=False)        # strict encoding must succeed
    assert out["ranking"][0]["device"] == "free-T4"
    assert out["ranking"][0]["cost_normalized"] == "Infinity"


def test_sweep_request_wire_roundtrip(traces):
    service = PredictionService(predictor=cpu_predictor(),
                                coalesce_window_ms=0.0)
    payload = {"traces": [t.to_json() for t in traces[:2]],
               "dests": ["T4", "V100"]}
    out = service.sweep_request(payload)
    assert out["labels"] == [t.label for t in traces[:2]]
    direct = FleetPlanner(predictor=cpu_predictor()).sweep(
        traces[:2], dests=["T4", "V100"])
    assert out["times"] == direct


# ===========================================================================
# the union/split planner (tests/test_split_planner.py)
# ===========================================================================
def _split_service(**kw):
    kw.setdefault("predictor", cpu_predictor())
    kw.setdefault("coalesce_window_ms", 60.0)
    service = PredictionService(**kw)
    # toy traces are a few ops each — zero the pass-overhead seed so the
    # cost model's SPLIT decision is deterministic whenever components
    # exist and cells are saved (the model's refusal side is exercised
    # explicitly in test_cost_model_can_refuse_to_split)
    service.split_pass_overhead_s = 0.0
    return service


def _disjoint_burst(service, traces, flush_at):
    service.flush_at = flush_at
    handles = [service.submit_rank(t, 32,
                                   dests=(FLEET_A if i % 2 == 0
                                          else FLEET_B))
               for i, t in enumerate(traces)]
    return [h.get(timeout=60) for h in handles]


def test_disjoint_fleets_split_into_two_passes(traces):
    service = _split_service()
    got = _disjoint_burst(service, traces, flush_at=len(traces))
    stats = service.stats()
    assert stats["coalescing"]["batches"] == 1
    assert stats["coalescing"]["split_batches"] == 1
    assert stats["coalescing"]["split_passes"] == 2
    assert stats["engine_passes"] == 2
    # parity: every answer equals the direct planner's, bitwise
    direct = FleetPlanner(predictor=cpu_predictor())
    for i, res in enumerate(got):
        dests = FLEET_A if i % 2 == 0 else FLEET_B
        assert res == direct.rank(traces[i], 32, dests=dests)


def test_split_matches_forced_union_bitwise(traces):
    split = _split_service()
    forced = _split_service(split_planner=False)
    got = _disjoint_burst(split, traces, flush_at=len(traces))
    want = _disjoint_burst(forced, traces, flush_at=len(traces))
    assert got == want
    assert forced.stats()["engine_passes"] == 1
    assert forced.stats()["coalescing"]["split_batches"] == 0


def test_shared_device_keeps_one_pass(traces):
    """Fleets overlapping in even one device are one component — the
    rectangle wastes nothing a split would save there."""
    service = _split_service()
    service.flush_at = 4
    overlap = FLEET_B + [FLEET_A[0]]
    handles = [service.submit_rank(traces[i], 32,
                                   dests=(FLEET_A if i % 2 == 0
                                          else overlap))
               for i in range(4)]
    for h in handles:
        h.get(timeout=60)
    stats = service.stats()
    assert stats["coalescing"]["split_batches"] == 0
    assert stats["engine_passes"] == 1


def test_shared_trace_keeps_requests_together(traces):
    """Disjoint fleets but one shared trace: merging is free (the trace
    row spans both fleets' columns), so the planner must not split."""
    service = _split_service()
    service.flush_at = 2
    h1 = service.submit_rank(traces[0], 32, dests=FLEET_A)
    h2 = service.submit_rank(traces[0], 32, dests=FLEET_B)
    r1, r2 = h1.get(timeout=60), h2.get(timeout=60)
    stats = service.stats()
    assert stats["coalescing"]["split_batches"] == 0
    assert stats["engine_passes"] == 1
    direct = FleetPlanner(predictor=cpu_predictor())
    assert r1 == direct.rank(traces[0], 32, dests=FLEET_A)
    assert r2 == direct.rank(traces[0], 32, dests=FLEET_B)


def test_cost_model_can_refuse_to_split(traces):
    """With a huge per-pass overhead the rectangle always wins — the
    components exist, the model keeps them together."""
    service = _split_service()
    service.split_pass_overhead_s = 10.0       # pathological seed
    got = _disjoint_burst(service, traces, flush_at=len(traces))
    stats = service.stats()
    assert stats["coalescing"]["split_batches"] == 0
    assert stats["engine_passes"] == 1
    direct = FleetPlanner(predictor=cpu_predictor())
    for i, res in enumerate(got):
        dests = FLEET_A if i % 2 == 0 else FLEET_B
        assert res == direct.rank(traces[i], 32, dests=dests)


def test_split_sweep_requests(traces):
    """Sweep-kind requests ride the same planner and stay exact."""
    split = _split_service()
    forced = _split_service(split_planner=False)
    for service in (split, forced):
        service.flush_at = 2
        ha = service.submit_sweep(traces[:2], dests=FLEET_A)
        hb = service.submit_sweep(traces[2:4], dests=FLEET_B)
        service._last = (ha.get(timeout=60), hb.get(timeout=60))
    assert split._last == forced._last
    assert split.stats()["engine_passes"] == 2
    assert forced.stats()["engine_passes"] == 1


def test_three_disjoint_groups_three_passes(traces):
    service = _split_service()
    service.flush_at = 6
    thirds = [DEVS[0:5], DEVS[5:10], DEVS[10:15]]
    handles = [service.submit_rank(traces[i], 32, dests=thirds[i % 3])
               for i in range(6)]
    for h in handles:
        h.get(timeout=60)
    stats = service.stats()
    assert stats["coalescing"]["split_passes"] == 3
    assert stats["engine_passes"] == 3


def test_error_isolated_within_split_group(traces):
    """An engine error in one group must not poison the other group."""
    from repro_torch.core.costmodel import OpCost
    from repro_torch.core.trace import Op, TrackedTrace
    bad = TrackedTrace(        # unmeasured kernel-alike op -> engine error
        ops=[Op(name="add", kind="add", cost=OpCost(1e6, 6e5, 4e5))],
        origin_device="T4", label="bad")
    service = _split_service()
    service.flush_at = 2
    h_bad = service.submit_rank(bad, 32, dests=FLEET_A)
    h_ok = service.submit_rank(traces[1], 32, dests=FLEET_B)
    ok = h_ok.get(timeout=60)
    with pytest.raises(ValueError, match="no origin measurement"):
        h_bad.get(timeout=60)
    direct = FleetPlanner(predictor=cpu_predictor())
    assert ok == direct.rank(traces[1], 32, dests=FLEET_B)


def test_planning_failure_never_hangs_waiters(traces):
    """An exception inside _plan_groups (it fingerprints every trace)
    must degrade to the union pass's error-isolation path — every waiter
    gets an answer or an error, never an unset done-event."""
    bad = _trace(20)
    def boom():
        raise RuntimeError("boom in planning")
    bad.fingerprint = boom              # instance attr shadows the method
    service = _split_service()
    service.flush_at = 2
    h_bad = service.submit_rank(bad, 32, dests=FLEET_A)
    h_ok = service.submit_rank(traces[1], 32, dests=FLEET_B)
    ok = h_ok.get(timeout=30)           # would TimeoutError on a hang
    with pytest.raises(RuntimeError, match="boom in planning"):
        h_bad.get(timeout=30)
    direct = FleetPlanner(predictor=cpu_predictor())
    assert ok == direct.rank(traces[1], 32, dests=FLEET_B)


def test_pass_model_learns_from_measurements(traces):
    """Measured engine passes refine the cost model (positive fits only)."""
    service = _split_service()
    with service._cond:
        service._pass_samples = [(c, c, t) for c, t in
                                 [(1000, 0.002), (2000, 0.003),
                                  (3000, 0.004), (4000, 0.005),
                                  (5000, 0.006), (6000, 0.007),
                                  (7000, 0.008), (8000, 0.009)]]
    c_pass, c_cell = service._pass_model()
    assert c_pass == pytest.approx(1e-3, rel=1e-6)
    assert c_cell == pytest.approx(1e-6, rel=1e-6)
    # degenerate samples (no variance) fall back to the seeds
    with service._cond:
        service._pass_samples = [(1000, 1000, 0.002)] * 8
    assert service._pass_model() == (service.split_pass_overhead_s,
                                     service.split_cell_cost_s)


def test_warm_history_prefers_union_over_pointless_split(traces):
    """A fully-warm streak discounts the rectangle, so the planner stops
    paying extra passes for compute the result cache serves either way —
    and a cold history restores the split, same overhead."""
    service = _split_service()
    # overhead sized between the discounted and undiscounted savings of
    # this burst's rectangle, so the warm discount alone flips the plan
    service.split_pass_overhead_s = 5e-6
    with service._cond:                        # all-warm history
        service._pass_samples = [(0, 50_000, 0.001)] * 8
    assert service._warm_discount() == pytest.approx(0.1)
    got = _disjoint_burst(service, traces, flush_at=len(traces))
    stats = service.stats()
    assert stats["coalescing"]["split_batches"] == 0
    assert stats["engine_passes"] == 1
    direct = FleetPlanner(predictor=cpu_predictor())
    for i, res in enumerate(got):
        dests = FLEET_A if i % 2 == 0 else FLEET_B
        assert res == direct.rank(traces[i], 32, dests=dests)
    # cold history (no samples -> discount 1.0): the same burst splits
    with service._cond:
        service._pass_samples = []
    service.planner.clear_cache()
    _disjoint_burst(service, traces, flush_at=len(traces))
    assert service.stats()["coalescing"]["split_batches"] == 1


def test_split_counters_snapshot_consistent(traces):
    """stats() under concurrent bursts never shows torn counters."""
    service = _split_service()
    service.flush_at = len(traces)
    stop = threading.Event()
    seen = []

    def poll():
        while not stop.is_set():
            s = service.stats()["coalescing"]
            seen.append((s["split_batches"], s["split_passes"]))

    t = threading.Thread(target=poll)
    t.start()
    try:
        _disjoint_burst(service, traces, flush_at=len(traces))
    finally:
        stop.set()
        t.join()
    for batches, passes in seen:
        assert passes >= batches            # a split has >= 1 pass
    final = service.stats()["coalescing"]
    assert (final["split_batches"], final["split_passes"]) == (1, 2)


def test_split_model_in_stats_payload(traces):
    service = _split_service()
    payload = service.stats()
    assert payload["split_model"]["samples"] == 0
    assert payload["split_model"]["pass_overhead_ms"] == pytest.approx(
        service.split_pass_overhead_s * 1e3)
    assert payload["coalescing"]["split_planner"] is True
    assert "engine_caches" in payload


def test_split_env_knobs(monkeypatch):
    monkeypatch.setenv("REPRO_SPLIT_PASS_OVERHEAD_MS", "2.5")
    monkeypatch.setenv("REPRO_SPLIT_CELL_NS", "80")
    service = PredictionService(predictor=cpu_predictor())
    assert service.split_pass_overhead_s == pytest.approx(2.5e-3)
    assert service.split_cell_cost_s == pytest.approx(80e-9)
    # malformed / negative overrides must not kill the worker — the
    # documented defaults apply instead (same policy as batched.env_int)
    monkeypatch.setenv("REPRO_SPLIT_PASS_OVERHEAD_MS", "1,5")
    monkeypatch.setenv("REPRO_SPLIT_CELL_NS", "-3")
    service = PredictionService(predictor=cpu_predictor())
    assert service.split_pass_overhead_s == pytest.approx(1.5e-3)
    assert service.split_cell_cost_s == pytest.approx(40e-9)


def test_pass_model_rejects_inconsistent_fit(traces):
    """A fit whose slope comes out negative must not leak its (inflated)
    intercept into the model — both terms adopt together or not at all."""
    service = _split_service()
    service.split_pass_overhead_s = 1.5e-3
    with service._cond:
        # warm passes: many cells, tiny time; cold passes: few cells,
        # large time -> negative slope, intercept inflated way past any
        # real per-pass overhead
        service._pass_samples = [(100_000, 100_000, 0.001)] * 4 \
            + [(100, 100, 0.02)] * 4
    c_pass, c_cell = service._pass_model()
    assert (c_pass, c_cell) == (service.split_pass_overhead_s,
                                service.split_cell_cost_s)


def test_warm_pass_samples_not_credited_with_rectangle(traces):
    """A repeat (cache-warm) burst must record ~zero computed cells, not
    the full rectangle — otherwise the fitted per-cell cost collapses
    and the planner stops splitting cold bursts."""
    service = _split_service(split_planner=False)
    service.flush_at = 4
    for _ in range(2):          # second burst is fully result-cache warm
        handles = [service.submit_rank(traces[i], 32, dests=FLEET_A)
                   for i in range(4)]
        for h in handles:
            h.get(timeout=60)
    with service._cond:
        samples = list(service._pass_samples)
    assert len(samples) == 2
    assert samples[0][0] > 0    # cold burst priced its real cells
    assert samples[1][0] == 0   # warm burst computed (and records) ~none


def test_a_pass_is_timed_by_its_threads_cpu_not_the_wall_clock(traces):
    """The port records a pass's thread CPU time: time the pass spends
    waiting (here a sleep; under a burst, the interpreter lock) is not
    priced as engine work."""
    import time
    service = _split_service(split_planner=False)
    sweep = service.planner.sweep

    def waiting_sweep(*args, **kwargs):
        time.sleep(0.5)
        return sweep(*args, **kwargs)

    service.planner.sweep = waiting_sweep
    t0 = time.perf_counter()
    service.sweep([traces[0]], dests=FLEET_A)
    wall = time.perf_counter() - t0
    with service._cond:
        (sample,) = service._pass_samples
    assert wall >= 0.5
    assert sample[2] < 0.25


# ===========================================================================
# admission and the adaptive window (tests/test_admission.py)
# ===========================================================================
def _adm_trace(n=12, label="adm") -> TrackedTrace:
    return carry(OperationTracker("T4").track(
        lambda w, x: jnp.sum(jnp.tanh(x @ w)),
        jnp.zeros((n, 24)), jnp.zeros((8, n)), label=label))


# -- AdmissionController units ----------------------------------------------
def test_admit_release_conserves_budget():
    ctl = AdmissionController(max_queue=10, max_inflight_s=1.0)
    t1 = ctl.admit("interactive", 0.3)
    t2 = ctl.admit("bulk", 0.2)
    s = ctl.stats()
    assert s["inflight_requests"] == 2
    assert s["inflight_cost_s"] == pytest.approx(0.5)
    ctl.release(t1)
    ctl.release(t1)     # idempotent per ticket
    ctl.release(t2)
    s = ctl.stats()
    assert s["inflight_requests"] == 0
    assert s["inflight_cost_s"] == 0.0
    assert s["admitted"] == {"interactive": 1, "bulk": 1}
    assert s["shed"] == {"interactive": 0, "bulk": 0}


def test_queue_full_sheds_503():
    ctl = AdmissionController(max_queue=1, max_inflight_s=100.0)
    ctl.admit("interactive", 0.0)
    with pytest.raises(AdmissionError) as ei:
        ctl.admit("interactive", 0.0)
    assert ei.value.status == 503
    assert 0.05 <= ei.value.retry_after_s <= 30.0
    assert ctl.stats()["shed_503"] == 1


def test_cost_budget_sheds_429_with_clamped_retry():
    ctl = AdmissionController(max_queue=100, max_inflight_s=1.0)
    ctl.admit("interactive", 0.9)
    with pytest.raises(AdmissionError) as ei:
        ctl.admit("interactive", 0.5)       # 1.4 > 1.0
    assert ei.value.status == 429
    assert ei.value.retry_after_s == pytest.approx(0.4)
    with pytest.raises(AdmissionError) as ei:
        ctl.admit("interactive", 1000.0)    # huge excess clamps to 30 s
    assert ei.value.retry_after_s == 30.0


def test_bulk_lane_sheds_before_interactive():
    """Bulk is capped at bulk_share of the budget; interactive may spend
    the remainder — a sweep flood cannot starve ranking traffic."""
    ctl = AdmissionController(max_queue=100, max_inflight_s=1.0,
                              bulk_share=0.5)
    ctl.admit("bulk", 0.45)
    with pytest.raises(AdmissionError) as ei:
        ctl.admit("bulk", 0.2)              # bulk 0.65 > 0.5 share
    assert ei.value.status == 429
    assert ei.value.lane == "bulk"
    ctl.admit("interactive", 0.5)           # total 0.95 <= 1.0: fine
    s = ctl.stats()
    assert s["admitted"] == {"interactive": 1, "bulk": 1}
    assert s["shed"] == {"interactive": 0, "bulk": 1}


def test_kill_switch_admits_everything_but_counts():
    ctl = AdmissionController(enabled=False, max_queue=0,
                              max_inflight_s=0.0)
    for _ in range(5):
        ctl.admit("bulk", 99.0)
    s = ctl.stats()
    assert s["enabled"] is False
    assert s["admitted"]["bulk"] == 5
    assert s["shed_429"] == s["shed_503"] == 0
    assert s["inflight_cost_s"] == pytest.approx(5 * 99.0)


def test_unknown_lane_rejected():
    ctl = AdmissionController()
    with pytest.raises(ValueError):
        ctl.admit("batch", 0.1)
    assert set(LANES) == {"interactive", "bulk"}


def test_admit_is_atomic_under_contention():
    """Two racing admits can never both squeeze into the last slot."""
    ctl = AdmissionController(max_queue=100, max_inflight_s=1.0)
    admitted, shed = [], []
    barrier = threading.Barrier(8)

    def worker():
        barrier.wait()
        try:
            admitted.append(ctl.admit("interactive", 0.3))
        except AdmissionError:
            shed.append(1)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(admitted) == 3               # floor(1.0 / 0.3)
    assert len(shed) == 5
    assert ctl.stats()["inflight_cost_s"] <= 1.0


def test_an_idle_bulk_lane_skips_its_share_not_the_budget():
    """A bulk request priced above the bulk share still runs when no
    other bulk request is in flight (the reference refuses it forever,
    each time with a Retry-After); the global budget still binds it."""
    ctl = AdmissionController(max_queue=100, max_inflight_s=1.0,
                              bulk_share=0.5)
    with pytest.raises(AdmissionError) as ei:
        ctl.admit("bulk", 1.5)              # above the whole budget
    assert ei.value.status == 429 and ei.value.lane == "bulk"
    big = ctl.admit("bulk", 0.8)            # 0.8 > the 0.5 s share
    with pytest.raises(AdmissionError) as ei:
        ctl.admit("bulk", 0.1)              # its lane is busy now
    assert "bulk lane over its cost share" in str(ei.value)
    with pytest.raises(AdmissionError) as ei:
        ctl.admit("interactive", 0.3)       # 1.1 > the 1.0 s budget
    assert "in-flight cost budget exhausted" in str(ei.value)
    ctl.release(ctl.admit("interactive", 0.2))
    ctl.release(big)
    ctl.release(ctl.admit("bulk", 0.8))     # the lane drained: progress
    s = ctl.stats()
    assert s["inflight_requests"] == 0 and s["inflight_cost_s"] == 0.0
    assert s["admitted"] == {"interactive": 1, "bulk": 2}
    assert s["shed"] == {"interactive": 1, "bulk": 2}


# -- adaptive_window_ms (pure rule) -----------------------------------------
def test_adaptive_window_stretches_when_idle_collapses_when_full():
    base, hi, flush = 5.0, 25.0, 64
    assert adaptive_window_ms(base, hi, 1.0, flush) == pytest.approx(hi)
    assert adaptive_window_ms(base, hi, flush, flush) == pytest.approx(base)
    mid = adaptive_window_ms(base, hi, flush / 2, flush)
    assert base < mid < hi
    # monotonic: more load, shorter window
    prev = hi + 1
    for ewma in (1, 4, 16, 32, 64, 128):
        w = adaptive_window_ms(base, hi, ewma, flush)
        assert w <= prev
        prev = w


def test_adaptive_window_never_shrinks_below_base():
    # max below base degenerates to the static window (burst benches
    # tuned to a wide base keep their semantics)
    assert adaptive_window_ms(100.0, 25.0, 1.0, 64) == 100.0
    assert adaptive_window_ms(100.0, 25.0, 64.0, 64) == 100.0
    # and out-of-range ewma clamps rather than extrapolating
    assert adaptive_window_ms(5.0, 25.0, 0.0, 64) == 25.0
    assert adaptive_window_ms(5.0, 25.0, 1e9, 64) == 5.0


def test_service_effective_window_tracks_load():
    svc = PredictionService(predictor=cpu_predictor(),
                            coalesce_window_ms=1.0, window_max_ms=20.0,
                            flush_at=4)
    assert svc.effective_window_ms() == pytest.approx(20.0)  # idle: max
    tr = _adm_trace()
    for _ in range(8):      # solo batches keep ewma ~1: stays stretched
        svc.rank(tr, 8)
    stretched = svc.effective_window_ms()
    svc._batch_ewma = 4.0   # simulate full batches
    assert svc.effective_window_ms() == pytest.approx(1.0)
    assert stretched > 10.0
    off = PredictionService(predictor=cpu_predictor(),
                            coalesce_window_ms=1.0, adaptive_window=False,
                            window_max_ms=20.0)
    assert off.effective_window_ms() == 1.0     # kill switch: static


# -- service integration -----------------------------------------------------
def test_estimate_cost_monotonic_and_positive():
    svc = PredictionService(predictor=cpu_predictor())
    small, big = _adm_trace(8, "small"), _adm_trace(8, "big")
    one = svc.estimate_cost_s([small], ["T4"])
    all_devs = svc.estimate_cost_s([small], None)
    two_traces = svc.estimate_cost_s([small, big], ["T4"])
    assert one > 0
    assert all_devs > one           # more devices, more cells
    assert two_traces > one         # more traces, more cells


def test_a_request_the_result_cache_holds_is_priced_at_a_warm_pass():
    """The port prices a request whose every cell is cached at the
    median of the recent passes that computed no cell, read from the
    cache without counting a hit or a miss; a cold cell prices it as
    the reference does."""
    svc = PredictionService(predictor=cpu_predictor(),
                            coalesce_window_ms=0.0)
    tr = _adm_trace()
    cold = svc.estimate_cost_s([tr], ["T4"])
    svc.sweep([tr], dests=["T4"])           # computes the cell
    svc.sweep([tr], dests=["T4"])           # a pass that computes none
    warm = [s[2] for s in svc.export_pass_samples() if not s[0]]
    assert len(warm) == 1
    before = svc.planner.stats.as_dict()
    assert svc.estimate_cost_s([tr], ["T4"]) == warm[0]
    assert svc.estimate_cost_s([tr], ["T4"]) < cold
    assert svc.planner.stats.as_dict() == before    # a peek, not a probe
    assert svc.planner.sweep_cached([tr], ["T4"])
    assert not svc.planner.sweep_cached([tr], ["T4", "V100"])
    assert svc.estimate_cost_s([tr], ["T4", "V100"]) > warm[0]


def test_wire_entry_points_enforce_admission_and_release():
    svc = PredictionService(
        predictor=cpu_predictor(), coalesce_window_ms=0.0,
        admission=AdmissionController(max_queue=64, max_inflight_s=50.0))
    tr = _adm_trace()
    out = svc.rank_request({"trace": tr.to_dict(), "batch_size": 8})
    assert out["label"] == tr.label
    s = svc.admission.stats()
    assert s["admitted"]["interactive"] == 1
    assert s["inflight_requests"] == 0          # released on success
    out = svc.sweep_request({"traces": [tr.to_dict()], "dests": ["T4"]})
    assert out["times"][0]["T4"] > 0
    assert svc.admission.stats()["admitted"]["bulk"] == 1

    svc.admission.max_inflight_s = 1e-12        # now everything sheds
    with pytest.raises(AdmissionError):
        svc.rank_request({"trace": tr.to_dict(), "batch_size": 8})
    s = svc.admission.stats()
    assert s["shed"]["interactive"] == 1
    assert s["inflight_requests"] == 0          # shed reserves nothing


def test_ticket_released_when_engine_errors():
    svc = PredictionService(predictor=cpu_predictor(),
                            coalesce_window_ms=0.0)
    tr = _adm_trace()
    with pytest.raises(Exception):
        svc.rank_request({"trace": tr.to_dict(), "batch_size": 8,
                          "dests": ["no-such-device"]})
    assert svc.admission.stats()["inflight_requests"] == 0


def test_inprocess_calls_bypass_admission():
    """rank()/sweep()/submit_* are engine API, not the front door."""
    svc = PredictionService(
        predictor=cpu_predictor(), coalesce_window_ms=0.0,
        admission=AdmissionController(max_queue=0, max_inflight_s=0.0))
    tr = _adm_trace()
    assert svc.rank(tr, 8)                      # would 503 at the door
    assert svc.sweep([tr], dests=["T4"])
    assert svc.admission.stats()["admitted"] == {"interactive": 0,
                                                 "bulk": 0}


# -- threaded front end translates sheds ------------------------------------
def test_threaded_server_sheds_with_retry_after():
    svc = PredictionService(
        predictor=cpu_predictor(), coalesce_window_ms=0.0,
        admission=AdmissionController(max_queue=64, max_inflight_s=1e-12))
    server = PredictionServer(svc).start()
    try:
        client = PredictionClient(server.url)
        with pytest.raises(urllib.error.HTTPError) as ei:
            client.rank(_adm_trace(), batch_size=8)
        assert ei.value.code == 429
        assert int(ei.value.headers["Retry-After"]) >= 1
        body = ei.value.read()
        assert b"retry_after_s" in body and b"lane" in body
        # stats still served, with the shed visible
        stats = client.stats()
        assert stats["admission"]["shed_429"] == 1
    finally:
        server.shutdown()


# -- release-on-cancel: exactly once under concurrent cancellation -----------
# (hypothesis is a dev-only dependency — same gating as test_properties)
try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:
    from repro_torch.serve.admission import DeadlineExceeded
    from repro_torch.serve.service import PendingQuery

    @settings(max_examples=30, deadline=None)
    @given(n_cancellers=st.integers(1, 6), cost=st.floats(0.01, 0.5),
           finisher_races=st.booleans())
    def test_release_on_cancel_exactly_once(n_cancellers, cost,
                                            finisher_races):
        """The on_done -> release bridge fires exactly once no matter
        how many cancellations race one finish: the admission budget is
        conserved bit-for-bit (a double release would underflow it, a
        missed one would leak inflight cost forever)."""
        ctl = AdmissionController(max_queue=100, max_inflight_s=10.0)
        ticket = ctl.admit("interactive", cost)
        releases = []

        def bridge(_q):
            releases.append(1)
            ctl.release(ticket)

        q = PendingQuery(kind="rank", traces=[], dests=None,
                         on_done=bridge)
        q.result = "ok"
        n_parties = n_cancellers + (1 if finisher_races else 0)
        barrier = threading.Barrier(n_parties)
        wins = []
        lock = threading.Lock()

        def canceller():
            barrier.wait()
            if q.cancel(DeadlineExceeded("lapsed")):
                with lock:
                    wins.append("cancel")
                ctl.release(ticket)     # wire paths also release in
                # their finally blocks — idempotence must absorb it

        def finisher():
            barrier.wait()
            q.finish()
            ctl.release(ticket)

        threads = [threading.Thread(target=canceller)
                   for _ in range(n_cancellers)]
        if finisher_races:
            threads.append(threading.Thread(target=finisher))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(releases) == 1       # on_done fired exactly once
        assert len(wins) <= 1
        s = ctl.stats()
        assert s["inflight_requests"] == 0
        assert s["inflight_cost_s"] == 0.0
        assert s["admitted"]["interactive"] == 1


# ===========================================================================
# the what-if optimizer (tests/test_optimizer.py)
# ===========================================================================
ALIKE = ("add", "mul", "tanh", "reduce_sum", "transpose")


def _ref_opt_trace(n_ops, seed, label):
    """A reference trace of kernel-alike ops, measured by its simulator."""
    from repro.core.costmodel import OpCost
    from repro.core.trace import Op
    from repro.core.trace import TrackedTrace as RefTrace
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_ops):
        kind = ALIKE[int(rng.integers(len(ALIKE)))]
        nbytes = float(np.exp(rng.uniform(np.log(1e4), np.log(1e8))))
        ops.append(Op(name=kind, kind=kind,
                      cost=OpCost(nbytes * 0.5, nbytes * 0.6,
                                  nbytes * 0.4)))
    return RefTrace(ops=ops, origin_device="T4", label=label).measure()


REF_TRACES = [_ref_opt_trace(60, 100 + i, f"model-bs{b}")
              for i, b in enumerate((16, 32, 64))]
TRACES = [carry(t) for t in REF_TRACES]
BATCHES = [16, 32, 64]


def _opt_service(**kw):
    kw.setdefault("coalesce_window_ms", 0.0)
    kw.setdefault("adaptive_window", False)
    return PredictionService(predictor=cpu_predictor(), **kw)


def test_candidates_bitwise_equal_direct_sweep():
    service = _opt_service()
    result = service.optimize(TRACES, BATCHES, max_replicas=4, seed=3)
    assert result.candidates >= 45    # the replicas=1 grid at minimum
    fresh = FleetPlanner(predictor=cpu_predictor())
    for c in result.evaluated:
        direct = fresh.sweep([TRACES[c.trace_idx]],
                             dests=[c.device])[0][c.device]
        assert direct == c.iter_ms    # bitwise, not approx


def test_engine_passes_bounded_by_generations():
    service = _opt_service()
    result = service.optimize(TRACES, BATCHES, max_replicas=8, seed=0)
    assert service.planner.engine_pass_count() <= result.generations
    assert result.sweeps <= result.generations
    # dedup must actually fire: every generation past the first re-uses
    # cells the rectangle already priced
    assert result.cells_deduped > 0
    assert result.cells_priced <= len(TRACES) * len(DEVS)


def test_same_seed_same_frontier():
    r1 = _opt_service().optimize(TRACES, BATCHES, max_replicas=8, seed=11)
    r2 = _opt_service().optimize(TRACES, BATCHES, max_replicas=8, seed=11)
    assert r1.frontier == r2.frontier
    assert encode_optimize(r1) == encode_optimize(r2)


def test_frontier_is_nondominated_and_ordered():
    result = _opt_service().optimize(TRACES, BATCHES, max_replicas=8, seed=5)
    front = result.frontier
    assert front, "search produced an empty frontier"
    as_obj = [(c.time_s, float("nan") if c.cost_per_hour is None
               else c.cost_per_hour) for c in front]
    for i, (ti, ci) in enumerate(as_obj):
        for j, (tj, cj) in enumerate(as_obj):
            if i != j:
                assert not dominates(ti, ci, tj, cj)
    times = [c.time_s for c in front]
    assert times == sorted(times)     # fastest first
    # nothing the search evaluated dominates a frontier point
    for e in result.evaluated:
        ce = float("nan") if e.cost_per_hour is None else e.cost_per_hour
        for ti, ci in as_obj:
            assert not dominates(e.time_s, ce, ti, ci)


def test_unrentable_devices_kept_time_only():
    # a fleet of one unrentable + one priced device: the unrentable one
    # may only appear with cost_per_hour None, and JSON stays strict
    result = _opt_service().optimize(
        TRACES[:1], BATCHES[:1], dests=["P4000", "V100"],
        max_replicas=2, seed=0)
    devs = {c.device for c in result.frontier}
    assert "V100" in devs
    for c in result.frontier:
        if c.device == "P4000":
            assert c.cost_per_hour is None
    json.dumps(encode_optimize(result), allow_nan=False)
    assert "candidates" in format_frontier(result)


def test_validation_errors():
    service = _opt_service()
    with pytest.raises(ValueError):
        service.optimize(TRACES, [16, 32])          # length mismatch
    with pytest.raises(ValueError):
        service.optimize(TRACES, [16, 32, 0])       # non-positive batch
    with pytest.raises(ValueError):
        service.optimize([], [])                    # no traces
    with pytest.raises(ValueError):
        service.optimize(TRACES, BATCHES, max_generations=10**9)
    with pytest.raises(KeyError):
        service.optimize(TRACES, BATCHES, dests=["not-a-device"])
    with pytest.raises(ValueError):
        WhatIfOptimizer(service, TRACES, BATCHES, epoch_samples=-1.0)


def test_optimizer_works_on_bare_planner():
    # duck-typed inner loop: a FleetPlanner (no coalescer) works too
    planner = FleetPlanner(predictor=cpu_predictor())
    result = WhatIfOptimizer(planner, TRACES, BATCHES, dests=DEVS,
                             max_replicas=4, seed=0).run()
    assert result.sweeps >= 1 and result.frontier


def test_stats_and_requests_counters():
    service = _opt_service()
    before = service.stats()["optimizer"]
    assert before == {"optimize_searches": 0, "optimize_generations": 0,
                      "optimize_sweeps": 0, "optimize_candidates": 0,
                      "optimize_cells_priced": 0,
                      "optimize_cells_deduped": 0}
    result = service.optimize(TRACES, BATCHES, max_replicas=4, seed=0)
    stats = service.stats()
    opt = stats["optimizer"]
    assert opt["optimize_searches"] == 1
    assert opt["optimize_generations"] == result.generations
    assert opt["optimize_cells_deduped"] == result.cells_deduped
    assert opt["optimize_candidates"] == result.candidates
    assert stats["requests"]["optimize"] == 1


def test_wire_round_trip_and_admission_lane():
    service = _opt_service()
    payload = {"traces": [t.to_dict() for t in TRACES],
               "batch_sizes": BATCHES, "max_replicas": 4, "seed": 2,
               "max_generations": 4}
    doc = service.optimize_request(json.dumps(payload))
    json.dumps(doc, allow_nan=False)
    assert doc["search"]["generations"] <= 4
    assert doc["frontier"]
    direct = service.optimize(TRACES, BATCHES, max_replicas=4, seed=2,
                              max_generations=4)
    assert doc == encode_optimize(direct)   # wire == in-process, bitwise
    # the lane is bulk: admission counted it there
    adm = service.stats()["admission"]
    assert adm["admitted"]["bulk"] >= 1


def test_wire_shed_maps_to_admission_error():
    from repro_torch.serve.admission import AdmissionError
    service = PredictionService(
        predictor=cpu_predictor(), coalesce_window_ms=0.0,
        adaptive_window=False,
        admission=AdmissionController(max_queue=64, max_inflight_s=1e-12))
    payload = {"traces": [t.to_dict() for t in TRACES],
               "batch_sizes": BATCHES}
    with pytest.raises(AdmissionError) as ei:
        service.optimize_request(payload)
    assert ei.value.lane == "bulk"


def test_wire_validation_is_400_shaped():
    service = _opt_service()
    with pytest.raises((KeyError, ValueError, TypeError)):
        service.optimize_request({"traces": [TRACES[0].to_dict()]})
    with pytest.raises((KeyError, ValueError, TypeError)):
        service.optimize_request(
            {"traces": [TRACES[0].to_dict()], "batch_sizes": [16, 32]})


@pytest.fixture(scope="module")
def http_client():
    service = PredictionService(predictor=cpu_predictor(),
                                coalesce_window_ms=0.0,
                                adaptive_window=False)
    server = PredictionServer(service).start()
    yield PredictionClient(server.url), service
    server.shutdown()


def test_http_optimize_route(http_client):
    client, service = http_client
    doc = client.optimize(TRACES, BATCHES, max_replicas=4, seed=9,
                          max_generations=3)
    direct = _opt_service().optimize(TRACES, BATCHES, max_replicas=4, seed=9,
                                 max_generations=3)
    assert doc == encode_optimize(direct)   # HTTP == in-process
    assert client.stats()["optimizer"]["optimize_searches"] >= 1


def test_http_optimize_bad_request_is_400(http_client):
    import urllib.error
    client, _ = http_client
    with pytest.raises(urllib.error.HTTPError) as ei:
        client.optimize(TRACES, [1])        # misaligned batch_sizes
    assert ei.value.code == 400


def test_aserver_optimize_route():
    from repro_torch.serve.aserver import AsyncPredictionServer
    service = PredictionService(predictor=cpu_predictor(),
                                coalesce_window_ms=0.0,
                                adaptive_window=False)
    server = AsyncPredictionServer(service).start()
    try:
        client = PredictionClient(server.url)
        doc = client.optimize(TRACES, BATCHES, max_replicas=4, seed=9,
                              max_generations=3)
        direct = _opt_service().optimize(TRACES, BATCHES, max_replicas=4,
                                     seed=9, max_generations=3)
        assert doc == encode_optimize(direct)   # async == threaded
        assert client.stats()["optimizer"]["optimize_searches"] >= 1
    finally:
        server.shutdown()


# ===========================================================================
# across the packages
# ===========================================================================
def _close(got, want, rel):
    """Decoded wire documents: same keys, same order of lists, strings
    equal, numbers within ``rel``."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _close(got[k], want[k], rel)
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rel)
    elif isinstance(want, float) and not isinstance(got, str):
        assert type(got) is float
        assert got == pytest.approx(want, rel=rel, abs=0.0)
    else:
        assert got == want


def _ref_service(**kw):
    from repro.core import HabitatPredictor as RefPredictor
    from repro.serve.service import PredictionService as RefService
    kw.setdefault("predictor", RefPredictor())
    return RefService(coalesce_window_ms=0.0, **kw)


@pytest.mark.parametrize("dests", [None, ["T4", "V100", "tpu-v5e"]])
def test_wire_answers_match_the_reference(dests):
    """The same wire payloads through both packages' services: the same
    keys, device orders and labels, every number within rel 1e-12."""
    ref_traces = [_ref_toy(16 + 8 * i) for i in range(4)]
    port, ref = PredictionService(predictor=cpu_predictor(),
                                  coalesce_window_ms=0.0), _ref_service()
    for by in ("throughput", "cost"):
        for t in ref_traces:
            payload = json.dumps({"trace": t.to_dict(), "batch_size": 32,
                                  "by": by, "dests": dests})
            _close(port.rank_request(payload), ref.rank_request(payload),
                   1e-12)
    payload = json.dumps({"traces": [t.to_dict() for t in ref_traces],
                          "dests": dests})
    _close(port.sweep_request(payload), ref.sweep_request(payload), 1e-12)


def test_coalesced_burst_matches_the_reference():
    """A coalesced burst of mixed fleets in the port answers as the
    reference's service does, request by request (rel 1e-12), and the
    port's answers are bitwise its own direct planner's."""
    ref_traces = [_ref_toy(16 + 8 * i) for i in range(6)]
    fleets = [None, ("T4", "V100"), tuple(FLEET_A), tuple(FLEET_B),
              ("P100", "trainium1"), tuple(DEVS)]
    port = PredictionService(predictor=cpu_predictor(),
                             coalesce_window_ms=500.0,
                             flush_at=len(fleets))
    handles = [port.submit_rank(carry(t), 16, dests=f)
               for t, f in zip(ref_traces, fleets)]
    got = [h.get(timeout=60) for h in handles]
    assert port.stats()["coalescing"]["batches"] == 1
    ref, direct = _ref_service(), FleetPlanner(predictor=cpu_predictor())
    for t, f, res in zip(ref_traces, fleets, got):
        want = ref.rank(t, 16, dests=f)
        assert [c.device for c in res] == [c.device for c in want]
        for g, w in zip(res, want):
            assert g.iter_ms == pytest.approx(w.iter_ms, rel=1e-12)
        assert res == direct.rank(carry(t), 16,
                                  dests=list(f) if f else None)


def test_carried_mlps_serve_as_the_reference():
    """With the reference's MLPs carried over, the coalesced port service
    ranks the golden traces as the reference's service does (rel 1e-5)."""
    from repro.core import HabitatPredictor as RefPredictor
    from repro.core.trace import TrackedTrace as RefTrace
    from test_torch_engine import carried_mlps
    ref_mlps, port_mlps = carried_mlps(seed=7)
    docs = [json.loads(p.read_text())["trace"]
            for p in sorted((ROOT / "tests" / "golden").glob("*.json"))]
    port = PredictionService(predictor=cpu_predictor(mlps=port_mlps),
                             coalesce_window_ms=200.0, flush_at=len(docs))
    handles = [port.submit_rank(TrackedTrace.from_dict(d), 32)
               for d in docs]
    ref = _ref_service(predictor=RefPredictor(mlps=ref_mlps))
    for d, h in zip(docs, handles):
        got, want = h.get(timeout=60), ref.rank(RefTrace.from_dict(d), 32)
        assert [c.device for c in got] == [c.device for c in want]
        np.testing.assert_allclose([c.iter_ms for c in got],
                                   [c.iter_ms for c in want], rtol=1e-5)
    assert port.stats()["engine_passes"] == 1


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_optimizer_frontier_matches_the_reference(seed):
    """The same seed walks the same candidates in both packages: the
    frontiers hold the same configurations, times within rel 1e-12."""
    from repro.serve.optimizer import encode_optimize as ref_encode
    ref = _ref_service().optimize(REF_TRACES, BATCHES, max_replicas=8,
                                  seed=seed)
    got = _opt_service().optimize(TRACES, BATCHES, max_replicas=8,
                                  seed=seed)
    assert ([(c.device, c.replicas, c.batch_size) for c in got.frontier]
            == [(c.device, c.replicas, c.batch_size) for c in ref.frontier])
    assert (got.generations, got.candidates, got.cells_priced,
            got.cells_deduped) == (ref.generations, ref.candidates,
                                   ref.cells_priced, ref.cells_deduped)
    _close(encode_optimize(got), ref_encode(ref), 1e-12)


def _documented_stats_paths():
    """Dotted paths of ``docs/serving.md``'s field-reference rows, read
    as ``tests/test_docs_sync.py`` reads them."""
    paths = set()
    for line in (ROOT / "docs" / "serving.md").read_text().splitlines():
        if not line.startswith("| `"):
            continue
        for token in re.findall(r"`([^`]+)`", line):
            if re.fullmatch(r"[a-z_][a-z0-9_]*(\.[a-z0-9_]+)*", token):
                paths.add(token)
    return paths


def _flatten(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(f"{prefix}{k}")
        if isinstance(v, dict):
            out |= _flatten(v, f"{prefix}{k}.")
    return out


def test_stats_cover_the_documented_fields():
    documented = _documented_stats_paths()
    assert len(documented) > 30
    service = PredictionService(predictor=cpu_predictor(),
                                coalesce_window_ms=0.0)
    service.rank(_trace(8, 8, "docs-sync"), 8)
    missing = documented - _flatten(service.stats())
    assert not missing, sorted(missing)


def test_kill_switches_are_named_in_knobs_doc():
    import inspect
    names = {p.name
             for fn in (PredictionService.__init__,
                        AdmissionController.__init__, FleetPlanner.__init__)
             for p in inspect.signature(fn).parameters.values()
             if isinstance(p.default, bool)}
    assert {"union_grid", "split_planner", "adaptive_window",
            "cell_fill"} <= names
    documented = set(re.findall(r"`([a-z_]+)`",
                                (ROOT / "docs" / "knobs.md").read_text()))
    assert names <= documented, sorted(names - documented)


# ===========================================================================
# the kernel wrappers' launch counts under concurrent passes
# ===========================================================================
@pytest.mark.parametrize("module", ["fused_mlp_score", "fused_mlp",
                                    "flash_attention", "ssd"])
def test_launch_counts_are_exact_under_threads(module):
    """Two leaders' passes can launch at once: every wrapper counts
    through ``build.count_launch``, whose lock loses no count when 8
    threads bump together."""
    import importlib
    import inspect
    from repro_torch.kernels import build
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    src = inspect.getsource(mod)
    assert re.search(r"LAUNCHES\[[^\]]+\] \+=", src) is None
    names = list(mod.LAUNCHES)
    assert src.count("build.count_launch(LAUNCHES, ") == len(names)
    counts = dict.fromkeys(names, 0)
    barrier = threading.Barrier(8)

    def bump():
        barrier.wait()
        for _ in range(20000):
            for name in names:
                build.count_launch(counts, name)

    threads = [threading.Thread(target=bump) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert counts == dict.fromkeys(names, 8 * 20000)
