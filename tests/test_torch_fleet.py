"""Port parity: the fleet planner, ranking semantics and MLP artifacts.

The port's ``FleetPlanner`` must order the fleet exactly as the reference
does on the golden traces (with tiny MLPs carried across), keep the
None-versus-0.0 $/hr semantics (None = not rentable, ranks last by cost;
0.0 = free, ranks first), and score the reference's sealed MLP artifacts
to the reference's ``predict_ms``."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from repro.core import HabitatPredictor as RefPredictor
from repro.core import cost as ref_cost
from repro.core import dataset as ref_dataset
from repro.core import devices as ref_devices
from repro.core import mlp as ref_mlp
from repro.serve.fleet import FleetPlanner as RefPlanner
from repro_torch.core import cost, devices
from repro_torch.core import mlp as pt_mlp
from repro_torch.core.predictor import HabitatPredictor
from repro_torch.core.trace import TrackedTrace
from repro_torch.serve import cache as pt_cache
from repro_torch.serve.fleet import FleetPlanner, format_fleet, rank_rows
from test_torch_engine import DEVS, carried_mlps

ROOT = Path(__file__).resolve().parents[1]
GOLDEN_FILES = sorted((ROOT / "tests" / "golden").glob("*.json"))
ARTIFACTS = sorted((ROOT / "artifacts" / "mlps").glob("*_h3x256_*.pkl"))


def _golden_pair(path):
    doc = json.loads(path.read_text())["trace"]
    from repro.core.trace import TrackedTrace as RefTrace
    return RefTrace.from_dict(doc), TrackedTrace.from_dict(doc)


@pytest.fixture(scope="module")
def planners():
    ref_mlps, pt_mlps = carried_mlps(seed=4)
    return (RefPlanner(RefPredictor(mlps=ref_mlps)),
            FleetPlanner(HabitatPredictor(mlps=pt_mlps, device="cpu")))


@pytest.mark.parametrize("by", ["throughput", "cost"])
@pytest.mark.parametrize("path", GOLDEN_FILES, ids=lambda p: p.stem)
def test_rank_orderings_match_reference(planners, path, by):
    ref_planner, planner = planners
    ref_trace, trace = _golden_pair(path)
    want = ref_planner.rank(ref_trace, 32, by=by)
    got = planner.rank(trace, 32, by=by)
    assert [c.device for c in got] == [c.device for c in want]
    for g, w in zip(got, want):
        assert g.iter_ms == pytest.approx(w.iter_ms, rel=1e-5)
        assert (g.cost_normalized is None) == (w.cost_normalized is None)


@pytest.mark.parametrize("masked", [False, True])
def test_sweep_orderings_match_reference(planners, masked):
    """Cold sweeps, and (masked) sweeps that only fill the devices a
    previous narrower sweep left cold."""
    ref_planner, planner = planners
    pairs = [_golden_pair(p) for p in GOLDEN_FILES]
    ref_traces, traces = [r for r, _ in pairs], [t for _, t in pairs]
    if masked:
        ref_planner.sweep(ref_traces, DEVS[:9])
        planner.sweep(traces, DEVS[:9])
    want = ref_planner.sweep(ref_traces, DEVS)
    got = planner.sweep(traces, DEVS)
    for g, w in zip(got, want):
        assert sorted(g, key=g.get) == sorted(w, key=w.get)
        np.testing.assert_allclose([g[d] for d in DEVS],
                                   [w[d] for d in DEVS], rtol=1e-5)


def test_planner_caches_and_counts_engine_passes():
    planner = FleetPlanner(HabitatPredictor(device="cpu"))
    _, trace = _golden_pair(GOLDEN_FILES[1])
    first = planner.predict(trace)
    assert planner.engine_pass_count() == 1
    assert planner.predict(trace) == first
    assert planner.engine_pass_count() == 1
    assert planner.stats.hits == len(DEVS)
    stats = planner.engine_cache_stats()
    assert set(stats) == {"stack_cache", "wave_factor_cache",
                          "scorer_dispatches"}
    assert "iter ms" in format_fleet(planner.rank(trace, 8))


def test_none_price_ranks_last_by_cost_in_both():
    _, trace = _golden_pair(GOLDEN_FILES[0])
    times = HabitatPredictor(device="cpu").predict_fleet(trace).as_dict()
    rows = rank_rows(times, 16, trace.run_time_ms, by="cost")
    unpriced = [c.device for c in rows if c.cost_per_hour is None]
    assert unpriced and [c.device for c in rows[-len(unpriced):]] == \
        unpriced
    from repro.serve.fleet import rank_rows as ref_rank_rows
    want = ref_rank_rows(times, 16, trace.run_time_ms, by="cost")
    assert [c.device for c in rows] == [c.device for c in want]


def test_zero_price_is_free_not_unpriced(monkeypatch):
    """A free device (0.0 $/hr) ranks first by cost at inf samples/$, in
    the port's planner and in ``rank_devices``, as in the reference."""
    _, trace = _golden_pair(GOLDEN_FILES[1])
    for mod in (devices, ref_devices):
        free = dataclasses.replace(mod.get("T4"), name="free-T4",
                                   cost_per_hour=0.0)
        monkeypatch.setitem(mod._REGISTRY, "free-T4", free)
    fleet = ["free-T4", "V100", "P4000"]
    planner = FleetPlanner(HabitatPredictor(device="cpu"), fleet=fleet)
    by_cost = planner.rank(trace, 16, by="cost")
    assert by_cost[0].device == "free-T4"
    assert by_cost[0].cost_normalized == float("inf")
    assert by_cost[-1].device == "P4000" and \
        by_cost[-1].cost_normalized is None
    choices = cost.rank_devices(trace, 16, fleet,
                                HabitatPredictor(device="cpu"), by="cost")
    ref_trace, _ = _golden_pair(GOLDEN_FILES[1])
    want = ref_cost.rank_devices(ref_trace, 16, fleet, RefPredictor(),
                                 by="cost")
    assert [c.device for c in choices] == [c.device for c in want]
    assert cost.cost_normalized_throughput(16, 1.0, 0.0) == float("inf")


def test_make_backend_contract():
    assert isinstance(pt_cache.make_backend(None, 8), pt_cache.LRUCache)
    lru = pt_cache.LRUCache(2)
    assert pt_cache.make_backend(lru) is lru
    with pytest.raises(TypeError, match="protocol"):
        pt_cache.make_backend(object())
    with pytest.raises(NotImplementedError):
        pt_cache.make_backend("cache.sqlite")
    lru.put_many([(("a",), 1.0), (("b",), 2.0), (("c",), 3.0)])
    assert len(lru) == 2 and lru.stats.evictions == 1
    assert lru.get_many([("a",), ("c",)]) == [None, 3.0]


def test_mlp_save_load_roundtrip_readable_by_reference(tmp_path):
    _, pt_mlps = carried_mlps(seed=6, kinds=("linear",))
    path = tmp_path / "linear.pkl"
    pt_mlps["linear"].save(path)
    ref = ref_mlp.TrainedMLP.load(path)
    back = pt_mlp.TrainedMLP.load(path)
    feats = np.stack([ref_dataset.op_features(op, ref_devices.get("T4"))
                      for op in ref_dataset.sample_ops("linear", 20, 3)])
    np.testing.assert_allclose(back.predict_ms(feats), ref.predict_ms(feats),
                               rtol=1e-5)


@pytest.mark.parametrize("path", ARTIFACTS, ids=lambda p: p.name[:12])
def test_reference_artifact_loads_and_matches(path):
    """The untracked trained artifacts (3x256), when present locally."""
    ref = ref_mlp.TrainedMLP.load(path)
    port = pt_mlp.TrainedMLP.load(path)
    ops = ref_dataset.sample_ops(ref.kind, 50, seed=8)
    feats = np.stack([ref_dataset.op_features(op, ref_devices.get(d))
                      for op in ops for d in ("V100", "tpu-v4")])
    np.testing.assert_allclose(port.predict_ms(feats), ref.predict_ms(feats),
                               rtol=1e-5)
