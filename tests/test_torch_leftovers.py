"""Port parity: the main path's leftovers, fed to both packages.

``core/frontier.py`` (the cases of ``tests/test_frontier.py``), the
sqlite result cache (the sqlite cases of ``tests/test_serve_cache.py``,
plus database files crossing between the packages), ``faults.parse_spec``,
``format_sweep`` and the CI artifact key.  Exact equality throughout:
these are numpy, sqlite and string code with no float reordering."""

import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import artifacts as ref_artifacts
from repro.core import frontier as ref_frontier
from repro.serve import cache as ref_cache
from repro.serve import faults as ref_faults
from repro.serve import fleet as ref_fleet
from repro_torch.core import artifacts, devices, frontier
from repro_torch.core.predictor import HabitatPredictor
from repro_torch.core.trace import OperationTracker
from repro_torch.serve import cache, faults, fleet

ROOT = Path(__file__).resolve().parents[1]

PACKAGES = {
    "reference": types.SimpleNamespace(frontier=ref_frontier,
                                       cache=ref_cache),
    "port": types.SimpleNamespace(frontier=frontier, cache=cache),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


# ---------------------------------------------------------------------------
# frontier: the deterministic cases of tests/test_frontier.py, both packages
# ---------------------------------------------------------------------------
def test_simple_frontier(pkg):
    t = np.asarray([1.0, 2.0, 3.0, 2.0])
    c = np.asarray([9.0, 4.0, 1.0, 8.0])
    assert pkg.frontier.pareto_mask(t, c).tolist() == [True, True, True,
                                                       False]
    assert pkg.frontier.frontier_indices(t, c).tolist() == [0, 1, 2]


def test_duplicates_and_edges(pkg):
    f = pkg.frontier
    assert f.pareto_mask([1.0, 1.0, 2.0], [5.0, 5.0, 9.0]).tolist() == \
        [True, True, False]
    assert f.pareto_mask([], []).shape == (0,)
    assert f.frontier_indices([], []).shape == (0,)
    assert f.pareto_mask([3.0], [np.nan]).tolist() == [True]
    with pytest.raises(ValueError):
        f.pareto_mask([np.nan], [1.0])


def test_thin_keeps_endpoints_and_cap(pkg):
    ordered = np.arange(100, 200)
    for cap in (1, 2, 3, 7, 99, 100, 500):
        kept = pkg.frontier.thin_indices(ordered, cap)
        assert len(kept) <= cap and kept[0] == 100
        if cap >= 2:
            assert kept[-1] == 199
    with pytest.raises(ValueError):
        pkg.frontier.thin_indices(ordered, 0)


def test_nan_cost_contract(pkg):
    f = pkg.frontier
    assert f.pareto_mask([1.0, 2.0, 3.0],
                         [np.nan, 5.0, np.nan]).tolist() == [True, True,
                                                             False]
    assert f.dominates(2.0, 5.0, 2.0, np.nan)
    assert not f.dominates(2.0, np.nan, 2.0, 5.0)
    assert f.dominates(1.0, np.nan, 2.0, np.nan)
    t = np.asarray([1.0, 5.0, 9.0])
    assert f.frontier_indices(t, [np.nan, 2.0, 2.0],
                              objective="cost").tolist() == [1, 2]
    assert f.frontier_indices(t, [np.nan] * 3, objective="cost").size == 0
    assert f.frontier_indices([4.0, 4.0, 7.0], [np.nan, 3.0, 1.0],
                              objective="time").tolist() == [1, 0]
    assert f.pareto_mask([1.0, 2.0, 3.0],
                         [np.nan, np.nan, 2.0]).tolist() == [True, False,
                                                             True]


@pytest.mark.parametrize("seed", range(4))
def test_frontier_agrees_on_random_clouds(seed):
    """Registry costs (NaN for the unrentable) and random clouds give the
    same mask, order and thinning in both packages."""
    rng = np.random.default_rng(seed)
    names = sorted(devices.all_devices())
    costs = np.asarray(devices.as_arrays(names).cost_per_hour, np.float64)
    t = rng.uniform(1.0, 20.0, len(names))
    assert frontier.pareto_mask(t, costs).tolist() == \
        ref_frontier.pareto_mask(t, costs).tolist()
    t = rng.uniform(1, 10, 60)
    c = np.where(rng.uniform(size=60) < 0.2, np.nan, rng.uniform(1, 10, 60))
    for obj in ("time", "cost"):
        got = frontier.frontier_indices(t, c, objective=obj)
        assert got.tolist() == ref_frontier.frontier_indices(
            t, c, objective=obj).tolist()
        assert frontier.thin_indices(got, 5).tolist() == \
            ref_frontier.thin_indices(got, 5).tolist()


# ---------------------------------------------------------------------------
# the sqlite backend: the cases of tests/test_serve_cache.py, both packages
# ---------------------------------------------------------------------------
def test_sqlite_roundtrip_and_stats(pkg, tmp_path):
    c = pkg.cache.SqliteCache(tmp_path / "cache.sqlite", capacity=100)
    key = ("fp", "T4", ("HabitatPredictor", False), "tok")
    assert c.get(key) is None
    c.put_many([(key, 12.25)])
    assert c.get(key) == 12.25
    assert (c.stats.hits, c.stats.misses) == (1, 1) and len(c) == 1
    c.close()


def test_sqlite_value_bitwise_roundtrip(pkg, tmp_path):
    c = pkg.cache.SqliteCache(tmp_path / "cache.sqlite")
    vals = [0.1, 1e-300, 123456.789e12, 2.0 / 3.0]
    c.put_many([((f"k{i}",), v) for i, v in enumerate(vals)])
    assert [c.get((f"k{i}",)) for i in range(len(vals))] == vals
    c.close()


def test_sqlite_eviction(pkg, tmp_path):
    c = pkg.cache.SqliteCache(tmp_path / "cache.sqlite", capacity=3)
    c.put_many([((f"k{i}",), float(i)) for i in range(5)])
    assert len(c) == 3 and c.stats.evictions == 2
    assert c.get(("k0",)) is None and c.get(("k4",)) == 4.0
    c.close()


def test_sqlite_interleaved_ticks_evict_globally_oldest(pkg, tmp_path):
    path = tmp_path / "ticks.sqlite"
    a = pkg.cache.SqliteCache(path, capacity=3)
    b = pkg.cache.SqliteCache(path, capacity=3)
    a.put_many([(("a1",), 1.0)])
    a.put_many([(("a2",), 2.0)])
    a.put_many([(("a3",), 3.0)])
    b.put_many([(("b1",), 4.0), (("b2",), 5.0)])
    assert len(b) == 3
    assert b.get(("b1",)) == 4.0 and b.get(("b2",)) == 5.0
    assert b.get(("a3",)) == 3.0
    assert a.get(("a1",)) is None and a.get(("a2",)) is None
    a.close()
    b.close()


def test_sqlite_shared_between_instances(pkg, tmp_path):
    path = tmp_path / "shared.sqlite"
    a, b = pkg.cache.SqliteCache(path), pkg.cache.SqliteCache(path)
    a.put_many([(("fp", "V100"), 3.5)])
    assert b.get(("fp", "V100")) == 3.5
    assert b.stats.hits == 1 and b.stats.misses == 0 and a.stats.hits == 0
    a.close()
    b.close()


def test_make_backend_spellings_and_capacity(pkg, tmp_path):
    assert isinstance(pkg.cache.make_backend(None, 16), pkg.cache.LRUCache)
    assert isinstance(pkg.cache.make_backend(tmp_path / "x.sqlite"),
                      pkg.cache.SqliteCache)
    with pytest.raises(TypeError, match="not a cache backend"):
        pkg.cache.make_backend(42)
    c = pkg.cache.make_backend(str(tmp_path / "small.sqlite"), capacity=2)
    assert c.capacity == 2
    c.put_many([((f"k{i}",), float(i)) for i in range(5)])
    assert len(c) == 2 and c.stats.evictions == 3
    c.close()


def _toy_step(w, x):
    return torch.sum(torch.tanh(x @ w))


def test_port_planners_share_sqlite_backend(tmp_path):
    """Two port planners on one sqlite file: entries minted by one are
    hits for the other, bitwise."""
    path = tmp_path / "fleet.sqlite"
    dests = ["T4", "V100", "tpu-v5e"]
    a = fleet.FleetPlanner(predictor=HabitatPredictor(device="cpu"),
                           fleet=dests, cache=path)
    b = fleet.FleetPlanner(predictor=HabitatPredictor(device="cpu"),
                           fleet=dests, cache=path)
    tr = OperationTracker("T4").track(_toy_step, torch.zeros(32, 16),
                                      torch.zeros(4, 32))
    first = a.predict(tr)
    assert a.stats.misses == 3 and a.engine_passes == 1
    second = b.predict(tr)
    assert b.stats.hits == 3 and b.stats.misses == 0
    assert b.engine_passes == 0 and second == first


KEYS = [("fp", "T4", ("HabitatPredictor", False, 3), "tok"),
        ("a" * 40, "tpu-v5e", (("x", 1), True, None), "t2"),
        ("fp2",)]
VALUES = [12.25, 1e-300, 2.0 / 3.0]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_sqlite_file_crosses_packages(writer, tmp_path):
    """A database written by either package reads back in the other:
    same table, key encoding and sealed digest (column ``d``)."""
    path = tmp_path / "x.sqlite"
    reader = "port" if writer == "reference" else "reference"
    w = PACKAGES[writer].cache.SqliteCache(path)
    w.put_many(list(zip(KEYS, VALUES)))
    w.close()
    r = PACKAGES[reader].cache.SqliteCache(path)
    assert r.get_many(KEYS) == VALUES
    assert r.get(("missing",)) is None
    assert (r.stats.hits, r.stats.misses) == (3, 1)
    r.close()


def test_sqlite_corrupt_row_is_a_miss_in_the_port(tmp_path):
    """``cache.corrupt`` flips a row's digest on read: the port's sqlite
    read path degrades it to a miss, as the reference's does."""
    c = cache.SqliteCache(tmp_path / "c.sqlite")
    c.put_many([(("k",), 1.5)])
    faults.arm("cache.corrupt:error")
    try:
        assert c.get(("k",)) is None
    finally:
        faults.disarm()
    assert c.get(("k",)) == 1.5
    c.close()


def test_make_backend_refuses_tcp_until_netcache():
    """Named for the refusal ``tcp://`` met until the port had a
    netcache; it now checks that ``tcp://`` builds the port's
    ``NetCache``, as the reference's spelling does (it connects on
    first use)."""
    from repro_torch.serve.netcache import NetCache
    backend = cache.make_backend("tcp://127.0.0.1:9")
    assert isinstance(backend, NetCache)
    assert backend.describe() == "netcache(tcp://127.0.0.1:9)"
    backend.close()


# ---------------------------------------------------------------------------
# faults, format_sweep, the CI key
# ---------------------------------------------------------------------------
SPECS = ["netcache.get_many:delay=200ms,p=0.3;engine.pass:error,p=0.1",
         "cache.corrupt:error", "router.forward:hang=1.5s,p=1.0",
         " a:delay=2 ; b:error,delay=10ms ", ""]
BAD_SPECS = ["nocolon", "a:", "a:p=0.5", "a:error,p=2", "a:bogus"]


def _fields(points):
    return {k: (v.point, v.p, v.delay_s, v.error, v.hang_s,
                v.rng.random()) for k, v in points.items()}


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_agrees(spec):
    assert _fields(faults.parse_spec(spec, seed=3)) == \
        _fields(ref_faults.parse_spec(spec, seed=3))


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_spec_refuses_alike(spec):
    with pytest.raises(ValueError) as port_err:
        faults.parse_spec(spec)
    with pytest.raises(ValueError) as ref_err:
        ref_faults.parse_spec(spec)
    assert str(port_err.value) == str(ref_err.value)


def test_format_sweep_same_string():
    rng = np.random.default_rng(0)
    names = sorted(devices.all_devices())
    labels = ["resnet50", "gnmt-b64", "t"]
    times = [{n: float(v) for n, v in zip(names, rng.uniform(0.1, 90, 15))}
             for _ in labels]
    times[2].pop(names[0])
    for top in (1, 3, 5):
        assert fleet.format_sweep(labels, times, top) == \
            ref_fleet.format_sweep(labels, times, top)


def test_ci_cache_key_equals_the_reference():
    assert artifacts.ci_cache_key() == ref_artifacts.ci_cache_key()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.artifacts", "--ci-key"],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT),
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == ref_artifacts.ci_cache_key()
