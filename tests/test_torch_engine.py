"""Port parity: the ragged engine and the predictor on the CPU.

The golden suite (3 traces x 3 configs x 15 devices at rel 1e-6) through
the port's scalar, fleet and ragged paths, and the cell-masked sweep
against the reference ``predict_sweep`` on the same seeded traces and
MLPs.  Inputs are built once (numpy seeds, reference decoder) and handed
to the port as trace documents, so both packages see identical data.

Shared helpers (``port_traces``, ``carried_mlps``) are imported by the
other ``test_torch_*`` files."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import HabitatPredictor as RefPredictor
from repro.core import batched as ref_batched
from repro.core import dataset as ref_dataset
from repro.core import devices as ref_devices
from repro.core import mlp as ref_mlp
from repro.core.trace import TrackedTrace as RefTrace
from repro_torch.core import batched, devices
from repro_torch.core import mlp as pt_mlp
from repro_torch.core.predictor import (FlopsRatioPredictor,
                                        HabitatPredictor, PaleoPredictor)
from repro_torch.core.trace import TrackedTrace
from test_sweep_properties import _make_stack

GOLDEN_FILES = sorted((Path(__file__).resolve().parent / "golden")
                      .glob("*.json"))
DEVS = sorted(devices.all_devices())
CONFIGS = {
    "default": {},
    "exact_wave": {"exact_wave": True},
    "model_overhead": {"model_overhead": True},
}
VARYING_KINDS = ("conv2d", "linear", "bmm", "recurrent")


def _golden(path):
    blob = json.loads(path.read_text())
    return blob, TrackedTrace.from_dict(blob["trace"])


def port_traces(ref_traces):
    """The reference traces as port traces (through the wire format)."""
    return [TrackedTrace.from_dict(t.to_dict()) for t in ref_traces]


def carried_mlps(hidden_layers: int = 2, hidden: int = 32, seed: int = 0,
                 kinds=VARYING_KINDS):
    """Random architecture-uniform MLPs in both packages, same numbers:
    (reference TrainedMLPs, port TrainedMLPs carried with from_numpy)."""
    rng = np.random.default_rng(seed)
    cfg_kw = dict(in_features=13, hidden_layers=hidden_layers,
                  hidden_size=hidden)
    ref, port = {}, {}
    for kind in kinds:
        sizes = [13] + [hidden] * hidden_layers + [1]
        params = [((rng.standard_normal((a, b)) * np.sqrt(2.0 / a))
                   .astype(np.float32),
                   (rng.standard_normal(b) * 0.1).astype(np.float32))
                  for a, b in zip(sizes[:-1], sizes[1:])]
        norm = ref_dataset.build_dataset(kind, 40,
                                         device_names=["T4"]).normalized()
        ref[kind] = ref_mlp.TrainedMLP(
            kind=kind, cfg=ref_mlp.MLPConfig(**cfg_kw),
            params=[(jnp.asarray(w), jnp.asarray(b)) for w, b in params],
            feature_mean=norm.feature_mean, feature_std=norm.feature_std)
        port[kind] = pt_mlp.TrainedMLP.from_numpy(
            kind, pt_mlp.MLPConfig(**cfg_kw), params, norm.feature_mean,
            norm.feature_std)
    return ref, port


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
@pytest.mark.parametrize("path", GOLDEN_FILES, ids=lambda p: p.stem)
def test_scalar_path_reproduces_golden(path, cfg_name):
    blob, trace = _golden(path)
    pred = HabitatPredictor(device="cpu", **CONFIGS[cfg_name])
    for dev in DEVS:
        got = pred.predict_trace_scalar(trace, dev).run_time_ms
        assert got == pytest.approx(blob["expected"][cfg_name][dev],
                                    rel=1e-6), (dev, cfg_name)


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
@pytest.mark.parametrize("path", GOLDEN_FILES, ids=lambda p: p.stem)
def test_fleet_path_reproduces_golden(path, cfg_name):
    blob, trace = _golden(path)
    pred = HabitatPredictor(device="cpu", **CONFIGS[cfg_name])
    totals = pred.predict_fleet(trace, DEVS).total_ms
    expected = [blob["expected"][cfg_name][d] for d in DEVS]
    np.testing.assert_allclose(totals, expected, rtol=1e-6)


@pytest.mark.parametrize("factor_cache", [True, False])
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_ragged_path_reproduces_golden(cfg_name, factor_cache):
    """One ragged sweep over all three traces (mixed origins) at once."""
    blobs, traces = zip(*[_golden(p) for p in GOLDEN_FILES])
    pred = HabitatPredictor(device="cpu", factor_cache=factor_cache,
                            **CONFIGS[cfg_name])
    totals = pred.predict_sweep(list(traces), DEVS).total_ms
    for i, blob in enumerate(blobs):
        expected = [blob["expected"][cfg_name][d] for d in DEVS]
        np.testing.assert_allclose(totals[i], expected, rtol=1e-6)


def _mask(seed: int, n_traces: int, p: float) -> np.ndarray:
    rng = np.random.default_rng(seed)
    m = rng.random((n_traces, len(DEVS))) < p
    m[~m.any(axis=1), 0] = True
    return m


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [3, 11])
def test_cell_mask_matches_reference(seed, cfg_name, warm):
    """Masked sweep == the reference's masked sweep on computed cells and
    NaN on the rest, with the factor cache cold or warm."""
    ref_traces = _make_stack(seed, 6)
    mask = _mask(seed, len(ref_traces), 0.5)
    kw = CONFIGS[cfg_name]
    ref = RefPredictor(**kw).predict_sweep(ref_traces, DEVS,
                                           cell_mask=mask)
    pred = HabitatPredictor(device="cpu", **kw)
    traces = port_traces(ref_traces)
    if warm:
        pred.predict_sweep(traces, DEVS)
    got = pred.predict_sweep(traces, DEVS, cell_mask=mask)
    op_ms = got.op_ms.numpy()
    op_mask = mask[got.arrays.trace_ids]
    np.testing.assert_allclose(op_ms[op_mask], ref.op_ms[op_mask],
                               rtol=1e-12)
    assert np.isnan(op_ms[~op_mask]).all()


@pytest.mark.parametrize("scorer", [None, "plain"])
@pytest.mark.parametrize("masked", [False, True])
def test_mlp_sweep_matches_reference(scorer, masked):
    """Carried MLPs: the port's sweep (per-kind forwards, or the fused
    plain scorer) against the reference's per-kind forwards, at the fp32
    summation-order tolerance."""
    ref_traces = _make_stack(5, 8)
    ref_mlps, pt_mlps = carried_mlps(seed=1)
    mask = _mask(5, len(ref_traces), 0.6) if masked else None
    ref = RefPredictor(mlps=ref_mlps).predict_sweep(ref_traces, DEVS,
                                                    cell_mask=mask)
    got = HabitatPredictor(mlps=pt_mlps, device="cpu").predict_sweep(
        port_traces(ref_traces), DEVS, scorer=scorer, cell_mask=mask)
    op_ms = got.op_ms.numpy()
    np.testing.assert_allclose(op_ms, ref.op_ms, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(got.total_ms, ref.total_ms, rtol=1e-5)


def test_fleet_with_mlps_matches_reference():
    ref_traces = _make_stack(9, 3)
    ref_mlps, pt_mlps = carried_mlps(seed=2)
    ref_pred = RefPredictor(mlps=ref_mlps)
    pred = HabitatPredictor(mlps=pt_mlps, device="cpu")
    for rt, pt in zip(ref_traces, port_traces(ref_traces)):
        np.testing.assert_allclose(pred.predict_fleet(pt, DEVS).total_ms,
                                   ref_pred.predict_fleet(rt, DEVS).total_ms,
                                   rtol=1e-5)


@pytest.mark.parametrize("cls", [FlopsRatioPredictor, PaleoPredictor])
def test_baseline_predictors_match_reference(cls):
    from repro.core import predictor as ref_predictor
    ref_traces = _make_stack(4, 3)
    ref = getattr(ref_predictor, cls.__name__)()
    port = cls(device="cpu")
    for rt, pt in zip(ref_traces, port_traces(ref_traces)):
        np.testing.assert_allclose(port.predict_fleet(pt, DEVS).total_ms,
                                   ref.predict_fleet(rt, DEVS).total_ms,
                                   rtol=1e-12)
    np.testing.assert_allclose(
        port.predict_sweep(port_traces(ref_traces), DEVS).total_ms,
        ref.predict_sweep(ref_traces, DEVS).total_ms, rtol=1e-12)


def test_sweep_rows_match_fleet_and_breakdown():
    traces = port_traces(_make_stack(6, 4))
    pred = HabitatPredictor(device="cpu")
    sweep = pred.predict_sweep(traces, DEVS)
    for i, trace in enumerate(traces):
        fleet = pred.predict_fleet(trace, DEVS)
        np.testing.assert_allclose(sweep.total_ms[i], fleet.total_ms,
                                   rtol=1e-12)
        # a sweep row keeps the stack's unified kinds: absent ones are 0
        row = sweep.row(i).breakdown("V100")
        want = fleet.breakdown("V100")
        assert {k: v for k, v in row.items() if k in want} == \
            pytest.approx(want, rel=1e-12)
        assert all(v == 0.0 for k, v in row.items() if k not in want)


def test_stack_cache_prefix_extend_matches_fresh_build():
    traces = port_traces(_make_stack(8, 5))
    batched.STACK_CACHE.clear()
    batched.stack_traces(traces[:3])
    extended = batched.stack_traces(traces)
    fresh = batched.stack_traces(traces, cache=False)
    assert batched.STACK_CACHE.stats()["extends"] == 1
    for field in ("offsets", "trace_ids", "measured_ms", "kind_ids",
                  "op_features"):
        np.testing.assert_array_equal(getattr(extended, field),
                                      getattr(fresh, field))
    assert batched.stack_traces(traces) is extended


def test_factor_cache_keys_include_device():
    traces = port_traces(_make_stack(12, 2))
    batched.WAVE_FACTOR_CACHE.clear()
    pred = HabitatPredictor(device="cpu")
    pred.predict_sweep(traces, DEVS)
    pred.predict_sweep(traces, DEVS)
    stats = batched.WAVE_FACTOR_CACHE.stats()
    assert stats["inserts"] == 1 and stats["hits"] == 1
    (key,) = [k for k, *_ in batched.WAVE_FACTOR_CACHE._data.items()]
    assert key[-1] == "cpu"


def test_cuda_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        HabitatPredictor()
    with pytest.raises(RuntimeError, match="cuda"):
        devices.torch_device("cuda")
    assert devices.torch_device("cpu").type == "cpu"


def test_registry_matches_reference():
    assert sorted(devices.all_devices()) == sorted(ref_devices.all_devices())
    for name, spec in devices.all_devices().items():
        ref = ref_devices.get(name)
        assert spec.feature_vector() == ref.feature_vector()
        assert spec.wave_size == ref.wave_size


def test_unmeasured_op_raises_like_reference():
    ref_traces = _make_stack(2, 1)
    doc = json.loads(GOLDEN_FILES[0].read_text())["trace"]   # alike-only
    doc["ops"][3]["measured_ms"] = None
    broken = [port_traces(ref_traces)[0], TrackedTrace.from_dict(doc)]
    with pytest.raises(ValueError, match="no origin measurement"):
        HabitatPredictor(device="cpu").predict_sweep(broken, DEVS)
    with pytest.raises(ValueError, match="no origin measurement"):
        HabitatPredictor(device="cpu").predict_fleet(broken[1], DEVS)
    with pytest.raises(ValueError, match="no origin measurement"):
        ref_batched.predict_sweep([ref_traces[0], RefTrace.from_dict(doc)],
                                  DEVS)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("model_overhead", [False, True])
def test_wave_scaling_vec_matches_reference(exact, model_overhead):
    """gamma_vec and the grid and flat spellings of wave scaling against
    the reference's numpy functions on one seeded stack."""
    from types import SimpleNamespace
    from repro.core import wave_scaling as ref_ws
    from repro_torch.core import wave_scaling as ws
    ref_stack = ref_batched.stack_traces(_make_stack(14, 5), cache=False)
    stack = batched.stack_traces(port_traces(_make_stack(14, 5)),
                                 cache=False)
    alike = ~ref_stack.kernel_varying
    ref_origin = ref_stack.alike_origin_arrays()
    ref_da = ref_devices.as_arrays(DEVS)
    sub = SimpleNamespace(intensity=ref_stack.intensity[alike],
                          bytes_accessed=ref_stack.bytes_accessed[alike])
    t_o = ref_stack.measured_ms[alike]
    want = ref_ws.scale_times_vec(t_o, sub, ref_origin, ref_da, exact=exact,
                                  model_overhead=model_overhead)
    cpu = torch.device("cpu")
    view, dv = stack.on(cpu), devices.as_arrays(DEVS).on(cpu)
    a = view.alike
    got = ws.scale_times_vec(view.measured_ms[a], view.intensity[a],
                             view.bytes_accessed[a], view.alike_origin, dv,
                             exact=exact, model_overhead=model_overhead)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13)
    np.testing.assert_allclose(
        ws.gamma_vec(view.intensity[a], dv.ridge_point).numpy(),
        ref_ws.gamma_vec(sub.intensity, ref_da.ridge_point), rtol=1e-15)
    r, c = np.nonzero(np.random.default_rng(0).random(want.shape) < 0.4)
    rt, ct = torch.as_tensor(r), torch.as_tensor(c)
    ov = view.alike_origin
    cells = SimpleNamespace(mem_bandwidth=ov.mem_bandwidth[rt],
                            clock_hz=ov.clock_hz[rt],
                            wave_size=ov.wave_size[rt],
                            overhead=ov.overhead[rt])
    flat = ws.scale_times_flat(view.measured_ms[a][rt],
                               view.intensity[a][rt],
                               view.bytes_accessed[a][rt], cells, dv, ct,
                               exact=exact, model_overhead=model_overhead)
    np.testing.assert_allclose(flat.numpy(), want[r, c], rtol=1e-13)
