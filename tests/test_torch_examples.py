"""The port's examples (``examples/torch/*.py``) with ``--device cpu``,
and the paper's Listing 1 through the port's ``Device`` beside the
reference's (``tests/test_system.py::test_listing1_workflow``).

Each example's ``main`` runs in this process, with the MLP-free
predictor standing in for ``default_predictor``, which would first train
the default MLPs on the CPU (minutes; on the card chip_smoke.py trains
them).  The port's trace decodes in the reference
(``TrackedTrace.from_json``), so both predictors answer for the same
ops: their predictions agree within rtol 1e-4 (the float32 engine of
each), and the quickstart's ranking is the reference's.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import Device as RefDevice
from repro.core import HabitatPredictor as RefPredictor
from repro.core import OperationTracker as RefTracker
from repro.core import cost as ref_cost
from repro.core.trace import TrackedTrace as RefTrace
from repro.models.config import smoke_config as ref_smoke
from repro.train.optim import adamw as ref_adamw
from repro.train.train_step import init_state as ref_init_state
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.configs import get_config
from repro_torch.core import Device, OperationTracker
from repro_torch.core import predictor as predictor_mod
from repro_torch.core.predictor import HabitatPredictor
from repro_torch.models.config import smoke_config
from repro_torch.train.optim import adamw
from repro_torch.train.train_step import init_state, make_train_step

EXAMPLES = Path(__file__).resolve().parents[1] / "examples" / "torch"
RTOL = 1e-4


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def analytic(monkeypatch):
    """The MLP-free predictor behind every ``default_predictor`` call."""
    pred = HabitatPredictor(device="cpu")

    def default(force_retrain=False, device=None):
        return pred
    monkeypatch.setattr(predictor_mod, "default_predictor", default)
    return default


def _run(name, analytic, monkeypatch, *extra):
    mod = _load(name)
    if hasattr(mod, "default_predictor"):
        monkeypatch.setattr(mod, "default_predictor", analytic)
    return mod.main(["--device", "cpu", *extra])


def test_device_names_are_the_references():
    ref = {k: v for k, v in vars(RefDevice).items() if k.isupper()}
    port = {k: v for k, v in vars(Device).items() if k.isupper()}
    assert len(ref) == 15
    assert port == dict(ref, H100_SXM="H100-SXM")


def test_quickstart_ranks_as_the_reference(analytic, monkeypatch, capsys):
    trace, ranking = _run("quickstart", analytic, monkeypatch)
    out = capsys.readouterr().out
    assert "measured iteration on cpu-host" in out
    assert "Ranked by throughput" in out
    assert trace.origin_device == Device.CPU_HOST
    ref = ref_cost.rank_devices(RefTrace.from_json(trace.to_json()), 4,
                                [c.device for c in ranking],
                                predictor=RefPredictor())
    assert [c.device for c in ranking] == [c.device for c in ref]
    for got, want in zip(ranking, ref):
        assert got.iter_ms == pytest.approx(want.iter_ms, rel=RTOL)


def test_listing1_beside_the_reference():
    """``test_listing1_workflow``'s steps in both packages, and the port's
    trace through both predictors."""
    cfg = ref_smoke(ref_get_config("qwen3-0.6b"))
    opt = ref_adamw()
    state = ref_init_state(cfg, jax.random.PRNGKey(0), opt)
    batch = {"tokens": jnp.ones((2, 16), jnp.int32),
             "labels": jnp.ones((2, 16), jnp.int32)}
    ref_trace = RefTracker(origin_device=RefDevice.CPU_HOST).track(
        ref_make_train_step(cfg, opt), state, batch)
    ref_pred = ref_trace.to_device(RefDevice.V100, predictor=RefPredictor())
    assert ref_pred.run_time_ms > 0
    assert len(ref_pred.ops) == len(ref_trace.ops)

    cfg = smoke_config(get_config("qwen3-0.6b"))
    opt = adamw()
    state = init_state(cfg, 0, opt, device="cpu")
    batch = {"tokens": torch.ones((2, 16), dtype=torch.int32),
             "labels": torch.ones((2, 16), dtype=torch.int32)}
    trace = OperationTracker(origin_device=Device.CPU_HOST).track(
        make_train_step(cfg, opt), state, batch)
    predicted = trace.to_device(Device.V100,
                                predictor=HabitatPredictor(device="cpu"))
    assert predicted.run_time_ms > 0
    assert len(predicted.ops) == len(trace.ops)
    across = RefTrace.from_json(trace.to_json()).to_device(
        RefDevice.V100, predictor=RefPredictor())
    assert predicted.run_time_ms == pytest.approx(across.run_time_ms,
                                                  rel=RTOL)


def test_gpu_selection(analytic, monkeypatch, capsys):
    by_speed, by_cost = _run("gpu_selection", analytic, monkeypatch)
    assert sorted(c.device for c in by_speed) == sorted(
        ["P100", "T4", "V100", "tpu-v5e", "trainium1"])
    assert by_speed[0].throughput >= by_speed[-1].throughput
    assert "samples/$" in capsys.readouterr().out


def test_fleet_rank(analytic, monkeypatch):
    by_speed, stats = _run("fleet_rank", analytic, monkeypatch)
    assert len(by_speed) >= 15
    assert stats.hits > 0


def test_predict_scaling(analytic, monkeypatch):
    out, two = _run("predict_scaling", analytic, monkeypatch)
    for o in list(out.values()) + [two]:
        assert o.step_ms >= o.compute_ms > 0


def test_serve_client(monkeypatch):
    results, cache = _load("serve_client").main(["--device", "cpu"])
    assert len(results) == 4
    assert cache["hits"] > 0


def test_sweep_grid(analytic, monkeypatch):
    times, stats = _run("sweep_grid", analytic, monkeypatch)
    assert len(times) == 3 and all(len(row) >= 15 for row in times)
    assert stats.hits > 0


def test_train_lm(capsys):
    stats, done = _load("train_lm").main(["--device", "cpu", "--steps", "4"])
    assert stats["final_loss"] == stats["final_loss"]     # finite
    assert len(done) == 6
    assert "served 6 requests" in capsys.readouterr().out
