"""Port parity: MLP training, the artifact store and the default predictor.

The same inputs, made with numpy, go through the reference's training
pieces and the port's on the CPU:
- ``Dataset.split`` draws the same indices;
- ``male_loss`` and ``mape_loss`` agree at fp32 rounding (rtol 1e-6);
- one Adam step from the same state (parameters, moments, step count)
  gives the same loss and parameters to 1e-6: the port's ``AdamW`` is the
  reference's hand-written update;
- a whole small ``train`` from the reference's initial parameters ends at
  the same test MAPE (rtol 1e-4) and test predictions (rtol 2e-4); the
  tolerance covers ReLU units that sit within fp32 rounding of zero and
  switch in one framework but not the other, after which Adam's
  normalized step moves the weights they feed by up to the learning rate;
- artifact keys and paths are equal, and each package loads the other's
  sealed artifacts without training;
- the default set trained on the CPU at seeds 0-2 stays within the band
  that ``chip_smoke.py`` holds the card's training to.
"""

import dataclasses
import functools
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import artifacts as ref_artifacts
from repro.core import cost as ref_cost
from repro.core import dataset as ref_dataset
from repro.core import devices as ref_devices
from repro.core import mlp as ref_mlp
from repro.core import predictor as ref_predictor
from repro.core.trace import TrackedTrace as RefTrace
from repro_torch.core import artifacts, cost, integrity
from repro_torch.core import devices as pt_devices
from repro_torch.core import dataset as pt_dataset
from repro_torch.core import mlp as pt_mlp
from repro_torch.core import predictor as pt_predictor
from repro_torch.core.predictor import HabitatPredictor
from repro_torch.core.trace import TrackedTrace
from test_torch_engine import DEVS, VARYING_KINDS, carried_mlps

GOLDEN_FILES = sorted((Path(__file__).resolve().parent / "golden")
                      .glob("*.json"))
# chip_smoke.py's constants (importing the script runs nothing)
_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
CHIP_SMOKE = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(CHIP_SMOKE)
TINY = dict(hidden_layers=1, hidden_size=16, epochs=2, batch_size=32)


def _ref_cfg(**kw):
    return ref_mlp.MLPConfig(**kw)


def _pt_cfg(**kw):
    return pt_mlp.MLPConfig(**kw)


def _batch(seed, n=64, features=13):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, features)).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


def _pt_params(np_params):
    return [(torch.tensor(np.asarray(w)), torch.tensor(np.asarray(b)))
            for w, b in np_params]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("frac", [0.8, 0.5])
def test_split_matches_reference(seed, frac):
    ref = ref_dataset.build_dataset("conv2d", 60, device_names=["T4", "P100"])
    port = pt_dataset.build_dataset("conv2d", 60,
                                    device_names=["T4", "P100"])
    for r, p in zip(ref.normalized().split(frac, seed),
                    port.normalized().split(frac, seed)):
        np.testing.assert_array_equal(r.x, p.x)
        np.testing.assert_array_equal(r.y, p.y)
        np.testing.assert_array_equal(r.feature_mean, p.feature_mean)


@pytest.mark.parametrize("loss", ["male_loss", "mape_loss"])
def test_losses_match_reference(loss):
    params = [(np.asarray(w), np.asarray(b)) for w, b in
              ref_mlp.init_params(_ref_cfg(in_features=13, hidden_layers=2,
                                           hidden_size=32))]
    x, y = _batch(1)
    y = np.exp(y) if loss == "mape_loss" else y
    want = float(getattr(ref_mlp, loss)(
        [(jnp.asarray(w), jnp.asarray(b)) for w, b in params],
        jnp.asarray(x), jnp.asarray(y)))
    got = float(getattr(pt_mlp, loss)(_pt_params(params),
                                      torch.from_numpy(x),
                                      torch.from_numpy(y)))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("t", [1, 2, 3])
def test_one_adam_step_matches_reference(t):
    """Step t of the reference's ``_train_step`` and of the port's, each
    from the reference's state after t - 1 steps on the same batch."""
    kw = dict(in_features=13, hidden_layers=2, hidden_size=64)
    params = ref_mlp.init_params(_ref_cfg(**kw))
    m, v = ref_mlp._adam_init(params)
    x, logy = _batch(2)
    xj, lj = jnp.asarray(x), jnp.asarray(logy)
    lr, wd = 5e-4, 1e-4

    def ref_step(params, m, v, step):
        return ref_mlp._train_step(params, m, v, xj, lj, jnp.float32(lr),
                                   jnp.float32(wd), jnp.float32(step))

    for step in range(1, t):
        params, m, v, _ = ref_step(params, m, v, step)
    port = [(w.requires_grad_(), b.requires_grad_())
            for w, b in _pt_params(params)]
    opt = pt_mlp._optimizer(port, _pt_cfg(weight_decay=wd, **kw))
    if t > 1:
        for (w, b), (mw, mb), (vw, vb) in zip(port, m, v):
            for p, mp, vp in ((w, mw, vw), (b, mb, vb)):
                opt.state[p] = {"step": torch.tensor(float(t - 1)),
                                "exp_avg": torch.tensor(np.asarray(mp)),
                                "exp_avg_sq": torch.tensor(np.asarray(vp))}
    new, _, _, want_loss = ref_step(params, m, v, t)
    loss = pt_mlp._train_step(port, opt, torch.from_numpy(x),
                              torch.from_numpy(logy), lr)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-6)
    for (w, b), (rw, rb) in zip(port, new):
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(rw),
                                   atol=1e-6)
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(rb),
                                   atol=1e-6)


def test_chained_steps_track_the_reference():
    """Three steps in a row from the same start: the losses agree to 1e-5
    (state differences of fp32 rounding carry from step to step)."""
    kw = dict(in_features=13, hidden_layers=2, hidden_size=64)
    params = ref_mlp.init_params(_ref_cfg(**kw))
    port = [(w.requires_grad_(), b.requires_grad_())
            for w, b in _pt_params(params)]
    opt = pt_mlp._optimizer(port, _pt_cfg(**kw))
    m, v = ref_mlp._adam_init(params)
    x, logy = _batch(0)
    for t in range(1, 4):
        params, m, v, want = ref_mlp._train_step(
            params, m, v, jnp.asarray(x), jnp.asarray(logy),
            jnp.float32(5e-4), jnp.float32(1e-4), jnp.float32(t))
        got = pt_mlp._train_step(port, opt, torch.from_numpy(x),
                                 torch.from_numpy(logy), 5e-4)
        assert float(got) == pytest.approx(float(want), rel=1e-5)


@pytest.mark.parametrize("batch_size", [64, 48])
def test_whole_train_matches_reference(monkeypatch, batch_size):
    """bmm on 200 configurations x (T4, V100), 2 x 64, 5 epochs: 320
    training rows, so batch 48 ends each epoch on a short batch."""
    kw = dict(hidden_layers=2, hidden_size=64, epochs=5,
              batch_size=batch_size)
    ds = ref_dataset.build_dataset("bmm", 200, device_names=["T4", "V100"])
    pds = pt_dataset.build_dataset("bmm", 200, device_names=["T4", "V100"])
    ref = ref_mlp.train(ds, _ref_cfg(**kw))
    init = [(np.asarray(w), np.asarray(b)) for w, b in
            ref_mlp.init_params(_ref_cfg(in_features=13, **kw))]
    monkeypatch.setattr(pt_mlp, "init_params",
                        lambda cfg, device=None: _pt_params(init))
    port = pt_mlp.train(pds, _pt_cfg(**kw), device="cpu")
    assert port.cfg == pt_mlp.MLPConfig(in_features=13, **kw)
    assert port.test_mape == pytest.approx(ref.test_mape, rel=1e-4)
    test_x = ds.split(0.8, seed=0)[1].x
    np.testing.assert_allclose(port.predict_ms(test_x, device="cpu"),
                               ref.predict_ms(test_x), rtol=2e-4)
    np.testing.assert_array_equal(port.feature_mean, ref.feature_mean)


def test_train_is_deterministic_and_seeded():
    ds = pt_dataset.build_dataset("linear", 40, device_names=["T4"])
    a = pt_mlp.train(ds, _pt_cfg(**TINY), device="cpu")
    b = pt_mlp.train(ds, _pt_cfg(**TINY), device="cpu")
    c = pt_mlp.train(ds, _pt_cfg(seed=1, **TINY), device="cpu")
    for (wa, ba), (wb, bb) in zip(a.params, b.params):
        np.testing.assert_array_equal(wa, wb)
        np.testing.assert_array_equal(ba, bb)
    assert a.test_mape == b.test_mape
    assert not np.array_equal(a.params[0][0], c.params[0][0])


def test_entry_points_need_a_gpu_unless_given_cpu(monkeypatch):
    """``cuda`` is the default everywhere; without a GPU it raises rather
    than running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pt_predictor, "_DEFAULT", {})
    ds = pt_dataset.build_dataset("linear", 20, device_names=["T4"])
    model = pt_mlp.train(ds, _pt_cfg(**TINY), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.predict_ms(ds.x[:4])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_mlp.train(ds, _pt_cfg(**TINY))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_predictor.default_predictor()
    assert model.predict_ms(ds.x[:4], device="cpu").shape == (4,)


DEFAULT = ref_predictor.DEFAULT_MLP_CFG
WIDE = dataclasses.replace(DEFAULT, hidden_layers=6, hidden_size=512,
                           epochs=15)


@pytest.mark.parametrize("fleet", ["registry", "paper"])
@pytest.mark.parametrize("cfg", [DEFAULT, WIDE], ids=["default", "6x512"])
@pytest.mark.parametrize("kind", VARYING_KINDS)
def test_artifact_keys_match_reference(kind, cfg, fleet):
    names = None if fleet == "registry" else list(ref_devices.PAPER_GPUS)
    port_cfg = pt_mlp.MLPConfig(**dataclasses.asdict(cfg))
    assert artifacts.mlp_content_key(kind, port_cfg, 2000, names) == \
        ref_artifacts.mlp_content_key(kind, cfg, 2000, names)
    assert artifacts.artifact_path("a", kind, port_cfg, 2000, names) == \
        ref_artifacts.artifact_path("a", kind, cfg, 2000, names)
    assert pt_predictor.DEFAULT_MLP_CFG == pt_mlp.MLPConfig(
        **dataclasses.asdict(ref_predictor.DEFAULT_MLP_CFG))
    assert pt_predictor.DEFAULT_N_CONFIGS == ref_predictor.DEFAULT_N_CONFIGS
    assert pt_predictor.ARTIFACT_DIR == ref_predictor.ARTIFACT_DIR


def _refuse_training(*args, **kwargs):
    raise AssertionError("trained although the artifact was cached")


SMALL = dict(kinds=("linear", "bmm"), n_configs=30, device_names=["T4"])


def test_reference_artifacts_load_in_the_port(tmp_path, monkeypatch):
    ref = ref_predictor.train_mlps(cfg=_ref_cfg(**TINY), cache_dir=tmp_path,
                                   **SMALL)
    monkeypatch.setattr(pt_mlp, "train", _refuse_training)
    port = pt_predictor.train_mlps(cfg=_pt_cfg(**TINY), cache_dir=tmp_path,
                                   device="cpu", **SMALL)
    feats = ref_dataset.build_dataset("bmm", 10, device_names=["V100"]).x
    for kind in SMALL["kinds"]:
        assert port[kind].test_mape == ref[kind].test_mape
        assert port[kind].trainer == "repro"
        np.testing.assert_allclose(
            port[kind].predict_ms(feats, device="cpu"),
            ref[kind].predict_ms(feats), rtol=1e-5)


def test_port_artifacts_load_in_the_reference(tmp_path, monkeypatch):
    port = pt_predictor.train_mlps(cfg=_pt_cfg(**TINY), cache_dir=tmp_path,
                                   device="cpu", **SMALL)
    paths = sorted(tmp_path.glob("*.pkl"))
    assert len(paths) == 2
    assert [pt_mlp.TrainedMLP.load(p).trainer for p in paths] == \
        ["repro_torch"] * 2
    monkeypatch.setattr(ref_mlp, "train", _refuse_training)
    ref = ref_predictor.train_mlps(cfg=_ref_cfg(**TINY), cache_dir=tmp_path,
                                   **SMALL)
    feats = ref_dataset.build_dataset("linear", 10, device_names=["V100"]).x
    for kind in SMALL["kinds"]:
        np.testing.assert_allclose(
            ref[kind].predict_ms(feats),
            port[kind].predict_ms(feats, device="cpu"), rtol=1e-5)


def test_corrupt_artifact_is_counted_and_retrained(tmp_path, monkeypatch):
    kw = dict(cfg=_pt_cfg(**TINY), cache_dir=tmp_path, device="cpu",
              kinds=("linear",), n_configs=30, device_names=["T4"])
    first = pt_predictor.train_mlps(**kw)["linear"]
    (path,) = tmp_path.glob("linear_*.pkl")
    blob = bytearray(path.read_bytes())
    blob[-5] ^= 0xFF
    path.write_bytes(bytes(blob))
    trained = []
    orig = pt_mlp.train
    monkeypatch.setattr(pt_mlp, "train",
                        lambda *a, **k: trained.append(1) or orig(*a, **k))
    before = integrity.COUNTERS.stats()["corrupt_artifact"]
    again = pt_predictor.train_mlps(**kw)["linear"]
    assert integrity.COUNTERS.stats()["corrupt_artifact"] == before + 1
    assert trained == [1]
    loaded = pt_mlp.TrainedMLP.load(path)       # re-sealed on retraining
    for (wa, _), (wb, _), (wc, _) in zip(first.params, again.params,
                                         loaded.params):
        np.testing.assert_array_equal(wa, wb)
        np.testing.assert_array_equal(wb, wc)


def test_default_predictor_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(pt_predictor, "ARTIFACT_DIR", tmp_path)
    monkeypatch.setattr(pt_predictor, "DEFAULT_MLP_CFG", _pt_cfg(**TINY))
    monkeypatch.setattr(pt_predictor, "DEFAULT_N_CONFIGS", 20)
    monkeypatch.setattr(pt_predictor, "_DEFAULT", {})
    pred = pt_predictor.default_predictor(device="cpu")
    assert isinstance(pred, HabitatPredictor)
    assert pred.device == torch.device("cpu")
    assert sorted(pred.mlps) == sorted(VARYING_KINDS)
    assert len(list(tmp_path.glob("*_h1x16_e2_n20_*.pkl"))) == 4
    assert pt_predictor.default_predictor(device="cpu") is pred
    fresh = pt_predictor.default_predictor(force_retrain=True, device="cpu")
    assert fresh is not pred
    for kind in VARYING_KINDS:
        np.testing.assert_array_equal(fresh.mlps[kind].params[0][0],
                                      pred.mlps[kind].params[0][0])


@pytest.mark.parametrize("path", GOLDEN_FILES, ids=lambda p: p.stem)
def test_default_predictor_behind_rank_and_to_device(path, monkeypatch):
    """``rank_devices(predictor=None)`` and ``TrackedTrace.to_device``
    fall back to the default predictor in both packages; with the same
    MLPs behind them they answer alike (rel 1e-5, float32 MLP rows)."""
    ref_mlps, pt_mlps = carried_mlps(seed=9)
    monkeypatch.setattr(ref_predictor, "_DEFAULT",
                        ref_predictor.HabitatPredictor(mlps=ref_mlps))
    monkeypatch.setattr(pt_predictor, "_DEFAULT", {
        "cpu": HabitatPredictor(mlps=pt_mlps, device="cpu")})
    doc = json.loads(path.read_text())["trace"]
    ref_trace, trace = RefTrace.from_dict(doc), TrackedTrace.from_dict(doc)
    for by in ("throughput", "cost"):
        want = ref_cost.rank_devices(ref_trace, 32, DEVS, by=by)
        got = cost.rank_devices(trace, 32, DEVS, by=by, device="cpu")
        assert [c.device for c in got] == [c.device for c in want]
        for g, w in zip(got, want):
            assert g.iter_ms == pytest.approx(w.iter_ms, rel=1e-5)
    for dest in ("V100", "tpu-v4", "cpu-host"):
        want = ref_trace.to_device(dest)
        got = trace.to_device(dest, device="cpu")
        assert got.origin_device == dest
        np.testing.assert_allclose([op.predicted_ms for op in got.ops],
                                   [op.predicted_ms for op in want.ops],
                                   rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _default_dataset(kind):
    """The default predictor's dataset of ``kind``: DEFAULT_N_CONFIGS
    configurations over the whole registry, as ``train_mlps`` builds it."""
    return pt_dataset.build_dataset(
        kind, pt_predictor.DEFAULT_N_CONFIGS,
        device_names=sorted(pt_devices.all_devices()))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", VARYING_KINDS)
def test_default_set_test_mape_within_the_chip_band(kind, seed):
    """``chip_smoke.py`` holds each kind's test MAPE, trained on the card
    at ``DEFAULT_MLP_CFG``, within ``TEST_MAPE_BAND`` of the reference's
    fixed seed-0 values (``REFERENCE_TEST_MAPE``, read from artifacts the
    JAX package trained).  The port trained on the CPU at seeds 0-2 stays
    inside that band, so the gate allows for the spread over seeds (run
    with ``-s`` to read the ratios)."""
    cfg = dataclasses.replace(pt_predictor.DEFAULT_MLP_CFG, seed=seed)
    model = pt_mlp.train(_default_dataset(kind), cfg, device="cpu")
    want = CHIP_SMOKE.REFERENCE_TEST_MAPE[kind]
    ratio = model.test_mape / want
    print(f"{kind} seed {seed}: test_mape {model.test_mape:.4f}, "
          f"{ratio:.3f} x the reference's {want}")
    assert ratio <= CHIP_SMOKE.TEST_MAPE_BAND


def test_train_refuses_tf32():
    """Training products are fp32 without TF32; a process set to TF32 gets
    an error, and its setting is left as it was."""
    ds = pt_dataset.build_dataset("linear", 20, device_names=["T4"])
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            pt_mlp.train(ds, _pt_cfg(**TINY), device="cpu")
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision("highest")
