"""Port parity: checkpoints, the fault-tolerant trainer and gradient
compression (``repro_torch.train``), the cases of the reference's
``tests/test_fault_tolerance.py`` on the port, on the CPU.

Checkpoints round-trip exactly (bfloat16 included) and the latest wins; a
run that crashes and restarts from its checkpoint gives bitwise the
losses of the uninterrupted run (the CPU's sums are deterministic); an
async checkpoint completes; a slow step is flagged as a straggler.
Compression: the port's ``quantize_dequantize`` agrees with the
reference's within one float32 ulp of each block's scale (the scale
itself may differ by an ulp: ``max |x| / 127`` in another order), and
``wire_bytes`` is equal.  A reference checkpoint, carried into the port
by ``state_from_jax``, trains on to the reference's next losses within
rtol 1e-5 (fp32 sums in another order)."""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.config import smoke_config as ref_smoke_config
from repro.train import checkpoint as ref_checkpoint
from repro.train.compression import quantize_dequantize as ref_qdq
from repro.train.compression import wire_bytes as ref_wire_bytes
from repro.train.optim import adamw as ref_adamw
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig
from repro_torch.configs import get_config
from repro_torch.models.config import smoke_config
from repro_torch.models.convert import state_from_jax
from repro_torch.models import transformer as tfm
from repro_torch.train import checkpoint
from repro_torch.train.compression import (BLOCK, compress_grads,
                                           quantize_dequantize, wire_bytes)
from repro_torch.train.optim import adamw, sgd
from repro_torch.train.train_step import (TrainState, init_state,
                                          make_train_step)
from repro_torch.train.trainer import Trainer, TrainerConfig

QUIET = dict(log=lambda *_: None)


def _cfg():
    return smoke_config(get_config("qwen3-0.6b"))


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4)}}
    checkpoint.save(str(tmp_path), 7, tree)
    assert checkpoint.latest_step(str(tmp_path)) == 7
    restored, step = checkpoint.restore(str(tmp_path), tree)
    assert step == 7
    assert torch.equal(restored["a"], tree["a"])
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])


def test_checkpoint_latest_wins(tmp_path):
    tree = {"x": torch.zeros(3)}
    checkpoint.save(str(tmp_path), 1, {"x": torch.ones(3)})
    checkpoint.save(str(tmp_path), 5, {"x": torch.full((3,), 5.0)})
    restored, step = checkpoint.restore(str(tmp_path), tree)
    assert step == 5
    assert torch.equal(restored["x"], torch.full((3,), 5.0))


def test_train_state_roundtrip_keeps_dtypes_and_grad(tmp_path):
    """A bfloat16 model's state (float32 moments after a clipped step)
    comes back bit for bit into a fresh state (whose moments are still
    bfloat16), its parameters requiring grad; a model of another shape
    is refused."""
    cfg = dataclasses.replace(_cfg(), param_dtype="bfloat16")
    state = init_state(cfg, 0, adamw(), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             tfm_batch(cfg).items()}
    state, _ = make_train_step(cfg)(state, batch)
    checkpoint.save(str(tmp_path), state.step, state)
    fresh = init_state(cfg, 1, adamw(), "cpu")
    restored, step = checkpoint.restore(str(tmp_path), fresh)
    assert step == 1 and isinstance(restored, TrainState)
    assert restored.step == 1
    for (name, got), (_, want) in zip(restored.params.named_parameters(),
                                      state.params.named_parameters()):
        assert got.dtype == want.dtype and got.requires_grad, name
        assert torch.equal(got, want), name
    for which in ("m", "v"):
        for name, t in state.opt[which].items():
            assert fresh.opt[which][name].dtype == \
                dict(state.params.named_parameters())[name].dtype
            assert restored.opt[which][name].dtype == t.dtype, name
            assert torch.equal(restored.opt[which][name], t)
    wide = init_state(dataclasses.replace(cfg, d_model=32), 0, adamw(),
                      "cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore(str(tmp_path), wide)


def tfm_batch(cfg, b=2, s=8):
    from repro_torch.train.data import SyntheticTokens
    return SyntheticTokens(cfg, b, s).batch_at(0)


def test_crash_and_resume_is_bitwise_identical(tmp_path):
    """Train 10 steps straight vs crash-at-6 + restore: the same losses,
    bit for bit."""
    cfg = _cfg()
    tc = TrainerConfig(checkpoint_dir=str(tmp_path / "a"),
                       checkpoint_every=3, async_checkpoint=False,
                       max_steps=10, log_every=100)
    t1 = Trainer(cfg, 4, 16, tc, optimizer=adamw(lr=1e-3), seed=0,
                 device="cpu")
    stats1 = t1.run(10, **QUIET)

    class Crash(Exception):
        pass

    def injector(step):
        if step == 6 and not getattr(injector, "fired", False):
            injector.fired = True
            raise Crash()

    tc2 = dataclasses.replace(tc, checkpoint_dir=str(tmp_path / "b"))
    t2 = Trainer(cfg, 4, 16, tc2, optimizer=adamw(lr=1e-3), seed=0,
                 failure_injector=injector, device="cpu")
    with pytest.raises(Crash):
        t2.run(10, **QUIET)
    # "restart the job": new trainer instance, same checkpoint dir
    t3 = Trainer(cfg, 4, 16, tc2, optimizer=adamw(lr=1e-3), seed=0,
                 device="cpu")
    stats3 = t3.run(10, **QUIET)
    assert sorted(t3.losses) == list(range(6, 10))
    for step, loss in t3.losses.items():
        assert loss == t1.losses[step]
    assert stats3["final_loss"] == stats1["final_loss"]


def test_async_checkpoint_completes(tmp_path):
    cfg = _cfg()
    tc = TrainerConfig(checkpoint_dir=str(tmp_path), checkpoint_every=2,
                       async_checkpoint=True, max_steps=5, log_every=100)
    t = Trainer(cfg, 2, 8, tc, seed=1, device="cpu")
    t.run(5, **QUIET)
    assert checkpoint.latest_step(str(tmp_path)) == 5


def test_final_checkpoint_is_written_once(tmp_path, monkeypatch):
    """Saves at the periodic steps and the last one, that one once."""
    saved = []
    orig = checkpoint.save

    def save(directory, step, tree, blocking=True):
        saved.append(step)
        return orig(directory, step, tree, blocking)
    monkeypatch.setattr(checkpoint, "save", save)
    for steps, want in ((6, [3, 6]), (7, [3, 6, 7])):
        saved.clear()
        tc = TrainerConfig(checkpoint_dir=str(tmp_path / str(steps)),
                           checkpoint_every=3, max_steps=steps,
                           log_every=100)
        Trainer(_cfg(), 2, 8, tc, seed=1, device="cpu").run(steps, **QUIET)
        assert saved == want


def test_straggler_detection(tmp_path):
    cfg = _cfg()
    t = Trainer(cfg, 2, 8,
                TrainerConfig(max_steps=10, log_every=100,
                              straggler_factor=2.5,
                              checkpoint_dir=str(tmp_path),
                              checkpoint_every=1000),
                seed=2, device="cpu")
    inner = t.train_step
    calls = {"n": 0}

    def slow_step(state, batch):
        calls["n"] += 1
        if calls["n"] == 9:  # 0-indexed step 8
            # over 2.5 x any EWMA of the steps so far, however loaded the
            # host: the EWMA never exceeds the slowest step it took in
            # (every step but the first)
            time.sleep(max(0.5, 3 * max(t.step_times[1:])))
        return inner(state, batch)

    t.train_step = slow_step
    t.run(10, **QUIET)
    assert 8 in t.straggler_steps


@pytest.mark.parametrize("shape", [(64, 64), (3, 5000), (7,), (0,)])
def test_quantize_dequantize_matches_reference(shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 10.0)).astype(
        np.float32)
    got = quantize_dequantize(torch.from_numpy(x)).numpy()
    want = np.asarray(ref_qdq(jnp.asarray(x)))
    assert got.shape == want.shape and got.dtype == want.dtype
    flat = np.pad(np.abs(x).reshape(-1), (0, (-x.size) % BLOCK))
    scale = flat.reshape(-1, BLOCK).max(axis=1) / np.float32(127.0)
    ulp = np.repeat(np.spacing(scale), BLOCK)[:x.size].reshape(shape)
    assert np.all(np.abs(got - want) <= ulp)
    grads = {"w": torch.from_numpy(x), "b": {"c": torch.ones(4097)}}
    assert wire_bytes(grads) == ref_wire_bytes(
        {"w": jnp.asarray(x), "b": {"c": jnp.ones(4097)}})


def test_compression_parity_and_volume():
    g = np.random.default_rng(0).standard_normal((64, 64)).astype(np.float32)
    grads = {"w": torch.from_numpy(g)}
    comp, resid = compress_grads(grads)
    err = float(torch.max(torch.abs(comp["w"] - grads["w"])))
    assert err < float(torch.max(torch.abs(grads["w"]))) / 100
    raw, small = wire_bytes(grads)
    assert small < raw / 3
    # error feedback: residual equals quantization error
    np.testing.assert_allclose(resid["w"].numpy(),
                               (grads["w"] - comp["w"]).numpy(), atol=1e-6)


def test_compressed_training_converges():
    """SGD with int8-compressed grads still reduces loss."""
    cfg = _cfg()
    opt = sgd(lr=5e-2)
    state = init_state(cfg, 0, opt, "cpu")
    batch = {"tokens": torch.ones((4, 16), dtype=torch.int32),
             "labels": torch.ones((4, 16), dtype=torch.int32)}
    names = [n for n, _ in state.params.named_parameters()]
    losses = []
    for _ in range(10):
        loss, _ = tfm.loss_fn(state.params, cfg, batch)
        got = torch.autograd.grad(loss, list(state.params.parameters()))
        grads, _ = compress_grads(dict(zip(names, got)))
        with torch.no_grad():
            new, state.opt = opt.update(
                grads, state.opt, dict(state.params.named_parameters()),
                state.step)
        state = TrainState(state.params.map(lambda n, _: new[n]), state.opt,
                           state.step + 1)
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0]


def test_reference_checkpoint_trains_on_to_the_references_losses(tmp_path):
    """The reference trains 3 steps and checkpoints; its restored state,
    carried by ``state_from_jax``, takes the port's steps 3-4 to the
    reference's own losses there."""
    ref_cfg, cfg = ref_smoke_config(ref_get_config("qwen3-0.6b")), _cfg()
    tc = dict(checkpoint_every=3, async_checkpoint=False, log_every=100)
    ref = RefTrainer(ref_cfg, 4, 16, RefTrainerConfig(
        checkpoint_dir=str(tmp_path / "ref"), max_steps=3, **tc),
        optimizer=ref_adamw(lr=1e-3), seed=0)
    ref.run(3, **QUIET)
    restored, step = ref_checkpoint.restore(str(tmp_path / "ref"),
                                            ref.state)
    assert step == 3
    port = Trainer(cfg, 4, 16, TrainerConfig(
        checkpoint_dir=str(tmp_path / "port"), max_steps=5, **tc),
        optimizer=adamw(lr=1e-3), seed=0, device="cpu")
    port.state = state_from_jax(cfg, jax.tree.map(np.asarray, restored),
                                "cpu")
    losses = {}
    for s in (3, 4):
        batch = {k: torch.from_numpy(v)
                 for k, v in port.data.batch_at(s).items()}
        port.state, metrics = port.train_step(port.state, batch)
        losses[s] = float(metrics["loss"])
    assert port.state.step == 5
    want = _reference_losses(ref_cfg, restored)
    for s in (3, 4):
        np.testing.assert_allclose(losses[s], want[s], rtol=1e-5)


def _reference_losses(ref_cfg, state):
    from repro.train.data import SyntheticTokens as RefTokens
    from repro.train.train_step import make_train_step as ref_step
    step = jax.jit(ref_step(ref_cfg, ref_adamw(lr=1e-3)))
    data = RefTokens(ref_cfg, 4, 16, seed=0)
    out = {}
    for s in (3, 4):
        state, metrics = step(state, jax.tree.map(jnp.asarray,
                                                  data.batch_at(s)))
        out[s] = float(metrics["loss"])
    return out
