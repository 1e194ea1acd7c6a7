"""The port's training CLI (``repro_torch.launch.train``) on the CPU.

``main`` with ``--device cpu --smoke`` tracks the real training step
(the optimizer update included), ranks the ``--predict-on`` devices for
it and trains a few steps, printing the reference's ranking table and
``done:`` line; ``--trace-out`` writes a trace that decodes to the same
ops.  The ranking here uses the MLP-free predictor in place of
``default_predictor``, which would train the default MLPs on the CPU
first (minutes; on the card chip_smoke.py loads them sealed).  Without
``--device`` the entry point and the trainer ask for ``cuda``: asserted
without running, with CUDA reported absent."""

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import predictor as predictor_mod
from repro_torch.core.predictor import HabitatPredictor
from repro_torch.core.trace import TrackedTrace
from repro_torch.launch import train as launch_train
from repro_torch.models.config import smoke_config
from repro_torch.train import checkpoint
from repro_torch.train.trainer import Trainer

DEVS = "V100,T4,P100,tpu-v5e"


@pytest.fixture
def analytic_predictor(monkeypatch):
    pred = HabitatPredictor(device="cpu")
    monkeypatch.setattr(predictor_mod, "default_predictor",
                        lambda force_retrain=False, device=None: pred)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-130m"])
def test_main_predicts_then_trains(arch, tmp_path, capsys,
                                   analytic_predictor):
    out_path = tmp_path / "trace.json"
    launch_train.main(["--device", "cpu", "--smoke", "--arch", arch,
                       "--steps", "3", "--batch", "2", "--seq", "16",
                       "--predict-on", DEVS, "--checkpoint-dir",
                       str(tmp_path / "ckpt"), "--trace-out",
                       str(out_path)])
    out = capsys.readouterr().out
    assert "Predicted training performance for" in out
    table = out[out.index("device"):].splitlines()
    assert {line.split()[0] for line in table[1:5]} == set(DEVS.split(","))
    assert "kernel launches:" in out
    assert "done: {'final_loss'" in out
    assert checkpoint.latest_step(str(tmp_path / "ckpt")) == 3
    trace = TrackedTrace.from_json(out_path.read_text())
    assert trace.origin_device == "cpu-host" and len(trace.ops) > 100
    assert all(op.measured_ms is not None and op.measured_ms > 0
               for op in trace.ops)


def test_predict_only_skips_training(tmp_path, capsys, analytic_predictor):
    launch_train.main(["--device", "cpu", "--smoke", "--batch", "2",
                       "--seq", "8", "--predict-on", "V100",
                       "--predict-only", "--checkpoint-dir",
                       str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert "V100" in out and "done:" not in out
    assert checkpoint.latest_step(str(tmp_path / "ckpt")) is None


def test_default_device_is_cuda(monkeypatch):
    assert launch_train.build_parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config(get_config("qwen3-0.6b"))
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        launch_train.main(["--smoke", "--steps", "1"])
