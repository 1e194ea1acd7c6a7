"""The port stands alone: no module of ``repro_torch`` (nor the repo's
``chip_smoke.py``, nor the port's ``examples/torch/*.py``) imports
``jax`` or the reference package ``repro``."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def _port_modules():
    import repro_torch
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def test_port_has_the_slice_modules():
    names = set(_port_modules())
    for mod in ("core.integrity", "core.devices", "core.costmodel",
                "core.trace", "core.simulator", "core.wave_scaling",
                "core.dataset", "core.mlp", "core.batched",
                "core.predictor", "core.cost", "serve.cache",
                "serve.fleet", "kernels.fused_mlp_score", "kernels.build",
                "kernels.flash_attention", "kernels.ssd", "models.config",
                "models.layers", "models.attention", "models.ssm",
                "models.transformer", "models.convert", "configs",
                "configs.qwen3_0_6b", "configs.mamba2_130m", "serve.engine",
                "launch.serve", "core.artifacts", "kernels.fused_mlp",
                "core.frontier", "serve.faults", "core.calibration",
                "models.evalzoo", "serve.admission", "serve.optimizer",
                "serve.snapshot", "serve.service", "serve.http",
                "serve.aserver", "serve.netcache", "serve.router",
                "models.moe", "configs.glm4_9b", "configs.minitron_4b",
                "configs.gemma3_1b", "configs.granite_moe_3b_a800m",
                "configs.dbrx_132b", "configs.zamba2_2_7b",
                "configs.internvl2_2b", "configs.musicgen_medium",
                "train", "train.optim", "train.data", "train.train_step",
                "train.checkpoint", "train.compression", "train.trainer",
                "core.distributed", "launch.train", "parallel",
                "parallel.ctx", "parallel.sharding", "launch.mesh",
                "launch.specs", "launch.hlo_analysis", "launch.dryrun"):
        assert f"repro_torch.{mod}" in names


def _load(path: Path) -> str:
    return ("import importlib.util; "
            "spec = importlib.util.spec_from_file_location("
            f"{path.stem!r}, {str(path)!r}); "
            "mod = importlib.util.module_from_spec(spec); "
            "spec.loader.exec_module(mod)")


@pytest.mark.parametrize("target", ["package", "chip_smoke", "examples"])
def test_imports_pull_in_neither_jax_nor_reference(target):
    if target == "package":
        imports = "; ".join(f"import {m}" for m in _port_modules())
    elif target == "chip_smoke":
        imports = _load(ROOT / "chip_smoke.py")
    else:
        examples = sorted((ROOT / "examples" / "torch").glob("*.py"))
        assert len(examples) == 7
        imports = "; ".join(_load(p) for p in examples)
    code = (f"import sys; sys.path.insert(0, {str(SRC)!r}); {imports}; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')); print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout + proc.stderr
