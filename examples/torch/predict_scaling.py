"""Beyond-paper example: predict DISTRIBUTED step time on a 256-device pod.

    PYTHONPATH=src python examples/torch/predict_scaling.py [--device cpu]

Tracks the per-device training step of a reduced model on the PyTorch
port, then combines the Habitat compute prediction with the ring-model
collective estimate (paper Sec. 6.1.1 future work, ``core/distributed``)
for a 16x16 mesh, and for two such pods.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import torch

from repro_torch.configs import get_config
from repro_torch.core import OperationTracker
from repro_torch.core.devices import torch_device
from repro_torch.core.distributed import MeshPlan, predict_step
from repro_torch.core.predictor import default_predictor
from repro_torch.models.config import smoke_config
from repro_torch.train.optim import adamw
from repro_torch.train.train_step import init_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch_device(args.device)

    cfg = smoke_config(get_config("qwen3-0.6b"))
    optimizer = adamw()
    state = init_state(cfg, 0, optimizer, device=device)
    step = make_train_step(cfg, optimizer)
    # per-device shard of a (4096-global / 256-device) batch
    batch = {"tokens": torch.ones((16, 128), dtype=torch.int32,
                                  device=device),
             "labels": torch.ones((16, 128), dtype=torch.int32,
                                  device=device)}
    trace = OperationTracker("cpu-host").track(step, state, batch)
    predictor = default_predictor(device=device)

    param_bytes = sum(p.numel() * p.element_size()
                      for p in state.params.parameters())
    plan = MeshPlan(data=16, model=16,
                    grad_bytes=param_bytes,            # reduce per step
                    weight_gather_bytes=2 * param_bytes,  # fwd+bwd FSDP
                    tp_activation_bytes=batch["tokens"].numel()
                    * cfg.d_model * 4)
    out = {}
    for dest in ["tpu-v5e", "tpu-v5p", "trainium2"]:
        out[dest] = predict_step(trace, dest, plan, predictor=predictor)
        o = out[dest]
        print(f"{dest:<10} compute {o.compute_ms:8.2f}ms  "
              f"collectives {o.collective_ms:8.2f}ms "
              f"(exposed {o.exposed_collective_ms:6.2f}ms)  "
              f"step {o.step_ms:8.2f}ms  "
              f"comm fraction {o.comm_fraction:.0%}")

    plan2 = MeshPlan(data=16, model=16, pod=2, grad_bytes=param_bytes,
                     weight_gather_bytes=2 * param_bytes)
    two = predict_step(trace, "tpu-v5e", plan2, predictor=predictor)
    print(f"\n2-pod (512 devices, DCN cross-pod): step {two.step_ms:.2f}ms, "
          f"per-collective: "
          f"{ {k: round(v, 2) for k, v in two.per_collective.items()} }")
    return out, two


if __name__ == "__main__":
    main()
