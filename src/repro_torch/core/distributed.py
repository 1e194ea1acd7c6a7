"""Beyond-paper extension: distributed iteration-time prediction.

A copy of ``repro.core.distributed`` on the port's traces, device specs
and predictors.

Paper Sec. 6.1.1 leaves multi-GPU/multi-pod prediction to future work,
noting that it reduces to (i) per-device compute time — which Habitat
provides — plus (ii) communication time and (iii) compute/communication
overlap.  We implement exactly that decomposition for the meshes this
framework targets:

  * compute: the Habitat-predicted single-device time of the *per-device*
    shard of the step (the caller traces the per-device program, or we
    scale a global trace by the mesh's parallel degrees),
  * collectives: ring model per axis —
      all_reduce(bytes)     = 2 (n-1)/n * bytes / link_bw
      all_gather(bytes)     =   (n-1)/n * bytes / link_bw
      reduce_scatter(bytes) =   (n-1)/n * bytes / link_bw
      all_to_all(bytes)     =   (n-1)/n * bytes / link_bw / n
  * overlap: data-parallel gradient reduction overlaps with the backward
    pass; we model the step as
      t = compute + max(0, collective - overlap_frac * compute).

The reference's dry-run prices its collective term with the same ring
model.  The port's sharding (``repro_torch.parallel``) is the plan whose
``comm_volumes`` feed ``MeshPlan``; its dry run
(``repro_torch.launch.dryrun``) reads the traced per-device graph where
the reference reads XLA's HLO.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core import devices
from repro_torch.core.devices import DeviceSpec
from repro_torch.core.trace import TrackedTrace


@dataclasses.dataclass
class MeshPlan:
    """Parallel degrees + per-step communication volumes (bytes, global)."""
    data: int = 1
    model: int = 1
    pod: int = 1
    grad_bytes: float = 0.0          # DP gradient all-reduce volume
    weight_gather_bytes: float = 0.0  # FSDP param all-gather volume
    tp_activation_bytes: float = 0.0  # TP activation all-reduce volume
    ep_alltoall_bytes: float = 0.0    # MoE token all-to-all volume
    overlap_frac: float = 0.8         # fraction of compute that can hide comm

    @property
    def n_devices(self) -> int:
        return self.data * self.model * self.pod


def _ring_ms(bytes_: float, n: int, link_bw: float, links: int,
             kind: str) -> float:
    if n <= 1 or bytes_ <= 0 or link_bw <= 0:
        return 0.0
    bw = link_bw * max(links, 1)
    frac = (n - 1) / n
    if kind == "all_reduce":
        return 2.0 * frac * bytes_ / bw * 1e3
    if kind == "all_to_all":
        return frac * bytes_ / bw / n * 1e3
    return frac * bytes_ / bw * 1e3  # all_gather / reduce_scatter


def predict_collective_ms(plan: MeshPlan, dev: DeviceSpec,
                          inter_pod_bw: Optional[float] = None) -> Dict[str, float]:
    """Per-collective-class times (ms) on the given device's fabric."""
    lbw, links = dev.link_bandwidth, dev.num_links
    out = {
        "grad_all_reduce": _ring_ms(plan.grad_bytes, plan.data, lbw, links,
                                    "all_reduce"),
        "weight_all_gather": _ring_ms(plan.weight_gather_bytes, plan.data,
                                      lbw, links, "all_gather"),
        "tp_all_reduce": _ring_ms(plan.tp_activation_bytes, plan.model, lbw,
                                  links, "all_reduce"),
        "ep_all_to_all": _ring_ms(plan.ep_alltoall_bytes, plan.model, lbw,
                                  links, "all_to_all"),
    }
    if plan.pod > 1:
        # Cross-pod reduction over DCN (slower than ICI).
        dcn = inter_pod_bw if inter_pod_bw is not None else lbw / 8.0
        out["pod_all_reduce"] = _ring_ms(plan.grad_bytes, plan.pod, dcn, 1,
                                         "all_reduce")
    return out


@dataclasses.dataclass
class DistributedPrediction:
    compute_ms: float
    collective_ms: float
    exposed_collective_ms: float
    step_ms: float
    per_collective: Dict[str, float]

    @property
    def comm_fraction(self) -> float:
        return self.collective_ms / max(self.step_ms, 1e-12)


def predict_step(per_device_trace: TrackedTrace, dest: str, plan: MeshPlan,
                 predictor=None, inter_pod_bw: Optional[float] = None,
                 device=None) -> DistributedPrediction:
    """Predict the distributed step time on ``dest`` for this mesh plan.

    ``per_device_trace`` must be the trace of the *per-device* program (e.g.
    traced at local batch = global_batch / (data*pod) with TP-sharded
    weights), measured on its origin device."""
    dev = devices.get(dest)
    predicted = per_device_trace.to_device(dest, predictor=predictor)
    compute_ms = predicted.run_time_ms
    per_coll = predict_collective_ms(plan, dev, inter_pod_bw)
    collective_ms = sum(per_coll.values())
    exposed = max(0.0, collective_ms - plan.overlap_frac * compute_ms)
    return DistributedPrediction(
        compute_ms=compute_ms, collective_ms=collective_ms,
        exposed_collective_ms=exposed, step_ms=compute_ms + exposed,
        per_collective=per_coll)
