"""Throughput / cost-normalized-throughput analysis (paper Sec. 5.3).

A copy of ``repro.core.cost`` on the port's predictors.

Habitat's end use: given a predicted iteration time per candidate device,
compute training throughput (samples/s) and cost-normalized throughput
(samples/s/$) and *rank* the candidates — the case studies show the ranking
is what users act on, and it survives moderate prediction error.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.core import devices
from repro_torch.core.trace import TrackedTrace


def throughput(batch_size: int, iter_ms: float) -> float:
    """Training samples per second."""
    return batch_size / (iter_ms * 1e-3)


def cost_normalized_throughput(batch_size: int, iter_ms: float,
                               cost_per_hour: float) -> float:
    """Samples per dollar (samples/s divided by $/s).

    A price of 0.0 (free tier / hardware already owned) yields ``inf`` —
    a legitimately free device dominates every paid one on samples/$."""
    if cost_per_hour == 0.0:
        return float("inf")
    return throughput(batch_size, iter_ms) / (cost_per_hour / 3600.0)


@dataclasses.dataclass
class DeviceChoice:
    device: str
    iter_ms: float
    throughput: float
    cost_per_hour: Optional[float]
    cost_normalized: Optional[float]
    speedup_vs_origin: float


def rank_devices(trace: TrackedTrace, batch_size: int,
                 candidates: Sequence[str],
                 predictor, by: str = "throughput") -> List[DeviceChoice]:
    """Predict and rank candidate devices for the traced workload.

    ``by`` is either "throughput" (maximize speed) or "cost" (maximize
    samples/$) — the two user objectives from case studies 1 and 2.

    ``predictor`` (any of ``repro_torch.core.predictor``) is queried once
    for the whole candidate set through its ``predict_fleet`` grid."""
    candidates = list(candidates)   # may be a one-shot iterator
    origin_ms = trace.run_time_ms
    fleet_ms = predictor.predict_fleet(trace, candidates).as_dict()
    out: List[DeviceChoice] = []
    for name in candidates:
        spec = devices.get(name)
        ms = fleet_ms[name]
        tput = throughput(batch_size, ms)
        # `is not None`, not truthiness: a free device (0.0 $/hr) is
        # rentable and ranks at inf samples/$, it is not unpriced
        cn = (cost_normalized_throughput(batch_size, ms, spec.cost_per_hour)
              if spec.cost_per_hour is not None else None)
        out.append(DeviceChoice(
            device=name, iter_ms=ms, throughput=tput,
            cost_per_hour=spec.cost_per_hour, cost_normalized=cn,
            speedup_vs_origin=origin_ms / ms))
    if by == "cost":
        out.sort(key=lambda c: -(c.cost_normalized or 0.0))
    else:
        out.sort(key=lambda c: -c.throughput)
    return out


def format_ranking(choices: Sequence[DeviceChoice]) -> str:
    lines = [f"{'device':<12} {'iter ms':>9} {'samples/s':>10} "
             f"{'$/hr':>6} {'samples/$':>10} {'speedup':>8}"]
    for c in choices:
        lines.append(
            f"{c.device:<12} {c.iter_ms:>9.2f} {c.throughput:>10.1f} "
            f"{(f'{c.cost_per_hour:.2f}' if c.cost_per_hour is not None else '-'):>6} "
            f"{(f'{c.cost_normalized:.0f}' if c.cost_normalized is not None else '-'):>10} "
            f"{c.speedup_vs_origin:>7.2f}x")
    return "\n".join(lines)
