"""Port parity: distributed step prediction (``repro_torch.core.
distributed``) against ``repro.core.distributed``.

The same trace document (each golden trace, and a training step of the
qwen3 smoke config tracked by the port with its flash-attention ops)
decodes in both packages; ``predict_collective_ms`` and ``predict_step``
under data-parallel, model-parallel, MoE and cross-pod plans agree within
rel 1e-12 with the MLP-free predictors, whose analytical paths run the
same float64 arithmetic in both."""

import json
from pathlib import Path

import pytest
import torch

from repro.core import HabitatPredictor as RefPredictor
from repro.core import devices as ref_devices
from repro.core import distributed as ref_dist
from repro.core.trace import TrackedTrace as RefTrace
from repro_torch.configs import get_config
from repro_torch.core import distributed
from repro_torch.core import devices
from repro_torch.core.predictor import HabitatPredictor
from repro_torch.core.trace import OperationTracker, TrackedTrace
from repro_torch.models.config import smoke_config
from repro_torch.train.data import SyntheticTokens
from repro_torch.train.train_step import init_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = sorted((ROOT / "tests" / "golden").glob("*.json"))
REL = 1e-12
PLANS = {
    "dp8": dict(data=8, grad_bytes=1.2e9),
    "fsdp-tp": dict(data=4, model=2, grad_bytes=3e8,
                    weight_gather_bytes=6e8, tp_activation_bytes=2e7),
    "moe": dict(data=2, model=4, grad_bytes=1e8, ep_alltoall_bytes=5e7),
    "pod": dict(data=4, pod=2, grad_bytes=2e9, overlap_frac=0.5),
}
DESTS = ["V100", "T4", "tpu-v5e", "trainium2"]


def _tracked_doc():
    cfg = smoke_config(get_config("qwen3-0.6b"))
    state = init_state(cfg, 0, device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in SyntheticTokens(cfg, 2, 16).batch_at(0).items()}
    trace = OperationTracker("cpu-host").track(make_train_step(cfg), state,
                                               batch, label="qwen3-smoke")
    assert any(op.name == "repro_torch::flash_attention"
               for op in trace.ops)
    return trace.to_dict()


def _docs():
    docs = {p.stem: json.loads(p.read_text())["trace"] for p in GOLDEN}
    docs["tracked"] = _tracked_doc()
    return docs


@pytest.fixture(scope="module")
def traces():
    return {name: (RefTrace.from_dict(doc), TrackedTrace.from_dict(doc))
            for name, doc in _docs().items()}


def _close(a, b):
    assert a == pytest.approx(b, rel=REL, abs=1e-300)


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_collective_times_match_reference(plan):
    for dest, dcn in [(d, None) for d in DESTS] + [("tpu-v5e", 5e9)]:
        got = distributed.predict_collective_ms(
            distributed.MeshPlan(**PLANS[plan]), devices.get(dest),
            inter_pod_bw=dcn)
        want = ref_dist.predict_collective_ms(
            ref_dist.MeshPlan(**PLANS[plan]), ref_devices.get(dest),
            inter_pod_bw=dcn)
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k])


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_predict_step_matches_reference(traces, plan):
    ref_pred, pred = RefPredictor(), HabitatPredictor(device="cpu")
    for name, (ref_trace, trace) in traces.items():
        for dest in DESTS:
            got = distributed.predict_step(
                trace, dest, distributed.MeshPlan(**PLANS[plan]),
                predictor=pred)
            want = ref_dist.predict_step(
                ref_trace, dest, ref_dist.MeshPlan(**PLANS[plan]),
                predictor=ref_pred)
            for field in ("compute_ms", "collective_ms",
                          "exposed_collective_ms", "step_ms",
                          "comm_fraction"):
                _close(getattr(got, field), getattr(want, field))
            assert set(got.per_collective) == set(want.per_collective)


def test_mesh_plan_counts_devices():
    assert distributed.MeshPlan(data=4, model=2, pod=2).n_devices == 16
    assert distributed.MeshPlan().n_devices == 1
    zero = distributed.predict_collective_ms(distributed.MeshPlan(),
                                             devices.get("V100"))
    assert set(zero.values()) == {0.0}
