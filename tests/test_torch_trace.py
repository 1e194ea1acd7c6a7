"""Port parity: the trace data model and wire format.

The PyTorch port (``repro_torch``) must decode every golden document to
the same fingerprint the reference froze, exchange trace documents with
the reference bitwise in both directions, and reject the same malformed
documents with ``TraceValidationError``."""

import json
import math
from pathlib import Path

import numpy as np
import pytest

from repro.core import dataset as ref_dataset
from repro.core import trace as ref_trace
from repro_torch.core import dataset as pt_dataset
from repro_torch.core import trace as pt_trace

GOLDEN_FILES = sorted((Path(__file__).resolve().parent / "golden")
                      .glob("*.json"))


def _seeded_ops(dataset_mod, seed: int):
    """Four kernel-varying kinds from one numpy seed, in either package."""
    ops = []
    for i, kind in enumerate(("conv2d", "linear", "bmm", "recurrent")):
        ops += dataset_mod.sample_ops(kind, 3, seed=seed + i)
    return ops


def test_golden_files_present():
    assert len(GOLDEN_FILES) == 3


@pytest.mark.parametrize("path", GOLDEN_FILES, ids=lambda p: p.stem)
def test_golden_decodes_to_frozen_fingerprint(path):
    blob = json.loads(path.read_text())
    trace = pt_trace.TrackedTrace.from_dict(blob["trace"])
    assert trace.fingerprint() == blob["fingerprint"]
    assert trace.to_dict() == blob["trace"]


@pytest.mark.parametrize("path", GOLDEN_FILES, ids=lambda p: p.stem)
def test_reference_document_decodes_bitwise_in_port(path):
    ref = ref_trace.TrackedTrace.from_dict(
        json.loads(path.read_text())["trace"])
    port = pt_trace.TrackedTrace.from_json(ref.to_json())
    assert port.fingerprint() == ref.fingerprint()
    assert port.to_json() == ref.to_json()
    assert port.run_time_ms == ref.run_time_ms
    for field in ("flops", "bytes_accessed", "measured_ms", "multiplicity",
                  "kind_ids", "op_features"):
        np.testing.assert_array_equal(getattr(port.to_arrays(), field),
                                      getattr(ref.to_arrays(), field))


@pytest.mark.parametrize("seed", [0, 7])
def test_port_document_decodes_bitwise_in_reference(seed):
    """Ops sampled and measured by the port, decoded by the reference."""
    port = pt_trace.TrackedTrace(ops=_seeded_ops(pt_dataset, seed),
                                 origin_device="V100",
                                 label=f"port-{seed}").measure()
    ref = ref_trace.TrackedTrace.from_json(port.to_json())
    assert ref.fingerprint() == port.fingerprint()
    assert ref.to_dict() == port.to_dict()


@pytest.mark.parametrize("seed", [1, 2])
def test_measure_simulate_matches_reference(seed):
    """The same seeded ops measured by each package's simulator."""
    ref = ref_trace.TrackedTrace(ops=_seeded_ops(ref_dataset, seed),
                                 origin_device="tpu-v5e").measure()
    port = pt_trace.TrackedTrace(ops=_seeded_ops(pt_dataset, seed),
                                 origin_device="tpu-v5e").measure()
    assert port.to_dict() == ref.to_dict()
    assert port.fingerprint() == ref.fingerprint()


def _valid_doc():
    return json.loads(GOLDEN_FILES[0].read_text())["trace"]


def _mutate(path, value):
    doc = _valid_doc()
    target = doc
    for key in path[:-1]:
        target = target[key]
    if value is _DELETE:
        del target[path[-1]]
    else:
        target[path[-1]] = value
    return doc


_DELETE = object()

MALFORMED = {
    "not-an-object": [1, 2, 3],
    "missing-ops": _mutate(("ops",), _DELETE),
    "ops-not-list": _mutate(("ops",), {"a": 1}),
    "origin-not-str": _mutate(("origin_device",), 3),
    "label-not-str": _mutate(("label",), ["x"]),
    "op-not-object": _mutate(("ops", 0), "op"),
    "op-missing-cost": _mutate(("ops", 0, "cost"), _DELETE),
    "nan-measured": _mutate(("ops", 0, "measured_ms"), math.nan),
    "negative-measured": _mutate(("ops", 0, "measured_ms"), -1.0),
    "string-flops": _mutate(("ops", 0, "cost", "flops"), "12"),
    "bool-multiplicity": _mutate(("ops", 0, "multiplicity"), True),
    "fractional-multiplicity": _mutate(("ops", 0, "multiplicity"), 1.5),
    "shape-not-list": _mutate(("ops", 0, "in_shapes"), [3]),
    "params-not-object": _mutate(("ops", 0, "params"), [1]),
}


@pytest.mark.parametrize("name", sorted(MALFORMED))
def test_malformed_documents_raise_in_both(name):
    doc = MALFORMED[name]
    with pytest.raises(ref_trace.TraceValidationError):
        ref_trace.TrackedTrace.from_dict(doc)
    with pytest.raises(pt_trace.TraceValidationError):
        pt_trace.TrackedTrace.from_dict(doc)


def test_invalid_json_and_op_cap_raise_in_both(monkeypatch):
    for mod in (ref_trace, pt_trace):
        with pytest.raises(mod.TraceValidationError):
            mod.TrackedTrace.from_json("{not json")
    monkeypatch.setenv("REPRO_TRACE_MAX_OPS", "2")
    doc = _valid_doc()
    for mod in (ref_trace, pt_trace):
        with pytest.raises(mod.TraceValidationError, match="cap"):
            mod.TrackedTrace.from_dict(doc)
