"""Core of the port: trace model, analytical engine, MLP scorer, predictor.

Exports the tracker and the symbolic device names of the reference's
``repro.core`` (Listing 1)::

    from repro_torch.core import Device, OperationTracker

    trace = OperationTracker(Device.H100_SXM, measure="wallclock").track(
        iteration, params, batch)
    print(trace.to_device(Device.V100, predictor=predictor).run_time_ms)

and is otherwise kept import-free on purpose: import the modules
themselves (``from repro_torch.core import batched``), so that loading
one module never pulls the whole engine in.
"""

from repro_torch.core.trace import (Op, OperationTracker, TraceArrays,
                                    TrackedTrace)


class Device:
    """Symbolic device names (the reference's ``Device``, which mirrors
    ``habitat.Device.*`` in Listing 1): the registry's names as string
    constants.  ``H100_SXM`` is the card the port tracks on, an origin
    only (``core.devices.H100_SXM``): a trace can come from it, but
    ``to_device`` does not predict for it."""
    P4000 = "P4000"
    P100 = "P100"
    V100 = "V100"
    RTX2070 = "RTX2070"
    RTX2080TI = "RTX2080Ti"
    T4 = "T4"
    TPU_V2 = "tpu-v2"
    TPU_V3 = "tpu-v3"
    TPU_V4 = "tpu-v4"
    TPU_V5E = "tpu-v5e"
    TPU_V5P = "tpu-v5p"
    TPU_V6E = "tpu-v6e"
    TRAINIUM1 = "trainium1"
    TRAINIUM2 = "trainium2"
    CPU_HOST = "cpu-host"
    H100_SXM = "H100-SXM"


__all__ = ["Device", "Op", "OperationTracker", "TraceArrays", "TrackedTrace"]
