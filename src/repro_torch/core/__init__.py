"""Core of the port: trace model, analytical engine, MLP scorer, predictor.

Exports the tracker as the reference's ``repro.core`` does (Listing 1)::

    from repro_torch.core import OperationTracker

    trace = OperationTracker("H100-SXM", measure="wallclock").track(
        iteration, params, batch)

and is otherwise kept import-free on purpose: import the modules
themselves (``from repro_torch.core import batched``), so that loading
one module never pulls the whole engine in.
"""

from repro_torch.core.trace import (Op, OperationTracker, TraceArrays,
                                    TrackedTrace)

__all__ = ["Op", "OperationTracker", "TraceArrays", "TrackedTrace"]
