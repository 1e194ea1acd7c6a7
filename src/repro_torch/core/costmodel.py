"""Analytical per-op cost record (``repro.core.costmodel.OpCost``).

Only the record is ported here; the per-primitive pricing of traced
operations comes with the tracker.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class OpCost:
    flops: float = 0.0
    bytes_read: float = 0.0
    bytes_written: float = 0.0

    @property
    def bytes_accessed(self) -> float:
        return self.bytes_read + self.bytes_written

    @property
    def intensity(self) -> float:
        """Arithmetic intensity (FLOPs/byte); paper Fig. 2's x-axis."""
        return self.flops / max(self.bytes_accessed, 1.0)

    def __add__(self, other: "OpCost") -> "OpCost":
        return OpCost(self.flops + other.flops,
                      self.bytes_read + other.bytes_read,
                      self.bytes_written + other.bytes_written)

    def scaled(self, k: float) -> "OpCost":
        return OpCost(self.flops * k, self.bytes_read * k,
                      self.bytes_written * k)
