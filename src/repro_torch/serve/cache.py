"""Result-cache backends for the fleet planner (port of ``repro.serve.cache``).

:class:`LRUCache` is the in-process ``OrderedDict`` LRU (hit moves to
tail, plain assignment appends, overflow pops the head, every probe
counted).  The shared sqlite and network backends of the reference come
with the serving-stack part of the port.  Keys are the planner's
``(fingerprint, device, config_key, fleet_token)`` tuples; values are
float64 milliseconds.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Iterable, List, Optional, Sequence, Tuple

#: a planner cache key: (trace fingerprint, device, config_key, fleet_token)
Key = Tuple


@dataclasses.dataclass
class CacheStats:
    """Per-worker hit/miss/eviction counters (shared backends included).

    ``degraded`` counts backend failures absorbed as misses — a network
    cache whose server is unreachable, or any backend whose
    ``get_many``/``put_many`` raised into the planner.  A degraded probe
    still counts its keys as misses (they get computed), so ``hit_rate``
    stays truthful under outage."""
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    degraded: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "degraded": self.degraded,
                "hit_rate": round(self.hit_rate, 4)}


class LRUCache:
    """In-process LRU backend (the original ``FleetPlanner`` cache).

    Thread-safe: every operation takes the backend lock, so concurrent
    ``rank()`` / ``sweep()`` calls cannot corrupt the ``OrderedDict`` or
    lose stats increments.
    """

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self.data: "OrderedDict[Key, float]" = OrderedDict()
        self.stats = CacheStats()
        self._lock = threading.Lock()

    def describe(self) -> str:
        return f"lru(capacity={self.capacity})"

    def get(self, key: Key) -> Optional[float]:
        """Hit-or-miss with stats accounting (hit refreshes LRU order)."""
        with self._lock:
            if key in self.data:
                self.data.move_to_end(key)
                self.stats.hits += 1
                return self.data[key]
            self.stats.misses += 1
            return None

    def get_many(self, keys: Sequence[Key]) -> List[Optional[float]]:
        """Batched :meth:`get`: one lock acquisition for a whole probe set.

        Accounting and LRU refresh are per key, in order — byte-identical
        to calling ``get`` in a loop, minus ~len(keys) lock round-trips
        (the planner probes n_traces x n_devices cells per query, so the
        lock traffic is measurable on the serving hot path)."""
        out: List[Optional[float]] = []
        with self._lock:
            for key in keys:
                if key in self.data:
                    self.data.move_to_end(key)
                    self.stats.hits += 1
                    out.append(self.data[key])
                else:
                    self.stats.misses += 1
                    out.append(None)
        return out

    def put_many(self, items: Iterable[Tuple[Key, float]]) -> None:
        """Insert computed cells, then evict LRU overflow.

        Plain assignment appends fresh keys at the LRU tail — identical
        insertion/eviction order to the pre-extraction planner cache."""
        with self._lock:
            for key, ms in items:
                self.data[key] = ms
            while len(self.data) > self.capacity:
                self.data.popitem(last=False)
                self.stats.evictions += 1

    def clear(self) -> None:
        with self._lock:
            self.data.clear()
            self.stats = CacheStats()

    def close(self) -> None:
        """No resources to release; exists so callers can close any
        backend uniformly."""

    def __len__(self) -> int:
        return len(self.data)


#: the full backend protocol every consumer relies on: the planner probes
#: with ``get``/``get_many`` and fills with ``put_many``; ``stats``,
#: ``describe``, ``clear`` and ``__len__`` serve accounting and tooling.
BACKEND_PROTOCOL = ("get", "get_many", "put_many", "stats", "describe",
                    "clear", "__len__")


def make_backend(cache=None, capacity: int = 4096):
    """Resolve a cache spelling to a backend instance.

    ``None`` -> fresh in-process LRU of ``capacity`` entries; a ready
    backend passes through after full-protocol validation.  Paths and
    ``tcp://`` addresses (the reference's shared backends) are not
    ported yet and raise."""
    if cache is None:
        return LRUCache(capacity)
    if isinstance(cache, str) or hasattr(cache, "__fspath__"):
        raise NotImplementedError(
            f"shared cache backend {cache!r}: the sqlite and network "
            f"backends are not ported yet; pass None or a backend object")
    missing = [name for name in BACKEND_PROTOCOL
               if not hasattr(cache, name)]
    if not missing:
        return cache
    raise TypeError(
        f"not a cache backend: {cache!r} (missing "
        f"{', '.join(missing)} of the protocol {BACKEND_PROTOCOL})")
