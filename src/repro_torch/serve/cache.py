"""Result-cache backends for the fleet planner (port of ``repro.serve.cache``).

:class:`LRUCache` is the in-process ``OrderedDict`` LRU (hit moves to
tail, plain assignment appends, overflow pops the head, every probe
counted).  :class:`SqliteCache` is the cross-process shared store (one
sqlite file in WAL mode): a (trace, device) cell priced by one worker is
a hit for the next, while hit/miss/eviction accounting stays per worker.
Its table, key encoding (``repr`` of the key tuple) and sealed value
digest (column ``d``) are the reference's, so a database file written by
either package reads back in the other.  The network backend,
:class:`repro_torch.serve.netcache.NetCache` (spelled
``tcp://host:port``), is the cross-host store; its frames are the
reference's, so either package's client talks to either's server.
Keys are the planner's
``(fingerprint, device, config_key, fleet_token)`` tuples; values are
float64 milliseconds (sqlite REAL is an IEEE double, so round trips are
bitwise exact).
"""

from __future__ import annotations

import dataclasses
import sqlite3
import struct
import sys
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Tuple, Union

from repro_torch.core import integrity
from repro_torch.serve import faults

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

    def contains_many(self, keys: Sequence[Key]) -> List[bool]:
        """Whether each key is held, read without stats accounting or an
        LRU refresh (admission prices a request by it; not in the
        reference)."""
        with self._lock:
            return [key in self.data for key in keys]

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

    def export_entries(self) -> List[Tuple[Key, float]]:
        """Snapshot of every entry in LRU order (head first), so a
        restore through :meth:`put_many` reproduces the eviction order.
        Only the in-process backend exports: sqlite and netcache stores
        are already durable or shared, so ``serve/snapshot.py`` skips
        them."""
        with self._lock:
            return list(self.data.items())

    def __len__(self) -> int:
        return len(self.data)


class SqliteCache:
    """Cross-process shared backend: one sqlite file, N workers.

    * WAL journaling + a busy timeout make concurrent reader/writer
      workers safe without any cross-process lock of our own.
    * Reads are PURE reads (no tick refresh): WAL allows any number of
      concurrent readers but only one writer, so a hit must never queue
      on the write lock — the hot path this cache exists to serve.
      Eviction order is therefore write-recency (a monotone ``tick``
      bumped on insert/overwrite), not strict LRU.  Ticks are minted
      **in SQL, inside the insert's own write transaction**
      (``MAX(tick) + 1`` evaluated under the writer lock), so N
      concurrent workers always mint disjoint, globally increasing
      ticks.  A per-connection counter seeded at open — the previous
      scheme — let workers that opened early mint ticks far below the
      table's current max, and eviction (``ORDER BY tick``) would then
      drop another worker's *freshest* entries.
    * ``stats`` counts only THIS worker's probes/evictions; the shared
      entry count is ``len(backend)``.
    """

    _SCHEMA = ("CREATE TABLE IF NOT EXISTS cache ("
               "k TEXT PRIMARY KEY, ms REAL NOT NULL, "
               "tick INTEGER NOT NULL, d BLOB)")

    def __init__(self, path: Union[str, Path], capacity: int = 262144):
        self.path = Path(path)
        self.capacity = capacity
        self.stats = CacheStats()
        self.recreated = 0              # corrupt DB files replaced at open
        self._lock = threading.Lock()   # serializes this worker's conn
        self.path.parent.mkdir(parents=True, exist_ok=True)
        try:
            self._conn = self._open()
        except sqlite3.DatabaseError as e:
            # a corrupt/truncated DB file must cost this worker its
            # persisted warmth, never its startup: recreate a fresh
            # store in place (the shared entries are a cache, not a
            # source of truth) and carry on
            print(f"sqlite cache at {self.path} is corrupt ({e}); "
                  f"recreating a fresh store", file=sys.stderr)
            integrity.COUNTERS.bump("sqlite")
            self.recreated += 1
            for suffix in ("", "-wal", "-shm"):
                Path(str(self.path) + suffix).unlink(missing_ok=True)
            self._conn = self._open()

    def _open(self) -> sqlite3.Connection:
        """Connect + PRAGMAs + schema; raises ``sqlite3.DatabaseError``
        on a corrupt file (``connect`` succeeds lazily — the first
        statement is where garbage bytes surface)."""
        conn = sqlite3.connect(self.path, timeout=30.0,
                               check_same_thread=False)
        try:
            with self._lock:
                conn.execute("PRAGMA journal_mode=WAL")
                conn.execute("PRAGMA synchronous=NORMAL")
                conn.execute(self._SCHEMA)
                cols = [r[1] for r in conn.execute(
                    "PRAGMA table_info(cache)")]
                if "d" not in cols:     # pre-integrity stores: add the
                    conn.execute(       # digest column, legacy rows NULL
                        "ALTER TABLE cache ADD COLUMN d BLOB")
                conn.commit()
        except sqlite3.DatabaseError:
            conn.close()
            raise
        return conn

    def describe(self) -> str:
        return f"sqlite({self.path}, capacity={self.capacity})"

    @staticmethod
    def _encode(key: Key) -> str:
        # planner keys hold only str/bool/int/tuple primitives, whose repr
        # is deterministic and identical across worker processes
        return repr(key)

    @staticmethod
    def _digest(enc_key: str, ms: float) -> bytes:
        """Row checksum binding the value to ITS key: a torn write or a
        bit flip in either breaks verification, and the row degrades to
        a miss rather than serving a wrong cell into the planner."""
        return integrity.digest(
            enc_key.encode() + struct.pack("!d", float(ms)))

    def _decode(self, enc_key: str, row) -> Optional[float]:
        """Verify-and-decode one fetched row; None (a miss) when the
        checksum fails.  Legacy rows (NULL digest, written before the
        integrity column existed) are served unverified."""
        ms, d = float(row[0]), row[1]
        try:
            faults.inject("cache.corrupt")
        except OSError:
            d = b"\x00" * integrity.DIGEST_BYTES    # simulate a bad row
        if d is not None and bytes(d) != self._digest(enc_key, ms):
            integrity.COUNTERS.bump("sqlite")
            return None
        return ms

    def get(self, key: Key) -> Optional[float]:
        enc = self._encode(key)
        with self._lock:
            row = self._conn.execute(
                "SELECT ms, d FROM cache WHERE k = ?", (enc,)).fetchone()
        ms = None if row is None else self._decode(enc, row)
        if ms is None:
            self.stats.misses += 1
            return None
        self.stats.hits += 1
        return ms

    def get_many(self, keys: Sequence[Key]) -> List[Optional[float]]:
        """Batched :meth:`get` (pure reads, one lock hold)."""
        out: List[Optional[float]] = []
        with self._lock:
            rows = [self._conn.execute(
                "SELECT ms, d FROM cache WHERE k = ?",
                (self._encode(key),)).fetchone() for key in keys]
        for key, row in zip(keys, rows):
            ms = None if row is None else \
                self._decode(self._encode(key), row)
            if ms is None:
                self.stats.misses += 1
                out.append(None)
            else:
                self.stats.hits += 1
                out.append(ms)
        return out

    def put_many(self, items: Sequence[Tuple[Key, float]]) -> None:
        items = list(items)
        if not items:
            return
        with self._lock:
            rows = []
            for key, ms in items:
                enc = self._encode(key)
                rows.append((enc, float(ms), self._digest(enc, ms)))
            # the tick subquery runs inside this statement's write
            # transaction, so it sees every committed write from every
            # worker (and this batch's earlier rows): ticks are globally
            # monotone and collision-free without any cross-process
            # coordination of our own
            self._conn.executemany(
                "INSERT INTO cache (k, ms, tick, d) VALUES (?, ?, "
                "(SELECT COALESCE(MAX(tick), 0) + 1 FROM cache), ?) "
                "ON CONFLICT(k) DO UPDATE SET ms=excluded.ms, "
                "tick=excluded.tick, d=excluded.d", rows)
            over = (self._conn.execute(
                "SELECT COUNT(*) FROM cache").fetchone()[0] - self.capacity)
            if over > 0:
                cur = self._conn.execute(
                    "DELETE FROM cache WHERE k IN (SELECT k FROM cache "
                    "ORDER BY tick LIMIT ?)", (over,))
                self.stats.evictions += cur.rowcount
            self._conn.commit()

    def clear(self) -> None:
        """Drop all SHARED entries and reset this worker's counters."""
        with self._lock:
            self._conn.execute("DELETE FROM cache")
            self._conn.commit()
            self.stats = CacheStats()

    def __len__(self) -> int:
        with self._lock:
            return int(self._conn.execute(
                "SELECT COUNT(*) FROM cache").fetchone()[0])

    def close(self) -> None:
        with self._lock:
            self._conn.close()


#: anything ``make_backend`` accepts
BackendLike = Union[None, str, Path, LRUCache, SqliteCache]

#: the full backend protocol every consumer relies on: the planner probes
#: with ``get``/``get_many`` and fills with ``put_many``; ``stats``,
#: ``describe``, ``clear`` and ``__len__`` serve accounting and tooling.
BACKEND_PROTOCOL = ("get", "get_many", "put_many", "stats", "describe",
                    "clear", "__len__")


def make_backend(cache: BackendLike = None, capacity: int = 4096):
    """Resolve a cache spelling to a backend instance.

    ``None`` -> fresh in-process LRU of ``capacity`` entries;
    ``tcp://host:port`` -> network result-cache client
    (:class:`repro_torch.serve.netcache.NetCache`); any other str/Path
    -> sqlite shared backend at that file (``capacity`` honored
    exactly); a ready backend passes through after full-protocol
    validation (``capacity`` ignored)."""
    if cache is None:
        return LRUCache(capacity)
    if isinstance(cache, str) and cache.startswith("tcp://"):
        from repro_torch.serve.netcache import NetCache  # import cycle
        return NetCache(cache)
    if isinstance(cache, (str, Path)):
        return SqliteCache(cache, capacity=capacity)
    missing = [name for name in BACKEND_PROTOCOL
               if not hasattr(cache, name)]
    if not missing:
        return cache
    raise TypeError(
        f"not a cache backend or path: {cache!r} (missing "
        f"{', '.join(missing)} of the protocol {BACKEND_PROTOCOL})")
