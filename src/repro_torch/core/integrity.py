"""End-to-end integrity: sealed payloads and checksummed wire frames.

Every byte the serving tier persists or ships — sqlite value columns,
netcache frames, snapshot files, MLP artifact pickles — is wrapped in a
checksum here, and every load verifies it.  The contract is the same as
the netcache circuit breaker's: **corruption degrades, it never
raises into the planner.**  (A copy of ``repro.core.integrity``: the
port shares its sealed format and so reads the reference's artifacts.)  A corrupt sqlite row is a miss, a corrupt
netcache frame is a degraded probe, a corrupt snapshot is a cold start,
a corrupt MLP artifact is a retrain — each bumps a ``corrupt_*``
counter surfaced in ``/stats`` under ``integrity``.

Sealed layout (``seal``/``unseal``)::

    MAGIC(4) | truncated sha256 of payload (8) | payload

Frames that already carry their own length header (the netcache wire
protocol) use the bare ``digest`` helper instead of the full envelope.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict

__all__ = [
    "IntegrityError", "seal", "unseal", "is_sealed", "digest",
    "DIGEST_BYTES", "COUNTERS",
]


class IntegrityError(ValueError):
    """A checksum or envelope mismatch.

    Subclasses ``ValueError`` so generic decode guards already catch it;
    call sites on the serving hot paths catch it *explicitly* and
    degrade (miss / cold / refetch) instead of propagating.
    """


_MAGIC = b"RSB1"            # "repro sealed blob", layout version 1
DIGEST_BYTES = 8            # truncated sha256 — collision-irrelevant here:
                            # we detect corruption, not adversaries
_HEADER = len(_MAGIC) + DIGEST_BYTES


def digest(payload: bytes) -> bytes:
    """Truncated sha256 of ``payload`` (``DIGEST_BYTES`` bytes)."""
    return hashlib.sha256(payload).digest()[:DIGEST_BYTES]


def seal(payload: bytes) -> bytes:
    """Wrap ``payload`` in the sealed envelope (magic + digest)."""
    if not isinstance(payload, bytes):
        raise TypeError(f"seal() wants bytes, got {type(payload).__name__}")
    return _MAGIC + digest(payload) + payload


def is_sealed(blob: bytes) -> bool:
    """Does ``blob`` carry the sealed-envelope magic?  (No verification.)"""
    return isinstance(blob, (bytes, bytearray)) and \
        bytes(blob[:len(_MAGIC)]) == _MAGIC


def unseal(blob: bytes) -> bytes:
    """Verify and strip the sealed envelope; raise ``IntegrityError``.

    Raises on: short/truncated blobs, missing magic, digest mismatch.
    Callers on serving paths must catch ``IntegrityError`` and degrade.
    """
    if not isinstance(blob, (bytes, bytearray)):
        raise IntegrityError(
            f"sealed payload must be bytes, got {type(blob).__name__}")
    blob = bytes(blob)
    if len(blob) < _HEADER or not blob.startswith(_MAGIC):
        raise IntegrityError("not a sealed payload (bad magic/truncated)")
    want = blob[len(_MAGIC):_HEADER]
    body = blob[_HEADER:]
    if digest(body) != want:
        raise IntegrityError("sealed payload failed checksum verification")
    return body


class _Counters:
    """Process-wide corruption counters (module singleton ``COUNTERS``).

    Module-level on purpose: corruption is detected deep in backends
    (sqlite decode, netcache framing, artifact load) where no service
    object is in scope, yet ``/stats`` must aggregate it all.
    """

    #: every kind pre-declared so the ``/stats`` block is always present
    #: (docs-sync pins the field reference against a bare service)
    KINDS = ("netcache", "sqlite", "snapshot", "artifact")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {k: 0 for k in self.KINDS}

    def bump(self, kind: str, n: int = 1) -> None:
        with self._lock:
            self._counts[kind] = self._counts.get(kind, 0) + n

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {f"corrupt_{k}": v
                    for k, v in sorted(self._counts.items())}

    def reset(self) -> None:
        """Zero every counter (tests only)."""
        with self._lock:
            for k in list(self._counts):
                self._counts[k] = 0


COUNTERS = _Counters()
