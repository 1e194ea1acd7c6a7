"""Fault-injection registry for the serving tier.

A copy of ``repro.serve.faults``.  Named injection points sit in the
serving hot paths (``netcache.get_many``, ``router.forward``,
``engine.pass``, ``worker.heartbeat``) and the durability paths
(``snapshot.write``, ``snapshot.load``, ``cache.corrupt`` — the last
flips a sqlite row's stored digest so the read path must detect it and
degrade to a miss).  Each point is a single call::

    from repro_torch.serve import faults
    faults.inject("engine.pass")

When no faults are armed the call is one module-level bool check —
measured in nanoseconds, safe to leave in production code paths. When
armed (via :func:`arm` or the ``REPRO_FAULTS`` environment variable)
a point can inject latency, raise a transport-shaped error, or hang,
each with an independent probability.

Spec grammar (``;``-separated entries)::

    point:mode[,p=<float>][,delay=<dur>][,hang=<dur>]

    REPRO_FAULTS="netcache.get_many:delay=200ms,p=0.3;engine.pass:error,p=0.1"

Modes:

- ``delay=<dur>`` — sleep for ``<dur>`` (``150ms``, ``1.5s``, or bare
  seconds) before the protected operation runs.
- ``error`` — raise :class:`FaultInjected` (an ``OSError`` subclass, so
  the existing transport-degradation paths — netcache miss-degrade,
  router failover — absorb it exactly like a real network fault).
- ``hang=<dur>`` — sleep for ``<dur>`` *then* raise; models a stalled
  peer that eventually times out.

Randomness is deterministic: each point draws from its own
``random.Random`` seeded from ``REPRO_FAULTS_SEED`` (default 0) plus
the point name, so a chaos run is reproducible bit-for-bit.

The registry is process-wide and thread-safe; tests use :func:`arm` /
:func:`disarm` around the invariants they prove.
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass, field


class FaultInjected(OSError):
    """Raised by an armed ``error`` / ``hang`` injection point.

    Subclasses ``OSError`` deliberately: every serving component already
    degrades gracefully on transport errors, and injected faults must
    flow through those same paths (netcache -> miss, router -> failover)
    rather than surfacing as novel exception types.
    """


@dataclass
class _PointSpec:
    """Parsed behavior for one injection point."""

    point: str
    p: float = 1.0
    delay_s: float = 0.0
    error: bool = False
    hang_s: float = 0.0
    rng: random.Random = field(default_factory=random.Random)
    fired: int = 0
    skipped: int = 0


def _parse_duration(text: str) -> float:
    """``200ms`` / ``1.5s`` / bare seconds -> seconds."""
    text = text.strip().lower()
    if text.endswith("ms"):
        return float(text[:-2]) / 1e3
    if text.endswith("s"):
        return float(text[:-1])
    return float(text)


def parse_spec(spec: str, seed: int = 0) -> dict:
    """Parse a ``REPRO_FAULTS`` spec string into point specs.

    Raises ``ValueError`` on malformed entries — an operator typo must
    fail loudly at arm time, not silently no-op in production.
    """
    points: dict[str, _PointSpec] = {}
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        if ":" not in entry:
            raise ValueError(f"fault spec entry missing ':': {entry!r}")
        point, _, body = entry.partition(":")
        point = point.strip()
        ps = _PointSpec(point=point)
        for part in body.split(","):
            part = part.strip()
            if not part:
                continue
            if part == "error":
                ps.error = True
            elif part.startswith("p="):
                ps.p = float(part[2:])
            elif part.startswith("delay="):
                ps.delay_s = _parse_duration(part[6:])
            elif part.startswith("hang="):
                ps.hang_s = _parse_duration(part[5:])
                ps.error = True
            else:
                raise ValueError(
                    f"fault spec entry {entry!r}: unknown part {part!r}")
        if not (ps.error or ps.delay_s > 0.0):
            raise ValueError(f"fault spec entry {entry!r} has no mode "
                             "(expected error, delay=..., or hang=...)")
        if not 0.0 <= ps.p <= 1.0:
            raise ValueError(f"fault spec entry {entry!r}: p out of [0,1]")
        # Deterministic per-point stream: independent of arming order and
        # of how many other points exist.
        ps.rng = random.Random(f"{seed}:{point}")
        points[point] = ps
    return points


_lock = threading.Lock()
_points: dict = {}
_armed = False          # the one flag `inject` checks when disarmed
_env_checked = False


def arm(spec: str, seed: int | None = None) -> None:
    """Arm the registry from a spec string (replaces any prior spec)."""
    global _points, _armed, _env_checked
    if seed is None:
        seed = int(os.environ.get("REPRO_FAULTS_SEED", "0"))
    parsed = parse_spec(spec, seed=seed)
    with _lock:
        _points = parsed
        _armed = bool(parsed)
        _env_checked = True


def disarm() -> None:
    """Disarm every injection point (back to zero-cost no-ops)."""
    global _points, _armed, _env_checked
    with _lock:
        _points = {}
        _armed = False
        _env_checked = True


def _check_env() -> None:
    """Lazily arm from ``REPRO_FAULTS`` on the first inject() call."""
    global _env_checked, _armed
    with _lock:
        if _env_checked:
            return
        _env_checked = True
    spec = os.environ.get("REPRO_FAULTS", "")
    if spec.strip():
        arm(spec)


def armed() -> bool:
    """True when at least one injection point is active."""
    if not _env_checked:
        _check_env()
    return _armed


def inject(point: str) -> None:
    """Fire the injection point ``point`` if armed; no-op otherwise.

    The disarmed path is a single bool check (after a one-time env
    probe) so the hooks can live in hot paths.
    """
    if not _armed:
        if _env_checked:
            return
        _check_env()
        if not _armed:
            return
    ps = _points.get(point)
    if ps is None:
        return
    with _lock:
        if ps.p < 1.0 and ps.rng.random() >= ps.p:
            ps.skipped += 1
            return
        ps.fired += 1
    if ps.delay_s > 0.0:
        time.sleep(ps.delay_s)
    if ps.hang_s > 0.0:
        time.sleep(ps.hang_s)
    if ps.error:
        raise FaultInjected(f"injected fault at {point}")


def stats() -> dict:
    """Counters per armed point (empty dict when disarmed)."""
    with _lock:
        return {
            "armed": _armed,
            "points": {
                name: {"fired": ps.fired, "skipped": ps.skipped,
                       "p": ps.p, "error": ps.error,
                       "delay_ms": round(ps.delay_s * 1e3, 3),
                       "hang_ms": round(ps.hang_s * 1e3, 3)}
                for name, ps in _points.items()
            },
        }
