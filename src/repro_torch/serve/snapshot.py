"""Crash-consistent snapshots of a worker's warm state.

A copy of ``repro.serve.snapshot`` with the same sealed envelope
(``core/integrity.py``).  Snapshots are per package: the pickle names
``repro_torch`` classes.  The port's engine caches export host arrays
only (a stack's device views and lock, and the wave factors' device
tensors, do not pickle); a restored factor goes back onto the torch
device its key names, and one keyed to ``cuda`` is skipped in a process
without a GPU.

Under the launcher's supervisor a crashed worker restarts on the same port —
but **cold**: result cache, stack cache, wave-factor cache, and the
fitted split-planner pass model all reset, so every crash-recovery is a
latency cliff.  This module makes warmth durable:

* :class:`SnapshotManager` periodically (``REPRO_SNAPSHOT_INTERVAL_S``)
  pickles the warm state — the in-process result cache, the module-level
  ``STACK_CACHE`` / ``WAVE_FACTOR_CACHE`` engine caches (via their
  export/import hooks in :mod:`repro_torch.core.batched`), the service's
  measured pass samples, and the wire-level response cache (when
  ``REPRO_RESPONSE_CACHE`` enables one) — seals it
  (:mod:`repro_torch.core.integrity`), and
  writes it **crash-consistently**: write to a temp file, ``fsync``,
  atomic ``os.replace``, ``fsync`` the directory.  A reader can never
  observe a torn snapshot; a crash mid-write leaves the previous one.
* A restarted worker calls :meth:`restore` BEFORE announcing readiness
  (both front ends' CLIs take ``--snapshot``), so the first request
  after a crash hits warm caches.  Graceful drain takes a final
  snapshot, so a clean restart is warm too.
* The failure contract is the serving tier's usual one: a corrupt,
  truncated, version-skewed, or unwritable snapshot **degrades to a
  cold start** (``integrity.corrupt_snapshot`` counter, warning line) —
  it never raises into worker startup or the planner.  Chaos coverage:
  the ``snapshot.write`` / ``snapshot.load`` fault points
  (:mod:`repro_torch.serve.faults`).

The wave-factor cache survives the process boundary even though its
entries are validated by ``DeviceArrays`` *instance identity*: the
import hook re-resolves each entry's fleet names through the memoized
``devices.arrays_for``, yielding exactly the instance the engine will
present on lookup (see ``_WaveFactorCache.import_state``).
"""

from __future__ import annotations

import os
import pickle
import sys
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Union

from repro_torch.core import batched, integrity
from repro_torch.core.batched import env_float
from repro_torch.serve import faults

__all__ = ["SnapshotManager", "empty_stats"]

_VERSION = 1


def empty_stats() -> Dict:
    """The ``/stats`` ``snapshot`` block when no manager is attached —
    same keys as :meth:`SnapshotManager.stats` so the payload shape
    (pinned by ``tests/test_docs_sync.py``) never depends on wiring."""
    return {"enabled": False, "path": None, "interval_s": 0.0,
            "saves": 0, "save_errors": 0, "auto_saves": 0,
            "restored": False, "restored_entries": 0,
            "last_save_age_s": None}


class SnapshotManager:
    """Periodic + on-demand snapshots of one service's warm state.

    ``service`` is duck-typed: it needs ``planner.cache`` (export via
    ``export_entries`` when the backend offers it — sqlite/netcache
    backends are already durable/shared and are skipped),
    ``export_pass_samples``/``import_pass_samples``, and
    ``attach_snapshot`` (so ``/stats`` grows the ``snapshot`` block).

    ``interval_s`` defaults to ``REPRO_SNAPSHOT_INTERVAL_S`` (30 s);
    0 disables the periodic thread (explicit :meth:`save` still works,
    which is how the drain hook takes its final snapshot).
    """

    def __init__(self, path: Union[str, Path], service,
                 interval_s: Optional[float] = None):
        self.path = Path(path)
        self.service = service
        self.interval_s = (env_float("REPRO_SNAPSHOT_INTERVAL_S", 30.0)
                           if interval_s is None else float(interval_s))
        self._lock = threading.Lock()       # serializes saves
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.saves = 0
        self.save_errors = 0
        self.auto_saves = 0
        self.restored = False
        self.restored_entries = 0
        self._last_save: Optional[float] = None
        service.attach_snapshot(self)

    # -- state assembly ------------------------------------------------------
    def _collect(self) -> Dict:
        state: Dict = {"version": _VERSION, "saved_unix": time.time()}
        cache = self.service.planner.cache
        export = getattr(cache, "export_entries", None)
        state["result_cache"] = export() if callable(export) else None
        state["stack_cache"] = batched.STACK_CACHE.export_state()
        state["factor_cache"] = batched.WAVE_FACTOR_CACHE.export_state()
        state["pass_samples"] = self.service.export_pass_samples()
        resp = getattr(self.service, "export_response_cache", None)
        state["response_cache"] = resp() if callable(resp) else []
        return state

    # -- save ----------------------------------------------------------------
    def save(self) -> bool:
        """Take one crash-consistent snapshot; ``False`` on any failure.

        Write-to-temp + ``fsync`` + atomic ``os.replace`` + directory
        ``fsync``: the snapshot at ``self.path`` is always either the
        previous complete one or the new complete one.  Failures (disk
        full, injected ``snapshot.write`` fault, unpicklable state)
        count ``save_errors`` and leave the previous snapshot in place
        — snapshotting must never take the worker down."""
        with self._lock:
            tmp = self.path.with_name(
                f"{self.path.name}.tmp.{os.getpid()}")
            try:
                faults.inject("snapshot.write")
                blob = integrity.seal(pickle.dumps(self._collect()))
                self.path.parent.mkdir(parents=True, exist_ok=True)
                with open(tmp, "wb") as f:
                    f.write(blob)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self.path)
                dirfd = os.open(self.path.parent, os.O_RDONLY)
                try:            # durability of the rename itself
                    os.fsync(dirfd)
                finally:
                    os.close(dirfd)
                self.saves += 1
                self._last_save = time.monotonic()
                return True
            except Exception as e:
                self.save_errors += 1
                print(f"snapshot save to {self.path} failed "
                      f"({type(e).__name__}: {e}); keeping previous",
                      file=sys.stderr)
                try:
                    tmp.unlink(missing_ok=True)
                except OSError:
                    pass
                return False

    # -- restore -------------------------------------------------------------
    def restore(self) -> bool:
        """Restore warm state from ``self.path`` (call before serving).

        A missing file is a normal cold start (``False``, no counter).
        Anything unusable — unreadable file, failed checksum, bad
        pickle, version skew, injected ``snapshot.load`` fault — bumps
        ``integrity.corrupt_snapshot``, logs, and starts cold: the
        restart stays up no matter what is on disk."""
        try:
            faults.inject("snapshot.load")
            raw = self.path.read_bytes()
        except FileNotFoundError:
            return False
        except OSError as e:            # injected faults land here too
            integrity.COUNTERS.bump("snapshot")
            print(f"snapshot at {self.path} unreadable "
                  f"({type(e).__name__}: {e}); starting cold",
                  file=sys.stderr)
            return False
        try:
            state = pickle.loads(integrity.unseal(raw))
            if state.get("version") != _VERSION:
                raise integrity.IntegrityError(
                    f"snapshot version {state.get('version')!r} != "
                    f"{_VERSION}")
            restored = 0
            entries = state.get("result_cache")
            if entries:
                self.service.planner.cache.put_many(entries)
                restored += len(entries)
            restored += batched.STACK_CACHE.import_state(
                state.get("stack_cache") or [])
            restored += batched.WAVE_FACTOR_CACHE.import_state(
                state.get("factor_cache") or [])
            self.service.import_pass_samples(
                state.get("pass_samples") or [])
            resp = getattr(self.service, "import_response_cache", None)
            if callable(resp):
                restored += resp(state.get("response_cache") or [])
        except Exception as e:
            integrity.COUNTERS.bump("snapshot")
            print(f"snapshot at {self.path} is corrupt "
                  f"({type(e).__name__}: {e}); starting cold",
                  file=sys.stderr)
            return False
        self.restored = True
        self.restored_entries = restored
        return True

    # -- periodic thread -----------------------------------------------------
    def start(self) -> "SnapshotManager":
        """Start the periodic save thread (no-op when interval is 0)."""
        if self.interval_s > 0 and self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="snapshotter")
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            if self.save():
                self.auto_saves += 1

    def stop(self, final: bool = True) -> None:
        """Stop the periodic thread; ``final=True`` (the drain hook)
        takes one last snapshot so a graceful restart comes back warm."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if final:
            self.save()

    def stats(self) -> Dict:
        return {"enabled": True, "path": str(self.path),
                "interval_s": self.interval_s,
                "saves": self.saves, "save_errors": self.save_errors,
                "auto_saves": self.auto_saves,
                "restored": self.restored,
                "restored_entries": self.restored_entries,
                "last_save_age_s": (
                    None if self._last_save is None
                    else round(time.monotonic() - self._last_save, 3))}
