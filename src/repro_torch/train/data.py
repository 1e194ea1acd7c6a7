"""Deterministic synthetic data pipeline (port of ``repro.train.data``).

The paper evaluates with synthetic data of the dataset's true shape
(Sec. 5.1, "We use synthetic data … the training computation time does not
depend on the values").  Tokens are generated counter-based (numpy's
generator seeded on the step index), which gives the two properties a
production pipeline needs for fault tolerance:

  * **skip-ahead**: batch(step) is a pure function of step, so restarting
    from a checkpoint at step N replays the exact stream without state;
  * **host sharding**: each host materializes only its slice.

:class:`SyntheticTokens` is the reference's, numpy only, so its batches
are bitwise the reference's.  A double-buffered prefetcher overlaps host
generation with device compute.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

from repro_torch.models.config import ModelConfig


class SyntheticTokens:
    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 seed: int = 0, host_index: int = 0, host_count: int = 1):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.host_index = host_index
        self.host_count = host_count
        assert batch % host_count == 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step, host) -> batch dict."""
        local = self.batch // self.host_count
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_index]))
        tokens = rng.integers(0, self.cfg.vocab_size,
                              (local, self.seq + 1), dtype=np.int32)
        out = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        if self.cfg.frontend:
            out["prefix_embeds"] = rng.standard_normal(
                (local, self.cfg.frontend_prefix_len, self.cfg.frontend_dim)
            ).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Double-buffered background prefetch of ``source.batch_at(step)``."""

    def __init__(self, source: SyntheticTokens, start_step: int = 0,
                 depth: int = 2):
        self.source = source
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self):
        step, batch = self._q.get()
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
