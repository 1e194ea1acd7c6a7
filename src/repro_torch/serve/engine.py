"""Batched serving engine: per-request prefill + batched greedy decode over
request slots (port of ``repro.serve.engine``).

A fixed pool of ``batch`` slots; arriving requests are prefilled one at a
time and spliced into a free slot (explicit per-slot index copies into the
pool's caches), and one ``decode_step`` advances every slot per tick.
Finished slots (EOS or max_tokens) are retired.  Idle slots decode too,
as in the reference; their tokens are dropped.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.devices import torch_device
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig


def splice(state: Dict[str, Any], one: Dict[str, Any], slot: int) -> None:
    """Copy a one-request decode state ``one`` (from ``tfm.prefill``) into
    slot ``slot`` of the pool's ``state``, in place: the caches' batch is
    axis 1 (KV caches, the stacked Mamba2 states), the positions' axis 0."""
    for key in ("k", "v"):
        if key in state:
            state[key][:, slot] = one[key][:, 0]
    for key, pool in state.get("ssm_layers", {}).items():
        pool[:, slot] = one["ssm_layers"][key][:, 0]
    state["index"][slot] = one["index"][0]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (prompt_len,) int32
    max_new_tokens: int = 16
    output: Optional[np.ndarray] = None


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params: tfm.LMParams, batch: int,
                 max_seq: int, eos_id: int = 1, device=None):
        dev = torch_device(device)
        if params.device.type != dev.type or \
                dev.index not in (None, params.device.index):
            raise ValueError(f"params live on {params.device}, the engine "
                             f"was asked to serve on {dev}")
        self.device = params.device
        self.cfg = cfg
        self.params = params
        self.batch = batch
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.state = tfm.init_decode_state(cfg, batch, max_seq, self.device)
        self.slot_req: List[Optional[Request]] = [None] * batch
        self.slot_remaining = np.zeros(batch, np.int64)
        self.last_token = np.zeros((batch, 1), np.int32)

    # -- slot management ----------------------------------------------------
    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def admit(self, req: Request) -> bool:
        """Prefill a request into a free slot.  Returns False if full."""
        free = self._free_slots()
        if not free:
            return False
        slot = free[0]
        tokens = torch.as_tensor(np.asarray(req.prompt)[None, :],
                                 dtype=torch.long, device=self.device)
        logits, one = tfm.prefill(self.params, self.cfg, tokens,
                                  self.max_seq)
        splice(self.state, one, slot)
        tok = int(torch.argmax(logits[0, -1]).item())
        self.last_token[slot, 0] = tok
        req.output = np.asarray([tok], np.int32)
        self.slot_req[slot] = req
        self.slot_remaining[slot] = req.max_new_tokens - 1
        return True

    def tick(self) -> List[Request]:
        """One decode step for all slots; returns the finished requests."""
        if all(r is None for r in self.slot_req):
            return []
        token = torch.as_tensor(self.last_token, dtype=torch.long,
                                device=self.device)
        logits, self.state = tfm.decode_step(self.params, self.cfg, token,
                                             self.state)
        next_tokens = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        finished = []
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            tok = int(next_tokens[slot])
            req.output = np.concatenate([req.output, [tok]]).astype(np.int32)
            self.slot_remaining[slot] -= 1
            if tok == self.eos_id or self.slot_remaining[slot] <= 0:
                finished.append(req)
                self.slot_req[slot] = None
            else:
                self.last_token[slot, 0] = tok
        return finished

    def serve(self, requests: List[Request], max_ticks: int = 1000
              ) -> List[Request]:
        """Drain a request list to completion (simple FCFS admission)."""
        pending = list(requests)
        done: List[Request] = []
        ticks = 0
        while (pending or any(r is not None for r in self.slot_req)) \
                and ticks < max_ticks:
            while pending and self.admit(pending[0]):
                pending.pop(0)
            done.extend(self.tick())
            ticks += 1
        return done
