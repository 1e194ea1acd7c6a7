"""The MLP execution-time predictors (paper Sec. 3.4 / 4.3.3): inference.

Architecture (paper defaults): input layer -> 8 hidden layers x 1024 units,
ReLU -> 1 output, the predicted log of the op's execution time in ms.
This module ports inference and the artifact format of ``repro.core.mlp``:
the layer chain is an ``nn.Module`` (:class:`MLPStack`), the parameters
stay numpy ``[(w, b), ...]`` with ``w`` of shape (in, out), exactly as the
reference stores them, so :meth:`TrainedMLP.from_numpy` and
:meth:`TrainedMLP.load` carry a reference model over unchanged.  Training
comes with a later part of the port.
"""

from __future__ import annotations

import dataclasses
import itertools
import pickle
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core import integrity


@dataclasses.dataclass
class MLPConfig:
    in_features: int = 11
    hidden_layers: int = 8
    hidden_size: int = 1024
    epochs: int = 80
    batch_size: int = 512
    lr: float = 5e-4
    lr_after_half: float = 1e-4
    weight_decay: float = 1e-4
    seed: int = 0


#: monotonic TrainedMLP identity for result-cache keys (``id()`` is
#: recycled by CPython, so a new model could alias a stale cache entry)
_UID = itertools.count()

#: finite ceiling for the network's log(ms) output: out-of-distribution
#: features saturate to a huge-but-finite time (e^80 ms, last in any
#: ranking) instead of overflowing ``exp`` into inf.  Fits float32.
LOG_MS_MAX = 80.0


class MLPStack(nn.Module):
    """The predictor's layer chain on one device: ``h @ w + b`` per layer,
    ReLU between layers and none after the last; the prediction is
    column 0 of the output."""

    def __init__(self, params: Sequence[Tuple[np.ndarray, np.ndarray]],
                 device: torch.device):
        super().__init__()
        self.n_layers = len(params)
        for i, (w, b) in enumerate(params):
            self.register_buffer(f"w{i}", torch.as_tensor(
                np.asarray(w, np.float32), device=device))
            self.register_buffer(f"b{i}", torch.as_tensor(
                np.asarray(b, np.float32), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.n_layers):
            z = torch.addmm(getattr(self, f"b{i}"), h, getattr(self, f"w{i}"))
            h = z if i == self.n_layers - 1 else torch.relu(z)
        return h[:, 0]


def _bucket(n: int) -> int:
    """Forward batch bucket, the reference ``predict_ms`` policy: powers
    of two up to 512 rows, multiples of 512 beyond."""
    if n <= 512:
        return 1 << max(n - 1, 0).bit_length()
    return -(-n // 512) * 512


@dataclasses.dataclass
class TrainedMLP:
    kind: str
    cfg: MLPConfig
    params: List[Tuple[np.ndarray, np.ndarray]]
    feature_mean: np.ndarray
    feature_std: np.ndarray
    test_mape: float = float("nan")
    uid: int = dataclasses.field(default_factory=lambda: next(_UID))
    _on_device: Dict = dataclasses.field(default_factory=dict, repr=False,
                                         compare=False)

    @classmethod
    def from_numpy(cls, kind: str, cfg: MLPConfig, params,
                   feature_mean, feature_std) -> "TrainedMLP":
        """Carry a reference model over: ``params`` is the reference's
        ``[(w, b), ...]`` (numpy or anything ``np.asarray`` takes)."""
        return cls(kind=kind, cfg=cfg,
                   params=[(np.asarray(w, np.float32),
                            np.asarray(b, np.float32)) for w, b in params],
                   feature_mean=np.asarray(feature_mean),
                   feature_std=np.asarray(feature_std))

    def _device_state(self, device: torch.device):
        """(MLPStack, mean, std) on ``device``, built once per device."""
        key = str(device)
        state = self._on_device.get(key)
        if state is None:
            state = (MLPStack(self.params, device),
                     torch.as_tensor(self.feature_mean, device=device),
                     torch.as_tensor(self.feature_std, device=device))
            self._on_device[key] = state
        return state

    def stack(self, device: torch.device) -> MLPStack:
        return self._device_state(torch.device(device))[0]

    def normalize(self, features: torch.Tensor) -> torch.Tensor:
        """Standardize raw feature rows with this model's train-set stats
        (shared by the per-kind forward and the fused scorer)."""
        _, mean, std = self._device_state(features.device)
        return (torch.atleast_2d(features) - mean) / std

    @staticmethod
    def ms_from_log(log_ms):
        """Map the network's log(ms) output to clamped milliseconds — the
        one output contract of every inference path (numpy or tensor)."""
        if isinstance(log_ms, torch.Tensor):
            return torch.clamp(torch.exp(torch.clamp(log_ms,
                                                     max=LOG_MS_MAX)),
                               min=1e-6)
        return np.maximum(np.exp(np.minimum(log_ms, LOG_MS_MAX)), 1e-6)

    def predict_ms(self, features):
        """Raw feature rows -> predicted ms.  A tensor is scored on its
        own device and answered as a tensor; numpy is scored on the CPU
        and answered as numpy."""
        as_numpy = not isinstance(features, torch.Tensor)
        x = self.normalize(torch.as_tensor(features) if as_numpy
                           else features)
        n = x.shape[0]
        padded = _bucket(n)
        x = x.to(torch.float32)
        if padded != n:
            x = torch.cat([x, x.new_zeros((padded - n, x.shape[1]))])
        with torch.no_grad():
            out = self.stack(x.device)(x)[:n]
        ms = self.ms_from_log(out)
        return ms.cpu().numpy() if as_numpy else ms

    def save(self, path: Path) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        blob = {"kind": self.kind, "cfg": dataclasses.asdict(self.cfg),
                "params": [(np.asarray(w), np.asarray(b))
                           for w, b in self.params],
                "mean": self.feature_mean, "std": self.feature_std,
                "test_mape": self.test_mape}
        with open(path, "wb") as f:
            f.write(integrity.seal(pickle.dumps(blob)))

    @staticmethod
    def load(path: Path) -> "TrainedMLP":
        """Load a sealed artifact (``integrity.IntegrityError`` on a
        checksum mismatch).  Raw-pickle artifacts written before the
        integrity envelope existed still load.  The format holds numpy
        arrays only, so reference artifacts load here unchanged."""
        with open(path, "rb") as f:
            raw = f.read()
        if integrity.is_sealed(raw):
            blob = pickle.loads(integrity.unseal(raw))
        else:                           # legacy pre-envelope artifact
            blob = pickle.loads(raw)
        return TrainedMLP(
            kind=blob["kind"], cfg=MLPConfig(**blob["cfg"]),
            params=[(np.asarray(w, np.float32), np.asarray(b, np.float32))
                    for w, b in blob["params"]],
            feature_mean=blob["mean"], feature_std=blob["std"],
            test_mape=blob["test_mape"])
