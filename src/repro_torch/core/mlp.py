"""The MLP execution-time predictors (paper Sec. 3.4 / 4.3.3).

Architecture (paper defaults): input layer -> 8 hidden layers x 1024 units,
ReLU -> 1 output, the predicted log of the op's execution time in ms.
Trained with Adam (lr 5e-4 -> 1e-4 after half the epochs), decoupled weight
decay 1e-4 on the weights, batch 512, on the mean absolute log error.

This module ports ``repro.core.mlp``: training runs on a torch ``device``
(``cuda`` unless the caller passes ``"cpu"``) with autograd and
``torch.optim.AdamW``, in fp32 without TF32.  The parameters of a trained
model are numpy ``[(w, b), ...]`` with ``w`` of shape (in, out), exactly as
the reference stores them, so :meth:`TrainedMLP.from_numpy` and
:meth:`TrainedMLP.load` carry a reference model over unchanged; for
inference the layer chain is an ``nn.Module`` (:class:`MLPStack`).
"""

from __future__ import annotations

import dataclasses
import itertools
import pickle
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core import devices, integrity
from repro_torch.core.dataset import Dataset


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


def init_params(cfg: MLPConfig,
                device=None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """He-normal weights (standard normal * sqrt(2 / fan_in)) of shape
    (in, out) and zero biases, as the reference's ``init_params``.  Drawn on
    the CPU from a ``torch.Generator`` seeded by ``cfg.seed``, so every
    device starts from the same numbers (JAX's stream differs, so the
    reference's initial weights are not these)."""
    dev = devices.torch_device(device)
    gen = torch.Generator().manual_seed(cfg.seed)
    sizes = [cfg.in_features] + [cfg.hidden_size] * cfg.hidden_layers + [1]
    return [((torch.randn((a, b), generator=gen) * float(np.sqrt(2.0 / a)))
             .to(dev), torch.zeros(b, device=dev))
            for a, b in zip(sizes[:-1], sizes[1:])]


def forward(params, x: torch.Tensor) -> torch.Tensor:
    """``h @ w + b`` per layer, ReLU between layers; column 0 of the last."""
    h = x
    for w, b in params[:-1]:
        h = torch.relu(torch.addmm(b, h, w))
    w, b = params[-1]
    return torch.addmm(b, h, w)[..., 0]


def mape_loss(params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """MAPE against raw times; the network predicts log(ms)."""
    pred = torch.exp(forward(params, x))
    return torch.mean(torch.abs(pred - y) / torch.clamp(y, min=1e-9))


def male_loss(params, x: torch.Tensor, logy: torch.Tensor) -> torch.Tensor:
    """Mean absolute log error: the scale-free training surrogate (the
    reference's stabilization on top of the paper's raw MAPE; evaluation
    still reports MAPE)."""
    return torch.mean(torch.abs(forward(params, x) - logy))


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
    #: the package that trained it: artifacts of both share one store
    trainer: str = "repro_torch"
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
                   feature_std=np.asarray(feature_std), trainer="repro")

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

    def predict_ms(self, features, device=None):
        """Raw feature rows -> predicted ms.  A tensor is scored on its
        own device and answered as a tensor; numpy is scored on ``device``
        (``cuda`` unless the caller passes ``"cpu"``) and answered as
        numpy."""
        as_numpy = not isinstance(features, torch.Tensor)
        if as_numpy:
            features = torch.as_tensor(np.asarray(features)).to(
                devices.torch_device(device))
        x = self.normalize(features)
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
                "test_mape": self.test_mape, "trainer": self.trainer}
        with open(path, "wb") as f:
            f.write(integrity.seal(pickle.dumps(blob)))

    @staticmethod
    def load(path: Path) -> "TrainedMLP":
        """Load a sealed artifact (``integrity.IntegrityError`` on a
        checksum mismatch).  Raw-pickle artifacts written before the
        integrity envelope existed still load.  The format holds numpy
        arrays only, so reference artifacts load here unchanged; they carry
        no ``trainer`` (the reference reads the port's and ignores it)."""
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
            test_mape=blob["test_mape"], trainer=blob.get("trainer", "repro"))


def _optimizer(params, cfg: MLPConfig) -> torch.optim.AdamW:
    """The reference's Adam update (``repro.core.mlp._train_step``):
    betas (0.9, 0.999), eps 1e-8 added to sqrt of the bias-corrected v,
    decay decoupled and on the weights only.  Fused on the card."""
    fused = params[0][0].device.type == "cuda"
    return torch.optim.AdamW(
        [{"params": [w for w, _ in params], "weight_decay": cfg.weight_decay},
         {"params": [b for _, b in params], "weight_decay": 0.0}],
        lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8, fused=fused or None)


def _train_step(params, opt: torch.optim.AdamW, x: torch.Tensor,
                logy: torch.Tensor, lr: float) -> torch.Tensor:
    """One Adam step on ``male_loss`` at learning rate ``lr``; returns the
    step's loss as a device tensor (reading it would wait for the card)."""
    for group in opt.param_groups:
        group["lr"] = lr
    opt.zero_grad(set_to_none=True)
    loss = male_loss(params, x, logy)
    loss.backward()
    opt.step()
    return loss.detach()


def train(dataset: Dataset, cfg: Optional[MLPConfig] = None,
          verbose: bool = False, device=None) -> TrainedMLP:
    """Train one MLP predictor on one kernel-varying op's dataset, on
    ``device`` (``cuda`` unless the caller passes ``"cpu"``).

    The reference's recipe step for step: its normalization and 80/20
    split, its per-epoch numpy permutations and batch order (the last
    batch short), the learning-rate switch at ``epochs // 2`` and its test
    MAPE.  The training set goes to the device once; each epoch's
    permutation is one host-to-device copy.  Products are fp32 without
    TF32, as the reference's: the process's float32 matmul precision must
    be ``"highest"`` (PyTorch's default), else this raises."""
    cfg = cfg or MLPConfig()
    dev = devices.torch_device(device)
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "mlp.train trains in fp32 without TF32: call "
            "torch.set_float32_matmul_precision('highest') first")
    norm = dataset.normalized()
    train_ds, test_ds = norm.split(0.8, seed=cfg.seed)
    cfg = dataclasses.replace(cfg, in_features=train_ds.x.shape[1])
    params = [(w.to(dev, torch.float32).requires_grad_(),
               b.to(dev, torch.float32).requires_grad_())
              for w, b in init_params(cfg, dev)]
    opt = _optimizer(params, cfg)
    x = torch.as_tensor(train_ds.x, dtype=torch.float32).to(dev)
    logy = torch.as_tensor(np.log(np.maximum(train_ds.y, 1e-9)),
                           dtype=torch.float32).to(dev)
    n = len(train_ds.y)
    rng = np.random.default_rng(cfg.seed)
    for epoch in range(cfg.epochs):
        lr = cfg.lr if epoch < cfg.epochs // 2 else cfg.lr_after_half
        perm = torch.as_tensor(rng.permutation(n)).to(dev)
        for start in range(0, n, cfg.batch_size):
            idx = perm[start:start + cfg.batch_size]
            loss = _train_step(params, opt, x[idx], logy[idx], lr)
        if verbose and (epoch % 10 == 0 or epoch == cfg.epochs - 1):
            print(f"  [{dataset.kind}] epoch {epoch:3d} loss "
                  f"{float(loss):.4f}")
    with torch.no_grad():
        test_mape = float(mape_loss(
            params, torch.as_tensor(test_ds.x, dtype=torch.float32)
            .to(dev), torch.as_tensor(test_ds.y).to(dev)))
    return TrainedMLP(
        kind=dataset.kind, cfg=cfg,
        params=[(w.detach().cpu().numpy(), b.detach().cpu().numpy())
                for w, b in params],
        feature_mean=norm.feature_mean, feature_std=norm.feature_std,
        test_mape=test_mape)
