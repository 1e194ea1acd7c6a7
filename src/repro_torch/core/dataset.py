"""Training-data collection for the MLP predictors (paper Sec. 4.3.1).

A copy of ``repro.core.dataset``: the same seed yields the same ops,
features and labels in both packages.

We sample random *input configurations* for each kernel-varying operation
over the paper's exact parameter ranges, compute each configuration's
analytical cost (fwd + bwd, as the paper sums both), and label it with the
ground-truth execution time on every registered device via the simulator.
Each datapoint is ``[op features (7, padded) ++ device features (4)] -> ms``.

The same seed yields identical configurations across devices, mirroring the
paper's join-by-configuration dataset construction (Sec. 4.3.2).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from repro_torch.core import devices, simulator
from repro_torch.core.costmodel import OpCost
from repro_torch.core.trace import Op

#: Granularity note: the paper's datasets label each configuration with the
#: *sum* of forward and backward times, because PyTorch measures an op's
#: autograd backward as a unit.  Our tracer sees the backward pass as its own
#: dot_general/conv equations (JAX grad is just more jaxpr), so each dataset
#: point prices ONE kernel launch and traced fwd+bwd sums emerge naturally
#: from the trace containing both ops.  Documented deviation from Sec. 4.3.2.
_FWD_BWD = 1.0


def _logu(rng, lo, hi) -> int:
    """Log-uniform integer in [lo, hi]: wide ranges need octave coverage."""
    return int(round(np.exp(rng.uniform(np.log(lo), np.log(hi + 0.49)))))


def _conv_op(rng: np.random.Generator) -> Op:
    # Ranges follow Sec. 4.3.1 but extended to the *backward* kernel
    # envelope (weight-grad convs see "kernel" sizes equal to activation
    # maps, far beyond torchvision's forward 1-11), since our tracer prices
    # each kernel launch individually.  Documented deviation.
    batch = _logu(rng, 1, 256)
    in_ch = _logu(rng, 1, 2048)
    out_ch = _logu(rng, 1, 2048)
    padding = int(rng.integers(0, 4))
    stride = int(rng.integers(1, 5))
    image = _logu(rng, 1, 256)
    if rng.uniform() < 0.3:
        # backward-weight-grad pattern: "kernel" is an activation map
        kernel = int(rng.integers(max(image // 2, 1),
                                  image + 2 * padding + 1))
    else:
        kernel = _logu(rng, 1, image + 2 * padding)
    out_img = (image + 2 * padding - kernel) // stride + 1
    if out_img < 1:
        out_img = 1
    flops = 2.0 * batch * out_ch * out_img * out_img * in_ch * kernel * kernel
    br = 4.0 * (batch * in_ch * image * image + out_ch * in_ch * kernel ** 2)
    bw = 4.0 * batch * out_ch * out_img * out_img
    cost = OpCost(flops * _FWD_BWD, br * _FWD_BWD, bw * _FWD_BWD)
    params = {"batch": batch, "in_ch": in_ch, "out_ch": out_ch,
              "kernel": kernel, "padding": padding, "stride": stride,
              "image": image}
    return Op(name="conv_general_dilated", kind="conv2d", cost=cost,
              params=params)


def _linear_op(rng: np.random.Generator) -> Op:
    batch = _logu(rng, 1, 65536)
    in_f = _logu(rng, 1, 32768)
    out_f = _logu(rng, 1, 32768)
    bias = int(rng.integers(0, 2))
    flops = 2.0 * batch * in_f * out_f + bias * batch * out_f
    br = 4.0 * (batch * in_f + in_f * out_f + bias * out_f)
    bw = 4.0 * batch * out_f
    cost = OpCost(flops * _FWD_BWD, br * _FWD_BWD, bw * _FWD_BWD)
    params = {"batch": batch, "in_f": in_f, "out_f": out_f, "bias": bias,
              "b": 1, "m": batch, "n": out_f, "k": in_f}
    return Op(name="dot_general", kind="linear", cost=cost, params=params)


def _bmm_op(rng: np.random.Generator) -> Op:
    b = _logu(rng, 1, 512)
    l = _logu(rng, 1, 2048)
    m = _logu(rng, 1, 2048)
    r = _logu(rng, 1, 2048)
    flops = 2.0 * b * l * m * r
    br = 4.0 * (b * l * m + b * m * r)
    bw = 4.0 * b * l * r
    cost = OpCost(flops * _FWD_BWD, br * _FWD_BWD, bw * _FWD_BWD)
    params = {"b": b, "m": l, "n": r, "k": m}
    return Op(name="dot_general", kind="bmm", cost=cost, params=params)


def _lstm_op(rng: np.random.Generator) -> Op:
    batch = _logu(rng, 1, 4096)
    in_f = _logu(rng, 1, 4096)
    hidden = _logu(rng, 1, 4096)
    seq = _logu(rng, 1, 128)
    layers = int(rng.integers(1, 7))
    bidir = int(rng.integers(0, 2))
    bias = int(rng.integers(0, 2))
    # Gate count varies the cell family: 1 = vanilla RNN, 3 = GRU, 4 = LSTM.
    # (The paper's MLP is LSTM-only; our ``recurrent`` kind covers every
    # matmul-carrying scan — including *backward* scans whose work per step
    # is an arbitrary multiple of the forward formula — so we jitter the
    # work continuously to teach the MLP the flops/bytes axes.)
    gates = int(rng.choice([1, 3, 4]))
    work = float(np.exp(rng.uniform(np.log(0.5), np.log(6.0))))
    dirs = 2 if bidir else 1
    per_step = (2.0 * batch * gates * hidden * (in_f + hidden)
                + 6.0 * gates * batch * hidden)
    flops = per_step * seq * layers * dirs * work
    br = 4.0 * (gates * hidden * (in_f + hidden) * layers * dirs
                + batch * seq * in_f
                + batch * hidden * seq * layers * dirs) * work ** 0.8
    bw = 4.0 * batch * hidden * seq * layers * dirs * work ** 0.8
    cost = OpCost(flops * _FWD_BWD, br * _FWD_BWD, bw * _FWD_BWD)
    params = {"batch": batch, "in_f": in_f, "hidden": hidden, "seq": seq,
              "layers": layers, "bidir": bidir, "bias": bias}
    return Op(name="scan", kind="recurrent", cost=cost, params=params)


_SAMPLERS = {"conv2d": _conv_op, "linear": _linear_op, "bmm": _bmm_op,
             "recurrent": _lstm_op}


@dataclasses.dataclass
class Dataset:
    kind: str
    x: np.ndarray          # (n, 13) features: 9 op + 4 device
    y: np.ndarray          # (n,) time in ms
    feature_mean: np.ndarray = None
    feature_std: np.ndarray = None

    def normalized(self) -> "Dataset":
        mean = self.x.mean(axis=0)
        std = self.x.std(axis=0) + 1e-8
        return Dataset(self.kind, (self.x - mean) / std, self.y, mean, std)


def sample_ops(kind: str, n: int, seed: int = 0) -> List[Op]:
    rng = np.random.default_rng(seed)
    sampler = _SAMPLERS[kind]
    return [sampler(rng) for _ in range(n)]


def transform_features(raw: np.ndarray) -> np.ndarray:
    """log1p of all features: op dims and device specs are positive counts
    spanning many octaves; log-compressing them is required for the MLP to
    resolve small configurations (implementation choice on top of the
    paper's plain standardization)."""
    return np.log1p(np.asarray(raw, np.float32))


def build_dataset(kind: str, n_configs: int,
                  device_names: Sequence[str] = None,
                  seed: int = 0) -> Dataset:
    """Sample ``n_configs`` configurations, measured on every device."""
    device_names = device_names or devices.PAPER_GPUS
    ops = sample_ops(kind, n_configs, seed)
    xs, ys = [], []
    for dev_name in device_names:
        dev = devices.get(dev_name)
        feat = dev.feature_vector()
        for op in ops:
            xs.append(transform_features(op.feature_vector() + feat))
            ys.append(simulator.op_time_ms(op, dev))
    return Dataset(kind, np.asarray(xs, np.float32),
                   np.asarray(ys, np.float32))


def op_features(op: Op, dev) -> np.ndarray:
    """Feature vector for a single (op, destination device) query."""
    return transform_features(op.feature_vector() + dev.feature_vector())
