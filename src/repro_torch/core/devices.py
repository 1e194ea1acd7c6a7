"""Device registry: hardware specifications for origin/destination devices.

A copy of ``repro.core.devices`` (same specs, same registry order, so
fingerprints, golden key sets and artifact keys agree across packages).
The paper (Table 2) uses six NVIDIA GPUs.  The registry keeps those six for
paper-parity experiments and adds the TPU/Trainium accelerator families,
plus a host CPU.  The arrays stay host numpy; :meth:`DeviceArrays.on`
gives the engine a cached float64 tensor view on a torch device, and
:func:`torch_device` is the one resolver of the port's ``device``
arguments.

Fields mirror what wave scaling (Sec. 3.3) and the MLP features (Sec. 3.4)
need:
  * ``peak_flops``       -- peak dense FLOP/s for the relevant dtype (P in the
                            roofline model).
  * ``mem_bandwidth``    -- achieved HBM/DRAM bandwidth in bytes/s (D).
  * ``mem_capacity``     -- device memory in bytes (MLP feature).
  * ``num_units``        -- SMs on GPUs / TensorCores-per-chip on TPUs.  Used
                            to derive the wave size W.
  * ``clock_hz``         -- compute clock (C).
  * ``tiles_per_unit``   -- concurrent resident tiles ("thread blocks") per
                            unit; W_i = num_units * tiles_per_unit.
  * ``link_bandwidth``   -- per-link interconnect bytes/s (ICI / NVLink),
                            used by the beyond-paper distributed extension.
  * ``cost_per_hour``    -- rental cost in USD (None if not rentable), used
                            for cost-normalized throughput (Sec. 5.3).
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def torch_device(device=None) -> torch.device:
    """Resolve a ``device`` argument of the port: ``None`` means ``cuda``.

    There is no silent CPU path: asking for ``cuda`` on a machine without
    a usable GPU raises, and only an explicit ``"cpu"`` runs on the host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the host")
    return dev


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    name: str
    vendor: str
    generation: str
    kind: str                    # "gpu" | "tpu" | "trainium" | "cpu"
    peak_flops: float            # FLOP/s (fp32 for GPUs per paper; bf16 for TPUs)
    mem_bandwidth: float         # bytes/s
    mem_capacity: float          # bytes
    num_units: int               # SMs / cores
    clock_hz: float
    tiles_per_unit: int = 16
    link_bandwidth: float = 0.0  # bytes/s per link
    num_links: int = 0
    cost_per_hour: Optional[float] = None

    @property
    def wave_size(self) -> int:
        """W_i: number of tiles ("thread blocks") resident in one wave."""
        return self.num_units * self.tiles_per_unit

    @property
    def ridge_point(self) -> float:
        """R = P / D (FLOPs per byte) of the roofline model (Fig. 2)."""
        return self.peak_flops / self.mem_bandwidth

    def feature_vector(self) -> list:
        """The four GPU features attached to MLP datapoints (Sec. 4.3.2)."""
        return [
            self.mem_capacity / 2**30,          # GiB
            self.mem_bandwidth / 1e9,           # GB/s
            float(self.num_units),
            self.peak_flops / 1e12,             # TFLOP/s
        ]


GB = 1024.0**3
_REGISTRY: Dict[str, DeviceSpec] = {}
#: origin-only specs: devices a trace is measured on (``get`` resolves
#: them) that are not destinations (``all_devices`` leaves them out, so
#: the default fleet, golden key sets and artifact keys are unchanged)
_ORIGINS: Dict[str, DeviceSpec] = {}


def register(spec: DeviceSpec, origin_only: bool = False) -> DeviceSpec:
    if spec.name in _REGISTRY or spec.name in _ORIGINS:
        raise ValueError(f"duplicate device spec {spec.name!r}")
    (_ORIGINS if origin_only else _REGISTRY)[spec.name] = spec
    return spec


def get(name: str) -> DeviceSpec:
    spec = _REGISTRY.get(name) or _ORIGINS.get(name)
    if spec is None:
        raise KeyError(f"unknown device {name!r}; known: "
                       f"{sorted(_REGISTRY) + sorted(_ORIGINS)}")
    return spec


def all_devices() -> Dict[str, DeviceSpec]:
    return dict(_REGISTRY)


@dataclasses.dataclass(frozen=True)
class DeviceArrays:
    """Structure-of-arrays view of a destination fleet (one row per device).

    The vectorized prediction engine (``core/batched.py``,
    ``wave_scaling.scale_times_vec``) broadcasts op-axis tensors against
    the device-axis view (:meth:`on`) to fill an (n_ops x n_devices) grid
    in one tensor expression instead of a per-op Python loop."""
    names: List[str]
    kinds: List[str]                  # "gpu" | "tpu" | "trainium" | "cpu"
    peak_flops: np.ndarray            # (n_dev,)
    mem_bandwidth: np.ndarray         # (n_dev,)
    clock_hz: np.ndarray              # (n_dev,)
    wave_size: np.ndarray             # (n_dev,)
    ridge_point: np.ndarray           # (n_dev,)
    cost_per_hour: np.ndarray         # (n_dev,) NaN where not rentable
    feature_matrix: np.ndarray        # (n_dev, 4) MLP device features
    _views: Dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)
    _views_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    @property
    def n(self) -> int:
        return len(self.names)

    def on(self, device: torch.device) -> SimpleNamespace:
        """float64 tensors of the numeric fields on ``device`` (``kinds``
        rides along as the host list).  Built once per (instance, device)
        and treated as immutable, like the numpy arrays it mirrors."""
        key = str(device)
        with self._views_lock:
            view = self._views.get(key)
            if view is None:
                f64 = lambda a: torch.as_tensor(a, dtype=torch.float64,
                                                device=device)
                view = SimpleNamespace(
                    n=self.n, kinds=self.kinds,
                    peak_flops=f64(self.peak_flops),
                    mem_bandwidth=f64(self.mem_bandwidth),
                    clock_hz=f64(self.clock_hz),
                    wave_size=f64(self.wave_size),
                    ridge_point=f64(self.ridge_point),
                    feature_matrix=f64(self.feature_matrix))
                self._views[key] = view
            return view


@dataclasses.dataclass(frozen=True)
class OriginArrays:
    """Per-op origin-device arrays for the ragged multi-trace engine.

    A ragged stack mixes traces measured on *different* origin devices, so
    the origin side of wave scaling becomes per-op arrays instead of one
    ``DeviceSpec``.  ``scale_times_vec`` accepts either; element [i, j] of
    its output is unchanged — only the broadcasting shape of the origin
    terms differs."""
    kinds: List[str]                  # per-op origin kind (overhead lookup)
    mem_bandwidth: np.ndarray         # (n_ops,)
    clock_hz: np.ndarray              # (n_ops,)
    wave_size: np.ndarray             # (n_ops,)

    def take(self, idx: np.ndarray) -> "OriginArrays":
        """Row subset (e.g. the kernel-alike ops of a ragged stack)."""
        kinds = np.asarray(self.kinds, object)[idx].tolist()
        return OriginArrays(kinds=kinds,
                            mem_bandwidth=self.mem_bandwidth[idx],
                            clock_hz=self.clock_hz[idx],
                            wave_size=self.wave_size[idx])


def repeat_origins(specs: Sequence[DeviceSpec],
                   counts: Sequence[int]) -> OriginArrays:
    """Expand per-trace origin specs into per-op arrays (``counts[i]`` ops
    belong to the trace measured on ``specs[i]``)."""
    counts = np.asarray(counts, np.int64)
    kinds: List[str] = []
    for s, c in zip(specs, counts):
        kinds.extend([s.kind] * int(c))
    rep = lambda vals: np.repeat(np.asarray(vals, np.float64), counts)
    return OriginArrays(
        kinds=kinds,
        mem_bandwidth=rep([s.mem_bandwidth for s in specs]),
        clock_hz=rep([s.clock_hz for s in specs]),
        wave_size=rep([float(s.wave_size) for s in specs]))


@functools.lru_cache(maxsize=256)
def _spec_arrays_cached(specs: tuple) -> DeviceArrays:
    """Memoized :func:`spec_arrays` body, keyed on the (frozen, hashable)
    spec tuple itself rather than on names: a registry entry replaced by
    tests (or a same-named spec with different numbers) can never be
    served a stale SoA, while every repeated fleet spelling — the serving
    hot path resolves its destination list on each request — reuses one
    immutable ``DeviceArrays`` instead of rebuilding eight arrays."""
    return _build_spec_arrays(specs)


def _build_spec_arrays(specs: Sequence[DeviceSpec]) -> DeviceArrays:
    return DeviceArrays(
        names=[s.name for s in specs],
        kinds=[s.kind for s in specs],
        peak_flops=np.asarray([s.peak_flops for s in specs], np.float64),
        mem_bandwidth=np.asarray([s.mem_bandwidth for s in specs],
                                 np.float64),
        clock_hz=np.asarray([s.clock_hz for s in specs], np.float64),
        wave_size=np.asarray([s.wave_size for s in specs], np.float64),
        ridge_point=np.asarray([s.ridge_point for s in specs], np.float64),
        cost_per_hour=np.asarray(
            [s.cost_per_hour if s.cost_per_hour is not None else np.nan
             for s in specs], np.float64),
        feature_matrix=np.asarray([s.feature_vector() for s in specs],
                                  np.float64),
    )


def spec_arrays(specs: Sequence[DeviceSpec]) -> DeviceArrays:
    """Stack device specs into the SoA layout the batched engine consumes.

    Memoized on the spec tuple (LRU): callers must treat the result as
    immutable — the engine only ever reads it."""
    return _spec_arrays_cached(tuple(specs))


def arrays_for(names: Sequence[str]) -> DeviceArrays:
    """``spec_arrays`` over registry names (KeyError on unknown devices)."""
    return spec_arrays([get(n) for n in names])


def as_arrays(dests) -> DeviceArrays:
    """Coerce any destination-fleet spelling to :class:`DeviceArrays`.

    Accepts a ready ``DeviceArrays``, a sequence of registry names, or a
    sequence of ``DeviceSpec`` objects — the one resolver shared by the
    vectorized engine and every predictor."""
    if isinstance(dests, DeviceArrays):
        return dests
    dests = list(dests)
    if dests and isinstance(dests[0], str):
        return arrays_for(dests)
    return spec_arrays(dests)


# ---------------------------------------------------------------------------
# The paper's six GPUs (Table 2).  peak_flops is fp32; bandwidths are the
# *achieved* bandwidths Habitat measures ahead of time (~80% of spec).
# ---------------------------------------------------------------------------
P4000 = register(DeviceSpec(
    "P4000", "nvidia", "pascal", "gpu",
    peak_flops=5.3e12, mem_bandwidth=0.80 * 243e9, mem_capacity=8 * GB,
    num_units=14, clock_hz=1.48e9, tiles_per_unit=8,
    link_bandwidth=16e9, num_links=1, cost_per_hour=None))
P100 = register(DeviceSpec(
    "P100", "nvidia", "pascal", "gpu",
    peak_flops=9.3e12, mem_bandwidth=0.80 * 732e9, mem_capacity=16 * GB,
    num_units=56, clock_hz=1.30e9, tiles_per_unit=8,
    link_bandwidth=20e9, num_links=4, cost_per_hour=1.46))
V100 = register(DeviceSpec(
    "V100", "nvidia", "volta", "gpu",
    peak_flops=14.0e12, mem_bandwidth=0.80 * 900e9, mem_capacity=16 * GB,
    num_units=80, clock_hz=1.38e9, tiles_per_unit=8,
    link_bandwidth=25e9, num_links=6, cost_per_hour=2.48))
RTX2070 = register(DeviceSpec(
    "RTX2070", "nvidia", "turing", "gpu",
    peak_flops=7.5e12, mem_bandwidth=0.80 * 448e9, mem_capacity=8 * GB,
    num_units=36, clock_hz=1.62e9, tiles_per_unit=8,
    link_bandwidth=16e9, num_links=1, cost_per_hour=None))
RTX2080TI = register(DeviceSpec(
    "RTX2080Ti", "nvidia", "turing", "gpu",
    peak_flops=13.4e12, mem_bandwidth=0.80 * 616e9, mem_capacity=11 * GB,
    num_units=68, clock_hz=1.54e9, tiles_per_unit=8,
    link_bandwidth=16e9, num_links=1, cost_per_hour=None))
T4 = register(DeviceSpec(
    "T4", "nvidia", "turing", "gpu",
    peak_flops=8.1e12, mem_bandwidth=0.80 * 320e9, mem_capacity=16 * GB,
    num_units=40, clock_hz=1.59e9, tiles_per_unit=8,
    link_bandwidth=16e9, num_links=1, cost_per_hour=0.35))

# ---------------------------------------------------------------------------
# TPU / Trainium targets (bf16 peak).  v5e is the framework's primary target
# and matches the roofline constants mandated by the assignment:
# 197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI.
# ---------------------------------------------------------------------------
TPU_V2 = register(DeviceSpec(
    "tpu-v2", "google", "tpu-v2", "tpu",
    peak_flops=45e12, mem_bandwidth=700e9, mem_capacity=16 * GB,
    num_units=2, clock_hz=0.70e9, tiles_per_unit=64,
    link_bandwidth=62.5e9, num_links=4, cost_per_hour=1.00))
TPU_V3 = register(DeviceSpec(
    "tpu-v3", "google", "tpu-v3", "tpu",
    peak_flops=123e12, mem_bandwidth=900e9, mem_capacity=32 * GB,
    num_units=2, clock_hz=0.94e9, tiles_per_unit=64,
    link_bandwidth=81.25e9, num_links=4, cost_per_hour=2.00))
TPU_V4 = register(DeviceSpec(
    "tpu-v4", "google", "tpu-v4", "tpu",
    peak_flops=275e12, mem_bandwidth=1228e9, mem_capacity=32 * GB,
    num_units=2, clock_hz=1.05e9, tiles_per_unit=64,
    link_bandwidth=50e9, num_links=6, cost_per_hour=3.22))
TPU_V5E = register(DeviceSpec(
    "tpu-v5e", "google", "tpu-v5e", "tpu",
    peak_flops=197e12, mem_bandwidth=819e9, mem_capacity=16 * GB,
    num_units=1, clock_hz=1.00e9, tiles_per_unit=128,
    link_bandwidth=50e9, num_links=4, cost_per_hour=1.20))
TPU_V5P = register(DeviceSpec(
    "tpu-v5p", "google", "tpu-v5p", "tpu",
    peak_flops=459e12, mem_bandwidth=2765e9, mem_capacity=95 * GB,
    num_units=2, clock_hz=1.75e9, tiles_per_unit=64,
    link_bandwidth=100e9, num_links=6, cost_per_hour=4.20))
TPU_V6E = register(DeviceSpec(
    "tpu-v6e", "google", "tpu-v6e", "tpu",
    peak_flops=918e12, mem_bandwidth=1640e9, mem_capacity=32 * GB,
    num_units=1, clock_hz=1.40e9, tiles_per_unit=128,
    link_bandwidth=112e9, num_links=4, cost_per_hour=2.70))
TRN1 = register(DeviceSpec(
    "trainium1", "aws", "trn1", "trainium",
    peak_flops=95e12, mem_bandwidth=820e9, mem_capacity=32 * GB,
    num_units=2, clock_hz=1.4e9, tiles_per_unit=64,
    link_bandwidth=48e9, num_links=4, cost_per_hour=1.34))
TRN2 = register(DeviceSpec(
    "trainium2", "aws", "trn2", "trainium",
    peak_flops=650e12, mem_bandwidth=2900e9, mem_capacity=96 * GB,
    num_units=8, clock_hz=1.4e9, tiles_per_unit=32,
    link_bandwidth=64e9, num_links=4, cost_per_hour=2.60))

# A generic host CPU (rough per-core GEMM rate and DRAM bandwidth).
CPU_HOST = register(DeviceSpec(
    "cpu-host", "generic", "x86", "cpu",
    peak_flops=0.4e12, mem_bandwidth=30e9, mem_capacity=64 * GB,
    num_units=8, clock_hz=3.0e9, tiles_per_unit=2,
    link_bandwidth=0.0, num_links=0, cost_per_hour=None))

# The GPU the port runs on: the origin that ``measure("wallclock")`` times
# CUDA tensors on, as ``CPU_HOST`` is for host tensors.  Origin only, not a
# destination.  Datasheet values of the SXM part (NVIDIA): 132 SMs, 1.98
# GHz boost clock, 80 GB of HBM3 at 3.35 TB/s (achieved taken as 80%, as
# for the paper's GPUs above) and 66.9 TFLOP/s fp32 outside the tensor
# cores (the paper's GPU rows count fp32).
H100_SXM = register(DeviceSpec(
    "H100-SXM", "nvidia", "hopper", "gpu",
    peak_flops=66.9e12, mem_bandwidth=0.80 * 3.35e12, mem_capacity=80 * GB,
    num_units=132, clock_hz=1.98e9, tiles_per_unit=8,
    link_bandwidth=0.0, num_links=0, cost_per_hour=None), origin_only=True)

#: The dry run's roofline constants (``launch.hlo_analysis``), for one
#: NVIDIA H100 SXM5 80GB at 700 W, from NVIDIA's datasheet: dense bf16 on
#: the tensor cores, HBM3 bandwidth, and one GPU's link off its node, a
#: 400 Gb/s NDR InfiniBand port (50 GB/s).  Each 16-wide axis of the
#: production meshes spans two 8-GPU nodes, so its collectives cross that
#: link; an axis inside one node would see NVLink's 450 GB/s per
#: direction.  The first two are chip_smoke.py's ``BF16_PEAK_FLOPS`` and
#: ``HBM_BYTES_PER_S``.  The reference's TPU v5e constants are not carried
#: over.
ROOFLINE_PEAK_FLOPS = 989e12
ROOFLINE_HBM_BW = 3.35e12
ROOFLINE_LINK_BW = 50e9

#: The six paper GPUs, used by paper-parity benchmarks (Figs. 3/4, Sec. 5).
PAPER_GPUS = ["P4000", "P100", "V100", "RTX2070", "RTX2080Ti", "T4"]
