"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/*.cu`` source is compiled on first use with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library with
a plain C interface under ``build/repro_torch_kernels/`` at the repository
root.  The library name carries a hash of the sources and flags, so an
edited source never loads a stale build.  All sources compile in parallel
(one ``nvcc`` each).  Nothing here runs at import time: the CPU tests
import every module on machines with no ``nvcc`` and no GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
_L, _F = ctypes.c_longlong, ctypes.c_float
#: kernel name -> (source file, C entry point, argtypes)
KERNELS = {
    # x, block_kinds, weights, biases, out, 2 x activation scratch;
    # B, H, L, K, block_m, in_features; stream
    "fused_mlp_score": ("fused_mlp_score.cu", "repro_fused_mlp_score",
                        [_P] * 7 + [_I] * 6 + [_P]),
    # x, row_kinds, weights, biases, out, 2 x activation scratch;
    # B, H, L, K, in_features; stream
    "fused_mlp_score_rows": ("fused_mlp_score_rows.cu",
                             "repro_fused_mlp_score_rows",
                             [_P] * 7 + [_I] * 5 + [_P]),
    # x, weights, biases, out, 2 x activation scratch; B, H, L,
    # in_features; stream
    "fused_mlp": ("fused_mlp.cu", "repro_fused_mlp",
                  [_P] * 6 + [_I] * 4 + [_P]),
    # q, k, v, o; dtype, B, H, KV, Sq, Skv, D; 4 x (b, h, s) strides;
    # causal, window, scale; stream
    "flash_attention": ("flash_attention.cu", "repro_flash_attention",
                        [_P] * 4 + [_I] * 7 + [_L] * 12 + [_I, _I, _F, _P]),
    # x, dt, a, bmat, cmat, y, state, chunk-state and cum_last scratch;
    # dtype, B, H, L, P, N, chunk; 5 x (b, h, l) strides; stream
    "ssd": ("ssd.cu", "repro_ssd", [_P] * 9 + [_I] * 7 + [_L] * 15 + [_P]),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: per kernel: the compiler's ``-Xptxas -v`` report of the last build
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> float:
    """Compile every kernel whose library is missing, all in parallel.

    Returns the wall seconds spent; raises ``RuntimeError`` with the
    compiler's output if any build fails."""
    t0 = time.perf_counter()
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, (src, _, _) in KERNELS.items():
            path = _lib_path(name)
            if path.exists():
                continue
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (path, tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for name, (path, tmp, proc) in procs.items():
            log, _ = proc.communicate()
            BUILD_LOG[name] = log
            if proc.returncode != 0:
                failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, path)
        if failed:
            raise RuntimeError("CUDA kernel build failed: "
                               + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not path.exists():
        build_all()
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(path))
            _, entry, argtypes = KERNELS[name]
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def sass(name: str) -> str:
    """The SASS of kernel ``name``'s built library (``cuobjdump -sass``,
    the toolkit's disassembler beside ``nvcc``)."""
    tool = Path(_nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), "-sass", str(_lib_path(name))],
                          capture_output=True, text=True, check=True).stdout


_count_lock = threading.Lock()


def count_launch(counts: Dict[str, int], name: str) -> None:
    """Add one to ``counts[name]``, a wrapper's ``LAUNCHES``, under a
    lock: the prediction service can run two leaders' passes at once,
    and an unguarded ``+=`` from both can lose a count."""
    with _count_lock:
        counts[name] += 1


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C launcher; raise on a non-zero
    ``cudaGetLastError()`` (a refused launch never runs, and a later
    synchronize would not report it)."""
    lib = library(name)
    rc = getattr(lib, KERNELS[name][1])(*args)
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
