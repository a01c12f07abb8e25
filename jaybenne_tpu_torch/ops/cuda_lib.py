"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` into one shared library with a
plain C interface, loaded with ``ctypes``. The build runs at first use, into
``jaybenne_tpu_torch/_build/`` (listed in ``.gitignore``), under a file name keyed
by a hash of the sources and flags, so an edited source rebuilds and an unchanged
one loads at once. Nothing here runs at import time: this module imports on a
machine without ``nvcc`` or a GPU, where only the plain PyTorch versions run.

``LAUNCHES`` counts kernel launches by name. Each launch wrapper adds one where it
launches its kernel and nowhere else, so a run can show that it went through the
kernels.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# sm_90a (Hopper). No --use_fast_math, and no FMA contraction, so that each float
# operation rounds as the plain PyTorch version's does.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: collections.Counter = collections.Counter()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "jb_raw_bits_launch": (_I, _P, _P, _P, _P, _I, _P),
    "jb_transport_1d_launch": (
        _P, _P, _P, _P, _P, _P, _P,   # x vx vy vz tau ci alive
        _P, _I,                       # inv_sigt n
        _I, _F, _F, _F, _F, _F, _F, _F, _F,  # nx dx inv_dx org lo hi lo_half hi_half span
        _I, _I,                       # bc_lo bc_hi
        _F, _F, _F, _F,               # c inv_c cdt inv_cdt
        _I, _I,                       # max_iters seed
        _P, _P, _P,                   # events iters stream
    ),
}


class CudaLibrary:
    """The loaded kernel library; ``build_seconds`` is the nvcc time of this process
    (0.0 when the library was already built), ``build_log`` nvcc's output."""

    def __init__(self, path: Path, build_seconds: float, build_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        self._dll = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self._dll, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int

    def call(self, name: str, *args) -> None:
        """Launch through the C entry ``name``; raise if the launch was refused."""
        err = getattr(self._dll, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


@functools.lru_cache(maxsize=1)
def library() -> CudaLibrary:
    sources = sorted(SRC_DIR.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(SRC_DIR.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    so = BUILD_DIR / f"libjbtorch_{h.hexdigest()[:16]}.so"
    if so.exists():
        return CudaLibrary(so, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, so)
    return CudaLibrary(so, seconds, res.stdout + res.stderr)


def stream_handle(device) -> int:
    """PyTorch's current stream on ``device``, as the pointer the C entries take."""
    return torch.cuda.current_stream(device).cuda_stream
