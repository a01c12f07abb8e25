"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc``, all started together
(the census's float32 and float64 instantiations are two sources,
``transport_kernel.cu`` and ``transport_kernel_f64.cu``, so that the float64 ones
add no time to the build's longest compile), and the objects are linked into one
shared library with a plain C interface,
loaded with ``ctypes``. The build runs at first use, into
``jaybenne_tpu_torch/_build/`` (listed in ``.gitignore``), under a file name keyed
by a hash of the sources and flags, so an edited source rebuilds and an unchanged
one loads at once. Nothing here runs at import time: this module imports on a
machine without ``nvcc`` or a GPU, where only the plain PyTorch versions run.

``LAUNCHES`` counts kernel launches by name. Each launch wrapper adds one where it
launches its kernel and nowhere else, so a run can show that it went through the
kernels; a CUDA graph's replay, which launches from no wrapper, adds the launches
counted while it was captured (``graph.py``).
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: collections.Counter = collections.Counter()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F, _D = ctypes.c_float, ctypes.c_double


def _table(real):
    # kind absorb run, table, ranges, host arrays of their 8 column pointers, of
    # their (cells, first row) and of the plan's 5 (d, mul, shift), nrbx nrby,
    # blocks, real(1 / dx), c, the counters to zero and their 64-bit words, stream
    return (_I, _I, _I, _P, _I, _P, _P, _P, _I, _I, _I, real, real, _P, _I, _P)


_TRANSPORT = (
    _I, _I, _I, _I, _I,  # ndim absorb ddmc smr nongray
    _P, _P,          # host array of 16 ledger pointers, cell table
    _P,              # host array of the record's 4 column pointers (or null)
    _P, _P, _P,      # block table, block levels, lookup grid (SMR; else null)
    _I,              # ledger capacity
    _P, _P,          # host int and real geometry arrays
    _I, _P,          # shards, host array of their (slot_lo slot_hi own_lo own_hi row)
    _P,              # the shards' int32 seeds (device)
    _P,              # go: the round's flag (a bool, device), or null for an ungated launch
    _I,              # spread: a block's warps take slot groups spread over the launch
    _I,              # grid: at most this many blocks where the instantiation runs in rounds
    _I,              # width: the first wave's blocks that take the shards spread, or 0
    _P, _P,          # events iters
    _I,              # zeroed: the counters were zeroed on the stream (no memset)
    _P,              # stream
)
# every C entry; a float64 entry (precision = f64) ends in _f64
_SIGNATURES = {
    "jb_table_launch": _table(_F),
    "jb_table_launch_f64": _table(_D),
    "jb_raw_bits_launch": (_I, _P, _P, _P, _P, _I, _P),
    "jb_draws_f64_launch": (_I, _P, _P, _P, _P, _I, _P),  # seed lane it tag out n stream
    "jb_census_words_launch": (_I, _P, _P, _I, _I, _P),  # seed n_events out n words stream
    # blocks_x blocks_y threads stream: an empty kernel, the floor of a launch
    "jb_empty_launch": (_I, _I, _I, _P),
    # ndim absorb ddmc smr nongray, out: resident blocks, whether it runs in rounds
    "jb_transport_occupancy": (_I, _I, _I, _I, _I, _P, _P),
    "jb_transport_occupancy_f64": (_I, _I, _I, _I, _I, _P, _P),
    "jb_transport_launch": _TRANSPORT,
    "jb_transport_launch_f64": _TRANSPORT,
    # columns dst src strides bytes fills k, alive reserved, valid vstride vbytes,
    # segments, slots and candidates a segment, scratch dropped stream
    "jb_insert_launch": (_I, _P, _P, _P, _P, _P, _L, _P, _P, _P, _L, _I, _I, _L, _L, _P,
                         _P, _P),
    # the 15 columns, their reals' bytes, words a row, alive block go, local shards,
    # shards, slots a shard, blocks a shard, the first shard's first block, K,
    # buffer, flags, scratch and its length, sent stream
    "jb_migrate_launch": (_P, _I, _I, _P, _P, _P, _I, _I, _L, _L, _L, _L, _P, _P, _P, _L, _P,
                          _P),
    # stages double, weight block k j i alive absorbed volume, blocks, slots, slots a
    # slice, spatial off0 bl, nx ny nz, bins bits, emax acc, parts, host arrays of
    # the parts' tally, energy_delta in and out pointers, stream
    "jb_tally_launch": (_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _L, _L, _I, _I, _I, _I, _I,
                        _I, _L, _I, _P, _P, _I, _P, _P, _P, _P),
    # double, host arrays of the 3 axes' lower and upper side maps and faces a
    # block, dx, surface index, S, ncell, blocks, bl, off0, tau thin, parts, host
    # arrays of the parts' sigma_t, its step, surfaces and 3 outputs each, stream
    # alive, tau, its bytes, local shards, slots a shard, scratch, per-shard counts,
    # totals, host array of the round's 12 counter pointers (or null), max_iters,
    # stream
    "jb_counts_launch": (_P, _P, _I, _I, _L, _P, _P, _P, _P, _I, _P),
    "jb_faces_launch": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _D, _D, _I, _P, _I, _P, _P,
                        _P),
}


class CudaLibrary:
    """The loaded kernel library; ``build_seconds`` is the nvcc time of this process
    (0.0 when the library was already built), ``build_log`` nvcc's output (of the
    build that made it)."""

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


def nvcc() -> str:
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
    log_path = so.with_suffix(".log")  # nvcc's output, kept for a library loaded later
    if so.exists():
        return CudaLibrary(so, 0.0, log_path.read_text() if log_path.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    exe = nvcc()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([exe, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    res = subprocess.run([exe, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)],
                         capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = "".join(logs) + res.stdout + res.stderr
    for obj in objs:
        obj.unlink(missing_ok=True)
    if res.returncode != 0 or any(proc.returncode != 0 for proc in procs):
        raise RuntimeError(f"nvcc failed:\n{log}")
    log_path.write_text(log)
    os.replace(tmp, so)
    return CudaLibrary(so, seconds, log)


def stream_handle(device) -> int:
    """PyTorch's current stream on ``device``, as the pointer the C entries take."""
    return torch.cuda.current_stream(device).cuda_stream
