"""The native (C++) mesh-forest builder, loaded with ctypes (port of
``jaybenne_tpu/native/__init__.py``).

``mesh_builder.cc`` here is the JAX package's ``native/mesh_builder.cc``, byte for
byte, so the package builds from its own tree. It is compiled with ``g++`` at
first use, with ``native/build.sh``'s flags, into ``jaybenne_tpu_torch/_build/``
(listed in ``.gitignore``) under a file name keyed by a hash of the source and the
flags: an unchanged source loads at once. The library is written to a file named
by the process id and renamed into place, so that processes that build at once
leave one whole library.

There is no fallback: where ``g++`` is missing or the build or the load fails,
``load_mesh_builder`` raises with the compiler's output (the JAX package's loader
returns None and its ``build_mesh`` quietly takes the Python builder). The Python
builder stays in ``mesh.py`` (``build_mesh(use_native=False)``) as the plain
version the tests hold this one against. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "mesh_builder.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# native/build.sh:6
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_L, _I, _DP, _IP = ctypes.c_long, ctypes.c_int, ctypes.POINTER(ctypes.c_double), \
    ctypes.POINTER(ctypes.c_int)
# jaybenne_tpu/native/__init__.py:44-60
_SIGNATURES = {
    "jb_mesh_query": (_I, _L, _L, _L, _DP, _DP, _I, _DP, _IP),
    "jb_mesh_fill": (_I, _L, _L, _L, _DP, _DP, _I, _DP, _DP, _DP, _IP, _IP),
}


class MeshBuilder:
    """The loaded library: ``path``, the seconds its build took in this process
    (0.0 where it was already built) and the compiler's output."""

    def __init__(self, path: Path, build_seconds: float, build_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int


def gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the native mesh builder needs a C++ compiler")
    return found


@functools.lru_cache(maxsize=None)
def load_mesh_builder(build_dir=None) -> MeshBuilder:
    """The native builder, built into ``build_dir`` (``BUILD_DIR`` by default) at
    the first call for this source; raises where it cannot be built or loaded."""
    out = Path(build_dir) if build_dir is not None else BUILD_DIR
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    so = out / f"libjbmesh_{h.hexdigest()[:16]}.so"
    if so.exists():
        return MeshBuilder(so, 0.0, "")
    out.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    res = subprocess.run([gxx(), *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                         capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = res.stdout + res.stderr
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build the native mesh builder:\n{log}")
    os.replace(tmp, so)
    return MeshBuilder(so, seconds, log)


def build_forest_native(ndim, nrb, gmin, gmax, regions):
    """(origin[B, 3], size[B, 3], level[B], lookup[ntz, nty, ntx], max_level) of the
    forest, built by the native builder with the JAX package's calls
    (``jaybenne_tpu/native/__init__.py:63-105``). Raises where the builder
    refuses the mesh."""
    lib = load_mesh_builder().lib
    gmin_a = (ctypes.c_double * 3)(*[float(v) for v in gmin])
    gmax_a = (ctypes.c_double * 3)(*[float(v) for v in gmax])
    reg_flat = np.asarray(
        [[r.level, r.x1min, r.x1max, r.x2min, r.x2max, r.x3min, r.x3max] for r in regions],
        dtype=np.float64,
    ).reshape(-1)
    reg_ptr = (reg_flat.ctypes.data_as(_DP) if reg_flat.size else _DP())
    max_level = ctypes.c_int(0)
    n_blocks = lib.jb_mesh_query(ndim, nrb[0], nrb[1], nrb[2], gmin_a, gmax_a, len(regions),
                                 reg_ptr, ctypes.byref(max_level))
    if n_blocks <= 0:
        raise RuntimeError(f"native mesh builder: jb_mesh_query returned {n_blocks}")
    ml = max_level.value
    nt = [nrb[d] * (2**ml if d < ndim else 1) for d in range(3)]
    origin = np.zeros((n_blocks, 3), dtype=np.float64)
    size = np.zeros((n_blocks, 3), dtype=np.float64)
    level = np.zeros((n_blocks,), dtype=np.int32)
    lookup = np.zeros((nt[2], nt[1], nt[0]), dtype=np.int32)
    rc = lib.jb_mesh_fill(ndim, nrb[0], nrb[1], nrb[2], gmin_a, gmax_a, len(regions), reg_ptr,
                          origin.ctypes.data_as(_DP), size.ctypes.data_as(_DP),
                          level.ctypes.data_as(_IP), lookup.ctypes.data_as(_IP))
    if rc != 0:
        raise RuntimeError(f"native mesh builder: jb_mesh_fill returned {rc}")
    return origin, size, level, lookup, ml
