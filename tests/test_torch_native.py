"""The port's native mesh-forest builder (``jaybenne_tpu_torch/native/``) against the
JAX package's native builder and against the port's Python builder, its build when
processes build at once, and its refusal to fall back. Skips where g++ is missing.

At import this module makes sure that the JAX package's library
(``jaybenne_tpu/native/libjbmesh.so``) is whole before any test runs
(``_jax_library_in_place``): the JAX loader builds it in place with g++ at its first
call and caches None where that build or the load fails, so pytest-xdist workers
that all call it at once raced, and one that lost the race skipped the native tests
for the rest of the run. Every worker imports this module while it collects,
before it runs a test, and no test module calls a JAX ``build_mesh`` at import."""

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from jaybenne_tpu import native as jnative
from jaybenne_tpu_torch import config as tcm
from jaybenne_tpu_torch import native
from jaybenne_tpu_torch.config import MeshConfig, RefinementRegion
from jaybenne_tpu_torch.mesh import build_mesh
from jaybenne_tpu_torch.utils.deck import Deck

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# native/build.sh: the JAX package's library, its source and g++'s flags
_JAX_LIB = os.path.join(_ROOT, "jaybenne_tpu", "native", "libjbmesh.so")
_JAX_SRC = os.path.join(_ROOT, "native", "mesh_builder.cc")
_JAX_GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def _loads(path) -> bool:
    """Whether ``path`` loads as a library with the builder's two entries."""
    try:
        lib = ctypes.CDLL(path)
        return all(hasattr(lib, name) for name in ("jb_mesh_query", "jb_mesh_fill"))
    except OSError:
        return False


def _jax_library_in_place() -> None:
    """Where g++ is present and the JAX package's library is missing or does not
    load, compiles ``native/mesh_builder.cc`` with ``native/build.sh``'s command and
    flags into a file named by this process and renames it into place: the bytes
    the JAX loader would build, written at once, so that its in-place build never
    runs and no process loads a half-written file. Processes that do this at once
    each rename a whole library."""
    gxx = shutil.which("g++")
    if gxx is None or (os.path.exists(_JAX_LIB) and _loads(_JAX_LIB)):
        return
    tmp = f"{_JAX_LIB}.{os.getpid()}.tmp"
    try:
        subprocess.run([gxx, *_JAX_GXX_FLAGS, os.path.basename(_JAX_SRC), "-o", tmp],
                       cwd=os.path.dirname(_JAX_SRC), check=True, capture_output=True,
                       timeout=300)
        os.replace(tmp, _JAX_LIB)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


_jax_library_in_place()


@pytest.fixture(autouse=True)
def _needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the native builder cannot be built here")


def _smr_cfg():
    """tests/test_native.py's level-1 forest."""
    return MeshConfig(
        nx1=64, nx2=32, nx3=1,
        x1min=-0.5, x1max=0.5, x2min=-0.25, x2max=0.25, x3min=-0.5, x3max=0.5,
        mbnx1=16, mbnx2=16, mbnx3=1,
        refinement="static",
        refinement_regions=(
            RefinementRegion(level=1, x1min=-0.25, x1max=0.25,
                             x2min=-0.25, x2max=0.25, x3min=-0.5, x3max=0.5),
        ),
    )


def _deck(name):
    return tcm.from_deck(Deck.from_file(os.path.join(_ROOT, "inputs", name))).mesh


# tests/test_native.py's two meshes, the three-level and the 3D forests, and a
# uniform 3D mesh of several blocks
MESHES = {
    "smr_level1": _smr_cfg,
    "uniform_1d": lambda: MeshConfig(nx1=100, nx2=1, nx3=1, x1min=-0.5, x1max=0.5,
                                     x2min=-0.5, x2max=0.5, x3min=-0.5, x3max=0.5, mbnx1=50),
    "stepdiff_smr2": lambda: _deck("stepdiff_smr2.in"),
    "stepdiff_3d": lambda: _deck("stepdiff_3d_smr_ddmc.in"),
    "uniform_3d": lambda: MeshConfig(nx1=16, nx2=16, nx3=16, x1min=-0.5, x1max=0.5,
                                     x2min=-0.5, x2max=0.5, x3min=-0.5, x3max=0.5,
                                     mbnx1=8, mbnx2=8, mbnx3=8),
}


def _forest_args(cfg):
    nz_b, ny_b, nx_b = cfg.block_shape
    nrb = (cfg.nx1 // nx_b, cfg.nx2 // ny_b, cfg.nx3 // nz_b)
    regions = cfg.refinement_regions if cfg.refinement == "static" else ()
    return (cfg.ndim, nrb, (cfg.x1min, cfg.x2min, cfg.x3min),
            (cfg.x1max, cfg.x2max, cfg.x3max), regions)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_native_forest_is_the_jax_packages(name):
    """The port's native forest is bitwise the JAX package's native forest (loaded
    as tests/test_native.py loads it): origins, sizes, levels, lookup grid and
    the finest level."""
    assert jnative.load_mesh_builder() is not None, (
        "the JAX package's native builder does not load though g++ is present")
    args = _forest_args(MESHES[name]())
    got = native.build_forest_native(*args)
    want = jnative.build_forest_native(*args)
    assert want is not None
    for a, b in zip(got[:4], want[:4]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    assert got[4] == want[4]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_native_mesh_is_the_python_mesh(name, dtype):
    """``build_mesh`` with the native builder (the default) against the Python
    builder: every tensor bitwise, on uniform meshes and on forests alike (the
    JAX package's own test allows 1e-12 on forests; no bit differs), and every
    derived shape."""
    cfg = MESHES[name]()
    a = build_mesh(cfg, dtype=dtype)
    b = build_mesh(cfg, dtype=dtype, use_native=False)
    for key in ("ndim", "nx", "ny", "nz", "n_blocks", "max_level", "bounds", "tile_shape",
                "root_grid", "finest"):
        assert getattr(a, key) == getattr(b, key), key
    for key in ("block_origin", "block_dx", "block_level", "lookup"):
        assert torch.equal(getattr(a, key), getattr(b, key)), key
        assert getattr(a, key).dtype == getattr(b, key).dtype, key


_BUILD = ("import sys; from jaybenne_tpu_torch import native; "
          "print(native.load_mesh_builder(sys.argv[1]).path)")


def test_processes_building_at_once_leave_one_library(tmp_path):
    """Two processes that build into one empty directory at once each load a
    library, and leave one library and no temporary file behind."""
    env = {**os.environ, "PYTHONPATH": _ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    files = sorted(f.name for f in tmp_path.iterdir())
    assert len(files) == 1 and files[0].startswith("libjbmesh_") and files[0].endswith(".so")
    assert {o[0].strip() for o in outs} == {str(tmp_path / files[0])}
    lib = native.load_mesh_builder(str(tmp_path))
    assert lib.lib.jb_mesh_query is not None


@pytest.mark.parametrize("fault", ["no_compiler", "build_fails"])
def test_native_build_failure_raises(fault, tmp_path, monkeypatch):
    """With no library built yet, ``build_mesh`` raises when g++ cannot be found or
    the build fails (with the compiler's output), and does not fall back to the
    Python builder."""
    native.load_mesh_builder.cache_clear()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    if fault == "no_compiler":
        monkeypatch.setattr(native.shutil, "which", lambda name: None)
        match = "g\\+\\+ not found"
    else:
        bad = tmp_path / "broken.cc"
        bad.write_text("this is not C++\n")
        monkeypatch.setattr(native, "SRC", bad)
        match = "g\\+\\+ failed(.|\\n)*error"
    try:
        with pytest.raises(RuntimeError, match=match):
            build_mesh(_smr_cfg())
        assert not (tmp_path / "build").exists() or not any((tmp_path / "build").iterdir())
    finally:
        native.load_mesh_builder.cache_clear()


def test_simulation_builds_its_forest_natively(tmp_path, monkeypatch):
    """The driver builds its mesh with the native builder, as the JAX driver does
    (``jaybenne_tpu/driver.py:48``)."""
    from jaybenne_tpu_torch.driver import Simulation

    calls = []
    real = native.build_forest_native
    monkeypatch.setattr(native, "build_forest_native",
                        lambda *args: calls.append(args) or real(*args))
    cfg = tcm.from_deck(Deck.from_file(os.path.join(_ROOT, "inputs", "stepdiff_smr.in")).update(
        {"jaybenne/num_particles": 200, "parthenon/output0/file_type": "none"}))
    sim = Simulation(cfg, outdir=str(tmp_path), quiet=True, device="cpu")
    assert len(calls) == 1 and sim.mesh.n_blocks == 20
