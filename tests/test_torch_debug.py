"""The port's ``debug_checks`` (``utils/debug.py``) against the JAX package's,
``history.json``, ``--profile-dir``, and a run without ``h5py`` (as on a GPU
machine that has none), on the CPU."""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaybenne_tpu import config as jcm
from jaybenne_tpu.driver import Simulation as JSimulation
from jaybenne_tpu.utils import debug as jdebug
from jaybenne_tpu.utils.deck import Deck as JDeck

from jaybenne_tpu_torch import bridge
from jaybenne_tpu_torch import config as tcm
from jaybenne_tpu_torch import driver as tdriver
from jaybenne_tpu_torch.driver import Simulation
from jaybenne_tpu_torch.mesh import build_mesh
from jaybenne_tpu_torch.profile import device_time_by_name, span_kernels
from jaybenne_tpu_torch.utils.debug import InvariantError, validate_state
from jaybenne_tpu_torch.utils.deck import Deck as TDeck

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPDIFF = os.path.join(_ROOT, "inputs", "stepdiff.in")
SMALL = {
    "parthenon/mesh/nx1": 32,
    "parthenon/meshblock/nx1": 16,
    "jaybenne/num_particles": 2000,
    "mcblock/scattering_constant_value": 2.0e2,
    "parthenon/time/tlim": "6.671282e-11",  # two cycles
    "parthenon/output0/file_type": "none",
}

# one corruption of a live particle (slot ``k``) or a field, applied alike to a
# flattened state of either package; "none" leaves the state healthy
CORRUPTIONS = {
    "none": lambda d, k: None,
    "cell_i": lambda d, k: d["particles"]["i"].__setitem__(k, 999),
    "nan_weight": lambda d, k: d["particles"]["weight"].__setitem__(k, np.nan),
    "outside_block": lambda d, k: d["particles"]["x"].__setitem__(k, -1.0),
    "tau_past_one": lambda d, k: d["particles"]["tau"].__setitem__(k, 1.5),
    "speed_off_c": lambda d, k: d["particles"]["vx"].__setitem__(
        k, 2.0 * d["particles"]["vx"][k] + 3.0e10),
    "negative_tally": lambda d, k: d["fields"]["energy_tally"].__setitem__(
        (0, 0, 0, 3), -1.0),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcfg(**mods):
    return tcm.from_deck(TDeck.from_file(STEPDIFF).update({**SMALL, **mods}))


def _jcfg(**mods):
    return jcm.from_deck(JDeck.from_file(STEPDIFF).update({**SMALL, **mods}))


def test_healthy_run_validates_every_cycle(tmp_path, monkeypatch):
    """``jaybenne/debug_checks = true`` validates the state after every step, and
    a healthy run passes, under the spatial decomposition too."""
    calls = []

    def counted(state, mesh, cfg):
        calls.append(int(state.cycle))
        validate_state(state, mesh, cfg)

    monkeypatch.setattr(tdriver, "validate_state", counted)
    for mods in ({}, {"jaybenne/decomposition": "spatial", "jaybenne/n_devices": 2}):
        calls.clear()
        sim = Simulation(_tcfg(**{"jaybenne/debug_checks": "true", **mods}),
                         outdir=str(tmp_path), quiet=True, device="cpu")
        sim.run()
        assert calls == [1, 2], mods


@pytest.mark.parametrize("name", ["cell_i", "nan_weight"])
def test_broken_state_raises(name, tmp_path):
    """``i = 999`` or a NaN weight on a live particle raises ``InvariantError``,
    directly and through ``Simulation``'s check after a step."""
    cfg = _tcfg()
    sim = Simulation(cfg, outdir=str(tmp_path), quiet=True, device="cpu")
    d = bridge.state_to_numpy(sim.state)
    k = int(np.flatnonzero(d["particles"]["alive"])[0])
    CORRUPTIONS[name](d, k)
    d["seed"] = sim.state.seed
    with pytest.raises(InvariantError):
        validate_state(bridge.state_from_numpy(d), sim.mesh, cfg)

    broken = Simulation(_tcfg(**{"jaybenne/debug_checks": "true"}), outdir=str(tmp_path),
                        quiet=True, device="cpu")
    step = broken.step_fn

    def corrupting(state, dt):
        state, stats = step(state, dt)
        p = state.particles
        slot = int(torch.nonzero(p.alive)[0])
        (p.i if name == "cell_i" else p.weight)[slot] = 999 if name == "cell_i" else np.nan
        return state, stats

    broken.step_fn = corrupting
    with pytest.raises(InvariantError):
        broken.run(nlim=1)


@pytest.mark.parametrize("name", list(CORRUPTIONS))
def test_validate_state_agrees_with_jax(name, tmp_path):
    """On one JAX state and its bridge into the port, each corruption raises in
    both packages' ``validate_state`` or in neither."""
    jcfg = _jcfg()
    jsim = JSimulation(jcfg, outdir=str(tmp_path), quiet=True)
    js = jsim.state
    d = {"fields": {f.name: np.array(getattr(js.fields, f.name))
                    for f in dataclasses.fields(js.fields)},
         "particles": {f.name: np.array(getattr(js.particles, f.name))
                       for f in dataclasses.fields(js.particles)}}
    k = int(np.flatnonzero(d["particles"]["alive"])[0])
    CORRUPTIONS[name](d, k)
    jbroken = dataclasses.replace(
        js, fields=dataclasses.replace(js.fields, **{n: jnp.asarray(v)
                                                    for n, v in d["fields"].items()}),
        particles=dataclasses.replace(js.particles, **{n: jnp.asarray(v)
                                                      for n, v in d["particles"].items()}))
    tbroken = bridge.state_from_numpy({**d, "t": 0.0, "cycle": 0, "overflow": 0, "seed": 1})
    tcfg = _tcfg()

    def raises(fn, *args):
        try:
            fn(*args)
        except AssertionError as e:  # both InvariantErrors derive from it
            return str(e)
        return None

    got = raises(validate_state, tbroken, build_mesh(tcfg.mesh), tcfg)
    want = raises(jdebug.validate_state, jbroken, jsim.mesh, jcfg)
    assert got == want
    assert (got is None) == (name == "none")


def test_history_json_has_the_jax_keys(tmp_path):
    """``history.json`` holds the JAX package's top-level and per-cycle keys, and
    the port's ``step_seconds`` a cycle."""
    JSimulation(_jcfg(), outdir=str(tmp_path / "jax"), quiet=True).run()
    sim = Simulation(_tcfg(), outdir=str(tmp_path / "port"), quiet=True, device="cpu")
    sim.run()
    want = json.loads((tmp_path / "jax" / "history.json").read_text())
    got = json.loads((tmp_path / "port" / "history.json").read_text())
    assert sorted(got) == sorted(want) == ["cycles", "problem_id", "total_events",
                                           "walltime_s"]
    assert got["problem_id"] == want["problem_id"] and got["total_events"] == sim.total_events
    assert len(got["cycles"]) == len(want["cycles"]) == 2
    for g, w in zip(got["cycles"], want["cycles"]):
        assert sorted(g) == sorted(list(w) + ["step_seconds"])
        assert (g["cycle"], g["dt"]) == (w["cycle"], w["dt"])


def test_profile_dir_writes_a_readable_trace(tmp_path):
    """``--profile-dir`` on the CPU runs the run under ``torch.profiler`` and writes
    a Chrome trace that ``profile.device_time_by_name`` reads (no device events
    here: a CPU run has none)."""
    assert tdriver.main(["-i", STEPDIFF, "-d", str(tmp_path / "o"), "-q", "-n", "1",
                         "--device", "cpu", "--profile-dir", str(tmp_path / "prof"),
                         *(f"{k}={v}" for k, v in SMALL.items())]) == 0
    trace = tmp_path / "prof" / "trace.json"
    assert trace.exists()
    assert json.loads(trace.read_text())["traceEvents"]
    assert device_time_by_name(str(trace)) == {}
    assert len(json.loads((tmp_path / "o" / "history.json").read_text())["cycles"]) == 1


def test_span_kernels_reads_the_work_inside_each_span(tmp_path):
    """``profile.span_kernels`` sums, by name, the device events that start inside
    a span's device interval, and leaves out host events and device events outside
    it."""
    events = [{"cat": "gpu_user_annotation", "name": "step.face_probs", "ts": 10.0, "dur": 20.0},
              {"cat": "kernel", "name": "cat", "ts": 11.0, "dur": 2.0},
              {"cat": "kernel", "name": "cat", "ts": 20.0, "dur": 3.0},
              {"cat": "gpu_memset", "name": "Memset", "ts": 25.0, "dur": 1.0},
              {"cat": "kernel", "name": "census", "ts": 31.0, "dur": 5.0},
              {"cat": "cpu_op", "name": "aten::cat", "ts": 12.0, "dur": 1.0}]
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"traceEvents": events}))
    assert span_kernels(str(trace)) == {"step.face_probs": {"cat": 5.0, "Memset": 1.0}}


_NO_H5PY = """
import sys
sys.modules["h5py"] = None  # as on a machine without h5py
import numpy as np, torch
from jaybenne_tpu_torch import config, io
from jaybenne_tpu_torch.driver import Simulation
from jaybenne_tpu_torch.utils.deck import Deck
mods = {"parthenon/mesh/nx1": 32, "parthenon/meshblock/nx1": 16,
        "jaybenne/num_particles": 1000, "parthenon/time/tlim": "6.671282e-11",
        "mcblock/scattering_constant_value": 200.0, "parthenon/output0/file_type": "none"}
cfg = config.from_deck(Deck.from_file(sys.argv[1]).update(mods))
a = Simulation(cfg, outdir=sys.argv[2], quiet=True, device="cpu")
a.run(nlim=1)
np.savez(sys.argv[2] + "/tree.npz", **a.checkpoint_tree())
b = Simulation(cfg, outdir=sys.argv[2], quiet=True, device="cpu",
               restart=dict(np.load(sys.argv[2] + "/tree.npz")))
b.run()
a.run()
assert b.cycle == a.cycle == 2
assert torch.equal(a.state.fields.energy_tally, b.state.fields.energy_tally)
try:
    io.write_checkpoint(sys.argv[2] + "/x.rhdf", a.state, a.mesh)
except RuntimeError as e:
    assert "h5py" in str(e)
    print("REFUSED", e)
else:
    raise AssertionError("an HDF5 file was written without h5py")
print("OK")
"""


def test_runs_without_h5py(tmp_path):
    """With ``h5py`` unimportable, a ``file_type = none`` run and a restart from a
    checkpoint tree (through ``np.savez``) work, bitwise; asking for an HDF5 file
    raises ``RuntimeError``."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = _ROOT
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "-c", _NO_H5PY, STEPDIFF, str(tmp_path)], cwd=_ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "REFUSED" in res.stdout and res.stdout.strip().endswith("OK")
