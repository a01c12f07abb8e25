"""Matter coupling through the port's normal entry points: emission sourcing, the
absorption deposition and the fluid update, against the JAX package on the
``inputs/inf.in`` deck, plus ledger growth and determinism on a small version of
the 64^3 feedback configuration (``bench.py``'s ``big_mesh_feedback`` row).

``inf.in`` runs with ``do_feedback = true`` and ``mcblock/cv = 1e-13`` erg/K/g.
Both packages read the specific heat from ``mcblock/cv`` (the deck's
``specific_heat`` key is read by neither, so it defaults to 1 / (gamma - 1) = 1.5);
at 1e-13 the matter's energy (1e-13 erg/cm^3) is 13 times the radiation's
(a T^4 = 7.6e-15) rather than 2e14 times: float32 can then show the exchange in
``u``, and total energy conservation tests the emission debit and the absorption
deposit."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaybenne_tpu import config as jcm
from jaybenne_tpu.driver import Simulation as JSimulation
from jaybenne_tpu.utils.deck import Deck as JDeck

from jaybenne_tpu_torch import bridge
from jaybenne_tpu_torch import config as tcm
from jaybenne_tpu_torch.driver import Simulation
from jaybenne_tpu_torch.mesh import build_mesh
from jaybenne_tpu_torch.step import build_step_core
from jaybenne_tpu_torch.utils.deck import Deck as TDeck

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INF = os.path.join(_ROOT, "inputs", "inf.in")
STEPDIFF = os.path.join(_ROOT, "inputs", "stepdiff.in")
INF_MODS = {
    "jaybenne/num_particles": 300,
    "jaybenne/do_feedback": "true",
    "mcblock/cv": 1.0e-13,
    "parthenon/output0/file_type": "none",
}
# bench.py's big_mesh_feedback overrides (its specific_heat key is read by
# neither package) at 8^3 cells in 4^3 blocks and 2000
# particles, with scattering cut from 1e3 to 1e2 per cm so that a census is ~100
# events long on the CPU
FEEDBACK_SMALL = {
    "parthenon/mesh/nx1": 8, "parthenon/mesh/nx2": 8, "parthenon/mesh/nx3": 8,
    "parthenon/mesh/ix2_bc": "periodic", "parthenon/mesh/ox2_bc": "periodic",
    "parthenon/mesh/ix3_bc": "periodic", "parthenon/mesh/ox3_bc": "periodic",
    "parthenon/meshblock/nx1": 4, "parthenon/meshblock/nx2": 4,
    "parthenon/meshblock/nx3": 4,
    "jaybenne/num_particles": 2000,
    "jaybenne/do_emission": "true",
    "jaybenne/do_feedback": "true",
    "mcblock/opacity_model": "constant",
    "mcblock/opacity_constant_value": 3.0,
    "mcblock/specific_heat": 30.3,
    "jaybenne/capacity_factor": 3,
    "mcblock/scattering_constant_value": 1.0e2,
    "parthenon/output0/file_type": "none",
}
N_STEPS = 3
# Sum u dV + sum of live weights, relative to the radiation energy: float32
# roundings of u and of the weights, far below this
ENERGY_RTOL = 1e-5
# n * ew against fleck * emis * dV * dt: a few float32 roundings
SOURCE_RTOL = 1e-6
# mean tally and mean u of two independent Monte Carlo runs: within this many
# combined standard deviations of the mean over cells (the medium is homogeneous,
# so the spread over cells estimates each cell's)
N_SIGMA = 5.0
EVENTS_RTOL = 0.05



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are small, and the suite runs in several
    processes at once, where PyTorch's default of one thread per core oversubscribes
    the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _total_energy(fields, particles, dv):
    u = np.asarray(fields.u, np.float64)
    w = np.asarray(particles.weight, np.float64)[np.asarray(particles.alive)]
    return float((u * dv).sum()), float(w.sum())


def _expected_source(cfg, rho, sie, fleck, dv, dt):
    """fleck * emis * dV * dt per cell from the fields before the step, in the
    port's models."""
    m = cfg.mcblock
    temp = m.build_eos().temperature_from_density_internal_energy(rho, sie)
    return (fleck * m.build_opacity().emissivity(rho, temp) * dv * dt).double().numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


def test_inf_feedback_slice_matches_jax(tmp_path):
    # the JAX package on the CPU runs its XLA event loop either way; "off" also
    # keeps its ledger from being rounded up to 16384 kernel-tile slots
    jcfg = jcm.from_deck(JDeck.from_file(INF).update({**INF_MODS, "jaybenne/use_pallas": "off"}))
    tcfg = tcm.from_deck(TDeck.from_file(INF).update(dict(INF_MODS)))
    jsim = JSimulation(jcfg, outdir=str(tmp_path), quiet=True)
    js = jsim.state
    d = {
        "fields": {f.name: np.asarray(getattr(js.fields, f.name))
                   for f in dataclasses.fields(js.fields)},
        "particles": {f.name: np.asarray(getattr(js.particles, f.name))
                      for f in dataclasses.fields(js.particles)},
        "t": float(js.t), "cycle": int(js.cycle), "overflow": int(js.overflow),
        "seed": jcfg.jaybenne.seed,
    }
    ts = bridge.state_from_numpy(d)
    tmesh = build_mesh(tcfg.mesh)
    assert tmesh.ndim == 3 and tmesh.total_cells == 64
    dv = tmesh.block_volume.double().numpy()[:, None, None, None]
    dvt = tmesh.block_volume[:, None, None, None]
    um0, er0 = _total_energy(ts.fields, ts.particles, dv)
    assert 5.0 < um0 / er0 < 20.0  # matter and radiation of a size

    step = build_step_core(tmesh, tcfg)
    dt = tcfg.jaybenne.dt
    ev_t = ev_j = 0
    for _ in range(N_STEPS):
        pre = [(_t(s.fields.rho), _t(s.fields.sie)) for s in (ts, js)]
        js, jstats = jsim.step_fn(js, jnp.float32(dt))
        ts, tstats = step(ts, dt)
        ev_j += int(jstats.events)
        ev_t += int(tstats.events)
        assert int(tstats.dropped) == 0 and int(jstats.dropped) == 0
        assert int(tstats.unfinished) == 0 and int(tstats.cap_hits) == 0
        for s, (rho, sie) in zip((ts, js), pre):
            want = _expected_source(tcfg, rho, sie, _t(s.fields.fleck), dvt, dt)
            got = np.asarray(s.fields.source_num, np.float64) * np.asarray(
                s.fields.source_ew, np.float64)
            np.testing.assert_allclose(got, want, rtol=SOURCE_RTOL)
            assert got.sum() > 1e-2 * er0  # each step emits ~3 % of the radiation
    assert ts.overflow == 0 and int(js.overflow) == 0

    for s in (ts, js):
        um, er = _total_energy(s.fields, s.particles, dv)
        assert abs(um + er - (um0 + er0)) <= ENERGY_RTOL * er0, (um + er, um0 + er0)
    assert abs(ev_t - ev_j) / ev_j < EVENTS_RTOL

    for name in ("energy_tally", "u"):
        a = np.asarray(getattr(ts.fields, name), np.float64).reshape(-1)
        b = np.asarray(getattr(js.fields, name), np.float64).reshape(-1)
        sd = np.sqrt((a.var(ddof=1) + b.var(ddof=1)) / a.size)
        assert abs(a.mean() - b.mean()) <= N_SIGMA * sd, (name, a.mean(), b.mean(), sd)


def _small_feedback_sim(tmp_path, **mods):
    cfg = tcm.from_deck(TDeck.from_file(STEPDIFF).update({**FEEDBACK_SMALL, **mods}))
    return Simulation(cfg, outdir=str(tmp_path), quiet=True, device="cpu")


def _conservation(sim, e0, er0):
    dv = sim.mesh.block_volume.double().numpy()[:, None, None, None]
    um, er = _total_energy(sim.state.fields, sim.state.particles, dv)
    return abs(um + er - e0) / er0


def test_ledger_grows_instead_of_dropping(tmp_path):
    """capacity_factor 0.5 leaves room for half the particles of one step's
    emission: the driver grows the ledger before the step, drops nothing, and
    total energy stays conserved."""
    sim = _small_feedback_sim(tmp_path, **{"jaybenne/capacity_factor": 0.5})
    cap0 = sim.state.particles.capacity
    dv = sim.mesh.block_volume.double().numpy()[:, None, None, None]
    um0, er0 = _total_energy(sim.state.fields, sim.state.particles, dv)
    sim.run(nlim=2)
    p = sim.state.particles
    assert p.capacity >= 2 * cap0
    assert all(h["dropped"] == 0 for h in sim.history) and sim.state.overflow == 0
    assert int(p.num_alive()) > cap0
    assert _conservation(sim, um0 + er0, er0) <= ENERGY_RTOL


def test_feedback_runs_are_deterministic(tmp_path):
    """Two CPU runs of the small feedback deck with the same seed give bitwise-equal
    tallies and matter energies, and each conserves total energy."""
    fields = []
    for k in range(2):
        sim = _small_feedback_sim(tmp_path / f"r{k}")
        dv = sim.mesh.block_volume.double().numpy()[:, None, None, None]
        um0, er0 = _total_energy(sim.state.fields, sim.state.particles, dv)
        u0 = sim.state.fields.u.clone()
        sim.run(nlim=2)
        assert sim.cycle == 2 and all(h["dropped"] == 0 for h in sim.history)
        assert _conservation(sim, um0 + er0, er0) <= ENERGY_RTOL
        assert not torch.equal(sim.state.fields.u, u0)  # feedback moved the matter
        fields.append(sim.state.fields)
    a, b = fields
    assert torch.equal(a.energy_tally, b.energy_tally)
    assert torch.equal(a.u, b.u)


def test_cli_runs_feedback_deck(tmp_path):
    cmd = [sys.executable, "-m", "jaybenne_tpu_torch.driver", "-i", STEPDIFF,
           "-d", str(tmp_path), "-n", "1", "--device", "cpu",
           *(f"{k}={v}" for k, v in FEEDBACK_SMALL.items())]
    res = subprocess.run(cmd, cwd=_ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "cycle=1 " in res.stdout and "WARNING" not in res.stderr
