"""The external volume source and the power-law-cv EOS in the port against the
JAX package: ports of tests/test_external_source.py's single-device gates (exact
energy bookkeeping through emission and feedback, the source-window cutoff, the
diffusion-limit pulse variance, the EOS), the source's ledger headroom, and a small
Su-Olson run (inputs/suolson.in) held to tst/suolson.py's bookkeeping gate and to
the JAX package's energies.

Both packages draw their births from different random streams, so runs agree in
the energies that the bookkeeping fixes exactly and, within Monte Carlo noise, in
how they split between matter and radiation."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaybenne_tpu import config as jcm
from jaybenne_tpu.driver import Simulation as JSimulation
from jaybenne_tpu.models import eos as jeos
from jaybenne_tpu.utils.deck import Deck as JDeck

from jaybenne_tpu_torch import config as tcm
from jaybenne_tpu_torch.driver import Simulation
from jaybenne_tpu_torch.models import eos as teos
from jaybenne_tpu_torch.ops import sourcing
from jaybenne_tpu_torch.utils.constants import CC
from jaybenne_tpu_torch.utils.deck import Deck as TDeck

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT = 1.0e-11
# the deck of tests/test_external_source.py
DECK = f"""
<parthenon/job>
problem_id = uniform

<parthenon/mesh>
nx1 = 16
x1min = -0.5
x1max = 0.5

<parthenon/time>
tlim = {4 * DT}

<jaybenne>
num_particles = 4096
dt = {DT}
seed = 7
external_source = 1.0e9
external_source_x1min = -0.5
external_source_x1max = 0.0
external_source_num = 4000

<mcblock>
eos_model = power_law_cv
cv_alpha = 1.0
opacity_model = constant
opacity_constant_value = 1.0
initial_density = 1.0
initial_temperature = 1.0e-2
initial_radiation = none
"""
# tests/test_external_source.py's tolerances: the bookkeeping (2e-3: float32
# sums), the per-cycle sourced energy (1e-5), the EOS (1e-6 forward, 1e-5 for
# the root), the pulse variance (6 %)
BOOK_RTOL = 2e-3
WINDOW_RTOL = 1e-5
EOS_RTOL = 1e-6
ROOT_RTOL = 1e-5
VAR_RTOL = 0.06
# tst/suolson.py's gate
SUOLSON_TOL = 1e-2
# the matter/radiation split of two Monte Carlo runs: their matter energies (each
# a sum over some 10^4 absorption histories) within this fraction of each other
SPLIT_RTOL = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are small, and the suite runs in several
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(mods=None, tmp_path=".", deck=DECK):
    return Simulation(tcm.from_deck(TDeck.parse(deck).update(mods or {})),
                      outdir=str(tmp_path), quiet=True, device="cpu")


def _energies(sim):
    """(matter, radiation) total energies [erg] of a port or JAX simulation."""
    f, p = sim.state.fields, sim.state.particles
    dv = np.asarray(sim.mesh.block_volume, np.float64)
    u = np.asarray(f.u, np.float64)
    mat = float((u.reshape(u.shape[0], -1).sum(axis=1) * dv).sum())
    alive = np.asarray(p.alive)
    return mat, float(np.asarray(p.weight, np.float64)[alive].sum())


def test_external_source_conservation_single(tmp_path):
    """Port of the JAX test: injected == matter gain + radiation gain through
    emission, absorption and feedback; the particle budget divides evenly over the 8
    source cells, so the injected total is exact. The JAX package's run of the same
    deck splits the energy alike."""
    sim = _port(tmp_path=tmp_path)
    assert sim.state.particles.capacity >= 4096 * 2 + 4000  # the source's headroom
    e0 = sum(_energies(sim))
    sim.run()
    assert int(sim.state.overflow) == 0 and sim.cycle == 4
    e1 = _energies(sim)
    dv = float(sim.mesh.block_volume[0])
    inj = sim.cfg.jaybenne.external_source_q * 8 * dv * 4 * DT
    assert inj > 100 * e0  # the budget is dominated by the injection
    np.testing.assert_allclose(sum(e1) - e0, inj, rtol=BOOK_RTOL)
    jsim = JSimulation(jcm.from_deck(JDeck.parse(DECK)), quiet=True)
    jsim.run()
    j1 = _energies(jsim)
    np.testing.assert_allclose(sum(e1), sum(j1), rtol=BOOK_RTOL)
    np.testing.assert_allclose(e1[0], j1[0], rtol=SPLIT_RTOL)


def test_external_source_tmax_cutoff(tmp_path):
    """The source window [t, min(t + dt, tmax)) injects a partial step's worth when
    tmax lands mid-step and nothing afterwards: births uniform over the window."""
    sim = _port({"jaybenne/external_source_tmax": 1.5 * DT, "jaybenne/do_emission": "false",
                 "jaybenne/do_feedback": "false"}, tmp_path)
    dv = float(sim.mesh.block_volume[0])
    q = sim.cfg.jaybenne.external_source_q
    state = sim.state
    per_cycle = []
    for _ in range(3):
        state, _ = sim.step_fn(state, DT)
        f = state.fields
        per_cycle.append(float((f.source_num.double() * f.source_ew.double()).sum()))
    expect = [q * 8 * dv * DT, q * 8 * dv * 0.5 * DT, 0.0]
    np.testing.assert_allclose(per_cycle, expect, rtol=WINDOW_RTOL, atol=1e-30)
    # past the cutoff no particles are born at all
    assert float(state.fields.source_num.sum()) == 0.0
    assert state.t == pytest.approx(3 * DT)


def test_external_births_in_the_window(tmp_path):
    """A source window of half a step births every particle at tau in [0, 0.5),
    only in the source box, and debits nothing from the matter."""
    sim = _port({"jaybenne/external_source_tmax": 0.5 * DT, "jaybenne/do_emission": "false",
                 "jaybenne/do_feedback": "false", "jaybenne/external_source_num": 800},
                tmp_path)
    ext = sourcing.external_source_setup(sim.mesh, sim.cfg.jaybenne)
    assert ext.n_cells == 8 and ext.cells.tolist() == list(range(8))
    f, p = sim.state.fields, sim.state.particles
    f, p, dropped = sourcing.source_photons(
        f, p, sim.mesh, torch.Generator().manual_seed(3), source_type="external",
        eos=sim.cfg.mcblock.build_eos(), sb=5.670374419e-5, c=CC, num_particles=800,
        dtype=torch.float32, dt=DT, t=0.0, external=ext)
    assert int(dropped) == 0 and int(p.alive.sum()) == 800
    assert float(p.tau[p.alive].max()) < 0.5 and bool((p.i[p.alive] < 8).all())
    assert not bool(f.energy_delta.any())
    np.testing.assert_array_equal(f.source_num.reshape(-1).numpy(), [100.0] * 8 + [0.0] * 8)


def test_external_source_diffusion_variance(tmp_path):
    """Port of the JAX test: a single-cell pulse in a pure-scattering medium
    spreads with the exact isotropic-scattering position variance
    2 D t (1 - (1 - e^(-s))/s), averaged over the in-step birth times."""
    nx, sig, dt, n_steps = 64, 100.0, 2.0e-12, 5
    h = 1.0 / nx
    sim = _port({
        "parthenon/mesh/nx1": nx, "parthenon/time/tlim": n_steps * dt, "jaybenne/dt": dt,
        "jaybenne/num_particles": 1000, "jaybenne/do_emission": "false",
        "jaybenne/do_feedback": "false", "jaybenne/external_source_num": 20000,
        "jaybenne/external_source_x1min": -h, "jaybenne/external_source_x1max": 0.0,
        "jaybenne/external_source_tmax": dt, "mcblock/opacity_model": "none",
        "mcblock/scattering_model": "constant", "mcblock/scattering_constant_value": sig,
    }, tmp_path)
    sim.run()
    p = sim.state.particles
    assert int(p.alive.sum()) == 20000  # no absorption, no escapes (periodic)
    x = (p.x[p.alive].double() + float(sim.mesh.block_origin[0, 0])).numpy()
    d = CC / (3.0 * sig)

    def var_exact(tau):
        s = sig * CC * tau
        return 2.0 * d * tau * (1.0 - (1.0 - np.exp(-s)) / s)

    tb = (np.arange(1000) + 0.5) / 1000 * dt
    expect = var_exact(n_steps * dt - tb).mean() + h * h / 12.0
    np.testing.assert_allclose(float(np.var(x)), expect, rtol=VAR_RTOL)


def test_power_law_cv_eos():
    """Port of the JAX test: sie = alpha T^(n+1)/(n+1), its root and cv = alpha T^n,
    bare and under UnitSystemEOS, against the JAX package on the same inputs."""
    tj = jnp.asarray([1.0e-3, 0.7, 12.0])
    tt = torch.tensor([1.0e-3, 0.7, 12.0])
    pairs = [(jeos.PowerLawCv(alpha=2.5, n=3.0), teos.PowerLawCv(alpha=2.5, n=3.0))]
    pairs.append(tuple(cls(m, temperature_scale=2.0, length_scale=3.0) for cls, m in
                       zip((jeos.UnitSystemEOS, teos.UnitSystemEOS), pairs[0])))
    for jm, tm in pairs:
        sie_j = jm.internal_energy_from_density_temperature(1.0, tj)
        sie_t = tm.internal_energy_from_density_temperature(1.0, tt)
        np.testing.assert_allclose(sie_t.numpy(), np.asarray(sie_j), rtol=EOS_RTOL)
        for name in ("temperature_from_density_internal_energy",
                     "specific_heat_from_density_internal_energy"):
            got = getattr(tm, name)(1.0, sie_t)
            np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jm, name)(1.0, sie_j)),
                                       rtol=ROOT_RTOL, err_msg=name)
    eos = pairs[0][1]
    sie = eos.internal_energy_from_density_temperature(1.0, tt)
    np.testing.assert_allclose(sie.numpy(), (2.5 * tt**4 / 4.0).numpy(), rtol=EOS_RTOL)
    np.testing.assert_allclose(eos.temperature_from_density_internal_energy(1.0, sie).numpy(),
                               tt.numpy(), rtol=ROOT_RTOL)
    np.testing.assert_allclose(eos.specific_heat_from_density_internal_energy(1.0, sie).numpy(),
                               (2.5 * tt**3).numpy(), rtol=ROOT_RTOL)
    wrapped = teos.UnitSystemEOS(eos, temperature_scale=2.0)
    np.testing.assert_allclose(wrapped.temperature_from_density_internal_energy(1.0, sie),
                               (tt / 2.0).numpy(), rtol=ROOT_RTOL)
    # a Python float goes through as a float (the problem generator's call)
    assert eos.internal_energy_from_density_temperature(1.0, 2.0) == pytest.approx(10.0)


def test_suolson_bookkeeping_matches_jax(tmp_path):
    """inputs/suolson.in with tst/suolson.py's overrides (both particle walls
    reflecting: a closed slab), cut to 10 steps and 1600 + 1600 particles (100 a
    source cell, so the injected total is exact): E_matter + E_radiation - E(0)
    equals q V_src min(t, tmax) within the gate's 1e-2, nothing dropped; the JAX
    package's run of the same deck gives the same energies."""
    with open(os.path.join(_ROOT, "inputs", "suolson.in")) as fh:
        deck = fh.read()
    mods = {"parthenon/swarm/ix1_bc": "jaybenne_reflecting",
            "parthenon/swarm/ox1_bc": "jaybenne_reflecting",
            "parthenon/time/tlim": 1.0e-11, "jaybenne/num_particles": 1600,
            "jaybenne/external_source_num": 1600, "parthenon/output0/file_type": "none"}
    out = {}
    for name, sim in (("port", _port(mods, tmp_path, deck)),
                      ("jax", JSimulation(jcm.from_deck(JDeck.parse(deck).update(mods)),
                                          quiet=True))):
        mc, jb = sim.cfg.mcblock, sim.cfg.jaybenne
        sie0 = float(mc.build_eos().internal_energy_from_density_temperature(
            mc.initial_density, mc.initial_temperature))
        e0 = mc.initial_density * sie0 * 1.0
        sim.run()
        assert int(sim.state.overflow) == 0 and sim.cycle == 10, name
        e_mat, e_rad = _energies(sim)
        box = jb.external_source_box
        v_src = (box[1] - box[0]) * (box[3] - box[2]) * (box[5] - box[4])
        injected = jb.external_source_q * v_src * min(sim.t, jb.external_source_tmax)
        err = abs(e_mat + e_rad - e0 - injected) / injected
        assert err <= SUOLSON_TOL, (name, err)
        out[name] = (e_mat, e_rad)
    np.testing.assert_allclose(sum(out["port"]), sum(out["jax"]), rtol=SUOLSON_TOL)
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=SPLIT_RTOL)
