"""Frequency-dependent models in the port against the JAX package: the models of
ROADMAP item 14 (``EPBremss``, ``TabulatedOpacity``, ``ThomsonS`` and their unit
wrappers), the census kernel's non-gray branch (the ``NONGRAY`` instantiations'
plain version) particle by particle over the first events and statistically over
a full census, and ep_bremss decks through both packages' ``Simulation``.

The per-particle comparison gives both packages the same per-cell (rho, T,
fleck), spread so that ``EPBremss`` at the particles' spread photon energies
ranges from optically thin to thick (with DDMC, lanes of one cell take both
branches), and face probabilities rounded through bf16 before either package gets
them. Both evaluate the model per event in float32 in the same order of
operations; their ``exp`` (XLA's and PyTorch's) may differ by an ulp, a rare
branch flip then separates one history, so integer state agrees on ``INT_AGREE``
of the slots and floats within the DDMC tests' tolerances on those."""

import dataclasses
import os

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from jaybenne_tpu import config as jcm
from jaybenne_tpu.driver import Simulation as JSimulation
from jaybenne_tpu.mesh import build_mesh as jbuild_mesh
from jaybenne_tpu.models import opacity as jop
from jaybenne_tpu.ops import fleck as jfleck
from jaybenne_tpu.ops import pallas_bucketed as pb
from jaybenne_tpu.ops import pallas_grid as pg
from jaybenne_tpu.ops import pallas_transport as pt
from jaybenne_tpu.ops import transport as jT
from jaybenne_tpu.particles import ParticleLedger as JLedger
from jaybenne_tpu.step import make_transport_params as jparams
from jaybenne_tpu.utils.deck import Deck as JDeck

from jaybenne_tpu_torch import bridge
from jaybenne_tpu_torch import config as tcm
from jaybenne_tpu_torch.driver import Simulation
from jaybenne_tpu_torch.mesh import build_mesh as tbuild_mesh
from jaybenne_tpu_torch.models import opacity as top
from jaybenne_tpu_torch.ops import transport_kernel
from jaybenne_tpu_torch.ops.transport import TransportCoefs
from jaybenne_tpu_torch.step import make_transport_params as tparams
from jaybenne_tpu_torch.utils.constants import SB
from jaybenne_tpu_torch.utils.deck import Deck as TDeck

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(_ROOT, "inputs")
C = 2.99792458e10
KEY = jr.PRNGKey(20261018)
# the models: both packages run the same float32 operations; pow, log10, exp and
# the power of ten may differ by an ulp or two between XLA and PyTorch. In
# EPBremss's 1 - exp(-xc) at small xc one ulp of exp(-xc) is a relative change of
# ulp / (1 - exp(-xc)) (6e-4 at xc = 1e-4), allowed on top (``_exp_allowance``)
MODEL_RTOL = 1e-6
# per particle over the first events (tests/test_torch_transport_kernel.py,
# tests/test_torch_ddmc.py): one ulp of exp or log may flip a branch
INT_AGREE = 0.999
FLOAT_RTOL = 1e-5
FLOAT_ATOL = {"x": 5e-5, "y": 5e-5, "z": 5e-5, "vx": 5e-4 * C, "vy": 5e-4 * C,
              "vz": 5e-4 * C, "tau": 1e-6}
# full census and whole runs (tests/test_pallas.py:1402-1510): counts within
# N_SIGMA_COUNT sqrt(n), survivors' mean energy within MEAN_E_RTOL, energy
# conserved to ENERGY_RTOL, events within EVENTS_RTOL
N_SIGMA_COUNT = 4.0
MEAN_E_RTOL = 0.3
ENERGY_RTOL = 1e-4
EVENTS_RTOL = 0.05
MEAN_ATOL = 0.01

DECK = """
<parthenon/job>
problem_id = census
<parthenon/mesh>
nx1 = 8
x1min = -0.5
x1max = 0.5
ix1_bc = outflow
ox1_bc = outflow
nx2 = 1
x2min = -0.5
x2max = 0.5
nx3 = 1
x3min = -0.5
x3max = 0.5
<parthenon/swarm>
ix1_bc = jaybenne_reflecting
ox1_bc = jaybenne_reflecting
ix2_bc = periodic
ox2_bc = periodic
ix3_bc = outflow
ox3_bc = outflow
<parthenon/meshblock>
nx1 = 4
nx2 = 1
nx3 = 1
<parthenon/time>
tlim = 1.e-12
<jaybenne>
num_particles = 4000
dt = 1.e-12
tau_ddmc = 5.0
<mcblock>
opacity_model = ep_bremss
scattering_model = constant
scattering_constant_value = 10.0
cv = 1.0e8
initial_density = 1.0
initial_temperature = 1.0e6
initial_radiation = thermal
"""
# (global cells, cells per block) per axis
UNIFORM = {
    1: ((16, 1, 1), (4, 1, 1)),
    2: ((16, 8, 1), (8, 4, 1)),
    3: ((8, 8, 8), (4, 4, 4)),
}
SMR_2D = ("stepdiff_smr.in", {"parthenon/mesh/nx1": 32, "parthenon/mesh/nx2": 16,
                              "parthenon/meshblock/nx1": 8, "parthenon/meshblock/nx2": 8,
                              "jaybenne/tau_ddmc": 5.0, "mcblock/opacity_model": "ep_bremss",
                              "mcblock/scattering_constant_value": 10.0,
                              "mcblock/cv": 1.0e8})
# the deck of tests/test_pallas.py:49-88
PALLAS_DECK = """
<parthenon/job>
problem_id = stepdiff
<parthenon/mesh>
nx1 = 100
x1min = -0.5
x1max = 0.5
ix1_bc = outflow
ox1_bc = outflow
<parthenon/swarm>
ix1_bc = jaybenne_reflecting
ox1_bc = jaybenne_reflecting
<parthenon/meshblock>
nx1 = 50
<parthenon/time>
tlim = 3.335641e-11
<jaybenne>
num_particles = 4000
dt = 3.335641e-11
<mcblock>
opacity_model = none
scattering_model = constant
scattering_constant_value = 2.0e2
cv = 1.0e8
initial_density = 1.0
initial_temperature = 1.0e5
initial_radiation = thermal
"""
N = 4000
N_FACE = 1000  # with DDMC: on a face of their cell with the face-arrival code set
# the ep_bremss overrides of tests/test_pallas.py:1402-1416 and :1531-1546
EPB = {
    "mcblock/opacity_model": "ep_bremss",
    "mcblock/initial_temperature": "1.0e6",
    "mcblock/cv": "1.0e8",
    "mcblock/scattering_constant_value": "1.0e2",
    "jaybenne/do_emission": "false",
    "jaybenne/do_feedback": "false",
    "jaybenne/dt": "1.e-12",
    "parthenon/time/tlim": "1.e-12",
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are small, and the suite runs in several
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------- (a) models


def _spread(rng, n):
    """rho, T and photon energies spread over the thin and thick regimes."""
    rho = rng.uniform(0.3, 3.0, n).astype(np.float32)
    temp = np.exp(rng.uniform(np.log(1e3), np.log(1e8), n)).astype(np.float32)
    x = np.exp(rng.uniform(np.log(1e-4), np.log(150.0), n))
    return rho, temp, (x * SB * temp).astype(np.float32)


def _exp_allowance(en, t_cgs):
    """Per element, the relative change of EPBremss's 1 - exp(-xc) for one ulp of
    exp(-xc) (float64 from the inputs, the clamps applied)."""
    x = en.astype(np.float64) / (SB * t_cgs)
    freq = np.maximum(x * 1.380649e-16 * t_cgs / 6.62607015e-27, 1e10)
    xc = np.minimum(freq * 6.62607015e-27 / (1.380649e-16 * t_cgs), 80.0)
    return np.spacing(np.exp(-xc).astype(np.float32)).astype(np.float64) / -np.expm1(-xc)


@pytest.mark.parametrize("scales", [None, (2.0, 0.5, 3.0, 1.5)])
def test_epbremss_matches_jax(scales):
    """Both ``nu`` branches, bare and under ``NonCGSUnits`` (time, mass, length,
    temperature scales), at energies from deep in the clamped Rayleigh-Jeans tail
    (the 1e10 Hz floor) to the Wien tail (the xc = 80 cap)."""
    rho, temp, en = _spread(np.random.default_rng(1), 20000)
    jm, tm = jop.EPBremss(), top.EPBremss()
    if scales is not None:
        kw = dict(zip(("time_scale", "mass_scale", "length_scale", "temperature_scale"),
                      scales))
        jm, tm = jop.NonCGSUnits(jm, **kw), top.NonCGSUnits(tm, **kw)
    assert not tm.is_gray and not jm.is_gray
    tr, tt, te = (torch.from_numpy(v) for v in (rho, temp, en))
    t_cgs = temp * (1.0 if scales is None else scales[3])
    allow = _exp_allowance(en, t_cgs)
    for nu_j, nu_t, extra in ((jnp.asarray(en), te, allow), (None, None, 0.0)):
        want = np.asarray(jm.absorption_coefficient(jnp.asarray(rho), jnp.asarray(temp), nu_j))
        got = tm.absorption_coefficient(tr, tt, nu_t)
        assert got.dtype == torch.float32 and np.isfinite(want).all()
        err = np.abs(got.numpy().astype(np.float64) - want) / np.abs(want)
        assert (err <= MODEL_RTOL + extra).all(), float((err - MODEL_RTOL - extra).max())
        assert (err <= MODEL_RTOL).mean() > 0.97
    np.testing.assert_allclose(tm.emissivity(tr, tt).numpy(),
                               np.asarray(jm.emissivity(jnp.asarray(rho), jnp.asarray(temp))),
                               rtol=MODEL_RTOL)
    # the clamps were reached: the frequency floor and the cap of h nu / k T
    x = en.astype(np.float64) / (SB * temp)
    assert (x * 1.380649e-16 * temp / 6.62607015e-27 < 1e10).any() and (x > 80).any()


def test_tabulated_opacity_matches_jax(tmp_path):
    """The log-log bilinear table read from an .npz (written here, as
    tests/test_pallas.py:1354-1358 writes its own), inside the table, on its grid
    points and edges, and beyond them on every side (clamped)."""
    rho_ax = np.array([0.1, 1.0, 10.0, 100.0])
    t_ax = np.array([1.0e3, 1.0e5, 1.0e7])
    kap = np.outer([1.0, 2.0, 5.0, 7.0], [3.0, 1.0, 0.5])
    path = str(tmp_path / "tab.npz")
    np.savez(path, rho=rho_ax, T=t_ax, kappa=kap)
    jm, tm = jop.TabulatedOpacity.from_file(path), top.TabulatedOpacity.from_file(path)
    assert tm == top.TabulatedOpacity.from_arrays(rho_ax, t_ax, kap) and tm.is_gray
    assert (tm.log_rho, tm.log_T, tm.log_kappa) == (jm.log_rho, jm.log_T, jm.log_kappa)
    rng = np.random.default_rng(2)
    n = 4000
    rho = np.exp(rng.uniform(np.log(1e-3), np.log(1e4), n))
    temp = np.exp(rng.uniform(np.log(1e1), np.log(1e9), n))
    rho[:16] = np.repeat(rho_ax, 4)  # on the grid
    temp[:16] = np.tile(np.append(t_ax, 1e9), 4)
    rho, temp = rho.astype(np.float32), temp.astype(np.float32)
    tr, tt = torch.from_numpy(rho), torch.from_numpy(temp)
    for name in ("absorption_coefficient", "emissivity"):
        want = np.asarray(getattr(jm, name)(jnp.asarray(rho), jnp.asarray(temp)))
        got = getattr(tm, name)(tr, tt)
        np.testing.assert_allclose(got.numpy(), want, rtol=MODEL_RTOL, err_msg=name)
    # beyond the edges the table is clamped: kappa at the corner values
    corner = tm.absorption_coefficient(torch.tensor([1e-6, 1e6]), torch.tensor([1e-2, 1e12]))
    np.testing.assert_allclose(corner.numpy() / np.array([1e-6, 1e6]), [3.0, 0.5 * 7.0],
                               rtol=1e-5)


@pytest.mark.parametrize("scales", [None, (2.0, 0.5, 3.0, 1.5)])
def test_thomson_and_unit_wrappers_match_jax(scales):
    rho, temp, en = _spread(np.random.default_rng(3), 1000)
    pairs = [(jop.ThomsonS(0.7), top.ThomsonS(0.7)), (jop.GrayS(3.0, 2.0), top.GrayS(3.0, 2.0))]
    kw = {}
    if scales is not None:
        kw = dict(zip(("time_scale", "mass_scale", "length_scale", "temperature_scale"),
                      scales))
    for jm, tm in pairs:
        jm, tm = jop.NonCGSUnitsS(jm, **kw), top.NonCGSUnitsS(tm, **kw)
        assert tm.is_gray
        want = np.asarray(jm.total_scattering_coefficient(jnp.asarray(rho), jnp.asarray(temp),
                                                          jnp.asarray(en)))
        got = tm.total_scattering_coefficient(torch.from_numpy(rho), torch.from_numpy(temp),
                                              torch.from_numpy(en))
        np.testing.assert_allclose(got.numpy(), want, rtol=MODEL_RTOL)
    jw, tw = jop.NonCGSUnits(jop.EPBremss(), **kw), top.NonCGSUnits(top.EPBremss(), **kw)
    jc, tc = jw.get_runtime_physical_constants(), tw.get_runtime_physical_constants()
    assert (tc.c, tc.sb) == (jc.c, jc.sb)


@pytest.mark.parametrize("model", ["ep_bremss", "table", "thomson"])
def test_config_builds_the_models(model, tmp_path):
    """``build_opacity``/``build_scattering`` take every model the JAX config takes,
    wrapped alike; a Simulation with them starts on the CPU."""
    path = str(tmp_path / "tab.npz")
    np.savez(path, rho=np.array([0.1, 10.0]), T=np.array([1e3, 1e7]), kappa=np.ones((2, 2)))
    mods = {"ep_bremss": {"mcblock/opacity_model": "ep_bremss"},
            "table": {"mcblock/opacity_model": "table", "mcblock/opacity_table_file": path},
            "thomson": {"mcblock/scattering_model": "thomson", "mcblock/apm": 0.5,
                        "mcblock/opacity_model": "constant",
                        "mcblock/opacity_constant_value": 1.0}}[model]
    mods = {**mods, "jaybenne/num_particles": 100}
    jcfg = jcm.from_deck(JDeck.parse(DECK).update(mods))
    tcfg = tcm.from_deck(TDeck.parse(DECK).update(mods))
    for get in ("build_opacity", "build_scattering", "build_eos"):
        j, t = getattr(jcfg.mcblock, get)(), getattr(tcfg.mcblock, get)()
        assert type(t).__name__ == type(j).__name__ and type(t.base).__name__ == type(
            j.base).__name__, get
    assert tcfg.mcblock.build_opacity().is_gray == (model != "ep_bremss")
    sim = Simulation(tcfg, outdir=str(tmp_path), quiet=True, device="cpu")
    sim.run(nlim=1)
    assert sim.cycle == 1 and int(sim.state.overflow) == 0


def test_fleck_and_coefs_match_jax():
    """The Fleck factor with EPBremss (its emissivity is the Planck mean) and the
    non-gray coefficients: the Planck-mean sigma_a, the cells' rho and T and the
    model attached, against the JAX package's ``fleck_factor`` and
    ``precompute_coefs`` on the same fields."""
    from jaybenne_tpu.ops import transport as jtr
    from jaybenne_tpu.state import empty_fields as jempty
    from jaybenne_tpu_torch.ops import fleck as tfleck
    from jaybenne_tpu_torch.ops import transport as ttr
    from jaybenne_tpu_torch.state import empty_fields as tempty

    jcfg, tcfg = _configs("2d", False)
    jmesh, tmesh = jbuild_mesh(jcfg.mesh), tbuild_mesh(tcfg.mesh)
    rng = np.random.default_rng(4)
    shape = (tmesh.n_blocks, tmesh.nz, tmesh.ny, tmesh.nx)
    rho = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    sie = (1.0e8 * np.exp(rng.uniform(np.log(1e4), np.log(1e7), shape))).astype(np.float32)
    jf = jempty(*shape)
    jf = dataclasses.replace(jf, rho=jnp.asarray(rho), sie=jnp.asarray(sie))
    tf = tempty(*shape)
    tf = dataclasses.replace(tf, rho=torch.from_numpy(rho), sie=torch.from_numpy(sie))
    jm, tm = jcfg.mcblock, tcfg.mcblock
    dt = 1.0e-12
    jfl = jfleck.fleck_factor(jf.rho, jf.sie, jm.build_eos(), jm.build_opacity(), dt,
                              jnp.float32)
    tfl = tfleck.fleck_factor(tf.rho, tf.sie, tm.build_eos(), tm.build_opacity(), dt,
                              torch.float32)
    np.testing.assert_allclose(tfl.numpy(), np.asarray(jfl), rtol=MODEL_RTOL)
    assert float(tfl.min()) < 0.999  # the emissivity term is live
    jf, tf = dataclasses.replace(jf, fleck=jfl), dataclasses.replace(tf, fleck=tfl)
    jc = jtr.precompute_coefs(jf, jmesh, jm.build_eos(), jm.build_opacity(),
                              jm.build_scattering(), False, jnp.float32)
    tc = ttr.precompute_coefs(tf, tmesh, tm.build_eos(), tm.build_opacity(),
                              tm.build_scattering(), False, torch.float32)
    assert not tc.is_gray and tc.opacity == tm.build_opacity() and jc.opacity is not None
    for name, col in (("rho", 0), ("temp", 1), ("fleck", 2)):
        np.testing.assert_allclose(getattr(tc, name).numpy(), np.asarray(jc.packed[:, col]),
                                   rtol=MODEL_RTOL, err_msg=name)
    for name in ("sigma_a", "sigma_s"):
        np.testing.assert_allclose(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
                                   rtol=MODEL_RTOL, err_msg=name)


# ------------------------------------------------ (b) the census, per particle


def _configs(geom, ddmc):
    extra = {"jaybenne/use_ddmc": "true" if ddmc else "false"}
    if geom == "smr2d":
        path = os.path.join(INPUTS, SMR_2D[0])
        mods = {**SMR_2D[1], **extra}
        return (jcm.from_deck(JDeck.from_file(path).update(mods)),
                tcm.from_deck(TDeck.from_file(path).update(mods)))
    ndim = int(geom[0])
    cells, blocks = UNIFORM[ndim]
    for a, k in enumerate("123"):
        extra[f"parthenon/mesh/nx{k}"] = cells[a]
        extra[f"parthenon/meshblock/nx{k}"] = blocks[a]
    return (jcm.from_deck(JDeck.parse(DECK).update(extra)),
            tcm.from_deck(TDeck.parse(DECK).update(extra)))


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


def _coefs(jcfg, tcfg, jmesh, tmesh, ddmc, seed):
    """(JAX coefs, port coefs, T per cell): rho in [0.5, 2], T log-uniform in
    [5e5, 5e6], fleck in [0.3, 1], the deck's gray scattering, face probabilities
    from the Planck-mean sigma_t rounded through bf16."""
    rng = np.random.default_rng(seed)
    shape = (tmesh.n_blocks, tmesh.nz, tmesh.ny, tmesh.nx)
    rho = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    temp = np.exp(rng.uniform(np.log(5e5), np.log(5e6), shape)).astype(np.float32)
    ff = rng.uniform(0.3, 1.0, shape).astype(np.float32)
    jm, tm = jcfg.mcblock, tcfg.mcblock
    jo, js, to, ts = jm.build_opacity(), jm.build_scattering(), tm.build_opacity(), \
        tm.build_scattering()
    sa = to.absorption_coefficient(torch.from_numpy(rho), torch.from_numpy(temp))
    ss = ts.total_scattering_coefficient(torch.from_numpy(rho), torch.from_numpy(temp))
    probs = [np.zeros((1,), np.float32)] * 3
    if ddmc:
        sig = jnp.asarray((sa + ss).numpy())
        probs = [_bf16(p) for p in jfleck.ddmc_face_probs(
            jmesh, sig, jcfg.jaybenne.tau_ddmc, jcfg.mesh.periodic_flags, jnp.float32)]
    flat = [v.reshape(-1) for v in (rho, temp, ff, sa.numpy(), ss.numpy())]
    jc = jT.TransportCoefs(
        sigma_a=jnp.asarray(flat[3]), sigma_s=jnp.asarray(flat[4]), fleck=jnp.asarray(flat[2]),
        **{k: jnp.asarray(v) for k, v in zip(("px", "py", "pz"), probs)},
        packed=jnp.stack([jnp.asarray(flat[0]), jnp.asarray(flat[1]), jnp.asarray(flat[2])], -1),
        opacity=jo, scattering=js)
    tc = TransportCoefs(
        sigma_a=torch.from_numpy(flat[3]), sigma_s=torch.from_numpy(flat[4]),
        fleck=torch.from_numpy(flat[2]),
        **({k: torch.from_numpy(np.array(v)) for k, v in zip(("px", "py", "pz"), probs)}
           if ddmc else {}),
        rho=torch.from_numpy(flat[0]), temp=torch.from_numpy(flat[1]), opacity=to)
    assert not tc.is_gray
    return jc, tc, flat[1]


def _ledger(mesh, temp_cell, ddmc, cap, seed):
    """``N`` live particles (``N + N_FACE`` with DDMC) in cells drawn uniformly over
    the forest's cells, uniform in them with isotropic directions, a third a hair
    from the face they fly at; with DDMC the last ``N_FACE`` on a face of their cell
    flying into it with the face code set. Photon energies x sb T of their cell,
    x log-uniform in [0.05, 30]."""
    rng = np.random.default_rng(seed)
    nd = mesh.ndim
    m = N + (N_FACE if ddmc else 0)
    cells = rng.integers(0, mesh.total_cells, m)
    b, k, j, i = np.unravel_index(cells, (mesh.n_blocks, mesh.nz, mesh.ny, mesh.nx))
    dxb = mesh.block_dx.double().numpy()[b]
    mu = 1.0 - 2.0 * rng.random(m)
    phi = 2 * np.pi * rng.random(m)
    st = np.sqrt(1.0 - mu * mu)
    v = np.stack([st * np.cos(phi), st * np.sin(phi), mu])
    if nd == 1:  # 1D keeps the transverse magnitude in vy, vz = 0
        v = np.stack([mu, st, np.zeros(m)])
    u = rng.random((3, m))
    ax = rng.integers(0, nd, m)
    near = rng.random(m) < 1.0 / 3.0
    for a in range(nd):
        sel = near & (ax == a)
        u[a, sel] = np.where(v[a, sel] > 0, 1.0 - 1e-4, 1e-4)
    face = np.zeros(m, np.int32)
    fa = np.arange(N, m)
    lower = rng.random(fa.size) < 0.5
    for a in range(nd):
        sel = ax[fa] == a
        idx = fa[sel]
        u[a, idx] = np.where(lower[sel], 0.0, 1.0)
        v[a, idx] = np.abs(v[a, idx]) * np.where(lower[sel], 1.0, -1.0)
        face[idx] = np.where(lower[sel], a + 1, -(a + 1))
    f = lambda: np.zeros(cap, np.float32)  # noqa: E731
    n = lambda: np.zeros(cap, np.int32)  # noqa: E731
    d = dict(x=f(), y=f(), z=f(), vx=f(), vy=f(), vz=f(), tau=f(), weight=f(),
             energy=f(), block=n(), i=n(), j=n(), k=n(), face=n(),
             alive=np.zeros(cap, bool), absorbed=np.zeros(cap, bool))
    d["block"][:m] = b
    for a, (pname, iname, vname) in enumerate((("x", "i", "vx"), ("y", "j", "vy"),
                                                ("z", "k", "vz"))):
        c = (i, j, k)[a]
        d[iname][:m] = c
        d[pname][:m] = (c + u[a]) * dxb[:, a] if a < nd else 0.0
        d[vname][:m] = C * v[a]
    x = np.exp(rng.uniform(np.log(0.05), np.log(30.0), m))
    d["energy"][:m] = x * SB * temp_cell[cells]
    d["face"][:m] = face
    d["alive"][:m] = True
    d["weight"][:m] = 1.0
    return d


def _setup(geom, ddmc, max_iters=None, seed=11):
    jcfg, tcfg = _configs(geom, ddmc)
    jmesh, tmesh = jbuild_mesh(jcfg.mesh), tbuild_mesh(tcfg.mesh)
    jprm, tprm = jparams(jcfg, jnp.float32), tparams(tcfg, torch.float32)
    assert tprm.has_absorption and tprm.use_ddmc == ddmc and pt.supports(jmesh, jprm)
    if max_iters is not None:
        jprm = dataclasses.replace(jprm, max_iters=max_iters)
        tprm = dataclasses.replace(tprm, max_iters=max_iters)
    jc, tc, temp = _coefs(jcfg, tcfg, jmesh, tmesh, ddmc, seed)
    d = _ledger(tmesh, temp, ddmc, pt.TILE, seed)
    jl = JLedger(**{k: jnp.asarray(v) for k, v in d.items()}, leak=jnp.zeros(pt.TILE, jnp.int32))
    kseed = int(np.asarray(jr.key_data(KEY)).reshape(-1)[-1].astype(np.uint32).view(np.int32))
    return tcfg.jaybenne.dt, (jl, jc, jmesh, jprm), (tc, tmesh, tprm), kseed, d


def _np(ledger):
    if isinstance(ledger, JLedger):
        return {f.name: np.asarray(getattr(ledger, f.name)) for f in dataclasses.fields(ledger)}
    return bridge.state_to_numpy(ledger)


CASES = [("1d", False), ("1d", True), ("2d", True), ("3d", False), ("smr2d", True)]


@pytest.mark.parametrize("max_iters", [1, 8])
@pytest.mark.parametrize("geom, ddmc", CASES)
def test_first_events_match_jax_kernel_per_particle(geom, ddmc, max_iters):
    dt, (jl, jc, jmesh, jprm), (tc, tmesh, tprm), seed, d0 = _setup(geom, ddmc, max_iters)
    jout, jit_, jev = pt.transport_pallas(jl, jc, jmesh, KEY, jprm, jnp.float32(dt),
                                          interpret=True)
    tout, tit, tev = transport_kernel.transport(bridge.state_from_numpy(d0), tc, tmesh, seed,
                                                tprm, dt)
    a, b = _np(tout), _np(jout)
    live = d0["alive"]
    same = live.copy()
    for name in ("i", "j", "k", "block", "alive", "absorbed", "face"):
        same &= a[name] == b[name]
    assert same[live].mean() >= INT_AGREE, same[live].mean()
    for name in ("x", "y", "z", "vx", "vy", "vz", "tau"):
        np.testing.assert_allclose(a[name][same], b[name][same], rtol=FLOAT_RTOL,
                                   atol=FLOAT_ATOL[name], err_msg=name)
    assert int(tit) == int(jit_) == max_iters
    assert abs(int(tev) - int(jev)) <= (1 - INT_AGREE) * int(jev) + 1
    # the spectral model put lanes on every outcome: absorbed, scattered or
    # crossed and alive; with DDMC lanes of one cell on both branches
    assert a["absorbed"][live].any() and a["alive"][live].any()
    np.testing.assert_array_equal(a["energy"], d0["energy"])  # read only
    if ddmc:  # the branch follows each lane's own sigma_t(E): cells hold both kinds
        cell = ((d0["block"] * tmesh.nz + d0["k"]) * tmesh.ny + d0["j"]) * tmesh.nx + d0["i"]
        cell = cell[live]
        ff = tc.fleck[cell]
        sa = tc.opacity.absorption_coefficient(tc.rho[cell], tc.temp[cell],
                                               torch.from_numpy(d0["energy"][live]))
        sig_t = (ff * sa + (tc.sigma_s[cell] + (1.0 - ff) * sa)).numpy()
        dmin = tmesh.block_dx[:, : tmesh.ndim].min(dim=1).values.numpy()[d0["block"][live]]
        dd = dmin * sig_t > tprm.tau_ddmc
        assert np.intersect1d(cell[dd], cell[~dd]).size > 0


def test_full_census_matches_jax_kernel_3d():
    """A full census of the last 20 % of a step in 3D: survivors, absorbed counts,
    the survivors' mean photon energy and positions, statistically; events within
    EVENTS_RTOL."""
    dt, (jl, jc, jmesh, jprm), (tc, tmesh, tprm), seed, d0 = _setup("3d", False)
    tau0 = 0.8 + 0.2 * np.random.default_rng(5).random(pt.TILE).astype(np.float32)
    d0["tau"][:] = tau0
    jl = dataclasses.replace(jl, tau=jnp.asarray(tau0))
    jk, _, ev_j = pt.transport_pallas(jl, jc, jmesh, KEY, jprm, jnp.float32(dt),
                                      interpret=True)
    tout, _, ev_t = transport_kernel.transport(bridge.state_from_numpy(d0), tc, tmesh, seed,
                                               tprm, dt)
    a, b = _np(tout), _np(jk)
    for out in (a, b):
        assert not (out["tau"][out["alive"]] < 1.0).any()
        assert not (out["alive"] & out["absorbed"]).any()
    n_t, n_j = int(a["alive"].sum()), int(b["alive"].sum())
    assert 0.05 * N < n_t < 0.95 * N
    assert abs(n_t - n_j) < N_SIGMA_COUNT * np.sqrt(n_t + n_j), (n_t, n_j)
    e_t, e_j = a["energy"][a["alive"]].mean(), b["energy"][b["alive"]].mean()
    assert abs(e_t - e_j) / e_j < MEAN_E_RTOL
    # survivors harden: the soft photons are the thick ones
    assert e_t > d0["energy"][d0["alive"]].mean()
    for axis in range(3):
        gt = tout.global_position(tmesh)[axis].numpy()[a["alive"]]
        gj = np.asarray(jk.global_position(jmesh)[axis])[b["alive"]]
        assert abs(gt.mean() - gj.mean()) < MEAN_ATOL * 5, axis
    assert abs(int(ev_t) - int(ev_j)) < EVENTS_RTOL * int(ev_j)


# ------------------------------------------------- (c) decks through Simulation


def _run_both(deck_path, mods, tmp_path, jax_mode):
    """(port, JAX) survivor statistics of one deck, each checked for energy
    conservation (live weight + absorbed == initial weight) and absorption."""
    out = {}
    runs = (("port", lambda: Simulation(
                tcm.from_deck(TDeck.from_file(deck_path).update(mods)),
                outdir=str(tmp_path), quiet=True, device="cpu")),
            ("jax", lambda: JSimulation(
                jcm.from_deck(JDeck.from_file(deck_path).update(
                    {**mods, "jaybenne/use_pallas": jax_mode})), quiet=True)))
    for name, make in runs:
        sim = make()
        assert not sim.cfg.mcblock.build_opacity().is_gray
        # a copy: the port updates its ledger in place
        p0 = {k: np.array(getattr(sim.state.particles, k)) for k in ("weight", "energy",
                                                                       "alive")}
        w0 = float(p0["weight"][p0["alive"]].sum())
        sim.run()
        p = {k: np.asarray(getattr(sim.state.particles, k)) for k in ("weight", "energy",
                                                                        "alive")}
        alive = p["alive"]
        w_live = float(p["weight"][alive].sum())
        absorbed = float(np.asarray(sim.state.fields.energy_delta).sum())
        assert np.isclose(w_live + absorbed, w0, rtol=ENERGY_RTOL), name
        assert absorbed > 0, name
        out[name] = {"surv": int(alive.sum()), "mean_E": float(p["energy"][alive].mean()),
                     "mean_E0": float(p0["energy"][p0["alive"]].mean())}
    for name, o in out.items():
        # nu^-3: low-energy photons absorb preferentially, survivors harden
        assert o["mean_E"] > o["mean_E0"], (name, o)
    n_t, n_j = out["port"]["surv"], out["jax"]["surv"]
    assert abs(n_t - n_j) < N_SIGMA_COUNT * np.sqrt(max(n_t + n_j, 1)), (n_t, n_j)
    assert abs(out["port"]["mean_E"] - out["jax"]["mean_E"]) / out["jax"]["mean_E"] < MEAN_E_RTOL
    return out


def test_epbremss_per_event_in_kernel(tmp_path):
    """Port of tests/test_pallas.py::test_epbremss_per_event_in_kernel: its deck
    (100 cells in two blocks, 4000 particles) with EPBremss, one step, through the
    port's census on the CPU and through the JAX package's kernel (interpret)."""
    path = str(tmp_path / "deck.in")
    with open(path, "w") as fh:
        fh.write(PALLAS_DECK)
    _run_both(path, EPB, tmp_path, "on")


def test_bucketed_nongray_per_event(tmp_path, monkeypatch):
    """Port of tests/test_pallas.py::test_bucketed_nongray_per_event: the SMR deck
    inputs/stepdiff_smr.in with EPBremss and 2000 particles, one step, against the
    JAX package's bucketed kernel (K4, interpret; its route forced as the JAX test
    forces it)."""
    monkeypatch.setattr(pt, "supports", lambda *a, **k: False)
    mods = {**EPB, "jaybenne/num_particles": "2000", "jaybenne/use_ddmc": "false",
            "parthenon/output0/file_type": "none"}
    path = os.path.join(INPUTS, "stepdiff_smr.in")
    jcfg = jcm.from_deck(JDeck.from_file(path).update(mods))
    jmesh = jbuild_mesh(jcfg.mesh)
    jprm = jparams(jcfg, jnp.float32)
    assert jmesh.max_level > 0 and not pg.supports(jmesh, jprm) and pb.supports(jmesh, jprm)
    _run_both(path, mods, tmp_path, "on")
