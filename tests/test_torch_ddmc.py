"""DDMC in the port against the JAX package: the face probabilities, the census
kernel's DDMC branch (K1(c)) particle by particle over the first events and
statistically over a full census (against K1 and K3), the JAX package's DDMC
physics tests, and a stepdiff_ddmc slice through both packages' ``Simulation``.

The per-particle comparison runs a hybrid ledger: x-slabs of cells alternate
between thin (sigma_t = 16, IMC) and thick (sigma_t = 256, DDMC) with
coefficients that bf16 represents exactly, and face probabilities rounded through
bf16 before either package gets them, so that the JAX kernel's bf16 tables and the
port's f32 tables hold the same numbers and both draw the same K2 variates per
slot."""

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
from jaybenne_tpu.ops import fleck as jfleck
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
from jaybenne_tpu_torch.ops import fleck as tfleck
from jaybenne_tpu_torch.ops import transport_kernel
from jaybenne_tpu_torch.ops.transport import TransportCoefs
from jaybenne_tpu_torch.step import make_transport_params as tparams
from jaybenne_tpu_torch.utils.deck import Deck as TDeck

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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
tlim = 3.335641e-11
<jaybenne>
num_particles = 4000
dt = 3.335641e-11
use_ddmc = true
<mcblock>
opacity_model = constant
opacity_constant_value = 1.0
scattering_model = constant
scattering_constant_value = 15.0
initial_density = 1.0
initial_temperature = 1.0e5
initial_radiation = thermal
"""
# (global cells, cells per block) per axis: several blocks per axis, so the
# uniform-forest collapse and the global-order tables are exercised
MESHES = {
    1: ((16, 1, 1), (4, 1, 1)),
    2: ((16, 8, 1), (8, 4, 1)),
    3: ((8, 8, 8), (4, 4, 4)),
}
# thin (IMC) and thick (DDMC) cells: sigma_t dmin = 1 or 2 against 16 or 32 for
# tau_ddmc = 5; every value, and fleck sigma_a, exact in bf16
THIN = (1.0, 15.0)     # (sigma_a, sigma_s) with absorption
THICK = (1.0, 255.0)
C = 2.99792458e10
KEY = jr.PRNGKey(20261016)
N = 4000
N_FACE = 1200  # particles on a face of a thick cell, as if an IMC crossing had just
#                brought them there (face code set)
# the tolerances of tests/test_torch_transport_3d.py
FLOAT_RTOL = 1e-5
FLOAT_ATOL = {"x": 5e-5, "y": 5e-5, "z": 5e-5, "vx": 5e-4 * C, "vy": 5e-4 * C,
              "vz": 5e-4 * C, "tau": 1e-6}
# face probabilities: both packages compute the same float32 operations
PROB_RTOL = 1e-6
# full census, the checks of tests/test_pallas.py:154-183 and :769-786
MEAN_ATOL = 0.01
MEAN_ATOL_GRID = 2e-3
STD_RTOL = 0.15
EVENTS_RTOL = 0.05
N_SIGMA_BINOMIAL = 4.0
# the slice end to end: mean tally of two Monte Carlo runs within this many
# combined standard deviations; radiation energy conserved to float32 roundings
N_SIGMA = 5.0
ENERGY_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are small, and the suite runs in several
    processes at once, where PyTorch's default of one thread per core oversubscribes
    the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mods(ndim, **extra):
    cells, blocks = MESHES[ndim]
    mods = {}
    for a, key in enumerate("123"):
        mods[f"parthenon/mesh/nx{key}"] = cells[a]
        mods[f"parthenon/meshblock/nx{key}"] = blocks[a]
    return {**mods, **extra}


def _configs(mods, deck=DECK):
    return (jcm.from_deck(JDeck.parse(deck).update(dict(mods))),
            tcm.from_deck(TDeck.parse(deck).update(dict(mods))))


def _global_index(mesh):
    """Global (x, y, z) cell index of every cell, each [B, nz, ny, nx]."""
    nrb = mesh.root_grid[::-1]
    nloc = (mesh.nx, mesh.ny, mesh.nz)
    b = np.arange(mesh.n_blocks)
    bk = (b % nrb[0], (b // nrb[0]) % nrb[1], b // (nrb[0] * nrb[1]))
    kk, jj, ii = np.meshgrid(np.arange(mesh.nz), np.arange(mesh.ny), np.arange(mesh.nx),
                             indexing="ij")
    loc = (ii, jj, kk)
    return [bk[a][:, None, None, None] * nloc[a] + loc[a][None] for a in range(3)]


def _thick(gi):
    """Thick x-slabs two cells wide, starting at the third cell; the last slab
    touches the upper x wall."""
    return (gi // 2) % 2 == 1


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


def _hybrid_coefs(jmesh, jcfg, absorb):
    """(JAX coefs, port coefs, thick mask [NC]) on the hybrid slabs."""
    thick = _thick(_global_index(jmesh)[0])
    sa = np.where(thick, THICK[0], THIN[0])
    ss = np.where(thick, THICK[1], THIN[1])
    if not absorb:  # the same sigma_t, all of it scattering
        sa, ss = np.zeros_like(sa), sa + ss
    sig = jnp.asarray(sa + ss, jnp.float32)
    probs = jfleck.ddmc_face_probs(jmesh, sig, jcfg.jaybenne.tau_ddmc,
                                   jcfg.mesh.periodic_flags, jnp.float32)
    probs = [_bf16(p) for p in probs]
    flat = [np.asarray(v, np.float32).reshape(-1) for v in (sa, ss)]
    nc = flat[0].size
    jc = jT.TransportCoefs(sigma_a=jnp.asarray(flat[0]), sigma_s=jnp.asarray(flat[1]),
                           fleck=jnp.ones((nc,)), px=jnp.asarray(probs[0]),
                           py=jnp.asarray(probs[1]), pz=jnp.asarray(probs[2]))
    tc = TransportCoefs(sigma_a=torch.from_numpy(flat[0]), sigma_s=torch.from_numpy(flat[1]),
                        fleck=torch.ones(nc), **{k: torch.from_numpy(np.array(v)) for k, v in
                                                 zip(("px", "py", "pz"), probs)})
    return jc, tc, thick.reshape(-1)


def _hybrid_ledger(mesh, cap, seed=7):
    """``N`` live particles at uniform positions with isotropic directions, a third
    of them a hair from the face their direction points at, plus ``N_FACE`` on a
    face of a thick cell flying into the cell with the matching face code."""
    rng = np.random.default_rng(seed)
    nd = mesh.ndim
    nloc = (mesh.nx, mesh.ny, mesh.nz)
    nrb = mesh.root_grid[::-1]
    ncell = [nloc[a] * nrb[a] for a in range(3)]
    b = mesh.bounds
    dxg = np.asarray([(b[2 * a + 1] - b[2 * a]) / ncell[a] for a in range(3)])
    m = N + N_FACE
    mu = 1.0 - 2.0 * rng.random(m)
    phi = 2 * np.pi * rng.random(m)
    st = np.sqrt(1.0 - mu * mu)
    v = np.stack([st * np.cos(phi), st * np.sin(phi), mu])
    g = np.stack([rng.integers(0, ncell[a], m) for a in range(3)])
    u = rng.random((3, m))
    face = np.zeros(m, np.int32)
    ax = rng.integers(0, nd, m)
    near = rng.random(m) < 1.0 / 3.0
    for a in range(nd):
        sel = near & (ax == a)
        u[a, sel] = np.where(v[a, sel] > 0, 1.0 - 1e-4, 1e-4)
    # face arrivals: into thick cells, +code on the lower face, -code on the upper
    fa = np.arange(N, m)
    g[0, fa] = 2 + 4 * rng.integers(0, ncell[0] // 4, N_FACE) + rng.integers(0, 2, N_FACE)
    assert _thick(g[0, fa]).all()
    lower = rng.random(N_FACE) < 0.5
    for a in range(nd):
        sel = ax[fa] == a
        idx = fa[sel]
        u[a, idx] = np.where(lower[sel], 0.0, 1.0)
        v[a, idx] = np.abs(v[a, idx]) * np.where(lower[sel], 1.0, -1.0)
        face[idx] = np.where(lower[sel], a + 1, -(a + 1))
    gpos = (g + u) * dxg[:, None]
    f = lambda: np.zeros(cap, np.float32)  # noqa: E731
    i = lambda: np.zeros(cap, np.int32)  # noqa: E731
    d = dict(x=f(), y=f(), z=f(), vx=f(), vy=f(), vz=f(), tau=f(), weight=f(),
             energy=f(), block=i(), i=i(), j=i(), k=i(), face=i(),
             alive=np.zeros(cap, bool), absorbed=np.zeros(cap, bool))
    bk = g // np.asarray(nloc)[:, None]
    d["block"][:m] = (bk[2] * nrb[1] + bk[1]) * nrb[0] + bk[0]
    for a, (pname, iname, vname) in enumerate((("x", "i", "vx"), ("y", "j", "vy"),
                                                ("z", "k", "vz"))):
        d[iname][:m] = g[a] - bk[a] * nloc[a]
        d[pname][:m] = gpos[a] - bk[a] * nloc[a] * dxg[a] if a < nd else 0.0
        d[vname][:m] = C * v[a]
    if nd == 1:  # 1D keeps the transverse magnitude in vy, vz = 0
        d["vy"][:m] = C * np.sqrt(1.0 - v[0] ** 2)
        d["vz"][:m] = 0.0
    d["face"][:m] = face
    d["alive"][:m] = True
    d["weight"][:m] = 1.0
    return d


def _setup(ndim, absorb, max_iters=None, cap=pt.TILE):
    extra = {} if absorb else {"mcblock/opacity_model": "none"}
    jcfg, tcfg = _configs(_mods(ndim, **extra))
    jmesh, tmesh = jbuild_mesh(jcfg.mesh), tbuild_mesh(tcfg.mesh)
    jprm, tprm = jparams(jcfg, jnp.float32), tparams(tcfg, torch.float32)
    assert jprm.use_ddmc and tprm.use_ddmc and tprm.has_absorption == absorb
    if max_iters is not None:
        jprm = dataclasses.replace(jprm, max_iters=max_iters)
        tprm = dataclasses.replace(tprm, max_iters=max_iters)
    d = _hybrid_ledger(tmesh, cap)
    jl = JLedger(**{k: jnp.asarray(v) for k, v in d.items()}, leak=jnp.zeros(cap, jnp.int32))
    tl = bridge.state_from_numpy(d)
    jc, tc, thick = _hybrid_coefs(jmesh, jcfg, absorb)
    kseed = int(np.asarray(jr.key_data(KEY)).reshape(-1)[-1].astype(np.uint32).view(np.int32))
    return tcfg.jaybenne.dt, (jl, jc, jmesh, jprm), (tl, tc, tmesh, tprm), kseed, d, thick


def _np(ledger):
    if isinstance(ledger, JLedger):
        return {f.name: np.asarray(getattr(ledger, f.name)) for f in dataclasses.fields(ledger)}
    return bridge.state_to_numpy(ledger)


def _global_cell(out, mesh):
    """Global row-major cell of each slot of a numpy ledger."""
    nrb = mesh.root_grid[::-1]
    nloc = (mesh.nx, mesh.ny, mesh.nz)
    blk = out["block"]
    bk = (blk % nrb[0], (blk // nrb[0]) % nrb[1], blk // (nrb[0] * nrb[1]))
    g = [bk[a] * nloc[a] + out[n] for a, n in enumerate("ijk")]
    return (g[2] * nrb[1] * nloc[1] + g[1]) * nrb[0] * nloc[0] + g[0], g


def _binomial_gate(k_a, k_b, n):
    p = 0.5 * (k_a + k_b) / n
    sd = np.sqrt(2.0 * n * p * (1.0 - p))
    assert abs(k_a - k_b) <= N_SIGMA_BINOMIAL * sd + 1, (k_a, k_b, sd)


# ---------------------------------------------------------------- (a) face probs


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("periodic", [False, True])
def test_face_probs_match_jax(ndim, periodic):
    """Random per-cell sigma_t straddling tau_ddmc on a uniform multi-block forest,
    with outflow or periodic field boundaries."""
    bc = "periodic" if periodic else "outflow"
    mods = _mods(ndim, **{f"parthenon/mesh/{s}x{k}_bc": bc for s in "io" for k in "123"})
    jcfg, tcfg = _configs(mods)
    jmesh, tmesh = jbuild_mesh(jcfg.mesh), tbuild_mesh(tcfg.mesh)
    assert tmesh.n_blocks > 1 and tcfg.mesh.periodic_flags == (periodic,) * 3
    rng = np.random.default_rng(ndim + 10 * periodic)
    dmin = float(tmesh.block_dx[0, :ndim].min())
    sig = (5.0 / dmin) * np.exp(rng.uniform(-1.5, 1.5, (tmesh.n_blocks, tmesh.nz, tmesh.ny,
                                                           tmesh.nx))).astype(np.float32)
    tau = sig * dmin
    assert (tau > 5.0).mean() > 0.2 and (tau <= 5.0).mean() > 0.2
    want = jfleck.ddmc_face_probs(jmesh, jnp.asarray(sig), jcfg.jaybenne.tau_ddmc,
                                  jcfg.mesh.periodic_flags, jnp.float32)
    got = tfleck.ddmc_face_probs(tmesh, torch.from_numpy(sig), tcfg.jaybenne.tau_ddmc,
                                 tcfg.mesh.periodic_flags, torch.float32)
    for a, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=PROB_RTOL, err_msg=str(a))
        if a >= ndim:
            assert not g.any()
        else:
            assert g.min() > 0


# ----------------------------------------------------- (b) first events, per slot


def _outcomes(d0, out, mesh, absorb):
    """Counts of the DDMC outcomes of one event, from the state before and after
    it: albedo rejections and acceptances, leaks into IMC cells and into walls,
    census and absorption on the DDMC branch."""
    c0, g0 = _global_cell(d0, mesh)
    c1, g1 = _global_cell(out, mesh)
    dd = d0["alive"] & _thick(g0[0])
    at_face = dd & (d0["face"] != 0)
    moved = c1 != c0
    rejected = at_face & out["alive"] & moved & (out["tau"] == d0["tau"])
    steps = dd & ~rejected & (out["tau"] > d0["tau"])
    census = steps & (out["tau"] == 1.0)
    leak = steps & (out["tau"] < 1.0) & ~out["absorbed"]
    into_imc = leak & out["alive"] & moved & ~_thick(g1[0])
    # a leak into a wall: wrapped by a periodic axis, gone through an outflow wall,
    # or turned back by a reflecting x wall (eps_ddmc dx inside it)
    wrapped = np.zeros_like(leak)
    for a in range(mesh.ndim):
        wrapped |= np.abs(g1[a] - g0[a]) > 1
    nrbx = mesh.root_grid[2]
    dx = 1.0 / (nrbx * mesh.nx)
    gx = -0.5 + (out["block"] % nrbx) / nrbx + out["x"]
    at_wall = wrapped | ~out["alive"] | (0.5 - np.abs(gx) < 2e-2 * dx)
    return {
        "rejected": int(rejected.sum()),
        "accepted": int((at_face & ~rejected).sum()),
        "leak into IMC": int(into_imc.sum()),
        "leak into a wall": int((leak & at_wall).sum()),
        "census": int(census.sum()),
        "absorbed": int((dd & out["absorbed"]).sum()) if absorb else 1,
    }


@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_first_events_match_jax_kernel_per_particle(ndim, absorb):
    dt, (jl, jc, jmesh, jprm), (tl, tc, tmesh, tprm), seed, d0, thick = _setup(
        ndim, absorb, max_iters=8)
    assert pt.supports(jmesh, jprm) and tmesh.n_blocks > 1
    # what the first event does, on the port's plain version
    one = dataclasses.replace(tprm, max_iters=1)
    out1 = bridge.state_to_numpy(
        transport_kernel.transport(bridge.state_from_numpy(d0), tc, tmesh, seed, one, dt)[0])
    seen = _outcomes(d0, out1, tmesh, absorb)
    assert min(seen.values()) > 0, seen

    jout, jit_, jev = pt.transport_pallas(jl, jc, jmesh, KEY, jprm, jnp.float32(dt),
                                          interpret=True)
    tout, tit, tev = transport_kernel.transport(tl, tc, tmesh, seed, tprm, dt)
    a, b = _np(tout), _np(jout)
    live = d0["alive"]
    for name in ("i", "j", "k", "block", "alive", "absorbed", "face"):
        np.testing.assert_array_equal(a[name][live], b[name][live], err_msg=name)
    for name in ("x", "y", "z", "vx", "vy", "vz", "tau"):
        np.testing.assert_allclose(a[name][live], b[name][live], rtol=FLOAT_RTOL,
                                   atol=FLOAT_ATOL[name], err_msg=name)
    assert int(tit) == int(jit_) == 8
    assert int(tev) == int(jev) and tev.dtype == torch.int64
    assert (a["face"][live] != 0).any() and (a["tau"][live] == 1.0).any()


# ------------------------------------------------------------- (c) full census


def test_full_census_hybrid_matches_jax_kernel_3d():
    """The hybrid slabs with absorption in 3D, a full census against K1: every
    survivor at census, positions, events and absorbed counts statistically."""
    dt, (jl, jc, jmesh, jprm), (tl, tc, tmesh, tprm), seed, d0, thick = _setup(3, True)
    jk, _, ev_j = pt.transport_pallas(jl, jc, jmesh, KEY, jprm, jnp.float32(dt),
                                      interpret=True)
    tout, _, ev_t = transport_kernel.transport(tl, tc, tmesh, seed, tprm, dt)
    a, b = _np(tout), _np(jk)
    n0 = int(d0["alive"].sum())
    for out in (a, b):
        assert not (out["tau"][out["alive"]] < 1.0).any()
        assert not (out["alive"] & out["absorbed"]).any()
    for axis in range(3):
        gt = tout.global_position(tmesh)[axis].numpy()[a["alive"]]
        gj = np.asarray(jk.global_position(jmesh)[axis])[b["alive"]]
        assert (gt >= -0.5).all() and (gt <= 0.5).all()
        assert abs(gt.mean() - gj.mean()) < MEAN_ATOL, axis
        assert abs(gt.std() - gj.std()) / gj.std() < STD_RTOL, axis
    assert abs(int(ev_t) - int(ev_j)) / int(ev_j) < EVENTS_RTOL
    _binomial_gate(int(a["absorbed"].sum()), int(b["absorbed"].sum()), n0)
    _binomial_gate(int(a["alive"].sum()), int(b["alive"].sum()), n0)


def _thick_slab_setup(nx_total, nblk, sigma_s, n, cap, dt=None):
    """tests/test_pallas.py's 1D DDMC set-ups: ``n`` particles spread over an
    ``nx_total``-cell slab of ``nblk``-cell blocks with uniform sigma_s, DDMC
    everywhere, and the JAX face probabilities."""
    mods = {"parthenon/mesh/nx1": nx_total, "parthenon/meshblock/nx1": nblk,
            "mcblock/opacity_model": "none", "mcblock/scattering_constant_value": sigma_s}
    if dt is not None:
        mods.update({"jaybenne/dt": dt, "parthenon/time/tlim": dt})
    jcfg, tcfg = _configs(mods)
    jmesh, tmesh = jbuild_mesh(jcfg.mesh), tbuild_mesh(tcfg.mesh)
    jprm, tprm = jparams(jcfg, jnp.float32), tparams(tcfg, torch.float32)
    rng = np.random.default_rng(9)
    cells = rng.integers(0, nx_total, n)
    mu = 1.0 - 2.0 * rng.random(n)
    d = {k: np.zeros(cap, np.float32) for k in ("x", "y", "z", "vx", "vy", "vz", "tau",
                                                 "weight", "energy")}
    d.update({k: np.zeros(cap, np.int32) for k in ("block", "i", "j", "k", "face")})
    d.update(alive=np.zeros(cap, bool), absorbed=np.zeros(cap, bool))
    d["block"][:n], d["i"][:n] = cells // nblk, cells % nblk
    d["x"][:n] = (cells % nblk + rng.random(n)) / nx_total
    d["vx"][:n], d["vy"][:n] = C * mu, C * np.sqrt(1.0 - mu * mu)
    d["alive"][:n], d["weight"][:n] = True, 1.0
    nc = jmesh.total_cells
    sig = jnp.full((jmesh.n_blocks, 1, 1, nblk), float(sigma_s))
    probs = jfleck.ddmc_face_probs(jmesh, sig, jcfg.jaybenne.tau_ddmc,
                                   jcfg.mesh.periodic_flags, jnp.float32)
    jc = jT.TransportCoefs(sigma_a=jnp.zeros((nc,)), sigma_s=jnp.full((nc,), float(sigma_s)),
                           fleck=jnp.ones((nc,)), px=probs[0], py=probs[1], pz=probs[2])
    tc = TransportCoefs(sigma_a=torch.zeros(nc), sigma_s=torch.full((nc,), float(sigma_s)),
                        fleck=torch.ones(nc), **{k: torch.from_numpy(np.array(v)) for k, v
                                                 in zip(("px", "py", "pz"), probs)})
    jl = JLedger(**{k: jnp.asarray(v) for k, v in d.items()}, leak=jnp.zeros(cap, jnp.int32))
    return tcfg.jaybenne.dt, (jl, jc, jmesh, jprm), (bridge.state_from_numpy(d), tc, tmesh,
                                                     tprm), d


def _full_census_checks(ref, ev_r, out, ev_t, jmesh, tmesh, n, mean_atol, std_rtol):
    for o in (ref, out):
        alive = np.asarray(o.alive)
        assert int(alive.sum()) == n  # pure scattering between reflecting walls
        assert not (np.asarray(o.tau)[alive] < 1.0).any()
    gx_t = out.global_position(tmesh)[0].numpy()[out.alive.numpy()]
    gx_r = np.asarray(ref.global_position(jmesh)[0])[np.asarray(ref.alive)]
    assert (gx_t >= -0.5).all() and (gx_t <= 0.5).all()
    assert abs(gx_t.mean() - gx_r.mean()) < mean_atol
    assert abs(gx_t.std() - gx_r.std()) / gx_r.std() < std_rtol
    assert abs(int(ev_t) - int(ev_r)) / int(ev_r) < EVENTS_RTOL


def test_full_census_thick_slab_matches_jax_kernel():
    """tests/test_pallas.py::test_pallas_interpret_ddmc_matches_xla's set-up (two
    50-cell blocks, sigma_s = 1e3, DDMC everywhere) against K1."""
    n = 4000
    dt, (jl, jc, jmesh, jprm), (tl, tc, tmesh, tprm), _ = _thick_slab_setup(
        100, 50, 1.0e3, n, pt.TILE)
    assert pt.supports(jmesh, jprm)
    seed = int(np.asarray(jr.key_data(KEY)).reshape(-1)[-1].astype(np.uint32).view(np.int32))
    jk, _, ev_j = pt.transport_pallas(jl, jc, jmesh, KEY, jprm, jnp.float32(dt),
                                      interpret=True)
    tout, _, ev_t = transport_kernel.transport(tl, tc, tmesh, seed, tprm, dt)
    _full_census_checks(jk, ev_j, tout, ev_t, jmesh, tmesh, n, MEAN_ATOL, STD_RTOL)


def test_full_census_matches_jax_grid_kernel(monkeypatch):
    """tests/test_pallas.py::test_grid_interpret_ddmc's set-up (_setup_big with
    sigma_s = 1e6 and DDMC: 8192 cells in 256-cell blocks, past K1's limit, with K3's
    regions shrunk as there) against K3."""
    monkeypatch.setattr(pg, "REGION_CELLS_IMC", 1024)
    monkeypatch.setattr(pg, "REGION_CELLS_DDMC", 1024)
    n = 4000
    dt, (jl, jc, jmesh, jprm), (tl, tc, tmesh, tprm), _ = _thick_slab_setup(
        8192, 256, 1.0e6, n, pg.BTILE * 2, dt="3.3e-13")
    assert not pt.supports(jmesh, jprm) and pg.supports(jmesh, jprm)
    seed = int(np.asarray(jr.key_data(KEY)).reshape(-1)[-1].astype(np.uint32).view(np.int32))
    jg, _, ev_j = pg.transport_grid(jl, jc, jmesh, KEY, jprm, jnp.float32(dt), interpret=True)
    tout, _, ev_t = transport_kernel.transport(tl, tc, tmesh, seed, tprm, dt)
    _full_census_checks(jg, ev_j, tout, ev_t, jmesh, tmesh, n, MEAN_ATOL_GRID, STD_RTOL)


# ------------------------------------------------ (d) the JAX package's DDMC tests

PHYS_DECK = """
<parthenon/job>
problem_id = stepdiff
<parthenon/mesh>
nx1 = 16
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
<parthenon/time>
tlim = 2.e-11
<jaybenne>
num_particles = 30000
dt = 1.e-11
do_emission = false
do_feedback = false
seed = 3
<mcblock>
opacity_model = none
scattering_model = constant
scattering_constant_value = 4.0e2
cv = 1.0e8
initial_density = 1.0
initial_temperature = 1.0e5
initial_radiation = thermal
"""


def _run_phys(mods, tmp_path):
    cfg = tcm.from_deck(TDeck.parse(PHYS_DECK).update(mods))
    sim = Simulation(cfg, outdir=str(tmp_path), quiet=True, device="cpu")
    sim.run()
    return sim


def test_ddmc_matches_imc_diffusion(tmp_path):
    """Port of tests/test_ddmc.py::test_ddmc_matches_imc_diffusion: tau per cell =
    400 / 16 = 25 > tau_ddmc, so with use_ddmc the whole slab takes the DDMC
    branch; the tally profile agrees with pure IMC to Monte Carlo noise, both
    conserve the energy, and DDMC needs far fewer events."""
    imc = _run_phys({}, tmp_path / "imc")
    ddmc = _run_phys({"jaybenne/use_ddmc": "true"}, tmp_path / "ddmc")
    t1 = imc.state.fields.energy_tally.double().numpy().reshape(-1)
    t2 = ddmc.state.fields.energy_tally.double().numpy().reshape(-1)
    w = t1 + t2
    err = np.abs(t1 - t2)[w > 0].sum() / w[w > 0].sum()
    assert err < 0.06, err
    assert np.isclose(t1.sum(), t2.sum(), rtol=1e-4)
    assert ddmc.total_events < 0.25 * imc.total_events, (ddmc.total_events, imc.total_events)


def test_ddmc_absorption_conserves_energy(tmp_path):
    """Port of tests/test_ddmc.py::test_ddmc_absorption_conserves_energy: DDMC with
    absorption, emission and feedback conserves matter plus radiation energy over
    a step (the inf_stiff regime at small scale)."""
    cfg = tcm.from_deck(TDeck.parse(PHYS_DECK).update({
        "jaybenne/use_ddmc": "true", "jaybenne/do_emission": "true",
        "jaybenne/do_feedback": "true", "mcblock/opacity_model": "constant",
        "mcblock/opacity_constant_value": "1000.0", "mcblock/scattering_model": "none",
        "jaybenne/num_particles": "8000", "jaybenne/dt": "1.e-11"}))
    sim = Simulation(cfg, outdir=str(tmp_path), quiet=True, device="cpu")
    dv = sim.mesh.block_volume.double().numpy()[:, None, None, None]

    def energy(state):
        p = state.particles
        return float((state.fields.u.double().numpy() * dv).sum()) + float(
            p.weight.double()[p.alive].sum())

    e0 = energy(sim.state)
    state, stats = sim.step_fn(sim.state, 1.0e-11)
    e1 = energy(state)
    assert abs(e1 - e0) / e0 < 2e-4, (e0, e1)
    assert int(stats.iterations) < cfg.jaybenne.max_transport_iterations
    assert int(stats.unfinished) == 0


# ------------------------------------------------------ (e) the slice end to end

STEPDIFF_DDMC = os.path.join(_ROOT, "inputs", "stepdiff_ddmc.in")
SLICE = {"parthenon/mesh/nx1": 32, "parthenon/meshblock/nx1": 16,
         "jaybenne/num_particles": 8000, "parthenon/output0/file_type": "none"}
SLICE_STEPS = 3


def test_stepdiff_ddmc_slice_matches_jax(tmp_path):
    """A small stepdiff_ddmc deck (32 cells in two blocks, sigma_s dx = 31) through
    both packages' ``Simulation`` on the CPU: the tally profiles agree within Monte
    Carlo noise cell by cell and on average, the radiation energy is conserved by
    both, and the event counts agree."""
    jsim = JSimulation(jcm.from_deck(JDeck.from_file(STEPDIFF_DDMC).update(
        {**SLICE, "jaybenne/use_pallas": "off"})), outdir=str(tmp_path / "j"), quiet=True)
    tsim = Simulation(tcm.from_deck(TDeck.from_file(STEPDIFF_DDMC).update(SLICE)),
                      outdir=str(tmp_path / "t"), quiet=True, device="cpu")
    dv = float(tsim.mesh.block_volume[0])
    e0 = [float(np.asarray(s.state.fields.energy_tally, np.float64).sum()) * dv
          for s in (jsim, tsim)]
    jsim.run(nlim=SLICE_STEPS)
    tsim.run(nlim=SLICE_STEPS)
    assert tsim.cycle == SLICE_STEPS and all(h["unfinished"] == 0 for h in tsim.history)
    ta = np.asarray(tsim.state.fields.energy_tally, np.float64).reshape(-1)
    ja = np.asarray(jsim.state.fields.energy_tally, np.float64).reshape(-1)
    for s, e, tal in ((jsim, e0[0], ja), (tsim, e0[1], ta)):
        assert abs(tal.sum() * dv - e) <= ENERGY_RTOL * e
    # per-cell Monte Carlo noise: each run has about n * (cell's share of the
    # energy) particles in a cell
    mean = 0.5 * (ta + ja)
    n_cell = SLICE["jaybenne/num_particles"] * mean / mean.sum()
    hot = n_cell > 10
    sd = mean[hot] * np.sqrt(2.0 / n_cell[hot])
    assert (np.abs(ta - ja)[hot] <= N_SIGMA * sd).all(), (ta, ja)
    assert abs(tsim.total_events - jsim.total_events) / jsim.total_events < EVENTS_RTOL
