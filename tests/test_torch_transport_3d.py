"""The port's census with absorption in 1D, 2D and 3D against the JAX kernels: K1
(``transport_pallas(..., interpret=True)``) particle by particle over the first
events and statistically over a full census, and K3 (``pallas_grid.transport_grid
(..., interpret=True)``, the kernel the JAX package runs past K1's cell limit)
statistically, as ``tests/test_pallas.py`` runs them on the CPU.

The coefficients are sigma_t = 64 with p_abs = 0.25 (f sigma_a = 16, sigma_s = 48,
f = 1): bf16 represents 0.25 and 1/64 exactly, so the JAX kernels' bf16 pair and
the port's f32 pair are the same numbers, and with the same K2 variates per slot
the two agree particle by particle over the first events. The mean free path
(1/64 cm) is a fraction of a cell, so those events cross cells and walls."""

import dataclasses

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from jaybenne_tpu import config as jcm
from jaybenne_tpu.mesh import build_mesh as jbuild_mesh
from jaybenne_tpu.ops import pallas_grid as pg
from jaybenne_tpu.ops import pallas_transport as pt
from jaybenne_tpu.ops import transport as jT
from jaybenne_tpu.particles import ParticleLedger as JLedger
from jaybenne_tpu.step import make_transport_params as jparams
from jaybenne_tpu.utils.deck import Deck as JDeck

from jaybenne_tpu_torch import bridge
from jaybenne_tpu_torch import config as tcm
from jaybenne_tpu_torch.mesh import build_mesh as tbuild_mesh
from jaybenne_tpu_torch.ops import transport_kernel
from jaybenne_tpu_torch.ops.transport import TransportCoefs
from jaybenne_tpu_torch.step import make_transport_params as tparams
from jaybenne_tpu_torch.utils.deck import Deck as TDeck

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
<mcblock>
opacity_model = constant
opacity_constant_value = 16.0
scattering_model = constant
scattering_constant_value = 48.0
initial_density = 1.0
initial_temperature = 1.0e5
initial_radiation = thermal
"""
# (global cells, cells per block) per axis for each dimensionality: several blocks
# per axis, so the uniform-forest collapse and the global-order table are exercised
MESHES = {
    2: ((16, 8, 1), (8, 4, 1)),
    3: ((8, 8, 8), (4, 4, 4)),
}
SIGMA_A, SIGMA_S = 16.0, 48.0
C = 2.99792458e10
KEY = jr.PRNGKey(20261016)
N = 4000
N_WALL = 8  # per wall and axis: a hair from the wall, flying into it
# floats of one particle after the same events: the two packages' float32 log and
# cos may differ by an ulp, carried through a few events
FLOAT_RTOL = 1e-5
# absolute floors where a value cancels: positions [cm] (one f32 ulp of the
# collapsed block's coordinates is 6e-8 cm, and the collapse round trip adds a
# few), and the velocity floor below carried over the events after a scatter
# (a few mean free paths of 1/64 cm); velocities, since the scatter's sin(phi) = sqrt(1 - cos(phi)^2) turns one
# ulp (6e-8) of cos(phi) near |cos(phi)| = 1 into up to sqrt(2 * 6e-8) = 3.5e-4 of
# c; tau, which adds d / (c dt) with d a difference of positions
FLOAT_ATOL = {"x": 5e-5, "y": 5e-5, "z": 5e-5, "vx": 5e-4 * C, "vy": 5e-4 * C,
              "vz": 5e-4 * C, "tau": 1e-6}
# full census, the checks of tests/test_pallas.py
MEAN_ATOL = 0.01
MEAN_ATOL_GRID = 2e-3
STD_RTOL = 0.10
EVENTS_RTOL = 0.05
N_SIGMA_BINOMIAL = 4.0



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are small, and the suite runs in several
    processes at once, where PyTorch's default of one thread per core oversubscribes
    the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _mods(ndim, cells, blocks, **extra):
    mods = {}
    for a, key in enumerate(("1", "2", "3")):
        mods[f"parthenon/mesh/nx{key}"] = cells[a]
        mods[f"parthenon/meshblock/nx{key}"] = blocks[a]
    return {**mods, **extra}


def _configs(mods):
    return (jcm.from_deck(JDeck.parse(DECK).update(dict(mods))),
            tcm.from_deck(TDeck.parse(DECK).update(dict(mods))))


def _ledger_np(mesh, cap, n, seed=7, n_wall=N_WALL):
    """Numpy ledger of ``cap`` slots: ``n`` live particles at uniform positions
    over the whole domain with isotropic directions, a third of them a hair from a
    cell face and flying into it, plus ``n_wall`` particles per wall of each
    active axis flying straight into it. Positions are block-local."""
    rng = np.random.default_rng(seed)
    ndim = mesh.ndim
    nloc = (mesh.nx, mesh.ny, mesh.nz)
    nrb = mesh.root_grid[::-1]
    ncell = [nloc[a] * nrb[a] for a in range(3)]
    b = mesh.bounds
    dxg = [(b[2 * a + 1] - b[2 * a]) / ncell[a] for a in range(3)]
    f = lambda: np.zeros(cap, np.float32)  # noqa: E731
    i = lambda: np.zeros(cap, np.int32)  # noqa: E731
    d = dict(x=f(), y=f(), z=f(), vx=f(), vy=f(), vz=f(), tau=f(), weight=f(),
             energy=f(), block=i(), i=i(), j=i(), k=i(), face=i(),
             alive=np.zeros(cap, bool), absorbed=np.zeros(cap, bool))
    mu = 1.0 - 2.0 * rng.random(n)
    phi = 2 * np.pi * rng.random(n)
    st = np.sqrt(1.0 - mu * mu)
    v = np.stack([st * np.cos(phi), st * np.sin(phi), mu])
    g = np.stack([rng.integers(0, ncell[a], n) for a in range(3)])
    u = rng.random((3, n))
    # a third sit 1e-4 of a cell from the face their direction points at
    near = rng.random(n) < 1.0 / 3.0
    ax = rng.integers(0, ndim, n)
    for a in range(ndim):
        m = near & (ax == a)
        u[a, m] = np.where(v[a, m] > 0, 1.0 - 1e-4, 1e-4)
    gpos = (g + u) * np.asarray(dxg)[:, None]
    # wall particles: on each active axis, n_wall at the low wall flying down and
    # n_wall at the high wall flying up
    walls = []
    for a in range(ndim):
        for hi in (False, True):
            gw = np.stack([rng.integers(0, ncell[k], n_wall) for k in range(3)])
            pw = (gw + rng.random((3, n_wall))) * np.asarray(dxg)[:, None]
            vw = np.zeros((3, n_wall))
            vw[a] = 1.0 if hi else -1.0
            gw[a] = ncell[a] - 1 if hi else 0
            pw[a] = (ncell[a] - 1e-6) * dxg[a] if hi else 1e-6 * dxg[a]
            walls.append((gw, pw, vw))
    g = np.concatenate([g] + [w[0] for w in walls], axis=1)
    gpos = np.concatenate([gpos] + [w[1] for w in walls], axis=1)
    v = np.concatenate([v] + [w[2] for w in walls], axis=1)
    m = g.shape[1]
    bk = g // np.asarray(nloc)[:, None]
    d["block"][:m] = (bk[2] * nrb[1] + bk[1]) * nrb[0] + bk[0]
    for a, (pname, iname, vname) in enumerate((("x", "i", "vx"), ("y", "j", "vy"),
                                                ("z", "k", "vz"))):
        d[iname][:m] = g[a] - bk[a] * nloc[a]
        d[pname][:m] = gpos[a] - bk[a] * nloc[a] * dxg[a] if a < ndim else 0.0
        d[vname][:m] = C * v[a]
    if ndim == 1:  # 1D keeps the transverse magnitude in vy, vz = 0
        d["vy"][:m] = C * np.sqrt(1.0 - v[0] ** 2)
        d["vz"][:m] = 0.0
    d["alive"][:m] = True
    d["weight"][:m] = 1.0
    return d


def _coefs(nc, sigma_a=SIGMA_A, sigma_s=SIGMA_S):
    jc = jT.TransportCoefs(
        sigma_a=jnp.full((nc,), sigma_a), sigma_s=jnp.full((nc,), sigma_s),
        fleck=jnp.ones((nc,)), px=None, py=None, pz=None,
    )
    tc = TransportCoefs(sigma_a=torch.full((nc,), sigma_a), sigma_s=torch.full((nc,), sigma_s),
                        fleck=torch.ones(nc))
    return jc, tc


def _setup(mods, cap, n, max_iters=None, seed=7, n_wall=N_WALL, **coef_kw):
    jcfg, tcfg = _configs(mods)
    jmesh, tmesh = jbuild_mesh(jcfg.mesh), tbuild_mesh(tcfg.mesh)
    jprm, tprm = jparams(jcfg, jnp.float32), tparams(tcfg, torch.float32)
    assert jprm.has_absorption and tprm.has_absorption
    if max_iters is not None:
        jprm = dataclasses.replace(jprm, max_iters=max_iters)
        tprm = dataclasses.replace(tprm, max_iters=max_iters)
    d = _ledger_np(tmesh, cap, n, seed=seed, n_wall=n_wall)
    jl = JLedger(**{k: jnp.asarray(v) for k, v in d.items()}, leak=jnp.zeros(cap, jnp.int32))
    tl = bridge.state_from_numpy(d)
    jc, tc = _coefs(tmesh.total_cells, **coef_kw)
    kseed = int(np.asarray(jr.key_data(KEY)).reshape(-1)[-1].astype(np.uint32).view(np.int32))
    dt = tcfg.jaybenne.dt
    return dt, (jl, jc, jmesh, jprm), (tl, tc, tmesh, tprm), kseed, d


def _np(ledger):
    if isinstance(ledger, JLedger):
        return {f.name: np.asarray(getattr(ledger, f.name)) for f in dataclasses.fields(ledger)}
    return bridge.state_to_numpy(ledger)


def _binomial_gate(k_a, k_b, n):
    """Two absorbed counts of n trials agree within N_SIGMA_BINOMIAL combined
    binomial standard deviations."""
    p = 0.5 * (k_a + k_b) / n
    sd = np.sqrt(2.0 * n * p * (1.0 - p))
    assert abs(k_a - k_b) <= N_SIGMA_BINOMIAL * sd + 1, (k_a, k_b, sd)


@pytest.mark.parametrize("ndim, max_iters", [(2, 1), (2, 8), (3, 1), (3, 8)])
def test_first_events_match_jax_kernel_per_particle(ndim, max_iters):
    cells, blocks = MESHES[ndim]
    dt, (jl, jc, jmesh, jprm), (tl, tc, tmesh, tprm), seed, d0 = _setup(
        _mods(ndim, cells, blocks), pt.TILE, N, max_iters)
    assert tmesh.ndim == ndim and tmesh.n_blocks > 1 and pt.supports(jmesh, jprm)
    jout, jit_, jev = pt.transport_pallas(jl, jc, jmesh, KEY, jprm, jnp.float32(dt),
                                          interpret=True)
    tout, tit, tev = transport_kernel.transport(tl, tc, tmesh, seed, tprm, dt)
    a, b = _np(tout), _np(jout)
    live = d0["alive"]
    for name in ("i", "j", "k", "block", "alive", "absorbed"):
        np.testing.assert_array_equal(a[name][live], b[name][live], err_msg=name)
    for name in ("x", "y", "z", "vx", "vy", "vz", "tau"):
        np.testing.assert_allclose(a[name][live], b[name][live], rtol=FLOAT_RTOL,
                                   atol=FLOAT_ATOL[name], err_msg=name)
    assert int(tit) == int(jit_) == max_iters
    assert int(tev) == int(jev) and tev.dtype == torch.int64
    assert a["absorbed"].sum() > 0 and not (a["alive"] & a["absorbed"]).any()
    if max_iters == 1:
        # the x-wall particles reflect, the y-wall ones wrap, the z-wall ones leave
        w = slice(N, N + 2 * N_WALL)
        assert (np.sign(a["vx"][w]) == np.repeat([1, -1], N_WALL)).all()
        wy = slice(N + 2 * N_WALL, N + 3 * N_WALL)
        assert (a["j"][wy] == tmesh.ny - 1).all()
        if ndim == 3:
            wz = slice(N + 4 * N_WALL, N + 6 * N_WALL)
            assert not a["alive"][wz].any() and not a["absorbed"][wz].any()


def test_full_census_matches_jax_kernel_3d_periodic():
    """sigma_t = 64 as above with p_abs = 1/256 (exact in bf16), so that about 78 %
    of the particles survive c dt = 1 cm. Positions are compared over every
    particle, the absorbed ones where they were absorbed: the survivors alone
    differ by which ones the two random streams absorb."""
    cells, blocks = MESHES[3]
    per = {f"parthenon/swarm/{s}x{k}_bc": "periodic" for s in "io" for k in "123"}
    dt, (jl, jc, jmesh, jprm), (tl, tc, tmesh, tprm), seed, d0 = _setup(
        _mods(3, cells, blocks, **per), pt.TILE, N, sigma_a=0.25, sigma_s=63.75)
    jk, _, ev_j = pt.transport_pallas(jl, jc, jmesh, KEY, jprm, jnp.float32(dt),
                                      interpret=True)
    tout, _, ev_t = transport_kernel.transport(tl, tc, tmesh, seed, tprm, dt)
    a, b = _np(tout), _np(jk)
    n0 = int(d0["alive"].sum())
    # periodic on every axis: a particle is either absorbed or at census
    for out in (a, b):
        assert out["alive"].sum() + out["absorbed"].sum() == n0
        assert not (out["tau"][out["alive"]] < 1.0).any()
    assert 0.6 * n0 < a["alive"].sum() < 0.9 * n0
    for axis in range(3):
        gt = tout.global_position(tmesh)[axis].numpy()[d0["alive"]]
        gj = np.asarray(jk.global_position(jmesh)[axis])[d0["alive"]]
        assert (gt >= -0.5).all() and (gt <= 0.5).all()
        assert abs(gt.mean() - gj.mean()) < MEAN_ATOL, axis
        assert abs(gt.std() - gj.std()) / gj.std() < STD_RTOL, axis
    assert abs(int(ev_t) - int(ev_j)) / int(ev_j) < EVENTS_RTOL
    _binomial_gate(int(a["absorbed"].sum()), int(b["absorbed"].sum()), n0)


def test_full_census_matches_jax_grid_kernel(monkeypatch):
    """A 2D mesh of 8192 cells, past K1's 5120-cell limit: the JAX package takes
    K3 there, with its regions shrunk so interpret mode stays affordable (as
    tests/test_pallas.py does). sigma_t = 4096 with p_abs = 1/64 absorbs about half
    the particles within dt = 3.3e-13 s (c dt = 0.01 cm, a few cells). Positions
    are compared over every particle, the absorbed ones where they were
    absorbed."""
    monkeypatch.setattr(pg, "REGION_CELLS_IMC", 1024)
    monkeypatch.setattr(pg, "REGION_CELLS_DDMC", 1024)
    mods = _mods(2, (128, 64, 1), (16, 16, 1), **{"jaybenne/dt": "3.3e-13",
                                                   "parthenon/time/tlim": "3.3e-13"})
    n = 4000
    dt, (jl, jc, jmesh, jprm), (tl, tc, tmesh, tprm), seed, d0 = _setup(
        mods, pg.BTILE * 2, n, n_wall=0, sigma_a=64.0, sigma_s=4032.0)
    assert not pt.supports(jmesh, jprm) and pg.supports(jmesh, jprm)
    jg, _, ev_j = pg.transport_grid(jl, jc, jmesh, KEY, jprm, jnp.float32(dt),
                                    interpret=True)
    tout, _, ev_t = transport_kernel.transport(tl, tc, tmesh, seed, tprm, dt)
    a, b = _np(tout), _np(jg)
    for out in (a, b):
        assert not (out["tau"][out["alive"]] < 1.0).any()
    for axis in range(2):
        gt = tout.global_position(tmesh)[axis].numpy()[d0["alive"]]
        gj = np.asarray(jg.global_position(jmesh)[axis])[d0["alive"]]
        assert abs(gt.mean() - gj.mean()) < MEAN_ATOL_GRID, axis
        assert abs(gt.std() - gj.std()) / gj.std() < STD_RTOL, axis
    assert abs(int(ev_t) - int(ev_j)) / int(ev_j) < EVENTS_RTOL
    assert 0.2 * n < a["absorbed"].sum() < 0.8 * n
    _binomial_gate(int(a["absorbed"].sum()), int(b["absorbed"].sum()), n)
    # cells stay consistent with block-local positions
    for pname, iname, nloc in (("x", "i", tmesh.nx), ("y", "j", tmesh.ny)):
        live = a["alive"]
        assert ((a[iname][live] >= 0) & (a[iname][live] < nloc)).all()


def test_rare_absorption_unbiased():
    """Port of tests/test_pallas.py::test_rare_absorption_unbiased on the plain
    version: with sigma_a / sigma_t ~ 7.5e-6, a 16-bit branch uniform quantises the
    absorption probability to 1/65536 (+103 % here); the 23-bit draw resolves it.
    Expected absorbed over one step: n (1 - exp(-sigma_a c dt)) = 24, sd ~ 4.9;
    the gate at 3.2 sd rejects the biased mean of ~49 at ~5 sd."""
    sigma_a, sigma_s, n = 0.0015, 200.0, 16000
    mods = {"parthenon/mesh/nx1": 100, "parthenon/meshblock/nx1": 50}
    _, tcfg = _configs(mods)
    mesh = tbuild_mesh(tcfg.mesh)
    prm = tparams(tcfg, torch.float32)
    d = _ledger_np(mesh, n, n, seed=11, n_wall=0)
    p = bridge.state_from_numpy(d)
    _, tc = _coefs(mesh.total_cells, sigma_a=sigma_a, sigma_s=sigma_s)
    dt = 3.335641e-11  # c dt = 1 cm
    out, _, _ = transport_kernel.transport(p, tc, mesh, 12345, prm, dt)
    absorbed = int(out.absorbed.sum())
    expect = n * (1.0 - np.exp(-sigma_a * C * dt))
    assert abs(absorbed - expect) < 3.2 * np.sqrt(expect), (absorbed, expect)


def test_uniform_view_remap_matches_lookup():
    """Port of tests/test_pallas.py::test_uniform_view_remap_matches_lookup: the
    port's global-order table layout (a reshape and permute) agrees with the
    mapping through the block forest's lookup grid, and with the JAX K3's, on 1D,
    2D and 3D multi-block forests."""
    for ndim, cells, blocks in ((1, (16, 1, 1), (4, 1, 1)), (2, (32, 16, 1), (8, 8, 1)),
                                (3, (8, 8, 8), (4, 2, 4))):
        jcfg, tcfg = _configs(_mods(ndim, cells, blocks))
        mesh, jmesh = tbuild_mesh(tcfg.mesh), jbuild_mesh(jcfg.mesh)
        assert mesh.max_level == 0 and mesh.n_blocks > 1
        v = torch.arange(mesh.total_cells, dtype=torch.int32)
        got = transport_kernel.to_global_cells(v, mesh).numpy()
        # block-order cell id of each global cell, through the lookup grid
        lut = mesh.lookup.numpy()
        nz, ny, nx = mesh.nz, mesh.ny, mesh.nx
        gz, gy, gx = np.meshgrid(*(np.arange(n) for n in (lut.shape[0] * nz, lut.shape[1] * ny,
                                                          lut.shape[2] * nx)), indexing="ij")
        blk = lut[gz // nz, gy // ny, gx // nx]
        want = (((blk * nz + gz % nz) * ny + gy % ny) * nx + gx % nx).reshape(-1)
        np.testing.assert_array_equal(got, want)
        jwant = np.asarray(pg._to_global(
            jmesh, jnp.arange(mesh.total_cells, dtype=jnp.int32).reshape(
                mesh.n_blocks, nz, ny, nx))).reshape(-1)
        np.testing.assert_array_equal(got, jwant)
