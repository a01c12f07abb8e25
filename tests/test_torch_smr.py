"""Static mesh refinement in the port against the JAX package: the forest lookup
(position -> block -> cell), the position-sampled DDMC face probabilities, the
census kernel's SMR branch (K1(d)) particle by particle over the first events and
statistically over a full census, the grazing block-crossing regression on a
refined forest, and SMR decks through both packages' ``Simulation``.

The per-particle comparison runs a hybrid ledger on a level-1 forest: x-slabs of
cells alternate between thin (sigma_t = 16, IMC on every level) and thick
(sigma_t = 512, DDMC on every level) by cell centre, so that IMC crossings change
level both ways and DDMC leaks from coarse thick cells resample onto fine
subfaces. Coefficients are exact in bf16, and face probabilities are rounded
through bf16 before either package gets them, so that the JAX kernel's bf16 tables
and the port's f32 tables hold the same numbers and both draw the same K2
variates per slot."""

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
from jaybenne_tpu_torch.particles import empty_ledger
from jaybenne_tpu_torch.step import make_transport_params as tparams
from jaybenne_tpu_torch.utils.deck import Deck as TDeck

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(_ROOT, "inputs")
# the forests: (deck, overrides), each cut to a CPU size
SMALL_2D = {"parthenon/mesh/nx1": 32, "parthenon/mesh/nx2": 16,
            "parthenon/meshblock/nx1": 8, "parthenon/meshblock/nx2": 8}
FORESTS = {
    "1d_level1": ("stepdiff.in",
                  {"parthenon/mesh/nx1": 64, "parthenon/meshblock/nx1": 8,
                   "parthenon/mesh/refinement": "static",
                   "parthenon/static_refinement1/level": 1,
                   "parthenon/static_refinement1/x1min": -0.25,
                   "parthenon/static_refinement1/x1max": 0.25}),
    "2d_level1": ("stepdiff_smr.in", SMALL_2D),
    "2d_level2": ("stepdiff_smr2.in", SMALL_2D),
    "3d_level1": ("stepdiff_3d_smr_ddmc.in",
                  {"parthenon/mesh/nx1": 16, "parthenon/mesh/nx2": 8, "parthenon/mesh/nx3": 8,
                   "parthenon/meshblock/nx1": 4, "parthenon/meshblock/nx2": 4,
                   "parthenon/meshblock/nx3": 4}),
}
# thin (IMC) and thick (DDMC) cells: sigma_t dmin = 0.25-1 or 8-32 against
# tau_ddmc = 5 on both levels; every value, and fleck sigma_a, exact in bf16
THIN = (1.0, 15.0)      # (sigma_a, sigma_s) with absorption
THICK = (32.0, 480.0)
SLAB = 1.0 / 16.0       # x-slab width: two coarse cells of the 2D forest
C = 2.99792458e10
KEY = jr.PRNGKey(20261017)
N = 4000
N_EDGE = 800    # on the coarse side of a coarse/fine face, in a thick cell
N_FACE = 800    # on a face of a thick cell with the face-arrival code set
# the tolerances of tests/test_torch_ddmc.py
FLOAT_RTOL = 1e-5
FLOAT_ATOL = {"x": 5e-5, "y": 5e-5, "z": 5e-5, "vx": 5e-4 * C, "vy": 5e-4 * C,
              "vz": 5e-4 * C, "tau": 1e-6}
PROB_RTOL = 1e-6
MEAN_ATOL = 0.01
STD_RTOL = 0.15
EVENTS_RTOL = 0.05
N_SIGMA_BINOMIAL = 4.0
# the slice end to end: radiation energy conserved to float32 roundings
ENERGY_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are small, and the suite runs in several
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(deck, mods):
    path = os.path.join(INPUTS, deck)
    return (jcm.from_deck(JDeck.from_file(path).update(dict(mods))),
            tcm.from_deck(TDeck.from_file(path).update(dict(mods))))


def _forest(name, **extra):
    deck, mods = FORESTS[name]
    jcfg, tcfg = _configs(deck, {**mods, **extra})
    jmesh, tmesh = jbuild_mesh(jcfg.mesh), tbuild_mesh(tcfg.mesh)
    assert tmesh.max_level == {"2d_level2": 2}.get(name, 1) and tmesh.n_blocks > 4
    return jcfg, tcfg, jmesh, tmesh


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))


# ------------------------------------------------------- (a) position -> block -> cell


@pytest.mark.parametrize("name", sorted(FORESTS))
def test_locate_block_and_cell_match_jax(name):
    """Random points, and points on every lookup-tile edge, through both packages'
    forest lookup and block-local cell."""
    _, _, jmesh, tmesh = _forest(name)
    rng = np.random.default_rng(len(name))
    b = tmesh.bounds
    n = 20000
    pts = [rng.uniform(b[2 * a], b[2 * a + 1], n).astype(np.float32) for a in range(3)]
    ntz, nty, ntx = tmesh.tile_shape
    for a, nt in enumerate((ntx, nty, ntz)):  # tile edges, where floor binning decides
        edge = b[2 * a] + (b[2 * a + 1] - b[2 * a]) * rng.integers(0, nt + 1, n) / nt
        pts[a][: n // 4] = edge[: n // 4].astype(np.float32)
    jb = np.array(jmesh.locate_block(*(jnp.asarray(p) for p in pts)))
    tb = tmesh.locate_block(*(torch.from_numpy(p) for p in pts))
    np.testing.assert_array_equal(tb.numpy(), jb)
    assert len(np.unique(jb)) == tmesh.n_blocks
    org = np.asarray(jmesh.block_origin)[jb]
    loc = [pts[a] - org[:, a] for a in range(3)]
    want = jmesh.cell_of_local(jnp.asarray(jb), *(jnp.asarray(v) for v in loc))
    got = tmesh.cell_of_local(torch.from_numpy(jb), *(torch.from_numpy(v) for v in loc))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(tmesh.block_meta.numpy(), np.asarray(jmesh.block_meta))


# ------------------------------------------------------------------- (b) face probs


@pytest.mark.parametrize("name", sorted(FORESTS))
@pytest.mark.parametrize("periodic", [False, True])
def test_face_probs_refined_match_jax(name, periodic):
    """Random per-cell sigma_t straddling tau_ddmc on both levels of a refined
    forest, with outflow or periodic field boundaries."""
    bc = "periodic" if periodic else "outflow"
    jcfg, tcfg, jmesh, tmesh = _forest(
        name, **{f"parthenon/mesh/{s}x{k}_bc": bc for s in "io" for k in "123"})
    assert tcfg.mesh.periodic_flags == (periodic,) * 3
    rng = np.random.default_rng(3 + periodic + len(name))
    dmin = float(tmesh.block_dx[:, : tmesh.ndim].min())
    sig = (5.0 / dmin) * np.exp(rng.uniform(-2.0, 1.5, (tmesh.n_blocks, tmesh.nz, tmesh.ny,
                                                          tmesh.nx))).astype(np.float32)
    tau = sig * dmin
    assert (tau > 5.0).mean() > 0.2 and (tau <= 5.0).mean() > 0.2
    want = jfleck.ddmc_face_probs(jmesh, jnp.asarray(sig), 5.0, jcfg.mesh.periodic_flags,
                                  jnp.float32)
    got = tfleck.ddmc_face_probs(tmesh, torch.from_numpy(sig), 5.0, tcfg.mesh.periodic_flags,
                                 torch.float32)
    for a, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=PROB_RTOL, err_msg=str(a))
        if a >= tmesh.ndim:
            assert not g.any()
        else:
            assert g.min() > 0


# --------------------------------------------------- (c) first events, per particle


def _centres(mesh):
    """Cell-centre x of every cell [NC] and each cell's (block, i, j, k)."""
    xc = mesh.cell_centers()[0].reshape(-1).double().numpy()
    b, k, j, i = np.meshgrid(np.arange(mesh.n_blocks), np.arange(mesh.nz), np.arange(mesh.ny),
                             np.arange(mesh.nx), indexing="ij")
    return xc, [v.reshape(-1) for v in (b, i, j, k)]


def _thick(xc, mesh):
    return np.floor((xc - mesh.bounds[0]) / SLAB).astype(np.int64) % 2 == 1


def _hybrid_coefs(jcfg, jmesh, tmesh, absorb, ddmc):
    """(JAX coefs, port coefs) on the hybrid slabs."""
    thick = _thick(_centres(tmesh)[0], tmesh)
    sa = np.where(thick, THICK[0], THIN[0]).astype(np.float32)
    ss = np.where(thick, THICK[1], THIN[1]).astype(np.float32)
    if not absorb:  # the same sigma_t, all of it scattering
        sa, ss = np.zeros_like(sa), sa + ss
    nc = sa.size
    probs = [np.zeros((1,), np.float32)] * 3
    if ddmc:
        sig = jnp.asarray((sa + ss).reshape(tmesh.n_blocks, tmesh.nz, tmesh.ny, tmesh.nx))
        probs = [_bf16(p) for p in jfleck.ddmc_face_probs(
            jmesh, sig, jcfg.jaybenne.tau_ddmc, jcfg.mesh.periodic_flags, jnp.float32)]
    jc = jT.TransportCoefs(sigma_a=jnp.asarray(sa), sigma_s=jnp.asarray(ss),
                           fleck=jnp.ones((nc,)),
                           **{k: jnp.asarray(v) for k, v in zip(("px", "py", "pz"), probs)})
    tc = TransportCoefs(sigma_a=torch.from_numpy(sa), sigma_s=torch.from_numpy(ss),
                        fleck=torch.ones(nc),
                        **({k: torch.from_numpy(np.array(v)) for k, v in
                            zip(("px", "py", "pz"), probs)} if ddmc else {}))
    return jc, tc


def _hybrid_ledger(mesh, cap, seed=7):
    """``N`` live particles in cells drawn uniformly over the forest's cells, at
    uniform positions in them with isotropic directions, a third of them a hair
    from the face their direction points at; ``N_EDGE`` in the thick coarse cells
    that touch a finer block across an x face; ``N_FACE`` on a face of a thick cell
    flying into it with the matching face code."""
    rng = np.random.default_rng(seed)
    nd = mesh.ndim
    xc, (cb, ci, cj, ck) = _centres(mesh)
    thick = _thick(xc, mesh)
    dxb = mesh.block_dx.double().numpy()
    lvl = mesh.block_level.numpy()
    # coarse thick cells on the coarse side of a coarse/fine x face
    edge = np.zeros_like(thick)
    for sgn, at in ((1, mesh.nx - 1), (-1, 0)):
        gx = xc + sgn * 0.75 * dxb[cb, 0]
        inside = (gx > mesh.bounds[0]) & (gx < mesh.bounds[1])
        g = [torch.from_numpy(np.clip(gx, mesh.bounds[0], mesh.bounds[1]).astype(np.float32))]
        for a in (1, 2):
            o = mesh.block_origin[:, a].double().numpy()[cb]
            g.append(torch.from_numpy((o + ((cj, ck)[a - 1] + 0.5) * dxb[cb, a])
                                      .astype(np.float32)))
        nb = mesh.locate_block(*g).numpy()
        edge |= inside & (ci == at) & thick & (lvl[nb] > lvl[cb])
    assert edge.any()
    m = N + N_EDGE + N_FACE
    cells = rng.integers(0, xc.size, m)
    cells[N:N + N_EDGE] = rng.choice(np.flatnonzero(edge), N_EDGE)
    cells[N + N_EDGE:] = rng.choice(np.flatnonzero(thick), N_FACE)
    mu = 1.0 - 2.0 * rng.random(m)
    phi = 2 * np.pi * rng.random(m)
    st = np.sqrt(1.0 - mu * mu)
    v = np.stack([st * np.cos(phi), st * np.sin(phi), mu])
    u = rng.random((3, m))
    face = np.zeros(m, np.int32)
    ax = rng.integers(0, nd, m)
    near = rng.random(m) < 1.0 / 3.0
    near[N:N + N_EDGE] = True
    ax[N:N + N_EDGE] = 0
    v[0, N:N + N_EDGE] = np.where(xc[cells[N:N + N_EDGE]] < 0, 1.0, -1.0) * np.abs(
        v[0, N:N + N_EDGE])
    for a in range(nd):
        sel = near & (ax == a)
        u[a, sel] = np.where(v[a, sel] > 0, 1.0 - 1e-4, 1e-4)
    fa = np.arange(N + N_EDGE, m)
    lower = rng.random(N_FACE) < 0.5
    for a in range(nd):
        sel = ax[fa] == a
        idx = fa[sel]
        u[a, idx] = np.where(lower[sel], 0.0, 1.0)
        v[a, idx] = np.abs(v[a, idx]) * np.where(lower[sel], 1.0, -1.0)
        face[idx] = np.where(lower[sel], a + 1, -(a + 1))
    f = lambda: np.zeros(cap, np.float32)  # noqa: E731
    i = lambda: np.zeros(cap, np.int32)  # noqa: E731
    d = dict(x=f(), y=f(), z=f(), vx=f(), vy=f(), vz=f(), tau=f(), weight=f(),
             energy=f(), block=i(), i=i(), j=i(), k=i(), face=i(),
             alive=np.zeros(cap, bool), absorbed=np.zeros(cap, bool))
    blk = cb[cells]
    d["block"][:m] = blk
    for a, (pname, iname, vname) in enumerate((("x", "i", "vx"), ("y", "j", "vy"),
                                                ("z", "k", "vz"))):
        c = (ci, cj, ck)[a][cells]
        d[iname][:m] = c
        d[pname][:m] = (c + u[a]) * dxb[blk, a] if a < nd else 0.0
        d[vname][:m] = C * v[a]
    d["face"][:m] = face
    d["alive"][:m] = True
    d["weight"][:m] = 1.0
    return d


def _setup(name, absorb, ddmc, max_iters=None, tau0=None):
    extra = {"jaybenne/use_ddmc": "true" if ddmc else "false", "jaybenne/tau_ddmc": 5.0,
             "mcblock/opacity_model": "constant" if absorb else "none",
             "mcblock/opacity_constant_value": 1.0}
    jcfg, tcfg, jmesh, tmesh = _forest(name, **extra)
    jprm, tprm = jparams(jcfg, jnp.float32), tparams(tcfg, torch.float32)
    assert tprm.use_ddmc == ddmc and tprm.has_absorption == absorb
    assert pt.supports(jmesh, jprm)
    if max_iters is not None:
        jprm = dataclasses.replace(jprm, max_iters=max_iters)
        tprm = dataclasses.replace(tprm, max_iters=max_iters)
    d = _hybrid_ledger(tmesh, pt.TILE)
    if tau0 is not None:
        d["tau"][:] = tau0 + (1.0 - tau0) * np.random.default_rng(5).random(pt.TILE)
    jl = JLedger(**{k: jnp.asarray(v) for k, v in d.items()},
                 leak=jnp.zeros(pt.TILE, jnp.int32))
    jc, tc = _hybrid_coefs(jcfg, jmesh, tmesh, absorb, ddmc)
    kseed = int(np.asarray(jr.key_data(KEY)).reshape(-1)[-1].astype(np.uint32).view(np.int32))
    return tcfg.jaybenne.dt, (jl, jc, jmesh, jprm), (tc, tmesh, tprm), kseed, d


def _np(ledger):
    if isinstance(ledger, JLedger):
        return {f.name: np.asarray(getattr(ledger, f.name)) for f in dataclasses.fields(ledger)}
    return bridge.state_to_numpy(ledger)


def _transitions(d0, out, mesh):
    """Counts of what one event did across blocks: level-up and level-down block
    transitions, and leaks of DDMC lanes into a finer block (the subface
    resamples), from the ledgers before and after it."""
    lvl = mesh.block_level.numpy()
    live = d0["alive"] & out["alive"]
    moved = live & (out["block"] != d0["block"])
    up = moved & (lvl[out["block"]] > lvl[d0["block"]])
    down = moved & (lvl[out["block"]] < lvl[d0["block"]])
    xc = mesh.cell_centers()[0].double().numpy()
    was_thick = _thick(xc[d0["block"], d0["k"], d0["j"], d0["i"]], mesh)
    # a DDMC leak leaves the particle off-face with tau < 1; an IMC crossing sets it
    resample = up & was_thick & (out["face"] == 0) & (out["tau"] < 1.0) & (out["tau"] > d0["tau"])
    return {"level up": int(up.sum()), "level down": int(down.sum()),
            "resample": int(resample.sum())}


CASES = [("1d_level1", True, True), ("2d_level1", False, False), ("2d_level1", False, True),
         ("2d_level1", True, True), ("3d_level1", True, False), ("3d_level1", False, True)]


@pytest.mark.parametrize("name, absorb, ddmc", CASES)
def test_first_events_match_jax_kernel_per_particle(name, absorb, ddmc):
    dt, (jl, jc, jmesh, jprm), (tc, tmesh, tprm), seed, d0 = _setup(name, absorb, ddmc,
                                                                     max_iters=8)
    one = dataclasses.replace(tprm, max_iters=1)
    out1 = bridge.state_to_numpy(transport_kernel.transport(
        bridge.state_from_numpy(d0), tc, tmesh, seed, one, dt)[0])
    seen = _transitions(d0, out1, tmesh)
    assert seen["level up"] > 0 and seen["level down"] > 0, seen
    if ddmc and tmesh.ndim >= 2:
        assert seen["resample"] > 0, seen

    jout, jit_, jev = pt.transport_pallas(jl, jc, jmesh, KEY, jprm, jnp.float32(dt),
                                          interpret=True)
    tout, tit, tev = transport_kernel.transport(bridge.state_from_numpy(d0), tc, tmesh, seed,
                                                tprm, dt)
    a, b = _np(tout), _np(jout)
    live = d0["alive"]
    for field in ("i", "j", "k", "block", "alive", "absorbed", "face"):
        np.testing.assert_array_equal(a[field][live], b[field][live], err_msg=field)
    for field in ("x", "y", "z", "vx", "vy", "vz", "tau"):
        np.testing.assert_allclose(a[field][live], b[field][live], rtol=FLOAT_RTOL,
                                   atol=FLOAT_ATOL[field], err_msg=field)
    assert int(tit) == int(jit_) == 8
    assert int(tev) == int(jev) and tev.dtype == torch.int64
    assert (a["block"][live] != d0["block"][live]).any()


# ------------------------------------------------------------------ (d) full census


def test_full_census_smr_ddmc_matches_jax_kernel():
    """The hybrid slabs on the 2D level-1 forest with DDMC, from the last 10 % of a
    step to census, against K1: every survivor at census, positions, events and
    survivor counts statistically."""
    dt, (jl, jc, jmesh, jprm), (tc, tmesh, tprm), seed, d0 = _setup(
        "2d_level1", False, True, tau0=0.9)
    jk, _, ev_j = pt.transport_pallas(jl, jc, jmesh, KEY, jprm, jnp.float32(dt), interpret=True)
    tout, _, ev_t = transport_kernel.transport(bridge.state_from_numpy(d0), tc, tmesh, seed,
                                               tprm, dt)
    a, b = _np(tout), _np(jk)
    for out in (a, b):
        assert not (out["tau"][out["alive"]] < 1.0).any()
    for axis in range(2):
        gt = tout.global_position(tmesh)[axis].numpy()[a["alive"]]
        gj = np.asarray(jk.global_position(jmesh)[axis])[b["alive"]]
        lo, hi = tmesh.bounds[2 * axis], tmesh.bounds[2 * axis + 1]
        assert (gt >= lo).all() and (gt <= hi).all()
        assert abs(gt.mean() - gj.mean()) < MEAN_ATOL, axis
        assert abs(gt.std() - gj.std()) / gj.std() < STD_RTOL, axis
    assert abs(int(ev_t) - int(ev_j)) / int(ev_j) < EVENTS_RTOL
    n0 = int(d0["alive"].sum())
    ka, kb = int(a["alive"].sum()), int(b["alive"].sum())
    p = 0.5 * (ka + kb) / n0
    assert abs(ka - kb) <= N_SIGMA_BINOMIAL * np.sqrt(2.0 * n0 * p * (1.0 - p)) + 1


# -------------------------------------------------------- (e) grazing block crossing


def test_grazing_crossing_into_finer_block_no_spin():
    """tests/test_pallas.py::test_grazing_block_crossing_no_spin on a refined forest:
    64 particles on block 0's upper x face (8 f32(0.00625) = 0.049999999, below the
    lookup-tile edge at 0.05) with a grazing normal velocity cross into level-1
    blocks. A velocity-proportional nudge would bin them back into block 0, where
    the face distance is 0 and crossing always wins: a spin to the iteration cap."""
    mods = {"parthenon/mesh/nx1": 16, "parthenon/mesh/x1min": 0.0,
            "parthenon/mesh/x1max": 0.1, "parthenon/mesh/nx2": 8,
            "parthenon/mesh/x2min": 0.0, "parthenon/mesh/x2max": 0.05,
            "parthenon/meshblock/nx1": 8, "parthenon/meshblock/nx2": 8,
            "parthenon/static_refinement1/x1min": 0.06, "parthenon/static_refinement1/x1max": 0.1,
            "parthenon/static_refinement1/x2min": 0.0, "parthenon/static_refinement1/x2max": 0.05,
            "jaybenne/dt": "2.0e-12", "parthenon/time/tlim": "2.0e-12",
            "mcblock/scattering_constant_value": 1.0e-1}
    _, cfg = _configs("stepdiff_smr.in", mods)
    mesh = tbuild_mesh(cfg.mesh)
    prm = tparams(cfg, torch.float32)
    assert mesh.max_level == 1 and int(mesh.block_level[0]) == 0
    assert int(mesh.block_level[mesh.locate_block(*(torch.tensor([v]) for v in
                                                     (0.051, 0.01, 0.0)))[0]]) == 1
    n = 64
    p = empty_ledger(n)
    dxb = mesh.block_dx[0, 0]
    p.x.fill_(float(8.0 * dxb))
    p.y.copy_(torch.linspace(0.001, float(mesh.block_dx[0, 1]) * 7.9, n))
    p.vx.fill_(C * 1.0e-7)
    p.vy.fill_(C)
    p.i.fill_(7)
    p.j.copy_(torch.arange(n, dtype=torch.int32) % 8)
    p.alive.fill_(True)
    p.weight.fill_(1.0)
    nc = mesh.total_cells
    coefs = TransportCoefs(sigma_a=torch.zeros(nc), sigma_s=torch.full((nc,), 1.0e-1),
                           fleck=torch.ones(nc))
    out, iters, _ = transport_kernel.transport(p, coefs, mesh, 3, prm, 2.0e-12)
    assert int(out.alive.sum()) == n
    assert not bool((out.tau[out.alive] < 1.0).any())
    assert int(iters) < 500, int(iters)
    assert bool((mesh.block_level[out.block.long()] == 1).any())


# ------------------------------------------------------------ (f) the slice end to end

SLICE = {**SMALL_2D, "jaybenne/num_particles": 8000, "jaybenne/dt": "1.e-11",
         "parthenon/time/tlim": "1.e-11", "parthenon/output0/file_type": "none"}
SLICE_DECKS = {
    "stepdiff_smr.in": {"mcblock/scattering_constant_value": "2.0e2"},
    "stepdiff_smr_ddmc.in": {"mcblock/scattering_constant_value": "1.0e3"},
    "stepdiff_smr2.in": {"mcblock/scattering_constant_value": "2.0e2"},
}


@pytest.mark.parametrize("deck", sorted(SLICE_DECKS))
def test_smr_slice_matches_jax(deck, tmp_path):
    """An SMR deck at 32 x 16 cells in 8^2 blocks through both packages'
    ``Simulation`` for one step (tests/test_pallas.py::_run_smr_conservation):
    in each, the tally's energy equals the live weights, and the two packages'
    totals agree."""
    mods = {**SLICE, **SLICE_DECKS[deck]}
    jcfg = _configs(deck, {**mods, "jaybenne/use_pallas": "off"})[0]
    tcfg = _configs(deck, mods)[1]
    jsim = JSimulation(jcfg, outdir=str(tmp_path / "j"), quiet=True)
    tsim = Simulation(tcfg, outdir=str(tmp_path / "t"), quiet=True, device="cpu")
    assert tsim.mesh.max_level == jsim.mesh.max_level > 0
    jsim.run()
    tsim.run()
    assert tsim.cycle == 1 and tsim.history[0]["unfinished"] == 0
    totals = []
    for sim in (jsim, tsim):
        dv = np.asarray(sim.mesh.block_volume, np.float64)[:, None, None, None]
        p = sim.state.particles
        w = float(np.asarray(p.weight, np.float64)[np.asarray(p.alive)].sum())
        e = float((np.asarray(sim.state.fields.energy_tally, np.float64) * dv).sum())
        assert abs(e - w) <= ENERGY_RTOL * w
        totals.append(w)
    assert abs(totals[0] - totals[1]) <= ENERGY_RTOL * totals[0]
