"""``precision = f64`` in the port against the JAX package's float64 path, on the
CPU: the float64 draw pool, one census of the port's float64 plain version against
the JAX float64 XLA loop (``jaybenne_tpu/ops/transport.py::transport``) from one
initial ledger, a reduced stepdiff_ddmc through both packages' ``Simulation``, and
the spatial decomposition's migration of float64 columns.

The JAX package runs float64 through its XLA event loop, which draws threefry
variates; the port runs the census kernel's event body at double precision on its
own counter-hash draws. The two agree in distribution, not draw for draw, so the
census checks compare statistics: event totals, the survivors' displacement, and
absorbed and surviving counts, each within a stated number of Monte Carlo standard
deviations. The JAX side runs with ``jax_enable_x64``, restored in ``finally`` as
``tests/test_f32_bias.py`` does."""

import contextlib
import dataclasses
import os

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from jaybenne_tpu import config as jcm
from jaybenne_tpu.driver import Simulation as JSimulation
from jaybenne_tpu.mesh import build_mesh as jbuild_mesh
from jaybenne_tpu.ops import fleck as jfleck
from jaybenne_tpu.ops import transport as jT
from jaybenne_tpu.particles import ParticleLedger as JLedger
from jaybenne_tpu.step import make_transport_params as jparams
from jaybenne_tpu.utils.deck import Deck as JDeck

from jaybenne_tpu_torch import bridge
from jaybenne_tpu_torch import config as tcm
from jaybenne_tpu_torch.driver import Simulation
from jaybenne_tpu_torch.mesh import build_mesh as tbuild_mesh
from jaybenne_tpu_torch.ops import kernel_rng, tally, transport_kernel
from jaybenne_tpu_torch.ops.transport import TransportCoefs
from jaybenne_tpu_torch.parallel import exchange, spatial
from jaybenne_tpu_torch.particles import empty_ledger
from jaybenne_tpu_torch.step import make_transport_params as tparams
from jaybenne_tpu_torch.utils.constants import SB
from jaybenne_tpu_torch.utils.deck import Deck as TDeck

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(_ROOT, "inputs")
F64 = torch.float64
C = 2.99792458e10
DECK = """
<parthenon/job>
problem_id = census
<parthenon/mesh>
nx1 = 32
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
<parthenon/meshblock>
nx1 = 16
<parthenon/time>
tlim = 1.0e-11
<jaybenne>
num_particles = 4000
dt = 1.0e-11
precision = f64
<mcblock>
opacity_model = constant
opacity_constant_value = 1.0
scattering_model = constant
scattering_constant_value = 15.0
initial_density = 1.0
initial_temperature = 1.0e5
initial_radiation = thermal
"""
# the census cases: (deck or inputs file, deck overrides, (sigma_a, sigma_s) or None
# for the slab hybrid of the SMR forest); every case draws N particles
CASES = {
    "imc_1d": (DECK, {"mcblock/scattering_constant_value": 60.0}, (4.0, 60.0)),
    "ddmc_1d": (DECK, {"jaybenne/use_ddmc": "true", "mcblock/scattering_constant_value": 800.0},
                (2.0, 800.0)),
    "smr_ddmc_2d": ("stepdiff_smr_ddmc.in", {
        "parthenon/mesh/nx1": 32, "parthenon/mesh/nx2": 16, "parthenon/meshblock/nx1": 8,
        "parthenon/meshblock/nx2": 8, "jaybenne/tau_ddmc": 5.0, "jaybenne/dt": 1.0e-11,
        "mcblock/opacity_model": "constant"}, None),
    "epbremss": (DECK, {"mcblock/opacity_model": "ep_bremss",
                        "mcblock/scattering_constant_value": 10.0}, "nongray"),
    # the route of transport_2d_smr_f64: stepdiff_smr (IMC on a level-1 forest), reduced
    "smr_2d": ("stepdiff_smr.in", {
        "parthenon/mesh/nx1": 32, "parthenon/mesh/nx2": 16, "parthenon/meshblock/nx1": 8,
        "parthenon/meshblock/nx2": 8, "jaybenne/dt": 1.0e-11,
        "mcblock/opacity_model": "constant"}, (4.0, 60.0)),
}
# the round of transport_1d_smr_f64@blocks: the 1D deck in four blocks of 8 cells,
# one owned by the shard (the spatial decomposition's K4s route on a uniform forest)
SETUPS = {**CASES, "blocks_1d": (DECK, {"parthenon/meshblock/nx1": 8,
                                        "mcblock/scattering_constant_value": 60.0}, (4.0, 60.0))}
OWNED = (1, 1)  # the shard's blocks [lo, lo + n)
N = 3000
FLECK = 0.8
# the forest's slabs: thin (IMC) and thick (DDMC) sigma_t by cell centre, every
# fourth coarse cell, and sigma_a on both
SLAB_SIGMA = (40.0, 1200.0)
SLAB_SIGMA_A = 4.0
# statistical gates: Monte Carlo standard deviations of the difference of two runs
N_SIGMA = 5.0
STD_RTOL = 0.1
# the reduced stepdiff_ddmc of tests/test_f32_bias.py::test_f32_epsilon_bias_fast
BIAS_MODS = {
    "parthenon/mesh/nx1": 32, "parthenon/meshblock/nx1": 32,
    "jaybenne/num_particles": 20000,
    "jaybenne/seed": 7,
    "parthenon/time/tlim": "1.0006923e-10",  # 3 steps
    "parthenon/output0/file_type": "none",
}
BIAS_TOL = 0.08


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are small, and the suite runs in several
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _x64():
    """The JAX package's float64 mode, switched off again after."""
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


# ------------------------------------------------------------ the float64 pool


def _pool(dtype, lanes, seed=-24680):
    return kernel_rng.DrawPool(lambda it, tag: kernel_rng.raw_bits_plain(seed, lanes, it, tag),
                               dtype)


def test_f64_pool_resolution_and_range():
    """The float64 pool's uniforms are float64 in [0, 1) with 53 bits: far finer
    than 2^-23 (hardly any lands on the float32 pool's grid), distinct across
    lanes, mean 1/2 within 5 sd; the spare u16 is a full double uniform of its
    own; the circle is a unit vector with either sign; each word is the one
    ``draws_f64_plain`` makes of its tag (tags allocated as in float32)."""
    n = 50000
    lanes = torch.arange(n)
    pool = _pool(F64, lanes)
    u = pool.u23(3)            # tag 0
    lo, hi = pool.u16(3), pool.u16(3)  # tag 1 and its spare
    c, s = pool.circle(3)      # tag 2
    e = pool.exp23(3)          # tag 3
    for v in (u, lo, hi):
        assert v.dtype == F64 and float(v.min()) >= 0.0 and float(v.max()) < 1.0
        assert abs(float(v.mean()) - 0.5) < 5.0 * (1.0 / 12.0 / n) ** 0.5
        assert int(torch.unique(v).numel()) == n
        assert int(((v * 2**23) == torch.floor(v * 2**23)).sum()) < 5
    assert abs(float(torch.corrcoef(torch.stack([lo, hi]))[0, 1])) < 5.0 / n**0.5
    assert float((c * c + s * s - 1.0).abs().max()) < 1e-15
    assert 0.45 < float((s < 0).double().mean()) < 0.55
    want = [kernel_rng.draws_f64_plain(-24680, lanes, 3, tag) for tag in range(4)]
    assert torch.equal(u, want[0][:, 0]) and torch.equal(lo, want[1][:, 0])
    assert torch.equal(hi, want[1][:, 1]) and torch.equal(e, want[3][:, 2])
    assert torch.equal(c, want[2][:, 3]) and torch.equal(s, want[2][:, 4])
    tiny = kernel_rng.draws_f64_plain(0, torch.zeros(1, dtype=torch.int64), 0, 0)
    assert bool(torch.isfinite(tiny).all())


def test_f32_pool_is_unchanged():
    """The float32 pool with its dtype spelt out is the pool of before, bit for bit:
    the same words, tags and transforms."""
    lanes = torch.arange(4096)
    a, b = _pool(torch.float32, lanes), kernel_rng.DrawPool(
        lambda it, tag: kernel_rng.raw_bits_plain(-24680, lanes, it, tag))
    for name in ("exp23", "u23", "u16", "u16", "u16", "circle"):
        x, y = getattr(a, name)(5), getattr(b, name)(5)
        for p, q in zip(x if isinstance(x, tuple) else (x,), y if isinstance(y, tuple) else (y,)):
            assert p.dtype == torch.float32 and torch.equal(p, q)
    w = kernel_rng.raw_bits_plain(-24680, lanes, 5, 1)
    assert torch.equal(_pool(torch.float32, lanes).u23(5), kernel_rng.u23(
        kernel_rng.raw_bits_plain(-24680, lanes, 5, 0)))
    assert torch.equal(kernel_rng.u16_hi(w), ((w >> 16) & 0xFFFF).float() / 65536.0)


# ------------------------------------------- one census against the JAX loop


def _configs(case):
    deck, mods, _ = SETUPS[case]
    mods = {**mods, "jaybenne/precision": "f64"}
    if deck.endswith(".in"):
        path = os.path.join(INPUTS, deck)
        return (jcm.from_deck(JDeck.from_file(path).update(mods)),
                tcm.from_deck(TDeck.from_file(path).update(mods)))
    return jcm.from_deck(JDeck.parse(deck).update(mods)), tcm.from_deck(TDeck.parse(deck)
                                                                       .update(mods))


def _census_setup(case, seed=17):
    """(dt, JAX inputs, port inputs, the initial ledger as numpy): N particles in
    cells drawn uniformly over the forest's cells, uniform in them, isotropic, at
    tau 0 (photon energies x sb T of their cell, x log-uniform in [0.05, 30], for
    EPBremss); float64 coefficients and face probabilities built once and carried
    to both packages."""
    jcfg, tcfg = _configs(case)
    sig = SETUPS[case][2]
    jmesh, tmesh = jbuild_mesh(jcfg.mesh, dtype=jnp.float64), tbuild_mesh(tcfg.mesh, F64)
    jprm, tprm = jparams(jcfg, jnp.float64), tparams(tcfg, F64)
    rng = np.random.default_rng(seed)
    nc, nd = tmesh.total_cells, tmesh.ndim
    shape = (tmesh.n_blocks, tmesh.nz, tmesh.ny, tmesh.nx)
    extra, jextra = {}, {}
    if sig == "nongray":
        rho = rng.uniform(0.5, 2.0, nc)
        temp = np.exp(rng.uniform(np.log(5e5), np.log(5e6), nc))
        ff = rng.uniform(0.3, 1.0, nc)
        to, ts = tcfg.mcblock.build_opacity(), tcfg.mcblock.build_scattering()
        sa = to.absorption_coefficient(torch.from_numpy(rho), torch.from_numpy(temp)).numpy()
        ss = ts.total_scattering_coefficient(torch.from_numpy(rho), torch.from_numpy(temp))
        ss = np.broadcast_to(np.asarray(ss, np.float64), (nc,)).copy()
        extra = dict(rho=torch.from_numpy(rho), temp=torch.from_numpy(temp), opacity=to)
        jextra = dict(packed=jnp.stack([jnp.asarray(rho), jnp.asarray(temp), jnp.asarray(ff)],
                                       -1),
                      opacity=jcfg.mcblock.build_opacity(),
                      scattering=jcfg.mcblock.build_scattering())
    elif sig is None:  # the forest's slabs
        xc = np.asarray(tmesh.cell_centers()[0]).reshape(-1)
        width = 4.0 * float(tmesh.block_dx[:, 0].max())
        thick = np.floor((xc - tmesh.bounds[0]) / width).astype(np.int64) % 2 == 1
        sa = np.full(nc, SLAB_SIGMA_A)
        ss = np.where(thick, SLAB_SIGMA[1], SLAB_SIGMA[0]) - sa
        ff = np.full(nc, FLECK)
    else:
        sa, ss, ff = np.full(nc, sig[0]), np.full(nc, sig[1]), np.full(nc, FLECK)
    faces = {}
    if tprm.use_ddmc:
        sig_t = jnp.asarray((sa + ss).reshape(shape))
        faces = dict(zip(("px", "py", "pz"), (np.asarray(f) for f in jfleck.ddmc_face_probs(
            jmesh, sig_t, jcfg.jaybenne.tau_ddmc, jcfg.mesh.periodic_flags, jnp.float64))))
    jfaces = faces or {k: np.zeros(1) for k in ("px", "py", "pz")}  # unread without DDMC
    jc = jT.TransportCoefs(sigma_a=jnp.asarray(sa), sigma_s=jnp.asarray(ss),
                           fleck=jnp.asarray(ff),
                           **{k: jnp.asarray(v) for k, v in jfaces.items()}, **jextra)
    tc = TransportCoefs(sigma_a=torch.from_numpy(sa), sigma_s=torch.from_numpy(ss),
                        fleck=torch.from_numpy(ff),
                        **{k: torch.from_numpy(v.copy()) for k, v in faces.items()}, **extra)
    cells = rng.integers(0, nc, N)
    b, k, j, i = np.unravel_index(cells, shape)
    dxb = tmesh.block_dx.numpy()[b]
    mu = 1.0 - 2.0 * rng.random(N)
    phi = 2.0 * np.pi * rng.random(N)
    st = np.sqrt(1.0 - mu * mu)
    v = np.stack([mu, st, np.zeros(N)]) if nd == 1 else np.stack(
        [st * np.cos(phi), st * np.sin(phi), mu])
    d = {name: np.zeros(N) for name in ("x", "y", "z", "vx", "vy", "vz", "tau", "weight",
                                        "energy")}
    d.update({name: np.zeros(N, np.int32) for name in ("block", "i", "j", "k", "face")})
    d.update(alive=np.ones(N, bool), absorbed=np.zeros(N, bool), weight=np.ones(N))
    d["block"] = b.astype(np.int32)
    for a, (pn, iname, vn) in enumerate((("x", "i", "vx"), ("y", "j", "vy"), ("z", "k", "vz"))):
        c = (i, j, k)[a]
        d[iname] = c.astype(np.int32)
        d[pn] = (c + rng.random(N)) * dxb[:, a] if a < nd else np.zeros(N)
        d[vn] = C * v[a]
    if sig == "nongray":
        d["energy"] = np.exp(rng.uniform(np.log(0.05), np.log(30.0), N)) * SB * temp[cells]
    jl = JLedger(**{name: jnp.asarray(v) for name, v in d.items()},
                 leak=jnp.zeros(N, jnp.int32))
    return (tcfg.jaybenne.dt, (jl, jc, jmesh, jprm), (bridge.state_from_numpy(d), tc, tmesh,
                                                      tprm), d)


def _gx(p, mesh):
    org = np.asarray(mesh.block_origin)[np.asarray(p.block)]
    return org[:, 0] + np.asarray(p.x)


@pytest.mark.parametrize("case", sorted(CASES))
def test_census_matches_jax_f64_loop(case):
    """One float64 census of the port's plain version against the JAX package's
    float64 XLA loop from the same initial ledger: every survivor at census, event
    totals within N_SIGMA sd of their difference (the sd from the port's per-lane
    events), absorbed and surviving counts within N_SIGMA binomial sd, the mean
    x-displacement of the survivors within N_SIGMA sd and its spread within
    STD_RTOL; both ledgers float64 throughout."""
    with _x64():
        dt, (jl, jc, jmesh, jprm), (tl, tc, tmesh, tprm), d = _census_setup(case)
        jout, _, ev_j = jT.transport(jl, jc, jmesh, jr.PRNGKey(2024), jprm, dt)
        lane_events = torch.zeros(N, dtype=torch.int32)
        tout, _, ev_t = transport_kernel.transport_plain(tl, tc, tmesh, 31337, tprm, dt,
                                                         lane_events=lane_events)
        jx = _gx(jout, jmesh)
        jalive, jabs = np.asarray(jout.alive), np.asarray(jout.absorbed)
        jtau = np.asarray(jout.tau)
        assert np.asarray(jout.x).dtype == np.float64
    assert all(getattr(tout, f.name).dtype == F64 for f in dataclasses.fields(tout)
               if getattr(tout, f.name).is_floating_point())
    talive = tout.alive.numpy()
    assert (tout.tau.numpy()[talive] >= 1.0).all() and (jtau[jalive] >= 1.0).all()
    ev = lane_events.double().numpy()
    sd_ev = (2.0 * N * ev.var()) ** 0.5
    assert abs(int(ev_t) - int(ev_j)) <= N_SIGMA * sd_ev + 1, (int(ev_t), int(ev_j), sd_ev)
    for ka, kb in ((int(tout.absorbed.sum()), int(jabs.sum())), (int(talive.sum()),
                                                                  int(jalive.sum()))):
        p = 0.5 * (ka + kb) / N
        assert abs(ka - kb) <= N_SIGMA * (2.0 * N * p * (1.0 - p)) ** 0.5 + 1, (ka, kb)
    x0 = d["x"] + np.asarray(tmesh.block_origin)[d["block"], 0]
    dt_ = _gx(tout, tmesh)[talive] - x0[talive]
    dj = jx[jalive] - x0[jalive]
    sd = (dt_.var() / dt_.size + dj.var() / dj.size) ** 0.5
    assert abs(dt_.mean() - dj.mean()) <= N_SIGMA * sd, (dt_.mean(), dj.mean(), sd)
    assert abs(dt_.std() - dj.std()) <= STD_RTOL * dj.std()


def test_blocks_round_matches_jax_f64_round():
    """One float64 round of the spatial decomposition over a 1D uniform forest
    split in blocks (four of 8 cells, the shard owning block 1), the route of
    transport_1d_smr_f64@blocks: the port's plain version with the owned range
    against the JAX package's float64 round (``transport`` with ``block_offset``,
    as ``jaybenne_tpu/parallel/spatial.py`` runs it) from the same initial ledger
    and the owned blocks' coefficients. Lanes outside the range stay as they were
    in both; the owned lanes that left the range (paused, alive short of census),
    those at census and those absorbed agree within N_SIGMA binomial sd, the
    events within N_SIGMA sd of their difference, and the census survivors' mean
    x within N_SIGMA sd, its spread within STD_RTOL (per-particle equality cannot
    hold: the JAX loop draws threefry variates)."""
    lo, n = OWNED
    with _x64():
        dt, (jl, jc, jmesh, jprm), (tl, tc, tmesh, tprm), d = _census_setup("blocks_1d")
        assert tmesh.n_blocks == 4 and tmesh.max_level == 0
        ncpb = tmesh.ncells_per_block
        cells = slice(lo * ncpb, (lo + n) * ncpb)
        jloc = jT.TransportCoefs(sigma_a=jc.sigma_a[cells], sigma_s=jc.sigma_s[cells],
                                 fleck=jc.fleck[cells], px=jnp.zeros(n), py=jnp.zeros(n),
                                 pz=jnp.zeros(n))
        jout, _, ev_j = jT.transport(jl, jloc, jmesh, jr.PRNGKey(2024), jprm, dt, block_offset=lo)
        jout = {f.name: np.asarray(getattr(jout, f.name)) for f in dataclasses.fields(jout)}
    tloc = TransportCoefs(sigma_a=tc.sigma_a[cells], sigma_s=tc.sigma_s[cells],
                          fleck=tc.fleck[cells])
    own = transport_kernel.OwnedRange("blocks", lo, n)
    lane_events = torch.zeros(N, dtype=torch.int32)
    tout, _, ev_t = transport_kernel.transport_plain(tl, tloc, tmesh, 31337, tprm, dt, own,
                                                     lane_events=lane_events)
    tout = {f.name: getattr(tout, f.name).numpy() for f in dataclasses.fields(tout)}
    assert tout["x"].dtype == np.float64 and jout["x"].dtype == np.float64
    owned = (d["block"] >= lo) & (d["block"] < lo + n)
    for out in (tout, jout):  # the lanes outside the range as they were
        for name in ("x", "vx", "tau", "i", "block"):
            assert np.array_equal(out[name][~owned], d[name][~owned]), name
    org = np.asarray(tmesh.block_origin)[:, 0]

    def outcome(out):
        left = owned & out["alive"] & (out["tau"] < 1.0)
        census = owned & out["alive"] & (out["tau"] >= 1.0)
        assert ((out["block"][left] < lo) | (out["block"][left] >= lo + n)).all()
        assert ((out["block"][census] >= lo) & (out["block"][census] < lo + n)).all()
        return left, census, owned & out["absorbed"]

    (tl_, tcen, tab), (jl_, jcen, jab) = outcome(tout), outcome(jout)
    m = int(owned.sum())
    for ka, kb in ((int(tl_.sum()), int(jl_.sum())), (int(tcen.sum()), int(jcen.sum())),
                   (int(tab.sum()), int(jab.sum()))):
        p = 0.5 * (ka + kb) / m
        assert abs(ka - kb) <= N_SIGMA * (2.0 * m * p * (1.0 - p)) ** 0.5 + 1, (ka, kb)
    assert int(tl_.sum()) > 0.05 * m and int(tcen.sum()) > 0.05 * m
    ev = lane_events.double().numpy()[owned]
    sd_ev = (2.0 * m * ev.var()) ** 0.5
    assert abs(int(ev_t) - int(ev_j)) <= N_SIGMA * sd_ev + 1, (int(ev_t), int(ev_j), sd_ev)
    xt = (org[tout["block"]] + tout["x"])[tcen]
    xj = (org[jout["block"]] + jout["x"])[jcen]
    sd = (xt.var() / xt.size + xj.var() / xj.size) ** 0.5
    assert abs(xt.mean() - xj.mean()) <= N_SIGMA * sd, (xt.mean(), xj.mean(), sd)
    assert abs(xt.std() - xj.std()) <= STD_RTOL * xj.std()


# ------------------------------------------------------- Simulation, end to end


def _tally(sim):
    return np.asarray(sim.state.fields.energy_tally, dtype=np.float64).reshape(-1)


def _sep(a, b):
    w = a + b
    m = w > 0
    return np.abs(a - b)[m].sum() / w[m].sum()


def test_f64_simulation_matches_f32_and_jax_f64(tmp_path):
    """The reduced stepdiff_ddmc of tests/test_f32_bias.py's fast test through the
    port at f32 and f64 and the JAX package at f64 (its XLA loop): every field and
    ledger column float64, the radiation energy conserved to the fixed-point
    tally's bound (``tally.conservation_rtol``), and the weighted separations
    f32/f64 and port/JAX < BIAS_TOL."""
    deck = os.path.join(INPUTS, "stepdiff_ddmc.in")
    runs = {}
    for prec in ("f32", "f64"):
        sim = Simulation(tcm.from_deck(TDeck.from_file(deck).update(
            {**BIAS_MODS, "jaybenne/precision": prec})), outdir=str(tmp_path / prec),
            quiet=True, device="cpu")
        dv = float(sim.mesh.block_volume.double()[0])
        e0 = _tally(sim).sum() * dv
        sim.run()
        runs[prec] = _tally(sim)
        if prec == "f64":
            st = sim.state
            for obj in (st.fields, st.particles):
                for f in dataclasses.fields(obj):
                    t = getattr(obj, f.name)
                    if t.is_floating_point():
                        assert t.dtype == F64, f.name
            # the fixed-point tally's bound at float64 (ops/tally.py)
            rtol = tally.conservation_rtol(st.particles.capacity)
            assert abs(runs[prec].sum() * dv - e0) <= rtol * e0
    with _x64():
        jsim = JSimulation(jcm.from_deck(JDeck.from_file(deck).update(
            {**BIAS_MODS, "jaybenne/precision": "f64", "jaybenne/use_pallas": "off"})),
            outdir=str(tmp_path / "jax"), quiet=True)
        jsim.run()
        jt = _tally(jsim)
    assert _sep(runs["f32"], runs["f64"]) < BIAS_TOL
    assert _sep(runs["f64"], jt) < BIAS_TOL


# ----------------------------------------------------------- the decomposition


def test_spatial_f64_migration_preserves_dtype(tmp_path):
    """The counterpart of tests/test_spatial.py::test_spatial_f64_migration_
    preserves_dtype: tests/test_spatial.py's two-shard deck at f64 migrates
    particles (each float64 column as two int32 words), keeps them float64, does
    not truncate positions, and conserves the live weight."""
    deck = os.path.join(_ROOT, "tests", "test_spatial.py")
    with open(deck) as fh:
        src = fh.read()
    text = src.split('DECK = """', 1)[1].split('"""', 1)[0]
    sim = Simulation(tcm.from_deck(TDeck.parse(text).update({"jaybenne/precision": "f64"})),
                     outdir=str(tmp_path), quiet=True, device="cpu")
    p0 = sim.state.particles
    w0 = float(p0.weight[p0.alive].sum())
    sim.run()
    p = sim.state.particles
    alive = p.alive
    assert p.x.dtype == F64 and p.weight.dtype == F64 and int(alive.sum()) > 0
    assert all(h["migrated"] > 0 for h in sim.history)
    blocks = p.block[alive]
    assert bool((blocks < 1).any()) and bool((blocks >= 1).any())
    xs = p.x[alive]
    assert not bool((xs == torch.trunc(xs)).all()), "positions truncated to integers"
    assert abs(float(p.weight[alive].sum()) - w0) <= 1e-12 * w0


def test_migrate_carries_f64_columns_bitwise():
    """One migration round of float64 ledgers: every float64 column arrives bit for
    bit (two int32 words a value), the int32 columns too."""
    n, bl, cap = 2, 1, 8
    ledgers = []
    for s in range(n):
        p = empty_ledger(cap, F64)
        p.alive[:3] = True
        p.block[:3] = torch.tensor([1 - s] * 3, dtype=torch.int32)  # all in the other shard
        p.x[:3] = torch.tensor([1.0 / 3.0, -2.0 ** -40, np.pi]) + s
        p.energy[:3] = torch.tensor([1e-300, 1e300, -0.0])
        p.i[:3] = torch.tensor([7, -1, 2**30], dtype=torch.int32)
        ledgers.append(p)
    want = [(p.x[:3].clone(), p.energy[:3].clone(), p.i[:3].clone()) for p in ledgers]
    spatial.migrate(ledgers, [0, 1], bl, 4, exchange.InProcess(n))
    for s, p in enumerate(ledgers):
        x, e, i = want[1 - s]
        got = p.alive.nonzero().flatten()
        assert got.numel() == 3 and p.x.dtype == F64
        assert torch.equal(p.x[got].view(torch.int64), x.view(torch.int64))
        assert torch.equal(p.energy[got].view(torch.int64), e.view(torch.int64))
        assert torch.equal(p.i[got], i)
