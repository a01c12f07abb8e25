"""The port's spatial decomposition on the CPU against the JAX package's: the
owned-range census (one round of a shard) against ``make_spatial_grid`` (K3s) and
``make_spatial_transport`` (K4s) in interpret mode, the whole mesh as the owned
range against today's census, the shard-local DDMC face probabilities, the
coarse-to-fine fixup of migrated arrivals, ``migrate``, ports of
``tests/test_spatial.py``, and one slice end to end through both drivers.

The JAX side runs as ``tests/test_spatial.py`` runs it: on the 8 virtual CPU
devices of ``tests/conftest.py``, with the kernels at ``interpret=True`` and the
bucketed kernel's regions shrunk. The JAX kernels bucket particles into tiles, so
a lane draws other K2 words than the port's slot does: rounds are compared
statistically. Coefficients and face probabilities are exact in bf16, so the JAX
kernels' bf16 tables hold the port's numbers."""

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
from jaybenne_tpu.ops import pallas_bucketed as pb
from jaybenne_tpu.ops import pallas_grid as pg
from jaybenne_tpu.ops import transport as jT
from jaybenne_tpu.particles import ParticleLedger as JLedger
from jaybenne_tpu.step import make_transport_params as jparams
from jaybenne_tpu.utils.deck import Deck as JDeck

from jaybenne_tpu_torch import bridge
from jaybenne_tpu_torch import config as tcm
from jaybenne_tpu_torch.driver import Simulation
from jaybenne_tpu_torch.mesh import build_mesh as tbuild_mesh
from jaybenne_tpu_torch.ops import fleck as tfleck
from jaybenne_tpu_torch.ops import rng, transport_kernel
from jaybenne_tpu_torch.ops.transport import TransportCoefs
from jaybenne_tpu_torch.parallel import exchange, spatial
from jaybenne_tpu_torch.particles import empty_ledger, forest_ledger, uniform_ledger
from jaybenne_tpu_torch.step import make_transport_params as tparams
from jaybenne_tpu_torch.utils.deck import Deck as TDeck

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(_ROOT, "inputs")
C = 2.99792458e10
KEY = jr.PRNGKey(20261018)
KSEED = int(np.asarray(jr.key_data(KEY)).reshape(-1)[-1].astype(np.uint32).view(np.int32))

# tests/test_spatial.py's deck: a 1D slab of 8 cells in 4-cell blocks, 2 shards
DECK = """
<parthenon/job>
problem_id = stepdiff
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
<parthenon/meshblock>
nx1 = 4
<parthenon/time>
tlim = 2.e-11
<jaybenne>
num_particles = 4000
dt = 1.e-11
do_emission = false
do_feedback = false
seed = 5
decomposition = spatial
n_devices = 2
<mcblock>
opacity_model = none
scattering_model = constant
scattering_constant_value = 2.0e2
cv = 1.0e8
initial_density = 1.0
initial_temperature = 1.0e5
initial_radiation = thermal
<parthenon/output0>
file_type = none
"""
SMR_FOREST = {"parthenon/mesh/nx1": 32, "parthenon/mesh/nx2": 16,
              "parthenon/meshblock/nx1": 8, "parthenon/meshblock/nx2": 8}
# a round, port against JAX (tests/test_torch_transport_3d.py's tolerances): the
# positions' mean within MEAN_ATOL cm and std within STD_RTOL, events within
# EVENTS_RTOL, paused and pending-leak counts within N_SIGMA binomial sd
MEAN_ATOL = 0.01
STD_RTOL = 0.10
EVENTS_RTOL = 0.05
N_SIGMA = 4.0
# the face probabilities against the JAX package's (tests/test_torch_smr.py:79)
PROB_RTOL = 1e-6
# the subface fixup against the JAX package's on the same draws: float32 roundings
# of a few operations
FIX_RTOL = 1e-6
# tally against the live weights and conservation without absorption; with
# absorption w_live + absorbed = w0 (tests/test_spatial.py:388)
ENERGY_RTOL = 1e-5
ABSORB_RTOL = 1e-4
# the SMR DDMC forest at 8 shards against one device at 12k particles: each
# block's energy (the cells' tallies are too noisy at this size)
SMR8_TOL = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are small, and the suite runs in several
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sim(mods=None, path=None, tmp="."):
    d = TDeck.from_file(path) if path else TDeck.parse(DECK)
    return Simulation(tcm.from_deck(d.update(dict(mods or {}))), outdir=str(tmp), quiet=True,
                      device="cpu")


def _weights(sim):
    p = sim.state.particles
    return float(p.weight.double()[p.alive].sum())


def _tally_energy(sim):
    dv = sim.mesh.block_volume.double()[:, None, None, None]
    return float((sim.state.fields.energy_tally.double() * dv).sum())


def _binomial(k_a, k_b, n, what):
    p = 0.5 * (k_a + k_b) / n
    sd = np.sqrt(2.0 * n * p * (1.0 - p))
    assert abs(k_a - k_b) <= N_SIGMA * sd + 1, (what, k_a, k_b, sd)


def _bf16(t):
    return torch.from_numpy(np.asarray(jnp.asarray(t.numpy()).astype(jnp.bfloat16)
                                       .astype(jnp.float32)))


def _stats_match(tout, jout, tmesh, jmesh, ndim):
    for axis in range(ndim):
        gt = tout.global_position(tmesh)[axis].double().numpy()[tout.alive.numpy()]
        gj = np.asarray(jout.global_position(jmesh)[axis], np.float64)[np.asarray(jout.alive)]
        assert abs(gt.mean() - gj.mean()) < MEAN_ATOL, axis
        assert abs(gt.std() - gj.std()) / gj.std() < STD_RTOL, axis


# ------------------------------------------------- one round against the JAX kernels


def test_k3s_round_matches_jax_make_spatial_grid():
    """K3s: shard 1 of 2 of an 8^3 mesh in 4^3 blocks (z cells [4, 8), periodic y
    and z, so crossings of the z seam pause wrapped), 4096 particles on its slab,
    sigma_t = 64 with p_abs = 1/4; one round of the port's owned-range census
    against ``make_spatial_grid`` in interpret mode."""
    per = {f"parthenon/swarm/{s}x{k}_bc": "periodic" for s in "io" for k in "23"}
    mods = {**{f"parthenon/mesh/nx{k}": 8 for k in "123"},
            **{f"parthenon/meshblock/nx{k}": 4 for k in "123"}, **per,
            "mcblock/opacity_model": "constant", "jaybenne/dt": "1.e-11"}
    jcfg = jcm.from_deck(JDeck.parse(DECK).update(mods))
    tcfg = tcm.from_deck(TDeck.parse(DECK).update(mods))
    jmesh, tmesh = jbuild_mesh(jcfg.mesh), tbuild_mesh(tcfg.mesh)
    jprm, tprm = jparams(jcfg, jnp.float32), tparams(tcfg, torch.float32)
    assert pg.supports_spatial(jmesh, jprm, 2)
    own = spatial.owned_range(tmesh, tprm, 2, 1)
    assert own == transport_kernel.OwnedRange("z", 4, 4)
    cap = pg.BTILE
    p = uniform_ledger(tmesh, cap, torch.Generator().manual_seed(31), C)
    p.block.copy_(p.block % 4 + 4)  # onto the shard's z-plane of blocks
    d = bridge.state_to_numpy(p)
    nc = 4 * tmesh.ncells_per_block
    tc = TransportCoefs(sigma_a=torch.full((nc,), 16.0), sigma_s=torch.full((nc,), 48.0),
                        fleck=torch.ones(nc))
    jc = jT.TransportCoefs(sigma_a=jnp.full((nc,), 16.0), sigma_s=jnp.full((nc,), 48.0),
                           fleck=jnp.ones((nc,)), px=None, py=None, pz=None)
    build, round_fn = pg.make_spatial_grid(jmesh, jprm, 2, cap, interpret=True)
    jl = JLedger(**{k: jnp.asarray(v) for k, v in d.items()})
    jout, _, jev = round_fn(jl, build(jc, 1), KEY, 0, jnp.float32(tcfg.jaybenne.dt))
    tout, _, tev = transport_kernel.transport(bridge.state_from_numpy(d), tc, tmesh, KSEED,
                                              tprm, tcfg.jaybenne.dt, own)
    _stats_match(tout, jout, tmesh, jmesh, 3)
    assert abs(int(tev) - int(jev)) / int(jev) < EVENTS_RTOL
    paused = [int((q.alive & (q.tau < 1.0)).sum()) for q in (tout, bridge.state_from_numpy(
        {f.name: np.asarray(getattr(jout, f.name)) for f in dataclasses.fields(jout)}))]
    assert paused[0] > 0.02 * cap
    _binomial(paused[0], paused[1], cap, "paused")
    _binomial(int(tout.absorbed.sum()), int(np.asarray(jout.absorbed).sum()), cap, "absorbed")
    gk = (tout.block // 4) * 4 + tout.k
    short = tout.alive & (tout.tau < 1.0)
    assert not bool((short & (gk >= 4)).any())  # every paused lane left z cells [4, 8)
    assert bool((short & (gk < 2)).any())  # some across the periodic seam


def _smr_hybrid(tmesh, tcfg):
    """Thin (sigma_s = 16) and thick (512) x-slabs two coarse cells wide on the
    32x16 forest: coarse thick cells leak into finer blocks."""
    xc = tmesh.cell_centers()[0]
    thick = torch.floor((xc + 0.5) / 0.0625).long() % 2 == 1
    sig = torch.where(thick, 512.0, 16.0)
    faces = tfleck.ddmc_face_probs(tmesh, sig, 5.0, tcfg.mesh.periodic_flags, torch.float32)
    return sig, tuple(_bf16(f) for f in faces)


def test_k4s_round_matches_jax_make_spatial_transport(monkeypatch):
    """K4s with DDMC: shard 0 of 2 of the 32x16 forest in 8x8 blocks (the coarse
    blocks, whose thick cells leak into shard 1's finer blocks), 4096 particles in
    its blocks; one round of the port's owned-range census against
    ``make_spatial_transport`` in interpret mode, pending-leak codes into the other
    shard's blocks counted."""
    monkeypatch.setattr(pb, "REGION_CELLS_IMC", 1024)
    monkeypatch.setattr(pb, "REGION_CELLS_DDMC", 1024)
    mods = {**SMR_FOREST, "jaybenne/tau_ddmc": 5.0, "jaybenne/dt": "3.e-11"}
    path = os.path.join(INPUTS, "stepdiff_smr_ddmc.in")
    jcfg = jcm.from_deck(JDeck.from_file(path).update(mods))
    tcfg = tcm.from_deck(TDeck.from_file(path).update(mods))
    jmesh, tmesh = jbuild_mesh(jcfg.mesh), tbuild_mesh(tcfg.mesh)
    jprm, tprm = jparams(jcfg, jnp.float32), tparams(tcfg, torch.float32)
    assert pb.supports_spatial(jmesh, jprm, 2) and tmesh.max_level == 1
    own = spatial.owned_range(tmesh, tprm, 2, 0)
    assert own == transport_kernel.OwnedRange("blocks", 0, 10)
    sig, faces = _smr_hybrid(tmesh, tcfg)
    ncpb = tmesh.ncells_per_block
    loc = sig.reshape(-1)[:10 * ncpb]
    lf = [f[:10] for f in faces]
    tc = TransportCoefs(sigma_a=torch.zeros_like(loc), sigma_s=loc, fleck=torch.ones_like(loc),
                        px=lf[0], py=lf[1], pz=lf[2])
    jc = jT.TransportCoefs(sigma_a=jnp.zeros(loc.shape), sigma_s=jnp.asarray(loc.numpy()),
                           fleck=jnp.ones(loc.shape),
                           **{k: jnp.asarray(f.numpy()) for k, f in zip(("px", "py", "pz"), lf)})
    cap = 2 * pb.BTILE
    d = bridge.state_to_numpy(forest_ledger(tmesh, cap, torch.Generator().manual_seed(41), C,
                                            blocks=(0, 10)))
    build, round_fn = pb.make_spatial_transport(jmesh, jprm, 2, cap, interpret=True)
    jl = JLedger(**{k: jnp.asarray(v) for k, v in d.items()})
    jout, _, jev = round_fn(jl, build(jc, 0), KEY, 0, jnp.float32(tcfg.jaybenne.dt))
    tout, _, tev = transport_kernel.transport(bridge.state_from_numpy(d), tc, tmesh, KSEED,
                                              tprm, tcfg.jaybenne.dt, own)
    _stats_match(tout, jout, tmesh, jmesh, 2)
    assert abs(int(tev) - int(jev)) / int(jev) < EVENTS_RTOL
    # the JAX kernel pauses every coarse-to-fine leak with its code, the local ones
    # too (its host resamples those between rounds); the port resamples a local one
    # in the kernel and pauses only those into another shard's blocks
    jleak, jblk = np.asarray(jout.leak), np.asarray(jout.block)
    jlocal = (jleak != 0) & (jblk < 10)
    jpaused = np.asarray(jout.alive) & (np.asarray(jout.tau) < 1.0) & ~jlocal
    counts = {"paused": (int((tout.alive & (tout.tau < 1.0)).sum()), int(jpaused.sum())),
              "leak": (int((tout.leak != 0).sum()), int(((jleak != 0) & ~jlocal).sum()))}
    assert counts["leak"][0] > 0 and counts["paused"][0] > counts["leak"][0], counts
    for what, (a, b) in counts.items():
        _binomial(a, b, cap, what)
    pend = tout.leak != 0  # each a paused lane in a finer block of the other shard
    assert bool((tout.block[pend] >= 10).all())
    assert bool((tmesh.block_level[tout.block[pend].long()] == 1).all())
    assert bool((tout.alive & (tout.tau < 1.0))[pend].all())


# --------------------------------------------- the whole mesh as the owned range


@pytest.mark.parametrize("case", ["uniform_3d", "forest_2d_ddmc"])
def test_whole_mesh_range_is_todays_census_bitwise(case):
    """Offset 0 with every block (z0 = 0 with every z cell) runs today's census:
    every column bitwise equal, draw for draw, and the same events."""
    if case == "uniform_3d":
        mods = {**{f"parthenon/mesh/nx{k}": 8 for k in "123"},
                **{f"parthenon/meshblock/nx{k}": 4 for k in "123"},
                "mcblock/opacity_model": "constant"}
        cfg = tcm.from_deck(TDeck.parse(DECK).update(mods))
        mesh = tbuild_mesh(cfg.mesh)
        nc = mesh.total_cells
        coefs = TransportCoefs(sigma_a=torch.full((nc,), 16.0), sigma_s=torch.full((nc,), 48.0),
                               fleck=torch.ones(nc))
        p0 = uniform_ledger(mesh, 3000, torch.Generator().manual_seed(3), C)
    else:
        path = os.path.join(INPUTS, "stepdiff_smr_ddmc.in")
        cfg = tcm.from_deck(TDeck.from_file(path).update({**SMR_FOREST, "jaybenne/tau_ddmc": 5.0,
                                                           "jaybenne/dt": "1.e-12"}))
        mesh = tbuild_mesh(cfg.mesh)
        sig, faces = _smr_hybrid(mesh, cfg)
        coefs = TransportCoefs(sigma_a=torch.zeros(mesh.total_cells), sigma_s=sig.reshape(-1),
                               fleck=torch.ones(mesh.total_cells), px=faces[0], py=faces[1],
                               pz=faces[2])
        p0 = forest_ledger(mesh, 3000, torch.Generator().manual_seed(3), C)
    prm = tparams(cfg, torch.float32)
    own = transport_kernel.whole_mesh(mesh)
    a, it_a, ev_a = transport_kernel.transport_plain(p0.clone(), coefs, mesh, 99, prm,
                                                     cfg.jaybenne.dt)
    b, it_b, ev_b = transport_kernel.transport_plain(p0.clone(), coefs, mesh, 99, prm,
                                                     cfg.jaybenne.dt, own)
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name
    assert int(ev_a) == int(ev_b) and int(it_a) == int(it_b)
    assert not bool((b.alive & (b.tau < 1.0)).any()) and not bool((b.leak != 0).any())


def test_block_range_on_a_uniform_mesh_matches_collapsed_census():
    """A uniform mesh through the block-range (SMR) route, as K4s runs a uniform
    mesh whose shards are not whole z planes, against the collapsed census of the
    same ledger: the same physics (statistically; the two round differently)."""
    mods = {"parthenon/mesh/nx1": 32, "parthenon/meshblock/nx1": 2}
    cfg = tcm.from_deck(TDeck.parse(DECK).update(mods))
    mesh = tbuild_mesh(cfg.mesh)
    prm = tparams(cfg, torch.float32)
    nc = mesh.total_cells
    coefs = TransportCoefs(sigma_a=torch.zeros(nc), sigma_s=torch.full((nc,), 200.0),
                           fleck=torch.ones(nc))
    p0 = uniform_ledger(mesh, 4000, torch.Generator().manual_seed(8), C)
    own = transport_kernel.OwnedRange("blocks", 0, mesh.n_blocks)
    a, _, ev_a = transport_kernel.transport_plain(p0.clone(), coefs, mesh, 5, prm,
                                                  cfg.jaybenne.dt)
    b, _, ev_b = transport_kernel.transport_plain(p0.clone(), coefs, mesh, 6, prm,
                                                  cfg.jaybenne.dt, own)
    assert not bool((b.tau[b.alive] < 1.0).any()) and int(b.alive.sum()) == 4000
    xa, xb = (q.global_position(mesh)[0].double() for q in (a, b))
    assert abs(float(xa.mean() - xb.mean())) < MEAN_ATOL
    assert abs(float(xa.std() / xb.std()) - 1.0) < STD_RTOL
    assert abs(int(ev_a) - int(ev_b)) / int(ev_a) < EVENTS_RTOL


# ----------------------------------------------------- the face probabilities


@pytest.mark.parametrize("forest", ["uniform_2d", "refined_2d"])
@pytest.mark.parametrize("n", [2, 8])
def test_face_probs_spatial_bitwise(forest, n):
    """``ddmc_face_probs_spatial`` from a shard's own sigma_t and every block's
    all-gathered boundary surface is bitwise ``ddmc_face_probs`` of the whole
    mesh restricted to the shard's blocks (zeros in padding blocks), and equal to
    the JAX package's ``ddmc_face_probs_spatial`` (tests/test_spatial.py:289)."""
    path = os.path.join(INPUTS, "stepdiff_smr_ddmc.in")
    mods = dict(SMR_FOREST)
    if forest == "uniform_2d":
        mods["parthenon/mesh/refinement"] = "none"
    tcfg = tcm.from_deck(TDeck.from_file(path).update(mods))
    jcfg = jcm.from_deck(JDeck.from_file(path).update(mods))
    mesh, jmesh = tbuild_mesh(tcfg.mesh), jbuild_mesh(jcfg.mesh)
    assert (mesh.max_level > 0) == (forest == "refined_2d")
    B, bl = mesh.n_blocks, spatial.blocks_per_shard(mesh, n)
    g = torch.Generator().manual_seed(n)
    sig = 1.0e2 * (1.0 + torch.rand((B, mesh.nz, mesh.ny, mesh.nx), generator=g))
    tau, periodic = tcfg.jaybenne.tau_ddmc, tcfg.mesh.periodic_flags
    full = tfleck.ddmc_face_probs(mesh, sig, tau, periodic, torch.float32)
    pad = torch.cat([sig, torch.ones((n * bl - B,) + sig.shape[1:])])
    ex = exchange.InProcess(n)
    surf = ex.all_gather([tfleck.pack_boundary_surface(mesh, pad[s * bl:(s + 1) * bl])
                          for s in range(n)])
    assert surf[0].shape[1] < mesh.ncells_per_block
    jsurf = jfleck.pack_boundary_surface(jmesh, jnp.asarray(pad.numpy()))
    for s in range(n):
        lo, real = s * bl, max(0, min(bl, B - s * bl))
        loc = tfleck.ddmc_face_probs_spatial(mesh, pad[lo:lo + bl], surf[s], lo, tau, periodic,
                                             torch.float32)
        jloc = jfleck.ddmc_face_probs_spatial(jmesh, jnp.asarray(pad[lo:lo + bl].numpy()),
                                              jsurf, lo, tau, periodic, jnp.float32)
        for a, (got, want, jw) in enumerate(zip(loc, full, jloc)):
            assert torch.equal(got[:real], want[lo:lo + real]), (s, a)
            assert not bool(got[real:].any())
            np.testing.assert_allclose(got[:real].numpy(), np.asarray(jw)[:real],
                                       rtol=PROB_RTOL, err_msg=str((s, a)))


# --------------------------------------------- the fixup of migrated arrivals


def test_subface_resample_matches_jax_on_the_same_draws():
    """Pending coarse-to-fine leaks on the 32x16 forest, resampled by the owner of
    the fine blocks (shard 1 of 2, blocks [10, 20)): the port's
    ``subface_resample`` against the JAX ``_ddmc_subface_resample`` given the same
    five uniforms per slot. The chosen fine faces agree exactly, positions and
    directions to FIX_RTOL, and the codes are cleared."""
    path = os.path.join(INPUTS, "stepdiff_smr_ddmc.in")
    mods = {**SMR_FOREST, "jaybenne/tau_ddmc": 5.0}
    tcfg = tcm.from_deck(TDeck.from_file(path).update(mods))
    jcfg = jcm.from_deck(JDeck.from_file(path).update(mods))
    mesh, jmesh = tbuild_mesh(tcfg.mesh), jbuild_mesh(jcfg.mesh)
    prm = tparams(tcfg, torch.float32)
    sig, faces = _smr_hybrid(mesh, tcfg)
    lf = [f[10:20] for f in faces]
    # leaks out of coarse block 2 ([-0.5, -0.25) x [0, 0.25)) in +x land on the
    # transverse centre of their coarse cell, on the edge of two fine faces of
    # block 12 (its lower x face)
    n = 512
    gen = torch.Generator().manual_seed(17)
    p = empty_ledger(n)
    p.block.fill_(12)
    p.j.copy_(torch.randint(0, 4, (n,), generator=gen, dtype=torch.int32) * 2 + 1)
    dy = float(mesh.block_dx[12, 1])
    p.y.copy_(p.j.float() * dy)  # the coarse centre: a fine edge
    p.x.fill_(0.01 * float(mesh.block_dx[12, 0]))
    p.vx.fill_(C)
    p.alive.fill_(True)
    p.weight.fill_(1.0)
    p.leak.fill_(1)
    p.leak[n // 2:] = 0  # half carry no pending code and stay as they are
    before = p.clone()
    transport_kernel.subface_resample(p, lf, mesh, prm.c,
                                      rng.generator(5, 0, rng.PHASE_FIXUP, "cpu", (1, 0)), 10, 10)
    u = rng.uniform(rng.generator(5, 0, rng.PHASE_FIXUP, "cpu", (1, 0)), (5, n), torch.float32,
                    "cpu").numpy()
    mu = np.sqrt(u[3])
    nu = np.sqrt(np.maximum(1.0 - mu * mu, 0.0))
    phi = 2.0 * np.pi * u[4]
    draws = tuple(jnp.asarray(v, jnp.float32) for v in
                  (u[0], u[1], u[2], mu, nu * np.cos(phi), nu * np.sin(phi)))
    jc = jT.TransportCoefs(sigma_a=None, sigma_s=None, fleck=None,
                           **{k: jnp.asarray(f.numpy()) for k, f in zip(("px", "py", "pz"), lf)})
    jprm = jparams(jcfg, jnp.float32)
    b = before
    need = jnp.asarray((b.leak != 0).numpy())
    col = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    out = jT._ddmc_subface_resample(
        jmesh, jc, jprm, draws, need, col(b.leak), col(b.block - 10),
        jnp.asarray(mesh.block_dx[b.block.long()].numpy()),
        col(b.x), col(b.y), col(b.z), col(b.vx), col(b.vy), col(b.vz), col(b.i), col(b.j),
        col(b.k))
    names = ("x", "y", "z", "vx", "vy", "vz", "i", "j", "k")
    for name, want in zip(names, out):
        got = getattr(p, name).numpy()
        if name in ("i", "j", "k"):
            np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)
        else:
            np.testing.assert_allclose(got, np.asarray(want), rtol=FIX_RTOL,
                                       atol=1e-6 * (C if name[0] == "v" else 1.0), err_msg=name)
    moved = p.j != before.j
    assert bool(moved[: n // 2].any()) and not bool(moved[n // 2:].any())
    assert not bool((p.leak != 0).any())
    assert bool((p.vx[: n // 2] > 0).all())  # into the block, along +x


# ------------------------------------------------------------------- migrate


def test_migrate_conserves_reserves_and_orders():
    """Three shards of two blocks each: every live particle is conserved (sent =
    received + in transit), absorbed rows are never overwritten, sends past K stay
    in transit, and arrivals are inserted in source-shard order."""
    n, bl, cap, K = 3, 2, 40, 4
    ledgers = []
    for s in range(n):
        p = empty_ledger(cap)
        p.alive[:12] = True
        p.block[:12] = torch.tensor([0, 1, 2, 3, 4, 5] * 2, dtype=torch.int32)
        p.x[:12] = torch.arange(12, dtype=torch.float32) + 100.0 * s  # tags the source
        p.absorbed[30:33] = True  # this step's absorbed rows, still carrying weight
        p.weight[30:33] = 7.0
        ledgers.append(p)
    live0 = sum(int(p.alive.sum()) for p in ledgers)
    dropped, sent = spatial.migrate(ledgers, [s * bl for s in range(n)], bl, K,
                                    exchange.InProcess(n))
    live1 = sum(int(p.alive.sum()) for p in ledgers)
    assert live1 == live0 and all(int(d) == 0 for d in dropped)
    assert [int(v) for v in sent] == [8, 8, 8]  # 4 to each other shard, within K
    for s, p in enumerate(ledgers):
        own = (p.block >= s * bl) & (p.block < (s + 1) * bl)
        assert bool(own[p.alive].all())  # everyone home
        assert bool(p.absorbed[30:33].all()) and bool((p.weight[30:33] == 7.0).all())
        assert not bool(p.alive[30:33].any())
        src = (p.x[p.alive] // 100.0).long()  # in slot order
        arrived = src[src != s]
        assert torch.equal(arrived, torch.sort(arrived, stable=True).values)  # by source shard
        assert sorted(set(arrived.tolist())) == [q for q in range(n) if q != s]
    # K = 1: one particle a destination goes, the rest stay in transit
    for p in ledgers:
        p.block[:12] = torch.tensor([0, 1, 2, 3, 4, 5] * 2, dtype=torch.int32)
        p.alive[:] = False
        p.alive[:12] = True
    _, sent = spatial.migrate(ledgers, [s * bl for s in range(n)], bl, 1, exchange.InProcess(n))
    assert [int(v) for v in sent] == [2, 2, 2]
    for s, p in enumerate(ledgers):
        transit = p.alive & ((p.block < s * bl) | (p.block >= (s + 1) * bl))
        assert int(transit.sum()) == 6
    assert sum(int(p.alive.sum()) for p in ledgers) == 36


# ------------------------------------------------- ports of tests/test_spatial.py


def test_spatial_two_shards_conserve_and_migrate(tmp_path):
    """tests/test_spatial.py:69: exact weight conservation, particles on both
    shards' blocks, a tally holding the weights, migration observed."""
    sim = _sim(tmp=tmp_path)
    w0 = _weights(sim)
    sim.run()
    w1 = _weights(sim)
    p = sim.state.particles
    assert abs(w1 - w0) <= ENERGY_RTOL * w0 and sim.state.overflow == 0
    blocks = p.block[p.alive]
    assert bool((blocks < 1).any()) and bool((blocks >= 1).any())
    assert abs(_tally_energy(sim) - w0) <= 1e-4 * w0
    h = sim.history[-1]
    assert h["migration_rounds"] >= 1 and h["migrated"] > 0 and h["unfinished"] == 0


def test_census_round_budget_interleaves(tmp_path):
    """tests/test_spatial.py:94 on the plain census (use_pallas = off, where the
    budget applies): the same physics at budgets 0, 64 and 16, and fewer
    iterations with a binding budget without many more rounds."""
    totals = {}
    for budget in (0, 64, 16):
        sim = _sim({"jaybenne/census_iters_per_round": budget, "jaybenne/use_pallas": "off"},
                   tmp=tmp_path)
        w0 = _weights(sim)
        sim.run()
        assert abs(_weights(sim) - w0) <= ENERGY_RTOL * w0, budget
        totals[budget] = {"iters": sum(h["iterations"] for h in sim.history),
                          "rounds": sum(h["migration_rounds"] for h in sim.history),
                          "tally": _tally_energy(sim)}
    for b in (64, 16):
        assert abs(totals[b]["tally"] - totals[0]["tally"]) / totals[0]["tally"] < 1e-4, b
    assert totals[64]["iters"] < 0.95 * totals[0]["iters"], totals
    assert totals[16]["iters"] < 0.60 * totals[0]["iters"], totals
    assert totals[16]["rounds"] <= 2 * totals[0]["rounds"], totals


def test_spatial_eight_shards_match_single(tmp_path):
    """tests/test_spatial.py:143 (its default-suite size: 32 cells in 4-cell blocks,
    8 shards, 8000 particles, 2 steps): the tally agrees with one device's within
    MC noise, energy conserved exactly."""
    mods = {"parthenon/mesh/nx1": 32, "jaybenne/num_particles": 8000,
            "jaybenne/n_devices": 8}
    s8 = _sim(mods, tmp=tmp_path)
    s1 = _sim({**mods, "jaybenne/n_devices": 1, "jaybenne/decomposition": "particle"},
              tmp=tmp_path)
    for s in (s1, s8):
        w0 = _weights(s)
        s.run()
        assert abs(_weights(s) - w0) <= ENERGY_RTOL * w0
    t1, t8 = (s.state.fields.energy_tally.double().reshape(-1) for s in (s1, s8))
    err = float((t1 - t8).abs().sum() / (t1 + t8).sum())
    assert err < 0.08, err
    assert s8.history[-1]["migrated"] > 0


def test_spatial_single_shard(tmp_path):
    """tests/test_spatial.py:202: decomposition = spatial at one shard runs its
    rounds (one, with nothing to migrate) and conserves energy; it holds every
    field whole."""
    sim = _sim({"parthenon/mesh/nx1": 16, "jaybenne/n_devices": 1,
                "parthenon/time/tlim": "1.e-11"}, tmp=tmp_path)
    assert len(sim.shards) == 1 and sim.shards[0].fields.rho.shape[0] == sim.mesh.n_blocks
    w0 = _weights(sim)
    sim.run()
    assert abs(_weights(sim) - w0) <= ENERGY_RTOL * w0
    assert sim.history[-1]["migration_rounds"] == 1 and sim.history[-1]["migrated"] == 0


def test_spatial_matches_particle_mode(tmp_path):
    """tests/test_spatial.py:224: the spatial and the particle decomposition of
    the same problem agree on the tally's centre of mass, spread and total."""
    mods = {"parthenon/mesh/nx1": 16, "parthenon/time/tlim": "1.e-11",
            "jaybenne/num_particles": 8000}
    out = {}
    for decomp in ("spatial", "particle"):
        sim = _sim({**mods, "jaybenne/decomposition": decomp}, tmp=tmp_path)
        sim.run()
        t = sim.state.fields.energy_tally.double().reshape(-1)
        x = sim.mesh.cell_centers()[0].double().reshape(-1)
        com = float((t * x).sum() / t.sum())
        out[decomp] = (com, float(np.sqrt(((t * (x - com) ** 2).sum() / t.sum()))),
                       float(t.sum()))
    (cs, ss, ts), (cp, sp, tp) = out["spatial"], out["particle"]
    assert abs(cs - cp) < 0.02 and abs(ss - sp) / sp < 0.1
    assert abs(ts - tp) / tp < 1e-4


@pytest.mark.parametrize("grid", [False, True])
def test_spatial_nongray_per_event(grid, tmp_path):
    """tests/test_spatial.py:343 (the block route, a 1D slab) and :404 (the z-slab
    route, 8^3 in 4^3 blocks): EPBremss per event in the spatial rounds; w_live +
    absorbed = w0, the survivors harden; on the slab the kernel route and the
    plain census with its iteration budget agree on the survivors."""
    ep = {"parthenon/time/tlim": "1.e-12", "jaybenne/dt": "1.e-12",
          "mcblock/opacity_model": "ep_bremss", "mcblock/initial_temperature": "1.0e6",
          "mcblock/cv": "1.0e8", "mcblock/scattering_constant_value": "1.0e2"}
    if grid:
        ep.update({**{f"parthenon/mesh/nx{k}": 8 for k in "123"},
                   **{f"parthenon/meshblock/nx{k}": 4 for k in "123"},
                   "jaybenne/num_particles": 2000})
        modes = ("auto",)
    else:
        ep.update({"parthenon/mesh/nx1": 16, "jaybenne/num_particles": 4000})
        modes = ("auto", "off")
    surv = {}
    for mode in modes:
        sim = _sim({**ep, "jaybenne/use_pallas": mode}, tmp=tmp_path)
        own = spatial.owned_range(sim.mesh, tparams(sim.cfg, torch.float32), 2, 0)
        assert own.kind == ("z" if grid else "blocks")
        p0 = sim.state.particles.clone()
        w0 = float(p0.weight.double()[p0.alive].sum())
        sim.run()
        p = sim.state.particles
        w_live = float(p.weight.double()[p.alive].sum())
        absorbed = float(sim.state.fields.energy_delta.double().sum())
        assert absorbed > 0 and abs(w_live + absorbed - w0) <= ABSORB_RTOL * w0, mode
        assert float(p.energy[p.alive].mean()) > float(p0.energy[p0.alive].mean())
        surv[mode] = int(p.alive.sum())
    if not grid:
        a, b = surv["auto"], surv["off"]
        assert abs(a - b) < 4.0 * np.sqrt(a + b), surv


def test_spatial_smr_ddmc_kernel_route_matches_plain_loop(tmp_path):
    """tests/test_spatial.py:455: spatial + SMR + DDMC at 2 shards through the
    owned-range route (pending-leak pause and fixup) against the plain census
    with its iteration budget: the tally holds the live weights in each, and the
    two agree to MC noise (the JAX test allows 0.2 at 24k particles)."""
    mods = {**SMR_FOREST, "jaybenne/num_particles": 6000, "jaybenne/dt": "1.e-11",
            "parthenon/time/tlim": "1.e-11", "jaybenne/decomposition": "spatial",
            "jaybenne/n_devices": 2, "parthenon/output0/file_type": "none"}
    prof = {}
    for mode in ("auto", "off"):
        sim = _sim({**mods, "jaybenne/use_pallas": mode},
                   path=os.path.join(INPUTS, "stepdiff_smr_ddmc.in"), tmp=tmp_path)
        assert sim.mesh.max_level > 0
        sim.run()
        w = _weights(sim)
        assert abs(_tally_energy(sim) - w) <= ENERGY_RTOL * w, mode
        prof[mode] = sim.state.fields.energy_tally.double().reshape(-1)
    s = prof["auto"] + prof["off"]
    err = float((prof["auto"] - prof["off"]).abs()[s > 0].sum() / s[s > 0].sum())
    assert err < 0.2, err


def test_spatial_fields_sharded_per_shard(tmp_path):
    """tests/test_spatial.py:522: each shard holds its [B/n, ...] slice of every
    field; the particle decomposition keeps them whole."""
    sim = _sim(tmp=tmp_path)
    assert len(sim.shards) == 2
    for st in sim.shards:
        for name in ("rho", "sie", "u", "energy_tally"):
            assert getattr(st.fields, name).shape[0] == sim.mesh.n_blocks // 2, name
    assert sim.state.fields.rho.shape[0] == sim.mesh.n_blocks
    simp = _sim({"jaybenne/decomposition": "particle"}, tmp=tmp_path)
    assert simp.shards[0].fields.rho.shape == simp.state.fields.rho.shape


def test_spatial_smr_ddmc_eight_shards(tmp_path):
    """tests/test_spatial.py:546 at a CPU size (12k particles, one step): 8 shards
    of the 20-block forest (the last owns one padding block) with sharded fields,
    cross-shard DDMC fixups and migration: the tally holds the live weights, no
    pending leak is left, and each block's energy agrees with one device's."""
    mods = {**SMR_FOREST, "jaybenne/num_particles": 12000, "jaybenne/dt": "1.e-11",
            "parthenon/time/tlim": "1.e-11", "parthenon/output0/file_type": "none"}
    path = os.path.join(INPUTS, "stepdiff_smr_ddmc.in")
    tallies = {}
    for n in (8, 1):
        sim = _sim({**mods, "jaybenne/n_devices": n,
                    "jaybenne/decomposition": "spatial" if n > 1 else "particle"},
                   path=path, tmp=tmp_path)
        sim.run()
        w = _weights(sim)
        assert abs(_tally_energy(sim) - w) <= ENERGY_RTOL * w, n
        p = sim.state.particles
        assert not bool((p.alive & (p.leak != 0)).any())
        dv = sim.mesh.block_volume.double()[:, None, None, None]
        tallies[n] = (sim.state.fields.energy_tally.double() * dv).sum(dim=(1, 2, 3))
    s = tallies[1] + tallies[8]
    err = float((tallies[1] - tallies[8]).abs()[s > 0].sum() / s[s > 0].sum())
    assert err < SMR8_TOL, err


# ------------------------------------------- one census call a round over every shard

# a spatial step of each census route: the z-slab route (8^3 in 4^3 blocks, 2
# shards of two z planes of blocks) and the block route (the SMR DDMC forest at 4
# shards, pending leaks between them); one step each
ROUND_CASES = {
    "z": (None, {**{f"parthenon/mesh/nx{k}": 8 for k in "123"},
                 **{f"parthenon/meshblock/nx{k}": 4 for k in "123"},
                 "mcblock/opacity_model": "constant", "jaybenne/num_particles": 2000,
                 "parthenon/time/tlim": "1.e-11"}),
    "blocks": ("stepdiff_smr_ddmc.in",
               {**SMR_FOREST, "jaybenne/num_particles": 2000, "jaybenne/dt": "1.e-11",
                "parthenon/time/tlim": "1.e-11", "jaybenne/decomposition": "spatial",
                "jaybenne/n_devices": 4, "parthenon/output0/file_type": "none"}),
}


def _per_shard_census(monkeypatch):
    """Make the spatial steps built from here on run each round as the per-shard
    loop, one census call per shard with that shard's own coefficients and owned
    range: ``prepare`` is wrapped to keep what each set-up was built from."""
    built = {}
    real_prepare = transport_kernel.prepare

    def prepare(coefs, mesh, prm, dt, own=None):
        setup = real_prepare(coefs, mesh, prm, dt, own)
        if isinstance(own, list):  # the step's set-up, not a per-shard call's
            built[id(setup)] = (coefs, own)
        return setup

    def per_shard(ps, setup, mesh, seeds, prm, dt, go=None):
        coefs, owns = built[id(setup)]
        its, evs = [], []
        for p, c, seed, own in zip(ps, coefs, seeds, owns):
            _, it, ev = transport_kernel.transport(p, c, mesh, seed, prm, dt, own, go=go)
            its.append(it)
            evs.append(ev)
        return ps, torch.stack(its), torch.stack(evs)

    monkeypatch.setattr(transport_kernel, "prepare", prepare)
    monkeypatch.setattr(spatial, "census_fn", lambda cfg: per_shard)


@pytest.mark.parametrize("route", sorted(ROUND_CASES))
def test_one_call_round_is_the_per_shard_loop(route, monkeypatch, tmp_path):
    """A spatial step whose rounds make one census call over every local shard
    against the same step with the per-shard loop written here: fields, the
    history (StepStats, migration rounds, migrated) and every ledger column
    bitwise."""
    path, mods = ROUND_CASES[route]
    path = path and os.path.join(INPUTS, path)
    one = _sim(mods, path=path, tmp=tmp_path)
    assert spatial.owned_range(one.mesh, tparams(one.cfg, torch.float32), one.exchange.n,
                               0).kind == route
    one.run()
    _per_shard_census(monkeypatch)
    loop = _sim(mods, path=path, tmp=tmp_path)
    loop.run()
    for h1, h2 in zip(one.history, loop.history, strict=True):
        assert {k: v for k, v in h1.items() if k != "step_seconds"} == \
            {k: v for k, v in h2.items() if k != "step_seconds"}
    assert one.history[-1]["migration_rounds"] > 1 and one.history[-1]["migrated"] > 0
    f1, f2 = one.state.fields, loop.state.fields
    for f in dataclasses.fields(f1):
        a, b = getattr(f1, f.name), getattr(f2, f.name)
        assert (a is None and b is None) or torch.equal(a, b), f.name
    p1, p2 = one.state.particles, loop.state.particles
    for f in dataclasses.fields(p1):
        assert torch.equal(getattr(p1, f.name), getattr(p2, f.name)), f.name


def test_census_tables_built_once_a_step(monkeypatch, tmp_path):
    """The census tables are built once a step, not once per shard per round:
    ``_tables`` counted over two steps of 2 shards with several rounds each."""
    calls = []
    real = transport_kernel._tables
    monkeypatch.setattr(transport_kernel, "_tables",
                        lambda *args: calls.append(1) or real(*args))
    sim = _sim(tmp=tmp_path)
    sim.run()
    rounds = [h["migration_rounds"] for h in sim.history]
    assert len(rounds) == 2 and min(rounds) > 1
    assert len(calls) == len(rounds)


# ------------------------------------------------- the slice end to end against JAX


def test_spatial_slice_matches_jax(tmp_path):
    """The same 2-shard spatial deck (16 cells in 4-cell blocks, 8000 particles,
    one step) through the JAX package's driver (8 virtual CPU devices, its plain
    loop) and the port's: each conserves the weights in its tally, and the two
    agree on the tally's centre of mass, spread and total."""
    mods = {"parthenon/mesh/nx1": 16, "parthenon/time/tlim": "1.e-11",
            "jaybenne/num_particles": 8000}
    jsim = JSimulation(jcm.from_deck(JDeck.parse(DECK).update(
        {**mods, "jaybenne/use_pallas": "off"})), outdir=str(tmp_path / "j"), quiet=True)
    tsim = _sim(mods, tmp=tmp_path / "t")
    jsim.run()
    tsim.run()
    out = []
    for sim in (jsim, tsim):
        t = np.asarray(sim.state.fields.energy_tally, np.float64)[: sim.mesh.n_blocks]
        x = np.asarray(sim.mesh.cell_centers()[0], np.float64)
        dv = np.asarray(sim.mesh.block_volume, np.float64)[:, None, None, None]
        p = sim.state.particles
        w = float(np.asarray(p.weight, np.float64)[np.asarray(p.alive)].sum())
        assert abs(float((t * dv).sum()) - w) <= ENERGY_RTOL * w
        com = float((t * x).sum() / t.sum())
        out.append((com, float(np.sqrt((t * (x - com) ** 2).sum() / t.sum())), float(t.sum())))
    (cj, sj, tj), (ct, st, tt) = out
    assert abs(cj - ct) < 0.02 and abs(sj - st) / sj < 0.1
    assert abs(tj - tt) / tj < 0.02
    assert tsim.history[-1]["migrated"] > 0
