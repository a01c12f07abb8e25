"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here is marked ``cuda`` and skips without a GPU: a CUDA kernel has no
CPU mode. The file imports no jax, so it also runs on a GPU machine without jax,
where ``tests/conftest.py`` (which imports jax) cannot load:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider
"""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch

from jaybenne_tpu_torch import config as cm
from jaybenne_tpu_torch.driver import run_file
from jaybenne_tpu_torch.mesh import build_mesh
from jaybenne_tpu_torch.ops import cuda_lib, kernel_rng, transport_kernel
from jaybenne_tpu_torch.ops.transport import TransportCoefs
from jaybenne_tpu_torch.ops.fleck import ddmc_face_probs
from jaybenne_tpu_torch.particles import (empty_ledger, forest_ledger, place_on_faces,
                                          uniform_ledger)
from jaybenne_tpu_torch.step import make_transport_params
from jaybenne_tpu_torch.utils.deck import Deck

pytestmark = pytest.mark.cuda

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPDIFF = os.path.join(_ROOT, "inputs", "stepdiff.in")
STEPDIFF_DDMC = os.path.join(_ROOT, "inputs", "stepdiff_ddmc.in")
C = 2.99792458e10
# kernel vs plain: the same float32 operations in the same order (the kernel is
# built without fast math and without FMA contraction)
FLOAT_RTOL = 1e-5
EVENTS_RTOL = 0.02


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _two_block_setup(dev, n=20000, sigma_s=256.0, bc="jaybenne_reflecting"):
    """The stepdiff deck as shipped (two 50-cell blocks) with walls ``bc``, with n
    particles spread over both blocks and 16 flying straight into the walls."""
    cfg = cm.from_deck(Deck.from_file(STEPDIFF).update(
        {"parthenon/swarm/ix1_bc": bc, "parthenon/swarm/ox1_bc": bc}))
    mesh = build_mesh(cfg.mesh, device=dev)
    assert mesh.n_blocks == 2
    prm = make_transport_params(cfg, torch.float32)
    rng = np.random.default_rng(11)
    p = empty_ledger(n + 1000, torch.float32, dev)
    blk = rng.integers(0, 2, n)
    cell = rng.integers(0, 50, n)
    cell[:8], blk[:8] = 0, 0
    cell[8:16], blk[8:16] = 49, 1
    x = (cell + rng.random(n)) * 0.01
    x[:8], x[8:16] = 1e-6, 0.5 - 1e-6
    mu = 1.0 - 2.0 * rng.random(n)
    mu[:8], mu[8:16] = -1.0, 1.0
    for name, v in (("block", blk), ("i", cell), ("x", x), ("vx", C * mu),
                    ("vy", C * np.sqrt(1.0 - mu * mu))):
        getattr(p, name)[:n] = torch.as_tensor(v).to(getattr(p, name).dtype)
    p.alive[:n] = True
    p.weight[:n] = 1.0
    nc = mesh.total_cells
    coefs = TransportCoefs(sigma_a=torch.zeros(nc, device=dev),
                           sigma_s=torch.full((nc,), sigma_s, device=dev),
                           fleck=torch.ones(nc, device=dev))
    return cfg.jaybenne.dt, mesh, prm, p, coefs


def test_raw_bits_kernel_matches_plain(gpu):
    n = 1 << 16
    g = torch.Generator().manual_seed(3)
    lane = torch.randint(0, 1 << 31, (n,), generator=g, dtype=torch.int32)
    it = torch.randint(0, 1 << 31, (n,), generator=g, dtype=torch.int32)
    tag = torch.randint(0, 6, (n,), generator=g, dtype=torch.int32)
    before = cuda_lib.LAUNCHES["raw_bits"]
    for seed in (-5, 0, 349857, -(1 << 31)):
        got = kernel_rng.raw_bits(seed, lane.to(gpu), it.to(gpu), tag.to(gpu)).cpu()
        want = kernel_rng.raw_bits_plain(seed, lane.long(), it.long(), tag.long())
        assert torch.equal(got, want)
    assert cuda_lib.LAUNCHES["raw_bits"] == before + 4


@pytest.mark.parametrize(
    "max_iters, bc",
    [(1, "jaybenne_reflecting"), (8, "jaybenne_reflecting"), (None, "jaybenne_reflecting"),
     (8, "periodic"), (8, "outflow")],
)
def test_census_kernel_matches_plain(gpu, max_iters, bc):
    dt, mesh, prm, p0, coefs = _two_block_setup(gpu, bc=bc)
    if max_iters is not None:
        prm = dataclasses.replace(prm, max_iters=max_iters)
    seed = -777
    k, it_k, ev_k = transport_kernel.transport(p0.clone(), coefs, mesh, seed, prm, dt)
    q, it_q, ev_q = transport_kernel.transport_plain(p0.clone(), coefs, mesh, seed, prm, dt)
    assert ev_k.dtype == torch.int64 and it_k.dtype == torch.int32
    if bc != "outflow":  # no absorption: nobody dies
        assert int(k.alive.sum()) == int(p0.alive.sum())
    if max_iters is None:  # full census: every live slot at tau = 1
        assert not bool((k.tau[k.alive] < 1.0).any())
        assert abs(int(ev_k) - int(ev_q)) <= EVENTS_RTOL * int(ev_q)
        return
    for name in ("i", "block", "alive"):
        assert torch.equal(getattr(k, name), getattr(q, name)), name
    for name in ("x", "vx", "vy", "vz", "tau"):
        torch.testing.assert_close(getattr(k, name), getattr(q, name), rtol=FLOAT_RTOL,
                                   atol=1e-8 if name in ("x", "tau") else 1e-6 * C)
    assert int(ev_k) == int(ev_q) and int(it_k) == int(it_q) == max_iters
    if max_iters == 1:  # the wall-bound particles reflected in their first event
        assert bool((k.vx[:8] > 0).all()) and bool((k.vx[8:16] < 0).all())


def test_census_kernel_rejects_bad_ledgers(gpu):
    dt, mesh, prm, p, coefs = _two_block_setup(gpu, n=100)
    strided = p.clone()
    strided.x = torch.zeros(2 * p.capacity, device=gpu)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        transport_kernel.transport(strided, coefs, mesh, 1, prm, dt)
    wide = p.clone()
    wide.i = wide.i.long()
    with pytest.raises(ValueError, match="int32"):
        transport_kernel.transport(wide, coefs, mesh, 1, prm, dt)
    flags = p.clone()
    flags.absorbed = flags.absorbed.to(torch.uint8)
    with pytest.raises(ValueError, match="bool"):
        transport_kernel.transport(flags, coefs, mesh, 1, prm, dt)
    short = p.clone()
    short.k = short.k[:-1].contiguous()
    with pytest.raises(ValueError, match="length"):
        transport_kernel.transport(short, coefs, mesh, 1, prm, dt)


def _grid_setup(dev, ndim, n=30000, sigma_a=256.0, sigma_s=768.0, seed=5):
    """A uniform multi-block mesh in 2D (32 x 16 cells in 8 x 8 blocks) or 3D (16^3
    in 8^3 blocks), reflecting in x, periodic in y and outflow in z, with n
    particles at uniform positions and isotropic directions. sigma_t = 1024 and
    p_abs = 0.25 by default."""
    cells = {2: (32, 16, 1), 3: (16, 16, 16)}[ndim]
    blocks = {2: (8, 8, 1), 3: (8, 8, 8)}[ndim]
    mods = {"mcblock/opacity_model": "constant", "parthenon/swarm/ix3_bc": "outflow",
            "parthenon/swarm/ox3_bc": "outflow"}
    for a, k in enumerate("123"):
        mods[f"parthenon/mesh/nx{k}"] = cells[a]
        mods[f"parthenon/meshblock/nx{k}"] = blocks[a]
    cfg = cm.from_deck(Deck.from_file(STEPDIFF).update(mods))
    mesh = build_mesh(cfg.mesh, device=dev)
    prm = make_transport_params(cfg, torch.float32)
    assert mesh.ndim == ndim and mesh.n_blocks > 1 and prm.has_absorption
    rng = np.random.default_rng(seed)
    p = empty_ledger(n + 777, torch.float32, dev)
    nloc = (mesh.nx, mesh.ny, mesh.nz)
    nrb = mesh.root_grid[::-1]
    g = np.stack([rng.integers(0, cells[a], n) for a in range(3)])
    bk = g // np.asarray(nloc)[:, None]
    blk = (bk[2] * nrb[1] + bk[1]) * nrb[0] + bk[0]
    mu = 1.0 - 2.0 * rng.random(n)
    phi = 2 * np.pi * rng.random(n)
    st = np.sqrt(1.0 - mu * mu)
    v = (st * np.cos(phi), st * np.sin(phi), mu)
    p.block[:n] = torch.as_tensor(blk, dtype=torch.int32)
    for a, (pos, idx, vel) in enumerate((("x", "i", "vx"), ("y", "j", "vy"), ("z", "k", "vz"))):
        loc = g[a] - bk[a] * nloc[a]
        getattr(p, idx)[:n] = torch.as_tensor(loc, dtype=torch.int32)
        if a < ndim:
            dx = 1.0 / cells[a]
            getattr(p, pos)[:n] = torch.as_tensor((loc + rng.random(n)) * dx, dtype=torch.float32)
        getattr(p, vel)[:n] = torch.as_tensor(C * v[a], dtype=torch.float32)
    p.alive[:n] = True
    p.weight[:n] = 1.0
    nc = mesh.total_cells
    coefs = TransportCoefs(sigma_a=torch.full((nc,), sigma_a, device=dev),
                           sigma_s=torch.full((nc,), sigma_s, device=dev),
                           fleck=torch.ones(nc, device=dev))
    return cfg.jaybenne.dt, mesh, prm, p, coefs


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("max_iters", [8, None])
def test_absorbing_kernel_matches_plain(gpu, ndim, max_iters):
    dt, mesh, prm, p0, coefs = _grid_setup(gpu, ndim)
    if max_iters is not None:
        prm = dataclasses.replace(prm, max_iters=max_iters)
    name = transport_kernel.launch_name(ndim, True)
    before = cuda_lib.LAUNCHES[name]
    k, it_k, ev_k = transport_kernel.transport(p0.clone(), coefs, mesh, -99, prm, dt)
    q, it_q, ev_q = transport_kernel.transport_plain(p0.clone(), coefs, mesh, -99, prm, dt)
    assert cuda_lib.LAUNCHES[name] == before + 1
    assert not bool((k.alive & k.absorbed).any())
    if max_iters is None:  # full census: statistics
        assert not bool((k.tau[k.alive] < 1.0).any())
        assert abs(int(ev_k) - int(ev_q)) <= EVENTS_RTOL * int(ev_q)
        n = int(p0.alive.sum())
        ka, qa = int(k.absorbed.sum()), int(q.absorbed.sum())
        pbar = 0.5 * (ka + qa) / n
        assert abs(ka - qa) <= 4.0 * np.sqrt(2.0 * n * pbar * (1.0 - pbar)) + 1
        return
    for name in ("i", "j", "k", "block", "alive", "absorbed"):
        assert torch.equal(getattr(k, name), getattr(q, name)), name
    for name in ("x", "y", "z", "vx", "vy", "vz", "tau"):
        torch.testing.assert_close(getattr(k, name), getattr(q, name), rtol=FLOAT_RTOL,
                                   atol=1e-7 if name in ("x", "y", "z", "tau") else 1e-6 * C)
    assert int(ev_k) == int(ev_q) and int(it_k) == int(it_q) == max_iters


def test_rare_absorption_unbiased_on_kernel(gpu):
    """tests/test_pallas.py::test_rare_absorption_unbiased on the kernel: 16000
    particles, sigma_a / sigma_t ~ 7.5e-6; a u16 branch draw would double the
    24 expected absorptions."""
    cfg = cm.from_deck(Deck.from_file(STEPDIFF).update(
        {"mcblock/opacity_model": "constant", "parthenon/mesh/nx1": 100}))
    mesh = build_mesh(cfg.mesh, device=gpu)
    prm = make_transport_params(cfg, torch.float32)
    n = 16000
    rng = np.random.default_rng(7)
    p = empty_ledger(n, torch.float32, gpu)
    cell = rng.integers(0, 50, n)
    p.block[:] = torch.as_tensor(rng.integers(0, 2, n), dtype=torch.int32)
    p.i[:] = torch.as_tensor(cell, dtype=torch.int32)
    p.x[:] = torch.as_tensor((cell + rng.random(n)) * 0.01, dtype=torch.float32)
    mu = 1.0 - 2.0 * rng.random(n)
    p.vx[:] = torch.as_tensor(C * mu, dtype=torch.float32)
    p.vy[:] = torch.as_tensor(C * np.sqrt(1.0 - mu * mu), dtype=torch.float32)
    p.alive[:] = True
    p.weight[:] = 1.0
    nc = mesh.total_cells
    coefs = TransportCoefs(sigma_a=torch.full((nc,), 0.0015, device=gpu),
                           sigma_s=torch.full((nc,), 200.0, device=gpu),
                           fleck=torch.ones(nc, device=gpu))
    dt = 3.335641e-11  # c dt = 1 cm
    out, _, _ = transport_kernel.transport(p, coefs, mesh, 4242, prm, dt)
    expect = n * (1.0 - np.exp(-0.0015 * C * dt))
    assert abs(int(out.absorbed.sum()) - expect) < 3.2 * np.sqrt(expect)


def test_feedback_path_runs_through_kernel(gpu, tmp_path):
    """bench.py's feedback configuration at 16^3 cells in 8^3 blocks and 20000
    particles: emission, absorption and feedback through the 3D absorbing kernel,
    one launch per step, nothing dropped, total energy conserved, and a rerun with
    the same seed bitwise identical."""
    mods = {
        "parthenon/mesh/nx1": 16, "parthenon/mesh/nx2": 16, "parthenon/mesh/nx3": 16,
        "parthenon/mesh/ix2_bc": "periodic", "parthenon/mesh/ox2_bc": "periodic",
        "parthenon/mesh/ix3_bc": "periodic", "parthenon/mesh/ox3_bc": "periodic",
        "parthenon/meshblock/nx1": 8, "parthenon/meshblock/nx2": 8,
        "parthenon/meshblock/nx3": 8,
        "jaybenne/num_particles": 20000, "jaybenne/do_emission": "true",
        "jaybenne/do_feedback": "true", "mcblock/opacity_model": "constant",
        "mcblock/opacity_constant_value": 3.0, "jaybenne/capacity_factor": 3,
        "parthenon/output0/file_type": "none",
    }
    sims, energies = [], []
    name = transport_kernel.launch_name(3, True)
    for _ in range(2):
        sim0 = run_file(STEPDIFF, outdir=str(tmp_path), modified_inputs=mods, quiet=True,
                        nlim=0, device="cuda")
        energies.append(_total_energy(sim0))
        before = cuda_lib.LAUNCHES[name]
        sims.append(run_file(STEPDIFF, outdir=str(tmp_path), modified_inputs=mods,
                             quiet=True, nlim=3, device="cuda"))
        assert cuda_lib.LAUNCHES[name] == before + 3
    for sim, (e0, er0) in zip(sims, energies):
        assert all(h["dropped"] == 0 and h["unfinished"] == 0 for h in sim.history)
        e1, _ = _total_energy(sim)
        assert abs(e1 - e0) <= 1e-5 * er0
    a, b = (s.state.fields for s in sims)
    assert a.u.is_cuda and torch.equal(a.energy_tally, b.energy_tally)
    assert torch.equal(a.u, b.u)


def _total_energy(sim):
    """(sum u dV + sum of live weights, sum of live weights) in float64."""
    dv = sim.mesh.block_volume.double()[:, None, None, None]
    p = sim.state.particles
    er = float(p.weight.double()[p.alive].sum())
    return float((sim.state.fields.u.double() * dv).sum()) + er, er


def test_main_path_runs_through_kernel(gpu, tmp_path):
    mods = {"parthenon/mesh/nx1": 64, "parthenon/meshblock/nx1": 64,
            "jaybenne/num_particles": 20000, "parthenon/output0/file_type": "none"}
    cuda_lib.LAUNCHES.clear()
    sims = [run_file(STEPDIFF, outdir=str(tmp_path), modified_inputs=mods, quiet=True,
                     nlim=3, device="cuda") for _ in range(2)]
    assert cuda_lib.LAUNCHES["transport_1d"] == 6 and cuda_lib.LAUNCHES["transport_1d_abs"] == 0
    a, b = (s.state.fields.energy_tally for s in sims)
    assert a.is_cuda and torch.equal(a, b)  # bitwise deterministic
    f = sims[0].state.fields
    # source_ew is a particle's weight (energy), the tally an energy density
    sourced = float((f.source_num.double() * f.source_ew.double()).sum())
    dv = sims[0].mesh.block_volume.double()[:, None, None, None]
    tallied = float((a.double() * dv).sum())
    assert abs(tallied - sourced) <= 1e-5 * sourced  # no absorption, reflecting walls


def _hybrid_setup(dev, ndim, absorb, n=30000, seed=5, thin=64.0):
    """DDMC on the meshes of ``_grid_setup`` (1D: 64 cells in 4 blocks): x-slabs of
    cells alternate thin (sigma_t = ``thin``, 64: IMC) and thick (sigma_t = 1024,
    DDMC for tau_ddmc = 5), with f sigma_a = 2 in every cell when absorbing; a
    quarter of the particles sit on a face of their cell with the face-arrival
    code set."""
    cells = {1: (64, 1, 1), 2: (32, 16, 1), 3: (16, 16, 16)}[ndim]
    blocks = {1: (16, 1, 1), 2: (8, 8, 1), 3: (8, 8, 8)}[ndim]
    mods = {"jaybenne/use_ddmc": "true", "parthenon/swarm/ix3_bc": "outflow",
            "parthenon/swarm/ox3_bc": "outflow",
            "mcblock/opacity_model": "constant" if absorb else "none"}
    for a, k in enumerate("123"):
        mods[f"parthenon/mesh/nx{k}"] = cells[a]
        mods[f"parthenon/meshblock/nx{k}"] = blocks[a]
    cfg = cm.from_deck(Deck.from_file(STEPDIFF).update(mods))
    mesh = build_mesh(cfg.mesh, device=dev)
    prm = make_transport_params(cfg, torch.float32)
    assert mesh.ndim == ndim and mesh.n_blocks > 1 and prm.use_ddmc
    nrbx = mesh.root_grid[2]
    gi = (torch.arange(mesh.n_blocks, device=dev) % nrbx)[:, None, None, None] * mesh.nx \
        + torch.arange(mesh.nx, device=dev)
    thick = ((gi // 4) % 2 == 1).expand(mesh.n_blocks, mesh.nz, mesh.ny, mesh.nx)
    sig = torch.where(thick, 1024.0, thin)
    sa = torch.full_like(sig, 2.0 if absorb else 0.0)
    px, py, pz = ddmc_face_probs(mesh, sig, prm.tau_ddmc, cfg.mesh.periodic_flags,
                                 torch.float32)
    coefs = TransportCoefs(sigma_a=sa.reshape(-1), sigma_s=(sig - sa).reshape(-1),
                           fleck=torch.ones(mesh.total_cells, device=dev), px=px, py=py, pz=pz)
    g = torch.Generator(device=dev).manual_seed(seed)
    p = uniform_ledger(mesh, n, g, C)
    place_on_faces(p, mesh, torch.rand(n, generator=g, device=dev) < 0.25, g)
    return cfg.jaybenne.dt, mesh, prm, p, coefs


@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("max_iters", [8, None])
def test_ddmc_kernel_matches_plain(gpu, ndim, absorb, max_iters):
    dt, mesh, prm, p0, coefs = _hybrid_setup(gpu, ndim, absorb)
    if max_iters is not None:
        prm = dataclasses.replace(prm, max_iters=max_iters)
    name = transport_kernel.launch_name(ndim, absorb, True)
    before = cuda_lib.LAUNCHES[name]
    k, it_k, ev_k = transport_kernel.transport(p0.clone(), coefs, mesh, -99, prm, dt)
    q, it_q, ev_q = transport_kernel.transport_plain(p0.clone(), coefs, mesh, -99, prm, dt)
    assert cuda_lib.LAUNCHES[name] == before + 1
    assert not bool((k.alive & k.absorbed).any())
    if max_iters is None:  # full census: statistics
        assert not bool((k.tau[k.alive] < 1.0).any())
        assert abs(int(ev_k) - int(ev_q)) <= EVENTS_RTOL * int(ev_q)
        n = int(p0.alive.sum())
        for ka, qa in ((int(k.absorbed.sum()), int(q.absorbed.sum())),
                       (int(k.alive.sum()), int(q.alive.sum()))):
            pbar = 0.5 * (ka + qa) / n
            assert abs(ka - qa) <= 4.0 * np.sqrt(2.0 * n * pbar * (1.0 - pbar)) + 1
        return
    for name in ("i", "j", "k", "block", "alive", "absorbed", "face"):
        assert torch.equal(getattr(k, name), getattr(q, name)), name
    for name in ("x", "y", "z", "vx", "vy", "vz", "tau"):
        torch.testing.assert_close(getattr(k, name), getattr(q, name), rtol=FLOAT_RTOL,
                                   atol=1e-7 if name in ("x", "y", "z", "tau") else 1e-6 * C)
    assert int(ev_k) == int(ev_q) and int(it_k) == int(it_q) == max_iters


def test_ddmc_main_path_runs_through_kernel(gpu, tmp_path):
    """stepdiff_ddmc at 64 cells and 20000 particles, 3 steps: one launch of the 1D
    DDMC kernel per step, the radiation energy conserved, and a rerun with the same
    seed bitwise identical."""
    mods = {"parthenon/mesh/nx1": 64, "parthenon/meshblock/nx1": 32,
            "jaybenne/num_particles": 20000, "parthenon/output0/file_type": "none"}
    name = transport_kernel.launch_name(1, False, True)
    sims = []
    for _ in range(2):
        before = cuda_lib.LAUNCHES[name]
        sims.append(run_file(STEPDIFF_DDMC, outdir=str(tmp_path), modified_inputs=mods,
                             quiet=True, nlim=3, device="cuda"))
        assert cuda_lib.LAUNCHES[name] == before + 3
    a, b = (s.state.fields.energy_tally for s in sims)
    assert a.is_cuda and torch.equal(a, b)
    f = sims[0].state.fields
    sourced = float((f.source_num.double() * f.source_ew.double()).sum())
    dv = sims[0].mesh.block_volume.double()[:, None, None, None]
    assert abs(float((a.double() * dv).sum()) - sourced) <= 1e-5 * sourced
    assert all(h["unfinished"] == 0 for h in sims[0].history)


# the forests of the SMR kernel checks: a level-1 box over the centre, cut small
SMR_FORESTS = {
    1: ("stepdiff.in", {"parthenon/mesh/nx1": 64, "parthenon/meshblock/nx1": 8,
                        "parthenon/mesh/refinement": "static",
                        "parthenon/static_refinement1/level": 1,
                        "parthenon/static_refinement1/x1min": -0.25,
                        "parthenon/static_refinement1/x1max": 0.25}),
    2: ("stepdiff_smr.in", {"parthenon/mesh/nx1": 32, "parthenon/mesh/nx2": 16,
                            "parthenon/meshblock/nx1": 8, "parthenon/meshblock/nx2": 8}),
    3: ("stepdiff_3d_smr_ddmc.in", {"parthenon/mesh/nx1": 16, "parthenon/mesh/nx2": 8,
                                    "parthenon/mesh/nx3": 8, "parthenon/meshblock/nx1": 4,
                                    "parthenon/meshblock/nx2": 4,
                                    "parthenon/meshblock/nx3": 4}),
}


def _smr_setup(dev, ndim, absorb, ddmc, n=30000, seed=5, thin=64.0):
    """A level-1 forest with x-slabs of two coarse cells alternating thin (sigma_t =
    ``thin``, 64: IMC) and thick (sigma_t = 1024, DDMC for tau_ddmc = 5 on both
    levels in 2D/3D), with f sigma_a = 2 when absorbing; particles uniform over the
    forest's cells, a quarter of them on a face of their cell with the face-arrival
    code set."""
    deck, mods = SMR_FORESTS[ndim]
    mods = {**mods, "jaybenne/use_ddmc": "true" if ddmc else "false",
            "jaybenne/tau_ddmc": 5.0, "mcblock/opacity_model": "constant" if absorb else "none"}
    cfg = cm.from_deck(Deck.from_file(os.path.join(_ROOT, "inputs", deck)).update(mods))
    mesh = build_mesh(cfg.mesh, device=dev)
    prm = make_transport_params(cfg, torch.float32)
    assert mesh.ndim == ndim and mesh.max_level == 1 and prm.use_ddmc == ddmc
    xc = mesh.cell_centers()[0]
    slab = 2.0 * float(mesh.block_dx[:, 0].max())
    thick = torch.floor((xc - mesh.bounds[0]) / slab).long() % 2 == 1
    sig = torch.where(thick, 1024.0, thin)
    sa = torch.full_like(sig, 2.0 if absorb else 0.0)
    faces = {}
    if ddmc:
        faces = dict(zip(("px", "py", "pz"), ddmc_face_probs(
            mesh, sig, prm.tau_ddmc, cfg.mesh.periodic_flags, torch.float32)))
    coefs = TransportCoefs(sigma_a=sa.reshape(-1), sigma_s=(sig - sa).reshape(-1),
                           fleck=torch.ones(mesh.total_cells, device=dev), **faces)
    g = torch.Generator(device=dev).manual_seed(seed)
    p = forest_ledger(mesh, n, g, C)
    place_on_faces(p, mesh, torch.rand(n, generator=g, device=dev) < 0.25, g)
    return cfg.jaybenne.dt, mesh, prm, p, coefs


@pytest.mark.parametrize("ddmc", [False, True])
@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("max_iters", [8, None])
def test_smr_kernel_matches_plain(gpu, ndim, absorb, ddmc, max_iters):
    dt, mesh, prm, p0, coefs = _smr_setup(gpu, ndim, absorb, ddmc)
    if max_iters is not None:
        prm = dataclasses.replace(prm, max_iters=max_iters)
    name = transport_kernel.launch_name(ndim, absorb, ddmc, True)
    before = cuda_lib.LAUNCHES[name]
    k, it_k, ev_k = transport_kernel.transport(p0.clone(), coefs, mesh, -99, prm, dt)
    q, it_q, ev_q = transport_kernel.transport_plain(p0.clone(), coefs, mesh, -99, prm, dt)
    assert cuda_lib.LAUNCHES[name] == before + 1
    assert not bool((k.alive & k.absorbed).any())
    assert bool((k.block != p0.block).any())
    if max_iters is None:  # full census: statistics
        assert not bool((k.tau[k.alive] < 1.0).any())
        assert abs(int(ev_k) - int(ev_q)) <= EVENTS_RTOL * int(ev_q)
        n = int(p0.alive.sum())
        for ka, qa in ((int(k.absorbed.sum()), int(q.absorbed.sum())),
                       (int(k.alive.sum()), int(q.alive.sum()))):
            pbar = 0.5 * (ka + qa) / n
            assert abs(ka - qa) <= 4.0 * np.sqrt(2.0 * n * pbar * (1.0 - pbar)) + 1
        return
    for name in ("i", "j", "k", "block", "alive", "absorbed", "face"):
        assert torch.equal(getattr(k, name), getattr(q, name)), name
    for name in ("x", "y", "z", "vx", "vy", "vz", "tau"):
        torch.testing.assert_close(getattr(k, name), getattr(q, name), rtol=FLOAT_RTOL,
                                   atol=1e-7 if name in ("x", "y", "z", "tau") else 1e-6 * C)
    assert int(ev_k) == int(ev_q) and int(it_k) == int(it_q) == max_iters


@pytest.mark.parametrize("deck", ["stepdiff_smr.in", "stepdiff_smr_ddmc.in"])
def test_smr_path_runs_through_kernel(gpu, tmp_path, deck):
    """An SMR deck at 32 x 16 cells in 8^2 blocks and 20000 particles, 3 steps: one
    launch of the 2D SMR kernel per step, the radiation energy conserved, and a
    rerun with the same seed bitwise identical."""
    mods = {"parthenon/mesh/nx1": 32, "parthenon/mesh/nx2": 16,
            "parthenon/meshblock/nx1": 8, "parthenon/meshblock/nx2": 8,
            "jaybenne/num_particles": 20000, "parthenon/output0/file_type": "none"}
    path = os.path.join(_ROOT, "inputs", deck)
    name = transport_kernel.launch_name(2, False, "ddmc" in deck, True)
    sims = []
    for _ in range(2):
        before = cuda_lib.LAUNCHES[name]
        sims.append(run_file(path, outdir=str(tmp_path), modified_inputs=mods, quiet=True,
                             nlim=3, device="cuda"))
        assert cuda_lib.LAUNCHES[name] == before + 3
    assert sims[0].mesh.max_level == 1
    a, b = (s.state.fields.energy_tally for s in sims)
    assert a.is_cuda and torch.equal(a, b)
    f = sims[0].state.fields
    sourced = float((f.source_num.double() * f.source_ew.double()).sum())
    dv = sims[0].mesh.block_volume.double()[:, None, None, None]
    assert abs(float((a.double() * dv).sum()) - sourced) <= 1e-5 * sourced
    assert all(h["unfinished"] == 0 for h in sims[0].history)


def _nongray_setup(dev, ndim, ddmc, smr, n=30000, seed=5):
    """EPBremss on the meshes of ``_hybrid_setup`` (uniform) or ``_smr_setup``
    (level-1 forests): per cell rho in [0.5, 2], T log-uniform in [5e5, 5e6], fleck
    in [0.3, 1] and sigma_s = 10; photon energies x sb T of the particle's cell, x
    log-uniform in [0.05, 30], so that sigma_a(E) runs from thin to thick and, with
    DDMC, lanes of one cell take both branches; a quarter of the particles on a face
    of their cell with the face-arrival code set."""
    from jaybenne_tpu_torch.utils.constants import SB

    if smr:
        deck, mods = SMR_FORESTS[ndim]
        path = os.path.join(_ROOT, "inputs", deck)
    else:
        path, mods = STEPDIFF, {"parthenon/swarm/ix3_bc": "outflow",
                                "parthenon/swarm/ox3_bc": "outflow"}
        cells = {1: (64, 1, 1), 2: (32, 16, 1), 3: (16, 16, 16)}[ndim]
        blocks = {1: (16, 1, 1), 2: (8, 8, 1), 3: (8, 8, 8)}[ndim]
        for a, k in enumerate("123"):
            mods[f"parthenon/mesh/nx{k}"] = cells[a]
            mods[f"parthenon/meshblock/nx{k}"] = blocks[a]
    mods = {**mods, "jaybenne/use_ddmc": "true" if ddmc else "false", "jaybenne/tau_ddmc": 5.0,
            "mcblock/opacity_model": "ep_bremss", "mcblock/scattering_constant_value": 10.0}
    cfg = cm.from_deck(Deck.from_file(path).update(mods))
    mesh = build_mesh(cfg.mesh, device=dev)
    prm = make_transport_params(cfg, torch.float32)
    assert mesh.ndim == ndim and (mesh.max_level > 0) == smr and prm.has_absorption
    g = torch.Generator(device=dev).manual_seed(seed)
    nc = mesh.total_cells
    rho = 0.5 + 1.5 * torch.rand(nc, generator=g, device=dev)
    temp = torch.exp(np.log(5e5) + np.log(10.0) * torch.rand(nc, generator=g, device=dev))
    ff = 0.3 + 0.7 * torch.rand(nc, generator=g, device=dev)
    opacity, scattering = cfg.mcblock.build_opacity(), cfg.mcblock.build_scattering()
    sa = opacity.absorption_coefficient(rho, temp)
    ss = scattering.total_scattering_coefficient(rho, temp)
    faces = {}
    if ddmc:
        shape = (mesh.n_blocks, mesh.nz, mesh.ny, mesh.nx)
        faces = dict(zip(("px", "py", "pz"), ddmc_face_probs(
            mesh, (sa + ss).reshape(shape), prm.tau_ddmc, cfg.mesh.periodic_flags,
            torch.float32)))
    coefs = TransportCoefs(sigma_a=sa, sigma_s=ss, fleck=ff, rho=rho, temp=temp,
                           opacity=opacity, **faces)
    p = forest_ledger(mesh, n, g, C)
    place_on_faces(p, mesh, torch.rand(n, generator=g, device=dev) < 0.25, g)
    cell = ((p.block.long() * mesh.nz + p.k) * mesh.ny + p.j) * mesh.nx + p.i
    x = torch.exp(np.log(0.05) + np.log(600.0) * torch.rand(n, generator=g, device=dev))
    p.energy.copy_(x * SB * temp[cell])
    return cfg.jaybenne.dt, mesh, prm, p, coefs


@pytest.mark.parametrize("smr", [False, True])
@pytest.mark.parametrize("ddmc", [False, True])
@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("max_iters", [8, None])
def test_nongray_kernel_matches_plain(gpu, ndim, ddmc, smr, max_iters):
    """Each of the twelve NONGRAY instantiations against its plain version: after 8
    iterations integers, blocks, alive, absorbed and face codes identical and floats
    within FLOAT_RTOL (the model's expf, sqrtf and divides are the plain version's
    on the card); after a full census statistics."""
    dt, mesh, prm, p0, coefs = _nongray_setup(gpu, ndim, ddmc, smr)
    if max_iters is not None:
        prm = dataclasses.replace(prm, max_iters=max_iters)
    name = transport_kernel.launch_name(ndim, True, ddmc, smr, True)
    before = cuda_lib.LAUNCHES[name]
    k, it_k, ev_k = transport_kernel.transport(p0.clone(), coefs, mesh, -99, prm, dt)
    q, it_q, ev_q = transport_kernel.transport_plain(p0.clone(), coefs, mesh, -99, prm, dt)
    assert cuda_lib.LAUNCHES[name] == before + 1
    assert not bool((k.alive & k.absorbed).any()) and bool(k.absorbed.any())
    assert torch.equal(k.energy, p0.energy)
    if max_iters is None:  # full census: statistics
        assert not bool((k.tau[k.alive] < 1.0).any())
        assert abs(int(ev_k) - int(ev_q)) <= EVENTS_RTOL * int(ev_q)
        n = int(p0.alive.sum())
        for ka, qa in ((int(k.absorbed.sum()), int(q.absorbed.sum())),
                       (int(k.alive.sum()), int(q.alive.sum()))):
            pbar = 0.5 * (ka + qa) / n
            assert abs(ka - qa) <= 4.0 * np.sqrt(2.0 * n * pbar * (1.0 - pbar)) + 1
        return
    for name in ("i", "j", "k", "block", "alive", "absorbed", "face"):
        assert torch.equal(getattr(k, name), getattr(q, name)), name
    for name in ("x", "y", "z", "vx", "vy", "vz", "tau"):
        torch.testing.assert_close(getattr(k, name), getattr(q, name), rtol=FLOAT_RTOL,
                                   atol=1e-7 if name in ("x", "y", "z", "tau") else 1e-6 * C)
    assert int(ev_k) == int(ev_q) and int(it_k) == int(it_q) == max_iters


def test_suolson_path_runs_through_kernel(gpu, tmp_path):
    """inputs/suolson.in with both particle walls reflecting, 1600 + 1600
    particles, 5 steps: one launch of the 1D absorbing kernel per step, the
    bookkeeping of tst/suolson.py within 1e-2, and a rerun bitwise identical."""
    mods = {"parthenon/swarm/ix1_bc": "jaybenne_reflecting",
            "parthenon/swarm/ox1_bc": "jaybenne_reflecting", "jaybenne/num_particles": 1600,
            "jaybenne/external_source_num": 1600, "parthenon/output0/file_type": "none"}
    path = os.path.join(_ROOT, "inputs", "suolson.in")
    name = transport_kernel.launch_name(1, True)
    sims = []
    for _ in range(2):
        before = cuda_lib.LAUNCHES[name]
        sims.append(run_file(path, outdir=str(tmp_path), modified_inputs=mods, quiet=True,
                             nlim=5, device="cuda"))
        assert cuda_lib.LAUNCHES[name] == before + 5
    a, b = (s.state.fields.u for s in sims)
    assert a.is_cuda and torch.equal(a, b)
    sim = sims[0]
    mc, jb = sim.cfg.mcblock, sim.cfg.jaybenne
    dv = sim.mesh.block_volume.double()[:, None, None, None]
    p = sim.state.particles
    e = float((sim.state.fields.u.double() * dv).sum()) + float(p.weight.double()[p.alive].sum())
    e0 = mc.initial_density * mc.build_eos().internal_energy_from_density_temperature(
        mc.initial_density, mc.initial_temperature)
    injected = jb.external_source_q * 0.25 * min(sim.t, jb.external_source_tmax)
    assert abs(e - e0 - injected) <= 1e-2 * injected and sim.state.overflow == 0


def _owned_round_matches_plain(gpu, p0, coefs, mesh, prm, dt, own):
    """One owned-range round of the kernel and of its plain version: every column
    identical, the floats bitwise, and the route's launch counted."""
    name = transport_kernel.launch_name(prm.ndim, prm.has_absorption, prm.use_ddmc,
                                        own.kind == "blocks" or mesh.max_level > 0,
                                        route=own.route)
    before = cuda_lib.LAUNCHES[name]
    k, it_k, ev_k = transport_kernel.transport(p0.clone(), coefs, mesh, 4242, prm, dt, own)
    q, it_q, ev_q = transport_kernel.transport_plain(p0.clone(), coefs, mesh, 4242, prm, dt,
                                                     own)
    assert cuda_lib.LAUNCHES[name] == before + 1
    for f in dataclasses.fields(k):
        assert torch.equal(getattr(k, f.name), getattr(q, f.name)), f.name
    assert int(ev_k) == int(ev_q) and int(it_k) == int(it_q)
    paused = k.alive & (k.tau < 1.0)
    assert bool(paused.any())
    return k, paused


@pytest.mark.parametrize("shard", [0, 1, 3])
def test_owned_range_z_kernel_matches_plain(gpu, shard):
    """K3s (chip_smoke.py phase 28 at a test's size): 16^3 cells in 4^3 blocks,
    periodic y and z, 4 shards of one z-plane of blocks each; 2^14 particles on
    shard ``shard``'s slab, one round. Every paused lane left the slab."""
    from jaybenne_tpu_torch.parallel.spatial import owned_range

    per = {f"parthenon/swarm/{s}x{k}_bc": "periodic" for s in "io" for k in "23"}
    cfg = cm.from_deck(Deck.from_file(STEPDIFF).update({
        **{f"parthenon/mesh/nx{k}": 16 for k in "123"}, **per,
        **{f"parthenon/meshblock/nx{k}": 4 for k in "123"},
        "mcblock/opacity_model": "constant", "jaybenne/dt": "3.e-12"}))
    mesh = build_mesh(cfg.mesh, device=gpu)
    prm = make_transport_params(cfg, torch.float32)
    own = owned_range(mesh, prm, 4, shard)
    lo, hi = own.bounds()
    assert own.kind == "z" and (lo, hi) == (4 * shard, 4 * shard + 4)
    nc = 16 * mesh.ncells_per_block
    coefs = TransportCoefs(sigma_a=torch.full((nc,), 2.0, device=gpu),
                           sigma_s=torch.full((nc,), 62.0, device=gpu),
                           fleck=torch.ones(nc, device=gpu))
    g = torch.Generator(device=gpu).manual_seed(28 + shard)
    p0 = uniform_ledger(mesh, 1 << 14, g, C)
    p0.block.copy_(p0.block % 16 + shard * 16)
    p0.tau.copy_(torch.rand(p0.capacity, generator=g, device=gpu))
    k, paused = _owned_round_matches_plain(gpu, p0, coefs, mesh, prm, cfg.jaybenne.dt, own)
    gk = (k.block // 16) * 4 + k.k
    assert not bool((paused & (gk >= lo) & (gk < hi)).any())


@pytest.mark.parametrize("shard", [0, 1])
def test_owned_range_blocks_kernel_matches_plain(gpu, shard):
    """K4s with DDMC (chip_smoke.py phase 29 at a test's size): the 32x16 forest in
    8x8 blocks with thin and thick x-slabs, 2 shards, 2^14 particles in shard
    ``shard``'s blocks, one round; shard 0's coarse thick cells write pending leak
    codes into shard 1's finer blocks."""
    from jaybenne_tpu_torch.parallel.spatial import owned_range

    cfg = cm.from_deck(Deck.from_file(os.path.join(_ROOT, "inputs", "stepdiff_smr_ddmc.in"))
                       .update({"parthenon/mesh/nx1": 32, "parthenon/mesh/nx2": 16,
                                "parthenon/meshblock/nx1": 8, "parthenon/meshblock/nx2": 8,
                                "jaybenne/tau_ddmc": 5.0}))
    mesh = build_mesh(cfg.mesh, device=gpu)
    prm = make_transport_params(cfg, torch.float32)
    own = owned_range(mesh, prm, 2, shard)
    lo, hi = own.bounds()
    assert own.kind == "blocks" and mesh.max_level == 1
    xc = mesh.cell_centers()[0]
    sig = torch.where(torch.floor((xc + 0.5) / 0.0625).long() % 2 == 1, 512.0, 16.0)
    faces = ddmc_face_probs(mesh, sig, prm.tau_ddmc, cfg.mesh.periodic_flags, torch.float32)
    ncpb = mesh.ncells_per_block
    loc = sig.reshape(-1)[lo * ncpb:hi * ncpb]
    coefs = TransportCoefs(sigma_a=torch.zeros_like(loc), sigma_s=loc,
                           fleck=torch.ones_like(loc), px=faces[0][lo:hi],
                           py=faces[1][lo:hi], pz=faces[2][lo:hi])
    g = torch.Generator(device=gpu).manual_seed(29 + shard)
    p0 = forest_ledger(mesh, 1 << 14, g, C, blocks=(lo, hi))
    place_on_faces(p0, mesh, torch.rand(p0.capacity, generator=g, device=gpu) < 0.25, g)
    p0.tau.copy_(torch.rand(p0.capacity, generator=g, device=gpu))
    k, paused = _owned_round_matches_plain(gpu, p0, coefs, mesh, prm, 3.0e-11, own)
    assert not bool((paused & (k.block >= lo) & (k.block < hi)).any())
    pending = k.leak != 0
    assert not bool((pending & ~paused).any())
    if shard == 0:
        assert bool(pending.any())


def test_spatial_path_runs_through_owned_range_kernel(gpu, tmp_path):
    """The stepdiff slab through the spatial decomposition at 4 in-process shards
    on the card, 2 steps: every round queued (a batch's no-op rounds too) makes
    one launch of the block-range route over all 4 shards and one launch of the
    migration kernel, the tally holds the live weights, and a rerun is bitwise
    identical."""
    mods = {"parthenon/mesh/nx1": 32, "parthenon/meshblock/nx1": 4,
            "jaybenne/num_particles": 8000, "jaybenne/decomposition": "spatial",
            "jaybenne/n_devices": 4, "jaybenne/dt": "1.e-11", "parthenon/time/tlim": "2.e-11",
            "mcblock/scattering_constant_value": 200.0, "parthenon/output0/file_type": "none"}
    name = transport_kernel.launch_name(1, False, False, True, route="@blocks")
    sims = []
    for _ in range(2):
        before, before_pack = cuda_lib.LAUNCHES[name], cuda_lib.LAUNCHES["migrate_pack"]
        sims.append(run_file(STEPDIFF, outdir=str(tmp_path), modified_inputs=mods, quiet=True,
                             device="cuda"))
        sim = sims[-1]
        core = sim.step_fn.step if sim.graphed else sim.step_fn
        rounds = sum(h["migration_rounds"] for h in sim.history)
        assert 0 < rounds <= core.rounds_run
        assert cuda_lib.LAUNCHES[name] == before + core.rounds_run  # one a round queued
        # the migration kernel: its one launch a round queued
        assert cuda_lib.LAUNCHES["migrate_pack"] == before_pack + core.rounds_run
    a, b = (s.state.fields.energy_tally for s in sims)
    assert a.is_cuda and torch.equal(a, b)
    sim = sims[0]
    p = sim.state.particles
    w = float(p.weight.double()[p.alive].sum())
    e = float((a.double() * sim.mesh.block_volume.double()[:, None, None, None]).sum())
    assert abs(e - w) <= 1e-5 * w and sim.history[-1]["migrated"] > 0


# ------------------------------------------- the regrouping schedule, at scale


def _resident_lanes(dev) -> int:
    """The most threads the card holds at once."""
    props = torch.cuda.get_device_properties(dev)
    return props.multi_processor_count * getattr(props, "max_threads_per_multi_processor", 2048)


def _same_round(k, q, it_k, ev_k, it_q, ev_q):
    for f in dataclasses.fields(k):
        a, b = getattr(k, f.name), getattr(q, f.name)
        assert torch.equal(a, b), (f.name, int((a != b).sum()))
    assert torch.equal(it_k, it_q) and torch.equal(ev_k, ev_q)


# tests/test_torch_schedule.py's ROUTES: the z slabs with IMC and with DDMC, the 2D
# and the 3D forest by blocks
SHARD_ROUTES = ["z", "z_ddmc", "blocks", "blocks_3d"]


@pytest.mark.parametrize("route", SHARD_ROUTES)
def test_multi_shard_launch_matches_plain(gpu, route):
    """One launch over 8 shards' slices (tests/test_torch_schedule.py's cases at
    4096 slots a shard) against the plain per-shard calls in order: every column
    bitwise, the same iterations and events per shard."""
    from test_torch_schedule import one_call_round, per_shard_rounds, shard_case

    p0, coefs, mesh, seeds, prm, dt, owns = shard_case(route, 4096, dev=gpu)
    kind = owns[0].kind
    name = transport_kernel.launch_name(prm.ndim, prm.has_absorption, prm.use_ddmc,
                                        kind == "blocks", route="@" + kind)
    before = cuda_lib.LAUNCHES[name]
    k, q = p0.clone(), p0.clone()
    it_k, ev_k = one_call_round(transport_kernel.transport, k, coefs, mesh, seeds, prm, dt, owns)
    assert cuda_lib.LAUNCHES[name] == before + 1
    it_q, ev_q = per_shard_rounds(transport_kernel.transport_plain, q, coefs, mesh, seeds, prm,
                                  dt, owns)
    _same_round(k, q, it_k, ev_k, it_q, ev_q)
    assert bool((k.alive & (k.tau < 1.0)).any())


@pytest.mark.parametrize("route", SHARD_ROUTES)
def test_owned_routes_bitwise_past_the_resident_lanes(gpu, route):
    """Both owned-range routes over 8 shards on a ledger of 4 times the card's
    resident threads, so that blocks run in several waves, each regrouping its lanes:
    one launch against the plain version, bitwise."""
    from test_torch_schedule import N_SHARDS, one_call_round, shard_case

    m = -(-4 * _resident_lanes(gpu) // N_SHARDS)
    p0, coefs, mesh, seeds, prm, dt, owns = shard_case(route, m, dev=gpu)
    k, q = p0.clone(), p0.clone()
    it_k, ev_k = one_call_round(transport_kernel.transport, k, coefs, mesh, seeds, prm, dt, owns)
    it_q, ev_q = one_call_round(transport_kernel.transport_plain, q, coefs, mesh, seeds, prm,
                                dt, owns)
    _same_round(k, q, it_k, ev_k, it_q, ev_q)


@pytest.mark.parametrize("smr", [False, True])
@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_ddmc_full_census_bitwise_past_the_resident_lanes(gpu, ndim, absorb, smr):
    """The twelve DDMC instantiations (uniform and SMR, gray) on hybrid ledgers of
    4 times the card's resident threads, a full census of the last 10 % of a
    step: kernel and plain identical in every column, events and iterations."""
    n = 4 * _resident_lanes(gpu)
    dt, mesh, prm, p0, coefs = (_smr_setup(gpu, ndim, absorb, True, n=n) if smr
                                else _hybrid_setup(gpu, ndim, absorb, n=n))
    g = torch.Generator(device=gpu).manual_seed(ndim)
    p0.tau.copy_(0.9 + 0.1 * torch.rand(n, generator=g, device=gpu))
    name = transport_kernel.launch_name(ndim, absorb, True, smr)
    before = cuda_lib.LAUNCHES[name]
    k, it_k, ev_k = transport_kernel.transport(p0.clone(), coefs, mesh, 77, prm, dt)
    q, it_q, ev_q = transport_kernel.transport_plain(p0.clone(), coefs, mesh, 77, prm, dt)
    assert cuda_lib.LAUNCHES[name] == before + 1
    _same_round(k, q, it_k, ev_k, it_q, ev_q)
    assert not bool((k.tau[k.alive] < 1.0).any())


@pytest.mark.parametrize("case", ["scattered", "capped", "hybrid"])
@pytest.mark.parametrize("absorb", [False, True])
@pytest.mark.parametrize("smr", [False, True])
def test_3d_ddmc_bitwise_over_several_waves(gpu, smr, absorb, case):
    """The four 3D gray DDMC instantiations (the 64^3 DDMC row's and stepdiff_3d's,
    with their absorbing twins) on ledgers of 6 times the card's resident threads,
    so that blocks run in several waves, with a third of the slots live at random
    through the whole ledger and tau in [0.5, 1): kernel and plain identical in
    every column, events and iterations, one launch, dead slots untouched.
    ``scattered``: every cell thick (DDMC lanes only); ``capped``: the same at
    max_iters = 2, so that lanes stop short of census; ``hybrid``: thin and thick
    slabs, IMC and DDMC lanes."""
    n = 6 * _resident_lanes(gpu)
    thin = 64.0 if case == "hybrid" else 1024.0
    dt, mesh, prm, p0, coefs = (_smr_setup(gpu, 3, absorb, True, n=n, thin=thin) if smr
                                else _hybrid_setup(gpu, 3, absorb, n=n, thin=thin))
    g = torch.Generator(device=gpu).manual_seed(31 + 2 * smr + absorb)
    p0.alive &= torch.rand(n, generator=g, device=gpu) < 1.0 / 3.0
    p0.tau.copy_(0.5 + 0.5 * torch.rand(n, generator=g, device=gpu))
    if case == "capped":
        prm = dataclasses.replace(prm, max_iters=2)
    props = torch.cuda.get_device_properties(gpu)
    resident = transport_kernel.resident_blocks(3, absorb, True, smr)
    assert 4 * props.multi_processor_count * resident * 256 < n
    name = transport_kernel.launch_name(3, absorb, True, smr)
    before = cuda_lib.LAUNCHES[name]
    k, it_k, ev_k = transport_kernel.transport(p0.clone(), coefs, mesh, 4321, prm, dt)
    q, it_q, ev_q = transport_kernel.transport_plain(p0.clone(), coefs, mesh, 4321, prm, dt)
    assert cuda_lib.LAUNCHES[name] == before + 1
    _same_round(k, q, it_k, ev_k, it_q, ev_q)
    late = k.alive & (k.tau < 1.0)
    if case == "capped":
        assert int(it_k) == 2 and bool(late.any()) and int(ev_k) <= 2 * int(p0.alive.sum())
    else:
        assert not bool(late.any())
    dead = ~p0.alive  # never taken
    assert torch.equal(k.tau[dead], p0.tau[dead]) and torch.equal(k.vx[dead], p0.vx[dead])


# ------------------------------ the census table and the fold into the census


@pytest.mark.parametrize("layout", ["one_block_1d", "uniform_1d", "uniform_3d", "forest_2d",
                                    "z_ranges_2", "z_ranges_20", "block_ranges_2",
                                    "uniform_64"])
@pytest.mark.parametrize("kind", ["pair", "pair_abs", "ddmc", "ddmc_abs", "nongray",
                                  "nongray_ddmc"])
def test_census_table_kernel_matches_plain(gpu, kind, layout):
    """The table kernel (``csrc/table_kernel.cu``, through ``prepare`` on the card)
    against the rows computed cell by cell (tests/test_torch_table.py) and against
    its plain version ``_pair_table`` on the same tensors: bitwise, every record
    kind on every layout (bench.py's 64^3 mesh in 8^3 blocks among them; runs of
    four cells a thread where nx allows, of one where it does not: nx = 2), one
    launch a group of 16 ranges. Where the non-gray
    record would be a verbatim copy (one range, one block or a forest), ``prepare``
    launches no table and the kernel reads the coefficient columns, which hold the
    same rows; the table kernel, called itself, still makes them."""
    from test_torch_table import table_case

    coefs, mesh, prm, dt, own, want = table_case(kind, layout, dev=gpu)
    cset = [coefs] if own is None else coefs
    before = cuda_lib.LAUNCHES["census_table"]
    census = transport_kernel.prepare(coefs, mesh, prm, dt, own)
    groups = 1 if own is None else -(-len(own) // transport_kernel.MAX_RANGES_PER_TABLE)
    columns = kind == "nongray" and layout in ("one_block_1d", "forest_2d")
    assert (census.tabs.cols is not None) == columns
    if columns:
        assert cuda_lib.LAUNCHES["census_table"] == before and census.tabs.cell is None
        rows = torch.stack(census.tabs.cols, dim=1)
        assert torch.equal(rows.cpu().view(torch.int32), want)
        got = transport_kernel._table_cuda(cset, mesh, census.g)
    else:
        assert cuda_lib.LAUNCHES["census_table"] == before + groups
        got = census.tabs.cell
    assert got.is_cuda and torch.equal(got.cpu().view(torch.int32), want)
    plain = transport_kernel._pair_table(cset[0] if len(cset) == 1
                                         else transport_kernel._concat_coefs(cset), mesh,
                                         census.g)
    assert torch.equal(got.view(torch.int32), plain.view(torch.int32))


def _scramble_idle_slots(p, mesh, seed):
    """A fifth of the slots dead, at random blocks, cells and positions (-0.0 in
    y), and a tenth of the live ones finished (tau = 1): slots that no lane takes,
    whose collapse to one block and expansion back change their bits. A dead
    slot's block and cells stay inside the mesh, as a census leaves them: the plain
    census clips every slot's cell to the mesh, taken or not."""
    rng = np.random.default_rng(seed)
    dev = p.x.device
    p.alive &= torch.as_tensor(rng.random(p.capacity) >= 0.2, device=dev)
    dead = ~p.alive
    m = int(dead.sum())
    for name, n in (("i", mesh.nx), ("j", mesh.ny), ("k", mesh.nz)):
        getattr(p, name)[dead] = torch.as_tensor(rng.integers(0, n, m), dtype=torch.int32,
                                                 device=dev)
    p.block[dead] = torch.as_tensor(rng.integers(0, mesh.n_blocks, m), dtype=torch.int32,
                                    device=dev)
    p.x[dead] = torch.as_tensor(rng.normal(size=m), dtype=torch.float32, device=dev)
    p.y[dead] = -0.0
    done = p.alive & torch.as_tensor(rng.random(p.capacity) < 0.1, device=dev)
    p.tau[done] = 1.0


def _same_bits(k, q):
    for f in dataclasses.fields(k):
        a, b = getattr(k, f.name), getattr(q, f.name)
        if a.dtype in (torch.float32, torch.float64):  # the bits, signed zeros too
            bits = torch.int32 if a.dtype == torch.float32 else torch.int64
            a, b = a.view(bits), b.view(bits)
        assert torch.equal(a, b), (f.name, int((a != b).sum()))


@pytest.mark.parametrize("ddmc", [False, True])
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_folded_census_matches_plain_collapse(gpu, ndim, ddmc):
    """A census on a uniform mesh of several blocks, the collapse to one block and
    the expansion folded into the kernel's reads and writes, against the plain
    collapse, census and expansion: every column bitwise, dead and finished slots
    too, whose round trip changes their bits; no other kernel launched."""
    if ddmc:
        dt, mesh, prm, p0, coefs = _hybrid_setup(gpu, ndim, True, n=20000)
    elif ndim == 1:
        dt, mesh, prm, p0, coefs = _hybrid_setup(gpu, 1, True, n=20000)
        prm = dataclasses.replace(prm, use_ddmc=False)
    else:
        dt, mesh, prm, p0, coefs = _grid_setup(gpu, ndim, n=20000)
    assert mesh.n_blocks > 1
    _scramble_idle_slots(p0, mesh, ndim)
    name = transport_kernel.launch_name(ndim, True, prm.use_ddmc)
    before = dict(cuda_lib.LAUNCHES)
    k, it_k, ev_k = transport_kernel.transport(p0.clone(), coefs, mesh, 99, prm, dt)
    launched = {n: c - before.get(n, 0) for n, c in cuda_lib.LAUNCHES.items()
                if c != before.get(n, 0)}
    assert launched == {name: 1, "census_table": 1}
    q, it_q, ev_q = transport_kernel.transport_plain(p0.clone(), coefs, mesh, 99, prm, dt)
    _same_bits(k, q)
    assert int(it_k) == int(it_q) and int(ev_k) == int(ev_q) > 0
    assert not torch.equal(k.x.view(torch.int32)[~p0.alive], p0.x.view(torch.int32)[~p0.alive])


@pytest.mark.parametrize("route", ["z", "z_ddmc"])
def test_folded_round_over_8_shards_matches_plain(gpu, route):
    """A spatial round's one launch over 8 shards' joined ledger on a uniform mesh
    (tests/test_torch_schedule.py's z slabs), with the fold, against the plain
    collapse, round and expansion of the joined ledger: every column bitwise,
    the unowned, dead and finished slots too, the same iterations and events."""
    from test_torch_schedule import one_call_round, shard_case

    p0, coefs, mesh, seeds, prm, dt, owns = shard_case(route, 4096, dev=gpu)
    _scramble_idle_slots(p0, mesh, 8)
    k, q = p0.clone(), p0.clone()
    it_k, ev_k = one_call_round(transport_kernel.transport, k, coefs, mesh, seeds, prm, dt, owns)
    it_q, ev_q = one_call_round(transport_kernel.transport_plain, q, coefs, mesh, seeds, prm,
                                dt, owns)
    _same_bits(k, q)
    assert torch.equal(it_k, it_q) and torch.equal(ev_k, ev_q)


# ------------------------------- the event loop's cell cache and early draws


def _line_setup(dev, n, nx, sigma_s):
    """The stepdiff deck at nx cells in two blocks, reflecting walls, sigma_s
    everywhere, n particles at uniform positions with isotropic directions."""
    cfg = cm.from_deck(Deck.from_file(STEPDIFF).update(
        {"parthenon/mesh/nx1": nx, "parthenon/meshblock/nx1": nx // 2}))
    mesh = build_mesh(cfg.mesh, device=dev)
    prm = make_transport_params(cfg, torch.float32)
    assert mesh.ndim == 1 and mesh.n_blocks == 2 and not prm.has_absorption
    p = uniform_ledger(mesh, n, torch.Generator(device=dev).manual_seed(nx), C)
    coefs = TransportCoefs(sigma_a=torch.zeros(nx, device=dev),
                           sigma_s=torch.full((nx,), sigma_s, device=dev),
                           fleck=torch.ones(nx, device=dev))
    return cfg.jaybenne.dt, mesh, prm, p, coefs


def _imc_target(dev, route, n, moving):
    """The routes whose event loop was redesigned, on ledgers of their kind:
    ``transport_1d`` on the stepdiff line (128 cells, sigma_s = 1e3, reflecting
    walls), ``transport_2d_abs`` on ``_grid_setup``'s 32 x 16 mesh (sigma_s = 1e3,
    f sigma_a = 3, as on the 2D feedback path), ``transport_2d_smr`` on the level-1
    2D forest of ``_smr_setup`` (8x8 blocks, reflecting in x, periodic in y) and
    ``transport_3d_abs`` on ``_grid_setup``'s 16^3 mesh (reflecting in x, periodic
    in y, outflow in z). ``moving``: an optical depth of a cell or less (in 1D
    four cells of depth 1), so that lanes change cell, block and wall every event or
    two and each change gathers the cell's values anew."""
    if route == "1d":
        dt, mesh, prm, p0, coefs = _line_setup(dev, n, 4 if moving else 128,
                                               4.0 if moving else 1.0e3)
        return dt, mesh, prm, p0, coefs, transport_kernel.launch_name(1, False)
    if route == "2d_smr":
        dt, mesh, prm, p0, coefs = _smr_setup(dev, 2, False, False, n=n)
        if moving:
            nc = mesh.total_cells
            coefs = TransportCoefs(sigma_a=torch.zeros(nc, device=dev),
                                   sigma_s=torch.full((nc,), 16.0, device=dev),
                                   fleck=torch.ones(nc, device=dev))
        return dt, mesh, prm, p0, coefs, transport_kernel.launch_name(2, False, False, True)
    ndim = 2 if route == "2d_abs" else 3
    kw = {"sigma_a": 4.0, "sigma_s": 12.0} if moving else {}
    if route == "2d_abs" and not moving:
        kw = {"sigma_a": 3.0, "sigma_s": 1.0e3}
    dt, mesh, prm, p0, coefs = _grid_setup(dev, ndim, n=n, **kw)
    return dt, mesh, prm, p0, coefs, transport_kernel.launch_name(ndim, True)


@pytest.mark.parametrize("size", ["path", "4x_resident", "moving"])
@pytest.mark.parametrize("route", ["1d", "2d_abs", "2d_smr", "3d_abs"])
def test_imc_targets_bitwise_after_a_full_census(gpu, route, size):
    """transport_1d, transport_2d_abs, transport_2d_smr and transport_3d_abs against
    their plain versions after a full census, identical in every column, events
    and iterations: on ledgers of their paths' size (100k lanes, 150k on the 2D
    feedback path's mesh, 2^18 in 3D) from the start of a step; on 4 times the
    card's resident threads over the last 10 % of a step; and on a ledger that
    changes cell, block and wall often."""
    n = {"path": {"2d_abs": 150_000, "3d_abs": 1 << 18}.get(route, 100_000), "moving": 100_000,
         "4x_resident": 4 * _resident_lanes(gpu)}[size]
    dt, mesh, prm, p0, coefs, name = _imc_target(gpu, route, n, size == "moving")
    if size == "4x_resident":
        g = torch.Generator(device=gpu).manual_seed(n)
        p0.tau.copy_(0.9 + 0.1 * torch.rand(p0.capacity, generator=g, device=gpu))
    before = cuda_lib.LAUNCHES[name]
    k, it_k, ev_k = transport_kernel.transport(p0.clone(), coefs, mesh, 8080, prm, dt)
    q, it_q, ev_q = transport_kernel.transport_plain(p0.clone(), coefs, mesh, 8080, prm, dt)
    assert cuda_lib.LAUNCHES[name] == before + 1
    _same_round(k, q, it_k, ev_k, it_q, ev_q)
    assert not bool((k.tau[k.alive] < 1.0).any())
    live = p0.alive
    if route in ("1d", "2d_smr"):
        moved = float((k.block != p0.block)[live].float().mean())
        assert moved > ({"1d": 0.2, "2d_smr": 0.5}[route] if size == "moving" else 0.0), moved
    elif size == "moving":
        assert 0 < int(k.absorbed.sum())
        if route == "3d_abs":
            assert 0 < int((live & ~k.alive & ~k.absorbed).sum())  # escaped through z


def test_1d_lanes_that_never_scatter_keep_their_transverse_velocity(gpu):
    """transport_1d sets a lane's vy and vz from its last scatter when its history
    ends: over the last 0.1 % of a step at sigma_s = 1e3 about a third of the
    lanes reach census without a scatter and keep the bits of their own vy and vz
    (drawn here at random, unrelated to vx), the others end with c sqrt(1 - mu^2)
    and 0; kernel and plain identical in every column."""
    dt, mesh, prm, p0, coefs, name = _imc_target(gpu, "1d", 100_000, False)
    g = torch.Generator(device=gpu).manual_seed(99)
    p0.tau.copy_(0.999 + 0.001 * torch.rand(p0.capacity, generator=g, device=gpu))
    p0.vy.copy_(C * torch.rand(p0.capacity, generator=g, device=gpu))
    p0.vz.copy_(C * torch.rand(p0.capacity, generator=g, device=gpu))
    before = cuda_lib.LAUNCHES[name]
    k, it_k, ev_k = transport_kernel.transport(p0.clone(), coefs, mesh, 4242, prm, dt)
    q, it_q, ev_q = transport_kernel.transport_plain(p0.clone(), coefs, mesh, 4242, prm, dt)
    assert cuda_lib.LAUNCHES[name] == before + 1
    _same_round(k, q, it_k, ev_k, it_q, ev_q)
    live = p0.alive
    kept = live & (k.vy == p0.vy) & (k.vz == p0.vz)
    scattered = live & (k.vz == 0.0)
    assert int(kept.sum()) > 0.1 * int(live.sum()) and int(scattered.sum()) > 0.1 * int(live.sum())


def test_census_words_kernel_matches_plain(gpu):
    """K2's census-words probe against its plain version: per-lane event counts
    from 0 to 99 on 5000 lanes, three words an event."""
    ev = torch.as_tensor(np.random.default_rng(3).integers(0, 100, 5000), dtype=torch.int32)
    before = cuda_lib.LAUNCHES["census_words"]
    got = kernel_rng.census_words(-4321, ev.to(gpu), 3).cpu()
    assert cuda_lib.LAUNCHES["census_words"] == before + 1
    assert torch.equal(got, kernel_rng.census_words_plain(-4321, ev, 3))



# ------------------------------ the counters without a fill, the non-gray record


def _same_counts(it_k, ev_k, it_q, ev_q):
    assert torch.equal(it_k.cpu(), it_q.cpu()) and torch.equal(ev_k.cpu(), ev_q.cpu()), (
        it_k, ev_k, it_q, ev_q)


def test_counters_over_back_to_back_calls(gpu):
    """The census counters are zeroed on the stream, by the table's launch where the
    call launches a table and else by the launch entry, with no PyTorch fill
    before either: ten calls on one stream and no synchronisation
    between them (a gray and a non-gray forest, uniform non-gray and gray meshes, a
    ledger with no live lane), twice over with other seeds, each with the plain
    version's events and iteration maximum exactly and its ledger bitwise."""
    cases = [_smr_setup(gpu, 2, True, False, seed=21), _nongray_setup(gpu, 1, False, False),
             _nongray_setup(gpu, 2, False, True), _grid_setup(gpu, 3)]
    dt, mesh, prm, p0, coefs = cases[0]
    dead = p0.clone()
    dead.alive.zero_()
    cases.append((dt, mesh, prm, dead, coefs))
    runs = [(case, seed, transport_kernel.transport(case[3].clone(), case[4], case[1], seed,
                                                     case[2], case[0]))
            for seed in (31, 32) for case in cases]
    torch.cuda.synchronize()
    for (dt, mesh, prm, p0, coefs), seed, (k, it_k, ev_k) in runs:
        q, it_q, ev_q = transport_kernel.transport_plain(p0.clone(), coefs, mesh, seed, prm, dt)
        _same_round(k, q, it_k, ev_k, it_q, ev_q)
    assert int(runs[4][2][2]) == 0 and all(int(r[2][2]) > 0 for r in runs[:4])


@pytest.mark.parametrize("case", ["two_groups", "empty_group"])
def test_counters_over_more_than_64_shards(gpu, case):
    """A call over 70 shards, each owning the whole gray level-1 forest with its own
    seed and slice: two launch groups (64 shards, then 6), each zeroing and
    counting its own shards; with ``empty_group`` the last six slices are empty,
    so the second group launches nothing and only zeroes its counters. Events and
    iteration maxima per shard exactly the plain version's over the same shards
    (itself the per-shard calls: tests/test_torch_schedule.py), every column
    bitwise."""
    from jaybenne_tpu_torch.parallel.sharding import split_ledger

    n_shards, m = 70, 512
    assert n_shards > transport_kernel.MAX_SHARDS_PER_LAUNCH
    dt, mesh, prm, p0, coefs = _smr_setup(gpu, 2, True, False, n=n_shards * m, seed=23)
    full = n_shards if case == "two_groups" else transport_kernel.MAX_SHARDS_PER_LAUNCH

    def slices(p):
        """The full slices, then empty ones at their end."""
        empty = dataclasses.replace(p, **{f.name: getattr(p, f.name)[full * m:full * m]
                                          for f in dataclasses.fields(p)})
        return split_ledger(p, n_shards)[:full] + [empty] * (n_shards - full)

    own = [transport_kernel.OwnedRange("blocks", 0, mesh.n_blocks)] * n_shards
    seeds = [7000 + 13 * s - (1 << 31) * (s % 2) for s in range(n_shards)]
    name = transport_kernel.launch_name(2, True, smr=True, route="@blocks")
    before = cuda_lib.LAUNCHES[name]
    k, q = p0.clone(), p0.clone()
    _, it_k, ev_k = transport_kernel.transport(slices(k), [coefs] * n_shards, mesh, seeds, prm,
                                               dt, own)
    assert cuda_lib.LAUNCHES[name] == before + (2 if full == n_shards else 1)
    _, it_q, ev_q = transport_kernel.transport_plain(slices(q), [coefs] * n_shards, mesh, seeds,
                                                     prm, dt, own)
    _same_counts(it_k, ev_k, it_q, ev_q)
    assert int(ev_q[:full].min()) > 0 and not bool(ev_q[full:].any())
    _same_bits(k, q)


@pytest.mark.parametrize("route", SHARD_ROUTES)
def test_counters_over_back_to_back_rounds(gpu, route):
    """Two spatial rounds over 8 shards back to back on one stream (the second with
    other seeds), then the same rounds by the plain version: each round's events
    and iteration maxima per shard exactly the plain version's, its ledger
    bitwise."""
    from test_torch_schedule import one_call_round, shard_case

    p0, coefs, mesh, seeds, prm, dt, owns = shard_case(route, 4096, dev=gpu)
    rounds = []
    for sd in (seeds, [s + 1 for s in seeds]):
        k = p0.clone()
        rounds.append((sd, k, one_call_round(transport_kernel.transport, k, coefs, mesh, sd,
                                             prm, dt, owns)))
    for sd, k, got in rounds:
        q = p0.clone()
        it_q, ev_q = one_call_round(transport_kernel.transport_plain, q, coefs, mesh, sd, prm, dt,
                                    owns)
        _same_counts(*got, it_q, ev_q)
        _same_bits(k, q)
        assert int(ev_q.sum()) > 0


def _memsets(fn):
    """The names of the memsets that ``fn()`` queues on the card, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if "memset" in e.name.lower()]


@pytest.mark.parametrize("case", ["table", "table_f64", "columns", "prepared"])
def test_census_counters_from_garbage(gpu, monkeypatch, case):
    """The census's counters made full of garbage (``census_counters``), so that
    only a zeroing on the stream gives the right counts: where the call launches a
    table (a uniform 3D mesh of several blocks, in float32 and float64) the table's
    launch zeroes them and the call queues no memset; where it launches none (a
    non-gray forest's record read from its columns) or takes a prepared census,
    the launch entry's memset does (and the profiler sees it). Events and the
    iteration maximum equal the plain version's, every column bitwise."""
    cs = _chip_smoke()
    if case == "columns":
        dt, mesh, prm, p0, coefs = _nongray_setup(gpu, 2, False, True)
    else:
        dt, mesh, prm, p0, coefs = _grid_setup(gpu, 3)
    if case == "table_f64":
        p0, coefs, prm = (cs.ledger_as(p0, torch.float64), cs.coefs_as(coefs, torch.float64),
                          cs.prm_as(prm, torch.float64))
    garbage = []

    def counters(n, device):
        garbage.append(torch.full((2 * n,), -0x5A5A5A5A5A5A5A5B, dtype=torch.int64,
                                  device=device))
        return garbage[-1]

    monkeypatch.setattr(transport_kernel, "census_counters", counters)
    args = (coefs, mesh, 77, prm, dt)
    if case == "prepared":
        args = (transport_kernel.prepare(coefs, mesh, prm, dt), mesh, 77, prm, dt)
    k = p0.clone()
    seen = _memsets(lambda: transport_kernel.transport(k, *args))
    assert len(garbage) == 1
    assert (not seen) if case.startswith("table") else bool(seen), seen
    it_k, ev_k = int(garbage[0][1:].view(torch.int32)[0]), int(garbage[0][0])
    q, it_q, ev_q = transport_kernel.transport_plain(p0.clone(), coefs, mesh, 77, prm, dt)
    assert (it_k, ev_k) == (int(it_q), int(ev_q))
    _same_bits(k, q)
    assert int(ev_q) > 0


# chip_smoke.py's phases 23 and 25: the ep_bremss overrides of
# tests/test_pallas.py:1402-1416 (and :1531-1546) on stepdiff at 128 cells in one
# block and on stepdiff_smr as shipped, 100k particles, one step
_EPB = {"mcblock/opacity_model": "ep_bremss", "mcblock/initial_temperature": "1.0e6",
        "mcblock/cv": "1.0e8", "mcblock/scattering_constant_value": "1.0e2",
        "jaybenne/do_emission": "false", "jaybenne/do_feedback": "false",
        "jaybenne/dt": "1.e-12", "parthenon/time/tlim": "1.e-12",
        "parthenon/output0/file_type": "none"}
_NG_PATHS = {
    "stepdiff.in": {**_EPB, "parthenon/mesh/nx1": 128, "parthenon/meshblock/nx1": 128,
                    "jaybenne/num_particles": 100000},
    "stepdiff_smr.in": {**_EPB, "jaybenne/use_ddmc": "false"},
}


@pytest.mark.parametrize("deck", sorted(_NG_PATHS))
def test_nongray_path_census_bitwise(gpu, tmp_path, deck):
    """The census of phases 23 (``transport_1d_abs_ng``) and 25
    (``transport_2d_abs_smr_ng``) on the path's own inputs: the kernel, which reads
    the record straight from the coefficient columns there (no table launch),
    against its plain version, every column bitwise, the same events and
    iteration maximum."""
    recorded = []
    real = transport_kernel.transport

    def keep(p, *args):
        (one,) = p  # one device: the step passes a list of one ledger
        recorded.append((one.clone(), args))
        return real(p, *args)

    transport_kernel.transport = keep
    try:
        run_file(os.path.join(_ROOT, "inputs", deck), outdir=str(tmp_path),
                 modified_inputs=_NG_PATHS[deck], quiet=True, nlim=1, device="cuda")
    finally:
        transport_kernel.transport = real
    (p0, args), = recorded
    coefs, mesh, prm = args[0], args[1], args[3]
    assert not coefs.is_gray and not prm.use_ddmc
    g = transport_kernel._geometry(mesh, prm, args[4], coefs, mesh.max_level > 0)
    assert transport_kernel.record_columns([coefs], mesh, g) is not None
    name = transport_kernel.launch_name(prm.ndim, True, False, mesh.max_level > 0, True)
    before = dict(cuda_lib.LAUNCHES)
    k, it_k, ev_k = transport_kernel.transport(p0.clone(), *args)
    assert cuda_lib.LAUNCHES[name] == before.get(name, 0) + 1
    assert cuda_lib.LAUNCHES["census_table"] == before.get("census_table", 0)
    q, it_q, ev_q = transport_kernel.transport_plain(p0.clone(), *args)
    _same_bits(k, q)
    _same_counts(it_k, ev_k, it_q, ev_q)
    assert int(ev_k) > 0


# ------------------------------------------------------------ precision = f64

# every float64 instantiation: (ndim, absorb, ddmc, smr, nongray)
F64_ROUTES = [(nd, ab, dd, smr, False) for nd in (1, 2, 3) for ab in (False, True)
              for dd in (False, True) for smr in (False, True)] + [
    (nd, True, dd, smr, True) for nd in (1, 2, 3) for dd in (False, True) for smr in (False, True)]


def _chip_smoke():
    import sys

    sys.path.insert(0, _ROOT)
    import chip_smoke

    return chip_smoke


def test_draws_f64_kernel_matches_plain(gpu):
    """Draw<double>: the float64 census's variates bitwise the plain float64 pool's
    on the card (the CPU's cos and log may round a double another way)."""
    g = torch.Generator().manual_seed(4)
    n = 1 << 15
    lane, it, tag = (torch.randint(0, hi, (n,), generator=g, dtype=torch.int32).to(gpu)
                     for hi in (1 << 31, 1 << 20, 24))
    got = kernel_rng.draws_f64_cuda(-777, lane, it, tag)
    want = kernel_rng.draws_f64_plain(-777, lane.long(), it.long(), tag.long())
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))


@pytest.mark.parametrize("route", F64_ROUTES,
                         ids=[transport_kernel.launch_name(*r, dtype=torch.float64)
                              for r in F64_ROUTES])
def test_f64_kernel_bitwise_plain(gpu, route):
    """Each float64 instantiation on chip_smoke's hybrid, SMR and EPBremss ledgers
    (phases 11, 15 and 22) made float64, 2^14 particles: bitwise its float64 plain
    version in every column after 8 iterations and after a full census, float64
    launches only."""
    cs = _chip_smoke()
    ndim, absorb, ddmc, smr, ng = route
    seed = 4100 + ndim
    if ng:
        cs.HYBRID_N = 1 << 14
        dt, mesh, prm, p0, coefs, _, _ = cs.nongray_setup(gpu, ndim, ddmc, smr, seed)
    elif smr:
        dt, mesh, prm, p0, coefs, _ = cs.smr_setup(gpu, ndim, absorb, ddmc, seed, n=1 << 14)
    else:
        dt, mesh, prm, p0, coefs, _ = cs.hybrid_setup(gpu, ndim, absorb, ddmc, seed, n=1 << 14)
    name = transport_kernel.launch_name(*route, dtype=torch.float64)
    err, events, _ = cs.f64_vs_plain(transport_kernel, gpu, name, p0, coefs, mesh, prm, dt, seed)
    assert err == 0.0 and events > 0


@pytest.mark.parametrize("deck, mods", [
    ("stepdiff.in", {"parthenon/mesh/nx1": 128, "parthenon/meshblock/nx1": 64}),
    ("stepdiff_ddmc.in", {"parthenon/mesh/nx1": 64, "parthenon/meshblock/nx1": 32}),
])
def test_f64_path_runs_through_kernel(gpu, tmp_path, deck, mods):
    """A float64 deck through run_file on the card: one float64 census launch and
    one float64 table launch a step, one insert pass (three launches) a run (the
    initial radiation's births; the insert kernel copies bytes of either width), one
    tally pass (three launches) a step and the initial radiation's, one face launch
    a DDMC step, one count launch a step (the tally, face and count kernels count
    either precision under one name) and no other, float64 state, a bitwise
    rerun."""
    mods = {**mods, "jaybenne/num_particles": 20000, "parthenon/output0/file_type": "none",
            "jaybenne/precision": "f64"}
    cuda_lib.LAUNCHES.clear()
    sims = [run_file(os.path.join(_ROOT, "inputs", deck), outdir=str(tmp_path),
                     modified_inputs=mods, quiet=True, nlim=3, device="cuda") for _ in range(2)]
    name = transport_kernel.launch_name(1, False, deck == "stepdiff_ddmc.in",
                                        dtype=torch.float64)
    faces = {"ddmc_face_probs": 6} if deck == "stepdiff_ddmc.in" else {}
    assert dict(cuda_lib.LAUNCHES) == {name: 6, "census_table_f64": 6, "ledger_insert": 6,
                                       "tally": 24, "round_counts": 6, **faces}
    a, b = (s.state.fields.energy_tally for s in sims)
    assert a.dtype == torch.float64 and sims[0].state.particles.x.dtype == torch.float64
    assert torch.equal(a, b)


@pytest.mark.parametrize("layout", ["one_block_1d", "uniform_3d", "uniform_64",
                                    "uniform_64_pair"])
def test_f64_census_table_kernel_matches_plain(gpu, layout):
    """The float64 table pass bitwise its plain version (chip_smoke.table_check) on
    the gray DDMC record of a uniform mesh, and on bench.py's 64^3 mesh in 8^3
    blocks (tests/test_torch_table.py's coefficients made float64) with the gray
    DDMC record and the gray pair."""
    cs = _chip_smoke()
    if layout.startswith("uniform_64"):
        from test_torch_table import table_case

        kind = "pair_abs" if layout.endswith("pair") else "ddmc_abs"
        coefs, mesh, prm, dt, _, _ = table_case(kind, "uniform_64", dev=gpu)
    else:
        ndim = 1 if layout == "one_block_1d" else 3
        dt, mesh, prm, _, coefs, _ = cs.hybrid_setup(gpu, ndim, True, True, 11, n=1024)
    before = cuda_lib.LAUNCHES["census_table_f64"]
    cs.table_check(transport_kernel, gpu, cs.coefs_as(coefs, torch.float64), mesh,
                   cs.prm_as(prm, torch.float64), dt, None, f"{layout} f64")
    assert cuda_lib.LAUNCHES["census_table_f64"] > before


# the resident blocks of 256 a SM of the 36 float32 instantiations on an NVIDIA H100
# 80GB HBM3 (chip_smoke.py phase 2), which the float64 lean lane leaves as they were:
# (ndim, smr) -> those of (gray, abs, ddmc, abs_ddmc, abs_ng, abs_ddmc_ng)
F32_RESIDENT = {(1, False): (8, 6, 6, 6, 6, 5), (1, True): (5, 5, 5, 5, 5, 5),
                (2, False): (6, 5, 5, 5, 5, 5), (2, True): (4, 4, 4, 3, 4, 3),
                (3, False): (4, 4, 4, 4, 4, 4), (3, True): (4, 3, 2, 2, 3, 2)}
F32_MODES = ((False, False, False), (True, False, False), (False, True, False),
             (True, True, False), (True, False, True), (True, True, True))


@pytest.mark.parametrize("route", F64_ROUTES,
                         ids=[transport_kernel.launch_name(*r, dtype=torch.float64)
                              for r in F64_ROUTES])
def test_f64_register_budget_held(gpu, route):
    """Each float64 instantiation is resident: the redesigned routes
    (``chip_smoke.F64_RESIDENT_FLOOR``: transport_2d_smr_f64 and
    transport_1d_smr_f64 for the register file, transport_1d_f64,
    transport_1d_ddmc_f64 and transport_2d_abs_smr_ng_f64 on the resident grid)
    hold at least 3, 4, 4, 4 and 3 blocks of 256 a SM on an H100, with no spill
    bytes (ptxas's lines of the library's build)."""
    cs = _chip_smoke()
    name = transport_kernel.launch_name(*route, dtype=torch.float64)
    floor = cs.F64_RESIDENT_FLOOR.get(name)
    blocks = transport_kernel.resident_blocks(*route, dtype=torch.float64)
    assert blocks >= 1
    if floor is None:
        return
    if "H100" not in torch.cuda.get_device_name(gpu):
        pytest.skip("the floors are an H100's")
    r = cs.kernel_resources(cuda_lib.library().build_log, transport_kernel)[name]
    assert blocks >= floor, (blocks, r)
    assert r["spill_stores"] == 0 and r["spill_loads"] == 0, r


@pytest.mark.parametrize("ndim, smr", sorted(F32_RESIDENT))
def test_f32_resident_blocks_unchanged(gpu, ndim, smr):
    """The float32 instantiations hold the resident blocks they held before the
    float64 lean lane, on an H100."""
    if "H100" not in torch.cuda.get_device_name(gpu):
        pytest.skip("the resident blocks are an H100's")
    got = tuple(transport_kernel.resident_blocks(ndim, *mode[:2], smr, mode[2])
                for mode in F32_MODES)
    assert got == F32_RESIDENT[(ndim, smr)]


# the float64 routes redesigned, each on its path's recorded census (deck, overrides,
# the census kept); "_4x", on that census's ledger four times over (the copies in
# other slots, so other draws): several waves of blocks, one thread a slot;
# "_flipped", on that ledger in reverse slot order: its live lanes at the end, so a
# route that runs in rounds meets live lanes in two rounds
_F64_PATHS = {
    "stepdiff": ("DECK", "GATE", 2),
    "stepdiff_ddmc": ("DDMC_DECK", "DDMC_GATE", 2),
    "stepdiff_smr": ("SMR_DECK", "SMR_GATE", 2),
}


def _flipped(p):
    """The ledger ``p`` in reverse slot order."""
    return dataclasses.replace(p, **{f.name: getattr(p, f.name).flip(0)
                                     for f in dataclasses.fields(p)})


@pytest.mark.parametrize("path", ["stepdiff_smr", "stepdiff_spatial", "stepdiff",
                                  "stepdiff_ddmc", "stepdiff_4x", "stepdiff_ddmc_4x",
                                  "stepdiff_flipped", "stepdiff_ddmc_flipped"])
def test_redesigned_f64_routes_bitwise_at_path_shapes(gpu, tmp_path, path):
    """The redesigned float64 routes on their paths' own inputs, bitwise their
    float64 plain version in every column: transport_2d_smr_f64 on stepdiff_smr's
    second census, transport_1d_f64 on stepdiff's (128 cells, 100k particles) and
    transport_1d_ddmc_f64 on stepdiff_ddmc's (``chip_smoke.f64_vs_plain``: after 8
    iterations and after a full census of the last 10 % of a step; the 1D routes
    also on the whole recorded census, with its events and iteration maximum, on
    its ledger four times over, several waves of blocks, and on it in reverse slot
    order, live lanes in two rounds of the resident grid), and
    transport_1d_smr_f64@blocks on the first round of stepdiff at 8 spatial shards
    (``chip_smoke.owned_vs_plain``)."""
    cs = _chip_smoke()
    base = path.removesuffix("_4x").removesuffix("_flipped")
    if base in _F64_PATHS:
        deck, mods, keep = _F64_PATHS[base]
        with cs.CensusRecorder(transport_kernel, keep) as rec:
            run_file(getattr(cs, deck), outdir=str(tmp_path),
                     modified_inputs={**getattr(cs, mods), **cs.PREC64}, quiet=True, nlim=keep,
                     device="cuda", graph=False)
        p0, (coefs, mesh, seed, prm, dt) = rec.inputs
        if path.endswith("_4x"):
            import census_bench  # beside chip_smoke.py

            p0 = census_bench.times_over(p0, 4)
            assert -(-p0.capacity // transport_kernel.THREADS) > _resident_lanes(gpu) // 256
        if path.endswith("_flipped"):
            p0 = _flipped(p0)
            assert bool(p0.alive[-1]) and not bool(p0.alive[0])
        name = transport_kernel.launch_name(prm.ndim, bool(prm.has_absorption),
                                            bool(prm.use_ddmc), mesh.max_level > 0,
                                            dtype=torch.float64)
        err, events, _ = cs.f64_vs_plain(transport_kernel, gpu, name, p0, coefs, mesh, prm, dt,
                                         seed)
        if base != "stepdiff_smr":
            before = cuda_lib.LAUNCHES[name]
            k, it_k, ev_k = transport_kernel.transport(p0.clone(), coefs, mesh, seed, prm, dt)
            assert cuda_lib.LAUNCHES[name] == before + 1
            q, it_q, ev_q = transport_kernel.transport_plain(p0.clone(), coefs, mesh, seed, prm,
                                                             dt)
            _same_bits(k, q)
            _same_counts(it_k, ev_k, it_q, ev_q)
    else:
        name = transport_kernel.launch_name(1, False, False, True, route="@blocks",
                                            dtype=torch.float64)
        _, launches, (p0, n, args), _, _ = cs.spatial_path(
            cs.DECK, {**cs.STEPDIFF_SPATIAL, **cs.PREC64}, 1, name)
        assert launches.get(name, 0) > 0
        _, events, err = cs.owned_vs_plain(transport_kernel, name, p0, args, n)
    assert p0.x.dtype == torch.float64 and err == 0.0 and events > 0


# ------------------------------------------------ the step without the host


def test_plain_census_deck_runs_eagerly_on_the_card(gpu, tmp_path):
    """``use_pallas = off`` on the card through run_file for 3 steps: the plain
    census reads its exit test, so the step is not captured (``capturable`` is
    false) and runs eagerly past the step a graph would capture, with no census
    launch, and a rerun is bitwise identical."""
    mods = {"parthenon/mesh/nx1": 64, "parthenon/meshblock/nx1": 64,
            "jaybenne/num_particles": 20000, "jaybenne/use_pallas": "off",
            "parthenon/output0/file_type": "none"}
    cuda_lib.LAUNCHES.clear()
    sims = [run_file(STEPDIFF, outdir=str(tmp_path), modified_inputs=mods, quiet=True,
                     nlim=3, device="cuda") for _ in range(2)]
    assert not any(s.graphed for s in sims) and [s.cycle for s in sims] == [3, 3]
    assert not any(k.startswith("transport") for k in cuda_lib.LAUNCHES)
    a, b = (s.state.fields.energy_tally for s in sims)
    assert torch.isfinite(a).all() and torch.equal(a, b)


_INSERT_PATHS = {  # (deck, overrides, steps, the candidates recorded, calls kept)
    "stepdiff_initial_source": (STEPDIFF, {"parthenon/mesh/nx1": 128,
                                           "parthenon/meshblock/nx1": 64}, 0, None, 1),
    "spatial_migration": (STEPDIFF, {"parthenon/mesh/nx1": 32, "parthenon/meshblock/nx1": 4,
                                     "jaybenne/decomposition": "spatial",
                                     "jaybenne/n_devices": 4, "jaybenne/dt": "1.e-11",
                                     "mcblock/scattering_constant_value": 200.0},
                          1, "face", 4),
    "f64_initial_source": (STEPDIFF, {"parthenon/mesh/nx1": 128, "parthenon/meshblock/nx1": 64,
                                      "jaybenne/precision": "f64"}, 0, None, 1),
}


@pytest.mark.parametrize("path", sorted(_INSERT_PATHS))
def test_insert_kernel_matches_plain_on_path_shapes(gpu, tmp_path, path):
    """The insert kernel bitwise its plain version (chip_smoke.inserts_bitwise) on
    the writes a run makes: the initial thermal source's [cells, candidates a
    cell] grid with its broadcast columns, the spatial migration arrivals (with
    ``reserved``; face and leak carried) and a float64 ledger."""
    cs = _chip_smoke()
    deck, mods, steps, key, keep = _INSERT_PATHS[path]
    mods = {**mods, "jaybenne/num_particles": 8000, "parthenon/output0/file_type": "none"}
    calls = cs.recorded_inserts(
        lambda: run_file(deck, outdir=str(tmp_path), modified_inputs=mods, quiet=True,
                         nlim=steps, device="cuda", graph=False),
        lambda cand: key is None or key in cand, keep)
    cs.inserts_bitwise(calls, path)
    if key is None:  # the grid: candidates along a row, per-cell columns broadcast
        shape = calls[0].valid.shape
        assert len(shape) == 2 and shape[1] > 1
        assert any(0 in v.stride() for v in calls[0].cand.values())
    else:  # every local shard in one pass
        assert all(c.m == 4 for c in calls)


@pytest.mark.parametrize("fill", ["empty", "mixed", "full", "none_valid"])
@pytest.mark.parametrize("wide", [False, True], ids=["f32", "f64"])
def test_insert_one_pass_over_shards_matches_plain(gpu, fill, wide):
    """The insert kernel's one pass over eight adjacent shard slices (a migration
    round's arrivals: strided candidate views of one buffer of int32 words, the
    valid flag its last word, the absorbed rows reserved) against its plain
    version a shard at a time: every column and each shard's drop count bitwise,
    three launches; slices with room, full slices and no valid candidate."""
    from jaybenne_tpu_torch.parallel.sharding import split_ledger
    from jaybenne_tpu_torch.particles import insert_arrivals

    m, cap_l, nc = 8, 5000, 3100  # the tiles of a slice and of a part end mid-tile
    dt = torch.float64 if wide else torch.float32
    g = torch.Generator(device=gpu).manual_seed(19 + wide)
    p0 = empty_ledger(m * cap_l, dt, gpu)
    share = {"empty": 0.0, "mixed": None, "full": 1.0, "none_valid": 0.5}[fill]
    rows = torch.arange(m * cap_l, device=gpu) // cap_l
    p0.alive.copy_(torch.rand(m * cap_l, generator=g, device=gpu)
                   < (0.12 * rows if share is None else share))
    p0.absorbed.copy_(torch.rand(m * cap_l, generator=g, device=gpu) < 0.2)
    names = ("x", "y", "z", "vx", "vy", "vz", "tau", "weight", "energy", "block", "i", "j",
             "k", "face", "leak")
    width = sum(getattr(p0, k).element_size() // 4 for k in names)
    width += 1 + (width + 1) % 2 * wide  # the valid word, the row even in float64
    buf = torch.randint(-9, 9, (m * nc, width), generator=g, device=gpu, dtype=torch.int32)
    valid = torch.rand(m * nc, generator=g, device=gpu) < (0.0 if fill == "none_valid" else 0.6)
    buf[:, -1] = valid.to(torch.int32)
    cand, c = {}, 0
    for k in names:
        w = getattr(p0, k).element_size() // 4
        cand[k] = buf[:, c:c + w].view(getattr(p0, k).dtype)[:, 0]
        c += w
    a, b = p0.clone(), p0.clone()
    before = cuda_lib.LAUNCHES["ledger_insert"]
    da = insert_arrivals(split_ledger(a, m), cand, buf[:, -1])
    assert cuda_lib.LAUNCHES["ledger_insert"] == before + 3
    db = insert_arrivals(split_ledger(b, m), cand, buf[:, -1], plain=True)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8)), f.name
    assert torch.equal(da, db)
    if fill == "full":
        assert int(da.sum()) == int(valid.sum())
    if fill == "mixed":
        assert int(da[0]) == 0 and int(da[-1]) > 0


@pytest.mark.parametrize("lanes", ["small", "past_the_resident_lanes"])
def test_k4s_round_spread_matches_plain(gpu, lanes):
    """A K4s round (transport_2d_ddmc_smr@blocks over 8 shards) with its shards'
    slot groups interleaved over the card's first wave (fewer blocks than it
    holds, and more), with dead, finished and unowned slots among them, against
    the plain round: every column bitwise, pending-leak codes included, the same
    iterations and events per shard."""
    from test_torch_schedule import one_call_round, shard_case

    m = 600 if lanes == "small" else -(-4 * _resident_lanes(gpu) // 8)
    p0, coefs, mesh, seeds, prm, dt, owns = shard_case("blocks", m, dev=gpu)
    p0.alive[::7] = False
    p0.tau[::5] = 1.0
    p0.block[::11] = (p0.block[::11] + owns[0].n) % mesh.n_blocks
    name = transport_kernel.launch_name(2, False, True, True, route="@blocks")
    assert name in transport_kernel.SPREAD_ROUTES
    before = cuda_lib.LAUNCHES[name]
    k, q = p0.clone(), p0.clone()
    it_k, ev_k = one_call_round(transport_kernel.transport, k, coefs, mesh, seeds, prm, dt, owns)
    assert cuda_lib.LAUNCHES[name] == before + 1
    it_q, ev_q = one_call_round(transport_kernel.transport_plain, q, coefs, mesh, seeds, prm,
                                dt, owns)
    _same_round(k, q, it_k, ev_k, it_q, ev_q)
    assert bool((k.leak != 0).any())


# ------------------------------------------------ the spatial step as CUDA graphs

# two in-process spatial shards whose ledgers grow after the step was captured
# (births outrun absorption): an SMR+DDMC forest with emission (the block route,
# its fixup generators, pending coarse-to-fine leaks), and Su-Olson's slab in two
# blocks with its source window closing in the fifth step (a partial, then empty
# windows; the source box in shard 0's block)
_SPATIAL_GRAPH_PATHS = {  # (deck, overrides, steps)
    "smr_ddmc_2_shards": (os.path.join(_ROOT, "inputs", "stepdiff_smr_ddmc.in"), {
        "parthenon/mesh/nx1": 32, "parthenon/mesh/nx2": 16, "parthenon/meshblock/nx1": 8,
        "parthenon/meshblock/nx2": 8, "jaybenne/num_particles": 3000, "jaybenne/dt": "1.e-11",
        "parthenon/time/tlim": "1.e-10", "jaybenne/do_emission": "true",
        "mcblock/opacity_model": "constant", "mcblock/opacity_constant_value": 1e-3,
        "jaybenne/capacity_factor": 1}, 6),
    "suolson_2_shards": (os.path.join(_ROOT, "inputs", "suolson.in"), {
        "parthenon/meshblock/nx1": 32, "parthenon/swarm/ox1_bc": "jaybenne_reflecting",
        "mcblock/opacity_constant_value": 1.0, "jaybenne/capacity_factor": 1,
        "jaybenne/external_source_tmax": "4.5e-12"}, 7),
}


@pytest.mark.parametrize("path", sorted(_SPATIAL_GRAPH_PATHS))
def test_spatial_graph_matches_eager(gpu, tmp_path, path):
    """The spatial step at 2 in-process shards through run_file, eager and as CUDA
    graphs (``GraphedSpatialStep``) side by side: every field, ledger column,
    counter and overflow bitwise equal after every step (chip_smoke.same_states),
    the same launches a step, a replay, and a capture again after the ledger
    grew."""
    cs = _chip_smoke()
    deck, mods, steps = _SPATIAL_GRAPH_PATHS[path]
    mods = {**mods, "jaybenne/decomposition": "spatial", "jaybenne/n_devices": 2,
            "parthenon/output0/file_type": "none"}
    sims = [run_file(deck, outdir=str(tmp_path), modified_inputs=mods, quiet=True, nlim=0,
                     device="cuda", graph=g) for g in (False, True)]
    eager, graph = sims
    assert not eager.graphed and graph.graphed
    kinds, caps = [], []
    for _ in range(steps):
        before = graph.step_fn.captures
        launches = []
        for sim in sims:
            cuda_lib.LAUNCHES.clear()
            sim.run(nlim=1)
            launches.append(dict(cuda_lib.LAUNCHES))
        kinds.append("eager" if len(graph.history) == 1 else
                     "capture" if graph.step_fn.captures > before else "replay")
        caps.append(graph.state.particles.capacity)
        assert launches[0] == launches[1], (path, graph.cycle, launches)
        assert any(k.startswith("transport") for k in launches[1])
        cs.same_states(eager, graph, path)
    grown = [k for k in range(2, steps) if caps[k] != caps[k - 1]]
    assert grown and all(kinds[k] == "capture" for k in grown), (kinds, caps)
    assert "replay" in kinds, kinds
    assert sum(h["migrated"] for h in graph.history) > 0
    if "suolson" in path:  # past the source's cutoff
        assert graph.t > graph.cfg.jaybenne.external_source_tmax + graph.cfg.jaybenne.dt


# ---------------------------------------- the migration's sort and pack, by scans

# local shards, shards, slots a shard, blocks a shard, the first shard's first
# block, K, alive share, float64, go (tests/test_torch_migrate_scan.py's cases)
_MIGRATE_CASES = {
    "n8_several_tiles": (8, 8, 9000, 4, 0, 2000, 0.6, False, True),
    "n8_overflow": (8, 8, 5000, 2, 0, 30, 0.8, False, True),
    "n3": (3, 3, 2100, 2, 0, 400, 0.7, False, True),
    "go_false": (8, 8, 5000, 2, 0, 300, 0.7, False, False),
    "f64": (8, 8, 5000, 3, 0, 500, 0.6, True, True),
    "f64_overflow": (8, 8, 3000, 3, 0, 10, 0.9, True, True),
    "one_of_four": (1, 4, 7000, 5, 10, 200, 0.7, False, True),
    # slices of 64 tiles and more: the look-back crosses many windows of 32
    "n2_many_tiles": (2, 2, 70000, 3, 0, 18000, 0.5, False, True),
    "n8_many_tiles_f64": (8, 8, 66000, 2, 0, 3000, 0.6, True, True),
}


def _migrate_ledger(gpu, case, rng):
    """A random joined ledger of ``_MIGRATE_CASES[case]``'s shape on the card:
    half of the live slots in their own shard's blocks, the rest anywhere."""
    m, n, cap_l, bl, off0, K, share, wide, go = _MIGRATE_CASES[case]
    cap = m * cap_l
    p0 = empty_ledger(cap, torch.float64 if wide else torch.float32, gpu)
    for k in ("x", "y", "z", "vx", "vy", "vz", "tau", "weight", "energy"):
        getattr(p0, k).copy_(torch.from_numpy(rng.standard_normal(cap)))
    for k in ("i", "j", "k", "face", "leak"):
        getattr(p0, k).copy_(torch.from_numpy(rng.integers(-3, 9, cap)))
    shard = np.arange(cap) // cap_l
    own = off0 + shard * bl + rng.integers(0, bl, cap)
    p0.block.copy_(torch.from_numpy(np.where(rng.random(cap) < 0.5, own,
                                             rng.integers(0, n * bl, cap))))
    p0.alive.copy_(torch.from_numpy(rng.random(cap) < share))
    p0.absorbed.copy_(torch.from_numpy(rng.random(cap) < 0.1))
    return p0


def _pack_bitwise(buf, flags, sent, want, plain_sent):
    """The kernel's pack against the plain version's (``pack_plain``'s buffers
    stacked in the receivers' layout): the sent counts equal, the flags its valid
    column, and every row whose flag is set bitwise the plain row."""
    valid = want[..., -1] == 1
    assert buf.shape == want.shape and flags.shape == valid.shape and flags.dtype == torch.bool
    assert torch.equal(sent, plain_sent)
    assert torch.equal(flags, valid)
    assert torch.equal(buf[valid], want[valid])
    return valid


@pytest.mark.parametrize("case", sorted(_MIGRATE_CASES))
def test_migrate_kernel_matches_plain(gpu, case):
    """The migration kernel's one launch over every local shard
    (csrc/migrate_kernel.cu) against its plain version's stable sort on random
    ledgers: the ledger after it and the sent counts bitwise, the flags the plain
    buffers' valid column, every row whose flag is set bitwise the plain row, in
    the receivers' layout (as the in-process exchange stacks the plain buffers);
    then the whole round through the in-process exchange and the insert, every
    column and the dropped and sent counts bitwise."""
    from jaybenne_tpu_torch.parallel import exchange, spatial
    from jaybenne_tpu_torch.parallel.sharding import split_ledger

    m, n, cap_l, bl, off0, K, share, wide, go = _MIGRATE_CASES[case]
    p0 = _migrate_ledger(gpu, case, np.random.default_rng(sorted(_MIGRATE_CASES).index(case)))
    offsets = [off0 + s * bl for s in range(m)]
    flag = torch.tensor(go, device=gpu)
    a, b = p0.clone(), p0.clone()
    before = cuda_lib.LAUNCHES["migrate_pack"]
    buf, flags, sent = spatial._pack_cuda(split_ledger(a, m), offsets, bl, K, n, flag)
    assert cuda_lib.LAUNCHES["migrate_pack"] == before + 1
    want, plain_sent = spatial.pack_plain(split_ledger(b, m), offsets, bl, K, n, flag)
    want = torch.stack(want, dim=1)
    assert buf.shape == (n, m, K, spatial.row_words(p0))
    valid = _pack_bitwise(buf, flags, sent, want, plain_sent)
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name
    if go:
        assert int(sent.sum()) > 0
        if "overflow" in case:
            assert int(sent.max()) == K * (n - 1)
    else:
        assert int(sent.sum()) == 0 and not bool(valid.any())
    if m == n:  # every shard in this process: the in-process round, and the round
        # through an exchange that takes each local shard's buffer, as Distributed does
        class Senders(exchange.Exchange):
            def all_to_all(self, xs):
                return torch.stack(list(xs), dim=1)

        senders = Senders()
        senders.n = n
        b = p0.clone()
        db, sb = spatial.migrate(split_ledger(b, m), offsets, bl, K, exchange.InProcess(n), flag,
                                 plain=True)
        for ex in (exchange.InProcess(n), senders):
            a = p0.clone()
            da, sa = spatial.migrate(split_ledger(a, m), offsets, bl, K, ex, flag)
            assert torch.equal(da, db) and torch.equal(sa, sb)
            for f in dataclasses.fields(a):
                x, y = getattr(a, f.name), getattr(b, f.name)
                assert torch.equal(x.view(torch.uint8), y.view(torch.uint8)), f.name


def test_migrate_kernel_graph_replays(gpu):
    """The migration kernel's launch captured in a CUDA graph with the scratch of
    a step (``MigrateScratch``, made before the capture) and replayed on fresh
    ledgers copied into the captured one: twice with go true, each bitwise the
    plain pack (sent, flags, rows, the ledger after it), with an eager launch on
    the same scratch between them; then once with go false, which changes no
    column and sets no flag. The status words and the ticket are left ready by
    every launch, and no memset is queued."""
    from jaybenne_tpu_torch.parallel import spatial
    from jaybenne_tpu_torch.parallel.sharding import split_ledger

    case = "n8_several_tiles"
    m, n, cap_l, bl, off0, K = _MIGRATE_CASES[case][:6]
    offsets = [off0 + s * bl for s in range(m)]
    rng = np.random.default_rng(31)
    led = _migrate_ledger(gpu, case, rng)
    go = torch.ones((), dtype=torch.bool, device=gpu)
    work = spatial.MigrateScratch().reserve(m, cap_l, n, gpu)

    def pack():
        return spatial._pack_cuda(split_ledger(led, m), offsets, bl, K, n, go, work)

    pack()  # builds the library, warms the launch
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        buf, flags, sent = pack()
    for k, (flag, eager) in enumerate(((True, True), (True, False), (False, False))):
        fresh = _migrate_ledger(gpu, case, rng)
        for f in dataclasses.fields(led):
            getattr(led, f.name).copy_(getattr(fresh, f.name))
        go.fill_(flag)
        graph.replay()
        torch.cuda.synchronize()
        plain = fresh.clone()
        want, plain_sent = spatial.pack_plain(split_ledger(plain, m), offsets, bl, K, n, go)
        valid = _pack_bitwise(buf, flags, sent, torch.stack(want, dim=1), plain_sent)
        for f in dataclasses.fields(led):
            assert torch.equal(getattr(led, f.name), getattr(plain, f.name)), (k, f.name)
        if flag:
            assert int(sent.sum()) > 0
        else:
            assert int(sent.sum()) == 0 and not bool(valid.any())
            for f in dataclasses.fields(led):
                assert torch.equal(getattr(led, f.name), getattr(fresh, f.name)), f.name
        if eager:  # the same scratch between two replays
            other = _migrate_ledger(gpu, case, rng)
            q, r = other.clone(), other.clone()
            got = spatial._pack_cuda(split_ledger(q, m), offsets, bl, K, n, go, work)
            want2, sent2 = spatial.pack_plain(split_ledger(r, m), offsets, bl, K, n, go)
            _pack_bitwise(*got, torch.stack(want2, dim=1), sent2)
            assert torch.equal(q.alive, r.alive)


@pytest.mark.parametrize("path", ["stepdiff_8_shards", "f64"])
def test_migrate_kernel_on_recorded_rounds(gpu, tmp_path, path):
    """The migration kernel bitwise its plain version (chip_smoke.migrations_bitwise)
    on the first two rounds of a step at 8 spatial shards as the eager step records
    them (the second a later round of a batch; each round's go a device flag, the
    first's open, as the head starts the unfinished count at 1), each again with
    go false: the ledgers, the sent and dropped counts and every valid row."""
    cs = _chip_smoke()
    mods = {"parthenon/mesh/nx1": 32, "parthenon/meshblock/nx1": 4,
            "jaybenne/decomposition": "spatial", "jaybenne/n_devices": 8,
            "jaybenne/num_particles": 8000, "jaybenne/dt": "1.e-11",
            "mcblock/scattering_constant_value": 200.0, "parthenon/output0/file_type": "none",
            **({"jaybenne/precision": "f64"} if path == "f64" else {})}
    calls = cs.recorded_migrations(
        lambda: run_file(STEPDIFF, outdir=str(tmp_path), modified_inputs=mods, quiet=True,
                         nlim=1, device="cuda", graph=False), 2)
    assert len(calls) == 2 and all(c.go is not None for c in calls) and bool(calls[0].go)
    cs.migrations_bitwise(calls, path)


@pytest.mark.parametrize("ledger", ["recorded", "flipped", "2x"])
def test_nongray_f64_forest_route_bitwise(gpu, tmp_path, ledger):
    """transport_2d_abs_smr_ng_f64 on its path's recorded census (stepdiff_smr with
    ep_bremss in float64, chip_smoke.py phase 43's EPBremss step), which runs on
    the card's resident grid in rounds (its live lanes in the first), on that
    ledger in reverse slot order (live lanes in its last rounds) and on it twice
    over (past four rounds: one thread a slot): after 8 iterations and after a
    full census (chip_smoke.f64_vs_plain), and the whole census with its events
    and iteration maximum, every column bitwise its float64 plain version's."""
    cs = _chip_smoke()
    with cs.CensusRecorder(transport_kernel, 1) as rec:
        run_file(cs.SMR_DECK, outdir=str(tmp_path), modified_inputs={**cs.NG_SMR, **cs.PREC64},
                 quiet=True, nlim=1, device="cuda", graph=False)
    p0, (coefs, mesh, seed, prm, dt) = rec.inputs
    name = transport_kernel.launch_name(2, True, False, True, True, dtype=torch.float64)
    assert p0.x.dtype == torch.float64 and not coefs.is_gray and mesh.max_level > 0
    if ledger == "flipped":
        p0 = _flipped(p0)
    if ledger == "2x":
        import census_bench  # beside chip_smoke.py

        p0 = census_bench.times_over(p0, 2)
    blocks, rounds = transport_kernel.occupancy(2, True, False, True, True, torch.float64)
    sms = torch.cuda.get_device_properties(gpu).multi_processor_count
    grid = transport_kernel.launch_shape(p0.capacity, sms, blocks, rounds)[1]
    assert rounds == 4 and (grid > 0) == (ledger != "2x"), (blocks, rounds, grid)
    err, events, _ = cs.f64_vs_plain(transport_kernel, gpu, name, p0, coefs, mesh, prm, dt, seed)
    before = cuda_lib.LAUNCHES[name]
    k, it_k, ev_k = transport_kernel.transport(p0.clone(), coefs, mesh, seed, prm, dt)
    assert cuda_lib.LAUNCHES[name] == before + 1
    q, it_q, ev_q = transport_kernel.transport_plain(p0.clone(), coefs, mesh, seed, prm, dt)
    _same_bits(k, q)
    _same_counts(it_k, ev_k, it_q, ev_q)
    assert err == 0.0 and events > 0 and int(ev_k) > 0


# ------------------------------- the tally kernel and the face-probability kernel

@dataclasses.dataclass
class _TallyFields:
    energy_tally: torch.Tensor
    energy_delta: torch.Tensor


# (deck, overrides) of each mesh (tests/test_torch_tally_kernel.py's and
# tests/test_torch_face_map.py's), and bench.py's 64^3 mesh in 8^3 blocks
_PERIODIC = {f"parthenon/mesh/{s}x{k}_bc": "periodic" for s in "io" for k in "123"}
_PERIODIC_YZ = {f"parthenon/mesh/{s}x{k}_bc": "periodic" for s in "io" for k in "23"}
_SMR_FOREST = {"parthenon/mesh/nx1": 32, "parthenon/mesh/nx2": 16,
               "parthenon/meshblock/nx1": 8, "parthenon/meshblock/nx2": 8}
_BLOCKS_3D = {"parthenon/meshblock/nx1": 4, "parthenon/meshblock/nx2": 4,
              "parthenon/meshblock/nx3": 4}
_FACE_MESHES = {
    "1d": ("stepdiff_ddmc.in", {"parthenon/mesh/nx1": 32, "parthenon/meshblock/nx1": 8}),
    "2d": ("stepdiff_smr_ddmc.in", {**_SMR_FOREST, "parthenon/mesh/refinement": "none"}),
    "2d_periodic": ("stepdiff_smr_ddmc.in", {**_SMR_FOREST, **_PERIODIC,
                                             "parthenon/mesh/refinement": "none"}),
    "3d_periodic_yz": ("stepdiff.in", {"parthenon/mesh/nx1": 16, "parthenon/mesh/nx2": 8,
                                       "parthenon/mesh/nx3": 8, **_BLOCKS_3D, **_PERIODIC_YZ}),
    "refined_2d": ("stepdiff_smr_ddmc.in", _SMR_FOREST),
    "refined_2d_periodic": ("stepdiff_smr_ddmc.in", {**_SMR_FOREST, **_PERIODIC}),
    "refined_3d": ("stepdiff_3d_smr_ddmc.in", {"parthenon/mesh/nx1": 16,
                                               "parthenon/mesh/nx2": 8,
                                               "parthenon/mesh/nx3": 8, **_BLOCKS_3D}),
    "big_64": ("stepdiff.in", {"parthenon/mesh/nx1": 64, "parthenon/mesh/nx2": 64,
                               "parthenon/mesh/nx3": 64, "parthenon/meshblock/nx1": 8,
                               "parthenon/meshblock/nx2": 8, "parthenon/meshblock/nx3": 8,
                               **_PERIODIC_YZ}),
    "tally_2d": ("stepdiff.in", {"parthenon/mesh/nx1": 16, "parthenon/mesh/nx2": 8,
                                 "parthenon/meshblock/nx1": 4, "parthenon/meshblock/nx2": 4}),
}


def _mesh_of(name, dtype, dev):
    deck, mods = _FACE_MESHES[name]
    cfg = cm.from_deck(Deck.from_file(os.path.join(_ROOT, "inputs", deck)).update(dict(mods)))
    return cfg, build_mesh(cfg.mesh, dtype=dtype, device=dev)


def _tally_ledger(mesh, n, dtype, dev, seed):
    """n slots on ``dev``: 60 % alive, a fifth of the dead absorbed, weights over four
    orders of magnitude, in any block and cell."""
    rng = np.random.default_rng(seed)
    p = empty_ledger(n, dtype, dev)
    p.alive.copy_(torch.from_numpy(rng.random(n) < 0.6))
    p.absorbed.copy_(torch.from_numpy(rng.random(n) < 0.2).to(dev) & ~p.alive)
    p.weight.copy_(torch.from_numpy(10.0 ** rng.uniform(-3, 1, n)))
    p.block.copy_(torch.from_numpy(rng.integers(0, mesh.n_blocks, n)))
    for name, size in (("i", mesh.nx), ("j", mesh.ny), ("k", mesh.nz)):
        getattr(p, name).copy_(torch.from_numpy(rng.integers(0, size, n)))
    return p


# layout: (mesh, local shards, slots a shard, decomposition, deposit)
_TALLY_CASES = {
    "one_tally_only": ("tally_2d", 1, 5000, None, False),
    "one": ("tally_2d", 1, 5000, None, True),
    "particle4": ("tally_2d", 4, 3000, "particle", True),
    "spatial4": ("tally_2d", 4, 3000, "spatial", True),
    "spatial8_64cubed": ("big_64", 8, 25000, "spatial", True),
    "one_64cubed": ("big_64", 1, 200000, None, True),
    "hot_shared_2e20": ("tally_2d", 1, 1 << 20, None, True),  # 128 cells: shared bins
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", sorted(_TALLY_CASES))
def test_tally_kernel_matches_plain(gpu, case, dtype):
    """The tally kernel (csrc/tally_kernel.cu: the exponents, the sums, the cells;
    every local shard in one pass, the deposit and the tally together) bitwise its
    plain version (``tally.tallies(plain=True)``): one shard, four particle shards,
    four and eight spatial shards, the 64^3 mesh (global atomics) and 2^20 slots in
    128 cells (shared-memory bins); three launches counted; a second call bitwise
    the first (its scratch reset by the cell launch)."""
    from jaybenne_tpu_torch.ops import tally
    from jaybenne_tpu_torch.parallel import exchange as ex_mod
    from jaybenne_tpu_torch.parallel.sharding import split_ledger

    name, m, cap_l, kind, deposit = _TALLY_CASES[case]
    _, mesh = _mesh_of(name, dtype, gpu)
    ledger = _tally_ledger(mesh, m * cap_l, dtype, gpu, seed=len(case))
    ps = split_ledger(ledger, m) if m > 1 else [ledger]
    bl = mesh.n_blocks // m if kind == "spatial" else mesh.n_blocks
    g = torch.Generator(device=gpu).manual_seed(3)
    fs = [_TallyFields(torch.rand((bl, mesh.nz, mesh.ny, mesh.nx), generator=g, device=gpu,
                                  dtype=dtype),
                       torch.rand((bl, mesh.nz, mesh.ny, mesh.nx), generator=g, device=gpu,
                                  dtype=dtype) - 0.5) for _ in range(m)]
    kw = dict(block_offsets=[s * bl for s in range(m)]) if kind == "spatial" else dict(
        exchange=ex_mod.InProcess(m) if kind == "particle" else None)
    cuda_lib.LAUNCHES.clear()
    got = tally.tallies(fs, ps, mesh, deposit, **kw)
    assert cuda_lib.LAUNCHES["tally"] == 3
    again = tally.tallies(fs, ps, mesh, deposit, **kw)
    want = tally.tallies(fs, ps, mesh, deposit, plain=True, **kw)
    torch.cuda.synchronize()
    for k, a, w in zip(got, again, want):
        _same_bits(k, w)
        _same_bits(a, w)
    assert float(want[0].energy_tally.sum()) > 0.0


@pytest.mark.parametrize("name, dtype", [
    ("1d", torch.float32), ("2d", torch.float32), ("2d_periodic", torch.float32),
    ("3d_periodic_yz", torch.float32), ("3d_periodic_yz", torch.float64),
    ("refined_2d", torch.float32), ("refined_2d", torch.float64),
    ("refined_2d_periodic", torch.float32), ("refined_3d", torch.float32),
    ("big_64", torch.float32), ("big_64", torch.float64)])
def test_face_kernel_matches_plain(gpu, name, dtype):
    """The face kernel (csrc/faces_kernel.cu, one launch, from the side map)
    bitwise ``ddmc_face_probs(plain=True)`` on uniform 1D, 2D and 3D forests,
    periodic and not, and on refined ones, in float32 and float64; sigma_t one
    value broadcast (a constant opacity) too."""
    cfg, mesh = _mesh_of(name, dtype, gpu)
    periodic = cfg.mesh.periodic_flags
    g = torch.Generator(device=gpu).manual_seed(len(name))
    dmin = float(mesh.block_dx[:, : mesh.ndim].min())
    shape = (mesh.n_blocks, mesh.nz, mesh.ny, mesh.nx)
    sig = (5.0 / dmin) * torch.exp(torch.rand(shape, generator=g, device=gpu, dtype=dtype)
                                   * 3.5 - 2.0)
    const = torch.tensor(6.0 / dmin, dtype=dtype, device=gpu).expand(shape)
    for s in (sig, const):
        cuda_lib.LAUNCHES.clear()
        got = ddmc_face_probs(mesh, s, 5.0, periodic, dtype)
        assert cuda_lib.LAUNCHES["ddmc_face_probs"] == 1
        want = ddmc_face_probs(mesh, s, 5.0, periodic, dtype, plain=True)
        torch.cuda.synchronize()
        for a, (k, w) in enumerate(zip(got, want)):
            bits = torch.int32 if dtype == torch.float32 else torch.int64
            assert k.shape == w.shape and torch.equal(k.view(bits), w.view(bits)), (name, a)


@pytest.mark.parametrize("name", ["2d", "refined_2d", "big_64"])
@pytest.mark.parametrize("n", [2, 8])
def test_face_kernel_spatial_matches_plain(gpu, name, n):
    """Every local shard's faces in one launch from its sigma_t and the all-gathered
    surfaces (``ddmc_face_probs_shards``) bitwise the plain version, a shard at a
    time (``ddmc_face_probs_spatial``), padding blocks 0."""
    from jaybenne_tpu_torch.ops import fleck
    from jaybenne_tpu_torch.parallel import exchange as ex_mod
    from jaybenne_tpu_torch.parallel.spatial import blocks_per_shard

    cfg, mesh = _mesh_of(name, torch.float32, gpu)
    periodic = cfg.mesh.periodic_flags
    bl = blocks_per_shard(mesh, n)
    g = torch.Generator(device=gpu).manual_seed(n)
    dmin = float(mesh.block_dx[:, : mesh.ndim].min())
    sig = (5.0 / dmin) * torch.exp(torch.rand((n * bl, mesh.nz, mesh.ny, mesh.nx), generator=g,
                                              device=gpu) * 3.5 - 2.0)
    sigmas = [sig[s * bl:(s + 1) * bl] for s in range(n)]
    surfs = ex_mod.InProcess(n).all_gather([fleck.pack_boundary_surface(mesh, t)
                                            for t in sigmas])
    offsets = [s * bl for s in range(n)]
    cuda_lib.LAUNCHES.clear()
    got = fleck.ddmc_face_probs_shards(mesh, sigmas, surfs, offsets, 5.0, periodic,
                                       torch.float32)
    assert cuda_lib.LAUNCHES["ddmc_face_probs"] == 1
    want = fleck.ddmc_face_probs_shards(mesh, sigmas, surfs, offsets, 5.0, periodic,
                                        torch.float32, plain=True)
    torch.cuda.synchronize()
    for s, (ks, ws) in enumerate(zip(got, want)):
        for a, (k, w) in enumerate(zip(ks, ws)):
            assert torch.equal(k.view(torch.int32), w.view(torch.int32)), (s, a)


def test_big_ddmc_graph_matches_eager_with_tally_and_faces(gpu, tmp_path):
    """The 64^3 DDMC row (chip_smoke.BIG_DDMC) through run_file, eager and as a
    CUDA graph (``GraphedStep``), 4 steps side by side: every state bitwise equal
    after every step, replays among them, and each step's launches the tally
    kernel's 3 and the face kernel's 1."""
    cs = _chip_smoke()
    sims = [run_file(STEPDIFF, outdir=str(tmp_path), modified_inputs=cs.BIG_DDMC, quiet=True,
                     nlim=0, device="cuda", graph=gr) for gr in (False, True)]
    eager, graph = sims
    kinds = []
    for _ in range(4):
        before = graph.step_fn.captures
        launches = []
        for sim in sims:
            cuda_lib.LAUNCHES.clear()
            sim.run(nlim=1)
            launches.append(dict(cuda_lib.LAUNCHES))
        kinds.append("eager" if len(graph.history) == 1 else
                     "capture" if graph.step_fn.captures > before else "replay")
        assert launches[0] == launches[1]
        assert launches[1]["tally"] == 3 and launches[1]["ddmc_face_probs"] == 1, launches
        cs.same_states(eager, graph, "the 64^3 DDMC row")
    assert "replay" in kinds, kinds


# ------------------------------------------- the round's gate and counts on the card

# short spatial runs at 8 in-process shards, one of each census route a spatial
# round takes: the z route (a uniform 3D IMC mesh, each shard a z plane of 2 x 2
# blocks), the 2D SMR+DDMC forest (the block route with pending leaks) and the
# float64 1D blocks
_GATE_PATHS = {
    "transport_3d@z": (STEPDIFF, {
        "parthenon/mesh/nx1": 8, "parthenon/mesh/nx2": 8, "parthenon/mesh/nx3": 32,
        "parthenon/mesh/ix2_bc": "periodic", "parthenon/mesh/ox2_bc": "periodic",
        "parthenon/mesh/ix3_bc": "periodic", "parthenon/mesh/ox3_bc": "periodic",
        "parthenon/meshblock/nx1": 4, "parthenon/meshblock/nx2": 4,
        "parthenon/meshblock/nx3": 4, "jaybenne/num_particles": 20000,
        "jaybenne/dt": "1.e-11", "mcblock/scattering_constant_value": 100}),
    "transport_2d_ddmc_smr@blocks": (os.path.join(_ROOT, "inputs", "stepdiff_smr_ddmc.in"), {
        "parthenon/mesh/nx1": 32, "parthenon/mesh/nx2": 16, "parthenon/meshblock/nx1": 8,
        "parthenon/meshblock/nx2": 8, "jaybenne/num_particles": 20000,
        "jaybenne/dt": "1.e-11"}),
    "transport_1d_smr_f64@blocks": (STEPDIFF, {
        "parthenon/mesh/nx1": 32, "parthenon/meshblock/nx1": 4,
        "jaybenne/num_particles": 8000, "jaybenne/dt": "1.e-11",
        "mcblock/scattering_constant_value": 200.0, "jaybenne/precision": "f64"}),
}


def _spatial_8(mods):
    return {**mods, "jaybenne/decomposition": "spatial", "jaybenne/n_devices": 8,
            "parthenon/output0/file_type": "none"}


@pytest.mark.parametrize("route", sorted(_GATE_PATHS))
def test_census_gate_changes_nothing_on_recorded_rounds(gpu, tmp_path, route):
    """The first two rounds of a step at 8 spatial shards as the eager step records
    them (the second a later round of a batch; each gated by a device flag, the
    first's open, as the head starts the unfinished count at 1), each by the
    census kernel with go false: every column bitwise as it was and nothing counted, one launch counted;
    with go true bitwise the ungated launch (chip_smoke.census_gate_bitwise); and
    the count kernel bitwise its plain version on the run's rounds and tail."""
    cs = _chip_smoke()
    deck, mods = _GATE_PATHS[route]
    with cs.RoundRecorder(transport_kernel) as rec:
        calls = cs.recorded_counts(lambda: run_file(
            deck, outdir=str(tmp_path), modified_inputs=_spatial_8(mods), quiet=True, nlim=1,
            device="cuda", graph=False))
    assert len(rec.rounds) == 2 and all(g is not None for g in rec.gos) and bool(rec.gos[0])
    held = cs.census_gate_bitwise(rec.rounds, route)
    assert held.startswith(f"{route}: {route} over 8 shards"), held
    assert calls[0].acc is not None and calls[-1].acc is None
    cs.counts_bitwise(calls, route)


# local shards, slots a shard, float64, the round's counters: None (a step's
# counts), or (go, with the migration's)
_COUNT_CASES = {
    "one_shard": (1, 70000, False, None),
    "one_shard_f64": (1, 70000, True, None),
    "8_shards": (8, 9000, False, None),
    "8_shards_round": (8, 9000, False, (None, True)),
    "8_shards_round_go_false": (8, 9000, False, (False, True)),
    "8_shards_round_f64": (8, 5000, True, (True, True)),
    "3_shards_no_migration": (3, 2100, False, (True, False)),
    "70_shards_small": (70, 100, False, (True, True)),
    "empty_slices": (4, 0, False, (True, True)),
}


@pytest.mark.parametrize("case", sorted(_COUNT_CASES))
def test_round_counts_kernel_matches_plain(gpu, case):
    """The count kernel (csrc/count_kernel.cu) against its plain version on random
    ledgers: each shard's live and unfinished counts and their totals, or a round's
    accumulators after it, bitwise; tau at 1 exactly and one ulp either side, dead
    slots short of census, the last shard empty; twice in a row, so that the
    scratch the first launch reset serves the second."""
    from jaybenne_tpu_torch.ops import counts
    from jaybenne_tpu_torch.parallel.sharding import split_ledger

    m, cap_l, wide, round_ = _COUNT_CASES[case]
    rng = np.random.default_rng(sorted(_COUNT_CASES).index(case))
    dt = torch.float64 if wide else torch.float32
    p = empty_ledger(m * cap_l, dt, gpu)
    tau = torch.from_numpy(rng.uniform(0.0, 1.2, m * cap_l)).to(dt)
    pick = torch.from_numpy(rng.integers(0, 10, m * cap_l))
    one = torch.ones((), dtype=dt)
    tau = torch.where(pick == 0, one, tau)
    tau = torch.where(pick == 1, torch.nextafter(one, one * 0), tau)
    tau = torch.where(pick == 2, torch.nextafter(one, one * 2), tau)
    p.tau.copy_(tau)
    p.alive.copy_(torch.from_numpy(rng.random(m * cap_l) < 0.6))
    if m > 1:
        p.alive[(m - 1) * cap_l:] = False
    ps = split_ledger(p, m) if m > 1 else [p]
    work = counts.scratch(m, gpu)
    for _ in range(2):
        if round_ is None:
            before = cuda_lib.LAUNCHES["round_counts"]
            got = counts.counts(ps, work)
            assert cuda_lib.LAUNCHES["round_counts"] == before + 1
            want = counts.counts(ps, plain=True)
        else:
            go, migrates = round_
            flag = None if go is None else torch.tensor(go, device=gpu)

            def ints(lo, hi, dtype=torch.int64):
                return torch.from_numpy(rng.integers(lo, hi, m)).to(dtype).to(gpu)

            it, ev = ints(0, 60, torch.int32), ints(0, 1 << 40)
            drop, sent = (ints(0, 9), ints(0, 900)) if migrates else (None, None)
            accs = []
            for _plain in (False, True):
                accs.append(types.SimpleNamespace(
                    iters=ints(0, 99, torch.int32), events=ints(0, 99), hits=ints(0, 3),
                    dropped=ints(0, 3), sent=ints(0, 3),
                    rounds=torch.tensor(5, dtype=torch.int64, device=gpu),
                    unfinished=torch.tensor(-1, dtype=torch.int64, device=gpu)))
            for a in accs[1:]:
                for k, v in vars(accs[0]).items():
                    getattr(a, k).copy_(v)
            counts.round_counts(ps, accs[0], it, ev, drop, sent, flag, 40, work)
            counts.round_counts(ps, accs[1], it, ev, drop, sent, flag, 40, plain=True)
            got, want = list(vars(accs[0]).values()), list(vars(accs[1]).values())
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (case, a, b)
    assert not bool(work.any())


def test_spatial_batch_of_8_shards_graph_matches_eager(gpu, tmp_path):
    """The z route's deck of _GATE_PATHS at 8 in-process shards through run_file,
    eager and as CUDA graphs (``GraphedSpatialStep``), 4 steps side by side: every
    state bitwise equal after every step (chip_smoke.same_states), replays among
    them, the same launches a step, and one round_counts launch a round queued and
    one a step's tail."""
    cs = _chip_smoke()
    deck, mods = _GATE_PATHS["transport_3d@z"]
    sims = [run_file(deck, outdir=str(tmp_path), modified_inputs=_spatial_8(mods), quiet=True,
                     nlim=0, device="cuda", graph=g) for g in (False, True)]
    eager, graph = sims
    assert graph.graphed and not eager.graphed
    kinds = []
    for _ in range(4):
        before = graph.step_fn.captures
        queued = cs.rounds_queued(graph)
        launches = []
        for sim in sims:
            cuda_lib.LAUNCHES.clear()
            sim.run(nlim=1)
            launches.append(dict(cuda_lib.LAUNCHES))
        kinds.append("eager" if len(graph.history) == 1 else
                     "capture" if graph.step_fn.captures > before else "replay")
        assert launches[0] == launches[1], launches
        assert launches[1]["round_counts"] == cs.rounds_queued(graph) - queued + 1, launches
        cs.same_states(eager, graph, "transport_3d@z at 8 shards")
    assert "replay" in kinds, kinds


# ------------------------- the particle decomposition's step: one census launch

@pytest.mark.parametrize("name, precision", [("1d_blocks", "f32"), ("2d_smr", "f32"),
                                             ("smr_ddmc", "f32"), ("2d_smr", "f64")])
def test_particle_census_one_launch_matches_plain(gpu, name, precision):
    """The initial radiation of tests/test_torch_particle_launch.py's deck ``name``
    at 8 particle shards: one census call over the 8 shards' slices is one launch
    of the kernel, bitwise the plain one-call census and the plain calls shard by
    shard (every column, each shard's iterations and events)."""
    from test_torch_particle_launch import assert_same, one_call, particle_case, per_shard_calls

    p0, coefs, mesh, seeds, prm, dt = particle_case(name, 8, precision, device=gpu,
                                                    particles=40000)
    launch = transport_kernel.launch_name(mesh.ndim, prm.has_absorption, prm.use_ddmc,
                                          mesh.max_level > 0, dtype=p0.x.dtype)
    k, q, r = p0.clone(), p0.clone(), p0.clone()
    before = cuda_lib.LAUNCHES[launch]
    it_k, ev_k = one_call(transport_kernel.transport, k, coefs, mesh, seeds, prm, dt)
    assert cuda_lib.LAUNCHES[launch] == before + 1
    it_q, ev_q = one_call(transport_kernel.transport_plain, q, coefs, mesh, seeds, prm, dt)
    it_r, ev_r = per_shard_calls(transport_kernel.transport_plain, r, coefs, mesh, seeds, prm,
                                 dt)
    assert_same(k, q, it_k, ev_k, it_q, ev_q, (name, precision, "kernel vs plain"))
    assert_same(q, r, it_q, ev_q, it_r, ev_r, (name, precision, "one call vs per shard"))
    assert bool((ev_k > 0).all())


# stepdiff_smr and stepdiff_smr_ddmc at 8 particle shards, at the CI's mesh, with
# births that outrun absorption so that the ledger grows after the capture
_PARTICLE_GRAPH_PATHS = {
    name: (os.path.join(_ROOT, "inputs", deck), {
        "parthenon/mesh/nx1": 64, "parthenon/mesh/nx2": 32, "parthenon/meshblock/nx1": 16,
        "parthenon/meshblock/nx2": 16, "jaybenne/num_particles": 20000,
        "jaybenne/n_devices": 8, "jaybenne/dt": "1.e-11", "parthenon/time/tlim": "1.e-10",
        "jaybenne/do_emission": "true", "mcblock/opacity_model": "constant",
        "mcblock/opacity_constant_value": 1e-3, "jaybenne/capacity_factor": 1,
        "parthenon/output0/file_type": "none"})
    for name, deck in (("stepdiff_smr", "stepdiff_smr.in"),
                       ("stepdiff_smr_ddmc", "stepdiff_smr_ddmc.in"))}


@pytest.mark.parametrize("path", sorted(_PARTICLE_GRAPH_PATHS))
def test_particle_graph_matches_eager(gpu, tmp_path, path):
    """The particle decomposition at 8 in-process shards through run_file, eager
    and as a CUDA graph (``GraphedStep`` over the shards' states) side by side,
    7 steps: every shard's fields, the ledger, the counters and overflow bitwise
    equal after every step, one census launch a step in both, replays among the
    steps, and a capture again after the ledger grew."""
    cs = _chip_smoke()
    deck, mods = _PARTICLE_GRAPH_PATHS[path]
    sims = [run_file(deck, outdir=str(tmp_path), modified_inputs=mods, quiet=True, nlim=0,
                     device="cuda", graph=g) for g in (False, True)]
    eager, graph = sims
    assert not eager.graphed and graph.graphed and len(graph.shards) == 8
    kinds, caps = [], []
    for _ in range(7):
        before = graph.step_fn.captures
        launches = []
        for sim in sims:
            cuda_lib.LAUNCHES.clear()
            sim.run(nlim=1)
            launches.append(dict(cuda_lib.LAUNCHES))
        kinds.append("eager" if len(graph.history) == 1 else
                     "capture" if graph.step_fn.captures > before else "replay")
        caps.append(graph.state.particles.capacity)
        assert launches[0] == launches[1], (path, graph.cycle, launches)
        assert sum(v for k, v in launches[1].items() if k.startswith("transport_")) == 1
        cs.same_states(eager, graph, path)
        for a, b in zip(eager.shards, graph.shards):
            for f in dataclasses.fields(a.fields):
                assert torch.equal(getattr(a.fields, f.name), getattr(b.fields, f.name)), f.name
    grown = [k for k in range(2, 7) if caps[k] != caps[k - 1]]
    assert grown and all(kinds[k] == "capture" for k in grown), (kinds, caps)
    assert "replay" in kinds, kinds


# the spatial step one batch ahead of its exit read against the loop that reads
# each batch first: the z route's deck of _GATE_PATHS (big_mesh_spatial's deck at
# a reduced size) and phase 33's SMR+DDMC deck, at 8 in-process shards
_AHEAD_PATHS = {
    "big_mesh_spatial_reduced": _GATE_PATHS["transport_3d@z"],
    "phase_33": (os.path.join(_ROOT, "inputs", "stepdiff_smr_ddmc.in"), {
        "parthenon/mesh/nx1": 32, "parthenon/mesh/nx2": 16, "parthenon/meshblock/nx1": 8,
        "parthenon/meshblock/nx2": 8, "jaybenne/num_particles": 96000,
        "jaybenne/dt": "1.e-11"}),
}


@pytest.mark.parametrize("path", sorted(_AHEAD_PATHS))
def test_spatial_batches_ahead_match_the_loop(gpu, tmp_path, path):
    """Two runs of the spatial step as CUDA graphs at 8 shards, 4 steps: one with
    the next batch queued before each exit read (the step's ``ahead``, the default
    on the card), one reading each batch before it queues the next: every
    state bitwise equal after every step, the same migration rounds and the same
    exit reads, the run ahead queuing at most one more batch a step."""
    from jaybenne_tpu_torch.parallel import spatial

    cs = _chip_smoke()
    deck, mods = _AHEAD_PATHS[path]
    sims = [run_file(deck, outdir=str(tmp_path), modified_inputs=_spatial_8(mods), quiet=True,
                     nlim=0, device="cuda") for _ in range(2)]
    ahead, loop = sims
    assert cs.spatial_core(ahead).ahead is True
    cs.spatial_core(loop).ahead = False
    reads = []
    real = spatial._exit_read
    spatial._exit_read = lambda count: reads.append(type(count).__name__) or real(count)
    try:
        for _ in range(4):
            queued = []
            for sim in (loop, ahead):
                k, q = len(reads), cs.rounds_queued(sim)
                sim.run(nlim=1)
                queued.append((cs.rounds_queued(sim) - q, reads[k:]))
            cs.same_states(loop, ahead, path)
            (q_loop, r_loop), (q_ahead, r_ahead) = queued
            rounds = loop.history[-1]["migration_rounds"]
            assert len(r_loop) == len(r_ahead) == cs.batches_of(loop, rounds), (r_loop, r_ahead)
            assert set(r_loop) == {"Tensor"} and set(r_ahead) == {"_CountRead"}
            assert q_loop <= q_ahead <= q_loop + cs.spatial_core(loop).rounds_per_batch
    finally:
        spatial._exit_read = real
    assert ahead.graphed and loop.graphed and sum(h["migrated"] for h in ahead.history) > 0
