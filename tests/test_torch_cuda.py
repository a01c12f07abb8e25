"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here is marked ``cuda`` and skips without a GPU: a CUDA kernel has no
CPU mode. The file imports no jax, so it also runs on a GPU machine without jax,
where ``tests/conftest.py`` (which imports jax) cannot load:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from jaybenne_tpu_torch import config as cm
from jaybenne_tpu_torch.driver import run_file
from jaybenne_tpu_torch.mesh import build_mesh
from jaybenne_tpu_torch.ops import cuda_lib, kernel_rng, transport_kernel
from jaybenne_tpu_torch.ops.transport import TransportCoefs
from jaybenne_tpu_torch.particles import empty_ledger
from jaybenne_tpu_torch.step import make_transport_params
from jaybenne_tpu_torch.utils.deck import Deck

pytestmark = pytest.mark.cuda

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPDIFF = os.path.join(_ROOT, "inputs", "stepdiff.in")
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


def test_main_path_runs_through_kernel(gpu, tmp_path):
    mods = {"parthenon/mesh/nx1": 64, "parthenon/meshblock/nx1": 64,
            "jaybenne/num_particles": 20000, "parthenon/output0/file_type": "none"}
    cuda_lib.LAUNCHES.clear()
    sims = [run_file(STEPDIFF, outdir=str(tmp_path), modified_inputs=mods, quiet=True,
                     nlim=3, device="cuda") for _ in range(2)]
    assert cuda_lib.LAUNCHES["transport_1d"] == 6
    a, b = (s.state.fields.energy_tally for s in sims)
    assert a.is_cuda and torch.equal(a, b)  # bitwise deterministic
    f = sims[0].state.fields
    # source_ew is a particle's weight (energy), the tally an energy density
    sourced = float((f.source_num.double() * f.source_ew.double()).sum())
    dv = sims[0].mesh.block_volume.double()[:, None, None, None]
    tallied = float((a.double() * dv).sum())
    assert abs(tallied - sourced) <= 1e-5 * sourced  # no absorption, reflecting walls
