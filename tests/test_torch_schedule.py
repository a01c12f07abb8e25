"""The census's multi-shard call and the SMR block table's reciprocal column, on the
CPU: one plain census call over the adjacent ledger slices of several shards,
each with its owned range, is bitwise the per-shard calls in order (the z-slab
route across the periodic seam, and the block route with pending leak codes and
padding blocks); the block table's f32(1 / dx) column is the IEEE quotient, and
the plain census reading it is bitwise the one that divides per event.

Imports no jax: ``tests/test_torch_cuda.py`` builds its multi-shard cases from
``shard_case`` here, on the card."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from jaybenne_tpu_torch import config as cm
from jaybenne_tpu_torch.mesh import build_mesh
from jaybenne_tpu_torch.ops import transport_kernel
from jaybenne_tpu_torch.ops.fleck import ddmc_face_probs
from jaybenne_tpu_torch.ops.transport import TransportCoefs
from jaybenne_tpu_torch.parallel.sharding import split_ledger
from jaybenne_tpu_torch.parallel.spatial import blocks_per_shard, owned_range
from jaybenne_tpu_torch.particles import (empty_ledger, forest_ledger, place_on_faces,
                                          uniform_ledger)
from jaybenne_tpu_torch.step import make_transport_params
from jaybenne_tpu_torch.utils.deck import Deck

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(_ROOT, "inputs")
C = 2.99792458e10
# the z route: 4 x 4 x 16 cells in 4 x 4 x 2 blocks, 8 shards of one z-plane of
# blocks, periodic in y and z; sigma_t = 64 with f sigma_a = 2 (chip_smoke.py
# phase 28's coefficients), so lanes cross the 2-cell slabs and the z seam
Z_MESH = {"parthenon/mesh/nx1": 4, "parthenon/mesh/nx2": 4, "parthenon/mesh/nx3": 16,
          "parthenon/meshblock/nx1": 4, "parthenon/meshblock/nx2": 4,
          "parthenon/meshblock/nx3": 2, "mcblock/opacity_model": "constant",
          **{f"parthenon/swarm/{s}x{k}_bc": "periodic" for s in "io" for k in "23"}}
# the block route: tests/test_torch_smr.py's 2D level-1 forest (32 x 16 in 8 x 8
# blocks, 20 blocks) at 8 shards of 3 blocks, the last 4 blocks padding; thin and
# thick x-slabs two coarse cells wide, so coarse thick cells leak into finer
# blocks of other shards
SMR_FOREST = {"parthenon/mesh/nx1": 32, "parthenon/mesh/nx2": 16,
              "parthenon/meshblock/nx1": 8, "parthenon/meshblock/nx2": 8,
              "jaybenne/tau_ddmc": 5.0}
SIGMA = (16.0, 512.0)  # thin and thick sigma_s
N_SHARDS = 8
# tests/test_torch_smr.py's forests with DDMC, for the reciprocal column
FORESTS = {
    "2d_level1": ("stepdiff_smr_ddmc.in", {"parthenon/mesh/nx1": 32, "parthenon/mesh/nx2": 16,
                                           "parthenon/meshblock/nx1": 8,
                                           "parthenon/meshblock/nx2": 8}),
    "2d_level2": ("stepdiff_smr2.in", {"parthenon/mesh/nx1": 32, "parthenon/mesh/nx2": 16,
                                       "parthenon/meshblock/nx1": 8,
                                       "parthenon/meshblock/nx2": 8,
                                       "jaybenne/use_ddmc": "true"}),
    "3d_level1": ("stepdiff_3d_smr_ddmc.in",
                  {"parthenon/mesh/nx1": 16, "parthenon/mesh/nx2": 8, "parthenon/mesh/nx3": 8,
                   "parthenon/meshblock/nx1": 4, "parthenon/meshblock/nx2": 4,
                   "parthenon/meshblock/nx3": 4}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are small, and the suite runs in several
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(deck, mods, dev):
    cfg = cm.from_deck(Deck.from_file(os.path.join(INPUTS, deck)).update(mods))
    return cfg, build_mesh(cfg.mesh, device=dev), make_transport_params(cfg, torch.float32)


def _slabs(mesh):
    """Per-cell sigma_s of thin and thick x-slabs two coarse cells wide."""
    xc = mesh.cell_centers()[0]
    width = 2.0 * float(mesh.block_dx[:, 0].max())
    thick = torch.floor((xc - mesh.bounds[0]) / width).long() % 2 == 1
    return torch.where(thick, SIGMA[1], SIGMA[0])


def _shard_coefs(mesh, prm, cfg, sig, sigma_a):
    """Per-shard DDMC coefficients of ``N_SHARDS`` shards of blocks_per_shard blocks
    from per-cell ``sig`` (sigma_t) with ``sigma_a`` of it absorbing, padding blocks
    thin and without face probabilities."""
    faces = ddmc_face_probs(mesh, sig, prm.tau_ddmc, cfg.mesh.periodic_flags, torch.float32)
    bl = blocks_per_shard(mesh, N_SHARDS)
    n_pad = N_SHARDS * bl - mesh.n_blocks
    ncpb = mesh.ncells_per_block
    sig = torch.cat([sig.reshape(-1), sig.new_full((n_pad * ncpb,), SIGMA[0])])
    faces = [torch.cat([f, f.new_zeros((n_pad,) + f.shape[1:])]) for f in faces]
    coefs = []
    for s in range(N_SHARDS):
        loc = sig[s * bl * ncpb:(s + 1) * bl * ncpb]
        coefs.append(TransportCoefs(sigma_a=torch.full_like(loc, sigma_a), sigma_s=loc - sigma_a,
                                    fleck=torch.ones_like(loc),
                                    **dict(zip(("px", "py", "pz"),
                                               (f[s * bl:(s + 1) * bl] for f in faces)))))
    return coefs


def shard_case(route: str, m: int, dev="cpu", seed=7):
    """A round of ``N_SHARDS`` shards: (one ledger of their adjacent slices of ``m``
    slots, per-shard coefficients, mesh, per-shard seeds, prm, dt, owned ranges).
    Each slice holds live particles of its shard's range at random tau, a tenth
    of them in the next shard's range (they do not run); on the block routes a
    quarter sit on a face with its arrival code, and the last shard owns padding
    blocks (on the 2D forest only those: its slice holds shard 0's particles).
    ``route``: ``z`` (IMC with absorption), ``z_ddmc`` (the same z slabs,
    absorbing IMC and DDMC on thin and thick x-slabs, a quarter of the lanes on a
    face; a spatial run with DDMC takes the block route, the kernel takes both),
    ``blocks`` (the 2D level-1 DDMC forest) or ``blocks_3d`` (a 3D level-1 DDMC
    forest)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    p = empty_ledger(N_SHARDS * m, torch.float32, dev)
    if route in ("z", "z_ddmc"):
        ddmc = route == "z_ddmc"
        cfg, mesh, prm = _config("stepdiff.in", {**Z_MESH, "jaybenne/dt": "1.e-11",
                                                 "jaybenne/use_ddmc": str(ddmc).lower()}, dev)
        nc = blocks_per_shard(mesh, N_SHARDS) * mesh.ncells_per_block
        coefs = [TransportCoefs(sigma_a=torch.full((nc,), 2.0, device=dev),
                                sigma_s=torch.full((nc,), 62.0, device=dev),
                                fleck=torch.ones(nc, device=dev))] * N_SHARDS
        if ddmc:
            coefs = _shard_coefs(mesh, prm, cfg, _slabs(mesh), 2.0)
        for s, q in enumerate(split_ledger(p, N_SHARDS)):
            src = uniform_ledger(mesh, m, g, C)
            src.block.copy_(torch.where(torch.arange(m, device=dev) % 10 == 9,
                                        (s + 1) % N_SHARDS, s))
            if ddmc:
                place_on_faces(src, mesh, torch.rand(m, generator=g, device=dev) < 0.25, g)
            for f in dataclasses.fields(q):
                getattr(q, f.name).copy_(getattr(src, f.name))
    else:
        deck, forest = (("stepdiff_smr_ddmc.in", SMR_FOREST) if route == "blocks"
                        else FORESTS["3d_level1"])
        cfg, mesh, prm = _config(deck, {**forest, "jaybenne/tau_ddmc": 5.0,
                                        "jaybenne/dt": "3.e-11"}, dev)
        bl = blocks_per_shard(mesh, N_SHARDS)
        coefs = _shard_coefs(mesh, prm, cfg, _slabs(mesh), 0.0)
        for s, q in enumerate(split_ledger(p, N_SHARDS)):
            lo = s * bl if s * bl < mesh.n_blocks else 0
            src = forest_ledger(mesh, m, g, C, blocks=(lo, min(lo + bl, mesh.n_blocks)))
            nxt = forest_ledger(mesh, m, g, C, blocks=((lo + bl) % mesh.n_blocks,
                                                        min((lo + bl) % mesh.n_blocks + bl,
                                                            mesh.n_blocks)))
            other = torch.arange(m, device=dev) % 10 == 9
            for f in dataclasses.fields(src):
                t = getattr(src, f.name)
                t.copy_(torch.where(other, getattr(nxt, f.name), t))
            place_on_faces(src, mesh, torch.rand(m, generator=g, device=dev) < 0.25, g)
            for f in dataclasses.fields(q):
                getattr(q, f.name).copy_(getattr(src, f.name))
    p.tau.copy_(torch.rand(p.capacity, generator=g, device=dev))
    owns = [owned_range(mesh, prm, N_SHARDS, s) for s in range(N_SHARDS)]
    if route == "z_ddmc":  # spatial runs take DDMC on the block route; the kernel takes both
        owns = [transport_kernel.OwnedRange("z", s * mesh.nz, mesh.nz) for s in range(N_SHARDS)]
    assert {o.kind for o in owns} == {route.split("_")[0]} and prm.use_ddmc == (route != "z")
    seeds = [1000 + 17 * s - (1 << 31) * (s % 2) for s in range(N_SHARDS)]
    return p, coefs, mesh, seeds, prm, cfg.jaybenne.dt, owns


def per_shard_rounds(census, p, coefs, mesh, seeds, prm, dt, owns):
    """The round as one census call per shard, in shard order, on ``p``'s slices
    (IN PLACE): (iterations, events) per shard."""
    its, evs = [], []
    for q, c, s, o in zip(split_ledger(p, N_SHARDS), coefs, seeds, owns):
        _, it, ev = census(q, c, mesh, s, prm, dt, o)
        its.append(it)
        evs.append(ev)
    return torch.stack(its), torch.stack(evs)


def one_call_round(census, p, coefs, mesh, seeds, prm, dt, owns):
    """The round as one census call over every shard's slice (IN PLACE)."""
    _, it, ev = census(split_ledger(p, N_SHARDS), coefs, mesh, seeds, prm, dt, owns)
    return it, ev


def assert_same_ledgers(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert torch.equal(x, y), (f.name, int((x != y).sum()))


ROUTES = ["z", "z_ddmc", "blocks", "blocks_3d"]


@pytest.mark.parametrize("route", ROUTES)
def test_one_call_over_shards_is_the_per_shard_calls(route):
    """One plain census call over 8 shards' adjacent slices, each with its owned
    range and seed, against the 8 per-shard calls in order: every column bitwise,
    the same iterations and events per shard. On the z routes lanes pause across
    the periodic z seam; on the block routes shards write pending leak codes into
    other shards' finer blocks and the last shard owns padding blocks only."""
    p0, coefs, mesh, seeds, prm, dt, owns = shard_case(route, 300)
    a, b = p0.clone(), p0.clone()
    it_a, ev_a = one_call_round(transport_kernel.transport_plain, a, coefs, mesh, seeds, prm,
                                dt, owns)
    it_b, ev_b = per_shard_rounds(transport_kernel.transport_plain, b, coefs, mesh, seeds, prm,
                                  dt, owns)
    assert_same_ledgers(a, b)
    assert torch.equal(it_a, it_b) and torch.equal(ev_a, ev_b)
    assert it_a.shape == ev_a.shape == (N_SHARDS,) and int(ev_a.sum()) > 0
    paused = a.alive & (a.tau < 1.0)
    assert bool(paused.any()) and bool((a.alive & (a.tau == 1.0)).any())
    if route.startswith("z"):
        gk = a.block * mesh.nz + a.k  # one block per z plane
        nz_all = mesh.root_grid[0] * mesh.nz
        seam = paused & (gk >= nz_all - mesh.nz)  # out of shard 0 across the seam
        assert bool(seam[: p0.capacity // N_SHARDS].any())
    else:
        assert bool((a.leak != 0).any())
        if route == "blocks":  # the padding shard's slice holds none of its lanes
            assert int(ev_a[-1]) == 0


def test_a_census_setup_is_reused_across_calls():
    """``prepare`` once, then two calls (two rounds) with the prepared set-up: the
    same as two calls that each build their tables."""
    p0, coefs, mesh, seeds, prm, dt, owns = shard_case("z", 200)
    setup = transport_kernel.prepare(coefs, mesh, prm, dt, owns)
    a, b = p0.clone(), p0.clone()
    for rnd in range(2):
        sd = [s + rnd for s in seeds]
        ra = transport_kernel.transport_plain(split_ledger(a, N_SHARDS), setup, mesh, sd, prm, dt)
        rb = one_call_round(transport_kernel.transport_plain, b, coefs, mesh, sd, prm, dt, owns)
        assert torch.equal(ra[1], rb[0]) and torch.equal(ra[2], rb[1])
        a.tau.copy_(torch.where(a.alive & (a.tau < 1.0), a.tau, 0.5))
        b.tau.copy_(torch.where(b.alive & (b.tau < 1.0), b.tau, 0.5))
    assert_same_ledgers(a, b)
    with pytest.raises(ValueError, match="prepared"):
        transport_kernel.transport_plain(split_ledger(a, N_SHARDS), setup, mesh, seeds, prm, dt,
                                         owns)


def test_shards_must_be_adjacent_slices():
    """A multi-shard call joins the shards' ledgers: separate ledgers raise."""
    p0, coefs, mesh, seeds, prm, dt, owns = shard_case("z", 50)
    parts = [q.clone() for q in split_ledger(p0, N_SHARDS)]
    with pytest.raises(ValueError, match="adjacent"):
        transport_kernel.transport_plain(parts, coefs, mesh, seeds, prm, dt, owns)


def test_lane_events_and_warp_efficiency():
    """The plain census's per-slot event counts sum to its events, and the warp
    efficiency of slot order is their sum over 32 times each group's largest."""
    p0, coefs, mesh, seeds, prm, dt, owns = shard_case("z", 100)
    lanes = torch.zeros(p0.capacity, dtype=torch.int32)
    _, _, ev = transport_kernel.transport_plain(split_ledger(p0.clone(), N_SHARDS), coefs, mesh,
                                                seeds, prm, dt, owns, lane_events=lanes)
    assert int(lanes.sum()) == int(ev.sum()) > 0
    eff = transport_kernel.warp_efficiency(lanes)
    groups = torch.cat([lanes, lanes.new_zeros((-lanes.numel()) % 32)]).reshape(-1, 32)
    assert eff == pytest.approx(int(lanes.sum()) / (32 * int(groups.max(1).values.sum())))
    assert 0.0 < eff < 1.0
    assert transport_kernel.warp_efficiency(torch.full((64,), 5, dtype=torch.int32)) == 1.0


def spread_slots(count, slice_, width, threads=transport_kernel.THREADS):
    """The slot each thread of a K4s launch takes with its shards' groups
    interleaved (csrc/transport_kernel.cuh, ``slot_of`` under kSpreadShards), -1
    for none, by block: an array [blocks, threads], and the spread width used."""
    groups = count * -(-slice_ // 32)
    blocks = -(-groups * 32 // threads)
    w = min(width, blocks)
    b = np.arange(blocks)[:, None]
    t = np.arange(threads)[None, :]
    lane = t & 31
    q = np.where(b < w, 32 * ((t >> 5) * w + b) + lane, threads * b + t)
    grp = q >> 5
    off = 32 * (grp // count) + lane
    return np.where(off < slice_, (grp % count) * slice_ + off, -1), w


@pytest.mark.parametrize("count, slice_, sms, resident", [
    (8, 24288, 132, 4), (8, 600, 132, 4), (3, 1000, 2, 1), (1, 50, 132, 4), (6, 4096, 132, 3)])
def test_k4s_spread_covers_every_slot_once(count, slice_, sms, resident):
    """The K4s launch's interleaved schedule takes every slot of every shard's
    slice once, with a launch of fewer blocks than its spread width too; the width
    is prime to the shard count, so a first-wave block's warps come from several
    shards; and on big_mesh_spatial's shape (8 slices of 24288 slots, 528
    resident blocks) every slice's first 16000 slots, where its live lanes sit,
    run in the first wave."""
    width = transport_kernel.spread_width(sms, resident, count, slice_)
    assert 0 < width <= sms * resident and np.gcd(width, count) == 1
    slots, w = spread_slots(count, slice_, width)
    assert w == width
    taken = slots[slots >= 0]
    assert np.array_equal(np.sort(taken), np.arange(count * slice_))
    shard = np.where(slots >= 0, slots // slice_, -1)
    if count > 1 and w > 1:
        mixed = [len(set(row[row >= 0].tolist())) for row in shard[:w]]
        assert min(m for m in mixed if m) >= min(2, count)
    if slice_ == 24288:
        first = slots[:w][slots[:w] >= 0]
        assert set(range(16000)) <= set((first % slice_).tolist())


def _hybrid(name, dev="cpu", n=1000, seed=3):
    deck, mods = FORESTS[name]
    cfg, mesh, prm = _config(deck, {**mods, "jaybenne/tau_ddmc": 5.0,
                                    "mcblock/opacity_model": "constant",
                                    "mcblock/opacity_constant_value": 1.0}, dev)
    assert prm.use_ddmc and mesh.max_level >= 1
    sig = _slabs(mesh).reshape(-1)
    faces = ddmc_face_probs(mesh, sig.reshape(mesh.n_blocks, mesh.nz, mesh.ny, mesh.nx),
                            prm.tau_ddmc, cfg.mesh.periodic_flags, torch.float32)
    coefs = TransportCoefs(sigma_a=torch.full_like(sig, 2.0), sigma_s=sig,
                           fleck=torch.full_like(sig, 0.5), px=faces[0], py=faces[1],
                           pz=faces[2])
    g = torch.Generator(device=dev).manual_seed(seed)
    p = forest_ledger(mesh, n, g, C)
    place_on_faces(p, mesh, torch.rand(n, generator=g, device=dev) < 0.25, g)
    p.tau.copy_(0.5 + 0.5 * torch.rand(n, generator=g, device=dev))
    return p, coefs, mesh, prm, cfg.jaybenne.dt


@pytest.mark.parametrize("name", sorted(FORESTS))
def test_block_table_reciprocals_are_the_per_event_divide(name, monkeypatch):
    """The SMR block table's f32(1 / dx) column equals the IEEE quotient bitwise,
    and the plain DDMC census reading it is bitwise the census that divides per
    event (the column recomputed as ``one / dx`` with a 0-dim ``one``, the
    expression the plain version evaluated per event)."""
    p0, coefs, mesh, prm, dt = _hybrid(name)
    setup = transport_kernel.prepare(coefs, mesh, prm, dt)
    block = setup.tabs.block
    dx = block[:, 0:3].numpy()
    assert np.array_equal(block[:, 8:11].numpy().view(np.int32),
                          (np.float32(1.0) / dx).view(np.int32))
    a, it_a, ev_a = transport_kernel.transport_plain(p0.clone(), coefs, mesh, 11, prm, dt)

    real = transport_kernel._tables

    def per_event_divide(*args):
        tabs = real(*args)
        one = torch.tensor(1.0, dtype=torch.float32)
        for ax in range(3):
            tabs.block[:, 8 + ax] = one / tabs.block[:, ax]
        return tabs

    monkeypatch.setattr(transport_kernel, "_tables", per_event_divide)
    b, it_b, ev_b = transport_kernel.transport_plain(p0.clone(), coefs, mesh, 11, prm, dt)
    assert_same_ledgers(a, b)
    assert int(it_a) == int(it_b) and int(ev_a) == int(ev_b) > 0


@pytest.mark.parametrize("route", ["z", "z_ddmc"])
def test_plain_collapse_round_trip(route):
    """The plain collapse of a uniform multi-block ledger to one block and its
    expansion: indices and blocks back exactly, positions within float32 rounding
    of the block extent, and the collapsed ledger on global cells of one block."""
    p0, coefs, mesh, seeds, prm, dt, owns = shard_case(route, 64)
    p = p0.clone()
    transport_kernel.collapse_plain(p, mesh)
    assert not bool(p.block.any())
    assert torch.equal(p.k, p0.k + p0.block * mesh.nz)  # one block per z plane
    transport_kernel.expand_plain(p, mesh)
    for name in ("i", "j", "k", "block"):
        assert torch.equal(getattr(p, name), getattr(p0, name)), name
    extent = max(transport_kernel._block_shifts(mesh))
    assert float((p.z - p0.z).abs().max()) <= 4 * np.finfo(np.float32).eps * 8 * extent
