"""The tally kernel's arithmetic on the CPU: ``csrc/tally_kernel.cu`` runs only on a
GPU, so its three passes are mirrored here in PyTorch, slot by slot as the kernel
runs them (every local shard's slots joined; one set of bins, global cells or
each shard's own after the shards before it; a zero contribution skipped; the
exponents by an integer max, the quantised values by integer adds; the deposit
and the tally from one read of each slot), and held bitwise against the plain
versions that the CPU runs: ``deterministic_segment_sum``,
``sharded_segment_sum`` and ``tally.tallies`` over one shard, four particle
shards and four spatial shards. The port's tally and deposit are held against
the JAX package's ``segment_sum`` (``evaluate_radiation_energy``,
``accumulate_absorption``) on the same seeded numpy ledgers.

On a GPU, ``tests/test_torch_cuda.py`` holds the kernel itself bitwise against
the same plain versions."""

import contextlib
import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaybenne_tpu import config as jcm
from jaybenne_tpu.mesh import build_mesh as jbuild_mesh
from jaybenne_tpu.ops import tally as jtally
from jaybenne_tpu.utils.deck import Deck as JDeck

from jaybenne_tpu_torch import config as tcm
from jaybenne_tpu_torch.mesh import build_mesh as tbuild_mesh
from jaybenne_tpu_torch.ops import tally
from jaybenne_tpu_torch.parallel import exchange
from jaybenne_tpu_torch.parallel.sharding import split_ledger
from jaybenne_tpu_torch.particles import empty_ledger
from jaybenne_tpu_torch.utils.deck import Deck as TDeck

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECK = os.path.join(_ROOT, "inputs", "stepdiff.in")
# a small 2D mesh of 8 blocks of 4x4 cells (128 cells, stepdiff's count)
MESH = {"parthenon/mesh/nx1": 16, "parthenon/mesh/nx2": 8, "parthenon/meshblock/nx1": 4,
        "parthenon/meshblock/nx2": 4}
CAP = 1200  # slots a shard
# the JAX package's float32 segment_sum adds in float32: a bin of k values is off by
# at most about k 2^-24 of its sum (k < 64 here)
JAX_F32_RTOL = 64 * 2.0 ** -24


@dataclasses.dataclass
class _Fields:
    energy_tally: object
    energy_delta: object


def _meshes(dtype=torch.float32):
    tcfg = tcm.from_deck(TDeck.from_file(DECK).update(dict(MESH)))
    jcfg = jcm.from_deck(JDeck.from_file(DECK).update(dict(MESH)))
    return tbuild_mesh(tcfg.mesh, dtype=dtype), jcfg


def _ledger(mesh, n, dtype, seed):
    """A ledger of ``n`` slots: 60 % alive, a fifth of the dead ones absorbed this
    step, weights over four orders of magnitude, blocks and cells drawn from every
    block's."""
    rng = np.random.default_rng(seed)
    p = empty_ledger(n, dtype)
    lo, hi = 0, mesh.n_blocks
    p.alive.copy_(torch.from_numpy(rng.random(n) < 0.6))
    p.absorbed.copy_(torch.from_numpy(rng.random(n) < 0.2) & ~p.alive)
    p.weight.copy_(torch.from_numpy(10.0 ** rng.uniform(-3, 1, n)))
    p.block.copy_(torch.from_numpy(rng.integers(lo, hi, n)))
    for name, size in (("i", mesh.nx), ("j", mesh.ny), ("k", mesh.nz)):
        getattr(p, name).copy_(torch.from_numpy(rng.integers(0, size, n)))
    return p


def _fields(mesh, n_blocks, dtype, seed):
    rng = np.random.default_rng(seed)
    shape = (n_blocks, mesh.nz, mesh.ny, mesh.nx)
    return _Fields(torch.from_numpy(rng.random(shape)).to(dtype),
                   torch.from_numpy(rng.uniform(-1, 1, shape)).to(dtype))


def _bins_of(values, bins, n_bins, bits):
    """Launches 1 and 2 and the cell pass of one kind: each bin's sum, float64."""
    v = values.to(torch.float64)
    on = v != 0  # a zero contribution does no atomic
    b = bins[on]
    exp = torch.frexp(v[on]).exponent
    emax = torch.full((n_bins,), -1100, dtype=torch.int32).scatter_reduce(0, b, exp, "amax")
    shift = (bits - emax.long()).clamp(-1000, 1000)
    scale = ((shift + 1023) << 52).view(torch.float64)
    acc = torch.zeros(n_bins, dtype=torch.int64).index_add_(
        0, b, torch.round(v[on] * scale[b]).to(torch.int64))
    return acc.to(torch.float64) / scale


def _kernel_mirror(fields, particles, mesh, deposit, block_offsets=None):
    """The tally kernel's pass over the local shards' joined slots, in PyTorch:
    returns each shard's fields."""
    m, cap_l = len(particles), particles[0].capacity
    col = {name: torch.cat([getattr(p, name) for p in particles])
           for name in ("weight", "block", "k", "j", "i", "alive", "absorbed")}
    g = torch.arange(m * cap_l) // cap_l
    blk = col["block"].long()
    if block_offsets is None:
        owned, base = torch.ones_like(col["alive"]), 0
        cells = n_bins = mesh.total_cells
        bits = tally._bits(cap_l * m)
    else:
        bl = fields[0].energy_tally.shape[0]
        blk = blk - (block_offsets[0] + g * bl)
        owned, base = (blk >= 0) & (blk < bl), g * bl
        cells = fields[0].energy_tally.numel()
        n_bins, bits = m * cells, tally._bits(cap_l)
    b = (((base + blk) * mesh.nz + col["k"]) * mesh.ny + col["j"]) * mesh.nx + col["i"]
    vol = mesh.block_volume[col["block"].long().clamp(0, mesh.n_blocks - 1)]
    w = col["weight"]
    sums = [_bins_of(torch.where(col["alive"] & owned, w / vol, 0.0), b, n_bins, bits)]
    if deposit:
        sums.append(_bins_of(torch.where(col["absorbed"] & owned, w, 0.0), b, n_bins, bits))
    out = []
    for s, f in enumerate(fields):
        part = slice(0, cells) if block_offsets is None else slice(s * cells, (s + 1) * cells)
        t = sums[0][part].reshape(f.energy_tally.shape).to(f.energy_tally.dtype)
        d = f.energy_delta
        if deposit:
            d = d + sums[1][part].reshape(d.shape).to(d.dtype)
        out.append(_Fields(t, d))
    return out


def _bitwise(a, b):
    return a.dtype == b.dtype and torch.equal(a.view(torch.int64 if a.element_size() == 8
                                                      else torch.int32),
                                              b.view(torch.int64 if b.element_size() == 8
                                                     else torch.int32))


# ------------------------------------------------- the passes on raw values


def _values(case, dtype, rng, n, nseg):
    seg = rng.integers(0, nseg, n)
    vals = rng.lognormal(0.0, 2.0, n)
    if case == "dead":  # most slots contribute nothing
        vals = np.where(rng.random(n) < 0.8, 0.0, vals)
    elif case == "zero_bins":  # every odd bin empty, every third slot zero
        seg = 2 * (seg // 2)
        vals[::3] = 0.0
    elif case == "span":  # bin 0 holds values from 1e-20 to 1
        seg[: n // 4] = 0
        vals[: n // 4] = 10.0 ** rng.uniform(-20, 0, n // 4)
    return torch.from_numpy(vals).to(dtype), torch.from_numpy(seg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["dead", "zero_bins", "span"])
def test_passes_bitwise_segment_sum(case, dtype):
    """The kernel's passes (no sub-bins, zeros skipped) give bitwise
    ``deterministic_segment_sum`` of one ledger, and bitwise
    ``sharded_segment_sum`` of four shards' (one set of bins, bits from every
    shard's slots)."""
    rng = np.random.default_rng(len(case) + dtype.itemsize)
    n, nseg = 4000, 37
    vals, seg = _values(case, dtype, rng, n, nseg)
    want = tally.deterministic_segment_sum(vals, seg, nseg)
    assert torch.equal(_bins_of(vals, seg, nseg, tally._bits(n)), want)
    if case == "zero_bins":
        assert not bool(want[1::2].any())
    if case == "span":
        assert float(want[0]) > 0.0
    parts = [vals[s * n // 4:(s + 1) * n // 4] for s in range(4)]
    segs = [seg[s * n // 4:(s + 1) * n // 4] for s in range(4)]
    sharded = tally.sharded_segment_sum(parts, segs, nseg, exchange.InProcess(4))
    for got in sharded:
        assert torch.equal(got, want)


# ------------------------------------ the whole pass against tally.tallies


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", ["one", "particle4", "spatial4"])
def test_mirror_bitwise_tallies(layout, dtype):
    """The kernel's one pass, the deposit and the tally together over every local
    shard's slots, is bitwise ``tally.tallies`` (the plain version, a shard at a
    time): one shard, four particle shards (replicated fields, the sum over
    shards) and four spatial shards at their block offsets (their own blocks'
    particles, other shards' left out)."""
    mesh, _ = _meshes(dtype)
    m = 1 if layout == "one" else 4
    ledger = _ledger(mesh, m * CAP, dtype, seed=m + dtype.itemsize)
    ps = split_ledger(ledger, m) if m > 1 else [ledger]
    if layout == "spatial4":
        bl = mesh.n_blocks // m
        offsets = [s * bl for s in range(m)]
        fs = [_fields(mesh, bl, dtype, seed=s) for s in range(m)]
        want = tally.tallies(fs, ps, mesh, True, block_offsets=offsets)
        got = _kernel_mirror(fs, ps, mesh, True, block_offsets=offsets)
    else:
        ex = None if m == 1 else exchange.InProcess(m)
        fs = [_fields(mesh, mesh.n_blocks, dtype, seed=s) for s in range(m)]
        want = tally.tallies(fs, ps, mesh, True, ex)
        got = _kernel_mirror(fs, ps, mesh, True)
    for w, g in zip(want, got):
        assert _bitwise(w.energy_tally, g.energy_tally)
        assert _bitwise(w.energy_delta, g.energy_delta)
    assert float(want[0].energy_tally.sum()) > 0.0


# --------------------------------------------- against the JAX package


@contextlib.contextmanager
def _jax_precision(dtype):
    """The JAX package's float64 mode where ``dtype`` is float64, switched off
    again after."""
    x64 = dtype == torch.float64
    if x64:
        jax.config.update("jax_enable_x64", True)
    try:
        yield jnp.float64 if x64 else jnp.float32
    finally:
        if x64:
            jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("spatial", [False, True])
def test_tally_and_deposit_match_jax(spatial, dtype):
    """The port's deposit and tally (the plain version of the kernel) against the
    JAX package's ``segment_sum`` on the same numpy ledger: within
    ``conservation_rtol`` of the slots in float64, within the float32 sum's own
    rounding in float32; a spatial shard's at block offset 4 of 8."""
    mesh, jcfg = _meshes(dtype)
    n = 2 * CAP
    ledger = _ledger(mesh, n, dtype, seed=11 + spatial)
    off = 4 if spatial else None
    nb = 4 if spatial else mesh.n_blocks
    f = _fields(mesh, nb, dtype, seed=5)
    (got,) = tally.tallies([f], [ledger], mesh, True,
                           block_offsets=None if off is None else [off])
    with _jax_precision(dtype) as jdt:
        jmesh = jbuild_mesh(jcfg.mesh, dtype=jdt)
        cols = {k: jnp.asarray(getattr(ledger, k).numpy()) for k in
                ("weight", "block", "k", "j", "i", "alive", "absorbed")}
        jp = types.SimpleNamespace(**cols)
        jf = _Fields(jnp.asarray(f.energy_tally.numpy(), jdt),
                     jnp.asarray(f.energy_delta.numpy(), jdt))
        jf = jtally.accumulate_absorption(jf, jp, jmesh, block_offset=off)
        jf = jtally.evaluate_radiation_energy(jf, jp, jmesh, block_offset=off)
        want_t, want_d = np.asarray(jf.energy_tally), np.asarray(jf.energy_delta)
    rtol = tally.conservation_rtol(n) if dtype == torch.float64 else JAX_F32_RTOL
    np.testing.assert_allclose(got.energy_tally.numpy(), want_t, rtol=rtol, atol=0)
    # energy_delta + the deposit, rounded once more where a cell's sum nears 0
    np.testing.assert_allclose(got.energy_delta.numpy(), want_d, rtol=rtol,
                               atol=rtol * float(np.abs(want_d).max()))
    assert not np.array_equal(want_d, f.energy_delta.numpy())
    assert (want_t > 0).sum() > 0.5 * want_t.size
