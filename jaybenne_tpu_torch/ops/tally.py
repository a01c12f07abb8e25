"""Tallies and fluid feedback (port of ``jaybenne_tpu/ops/tally.py``): the
radiation-energy tally, the absorption deposition and the fluid update.

The JAX package sums per-particle ``weight / dV`` into cells with an atomic-free
``segment_sum``. On a GPU, ``index_add_`` on floats adds in whatever order the
atomics land, so two runs differ in the last bits. Here each contribution is first
quantised to 64-bit fixed point at a power-of-two scale chosen per cell, and the
quantised values are summed with integer adds. Integer addition is associative, so
the tally and the absorption deposition repeat bitwise on any device in any
order.

Under the particle decomposition each shard holds a slice of the ledger and the
fields are replicated: the sum over shards stays in the integer domain (an integer
maximum of each cell's exponent, then a sum of the int64 accumulators, with the
scale's headroom taken from every shard's slots), so the sharded tally is bitwise
the tally of the concatenated ledger. Under the spatial decomposition a shard
holds its blocks' fields and the particles in them: with ``block_offset`` (the
global id of its first block) it tallies its own particles into its own cells and
nothing is reduced.

Precision, a stated deviation in float64 (``precision = f64``). A bin keeps
``62 - ceil(log2 n)`` bits of its largest contribution, n the slots summed
(``_bits``): 44 bits at stepdiff's 201152 slots. That is fewer than a float64's 53
once n passes 512, so a float64 run's tally is exact only to those bits, not to
the float64 sum's last bit: each of a bin's contributions is rounded by at most
half a unit of its scale, 2^-(bits + 1) of the bin's largest, so a sum of
positive contributions is off by at most n 2^-bits of itself
(``conservation_rtol``). The JAX package's float64 ``segment_sum`` keeps 53 bits
and adds in an order of its own. In float32 the contributions themselves carry 24
bits, and the tally is exact to them.
"""

from __future__ import annotations

import dataclasses
import math

import torch

_NO_EXP = -1100  # exponent of a zero: below every finite float64's


def _sub_bins(values, segment_ids, num_segments):
    """(float64 values, segment ids, sub-bin ids, sub-bins per segment): many values
    bound for few bins (100k particles in 128 cells) would serialise the atomics on
    one address per bin, so each bin is spread over up to 32 sub-bins by slot index
    and the sub-bins are combined with dense reductions."""
    v = values.to(torch.float64)
    n = v.numel()
    ways = max(1, min(32, n // (16 * num_segments)))
    seg = segment_ids.long()
    sub = seg * ways + torch.arange(n, device=v.device) % ways
    return v, seg, sub, ways


def _bits(n: int) -> int:
    """Bits of a bin's scale such that ``n`` values below 2^bits cannot overflow
    int64."""
    return 62 - math.ceil(math.log2(max(n, 2)))


def conservation_rtol(n: int) -> float:
    """The relative difference that the fixed-point quantisation allows between
    two tallies of the same positive values over ``n`` slots in whatever bins: each
    is within n 2^-bits of the exact sum (bits = ``_bits(n)``, at most n values a
    bin), so the two differ by at most 2 n 2^-bits <= 2^(2 ceil(log2 n) - 61); and
    by the float64 roundings of the bins' conversion and of a sum over the cells,
    which 2^-40 covers for any mesh of fewer than 2^12 cells a slot."""
    return 2.0 ** (2 * math.ceil(math.log2(max(n, 2))) - 61) + 2.0 ** -40


def _exponents(v, sub, num_segments, ways):
    """Each bin's largest binary exponent (|v| < 2^exp): an integer max."""
    exp = torch.where(v != 0, torch.frexp(v).exponent, _NO_EXP)
    emax = torch.full((num_segments * ways,), _NO_EXP, dtype=exp.dtype, device=v.device)
    return emax.scatter_reduce_(0, sub, exp, reduce="amax").view(num_segments, ways).amax(1)


def _scales(emax, bits):
    """Exact powers of two 2^(bits - emax), built from their float64 bit pattern."""
    shift = (bits - emax.long()).clamp(-1000, 1000)
    return ((shift + 1023) << 52).view(torch.float64)


def _fixed(v, seg, sub, ways, num_segments, scale):
    """The int64 sum of each bin's values quantised at its scale."""
    q = torch.round(v * scale[seg]).to(torch.int64)
    acc = torch.zeros(num_segments * ways, dtype=torch.int64, device=v.device)
    return acc.index_add_(0, sub, q).view(num_segments, ways).sum(1)


def deterministic_segment_sum(values, segment_ids, num_segments):
    """Sum ``values`` into ``num_segments`` bins with a result that does not depend
    on summation order. Returns float64.

    Each bin's scale is set by its largest binary exponent (an integer max, itself
    order-independent): every value becomes an integer below 2^bits with
    bits = 62 - ceil(log2(n)), so n of them cannot overflow int64, and each bin keeps
    ``bits`` bits of its own largest value. A cold cell whose contributions are
    1e-20 of a hot one's is summed as finely as the hot one."""
    v, seg, sub, ways = _sub_bins(values, segment_ids, num_segments)
    scale = _scales(_exponents(v, sub, num_segments, ways), _bits(v.numel()))
    return _fixed(v, seg, sub, ways, num_segments, scale).to(torch.float64) / scale


def sharded_segment_sum(values, segment_ids, num_segments, exchange):
    """``deterministic_segment_sum`` of values spread over the shards of a particle
    decomposition: one ``values`` and ``segment_ids`` tensor per local shard, every
    shard holding as many slots. Returns the global sum on every local shard,
    bitwise equal to ``deterministic_segment_sum`` over the concatenated values."""
    parts = [_sub_bins(v, s, num_segments) for v, s in zip(values, segment_ids)]
    sizes = {p[0].numel() for p in parts}
    if len(sizes) != 1:
        raise ValueError(f"sharded_segment_sum: shards hold {sorted(sizes)} slots")
    bits = _bits(sizes.pop() * exchange.n)
    emax = exchange.max([_exponents(v, sub, num_segments, ways) for v, _, sub, ways in parts])
    scales = [_scales(e, bits) for e in emax]
    acc = exchange.sum([_fixed(v, seg, sub, ways, num_segments, sc)
                        for (v, seg, sub, ways), sc in zip(parts, scales)])
    return [a.to(torch.float64) / sc for a, sc in zip(acc, scales)]


def _local_cells(particles, mesh, block_offset, n_local):
    """Flat cell index of each particle in its shard's [n_local, ...] field slice
    (0 for a particle outside it) and the mask of particles inside it."""
    b_local = particles.block - block_offset
    owned = (b_local >= 0) & (b_local < n_local)
    b_local = torch.clamp(b_local, 0, n_local - 1)
    return mesh.flat_cell(b_local, particles.k, particles.j, particles.i), owned


def _tally_terms(fields, particles, mesh, block_offset=None):
    """(weight / dV of each live particle, its cell)."""
    if block_offset is None:
        cell = mesh.flat_cell(particles.block, particles.k, particles.j, particles.i)
        dv = mesh.block_volume[particles.block.long()]
        return torch.where(particles.alive, particles.weight / dv, 0.0), cell
    cell, owned = _local_cells(particles, mesh, block_offset, fields.energy_tally.shape[0])
    dv = mesh.block_volume[torch.clamp(particles.block, 0, mesh.n_blocks - 1).long()]
    return torch.where(particles.alive & owned, particles.weight / dv, 0.0), cell


def _deposit_terms(fields, particles, mesh, block_offset=None):
    """(weight of each particle absorbed this step, its cell)."""
    if block_offset is None:
        cell = mesh.flat_cell(particles.block, particles.k, particles.j, particles.i)
        return torch.where(particles.absorbed, particles.weight, 0.0), cell
    cell, owned = _local_cells(particles, mesh, block_offset, fields.energy_delta.shape[0])
    return torch.where(particles.absorbed & owned, particles.weight, 0.0), cell


def _with_tally(fields, tally):
    shape = fields.energy_tally.shape
    return dataclasses.replace(
        fields, energy_tally=tally.reshape(shape).to(fields.energy_tally.dtype))


def _with_deposit(fields, dep):
    ed = fields.energy_delta
    return dataclasses.replace(fields, energy_delta=ed + dep.reshape(ed.shape).to(ed.dtype))


def evaluate_radiation_energy(fields, particles, mesh, block_offset=None):
    """Radiation energy density per cell from live particle weights."""
    contrib, cell = _tally_terms(fields, particles, mesh, block_offset)
    return _with_tally(
        fields, deterministic_segment_sum(contrib, cell, fields.energy_tally.numel()))


def accumulate_absorption(fields, particles, mesh, block_offset=None):
    """Add the weights of this step's absorbed particles into ``energy_delta``
    (total energy units)."""
    contrib, cell = _deposit_terms(fields, particles, mesh, block_offset)
    return _with_deposit(
        fields, deterministic_segment_sum(contrib, cell, fields.energy_delta.numel()))


def evaluate_radiation_energy_sharded(fields, particles, mesh, exchange):
    """``evaluate_radiation_energy`` of the particle decomposition: one (replicated)
    ``fields`` and one ledger slice per local shard; returns the fields of each."""
    terms = [_tally_terms(f, p, mesh) for f, p in zip(fields, particles)]
    sums = sharded_segment_sum([t[0] for t in terms], [t[1] for t in terms],
                               fields[0].energy_tally.numel(), exchange)
    return [_with_tally(f, s) for f, s in zip(fields, sums)]


def accumulate_absorption_sharded(fields, particles, mesh, exchange):
    """``accumulate_absorption`` of the particle decomposition (see
    ``evaluate_radiation_energy_sharded``)."""
    terms = [_deposit_terms(f, p, mesh) for f, p in zip(fields, particles)]
    sums = sharded_segment_sum([t[0] for t in terms], [t[1] for t in terms],
                               fields[0].energy_delta.numel(), exchange)
    return [_with_deposit(f, s) for f, s in zip(fields, sums)]


def local_block_volume(mesh, block_offset, n_local):
    """Cell volume of the blocks [block_offset, block_offset + n_local), 1 for the
    padding blocks past the mesh's last block."""
    pad = max(0, block_offset + n_local - mesh.n_blocks)
    vol = torch.cat([mesh.block_volume, mesh.block_volume.new_ones(pad)])
    return vol[block_offset:block_offset + n_local]


def update_fluid(fields, mesh, block_offset=None):
    """Apply the net radiation-matter energy exchange to the matter:
    ``u += energy_delta / dV`` and ``sie = u / rho``."""
    if block_offset is None:
        vol = mesh.block_volume
    else:
        vol = local_block_volume(mesh, block_offset, fields.u.shape[0])
    u = fields.u + fields.energy_delta / vol[:, None, None, None]
    return dataclasses.replace(fields, u=u, sie=u / fields.rho)
