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

On a GPU the tally and the deposit are one pass of the tally kernel
(``csrc/tally_kernel.cu``, three launches: the exponents, the sums, the cells)
over every local shard's slots, both from one read of each slot
(``tallies``): its atomics are an integer max and integer adds, so its bins are
the plain version's bit for bit. On the CPU (or with ``plain``) the functions
below run as written: the kernel's plain versions.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from ..particles import join_slices

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


def _on_card(particles, plain) -> bool:
    """Whether the ledger takes the tally kernel: on a GPU unless ``plain``; raises
    on any other device that is not the CPU."""
    if particles.alive.is_cuda and not plain:
        return True
    if particles.alive.device.type != "cpu" and not plain:
        raise ValueError(f"tally: unsupported device {particles.alive.device}")
    return False


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


def tallies(fields, particles, mesh, absorb, exchange=None, block_offsets=None, plain=False):
    """The absorption deposit (with ``absorb``) and then the tally of the local
    shards' ``fields`` from their ledgers ``particles``: one shard's own (no
    ``exchange``, no ``block_offsets``); under the particle decomposition
    (``exchange``) every shard's, reduced in the integer domain; under the spatial
    decomposition (``block_offsets``, each shard's first block) each shard's own
    particles into its own cells. Returns the fields of each shard.

    On a GPU one pass of the tally kernel over every local shard's slots, the
    deposit and the tally from one read of each slot (the ledgers adjacent slices
    of one ledger, ``join_slices``); on the CPU (or with ``plain``)
    ``accumulate_absorption`` and ``evaluate_radiation_energy`` (or their sharded
    forms) a shard at a time."""
    if _on_card(particles[0], plain):
        return _tally_cuda(fields, particles, mesh, absorb, exchange, block_offsets)
    if block_offsets is not None:
        out = []
        for f, p, off in zip(fields, particles, block_offsets):
            if absorb:
                f = accumulate_absorption(f, p, mesh, block_offset=off)
            out.append(evaluate_radiation_energy(f, p, mesh, block_offset=off))
        return out
    if exchange is None:
        f, p = fields[0], particles[0]
        if absorb:
            f = accumulate_absorption(f, p, mesh)
        return [evaluate_radiation_energy(f, p, mesh)]
    if absorb:
        fields = accumulate_absorption_sharded(fields, particles, mesh, exchange)
    return evaluate_radiation_energy_sharded(fields, particles, mesh, exchange)


# the tally kernel's bins, by (device, kinds, bins): int32 exponents at _NO_EXP and
# int64 sums at 0, left so by each call's cell launch
_SCRATCH: dict = {}
# output shards a cell launch of the tally kernel writes (csrc/tally_kernel.cu,
# kMaxParts)
TALLY_PARTS = 32


def _scratch(device, kinds, bins) -> tuple:
    """The kernel's (exponents, sums) of ``kinds`` x ``bins`` bins on ``device``,
    made at the first call for them (on the eager first step of a run, before any
    capture) and kept."""
    key = (torch.device(device), kinds, bins)
    hit = _SCRATCH.get(key)
    if hit is None:
        hit = _SCRATCH[key] = (
            torch.full((kinds * bins,), _NO_EXP, dtype=torch.int32, device=device),
            torch.zeros(kinds * bins, dtype=torch.int64, device=device))
    return hit


def _block_volumes(mesh) -> torch.Tensor:
    """``mesh.block_volume``, made once per mesh and kept in ``mesh.derived``."""
    hit = mesh.derived.get("block volume")
    if hit is None:
        hit = mesh.derived["block volume"] = mesh.block_volume.contiguous()
    return hit


def _tally_cuda(fields, particles, mesh, deposit, exchange=None, block_offsets=None) -> list:
    """One pass of the tally kernel (``csrc/tally_kernel.cu``) on PyTorch's current
    stream, without waiting for it: the deposit into ``energy_delta`` (with
    ``deposit``) and the tally into ``energy_tally`` of every local shard's fields,
    from the local shards' ledgers (adjacent slices of one ledger). Under a process
    group whose shards are not all local (``exchange.n`` above the local count) the
    exponents and then the sums are reduced over it between the launches, as
    ``sharded_segment_sum`` reduces them. Returns each shard's fields. Raises unless
    the ledger, the fields and the mesh's cell volumes are of one floating type on
    one GPU."""
    from . import cuda_lib

    m = len(particles)
    joined, bounds = join_slices(particles)
    dev, dt = joined.weight.device, joined.weight.dtype
    cap_l = particles[0].capacity
    if any(hi - lo != cap_l for lo, hi in bounds) or cap_l < 1:
        raise ValueError(f"tally kernel: shards of {[hi - lo for lo, hi in bounds]} slots")
    vol = _block_volumes(mesh)
    names = ("energy_tally", "energy_delta") if deposit else ("energy_tally",)
    outs = [getattr(f, name) for f in fields for name in names]
    cols = (joined.weight, joined.block, joined.i, joined.j, joined.k, joined.alive,
            joined.absorbed)
    if (dt not in (torch.float32, torch.float64) or vol.dtype != dt or vol.device != dev
            or any(t.dtype != dt or t.device != dev or not t.is_contiguous() for t in outs)
            or any(not t.is_contiguous() for t in cols) or len(fields) != m):
        raise ValueError("tally kernel: the ledger, the fields and the mesh of one floating "
                         "type on one GPU, contiguous, a field set a shard")
    spatial = block_offsets is not None
    cells = fields[0].energy_tally.numel()
    if spatial:
        bl = fields[0].energy_tally.shape[0]
        if any(off != block_offsets[0] + g * bl for g, off in enumerate(block_offsets)):
            raise ValueError(f"tally kernel: shards at blocks {list(block_offsets)}, {bl} a "
                             "shard")
        bins, bits, off0 = m * cells, _bits(cap_l), block_offsets[0]
    else:
        if cells != mesh.total_cells:
            raise ValueError(f"tally kernel: {cells} cells of a field, {mesh.total_cells} in "
                             "the mesh")
        n = 1 if exchange is None else exchange.n
        bins, bits, off0, bl = cells, _bits(cap_l * n), 0, 0
    emax, acc = _scratch(dev, 1 + int(deposit), bins)
    new_tally = [torch.empty_like(f.energy_tally) for f in fields]
    new_delta = [torch.empty_like(f.energy_delta) for f in fields] if deposit else None
    P = ctypes.c_void_p

    def ptrs(ts):
        return None if ts is None else (P * m)(*(t.data_ptr() for t in ts))

    def launch(stages):
        cuda_lib.library().call(
            "jb_tally_launch", stages, int(dt == torch.float64), joined.weight.data_ptr(),
            joined.block.data_ptr(), joined.k.data_ptr(), joined.j.data_ptr(),
            joined.i.data_ptr(), joined.alive.data_ptr(),
            joined.absorbed.data_ptr() if deposit else None, vol.data_ptr(), mesh.n_blocks,
            joined.capacity, cap_l, int(spatial), off0, bl, mesh.nx, mesh.ny, mesh.nz, bins,
            bits, emax.data_ptr(), acc.data_ptr(), m, ptrs(new_tally),
            ptrs([f.energy_delta for f in fields] if deposit else None), ptrs(new_delta),
            cuda_lib.stream_handle(dev))

    if spatial or exchange is None or exchange.n == m:
        launch(7)
    else:  # the other ranks' slots: their exponents, then their sums
        launch(1)
        emax.copy_(exchange.max([emax])[0])
        launch(2)
        acc.copy_(exchange.sum([acc])[0])
        launch(4)
    cuda_lib.LAUNCHES["tally"] += 2 + -(-m // TALLY_PARTS)
    if not deposit:
        return [dataclasses.replace(f, energy_tally=t) for f, t in zip(fields, new_tally)]
    return [dataclasses.replace(f, energy_tally=t, energy_delta=d)
            for f, t, d in zip(fields, new_tally, new_delta)]


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
