"""Tallies and fluid feedback (port of ``jaybenne_tpu/ops/tally.py``): the
radiation-energy tally, the absorption deposition and the fluid update.

The JAX package sums per-particle ``weight / dV`` into cells with an atomic-free
``segment_sum``. On a GPU, ``index_add_`` on floats adds in whatever order the
atomics land, so two runs differ in the last bits. Here each contribution is first
quantised to 64-bit fixed point at a power-of-two scale chosen per cell, and the
quantised values are summed with integer adds. Integer addition is associative, so
the tally and the absorption deposition repeat bitwise on any device in any
order.
"""

from __future__ import annotations

import dataclasses
import math

import torch

_NO_EXP = -1100  # exponent of a zero: below every finite float64's


def deterministic_segment_sum(values, segment_ids, num_segments):
    """Sum ``values`` into ``num_segments`` bins with a result that does not depend
    on summation order. Returns float64.

    Each bin's scale is set by its largest binary exponent (an integer max, itself
    order-independent): every value becomes an integer below 2^bits with
    bits = 62 - ceil(log2(n)), so n of them cannot overflow int64, and each bin keeps
    ``bits`` bits of its own largest value. A cold cell whose contributions are
    1e-20 of a hot one's is summed as finely as the hot one.

    Many values bound for few bins (100k particles in 128 cells) would serialise
    the atomics on one address per bin, so each bin is spread over up to 32
    sub-bins by slot index and the sub-bins are combined with dense reductions."""
    v = values.to(torch.float64)
    n = v.numel()
    ways = max(1, min(32, n // (16 * num_segments)))
    seg = segment_ids.long()
    sub = seg * ways + torch.arange(n, device=v.device) % ways
    bits = 62 - math.ceil(math.log2(max(n, 2)))
    exp = torch.where(v != 0, torch.frexp(v).exponent, _NO_EXP)  # |v| < 2^exp
    emax = torch.full((num_segments * ways,), _NO_EXP, dtype=exp.dtype, device=v.device)
    emax = emax.scatter_reduce_(0, sub, exp, reduce="amax").view(num_segments, ways).amax(1)
    # exact powers of two 2^(bits - emax), built from their float64 bit pattern
    shift = (bits - emax.long()).clamp(-1000, 1000)
    scale = ((shift + 1023) << 52).view(torch.float64)
    q = torch.round(v * scale[seg]).to(torch.int64)
    acc = torch.zeros(num_segments * ways, dtype=torch.int64, device=v.device)
    acc = acc.index_add_(0, sub, q).view(num_segments, ways).sum(1)
    return acc.to(torch.float64) / scale


def evaluate_radiation_energy(fields, particles, mesh):
    """Radiation energy density per cell from live particle weights."""
    shape = fields.energy_tally.shape
    cell = mesh.flat_cell(particles.block, particles.k, particles.j, particles.i)
    dv = mesh.block_volume[particles.block.long()]
    contrib = torch.where(particles.alive, particles.weight / dv, 0.0)
    tally = deterministic_segment_sum(contrib, cell, fields.energy_tally.numel())
    return dataclasses.replace(
        fields, energy_tally=tally.reshape(shape).to(fields.energy_tally.dtype)
    )


def accumulate_absorption(fields, particles, mesh):
    """Add the weights of this step's absorbed particles into ``energy_delta``
    (total energy units)."""
    cell = mesh.flat_cell(particles.block, particles.k, particles.j, particles.i)
    contrib = torch.where(particles.absorbed, particles.weight, 0.0)
    dep = deterministic_segment_sum(contrib, cell, fields.energy_delta.numel())
    ed = fields.energy_delta
    return dataclasses.replace(fields, energy_delta=ed + dep.reshape(ed.shape).to(ed.dtype))


def update_fluid(fields, mesh):
    """Apply the net radiation-matter energy exchange to the matter:
    ``u += energy_delta / dV`` and ``sie = u / rho``."""
    u = fields.u + fields.energy_delta / mesh.block_volume[:, None, None, None]
    return dataclasses.replace(fields, u=u, sie=u / fields.rho)
