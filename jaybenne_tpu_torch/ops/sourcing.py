"""Photon sourcing (port of ``jaybenne_tpu/ops/sourcing.py``, thermal and emission
branches).

  1. per cell: source energy ``erad`` -- thermal ``(4 sb / c) T^4 dV`` or emission
     ``fleck * emis * dV * dt`` -- and a stochastically rounded particle count
     ``n = floor(npc) + Bernoulli(npc - floor(npc))`` with
     ``npc = num_particles / n_cells`` and per-particle weight ``erad / n``;
  2. a candidate grid ``[n_cells, floor(npc)+1]`` holds every potential birth at a
     uniform in-cell position with an isotropic direction and a Planck energy;
  3. valid candidates go into the ledger's dead slots (``insert_particles``).

Emission debits each cell's ``energy_delta`` by the summed birth weights
``n * ew``, and its births are uniform in the step (``tau ~ U[0, 1)``); thermal
births start at ``tau = 0``. The external source arrives with slice 5 (ROADMAP
Queue 1, item 14).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import not_ported
from ..particles import insert_particles
from . import planck, rng


def source_photons(
    fields, particles, mesh, gen, *, source_type, eos, sb, c, num_particles, dtype,
    opacity=None, dt=0.0,
):
    """Returns (fields, particles, n_dropped); the ledger is updated in place.
    ``gen`` is the stream's ``torch.Generator`` (see ``ops/rng.py``); emission
    needs the ``opacity`` model and the step ``dt``."""
    if source_type == "external":
        raise not_ported("the external volume source", "Queue 1, item 14")
    if source_type not in ("thermal", "emission"):
        raise ValueError(f"unknown source_type {source_type!r}")
    dev = fields.rho.device
    B, nz, ny, nx = fields.rho.shape
    C = B * nz * ny * nx

    temp = eos.temperature_from_density_internal_energy(fields.rho, fields.sie)
    dv = mesh.block_volume[:, None, None, None]
    if source_type == "thermal":
        erad = (4.0 * sb / c) * temp**4 * dv
    else:
        erad = fields.fleck * opacity.emissivity(fields.rho, temp) * dv * dt

    npc = float(num_particles) / float(C)
    base = int(npc)
    frac = npc - base
    bern = rng.uniform(gen, erad.shape, dtype, dev) < frac
    n_cell = base + bern.to(torch.int32)
    # cells with no source energy emit nothing
    n_cell = torch.where(erad > 0, n_cell, 0)
    n_f = n_cell.to(dtype)
    ew = torch.where(n_cell > 0, erad / n_f.clamp_min(1.0), 0.0).to(dtype)
    debit = -(n_f * ew) if source_type == "emission" else torch.zeros_like(ew)
    fields = dataclasses.replace(fields, source_num=n_f, source_ew=ew, energy_delta=debit)

    # ---- candidate grid ------------------------------------------------------
    K = base + 1  # max births per cell
    cflat = torch.arange(C, dtype=torch.int32, device=dev)
    i_c = cflat % nx
    j_c = (cflat // nx) % ny
    k_c = (cflat // (nx * ny)) % nz
    b_c = cflat // (nx * ny * nz)
    valid = torch.arange(K, dtype=torch.int32, device=dev)[None, :] < n_cell.reshape(C, 1)

    shape = (C, K)
    ux = rng.uniform(gen, shape, dtype, dev)
    uy = rng.uniform(gen, shape, dtype, dev)
    uz = rng.uniform(gen, shape, dtype, dev)
    ndir = rng.isotropic_direction(gen, shape, dtype, dev)
    dxv = mesh.block_dx[b_c.long()]  # [C, 3]
    temp_flat = temp.reshape(C, 1).to(dtype)
    energy = planck.sample_planck_energy(gen, sb, temp_flat, shape, dtype, dev)
    if source_type == "emission":
        tau = rng.uniform(gen, shape, dtype, dev)
    else:
        tau = torch.zeros(shape, dtype=dtype, device=dev)

    cand = dict(
        x=(i_c.to(dtype)[:, None] + ux) * dxv[:, 0:1],
        y=(j_c.to(dtype)[:, None] + uy) * dxv[:, 1:2],
        z=(k_c.to(dtype)[:, None] + uz) * dxv[:, 2:3],
        vx=c * ndir[0],
        vy=c * ndir[1],
        vz=c * ndir[2],
        tau=tau,
        weight=ew.reshape(C, 1).expand(shape),
        energy=energy,
        block=b_c[:, None].expand(shape),
        i=i_c[:, None].expand(shape),
        j=j_c[:, None].expand(shape),
        k=k_c[:, None].expand(shape),
    )
    particles, n_dropped = insert_particles(particles, cand, valid)
    return fields, particles, n_dropped
