"""Photon sourcing (port of ``jaybenne_tpu/ops/sourcing.py``, one device).

  1. per cell: source energy ``erad`` -- thermal ``(4 sb / c) T^4 dV``, emission
     ``fleck * emis * dV * dt`` or external ``q * overlap * dV`` inside the source
     box -- and a stochastically rounded particle count
     ``n = floor(npc) + Bernoulli(npc - floor(npc))`` with
     ``npc = num_particles / n_cells`` (external: over the source cells only) and
     per-particle weight ``erad / n``;
  2. a candidate grid ``[n_cells, floor(npc)+1]`` (external: one row per source
     cell) holds every potential birth at a uniform in-cell position with an
     isotropic direction and a Planck energy;
  3. valid candidates go into the ledger's dead slots (``insert_particles``).

Emission debits each cell's ``energy_delta`` by the summed birth weights
``n * ew``, and its births are uniform in the step (``tau ~ U[0, 1)``); thermal
births start at ``tau = 0``. The external volume source (the Su-Olson driving
term, ``jaybenne/external_source*``) injects at the fixed rate ``q`` inside a box
while ``t < tmax``: its births are uniform over the in-step window
``[t, min(t + dt, tmax))``, nothing is debited from the matter, and
``source_num``/``source_ew`` accumulate over the emission pass before it. The
window comes from the host clock (``ExternalSource.window``) as a tensor of two
values, ``q * overlap`` and ``overlap / dt``, formed in float64 and rounded once
to the run's precision, as a Python float is where it multiplies a tensor: the
step writes them into a device buffer before it runs, so that its body holds no
host float of ``t`` and a CUDA graph's replay reads the step's own window.

Under a decomposition each shard sources its own births: under the particle one a
share of ``num_particles`` with the per-cell counts summed over shards before the
weights are set (``birth_counts``, then ``births`` with the summed counts); under
the spatial one the births of its own blocks (``block_offset``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..particles import insert_particles
from . import planck, rng, tally


@dataclasses.dataclass(frozen=True)
class ExternalSource:
    """Geometry of the external volume source, fixed for a run
    (``external_source_setup``): the box mask over cell centres ([B, nz, ny, nx]
    bool), the flat ids of the source cells, their count, the rate ``q``, the
    cutoff ``tmax`` and the injection temperature (0: the local matter's)."""

    inside: torch.Tensor
    cells: torch.Tensor
    n_cells: int
    q: float
    tmax: float
    temperature: float

    def window(self, t: float, dt: float) -> tuple:
        """``(q * overlap, overlap / dt)`` of the in-step source window [t, min(t +
        dt, tmax)), empty past the cutoff, as host floats."""
        overlap = min(max(min(t + dt, self.tmax) - t, 0.0), dt)
        return self.q * overlap, overlap / dt


def external_source_setup(mesh, jb) -> ExternalSource:
    """The source box of ``jb.external_source_*`` (the whole domain when unset) on
    ``mesh``: a cell is inside when its centre lies in ``[min, max)`` on every
    axis. Port of the JAX ``external_source_setup``."""
    box = jb.external_source_box or mesh.bounds
    xc, yc, zc = mesh.cell_centers()
    m = ((xc >= box[0]) & (xc < box[1]) & (yc >= box[2]) & (yc < box[3])
         & (zc >= box[4]) & (zc < box[5]))
    cells = torch.nonzero(m.reshape(-1)).reshape(-1)
    if cells.numel() == 0:
        raise ValueError("external_source box contains no cell centers")
    # the open-ended default stays below the float32 maximum, as in the JAX package
    return ExternalSource(inside=m, cells=cells, n_cells=int(cells.numel()),
                          q=jb.external_source_q, tmax=min(jb.external_source_tmax, 3.0e38),
                          temperature=jb.external_source_temperature)


def shard_source_cells(mesh, external: ExternalSource, block_offset: int, n_local: int):
    """The external source's cells in a spatial shard's blocks [block_offset,
    block_offset + n_local): their flat global ids and their rows in the shard's
    fields, int32 each (``births``' ``cells``). Its shape depends on the data: make
    it once, when the step is built."""
    ncpb = mesh.nx * mesh.ny * mesh.nz
    cflat = external.cells.to(torch.int32)
    b = cflat // ncpb
    cflat = cflat[(b >= block_offset) & (b < block_offset + n_local)]
    return cflat, cflat - block_offset * ncpb


@dataclasses.dataclass(frozen=True)
class BirthCounts:
    """A source's per-cell energy and birth count on one shard (``birth_counts``):
    ``n_cell`` births per cell of the shard's fields, ``erad`` their energy, the
    cells' temperature, the external source's window (its ``overlap / dt``, a
    0-dim tensor; None for another source) and the largest whole number of births
    per cell before the stochastic rounding."""

    erad: torch.Tensor
    temp: torch.Tensor
    n_cell: torch.Tensor
    window_frac: torch.Tensor | None
    base: int


def birth_counts(fields, mesh, gen, *, source_type, eos, sb, c, num_particles, dtype,
                 opacity=None, dt=0.0, t=0.0, external: ExternalSource | None = None,
                 block_offset=None, window=None) -> BirthCounts:
    """Step 1 of ``source_photons``: each cell's source energy and stochastically
    rounded birth count. With ``block_offset`` (the spatial decomposition) the
    fields are the shard's [Bl, ...] blocks from global block ``block_offset`` on,
    the per-cell rate is normalised by the mesh's cell count, and the padding blocks
    past the mesh's last one source nothing. The external source reads its
    ``window``, ``ExternalSource.window``'s two values in a tensor of ``dtype`` on
    the fields' device (made here from ``t`` and ``dt`` when not given: a step
    passes a buffer of its own)."""
    if source_type not in ("thermal", "emission", "external"):
        raise ValueError(f"unknown source_type {source_type!r}")
    dev = fields.rho.device
    B, nz, ny, nx = fields.rho.shape
    n_cells = B * nz * ny * nx if block_offset is None else mesh.total_cells

    temp = eos.temperature_from_density_internal_energy(fields.rho, fields.sie)
    if block_offset is None:
        dv = mesh.block_volume[:, None, None, None]
    else:
        dv = tally.local_block_volume(mesh, block_offset, B)[:, None, None, None]
    window_frac = None
    if source_type == "thermal":
        erad = (4.0 * sb / c) * temp**4 * dv
    elif source_type == "emission":
        erad = fields.fleck * opacity.emissivity(fields.rho, temp) * dv * dt
    else:
        if window is None:
            window = torch.tensor(external.window(t, dt), dtype=dtype, device=dev)
        window_frac = window[1]
        inside = external.inside
        if block_offset is not None:
            pad = max(0, block_offset + B - mesh.n_blocks)
            inside = torch.cat([inside, inside.new_zeros((pad,) + inside.shape[1:])])
            inside = inside[block_offset:block_offset + B]
        erad = window[0] * dv * inside.to(dtype)

    npc = float(num_particles) / float(external.n_cells if external else n_cells)
    base = int(npc)
    frac = npc - base
    bern = rng.uniform(gen, erad.shape, dtype, dev) < frac
    n_cell = base + bern.to(torch.int32)
    if block_offset is not None:  # padding blocks source nothing
        own = torch.arange(B, device=dev) + block_offset < mesh.n_blocks
        n_cell = torch.where(own[:, None, None, None], n_cell, 0)
    # cells with no source energy emit nothing
    n_cell = torch.where(erad > 0, n_cell, 0)
    return BirthCounts(erad=erad, temp=temp, n_cell=n_cell, window_frac=window_frac,
                       base=base)


def births(fields, particles, mesh, gen, counts: BirthCounts, n_glob=None, *, source_type,
           sb, c, dtype, dt=0.0, external: ExternalSource | None = None, block_offset=None,
           cells=None):
    """Steps 2 and 3 of ``source_photons``: the weights, the source diagnostics and
    the births of ``counts``. ``n_glob`` is each cell's birth count summed over the
    shards of a particle decomposition (default: this shard's own), so the summed
    energy per cell is exactly ``erad`` at any shard count. ``cells`` is a spatial
    shard's ``shard_source_cells`` for the external source (made here when not
    given). Returns (fields, particles, n_dropped); the ledger is updated in
    place."""
    dev = fields.rho.device
    B, nz, ny, nx = fields.rho.shape
    erad, n_cell = counts.erad, counts.n_cell
    if n_glob is None:
        n_glob = n_cell
    n_f = n_glob.to(dtype)
    ew = torch.where(n_glob > 0, erad / n_f.clamp_min(1.0), 0.0).to(dtype)
    if source_type == "external":
        # accumulate over the emission pass: source_num * source_ew stays the
        # energy sourced per cell; nothing is debited from the matter
        tot_e = fields.source_num * fields.source_ew + n_f * ew
        new_num = fields.source_num + n_f
        fields = dataclasses.replace(fields, source_num=new_num, source_ew=torch.where(
            new_num > 0, tot_e / new_num.clamp_min(1.0), 0.0).to(dtype))
    else:
        debit = -(n_f * ew) if source_type == "emission" else torch.zeros_like(ew)
        fields = dataclasses.replace(fields, source_num=n_f, source_ew=ew, energy_delta=debit)

    # ---- candidate grid: every cell, or the source cells ----------------------
    K = counts.base + 1  # max births per cell
    ncpb = nx * ny * nz
    rows = None
    if external:
        cflat = external.cells.to(torch.int32)  # flat global ids
        if block_offset is None:
            rows = cflat
        else:  # the source cells in this shard's blocks
            cflat, rows = cells or shard_source_cells(mesh, external, block_offset, B)
    else:
        cflat = torch.arange(B * ncpb, dtype=torch.int32, device=dev)
    C = cflat.numel()
    i_c = cflat % nx
    j_c = (cflat // nx) % ny
    k_c = (cflat // (nx * ny)) % nz
    b_c = cflat // ncpb
    if block_offset is not None and not external:  # global block ids
        b_c = torch.clamp(b_c + block_offset, max=mesh.n_blocks - 1)

    def per_row(v):
        """A per-cell tensor at the candidate rows, [C, 1]."""
        v = v.reshape(-1)
        return (v[rows.long()] if external else v).reshape(C, 1)

    valid = torch.arange(K, dtype=torch.int32, device=dev)[None, :] < per_row(n_cell)

    shape = (C, K)
    ux = rng.uniform(gen, shape, dtype, dev)
    uy = rng.uniform(gen, shape, dtype, dev)
    uz = rng.uniform(gen, shape, dtype, dev)
    ndir = rng.isotropic_direction(gen, shape, dtype, dev)
    dxv = mesh.block_dx[b_c.long()]  # [C, 3]
    temp_rows = per_row(counts.temp).to(dtype)
    if external and external.temperature > 0:  # a fixed injection spectrum
        temp_rows = torch.full_like(temp_rows, external.temperature)
    energy = planck.sample_planck_energy(gen, sb, temp_rows, shape, dtype, dev)
    if source_type == "emission":
        tau = rng.uniform(gen, shape, dtype, dev)
    elif source_type == "external":  # uniform over the in-step source window
        tau = rng.uniform(gen, shape, dtype, dev) * counts.window_frac
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
        weight=per_row(ew).expand(shape),
        energy=energy,
        block=b_c[:, None].expand(shape),
        i=i_c[:, None].expand(shape),
        j=j_c[:, None].expand(shape),
        k=k_c[:, None].expand(shape),
    )
    particles, n_dropped = insert_particles(particles, cand, valid)
    return fields, particles, n_dropped


def source_photons(
    fields, particles, mesh, gen, *, source_type, eos, sb, c, num_particles, dtype,
    opacity=None, dt=0.0, t=0.0, external: ExternalSource | None = None, block_offset=None,
    window=None, cells=None,
):
    """Returns (fields, particles, n_dropped); the ledger is updated in place.
    ``gen`` is the stream's ``torch.Generator`` (see ``ops/rng.py``); emission
    needs the ``opacity`` model and the step ``dt``, the external source the step's
    start time ``t`` (or its ``window``) and its ``external`` geometry;
    ``block_offset`` is the spatial decomposition's (see ``birth_counts``), and
    ``cells`` its shard's source cells (see ``births``)."""
    counts = birth_counts(fields, mesh, gen, source_type=source_type, eos=eos, sb=sb, c=c,
                          num_particles=num_particles, dtype=dtype, opacity=opacity, dt=dt,
                          t=t, external=external, block_offset=block_offset, window=window)
    return births(fields, particles, mesh, gen, counts, source_type=source_type, sb=sb, c=c,
                  dtype=dtype, dt=dt, external=external, block_offset=block_offset,
                  cells=cells)
