"""Derived transport fields (port of ``jaybenne_tpu/ops/fleck.py``).

Fleck factor (Fleck & Cummings 1971), per cell::

    f = 1 / (1 + (4 * emis / (rho * cv * T)) * dt)

DDMC face probability (Habetler-Matkowsky extrapolation, lambda_ext = 0.7104), per
face between cells l (lower) and u (upper)::

    tau_s = dx_s * (sigma_s + sigma_a)_s    for side s in {l, u}, dx_s along the face axis
    tau_s = tau_s            if tau_s > tau_ddmc
          = 2 * lambda_ext   otherwise
    P     = 2 / (3 * (tau_l + tau_u))

where ``dx_s`` is the cell size of the side's own block. A face on the domain
boundary takes its outer side from the field boundary conditions: the opposite
boundary cell on a periodic axis, the cell itself (a zero-gradient ghost)
otherwise.

The JAX package evaluates each side by locating a point a quarter local cell from
the face in its block forest. On a uniform forest that lands exactly in the index
neighbour, so there the sides are index neighbours on the global grid, which gives
the same numbers. On a refined forest (``max_level > 0``) the port samples
positions as the JAX package does: the point is wrapped (periodic field BC) or
clamped into the domain, located in the forest, and the owning cell's
``sigma_t dx`` of its own block is read. A coarse/fine face then holds a
different value on each side's block.

Under the spatial decomposition a shard holds only its blocks' sigma_t. Every side
of a face of one of its blocks lies in that block or in the first cell layer of a
neighbouring block (same level, 2:1 fine or 2:1 coarse alike), so the shards
all-gather only their blocks' boundary-surface sigma_t
(``pack_boundary_surface``), and ``ddmc_face_probs_spatial`` gives each shard
bitwise the values of ``ddmc_face_probs`` on its own blocks.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.constants import LAM_EXT
from ..utils.device import device_const
from .transport_kernel import to_global_cells


def fleck_factor(rho, sie, eos, opacity, dt, dtype):
    """Per-cell Fleck factor."""
    temp = eos.temperature_from_density_internal_energy(rho, sie)
    cv = eos.specific_heat_from_density_internal_energy(rho, sie)
    emis = opacity.emissivity(rho, temp)
    return (1.0 / (1.0 + (4.0 * emis / (rho * cv * temp)) * dt)).to(dtype)


def _block_faces(gface, mesh, axis, blocks=None):
    """Global face array along ``axis`` -> the per-block face array of ``blocks``
    (default every block; each block holds both faces of each of its cells, so
    blocks share their common faces)."""
    nrbz, nrby, nrbx = mesh.root_grid
    dev = gface.device
    b = torch.arange(mesh.n_blocks, device=dev) if blocks is None else blocks
    bk = (b // (nrbx * nrby), (b // nrbx) % nrby, b % nrbx)  # (z, y, x) block index
    nloc = (mesh.nz, mesh.ny, mesh.nx)
    ax = 2 - axis  # (x, y, z) axis -> (z, y, x) dimension
    idx = []
    for d in range(3):
        n = nloc[d] + (1 if d == ax else 0)
        shape = [b.numel(), 1, 1, 1]
        shape[d + 1] = n
        idx.append((bk[d][:, None] * nloc[d] + torch.arange(n, device=dev)).reshape(shape))
    return gface[idx[0], idx[1], idx[2]]


def ddmc_face_probs(mesh, sigma_t, tau_ddmc, periodic_flags, dtype, blocks=None):
    """Face probability arrays (px, py, pz) of shapes ``[B, nz, ny, nx+1]``,
    ``[B, nz, ny+1, nx]`` and ``[B, nz+1, ny, nx]``; zeros on inactive axes.

    ``sigma_t``: per-cell total interaction coefficient [B, nz, ny, nx].
    ``periodic_flags``: (x, y, z) bools from the *field* boundary conditions.
    ``blocks``: the ids of the blocks to return faces of (default every block).
    """
    if mesh.max_level > 0:
        return _face_probs_refined(mesh, sigma_t, tau_ddmc, periodic_flags, dtype, blocks)
    nz, ny, nx = sigma_t.shape[1:]
    B = sigma_t.shape[0] if blocks is None else blocks.numel()
    shapes = ((B, nz, ny, nx + 1), (B, nz, ny + 1, nx), (B, nz + 1, ny, nx))
    out = []
    for axis in range(3):
        if axis >= mesh.ndim:
            out.append(torch.zeros(shapes[axis], dtype=dtype, device=sigma_t.device))
            continue
        tau = (sigma_t * mesh.block_dx[:, axis][:, None, None, None]).to(dtype)
        nrb = mesh.root_grid
        tau = to_global_cells(tau.reshape(-1), mesh).reshape(
            nrb[0] * nz, nrb[1] * ny, nrb[2] * nx).movedim(2 - axis, -1)  # face axis last
        lower = torch.cat([tau[..., -1:] if periodic_flags[axis] else tau[..., :1], tau], -1)
        upper = torch.cat([tau, tau[..., :1] if periodic_flags[axis] else tau[..., -1:]], -1)
        thin = device_const(2.0 * LAM_EXT, dtype, tau.device)
        lower = torch.where(lower > tau_ddmc, lower, thin)
        upper = torch.where(upper > tau_ddmc, upper, thin)
        p = (2.0 / (3.0 * (lower + upper))).to(dtype).movedim(-1, 2 - axis)
        out.append(_block_faces(p, mesh, axis, blocks))
    return tuple(out)


def _wrap_or_clamp(coord, lo, hi, periodic):
    """A sample point's coordinate brought into [lo, hi] by the field BC: wrapped
    on a periodic axis, clamped otherwise (at the coordinate's precision, as the
    JAX package rounds it)."""
    dev, dt = coord.device, coord.dtype
    lo_t = device_const(lo, dt, dev)
    if periodic:
        span = device_const(hi - lo, dt, dev)
        return lo_t + torch.remainder(coord - lo_t, span)
    return torch.clamp(coord, lo_t, device_const(hi, dt, dev))


def _sample_tau(mesh, tau_flat, pos, axis, periodic_flags):
    """``tau`` along ``axis`` of the cell owning the physical point ``pos``."""
    b = mesh.bounds
    p = [_wrap_or_clamp(pos[a], b[2 * a], b[2 * a + 1], periodic_flags[a]) for a in range(3)]
    blk = mesh.locate_block(*p)
    org = mesh.block_origin[blk.long()]
    i, j, k = mesh.cell_of_local(blk, *(p[a] - org[..., a] for a in range(3)))
    flat = mesh.flat_cell(blk.long(), k.long(), j.long(), i.long())
    return tau_flat[flat, axis]


def _face_probs_refined(mesh, sigma_t, tau_ddmc, periodic_flags, dtype, blocks=None):
    """``ddmc_face_probs`` on a refined forest: each face's two sides sampled a
    quarter local cell to either side of its centre (``jaybenne_tpu/ops/fleck.py``
    ``ddmc_face_probs``)."""
    nz, ny, nx = sigma_t.shape[1:]
    dev = sigma_t.device
    dxv = mesh.block_dx.to(dtype)
    tau_flat = (sigma_t[..., None] * dxv[:, None, None, None, :]).reshape(-1, 3).to(dtype)
    org = mesh.block_origin.to(dtype)
    if blocks is not None:
        dxv, org = dxv[blocks], org[blocks]
    B = dxv.shape[0]
    thin = device_const(2.0 * LAM_EXT, dtype, dev)
    shapes = ((B, nz, ny, nx + 1), (B, nz, ny + 1, nx), (B, nz + 1, ny, nx))
    out = []
    for axis in range(3):
        if axis >= mesh.ndim:
            out.append(torch.zeros(shapes[axis], dtype=dtype, device=dev))
            continue
        pos = []
        for a, n in enumerate((nx, ny, nz)):
            f = torch.arange(n + (a == axis), dtype=dtype, device=dev)
            if a != axis:
                f = f + 0.5
            view = [1, 1, 1, 1]
            view[3 - a] = -1
            pos.append((org[:, a].reshape(B, 1, 1, 1) + f.reshape(view)
                        * dxv[:, a].reshape(B, 1, 1, 1)).expand(shapes[axis]))
        off = 0.25 * dxv[:, axis].reshape(B, 1, 1, 1)
        sides = []
        for sgn in (-1, 1):
            q = list(pos)
            q[axis] = pos[axis] - off if sgn < 0 else pos[axis] + off
            tau = _sample_tau(mesh, tau_flat, q, axis, periodic_flags)
            sides.append(torch.where(tau > tau_ddmc, tau, thin))
        out.append((2.0 / (3.0 * (sides[0] + sides[1]))).to(dtype))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _surface_cells(nz, ny, nx) -> np.ndarray:
    """Flat in-block ids of an (nz, ny, nx) block's boundary cells on its active
    axes, each once, in flat order."""
    kk, jj, ii = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij")
    on = (ii == 0) | (ii == nx - 1)
    if ny > 1:
        on |= (jj == 0) | (jj == ny - 1)
    if nz > 1:
        on |= (kk == 0) | (kk == nz - 1)
    return np.flatnonzero(on.reshape(-1))


def pack_boundary_surface(mesh, sigma_local):
    """[Bl, nz, ny, nx] local sigma_t -> [Bl, S] boundary-surface values: the
    payload each shard all-gathers for the DDMC face probabilities."""
    surf = device_const(_surface_cells(mesh.nz, mesh.ny, mesh.nx), torch.int64, sigma_local.device)
    return sigma_local.reshape(sigma_local.shape[0], -1)[:, surf]


def ddmc_face_probs_spatial(mesh, sigma_local, surf_glob, offset, tau_ddmc, periodic_flags,
                            dtype):
    """The DDMC face probabilities of one shard's blocks [offset, offset + Bl):
    bitwise ``ddmc_face_probs`` of the whole mesh restricted to them, from the
    shard's own sigma_t ``sigma_local`` [Bl, nz, ny, nx] and every block's
    boundary surface ``surf_glob`` [n Bl, S] (``pack_boundary_surface``,
    all-gathered). The shard sees its own blocks whole and every other block's
    surface; the faces of its blocks read nothing else. Padding blocks past the
    mesh's last one get zeros. Returns local (px, py, pz) of shapes [Bl, nz, ny,
    nx+1] etc."""
    Bl, nz, ny, nx = sigma_local.shape
    B = mesh.n_blocks
    surf = device_const(_surface_cells(nz, ny, nx), torch.int64, sigma_local.device)
    visible = sigma_local.new_zeros((surf_glob.shape[0], nz * ny * nx))
    visible[:, surf] = surf_glob.to(visible.dtype)
    visible[offset:offset + Bl] = sigma_local.reshape(Bl, -1)
    visible = visible[:B].reshape(B, nz, ny, nx)
    n_real = max(0, min(Bl, B - offset))
    blocks = torch.arange(offset, offset + n_real, device=sigma_local.device)
    faces = ddmc_face_probs(mesh, visible, tau_ddmc, periodic_flags, dtype, blocks)
    if n_real == Bl:
        return faces
    return tuple(torch.cat([f, f.new_zeros((Bl - n_real,) + f.shape[1:])]) for f in faces)
