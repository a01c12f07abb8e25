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

On a GPU the face probabilities are one launch of ``csrc/faces_kernel.cu`` a step
(every local shard's blocks in one, ``ddmc_face_probs_shards``): which cell holds
each side of each face depends on the mesh and the field BCs alone, so
``face_sides`` makes that map once per mesh, by the code that samples the sides
here with each side's flat cell id in place of its tau. On the CPU (or with
``plain``) the functions below run as written: the kernel's plain versions.
"""

from __future__ import annotations

import ctypes
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


def _face_shapes(B, nz, ny, nx) -> tuple:
    """The shapes of the (px, py, pz) face arrays of ``B`` blocks."""
    return (B, nz, ny, nx + 1), (B, nz, ny + 1, nx), (B, nz + 1, ny, nx)


def _global_sides(vec, mesh, axis, periodic):
    """A per-cell vector in block order [B * nz*ny*nx] -> the (lower, upper) side
    values of every face along ``axis`` on the global grid, the face axis last:
    each face's index neighbours, the outer side of a boundary face the opposite
    boundary cell on a periodic axis and the cell itself otherwise."""
    nrb = mesh.root_grid
    t = to_global_cells(vec, mesh).reshape(
        nrb[0] * mesh.nz, nrb[1] * mesh.ny, nrb[2] * mesh.nx).movedim(2 - axis, -1)
    lower = torch.cat([t[..., -1:] if periodic else t[..., :1], t], -1)
    upper = torch.cat([t, t[..., :1] if periodic else t[..., -1:]], -1)
    return lower, upper


def ddmc_face_probs(mesh, sigma_t, tau_ddmc, periodic_flags, dtype, blocks=None, plain=False):
    """Face probability arrays (px, py, pz) of shapes ``[B, nz, ny, nx+1]``,
    ``[B, nz, ny+1, nx]`` and ``[B, nz+1, ny, nx]``; zeros on inactive axes.

    ``sigma_t``: per-cell total interaction coefficient [B, nz, ny, nx].
    ``periodic_flags``: (x, y, z) bools from the *field* boundary conditions.
    ``blocks``: the ids of the blocks to return faces of (default every block; the
    plain version's alone).

    On a GPU one launch of the face kernel (``face_probs_kernel``), on the CPU (or
    with ``plain``) the plain version below.
    """
    if _on_card(sigma_t, plain):
        if blocks is not None:
            raise ValueError("ddmc_face_probs: the face kernel takes every block")
        return _faces_cuda(mesh, [sigma_t], None, [0], tau_ddmc, periodic_flags, dtype)[0]
    if mesh.max_level > 0:
        return _face_probs_refined(mesh, sigma_t, tau_ddmc, periodic_flags, dtype, blocks)
    nz, ny, nx = sigma_t.shape[1:]
    B = sigma_t.shape[0] if blocks is None else blocks.numel()
    shapes = _face_shapes(B, nz, ny, nx)
    out = []
    for axis in range(3):
        if axis >= mesh.ndim:
            out.append(torch.zeros(shapes[axis], dtype=dtype, device=sigma_t.device))
            continue
        tau = (sigma_t * mesh.block_dx[:, axis][:, None, None, None]).to(dtype)
        lower, upper = _global_sides(tau.reshape(-1), mesh, axis, periodic_flags[axis])
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


def _sample_cell(mesh, pos, periodic_flags):
    """The flat id of the cell owning the physical point ``pos``."""
    b = mesh.bounds
    p = [_wrap_or_clamp(pos[a], b[2 * a], b[2 * a + 1], periodic_flags[a]) for a in range(3)]
    blk = mesh.locate_block(*p)
    org = mesh.block_origin[blk.long()]
    i, j, k = mesh.cell_of_local(blk, *(p[a] - org[..., a] for a in range(3)))
    return mesh.flat_cell(blk.long(), k.long(), j.long(), i.long())


def _side_points(mesh, axis, dtype, blocks=None) -> list:
    """The (lower, upper) sample points of every face along ``axis`` of ``blocks``
    (default every block): each three coordinate arrays of the face array's
    shape, a quarter local cell to either side of the face's centre, in
    ``dtype``."""
    nz, ny, nx = mesh.nz, mesh.ny, mesh.nx
    dev = mesh.device
    dxv = mesh.block_dx.to(dtype)
    org = mesh.block_origin.to(dtype)
    if blocks is not None:
        dxv, org = dxv[blocks], org[blocks]
    B = dxv.shape[0]
    shape = _face_shapes(B, nz, ny, nx)[axis]
    pos = []
    for a, n in enumerate((nx, ny, nz)):
        f = torch.arange(n + (a == axis), dtype=dtype, device=dev)
        if a != axis:
            f = f + 0.5
        view = [1, 1, 1, 1]
        view[3 - a] = -1
        pos.append((org[:, a].reshape(B, 1, 1, 1) + f.reshape(view)
                    * dxv[:, a].reshape(B, 1, 1, 1)).expand(shape))
    off = 0.25 * dxv[:, axis].reshape(B, 1, 1, 1)
    sides = []
    for sgn in (-1, 1):
        q = list(pos)
        q[axis] = pos[axis] - off if sgn < 0 else pos[axis] + off
        sides.append(q)
    return sides


def _face_probs_refined(mesh, sigma_t, tau_ddmc, periodic_flags, dtype, blocks=None):
    """``ddmc_face_probs`` on a refined forest: each face's two sides sampled a
    quarter local cell to either side of its centre (``jaybenne_tpu/ops/fleck.py``
    ``ddmc_face_probs``)."""
    nz, ny, nx = sigma_t.shape[1:]
    dev = sigma_t.device
    dxv = mesh.block_dx.to(dtype)
    tau_flat = (sigma_t[..., None] * dxv[:, None, None, None, :]).reshape(-1, 3).to(dtype)
    B = mesh.n_blocks if blocks is None else blocks.numel()
    thin = device_const(2.0 * LAM_EXT, dtype, dev)
    shapes = _face_shapes(B, nz, ny, nx)
    out = []
    for axis in range(3):
        if axis >= mesh.ndim:
            out.append(torch.zeros(shapes[axis], dtype=dtype, device=dev))
            continue
        sides = []
        for q in _side_points(mesh, axis, dtype, blocks):
            tau = tau_flat[_sample_cell(mesh, q, periodic_flags), axis]
            sides.append(torch.where(tau > tau_ddmc, tau, thin))
        out.append((2.0 / (3.0 * (sides[0] + sides[1]))).to(dtype))
    return tuple(out)


def face_sides(mesh, periodic_flags, dtype) -> tuple:
    """The side map of the face kernel: for each axis, None where it is inactive,
    else the flat cell ids (int32, on the mesh's device) of the lower and of the
    upper side of every face along it, the faces of every block in the order of
    its face array. Made by the plain version's own code with each cell's flat
    id in place of its tau (on a refined forest the sample points of ``dtype``),
    so that the sides are the plain version's by construction. It depends on the
    mesh, the field BCs and ``dtype`` alone: built once, at the first call, and
    kept in ``mesh.derived``; read, never written."""
    key = ("ddmc face sides", tuple(bool(f) for f in periodic_flags), dtype)
    hit = mesh.derived.get(key)
    if hit is None:
        ids = torch.arange(mesh.total_cells, device=mesh.device)
        sides = []
        for axis in range(3):
            if axis >= mesh.ndim:
                sides.append(None)
            elif mesh.max_level > 0:
                sides.append(tuple(_sample_cell(mesh, q, periodic_flags).reshape(-1)
                                   .to(torch.int32) for q in _side_points(mesh, axis, dtype)))
            else:
                sides.append(tuple(
                    _block_faces(s.movedim(-1, 2 - axis), mesh, axis).reshape(-1).to(torch.int32)
                    for s in _global_sides(ids, mesh, axis, periodic_flags[axis])))
        hit = mesh.derived[key] = tuple(sides)
    return hit


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


@functools.lru_cache(maxsize=None)
def _surface_index(nz, ny, nx) -> np.ndarray:
    """Each in-block cell's place among its block's boundary-surface cells
    (``_surface_cells``), -1 for an interior cell."""
    out = np.full(nz * ny * nx, -1, dtype=np.int32)
    surf = _surface_cells(nz, ny, nx)
    out[surf] = np.arange(surf.size, dtype=np.int32)
    return out


def ddmc_face_probs_spatial(mesh, sigma_local, surf_glob, offset, tau_ddmc, periodic_flags,
                            dtype):
    """The DDMC face probabilities of one shard's blocks [offset, offset + Bl):
    bitwise ``ddmc_face_probs`` of the whole mesh restricted to them, from the
    shard's own sigma_t ``sigma_local`` [Bl, nz, ny, nx] and every block's
    boundary surface ``surf_glob`` [n Bl, S] (``pack_boundary_surface``,
    all-gathered). The shard sees its own blocks whole and every other block's
    surface; the faces of its blocks read nothing else. Padding blocks past the
    mesh's last one get zeros. Returns local (px, py, pz) of shapes [Bl, nz, ny,
    nx+1] etc. The face kernel's plain version on the spatial decomposition
    (``ddmc_face_probs_shards`` launches the kernel)."""
    Bl, nz, ny, nx = sigma_local.shape
    B = mesh.n_blocks
    surf = device_const(_surface_cells(nz, ny, nx), torch.int64, sigma_local.device)
    visible = sigma_local.new_zeros((surf_glob.shape[0], nz * ny * nx))
    visible[:, surf] = surf_glob.to(visible.dtype)
    visible[offset:offset + Bl] = sigma_local.reshape(Bl, -1)
    visible = visible[:B].reshape(B, nz, ny, nx)
    n_real = max(0, min(Bl, B - offset))
    blocks = torch.arange(offset, offset + n_real, device=sigma_local.device)
    faces = ddmc_face_probs(mesh, visible, tau_ddmc, periodic_flags, dtype, blocks, plain=True)
    if n_real == Bl:
        return faces
    return tuple(torch.cat([f, f.new_zeros((Bl - n_real,) + f.shape[1:])]) for f in faces)


def ddmc_face_probs_shards(mesh, sigmas, surfs, offsets, tau_ddmc, periodic_flags, dtype,
                           plain=False) -> list:
    """``ddmc_face_probs_spatial`` of every local shard: the shards' sigma_t
    ``sigmas``, their all-gathered surfaces ``surfs`` and their first blocks
    ``offsets`` (``offsets[0] + g Bl`` for shard g). On a GPU every shard's faces
    in one launch of the face kernel; on the CPU (or with ``plain``) a shard at a
    time."""
    if _on_card(sigmas[0], plain):
        return _faces_cuda(mesh, sigmas, surfs, offsets, tau_ddmc, periodic_flags, dtype)
    return [ddmc_face_probs_spatial(mesh, t, g, off, tau_ddmc, periodic_flags, dtype)
            for t, g, off in zip(sigmas, surfs, offsets)]


def _on_card(t, plain) -> bool:
    """Whether ``t`` takes the face kernel: on a GPU unless ``plain``; raises on any
    other device that is not the CPU."""
    if t.is_cuda and not plain:
        return True
    if t.device.type != "cpu" and not plain:
        raise ValueError(f"ddmc face probabilities: unsupported device {t.device}")
    return False


# local shards a launch of the face kernel writes (csrc/faces_kernel.cu, kMaxParts)
FACE_PARTS = 16


def _faces_cuda(mesh, sigmas, surfs, offsets, tau_ddmc, periodic_flags, dtype) -> list:
    """One launch of the face kernel (``csrc/faces_kernel.cu``) on PyTorch's current
    stream, without waiting for it: the (px, py, pz) of each shard's blocks
    [offsets[g], offsets[g] + Bl), from its sigma_t ``sigmas[g]`` [Bl, nz, ny, nx]
    and, with ``surfs``, every block's all-gathered surface ``surfs[g]`` (without,
    one shard of every block). Raises unless sigma_t, the mesh and ``dtype`` are
    one floating type on one GPU and the shards' blocks follow each other."""
    from . import cuda_lib

    dev = sigmas[0].device
    Bl, nz, ny, nx = sigmas[0].shape
    m = len(sigmas)
    if (dtype not in (torch.float32, torch.float64) or mesh.block_dx.dtype != dtype
            or mesh.device != dev or not mesh.block_dx.is_contiguous()
            or any(t.dtype != dtype or t.device != dev or t.shape != sigmas[0].shape
                   for t in sigmas)):
        raise ValueError("face kernel: sigma_t and the mesh on one GPU, of the run's precision")
    if any(off != offsets[0] + g * Bl for g, off in enumerate(offsets)):
        raise ValueError(f"face kernel: shards at blocks {list(offsets)}, {Bl} a shard")
    if surfs is None and (m != 1 or offsets[0] != 0 or Bl != mesh.n_blocks):
        raise ValueError("face kernel: without surfaces, one shard of every block")
    keep, sig_ptrs = [], []
    # 0 where every shard's sigma_t is one value broadcast (a constant opacity)
    sstep = 0 if all(st == 0 for t in sigmas for st in t.stride()) else 1
    for t in sigmas:
        if sstep == 1 and not t.is_contiguous():
            t = t.contiguous()
        keep.append(t)
        sig_ptrs.append(t.data_ptr())
    surf_ptrs, surf_index, S = None, None, 0
    if surfs is not None:
        idx = _surface_index(nz, ny, nx)
        S = int((idx >= 0).sum())
        surf_index = device_const(idx, torch.int32, dev)
        for g in surfs:
            if g.dtype != dtype or g.device != dev or g.dim() != 2 or g.shape[1] != S:
                raise ValueError("face kernel: surfaces [blocks, S] of the run's precision")
        keep += [g.contiguous() for g in surfs]
        surf_ptrs = [g.data_ptr() for g in keep[m:]]
    sides = face_sides(mesh, periodic_flags, dtype)
    shapes = _face_shapes(Bl, nz, ny, nx)
    outs, out_ptrs = [], []
    for _ in range(m):
        faces = tuple(torch.empty(shapes[a], dtype=dtype, device=dev) if sides[a] is not None
                      else torch.zeros(shapes[a], dtype=dtype, device=dev) for a in range(3))
        outs.append(faces)
        out_ptrs += [f.data_ptr() if sides[a] is not None else None for a, f in enumerate(faces)]
    fpb = [0 if sides[a] is None else int(np.prod(shapes[a][1:])) for a in range(3)]
    rd = np.float32 if dtype == torch.float32 else np.float64
    P = ctypes.c_void_p
    cuda_lib.library().call(
        "jb_faces_launch", int(dtype == torch.float64),
        (P * 3)(*(None if s is None else s[0].data_ptr() for s in sides)),
        (P * 3)(*(None if s is None else s[1].data_ptr() for s in sides)),
        (ctypes.c_longlong * 3)(*fpb), mesh.block_dx.data_ptr(),
        None if surf_index is None else surf_index.data_ptr(), S, nz * ny * nx, mesh.n_blocks,
        Bl, offsets[0], float(rd(tau_ddmc)), float(rd(2.0 * LAM_EXT)), m, (P * m)(*sig_ptrs),
        sstep, None if surf_ptrs is None else (P * m)(*surf_ptrs), (P * (3 * m))(*out_ptrs),
        cuda_lib.stream_handle(dev))
    cuda_lib.LAUNCHES["ddmc_face_probs"] += -(-m // FACE_PARTS)
    return outs
