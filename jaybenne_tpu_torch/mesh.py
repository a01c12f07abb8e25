"""Block-structured Cartesian mesh (port of ``jaybenne_tpu/mesh.py``).

Dense per-variable field arrays of shape ``[n_blocks, nz, ny, nx]``, flat per-block
metadata (origin, cell size, level) and a finest-granularity block lookup grid, as
in the JAX package. The forest is built by the pure-Python path, which
``tests/test_native.py`` pins bitwise-equal to the native C++ builder; the ctypes
loader of that builder is ROADMAP Queue 1, item 4.

Axis convention: physical axes are (x1, x2, x3) = (x, y, z); cell arrays are indexed
``[block, k, j, i]`` with i fastest.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import MeshConfig, RefinementRegion


@dataclasses.dataclass
class MeshGeometry:
    ndim: int
    nx: int            # cells per block, x1
    ny: int            # cells per block, x2
    nz: int            # cells per block, x3
    n_blocks: int
    max_level: int
    bounds: tuple      # (x1min, x1max, x2min, x2max, x3min, x3max)
    tile_shape: tuple  # lookup grid dims (ntz, nty, ntx)
    root_grid: tuple   # root blocks per dim (nrb3, nrb2, nrb1)
    finest: tuple      # finest cell size per axis (dx, dy, dz)
    block_origin: torch.Tensor  # f[B, 3] lower corner (x, y, z)
    block_dx: torch.Tensor      # f[B, 3] cell size (dx, dy, dz)
    block_level: torch.Tensor   # i32[B]
    lookup: torch.Tensor        # i32[ntz, nty, ntx] -> block id

    @property
    def device(self) -> torch.device:
        return self.block_dx.device

    @property
    def ncells_per_block(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def total_cells(self) -> int:
        return self.n_blocks * self.ncells_per_block

    @property
    def block_volume(self) -> torch.Tensor:
        """Cell volume per block, f[B] (inactive dims carry the full extent)."""
        dx = self.block_dx
        return dx[:, 0] * dx[:, 1] * dx[:, 2]

    def flat_cell(self, b, k, j, i):
        """Global flat cell index for segment reductions."""
        return ((b * self.nz + k) * self.ny + j) * self.nx + i

    def cell_centers(self):
        """Physical cell-center coordinate arrays (xc, yc, zc), each f[B, nz, ny, nx]."""
        dev, dt = self.device, self.block_dx.dtype
        shape = (self.n_blocks, self.nz, self.ny, self.nx)
        o = self.block_origin[:, :, None, None, None]
        d = self.block_dx[:, :, None, None, None]
        ii = torch.arange(self.nx, device=dev, dtype=dt)[None, None, :]
        jj = torch.arange(self.ny, device=dev, dtype=dt)[None, :, None]
        kk = torch.arange(self.nz, device=dev, dtype=dt)[:, None, None]
        xc = o[:, 0] + (ii + 0.5) * d[:, 0]
        yc = o[:, 1] + (jj + 0.5) * d[:, 1]
        zc = o[:, 2] + (kk + 0.5) * d[:, 2]
        return xc.expand(shape), yc.expand(shape), zc.expand(shape)


def _intersects(bmin, bmax, rmin, rmax, ndim) -> bool:
    for d in range(ndim):
        if bmax[d] <= rmin[d] or bmin[d] >= rmax[d]:
            return False
    return True


def build_mesh(cfg: MeshConfig, dtype=torch.float32, device="cpu") -> MeshGeometry:
    """Construct the block forest from a mesh config: root blocks overlapping a
    ``<parthenon/static_refinement*>`` box are split until they reach its level,
    then 2:1 balance is enforced. Blocks are ordered by (level, z, y, x)."""
    nz_b, ny_b, nx_b = cfg.block_shape
    for n_tot, n_blk, name in (
        (cfg.nx1, nx_b, "nx1"),
        (cfg.nx2, ny_b, "nx2"),
        (cfg.nx3, nz_b, "nx3"),
    ):
        if n_tot % n_blk != 0:
            raise ValueError(f"mesh {name}={n_tot} not divisible by meshblock {n_blk}")

    ndim = cfg.ndim
    nrb = (cfg.nx1 // nx_b, cfg.nx2 // ny_b, cfg.nx3 // nz_b)  # root blocks (x, y, z)
    gmin = (cfg.x1min, cfg.x2min, cfg.x3min)
    gmax = (cfg.x1max, cfg.x2max, cfg.x3max)
    root_size = tuple((gmax[d] - gmin[d]) / nrb[d] for d in range(3))
    regions: tuple[RefinementRegion, ...] = (
        cfg.refinement_regions if cfg.refinement == "static" else ()
    )

    # block = (level, (lx, ly, lz)) with logical location in level-granularity units
    blocks = [
        (0, (ix, iy, iz))
        for iz in range(nrb[2])
        for iy in range(nrb[1])
        for ix in range(nrb[0])
    ]

    def block_bounds(level, loc):
        size = [root_size[d] / (2**level if d < ndim else 1) for d in range(3)]
        bmin = [gmin[d] + loc[d] * size[d] for d in range(3)]
        bmax = [bmin[d] + size[d] for d in range(3)]
        return bmin, bmax

    def split(level, loc):
        steps = [range(2) if d < ndim else range(1) for d in range(3)]
        return [
            (level + 1, (2 * loc[0] + cx, 2 * loc[1] + cy, 2 * loc[2] + cz))
            for cz in steps[2]
            for cy in steps[1]
            for cx in steps[0]
        ]

    # refine to requested levels
    changed = True
    while changed:
        changed = False
        out = []
        for level, loc in blocks:
            bmin, bmax = block_bounds(level, loc)
            needs = any(
                level < r.level
                and _intersects(
                    bmin, bmax,
                    (r.x1min, r.x2min, r.x3min), (r.x1max, r.x2max, r.x3max),
                    ndim,
                )
                for r in regions
            )
            if needs:
                out.extend(split(level, loc))
                changed = True
            else:
                out.append((level, loc))
        blocks = out

    # enforce 2:1 balance (face/edge/corner neighbors differ by at most one level)
    def touches(a, b):
        (la, loca), (lb, locb) = a, b
        amin, amax = block_bounds(la, loca)
        bmin, bmax = block_bounds(lb, locb)
        eps = [1e-9 * root_size[d] for d in range(3)]
        for d in range(ndim):
            if amax[d] < bmin[d] - eps[d] or amin[d] > bmax[d] + eps[d]:
                return False
        return True

    changed = True
    while changed:
        changed = False
        out = []
        for a in blocks:
            if any(b[0] > a[0] + 1 and touches(a, b) for b in blocks if b is not a):
                out.extend(split(*a))
                changed = True
            else:
                out.append(a)
        blocks = out

    blocks.sort(key=lambda t: (t[0], t[1][2], t[1][1], t[1][0]))
    n_blocks = len(blocks)
    max_level = max(lvl for lvl, _ in blocks)
    origin = np.zeros((n_blocks, 3))
    bdx = np.zeros((n_blocks, 3))
    levels = np.zeros((n_blocks,), dtype=np.int32)
    for bid, (level, loc) in enumerate(blocks):
        bmin, bmax = block_bounds(level, loc)
        origin[bid] = bmin
        ncell = (nx_b, ny_b, nz_b)
        bdx[bid] = [(bmax[d] - bmin[d]) / ncell[d] for d in range(3)]
        levels[bid] = level

    # finest-granularity lookup grid
    nt = [nrb[d] * (2**max_level if d < ndim else 1) for d in range(3)]
    lookup = np.full((nt[2], nt[1], nt[0]), -1, dtype=np.int32)
    for bid, (level, loc) in enumerate(blocks):
        mult = [2 ** (max_level - level) if d < ndim else 1 for d in range(3)]
        sx, sy, sz = (loc[d] * mult[d] for d in range(3))
        lookup[sz : sz + mult[2], sy : sy + mult[1], sx : sx + mult[0]] = bid
    if (lookup < 0).any():
        raise RuntimeError("mesh construction left uncovered lookup tiles")

    return MeshGeometry(
        ndim=ndim,
        nx=nx_b,
        ny=ny_b,
        nz=nz_b,
        n_blocks=n_blocks,
        max_level=max_level,
        bounds=(cfg.x1min, cfg.x1max, cfg.x2min, cfg.x2max, cfg.x3min, cfg.x3max),
        tile_shape=(nt[2], nt[1], nt[0]),
        root_grid=(nrb[2], nrb[1], nrb[0]),
        finest=tuple(float(v) for v in bdx.min(axis=0)),
        block_origin=torch.as_tensor(origin, dtype=dtype, device=device),
        block_dx=torch.as_tensor(bdx, dtype=dtype, device=device),
        block_level=torch.as_tensor(levels, device=device),
        lookup=torch.as_tensor(lookup, device=device),
    )
