"""The census table kernel's plan (``transport_kernel.table_plan``), held on the CPU.

The CUDA table kernel (``csrc/table_kernel.cu``) runs only on a card, so its index
arithmetic is mirrored here in plain PyTorch, thread by thread over the plan's
grid, with the plan's multiply-high divisors: for every record kind and layout of
``tests/test_torch_table.py`` the mirror visits every row once, finds for it the
cell that ``to_global_cells`` puts there and the six faces that ``_face_pairs``
gives that cell, and builds from them, by the kernel's float operations, rows
bitwise those of the plain version ``_pair_table``. The divisors equal ``//`` and
``%`` over every index the kernel forms. ``tests/test_torch_cuda.py`` holds the
kernel itself to the same rows on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from jaybenne_tpu_torch.ops import transport_kernel as tk
from test_torch_table import KINDS, LAYOUTS, table_case

T = tk.TABLE_THREADS


def fast_div(n, div):
    """``n // div[0]`` as the table kernel makes it (``quo``) from
    ``fast_divisor``'s constants, for an int64 tensor ``n`` of values in [0,
    2**31)."""
    _, mul, shift = div
    return (n if mul == 0 else (n * mul) >> 32) >> shift


def _setup(kind, layout):
    coefs, mesh, prm, dt, own, _ = table_case(kind, layout)
    cset = [coefs] if own is None else coefs
    g = tk._prepare(coefs, mesh, prm, dt, own, False).g
    plan = tk.table_plan(mesh, g, [c.sigma_s.numel() for c in cset])
    return cset, mesh, g, plan


def _threads(plan, cells):
    """Per live thread of one range's blocks (grid.x): its run's first cell's
    (row in the range, b, k, j, i), by the kernel's arithmetic; and every numerator
    of each divisor that it forms."""
    t = torch.arange(plan.blocks * T, dtype=torch.int64)
    t = t[t * plan.run < cells]
    runs, lines, dx, dy, dz = plan.divisors
    line = fast_div(t, runs)
    x = (t - line * runs[0]) * plan.run
    z = fast_div(line, lines)
    y = line - z * lines[0]
    bx, by, bz = fast_div(x, dx), fast_div(y, dy), fast_div(z, dz)
    i, j, k = x - bx * dx[0], y - by * dy[0], z - bz * dz[0]
    b = (bz * plan.nrby + by) * plan.nrbx + bx
    numerators = [(runs, t), (lines, line), (dx, x), (dy, y), (dz, z)]
    return t * plan.run, (b, k, j, i), numerators


def mirror(cset, mesh, g, plan):
    """The table, each row's cell (in its range's block cell order) and each row's
    six face indices (into its range's px, py, pz) as the kernel makes them, and
    how often each row was written."""
    nx, ny, nz = mesh.nx, mesh.ny, mesh.nz
    width = tk._TABLE_WIDTHS[tk._table_kind(g)]
    total = sum(c.sigma_s.numel() for c in cset)
    table = torch.zeros((total, width), dtype=g.real)
    cell_of = torch.full((total,), -1, dtype=torch.int64)
    faces_of = torch.full((total, 6), -1, dtype=torch.int64)
    visits = torch.zeros(total, dtype=torch.int64)
    tiny = tk.limits(g.real)[1]
    first = 0
    for c in cset:
        cells = c.sigma_s.numel()
        r0, (b, k, j, i), _ = _threads(plan, cells)
        base = ((b * nz + k) * ny + j) * nx + i
        ix0 = ((b * nz + k) * ny + j) * (nx + 1) + i
        iy0 = ((b * nz + k) * (ny + 1) + j) * nx + i
        iz0 = ((b * (nz + 1) + k) * ny + j) * nx + i
        for v in range(plan.run):
            row, cell = first + r0 + v, base + v
            ix, iy, iz = ix0 + v, iy0 + v, iz0 + v
            face = [ix, ix + 1, iy, iy + nx, iz, iz + ny * nx]
            visits.index_add_(0, row, torch.ones_like(row))
            cell_of[row] = cell
            faces_of[row] = torch.stack(face, dim=1)
            table[row] = _records(c, g, cell, face, tiny)
        first += cells
    return table, cell_of, faces_of, visits


def _records(c, g, cell, face, tiny):
    """The kernel's rows of ``cell`` with the face values at ``face``, by its float
    operations."""
    col = lambda name: getattr(c, name).reshape(-1)[cell].to(g.real)  # noqa: E731
    f = ([getattr(c, n).reshape(-1)[i].to(g.real) for n, i in zip(("px", "px", "py", "py",
                                                                     "pz", "pz"), face)]
         if g.ddmc else [])
    ss = col("sigma_s")
    zero = torch.zeros_like(ss)
    if g.nongray:
        return torch.stack([col("rho"), col("temp"), col("fleck"), ss]
                           + (f + [zero, zero] if g.ddmc else []), dim=1)
    ea, es = zero, ss
    if g.absorb:
        sa, fl = col("sigma_a"), col("fleck")
        ea = fl * sa
        es = ss + (1.0 - fl) * sa
    if not g.ddmc:
        inv = 1.0 / (ea + es + tiny)
        return torch.stack([ea * inv, inv], dim=1)
    if tk._table_kind(g) == 4:
        inv_dx = float(g.inv_dx[0])
        lk = f[0] * inv_dx
        leak_tot = lk + f[1] * inv_dx
        cdf = (ea + leak_tot if g.absorb else leak_tot) + tiny
        return torch.stack([ea, es, f[0], f[1], lk, cdf, cdf * float(g.c), zero], dim=1)
    return torch.stack([ea, es, *f], dim=1)


def _bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_mirror_of_the_plan_gives_the_plain_table(kind, layout):
    """The kernel's index arithmetic under the host plan, mirrored in PyTorch:
    every row written once, each at the cell of ``to_global_cells`` (block cell
    order where the rows are not permuted) with the faces of ``_face_pairs``, and
    the rows bitwise ``_pair_table``'s."""
    cset, mesh, g, plan = _setup(kind, layout)
    table, cell_of, faces_of, visits = mirror(cset, mesh, g, plan)
    assert bool((visits == 1).all())
    permute = mesh.n_blocks > 1 and not g.smr
    first = 0
    for c in cset:
        cells = c.sigma_s.numel()
        ids = torch.arange(cells)
        want = tk.to_global_cells(ids, mesh) if permute else ids
        assert torch.equal(cell_of[first:first + cells], want)
        if g.ddmc:
            coded = [torch.arange(getattr(c, n).numel()).reshape(getattr(c, n).shape)
                     for n in ("px", "py", "pz")]
            pairs = tk._face_pairs(*coded, mesh)
            got = faces_of[first:first + cells]
            for e in range(6):
                assert torch.equal(got[:, e], pairs[e][want])
        first += cells
    plain = tk._pair_table(cset[0] if len(cset) == 1 else tk._concat_coefs(cset), mesh, g)
    assert table.shape == plain.shape and torch.equal(_bits(table), _bits(plain))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plan_divisors_are_floor_division(layout):
    """Each of the plan's multiply-high divisors equals ``//`` and ``%`` over every
    numerator the kernel forms from it on the layout (the threads of every range),
    and over the cell counts of its ranges and the largest numerator it takes."""
    cset, mesh, g, plan = _setup("ddmc_abs", layout)
    for c in cset:
        cells = c.sigma_s.numel()
        _, _, numerators = _threads(plan, cells)
        for div, n in numerators:
            n = torch.cat([n, torch.tensor([cells, cells // plan.run, 2**31 - 1])])
            q = fast_div(n, div)
            assert torch.equal(q, n // div[0]) and torch.equal(n - q * div[0], n % div[0])


def test_fast_divisor_over_divisors_and_numerators():
    """``fast_divisor``'s constants give ``n // d`` for every d up to 4096 and the
    powers of two and their neighbours up to 2^30, on numerators at both ends of
    [0, 2^31), around the first and the last multiples of d in it, and at random."""
    rng = np.random.default_rng(5)
    ds = list(range(1, 4097)) + [v for e in range(12, 31) for v in (2**e - 1, 2**e, 2**e + 1)]
    near = np.arange(-2, 3)
    for d in ds:
        div = tk.fast_divisor(d)
        assert div[0] == d and 0 <= div[1] < 2**32 and 0 <= div[2] < 32
        multiples = np.concatenate([np.arange(0, 4), (2**31 - 1) // d - np.arange(4)]) * d
        n = np.concatenate([np.arange(0, 64), 2**31 - 1 - np.arange(64),
                            (multiples[:, None] + near).reshape(-1),
                            rng.integers(0, 2**31, 64)])
        n = torch.as_tensor(n[(n >= 0) & (n < 2**31)], dtype=torch.int64)
        assert torch.equal(fast_div(n, div), n // d), d
    with pytest.raises(ValueError):
        tk.fast_divisor(0)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("layout, aligned", [("one_block_1d", True), ("uniform_1d", True),
                                             ("uniform_3d", True), ("forest_2d", True),
                                             ("z_ranges_2", True), ("z_ranges_20", True),
                                             ("block_ranges_2", True), ("uniform_64", True),
                                             ("uniform_64", False)])
def test_plan_takes_runs_where_columns_are_words(kind, layout, aligned):
    """A thread takes a run of TABLE_RUN cells where nx is a multiple of it, every
    column is 16-byte aligned and a row of the record is at most TABLE_RUN_BYTES
    (the gray pair and the non-gray record in float32; the gray pair in float64),
    else one; with blocks enough for every cell."""
    cset, mesh, g, _ = _setup(kind, layout)
    cells = [c.sigma_s.numel() for c in cset]
    plan = tk.table_plan(mesh, g, cells, aligned=aligned)
    narrow = kind in ("pair", "pair_abs", "nongray")
    want = tk.TABLE_RUN if aligned and mesh.nx % tk.TABLE_RUN == 0 and narrow else 1
    assert plan.run == want
    g64 = dataclasses.replace(g, real=torch.float64)
    assert tk.table_plan(mesh, g64, cells, aligned=aligned).run == (
        want if kind in ("pair", "pair_abs") else 1)
    assert plan.blocks * T * plan.run >= max(cells) > (plan.blocks - 1) * T * plan.run
    permute = mesh.n_blocks > 1 and not g.smr
    assert (plan.nrbx, plan.nrby) == ((mesh.root_grid[2], mesh.root_grid[1]) if permute
                                      else (1, 1))


def test_plan_refuses_ranges_of_partial_planes():
    """A range must be whole planes of the rows' layout: the kernel's lines and
    planes divide its cells."""
    cset, mesh, g, _ = _setup("pair", "uniform_3d")
    with pytest.raises(ValueError, match="whole planes"):
        tk.table_plan(mesh, g, [cset[0].sigma_s.numel() - mesh.nx])
