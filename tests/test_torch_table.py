"""The census table: the per-cell table of ``transport_kernel.prepare``, which the
CUDA table kernel (``csrc/table_kernel.cu``) builds on a GPU and its plain version
``_pair_table`` on the CPU.

Here, on the CPU, the table that ``prepare`` builds is held, bitwise, against rows
computed cell by cell with numpy float32 arithmetic from the coefficients, each at
the row the census reads for its cell (``_census_plain``'s ``cell_of``): for each
record kind (the gray pair, gray DDMC, non-gray, non-gray DDMC, with and without
absorption; on a uniform 1D mesh the DDMC record that carries the cell's leak
rate, cdf and c cdf) on one block, a uniform mesh of several blocks (1D, 3D and
bench.py's 64^3 in 8^3 blocks), a level-1 forest, two and twenty owned ranges of z
planes and two block ranges of a forest. ``tests/test_torch_cuda.py`` holds the
kernel to the same rows on the card.
Where the kernel reads the non-gray record straight from the coefficient columns,
those columns are held to the same rows. The forest tables, kept per mesh, are held
to the tables each census set-up built before, and the plain census on forests to
the census built on those.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from jaybenne_tpu_torch import config as cm
from jaybenne_tpu_torch.mesh import build_mesh
from jaybenne_tpu_torch.ops import transport_kernel as tk
from jaybenne_tpu_torch.ops.transport import TransportCoefs
from jaybenne_tpu_torch.step import make_transport_params
from jaybenne_tpu_torch.utils.deck import Deck

INPUTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "inputs")
F32 = np.float32
TINY = F32(1.0e-37)

# record kind: (DDMC, absorbing, non-gray)
KINDS = {"pair": (False, False, False), "pair_abs": (False, True, False),
         "ddmc": (True, False, False), "ddmc_abs": (True, True, False),
         "nongray": (False, True, True), "nongray_ddmc": (True, True, True)}
_UNIFORM_3D = {"parthenon/mesh/nx1": 8, "parthenon/mesh/nx2": 4, "parthenon/mesh/nx3": 8,
               "parthenon/meshblock/nx1": 4, "parthenon/meshblock/nx2": 2,
               "parthenon/meshblock/nx3": 2}
_FOREST = {"parthenon/mesh/nx1": 32, "parthenon/mesh/nx2": 16, "parthenon/meshblock/nx1": 8,
           "parthenon/meshblock/nx2": 8}
# layout: (deck, mesh overrides, owned ranges: None for the whole mesh, else their
# kind and (lo, n) each)
LAYOUTS = {
    "one_block_1d": ("stepdiff.in", {"parthenon/mesh/nx1": 16, "parthenon/meshblock/nx1": 16},
                     None),
    "uniform_1d": ("stepdiff.in", {"parthenon/mesh/nx1": 16, "parthenon/meshblock/nx1": 4},
                   None),
    "uniform_3d": ("stepdiff.in", _UNIFORM_3D, None),
    "forest_2d": ("stepdiff_smr_ddmc.in", _FOREST, None),
    "z_ranges_2": ("stepdiff.in", _UNIFORM_3D, ("z", [(0, 4), (4, 4)])),
    "z_ranges_20": ("stepdiff.in", {**_UNIFORM_3D, "parthenon/mesh/nx3": 40},
                    ("z", [(2 * s, 2) for s in range(20)])),
    "block_ranges_2": ("stepdiff_smr_ddmc.in", _FOREST, ("blocks", [(0, 10), (10, 10)])),
    # bench.py's big mesh: 64^3 cells in 8^3 blocks
    "uniform_64": ("stepdiff.in", {"parthenon/mesh/nx1": 64, "parthenon/mesh/nx2": 64,
                                   "parthenon/mesh/nx3": 64, "parthenon/meshblock/nx1": 8,
                                   "parthenon/meshblock/nx2": 8, "parthenon/meshblock/nx3": 8},
                   None),
}


def table_case(kind, layout, dev="cpu", seed=3):
    """One census set-up's inputs and the rows it must give: (coefficients, a set
    or one set per range; mesh; prm; dt; owned range or ranges, or None; the
    expected table as int32 bits). The coefficients are random float32 (numpy,
    ``seed``), and the rows are computed cell by cell from them."""
    ddmc, absorb, nongray = KINDS[kind]
    deck, mods, ranges = LAYOUTS[layout]
    model = "ep_bremss" if nongray else ("constant" if absorb else "none")
    cfg = cm.from_deck(Deck.from_file(os.path.join(INPUTS, deck)).update(
        {**mods, "jaybenne/use_ddmc": str(ddmc).lower(), "mcblock/opacity_model": model}))
    mesh = build_mesh(cfg.mesh, device=dev)
    prm = make_transport_params(cfg, torch.float32)
    assert prm.use_ddmc == ddmc and prm.has_absorption == absorb
    rng = np.random.default_rng(seed)
    nb, nz, ny, nx = mesh.n_blocks, mesh.nz, mesh.ny, mesh.nx
    cpb = mesh.ncells_per_block
    nc = nb * cpb
    col = {name: rng.uniform(lo, hi, nc).astype(F32) for name, lo, hi in (
        ("sigma_a", 0.5, 4.0), ("sigma_s", 1.0, 900.0), ("fleck", 0.05, 1.0),
        ("rho", 0.5, 2.0), ("temp", 5e5, 5e6))}
    faces = {"px": rng.uniform(0.0, 1.0, (nb, nz, ny, nx + 1)).astype(F32),
             "py": rng.uniform(0.0, 1.0, (nb, nz, ny + 1, nx)).astype(F32),
             "pz": rng.uniform(0.0, 1.0, (nb, nz + 1, ny, nx)).astype(F32)}
    opacity = cfg.mcblock.build_opacity() if nongray else None

    def coefs_of(b0, b1):
        t = {k: torch.as_tensor(v[b0 * cpb:b1 * cpb], device=dev) for k, v in col.items()}
        extra = ({k: torch.as_tensor(v[b0:b1], device=dev) for k, v in faces.items()}
                 if ddmc else {})
        if not nongray:
            t.pop("rho")
            t.pop("temp")
        return TransportCoefs(**t, **extra, opacity=opacity)

    if ranges is None:
        own, block_ranges = None, [(0, nb)]
        coefs = coefs_of(0, nb)
    else:
        rkind, spans = ranges
        own = [tk.OwnedRange(rkind, lo, n) for lo, n in spans]
        per_plane = mesh.root_grid[1] * mesh.root_grid[2]
        block_ranges = [(lo // nz * per_plane, (lo + n) // nz * per_plane) if rkind == "z"
                        else (lo, lo + n) for lo, n in spans]
        coefs = [coefs_of(b0, b1) for b0, b1 in block_ranges]
    smr = mesh.max_level > 0 or (ranges is not None and ranges[0] == "blocks")
    g = tk._geometry(mesh, prm, cfg.jaybenne.dt, coefs_of(0, 1), smr)

    # every cell's record, in block cell order
    sa, ss, fl = col["sigma_a"], col["sigma_s"], col["fleck"]
    if absorb and not nongray:
        ea = fl * sa
        es = ss + (F32(1.0) - fl) * sa
    else:
        ea, es = np.zeros_like(ss), ss
    pf = [faces["px"][..., :nx], faces["px"][..., 1:], faces["py"][:, :, :ny],
          faces["py"][:, :, 1:], faces["pz"][:, :nz], faces["pz"][:, 1:]]
    pf = [v.reshape(-1) for v in pf]
    zero = np.zeros_like(ss)
    if nongray:
        rec = [col["rho"], col["temp"], fl, ss] + (pf + [zero, zero] if ddmc else [])
    elif ddmc and mesh.ndim == 1 and not smr:
        inv_dx, c = F32(g.inv_dx[0]), F32(g.c)
        lk = pf[0] * inv_dx
        leak_tot = lk + pf[1] * inv_dx
        cdf = (ea + leak_tot if absorb else leak_tot) + TINY
        rec = [ea, es, pf[0], pf[1], lk, cdf, cdf * c, zero]
    elif ddmc:
        rec = [ea, es] + pf
    else:
        inv = F32(1.0) / (ea + es + TINY)
        rec = [ea * inv, inv]
    rec = np.stack(rec, axis=1)

    # the row the census reads for each cell
    nrbz, nrby, nrbx = mesh.root_grid
    table = np.zeros((sum((b1 - b0) * cpb for b0, b1 in block_ranges), rec.shape[1]), F32)
    seen = np.zeros(table.shape[0], np.int64)
    first = 0
    for b0, b1 in block_ranges:
        b, kk, j, i = (a.reshape(-1) for a in np.meshgrid(np.arange(b0, b1), np.arange(nz),
                                                          np.arange(ny), np.arange(nx),
                                                          indexing="ij"))
        cell = ((b * nz + kk) * ny + j) * nx + i
        if smr or nb == 1:
            row = first + cell - b0 * cpb
        else:
            gx, gy = (b % nrbx) * nx + i, (b // nrbx % nrby) * ny + j
            gz = (b // (nrbx * nrby)) * nz + kk
            lo = b0 // (nrbx * nrby) * nz
            row = first + ((gz - lo) * (nrby * ny) + gy) * (nrbx * nx) + gx
        table[row] = rec[cell]
        np.add.at(seen, row, 1)
        first += (b1 - b0) * cpb
    assert (seen == 1).all()
    return coefs, mesh, prm, cfg.jaybenne.dt, own, torch.as_tensor(table.view(np.int32))


def census_rows(coefs, mesh, prm, dt, own):
    """The cell table that ``prepare`` builds, as int32 bits on the CPU."""
    return tk.prepare(coefs, mesh, prm, dt, own).tabs.cell.cpu().view(torch.int32)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_plain_table_gives_the_rows_the_census_reads(kind, layout):
    """``prepare``'s plain table against the rows computed cell by cell, bitwise."""
    coefs, mesh, prm, dt, own, want = table_case(kind, layout)
    got = census_rows(coefs, mesh, prm, dt, own)
    assert got.shape == want.shape and torch.equal(got, want)


def test_table_kernel_refuses_a_cpu_coefficient_set():
    """The table kernel's wrapper launches on a GPU or raises: ``prepare`` builds a
    CPU set-up's table with the plain version, and never with the wrapper."""
    coefs, mesh, prm, dt, own, _ = table_case("ddmc_abs", "uniform_3d")
    g = tk._geometry(mesh, prm, dt, coefs, False)
    with pytest.raises(ValueError, match="on one GPU"):
        tk._table_cuda([coefs], mesh, g)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_record_columns_are_the_plain_record(kind, layout):
    """Where the non-gray record would be a verbatim copy of the coefficients (no
    DDMC, one owned range, one block or a forest), the kernel reads it straight
    from the columns ``record_columns`` names: those columns, side by side, are
    bitwise the rows of the plain table; on every other kind and layout it reads
    the table (None)."""
    coefs, mesh, prm, dt, own, want = table_case(kind, layout)
    g = tk._prepare(coefs, mesh, prm, dt, own, False).g
    cols = tk.record_columns([coefs] if own is None else coefs, mesh, g)
    if kind == "nongray" and layout in ("one_block_1d", "forest_2d"):
        rows = torch.stack(cols, dim=1).view(torch.int32)
        assert torch.equal(rows, want)
        assert torch.equal(rows, census_rows(coefs, mesh, prm, dt, own))
    else:
        assert cols is None


# ------------------------------ the forest tables, built once per mesh

_ROOT = os.path.dirname(INPUTS)
sys.path.insert(0, _ROOT)
import chip_smoke as cs  # noqa: E402

# the level-1 forests of chip_smoke.py's phase 15 (1D, 2D, 3D) and stepdiff_smr as
# shipped (phase 25's forest)
FOREST_DECKS = {f"{ndim}d_level1": (path, mods) for ndim, (path, mods) in cs.SMR_FORESTS.items()}
FOREST_DECKS["stepdiff_smr"] = (os.path.join(INPUTS, "stepdiff_smr.in"), {})


def _forest(name, dev="cpu"):
    path, mods = FOREST_DECKS[name]
    cfg = cm.from_deck(Deck.from_file(path).update(
        {**mods, "mcblock/opacity_model": "constant", "jaybenne/use_ddmc": "false"}))
    mesh = build_mesh(cfg.mesh, device=dev)
    assert mesh.max_level > 0
    return cfg, mesh


def _set_up_tables(mesh):
    """The forest tables as a census set-up built them each time before they were
    kept per mesh, in numpy: (dx, 0, origin, 0, f32(1) / dx by an IEEE float32
    divide, 0) per block, the int32 levels, the flat int32 lookup grid."""
    dx = mesh.block_dx.numpy().astype(F32)
    block = np.zeros((mesh.n_blocks, 12), F32)
    block[:, 0:3] = dx
    block[:, 4:7] = mesh.block_origin.numpy()
    block[:, 8:11] = F32(1.0) / dx
    return (block, mesh.block_level.numpy().astype(np.int32),
            mesh.lookup.numpy().astype(np.int32).reshape(-1))


@pytest.mark.parametrize("name", sorted(FOREST_DECKS))
def test_forest_tables_are_the_set_up_tables(name):
    """``forest_tables`` gives, bitwise, the block table, levels and lookup grid
    that each census set-up built before they were kept per mesh."""
    _, mesh = _forest(name)
    got = tk.forest_tables(mesh, torch.device("cpu"))
    for t, want in zip(got, _set_up_tables(mesh)):
        assert t.is_contiguous() and t.dtype == torch.from_numpy(want).dtype
        assert np.array_equal(t.numpy().view(np.int32), want.view(np.int32))


def _gray_coefs(mesh, rng):
    nc = mesh.total_cells
    return TransportCoefs(
        sigma_a=torch.as_tensor(rng.uniform(0.5, 2.0, nc).astype(F32)),
        sigma_s=torch.as_tensor(rng.uniform(1.0, 4.0, nc).astype(F32)),
        fleck=torch.as_tensor(rng.uniform(0.2, 1.0, nc).astype(F32)))


@pytest.mark.parametrize("name", sorted(FOREST_DECKS))
def test_census_set_ups_share_the_forest_tables(name):
    """Two census set-ups on one mesh, with other coefficients and steps, hold the
    same forest tables (the same tensors: built once, kept by the mesh); another
    mesh of the same deck gets its own."""
    cfg, mesh = _forest(name)
    prm = make_transport_params(cfg, torch.float32)
    rng = np.random.default_rng(5)
    a = tk.prepare(_gray_coefs(mesh, rng), mesh, prm, cfg.jaybenne.dt)
    b = tk.prepare(_gray_coefs(mesh, rng), mesh, prm, 0.5 * cfg.jaybenne.dt)
    assert a.tabs.cell is not b.tabs.cell
    for part in ("block", "level", "lookup"):
        assert getattr(a.tabs, part) is getattr(b.tabs, part)
    _, other = _forest(name)
    c = tk.prepare(_gray_coefs(other, rng), other, prm, cfg.jaybenne.dt)
    assert c.tabs.block is not a.tabs.block and torch.equal(c.tabs.block, a.tabs.block)
    assert [k[0] for k in mesh.derived] == ["census forest"]


@pytest.mark.parametrize("name", sorted(FOREST_DECKS))
def test_plain_census_on_forests_is_unchanged(name, monkeypatch):
    """The plain census on each forest, gray and absorbing, is bitwise the census
    whose set-up builds the forest tables anew (``_set_up_tables``): every column,
    the events and the iteration maximum."""
    from jaybenne_tpu_torch.particles import forest_ledger

    cfg, mesh = _forest(name)
    prm = make_transport_params(cfg, torch.float32)
    coefs = _gray_coefs(mesh, np.random.default_rng(9))
    p0 = forest_ledger(mesh, 3000, torch.Generator().manual_seed(9), 2.99792458e10)
    a, it_a, ev_a = tk.transport_plain(p0.clone(), coefs, mesh, 77, prm, cfg.jaybenne.dt)
    monkeypatch.setattr(tk, "forest_tables", lambda m, dev, dtype=torch.float32: tuple(
        torch.from_numpy(t) for t in _set_up_tables(m)))
    b, it_b, ev_b = tk.transport_plain(p0.clone(), coefs, mesh, 77, prm, cfg.jaybenne.dt)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), f.name
    assert int(it_a) == int(it_b) and int(ev_a) == int(ev_b) > 0
