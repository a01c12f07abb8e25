"""Census transport: IMC, or hybrid IMC/DDMC, on a uniform or statically refined
mesh in 1D, 2D or 3D, with or without absorption, with gray or frequency-dependent
opacities.

Port of ``jaybenne_tpu/ops/pallas_transport.py::_transport_kernel`` (K1) in all
its configurations (K1(a), K1(b), K1(c) DDMC, K1(d) static refinement and K1(e),
gray and non-gray), of ``jaybenne_tpu/ops/pallas_grid.py::_grid_kernel`` (K3) and
of ``jaybenne_tpu/ops/pallas_bucketed.py::_bucketed_kernel`` (K4): the JAX package
runs the last two on meshes or forests whose tables do not fit VMEM, which here is
no limit, so one kernel covers all three.

``transport`` runs the census for a ledger: the CUDA kernels
(``csrc/table_kernel.cu`` builds the census's table, ``csrc/transport_kernel.cuh``
runs it) for CUDA tensors, their plain versions for CPU tensors.
``transport_plain`` is that plain version: a vectorised PyTorch port of the same
event body in which every lane advances one iteration per loop step, with the same
K2 draws, as the JAX kernel's lanes do. The tests hold it against the JAX kernels
under ``interpret=True``, and ``chip_smoke.py`` holds the CUDA kernel against it.

Both update the ledger tensors IN PLACE and return ``(particles, iterations,
events)``: the iteration count is the largest number of events any particle ran
(the JAX kernel's per-tile loop count), and events is an int64 total (the JAX
kernel's int32 total wraps past 2^31).

A uniform multi-block forest is first collapsed to one synthetic block, as the JAX
wrapper does (``_uniform_view``): block-local positions and indices shift to global
ones before the census and back after it (``collapse_plain`` and ``expand_plain``;
on a GPU the census kernel folds both into its reads and writes of every slot),
and the per-cell table is laid out in global row-major cell order. With DDMC the
table row of a cell also carries its faces' probabilities (``_face_pairs``, the
JAX ``_face_pair_vectors``), and the ledger's ``face`` column (the face-arrival
code of the albedo test) is read and written.

With a frequency-dependent opacity (``EPBremss``, the one non-gray model) the
table row of a cell is ``(rho, T, fleck, sigma_s)``, before the face
probabilities with DDMC, and each event evaluates the opacity at the particle's
photon energy (the ledger's read-only ``energy`` column) before the collision
draw: ``ea = fleck sigma_a(E)``, ``es = sigma_s + (1 - fleck) sigma_a(E)``, as
``pallas_transport.py:484-501`` does. K3 and K4 evaluate the same models once per
coefficient refresh on the TPU, where a lane whose cell changed stalls until the
next refresh; evaluating per event computes the same function.

A refined forest (``max_level > 0``) keeps the ledger block-local and the cell
table in block cell order, and the census reads and writes the ``block`` column:
each event gathers its block's cell size, and a particle that leaves its block is
re-homed by the block lookup grid (K1(d), ``pallas_transport.py:973-1020``). With
DDMC in 2D/3D a leak into a finer block is re-seated on one of the fine faces
around its coarse landing point (``:1022-1151``).

An owned range makes one census call a round of the spatial decomposition
(``OwnedRange``; the JAX package's ``pallas_grid.py::make_spatial_grid``, K3s, and
``pallas_bucketed.py::make_spatial_transport``, K4s). A lane runs while its cell
lies in the range and pauses, alive and short of census, at the first event that
leaves it: on a uniform mesh collapsed to one block the range is the shard's global
z cells and the cell table the shard's z-slab; on a forest it is the shard's blocks
and the cell table theirs, while the block table and the lookup grid stay global.
With DDMC in 2D/3D a leak into a finer block of another shard writes its leak code
into the ledger's ``leak`` column instead of resampling, and pauses: the fine
block's face probabilities live on that shard (``subface_resample``). The whole
mesh as the range is the single-device census, draw for draw.

One call can run every local shard of a round at once: with a sequence of ranges,
the shards' ledgers (adjacent slices of one ledger), their coefficients and their
seeds, one launch covers them all, each lane keyed by its slot's index in its own
shard's slice. The particle decomposition's step calls it so too, with no range:
every shard owns the whole mesh, and every row of the shard table points at the
one cell table (the fields are replicated, so the shards' coefficients are the
same). ``prepare`` builds a call's geometry and tables, so that a step
builds them once and every round reuses them. A forest's own tables (block table,
levels, lookup grid) are built once per mesh (``forest_tables``); where the
non-gray record would copy the coefficients verbatim, the kernel reads their
columns and no table is built (``record_columns``).

The census runs at the ledger's precision, float32 or float64 (``precision =
f64``): the same event body, a ``double`` instantiation of the CUDA kernel and its
float64 plain version. The float64 census draws 53-bit uniforms from the same
hash and tag layout (``kernel_rng``'s float64 pool), rounds every scalar of
``_Geom`` in float64, and takes ``finfo(float64).max`` and ``.tiny`` where the
float32 census takes 3e38 and 1e-37, as the JAX package's float64 event loop
(``jaybenne_tpu/ops/transport.py::_one_event``) does. The JAX package runs float64
through that XLA loop, which draws threefry variates in another structure, so the
float64 census agrees with it in distribution, not draw for draw. Its launches
are named with an ``_f64`` suffix (``launch_name``). Nothing falls back to
another loop.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from ..config import BC
from ..models.opacity import EPBremss, NonCGSUnits
from ..utils import constants
from ..utils.constants import LAM_EXT
from ..utils.device import device_const
from . import cuda_lib
from ..particles import join_slices
from .kernel_rng import DrawPool, raw_bits_plain

_BC_CODE = {BC.periodic: 0, BC.outflow: 1, BC.reflecting: 2}
_BIG = 3.0e38
_TINY = 1.0e-37
# the float64 census's: finfo(float64).max and .tiny, as the JAX float64 loop takes
_BIG64 = float(np.finfo(np.float64).max)
_TINY64 = float(np.finfo(np.float64).tiny)
REALS = (torch.float32, torch.float64)


def limits(dtype) -> tuple:
    """(big, tiny) of the census at ``dtype``: the face distance of a lane at rest
    on an axis, and the floor added to a rate before a divide."""
    return (_BIG64, _TINY64) if dtype == torch.float64 else (_BIG, _TINY)


def check_supported(mesh, prm, dtype) -> None:
    """Raise unless the census covers the configuration: float32 or float64 state."""
    if dtype not in REALS:
        raise ValueError(f"transport: float32 or float64 state only, not {dtype}")


def _f64(dtype) -> str:
    """The suffix of a float64 census's C entries and launch names."""
    return "_f64" if dtype == torch.float64 else ""


def launch_name(ndim: int, absorb: bool, ddmc: bool = False, smr: bool = False,
                nongray: bool = False, route: str = "", dtype=torch.float32) -> str:
    """The ``cuda_lib.LAUNCHES`` key of one kernel instantiation; ``route`` is an
    owned-range call's ``OwnedRange.route``; a float64 instantiation's name ends
    in ``_f64`` before the route."""
    return (f"transport_{ndim}d" + ("_abs" if absorb else "") + ("_ddmc" if ddmc else "")
            + ("_smr" if smr else "") + ("_ng" if nongray else "") + _f64(dtype) + route)


def occupancy(ndim: int, absorb: bool, ddmc: bool = False, smr: bool = False,
              nongray: bool = False, dtype=torch.float32) -> tuple:
    """(blocks, rounds) of one kernel instantiation: the blocks that a SM of the
    current GPU holds at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    and, where it runs in rounds on the card's resident grid, the most rounds a
    ledger may take there (csrc/transport_kernel.cuh, kRounds, kRoundsMax), else
    0."""
    blocks, rounds = ctypes.c_int(0), ctypes.c_int(0)
    cuda_lib.library().call("jb_transport_occupancy" + _f64(dtype), ndim, int(absorb),
                            int(ddmc), int(smr), int(nongray), ctypes.addressof(blocks),
                            ctypes.addressof(rounds))
    return blocks.value, rounds.value


def resident_blocks(ndim: int, absorb: bool, ddmc: bool = False, smr: bool = False,
                    nongray: bool = False, dtype=torch.float32) -> int:
    """Blocks of one kernel instantiation that a SM of the current GPU holds at
    once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    return occupancy(ndim, absorb, ddmc, smr, nongray, dtype)[0]


@dataclasses.dataclass(frozen=True)
class OwnedRange:
    """The part of the mesh one shard of the spatial decomposition owns, and with it
    what the shard's coefficients cover:

      * ``kind = "z"``: the global z cells [lo, lo + n) of a uniform mesh, whole
        planes of blocks (K3s, ``pallas_grid.py:1925-1940``); the coefficients are
        those of the blocks in them;
      * ``kind = "blocks"``: the blocks [lo, lo + n) of any forest (K4s), uniform
        or refined; the coefficients are those of these blocks.
    """

    kind: str
    lo: int
    n: int

    def __post_init__(self):
        if self.kind not in ("z", "blocks") or self.n < 1 or self.lo < 0:
            raise ValueError(f"owned range {self}")

    @property
    def route(self) -> str:
        return "@" + self.kind

    def n_blocks(self, mesh) -> int:
        """Blocks whose coefficients the shard holds."""
        if self.kind == "blocks":
            return self.n
        nrbz, nrby, nrbx = mesh.root_grid
        return self.n // mesh.nz * nrby * nrbx

    def check(self, mesh) -> None:
        """Raise unless the range fits ``mesh``: z ranges only on a uniform mesh, in
        whole planes of blocks, and in 1D/2D only the whole mesh. A block range may
        run past the mesh's last block into the padding blocks of the last shard."""
        if self.kind == "blocks":
            return
        nz_all = mesh.root_grid[0] * mesh.nz
        if (mesh.max_level > 0 or self.lo % mesh.nz or self.n % mesh.nz
                or self.lo + self.n > nz_all or (mesh.ndim < 3 and self.n != nz_all)):
            raise ValueError(f"owned range {self}: not whole z planes of blocks of this mesh")

    def bounds(self) -> tuple:
        """(lo, hi) of the range."""
        return self.lo, self.lo + self.n


def whole_mesh(mesh) -> OwnedRange:
    """The single-device census as an owned range: every block of a forest, every
    z cell of a uniform mesh."""
    if mesh.max_level > 0:
        return OwnedRange("blocks", 0, mesh.n_blocks)
    return OwnedRange("z", 0, mesh.root_grid[0] * mesh.nz)


@dataclasses.dataclass(frozen=True)
class _Geom:
    """Scalars of the event body at the census's precision ``real``: in float32
    each rounded as the JAX kernel rounds it, in float64 as the JAX float64 loop
    does. Per-axis tuples are (x, y, z); only the first ``ndim`` are used."""

    ndim: int
    absorb: bool
    ddmc: bool
    smr: bool       # a refined forest: per-block geometry and the lookup grid
    n: tuple        # cells per axis of the collapsed single block (of a block with SMR)
    bc: tuple       # six BC codes (ix1, ox1, ix2, ox2, ix3, ox3)
    # the collapsed single block's cell size, its reciprocal, its origin and dmin;
    # SMR gathers them per block instead
    dx: tuple
    inv_dx: tuple
    org: tuple
    lo: tuple
    hi: tuple
    lo_half: tuple
    hi_half: tuple
    span: tuple
    dmin: np.float32
    c: np.float32
    inv_c: np.float32
    cdt: np.float32
    inv_cdt: np.float32
    # DDMC only
    tau_ddmc: np.float32
    eps_imc: np.float32
    eps_ddmc: np.float32
    dt: np.float32
    inv_dt: np.float32   # f32(1) / f32(dt), as the JAX kernel takes it in f32
    lam2: np.float32     # 2 lambda_ext
    pf2_num: np.float32  # the albedo probability's numerator 2 (2 / 3)
    # SMR only: the lookup grid's tiles per axis, a tile's f32 edge, and the probe
    # nudges f32(0.5 finest) along a crossed face's normal and f32(0.01 finest)
    # along the other axes
    ntiles: tuple = (1, 1, 1)
    tile: tuple = (np.float32(0.0),) * 3
    nudge_cross: tuple = (np.float32(0.0),) * 3
    nudge_tilt: tuple = (np.float32(0.0),) * 3
    # non-gray only: EPBremss under NonCGSUnits, the constants of
    # ``_nongray_constants`` in ``NONGRAY_CONSTANTS`` order
    nongray: bool = False
    ng: tuple = (np.float32(0.0),) * 9
    # an owned-range call's ``OwnedRange.route`` (its ``LAUNCHES`` key's suffix)
    route: str = ""
    # the census's precision: the ledger's, the tables' and these scalars'
    real: torch.dtype = torch.float32


NONGRAY_CONSTANTS = ("rho_scale", "temp_scale", "length_scale", "sb", "kb", "hh", "g_ff",
                     "freq_min", "xc_max")


def _nongray_constants(coefs, rd=np.float32) -> tuple:
    """The constants of the per-event opacity rounded by ``rd``, in
    ``NONGRAY_CONSTANTS`` order:
    ``EPBremss``, bare or under ``NonCGSUnits``, is the one frequency-dependent
    model of either package (every scattering model is gray: its per-cell value is
    in the table)."""
    op = coefs.opacity
    base = op.base if isinstance(op, NonCGSUnits) else op
    if not isinstance(base, EPBremss):
        raise ValueError(f"transport: the per-event census evaluates EPBremss, not {op!r}")
    scales = ((op._rho_scale, op.temperature_scale, op.length_scale)
              if isinstance(op, NonCGSUnits) else (1.0, 1.0, 1.0))
    return tuple(rd(v) for v in (
        *scales, constants.SB, constants.KB, constants.HH, base.g_ff, base.FREQ_MIN,
        base.XC_MAX))


def _geometry(mesh, prm, dt, coefs, smr, real=None) -> _Geom:
    real = real or coefs.sigma_s.dtype
    check_supported(mesh, prm, real)
    rd = np.float64 if real == torch.float64 else np.float32  # the census's rounding
    b = mesh.bounds
    nrb = (1, 1, 1) if smr else mesh.root_grid[::-1]  # root blocks per axis (x, y, z)
    n = tuple(nrb[a] * (mesh.nx, mesh.ny, mesh.nz)[a] for a in range(3))
    dx = tuple((b[2 * a + 1] - b[2 * a]) / n[a] for a in range(3))
    c = rd(prm.c)
    cdt = c * rd(dt)
    half = [rd(0.5 * mesh.finest[a]) for a in range(3)]
    extra = {}
    if smr:
        extra = dict(
            ntiles=mesh.tile_shape[::-1],
            tile=mesh.tile_edges(real),
            nudge_cross=tuple(half),
            nudge_tilt=tuple(rd(0.01 * mesh.finest[a]) for a in range(3)),
        )
    if not coefs.is_gray:
        if not prm.has_absorption:
            raise ValueError("transport: a frequency-dependent opacity absorbs")
        extra.update(nongray=True, ng=_nongray_constants(coefs, rd))
    return _Geom(
        ndim=prm.ndim,
        absorb=bool(prm.has_absorption),
        ddmc=bool(prm.use_ddmc),
        smr=smr,
        n=n,
        bc=tuple(_BC_CODE[v] for v in prm.swarm_bc),
        dx=tuple(rd(v) for v in dx),
        inv_dx=tuple(rd(1.0 / v) for v in dx),
        org=tuple(rd(b[2 * a]) for a in range(3)),
        lo=tuple(rd(b[2 * a]) for a in range(3)),
        hi=tuple(rd(b[2 * a + 1]) for a in range(3)),
        lo_half=tuple(rd(b[2 * a]) + half[a] for a in range(3)),
        hi_half=tuple(rd(b[2 * a + 1]) - half[a] for a in range(3)),
        span=tuple(rd(b[2 * a + 1] - b[2 * a]) for a in range(3)),
        dmin=rd(min(dx[: prm.ndim])),
        c=c,
        inv_c=rd(1.0) / c,
        cdt=cdt,
        inv_cdt=rd(1.0) / cdt,
        tau_ddmc=rd(prm.tau_ddmc),
        eps_imc=rd(prm.eps_imc),
        eps_ddmc=rd(prm.eps_ddmc),
        dt=rd(dt),
        inv_dt=rd(1.0) / rd(dt),
        lam2=rd(2.0 * LAM_EXT),
        pf2_num=rd(2.0 * (2.0 / 3.0)),
        real=real,
        **extra,
    )


def to_global_cells(vec, mesh):
    """Per-cell vector in block order ([B * nz*ny*nx], i fastest) -> global
    row-major cell order of the collapsed block: a reshape and permute, valid
    because uniform block ids are (z, y, x) row-major (``build_mesh`` sorts by
    (level, z, y, x)). Port of ``pallas_transport.py::_to_global_cells``; on the
    blocks of whole z planes (a z-owned shard's) it gives their z-slab in global
    row-major order (``pallas_grid.py:2062-2066``, ``_local_glob``)."""
    _, nrby, nrbx = mesh.root_grid
    return (
        vec.reshape(-1, nrby, nrbx, mesh.nz, mesh.ny, mesh.nx)
        .permute(0, 3, 1, 4, 2, 5)
        .reshape(-1)
    )


def _face_pairs(px, py, pz, mesh):
    """Per-cell f32 ``(P_lower, P_upper)`` of each axis, [NC] each in block cell
    order, from the fields' face arrays: a port of the JAX
    ``_face_pair_vectors`` without its bf16 packing."""
    if px is None:
        raise ValueError("transport: DDMC needs the face probabilities in the coefficients")
    nx, ny, nz = mesh.nx, mesh.ny, mesh.nz
    px = px.reshape(-1, nz, ny, nx + 1)
    py = py.reshape(-1, nz, ny + 1, nx)
    pz = pz.reshape(-1, nz + 1, ny, nx)
    return [v.reshape(-1) for v in (px[..., :nx], px[..., 1:], py[:, :, :ny], py[:, :, 1:],
                                    pz[:, :nz], pz[:, 1:])]


@dataclasses.dataclass(frozen=True)
class _Tables:
    """What the census gathers from: the per-cell table, or for the kernel where
    that table would copy its record verbatim the coefficient columns ``cols``
    (``record_columns``), and on a refined forest the mesh's ``forest_tables``:
    the block table [B, 12] = (dx, dy, dz, 0, ox, oy, oz, 0, 1/dx, 1/dy, 1/dz, 0)
    read as three float4 (the reciprocals by an IEEE float32 divide, the bits the
    kernel's per-event divide gave), the int32 level of each block and the flat
    int32 lookup grid ((z, y, x) row-major, x fastest). ``opacity`` is the
    frequency-dependent model that the plain version evaluates per event (None
    for gray runs)."""

    cell: torch.Tensor | None
    block: torch.Tensor | None = None
    level: torch.Tensor | None = None
    lookup: torch.Tensor | None = None
    opacity: object = None
    cols: tuple | None = None


def _tables(cset, mesh, g: _Geom, kernel: bool, zero=None) -> _Tables:
    """The tables of the coefficient sets ``cset`` (one per owned range, in range
    order): the cell table by the CUDA kernel (``_table_cuda``, which zeroes
    ``zero`` where given) with ``kernel``, else by its plain version
    (``_pair_table``); on a forest the mesh's ``forest_tables``."""
    coefs = cset[0]
    cols = record_columns(cset, mesh, g) if kernel else None
    if cols is not None:
        cell = None
    elif kernel:
        cell = _table_cuda(cset, mesh, g, zero)
    else:
        cell = _pair_table(coefs if len(cset) == 1 else _concat_coefs(cset), mesh, g)
    forest = (forest_tables(mesh, coefs.sigma_s.device, g.real) if g.smr
              else (None, None, None))
    return _Tables(cell, *forest, coefs.opacity, cols)


def forest_tables(mesh, device, dtype=torch.float32) -> tuple:
    """The block table, levels and lookup grid of ``_Tables`` for ``mesh`` on
    ``device``, the block table at the census's precision ``dtype``. They depend
    on the mesh alone, so they are built once per mesh, device and precision, at
    the first census there, and kept in ``mesh.derived``: every later census and
    spatial step on the forest launches nothing for them; they are read, never
    written. Built on ``device`` by the operations a census set-up used to run
    each time, so the same bits (the reciprocals by an IEEE divide)."""
    key = ("census forest", torch.device(device), dtype)
    hit = mesh.derived.get(key)
    if hit is None:
        # slices, not an index list: a list index is a host tensor copied to the card
        block = torch.zeros((mesh.n_blocks, 12), dtype=dtype, device=device)
        block[:, 0:3] = mesh.block_dx.to(block)
        block[:, 4:7] = mesh.block_origin.to(block)
        block[:, 8:11] = torch.ones_like(block[:, 0:3]) / block[:, 0:3]
        hit = mesh.derived[key] = (
            block, mesh.block_level.to(device=device, dtype=torch.int32).contiguous(),
            mesh.lookup.to(device=device, dtype=torch.int32).reshape(-1).contiguous())
    return hit


def record_columns(cset, mesh, g: _Geom) -> tuple | None:
    """The coefficient columns (rho, T, fleck, sigma_s) that the census kernel reads
    its record from where the cell table would be their verbatim copy, else None:
    a non-gray census without DDMC over one owned range whose table is not
    permuted (one block, or block by block on a forest). Each column is checked
    as the table kernel checks it."""
    if not g.nongray or g.ddmc or len(cset) != 1 or (mesh.n_blocks > 1 and not g.smr):
        return None
    c = cset[0]
    cols = (c.rho, c.temp, c.fleck, c.sigma_s)
    if any(t is None or t.dtype != g.real or not t.is_contiguous()
           or t.device != c.sigma_s.device or t.shape != c.sigma_s.shape for t in cols):
        raise ValueError(f"census: rho, T, fleck and sigma_s must be contiguous {g.real} "
                         "columns of one length on one device")
    return cols


def _pair_table(coefs, mesh, g: _Geom):
    """The kernel's per-cell table (global row-major cell order on a uniform
    forest collapsed to one block, block cell order on a forest run block by block
    with ``smr``), from the
    effective rates ``ea = fleck sigma_a`` and ``es = sigma_s + (1 - fleck)
    sigma_a`` (without absorption ``ea = 0``, ``es = sigma_s``): without DDMC the
    real pair ``(p_abs, 1 / sigma_t)`` as an [NC, 2] tensor, with DDMC the [NC, 8]
    rows ``(ea, es, Px_lo, Px_hi, Py_lo, Py_hi, Pz_lo, Pz_hi)``. The JAX kernels
    switch pairs the same way and hold them packed in bf16. On a uniform 1D mesh
    the DDMC rows end instead with what the DDMC event would make from its cell
    alone (``kCell1d`` in csrc/transport_kernel.cuh), by the event's
    operations: the lower face's leak rate ``lk = Px_lo real(1 / dx)``, ``cdf =
    (ea + (lk + Px_hi real(1 / dx))) + tiny`` (without absorption ``(lk + Px_hi
    real(1 / dx)) + tiny``), ``c cdf`` and a zero. With a frequency-dependent
    opacity the rows are ``(rho, T, fleck, sigma_s)`` [NC, 4], with DDMC followed
    by the six face probabilities and two zeros [NC, 12]: the JAX kernel's (rho,
    T, fleck) tables and the per-cell value of its gray scattering."""
    real = g.real
    tiny = limits(real)[1]
    ss = coefs.sigma_s.to(real)
    faces = ([v.to(real) for v in _face_pairs(coefs.px, coefs.py, coefs.pz, mesh)] if g.ddmc
             else [])
    if not coefs.is_gray:
        zero = [torch.zeros_like(ss)] * 2 if g.ddmc else []
        cols = [coefs.rho.to(real), coefs.temp.to(real), coefs.fleck.to(real), ss, *faces, *zero]
    else:
        if g.absorb:
            sa, fl = coefs.sigma_a.to(real), coefs.fleck.to(real)
            ea = fl * sa
            es = ss + (1.0 - fl) * sa
        else:
            ea = torch.zeros_like(ss)
            es = ss
        if _cell_1d(g):
            inv_dx = float(g.inv_dx[0])
            lk = faces[0] * inv_dx
            leak_tot = lk + faces[1] * inv_dx
            cdf = (ea + leak_tot if g.absorb else leak_tot) + tiny
            cols = [ea, es, faces[0], faces[1], lk, cdf, cdf * float(g.c),
                    torch.zeros_like(ss)]
        elif g.ddmc:
            cols = [ea, es, *faces]
        else:
            inv = 1.0 / (ea + es + tiny)
            cols = [ea * inv, inv]
    if mesh.n_blocks > 1 and not g.smr:
        cols = [to_global_cells(v, mesh) for v in cols]
    return torch.stack(cols, dim=1).contiguous()


def _cell_1d(g: _Geom) -> bool:
    """Whether the DDMC record carries what the event makes from its cell alone
    (``kCell1d``): a uniform 1D gray mesh."""
    return g.ndim == 1 and g.ddmc and not g.smr and not g.nongray


# the census table's record kinds (csrc/table_kernel.cu): the gray pair, gray
# DDMC, non-gray, non-gray DDMC, gray DDMC on a uniform 1D mesh; their widths
_TABLE_WIDTHS = (2, 8, 4, 12, 8)


def _table_kind(g: _Geom) -> int:
    if _cell_1d(g):
        return 4
    return (2 if g.nongray else 0) + int(g.ddmc)


# the owned ranges one launch of the table kernel takes (kMaxRanges); a set-up over
# more makes one launch for each group of as many
MAX_RANGES_PER_TABLE = 16
_TABLE_COLUMNS = ("sigma_a", "sigma_s", "fleck", "rho", "temp", "px", "py", "pz")


def table_columns(g: _Geom) -> set:
    """The coefficient columns that the cell table's record reads."""
    if g.nongray:
        need = {"rho", "temp", "fleck", "sigma_s"}
    else:
        need = {"sigma_a", "fleck", "sigma_s"} if g.absorb else {"sigma_s"}
    return need | ({"px", "py", "pz"} if g.ddmc else set())


# threads a block of the census table kernel (csrc/table_kernel.cu, kThreads); the
# cells of one block's x line that a thread takes (RUN) where they are whole 16-byte
# words of every column and a row is at most TABLE_RUN_BYTES: a wider row is faster
# at one a thread (measured on an H100: PERF.md section 6)
TABLE_THREADS = 128
TABLE_RUN = 4
TABLE_RUN_BYTES = 16


def fast_divisor(d: int) -> tuple:
    """``(d, mul, shift)`` with ``n // d == (n * mul) >> 32 >> shift`` for every ``0
    <= n < 2**31`` (``mul`` 0 where ``d`` is 1: ``n >> 0``): the table kernel's
    division by a multiply-high and a shift (csrc/table_kernel.cu, ``quo``), its
    constants made as CUTLASS's FastDivmod makes them."""
    if not 1 <= d < 2**31:
        raise ValueError(f"census table: divisor {d} out of range")
    if d == 1:
        return (1, 0, 0)
    log = (d - 1).bit_length()  # ceil(log2 d)
    return (d, -(-(1 << (31 + log)) // d), log - 1)


@dataclasses.dataclass(frozen=True)
class TablePlan:
    """One launch of the census table kernel: ``run`` cells of a block's x line a
    thread (TABLE_RUN, or 1), ``blocks`` blocks of TABLE_THREADS threads (grid.x)
    over the longest range's runs, ``divisors`` the ``fast_divisor`` constants of
    a line's runs (X / run), of the lines of a plane (Y), nx, ny and nz, and
    ``nrbx``, ``nrby`` the root blocks along x and y of the rows' layout (1 and 1
    where rows are in block cell order)."""

    run: int
    blocks: int
    divisors: tuple
    nrbx: int
    nrby: int


def table_plan(mesh, g: _Geom, cells, aligned: bool = True) -> TablePlan:
    """The table kernel's plan for ranges of ``cells`` cells each on ``mesh``: a
    range's rows are the cells (x, y, z) of global row-major order over its whole z
    planes of blocks (uniform mesh of several blocks run collapsed, ``g.smr``
    false), else of block cell order, which is the same layout with one root
    block along x and y; a thread takes a run of TABLE_RUN cells where they are
    whole 16-byte words of every column (nx a multiple of it and every column
    ``aligned``) and a row of the record is at most TABLE_RUN_BYTES, else one."""
    permute = mesh.n_blocks > 1 and not g.smr
    _, nrby, nrbx = mesh.root_grid if permute else (1, 1, 1)
    row = _TABLE_WIDTHS[_table_kind(g)] * (8 if g.real == torch.float64 else 4)
    run = (TABLE_RUN if aligned and mesh.nx % TABLE_RUN == 0 and row <= TABLE_RUN_BYTES
           else 1)
    line, plane = nrbx * mesh.nx, nrby * mesh.ny
    if max(cells) >= 2**31 or any(n % (line * plane) for n in cells):
        raise ValueError(f"census table: ranges of {cells} cells, not whole planes of "
                         f"{line} x {plane} cells under 2**31")
    blocks = max(1, -(-max(cells) // (run * TABLE_THREADS)))
    divisors = tuple(fast_divisor(d) for d in (line // run, plane, mesh.nx, mesh.ny, mesh.nz))
    return TablePlan(run, blocks, divisors, nrbx, nrby)


def _table_cuda(cset, mesh, g: _Geom, zero=None):
    """``_pair_table`` of the coefficient sets ``cset`` (one per owned range, the
    ranges' rows one after another) as one pass of a CUDA kernel
    (``csrc/table_kernel.cu``) on PyTorch's current stream, a launch for each
    group of MAX_RANGES_PER_TABLE ranges, in the shape of ``table_plan``: the
    permutation to global row-major order as index arithmetic, the face columns
    read from the face arrays, the same float operations, so the same bits. The
    first launch zeroes ``zero`` (int64; the census's counters) where given.
    Raises unless every column that the record reads is contiguous at the
    census's precision on one GPU."""
    kind = _table_kind(g)
    need = table_columns(g)
    dev = cset[0].sigma_s.device
    cpb = mesh.ncells_per_block
    rows, total, aligned = [], 0, True
    for c in cset:
        cells = c.sigma_s.numel()
        nb = cells // cpb
        for name in need:
            t = getattr(c, name)
            # a face array has one face more than cells along its own axis
            faces = {"px": (0, 0, 1), "py": (0, 1, 0), "pz": (1, 0, 0)}.get(name)
            want = (cells if faces is None else
                    nb * (mesh.nz + faces[0]) * (mesh.ny + faces[1]) * (mesh.nx + faces[2]))
            if (t is None or t.device != dev or dev.type != "cuda" or t.dtype != g.real
                    or not t.is_contiguous() or t.numel() != want):
                raise ValueError(f"census table kernel: {name} must be {want} contiguous "
                                 f"{g.real} values on one GPU")
            # px is read a cell at a time; every other column in 16-byte words
            aligned &= name == "px" or t.data_ptr() % 16 == 0
        rows.append((cells, total))
        total += cells
    plan = table_plan(mesh, g, [n for n, _ in rows], aligned)
    divisors = (ctypes.c_uint * 15)(*(v for d in plan.divisors for v in d))
    out = torch.empty((total, _TABLE_WIDTHS[kind]), dtype=g.real, device=dev)
    for k0 in range(0, len(cset), MAX_RANGES_PER_TABLE):
        group = cset[k0:k0 + MAX_RANGES_PER_TABLE]
        ptrs = [getattr(c, name).data_ptr() if name in need else 0
                for c in group for name in _TABLE_COLUMNS]
        ranges = [v for r in rows[k0:k0 + len(group)] for v in r]
        z = zero if k0 == 0 else None
        cuda_lib.library().call(
            "jb_table_launch" + _f64(g.real), kind, int(g.absorb), plan.run, out.data_ptr(),
            len(group), (ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_int * len(ranges))(*ranges), divisors, plan.nrbx, plan.nrby,
            plan.blocks, float(g.inv_dx[0]), float(g.c), 0 if z is None else z.data_ptr(),
            0 if z is None else z.numel(), cuda_lib.stream_handle(dev))
        cuda_lib.LAUNCHES["census_table" + _f64(g.real)] += 1
    return out


def _block_shifts(mesh, dtype=torch.float32):
    """Per-axis block extents at ``dtype`` (the collapse shift per block index)."""
    nrb = mesh.root_grid[::-1]
    b = mesh.bounds
    rd = np.float64 if dtype == torch.float64 else np.float32
    return [float(rd((b[2 * a + 1] - b[2 * a]) / nrb[a])) for a in range(3)]


def collapse_plain(p, mesh):
    """Shift block-local state to the single synthetic block (in place): the plain
    version of what the census kernel applies where it reads a slot (its fold)."""
    nrbz, nrby, nrbx = mesh.root_grid
    D = _block_shifts(mesh, p.x.dtype)
    bl = (p.block % nrbx, (p.block // nrbx) % nrby, p.block // (nrbx * nrby))
    for pos, idx, bk, d, nloc in zip((p.x, p.y, p.z), (p.i, p.j, p.k), bl, D,
                                     (mesh.nx, mesh.ny, mesh.nz)):
        pos += bk.to(p.x.dtype) * d
        idx += bk * nloc
    p.block.zero_()


def expand_plain(p, mesh):
    """Inverse of ``collapse_plain``: recover the owning block from the global
    indices (in place); the plain version of what the census kernel applies where
    it writes a slot back (its fold)."""
    nrbz, nrby, nrbx = mesh.root_grid
    D = _block_shifts(mesh, p.x.dtype)
    bl = []
    for pos, idx, d, nloc in zip((p.x, p.y, p.z), (p.i, p.j, p.k), D,
                                 (mesh.nx, mesh.ny, mesh.nz)):
        bk = torch.div(idx, nloc, rounding_mode="floor")
        idx -= bk * nloc
        pos -= bk.to(p.x.dtype) * d
        bl.append(bk)
    p.block.copy_((bl[2] * nrby + bl[1]) * nrbx + bl[0])


def _ddmc_plain(pool, it, g: _Geom, k, is_ddmc, ea, sig_t, pf, face, tau, pos, idx, vel,
                fl, fu):
    """The DDMC event of the lanes ``is_ddmc`` (pallas_transport.py:655-870), drawing
    after the IMC event's variates. ``k`` holds the f32 scalars of
    ``_census_plain`` (``dx`` and ``inv_dx`` per lane with SMR), ``pf`` the
    gathered (P_lower, P_upper) per axis. Returns (positions, index shifts,
    velocities, tau, absorbed, leak code): the values of every lane, of which the
    caller keeps those of ``is_ddmc``; the leak code is -(axis + 1) for a leak
    through a lower face, +(axis + 1) through an upper one, else 0."""
    nd = g.ndim
    c, zero, one = k["c"], k["zero"], k["one"]
    dx, inv_dx = k["dx"], k["inv_dx"]
    ea_dd = zero if ea is None else ea
    # albedo test on arrival at a face: +code at the lower face, -code at the upper
    sel = []
    for a in range(nd):
        sel += [is_ddmc & (face == a + 1), is_ddmc & (face == -(a + 1))]
    at_face = is_ddmc & (face != 0)
    prob = torch.zeros_like(tau)
    for a in range(nd):
        pf2 = k["pf2_num"] / (sig_t * dx[a] + k["lam2"])
        drift = 1.5 * vel[a] * k["inv_c"]
        prob = torch.where(sel[2 * a], pf2 * (1.0 + drift), prob)
        prob = torch.where(sel[2 * a + 1], pf2 * (1.0 - drift), prob)
    rejected = at_face & (pool.u23(it) > prob)

    def hemisphere():
        """(mu, nu cos phi, nu sin phi) of a cosine-weighted direction; 1D parks the
        transverse magnitude in the second slot."""
        amu = torch.sqrt(pool.u16(it))
        anu = torch.sqrt(torch.clamp_min(1.0 - amu * amu, 0.0))
        if nd == 1:
            return amu, anu, zero
        cph, sph = pool.circle(it)
        return amu, anu * cph, anu * sph

    def place(lanes, a, lower, offset, h, new_pos, shift, new_vel):
        """Move ``lanes`` ``offset`` cells beyond a face of axis ``a`` and give them
        direction ``h`` out through it; (v1, v2, v3) go to the axes (a, a+1, a+2)."""
        edge = fl[a] - offset * dx[a] if lower else fu[a] + offset * dx[a]
        new_pos[a] = torch.where(lanes, edge, new_pos[a])
        shift[a] = torch.where(lanes, -1 if lower else 1, shift[a])
        vs = (c * (-1.0 if lower else 1.0) * h[0], c * h[1], c * h[2])
        for q in range(3):
            new_vel[(a + q) % 3] = torch.where(lanes, vs[q], new_vel[(a + q) % 3])

    rj_pos, rj_shift, rj_vel = list(pos), [torch.zeros_like(i) for i in idx], list(vel)
    h = hemisphere()
    for e in range(2 * nd):
        place(sel[e], e // 2, e % 2 == 0, k["eps_imc"], h, rj_pos, rj_shift, rj_vel)

    # in-cell step: leak rates P_face / dx, event time against census
    lk = [pf[e] * inv_dx[e // 2] for e in range(2 * nd)]
    leak_tot = lk[0] + lk[1]
    for v in lk[2:]:
        leak_tot = leak_tot + v
    cdf = ea_dd + leak_tot + k["tiny"]
    dt_ev = pool.exp23(it) / (c * cdf)
    dt_rem = k["dt"] * (1.0 - tau)
    is_event = dt_ev < dt_rem
    do_step = is_ddmc & ~rejected
    dd_tau = torch.where(is_event, tau + dt_ev * k["inv_dt"], one)
    xi = cdf * pool.u23(it)
    dd_abs = do_step & is_event & (xi < ea_dd)
    xim = xi - ea_dd
    cum = zero
    leak_sel, leak_any = [], torch.zeros_like(is_event)
    for v in lk:
        m = do_step & is_event & ~dd_abs & ~leak_any & (xim < cum + v)
        leak_sel.append(m)
        leak_any = leak_any | m
        cum = cum + v
    # the numerical fall-through takes the last face
    leak_sel[-1] = leak_sel[-1] | (do_step & is_event & ~dd_abs & ~leak_any)

    dd_pos, dd_shift, dd_vel = list(pos), [torch.zeros_like(i) for i in idx], list(vel)
    h = hemisphere()
    centre = [fl[a] + 0.5 * dx[a] for a in range(nd)]
    leak = torch.zeros_like(face)
    for e in range(2 * nd):
        a = e // 2
        for t in range(nd):  # transverse coordinates at the cell centre
            if t != a:
                dd_pos[t] = torch.where(leak_sel[e], centre[t], dd_pos[t])
        place(leak_sel[e], a, e % 2 == 0, k["eps_ddmc"], h, dd_pos, dd_shift, dd_vel)
        leak = torch.where(leak_sel[e], -(a + 1) if e % 2 == 0 else a + 1, leak)

    # census: uniform position in the cell, isotropic direction
    dd_census = do_step & ~is_event
    for a in range(nd):
        dd_pos[a] = torch.where(dd_census, fl[a] + pool.u16(it) * dx[a], dd_pos[a])
    cmu = 1.0 - 2.0 * pool.u16(it)
    cst = torch.sqrt(torch.clamp_min(1.0 - cmu * cmu, 0.0))
    if nd == 1:
        cv = (c * cmu, c * cst, zero)
    else:
        cph, csh = pool.circle(it)
        cv = (c * cst * cph, c * cst * csh, c * cmu)
    dd_vel = [torch.where(dd_census, nv, v) for nv, v in zip(cv, dd_vel)]

    # a rejected lane bounces back, with no time advance
    dd_pos = [torch.where(rejected, r, v) for r, v in zip(rj_pos, dd_pos)]
    dd_shift = [torch.where(rejected, r, v) for r, v in zip(rj_shift, dd_shift)]
    dd_vel = [torch.where(rejected, r, v) for r, v in zip(rj_vel, dd_vel)]
    dd_tau = torch.where(rejected, tau, dd_tau)
    return dd_pos, dd_shift, dd_vel, dd_tau, dd_abs, torch.where(rejected, 0, leak)


def _rehome_plain(pool, it, g: _Geom, k, tabs: _Tables, blk, gp, out_lo, out_hi, nvel,
                  leak, cell_of, own):
    """The lanes that left their block on a refined forest (K1(d),
    pallas_transport.py:973-1151): the lookup probe, half a finest cell along a
    crossed face's normal and ``0.01 finest v / c`` along the other axes, binned
    by ``floor``; the rebase into the new block; and with DDMC in 2D/3D the
    coarse-to-fine subface resample of a leak into a finer block of the owned
    range ``own`` = (lo, hi). Computed for every lane; the caller keeps the lanes
    that left. Returns (block, local positions, cell indices, velocities, the
    pending leak code of a leak into a finer block outside the range, or None
    without DDMC in 2D/3D)."""
    nd = g.ndim
    t = []
    for a in range(nd):
        sg = (torch.where(out_hi[a], 1.0, 0.0) - torch.where(out_lo[a], 1.0, 0.0)).to(g.real)
        probe = gp[a] + torch.where(sg != 0.0, k["nudge_cross"][a] * sg,
                                    k["nudge_tilt"][a] * (nvel[a] * k["inv_c"]))
        t.append(torch.clamp(torch.floor((probe - k["lo"][a]) / k["tile"][a]).to(torch.int32),
                             0, g.ntiles[a] - 1).long())
    tidx = t[0]
    if nd >= 2:
        tidx = t[1] * g.ntiles[0] + tidx
    if nd == 3:
        tidx = (t[2] * g.ntiles[1] + t[1]) * g.ntiles[0] + t[0]
    b_new = tabs.lookup[tidx]
    row = tabs.block[b_new.long()]
    ndx = [row[:, a] for a in range(nd)]
    loc = [gp[a] - row[:, 4 + a] for a in range(nd)]
    idx = [torch.clamp(torch.floor(loc[a] / ndx[a]).to(torch.int32), 0, g.n[a] - 1)
           for a in range(nd)]
    vel = list(nvel)
    if not (g.ddmc and nd >= 2):
        return b_new, loc, idx, vel, None

    # coarse -> fine subface resample: the leak landed at the transverse centre of
    # its coarse cell, on the edge (2D) or corner (3D) of 2 or 4 fine faces; the
    # fine faces of a block outside the owned range live on another shard
    refine = (leak != 0) & (tabs.level[b_new.long()] > tabs.level[blk.long()])
    here = (b_new >= own[0]) & (b_new < own[1])
    pending = torch.where(refine & ~here, leak, 0)
    refine = refine & here
    u_sel = pool.u16(it)
    u_t = [pool.u16(it) for _ in range(nd - 1)]
    smu = torch.sqrt(pool.u16(it))
    snu = torch.sqrt(torch.clamp_min(1.0 - smu * smu, 0.0))
    sph, ssh = pool.circle(it)
    hemi = (smu, snu * sph, snu * ssh)
    p0 = _face_column(g)

    def face_prob(ax, upper, ijk):
        """The fine block's P_lower (leak in +axis) or P_upper of axis ``ax``."""
        r = tabs.cell[cell_of(b_new.long(), [q.long() for q in ijk])]
        return torch.where(upper, r[:, p0 + 1 + 2 * ax], r[:, p0 + 2 * ax])

    loc, idx, vel = _subface_pick(nd, g.n, refine, leak, loc, idx, ndx, vel, face_prob,
                                  u_sel, u_t, hemi, k["c"], k["zero"], k["tiny"])
    return b_new, loc, idx, vel, pending


def _subface_pick(nd, n, refine, leak, loc, idx, ndx, vel, face_prob, u_sel, u_t, hemi, c,
                  zero, tiny):
    """The coarse-to-fine subface resample of the lanes ``refine``, whose DDMC leak
    ``leak`` = +-(axis + 1) landed at the transverse centre of a coarse cell on a
    finer block (``n`` cells per axis, cell sizes ``ndx``): e = clip(rint(l / dx),
    1, n - 1) on each transverse axis gives the 2 (2D) or 4 (3D) fine faces around
    the landing point; one is picked by the fine block's ``face_prob(axis, upper,
    cell)``, P_lower for a leak in +axis and P_upper in -axis, in 2D by u (P_l +
    P_u) >= P_l, in 3D by cumulative sum against u (sum + tiny); the transverse
    position is redrawn uniformly on it (``u_t``) and the direction from the
    hemisphere ``hemi`` into the block, in the cyclic axis order. Updates and
    returns the lists (loc, idx, vel)."""
    real = loc[0].dtype
    leak_axis = leak.abs() - 1
    lsgn = torch.sign(leak).to(real)
    take_upper = lsgn < 0.0  # a leak in -axis enters the upper face of the last cell
    for ax in range(nd):
        m = refine & (leak_axis == ax)
        f_ax = torch.where(lsgn > 0, 0, n[ax] - 1).to(torch.int32)
        trans = [q for q in range(nd) if q != ax]
        edges = []
        for q in trans:
            e = torch.clamp(torch.round(loc[q] / torch.clamp_min(ndx[q], tiny))
                            .to(torch.int32), 1, n[q] - 1)
            edges.append((e - 1, e))

        def at(*cs):
            ijk = list(idx)
            ijk[ax] = f_ax
            for q, cq in zip(trans, cs):
                ijk[q] = cq
            return ijk

        if nd == 2:
            (lo1, hi1), = edges
            p_l = face_prob(ax, take_upper, at(lo1))
            p_u = face_prob(ax, take_upper, at(hi1))
            sel = [torch.where(u_sel * (p_l + p_u) >= p_l, hi1, lo1)]
        else:
            (lo1, hi1), (lo2, hi2) = edges
            cands = [(lo1, lo2), (hi1, lo2), (lo1, hi2), (hi1, hi2)]
            probs = [face_prob(ax, take_upper, at(*cs)) for cs in cands]
            xi = u_sel * (probs[0] + probs[1] + probs[2] + probs[3] + tiny)
            cum = zero
            sel = [hi1, hi2]  # the numerical fall-through takes the last candidate
            chosen = torch.zeros_like(m)
            for cs, pr in zip(cands, probs):
                hit = ~chosen & (xi < cum + pr)
                sel = [torch.where(hit, cq, sq) for cq, sq in zip(cs, sel)]
                chosen = chosen | hit
                cum = cum + pr
        for q, sq, u in zip(trans, sel, u_t):
            idx[q] = torch.where(m, sq, idx[q])
            loc[q] = torch.where(m, (sq.to(real) + u) * ndx[q], loc[q])
        # hemisphere direction into the block, in the cyclic axis order
        vs = (c * lsgn * hemi[0], c * hemi[1], c * hemi[2])
        for q in range(3):
            vel[(ax + q) % 3] = torch.where(m, vs[q], vel[(ax + q) % 3])
    return loc, idx, vel


def _face_column(g: _Geom) -> int:
    """The cell table's column of Px_lo with DDMC."""
    return 4 if g.nongray else 2


def _census_plain(p, tabs: _Tables, g: _Geom, shards: tuple, max_iters: int, fold=None,
                  lane_events=None, go=None):
    """All lanes advance one event per loop step (the JAX kernel's tile loop over
    the whole ledger) while their cell lies in their shard's owned range (of
    blocks with SMR, of global z cells in 3D without); ``shards`` are ``_Shard``
    rows, and a slot in none of them does not run. With ``fold`` a uniform mesh
    of several blocks: the ledger is collapsed to one block before
    (``collapse_plain``) and expanded after (``expand_plain``). Returns
    (iterations, events) as [len(shards)] tensors; ``lane_events``, an int32
    tensor of the ledger's length, receives each slot's events.

    With ``go`` (a 0-dim bool tensor) false the call changes nothing and counts
    nothing, as the kernel's launch that reads the flag first: the census runs,
    and every column, the counts and ``lane_events`` are put back where the flag
    is false, with no host read of the flag."""
    kept = {}
    if go is not None:
        kept = {f.name: getattr(p, f.name).clone() for f in dataclasses.fields(p)}
        if lane_events is not None:
            kept["lane_events"] = lane_events.clone()
    if fold is not None:
        collapse_plain(p, fold)
    iters, events = _census_loop(p, tabs, g, shards, max_iters, lane_events)
    if fold is not None:
        expand_plain(p, fold)
    if go is None:
        return iters, events
    for name, old in kept.items():
        col = lane_events if name == "lane_events" else getattr(p, name)
        torch.where(go, col, old, out=col)
    return torch.where(go, iters, 0), torch.where(go, events, 0)


def _census_loop(p, tabs: _Tables, g: _Geom, shards: tuple, max_iters: int, lane_events):
    dev = p.x.device
    real = g.real
    big, tiny = limits(real)
    nd = g.ndim

    def s(v):
        return device_const(float(v), real, dev)

    def axes(vals):
        return [s(v) for v in vals[:nd]]

    dx, inv_dx, org = axes(g.dx), axes(g.inv_dx), axes(g.org)
    lo, hi, lo_half, hi_half, span = (axes(v) for v in (g.lo, g.hi, g.lo_half,
                                                        g.hi_half, g.span))
    dmin, c, inv_c, cdt, inv_cdt = (s(v) for v in (g.dmin, g.c, g.inv_c, g.cdt,
                                                   g.inv_cdt))
    one, zero = s(1.0), s(0.0)
    k = dict(c=c, inv_c=inv_c, one=one, zero=zero, dx=dx, inv_dx=inv_dx, lo=lo,
             tiny=s(tiny), tile=axes(g.tile), nudge_cross=axes(g.nudge_cross),
             nudge_tilt=axes(g.nudge_tilt),
             **{name: s(getattr(g, name)) for name in ("eps_imc", "eps_ddmc", "dt", "inv_dt",
                                                       "lam2", "pf2_num")})
    # each slot's shard: its lane (the slot's index in the shard's slice), seed,
    # owned range and first table row
    cap = p.capacity
    lanes = torch.zeros(cap, dtype=torch.int64, device=dev)
    seeds, own_lo, own_hi, row0 = (torch.zeros_like(lanes) for _ in range(4))
    in_shard = torch.zeros(cap, dtype=torch.bool, device=dev)
    for sh in shards:
        sl = slice(sh.slot_lo, sh.slot_hi)
        lanes[sl] = torch.arange(sh.slot_hi - sh.slot_lo, dtype=torch.int64, device=dev)
        for t, v in ((seeds, sh.seed & 0xFFFFFFFF), (own_lo, sh.own_lo), (own_hi, sh.own_hi),
                     (row0, sh.row)):
            t[sl] = v
        in_shard[sl] = True
    own = (own_lo, own_hi)

    def raw(it, tag):
        return raw_bits_plain(seeds, lanes, it, tag)

    n_rows = tabs.cell.shape[0]

    def cell_of(blk, ijk):
        """Cell table row: row-major on a uniform forest (over the owned z cells), in
        block order with SMR (over the owned blocks), after the rows of the shards
        before; clipped to the table, so a lane outside the range gathers a row it
        does not use."""
        if g.smr:
            cell = blk - own_lo
            for a in reversed(range(nd)):
                cell = cell * g.n[a] + ijk[a]
        else:
            cell = ijk[0]
            if nd == 2:
                cell = ijk[1] * g.n[0] + cell
            elif nd == 3:
                cell = ((ijk[2] - own_lo) * g.n[1] + ijk[1]) * g.n[0] + cell
        return torch.clamp(cell + row0, 0, n_rows - 1)

    pos = [p.x, p.y, p.z][:nd]
    idx = [p.i, p.j, p.k][:nd]
    vel = [p.vx, p.vy, p.vz]
    blk = p.block
    tau, alive, absorbed, face = p.tau, p.alive, p.absorbed, p.face

    def owned():
        if g.smr:
            return in_shard & (blk >= own_lo) & (blk < own_hi)
        if nd == 3:
            return in_shard & (idx[2] >= own_lo) & (idx[2] < own_hi)
        return in_shard

    n_ev = torch.zeros(cap, dtype=torch.int32, device=dev)
    it = 0
    while it < max_iters:
        active = alive & (tau < one) & owned()
        if not bool(active.any()):
            break
        pool = DrawPool(raw, real)
        if g.smr:  # the lane's block geometry
            brow = tabs.block[blk.long()]
            dx = [brow[:, a] for a in range(nd)]
            dmin = dx[0]
            for a in range(1, nd):
                dmin = torch.minimum(dmin, dx[a])
            if g.ddmc:
                k["dx"], k["inv_dx"] = dx, [brow[:, 8 + a] for a in range(nd)]
        row = tabs.cell[cell_of(blk.long(), [q.long() for q in idx])]
        if g.nongray:  # rows (rho, T, fleck, sigma_s): the opacity at the photon energy
            ff = row[:, 2]
            sa = tabs.opacity.absorption_coefficient(row[:, 0], row[:, 1], p.energy)
            ea = ff * sa
            sig_t = ea + (row[:, 3] + (1.0 - ff) * sa)
        elif g.ddmc:  # rows (ea, es, P_lower, P_upper per axis)
            ea = row[:, 0] if g.absorb else None
            sig_t = row[:, 1] if ea is None else ea + row[:, 1]
        is_ddmc = active & (dmin * sig_t > s(g.tau_ddmc)) if g.ddmc else None
        act_imc = active & ~is_ddmc if g.ddmc else active
        if g.ddmc or g.nongray:
            d_coll = pool.exp23(it) / (sig_t + tiny)
        else:  # rows (p_abs, 1 / sigma_t)
            d_coll = pool.exp23(it) * row[:, 1]
        u_branch = pool.u23(it) if g.absorb else None
        d_end = cdt * (one - tau)
        d_geom = torch.minimum(dmin, d_end)
        fl, fu, fd = [], [], []
        for a in range(nd):
            fi = idx[a].to(real)
            fl.append(fi * dx[a])
            fu.append((fi + one) * dx[a])
            v = vel[a]
            tgt = torch.where(v > 0, fu[a], fl[a])
            fd.append(torch.where(v != 0, c * (tgt - pos[a]) / torch.where(v != 0, v, one),
                                  big))
        d_push = torch.minimum(d_geom, fd[0])
        for a in range(1, nd):
            d_push = torch.minimum(d_push, fd[a])
        coll = act_imc & (d_coll < d_push)
        if g.absorb:
            i_abs = coll & ((u_branch * sig_t < ea) if g.ddmc or g.nongray
                            else (u_branch < row[:, 0]))
            i_sc = coll & ~i_abs
        else:
            i_abs, i_sc = None, coll
        no_coll = act_imc & ~coll
        # crossing: the nearest face wins, ties to the lower axis
        cr, taken = [], torch.zeros_like(no_coll)
        for a in range(nd):
            m = no_coll & ~taken & (fd[a] <= d_geom)
            for b in range(a + 1, nd):
                m = m & (fd[a] <= fd[b])
            cr.append(m)
            taken = taken | m
        census = no_coll & ~taken & (d_end <= dmin)

        d = torch.where(active, torch.where(coll, d_coll, d_push), zero)
        ntau = torch.where(census, one, tau + d * inv_cdt)
        step = d * inv_c
        npos, nidx = [], []
        for a in range(nd):
            up = vel[a] > 0
            q = torch.where(cr[a], torch.where(up, fu[a], fl[a]), pos[a] + vel[a] * step)
            npos.append(q)
            nidx.append(idx[a] + torch.where(cr[a], torch.where(up, 1, -1), 0).to(torch.int32))

        mu = 1.0 - 2.0 * pool.u16(it)
        st = torch.sqrt(torch.clamp_min(1.0 - mu * mu, 0.0))
        if nd == 1:
            new_v = (c * mu, c * st, zero)
        else:
            cph, sph = pool.circle(it)
            new_v = (c * st * cph, c * st * sph, c * mu)
        nvel = [torch.where(i_sc, nv, v) for nv, v in zip(new_v, vel)]
        nalive = alive if i_abs is None else alive & ~i_abs

        leak = None
        if g.ddmc:
            # face-arrival code: +-(axis + 1) after a crossing, else 0
            nface = torch.zeros_like(face)
            for a in range(nd):
                nface = torch.where(cr[a], torch.where(vel[a] > 0, a + 1, -(a + 1)), nface)
            pf = [row[:, _face_column(g) + e] for e in range(2 * nd)]
            dd_pos, dd_shift, dd_vel, dd_tau, dd_abs, dd_leak = _ddmc_plain(
                pool, it, g, k, is_ddmc, ea, sig_t, pf, face, tau, pos, idx, vel, fl, fu)
            npos = [torch.where(is_ddmc, q, v) for q, v in zip(dd_pos, npos)]
            nidx = [torch.where(is_ddmc, i + sh, v) for i, sh, v in zip(idx, dd_shift, nidx)]
            nvel = [torch.where(is_ddmc, q, v) for q, v in zip(dd_vel, nvel)]
            ntau = torch.where(is_ddmc, dd_tau, ntau)
            nalive = nalive & ~dd_abs
            i_abs = dd_abs if i_abs is None else i_abs | dd_abs
            nface = torch.where(is_ddmc, 0, nface)
            leak = torch.where(is_ddmc, dd_leak, 0)

        # domain boundaries: half-finest-cell tolerant hit test, then clip
        out_lo = [nidx[a] < 0 for a in range(nd)]
        out_hi = [nidx[a] >= g.n[a] for a in range(nd)]
        box = [brow[:, 4 + a] for a in range(nd)] if g.smr else org
        gp = [box[a] + npos[a] for a in range(nd)]
        for a in range(nd):
            hits = ((out_lo[a] & (gp[a] <= lo_half[a]), g.bc[2 * a], 1.0, lo[a]),
                    (out_hi[a] & (gp[a] >= hi_half[a]), g.bc[2 * a + 1], -1.0, hi[a]))
            for hit, bc, sgn, wall in hits:
                if bc == _BC_CODE[BC.reflecting]:
                    gp[a] = torch.where(hit, torch.clamp(2.0 * wall - gp[a], lo[a], hi[a]),
                                        gp[a])
                    nvel[a] = torch.where(hit, -nvel[a], nvel[a])
                    if g.ddmc:
                        nface = torch.where(hit, -nface, nface)
                elif bc == _BC_CODE[BC.periodic]:
                    gp[a] = torch.where(hit, torch.clamp(gp[a] + sgn * span[a], lo[a], hi[a]),
                                        gp[a])
                else:
                    nalive = nalive & ~hit
        out = out_lo[0] | out_hi[0]
        for a in range(1, nd):
            out = out | out_lo[a] | out_hi[a]
        out = out & nalive
        if g.smr:  # re-home by the lookup grid
            b_new, la, ra, rvel, pending = _rehome_plain(pool, it, g, k, tabs, blk, gp, out_lo,
                                                         out_hi, nvel, leak, cell_of, own)
            nvel = [torch.where(out, rv, v) for rv, v in zip(rvel, nvel)]
            blk.copy_(torch.where(out, b_new, blk))
            if pending is not None:  # a leak into another shard's finer block
                p.leak.copy_(torch.where(out & (pending != 0), pending, p.leak))
        else:  # rebase into the single block
            la = [gp[a] - org[a] for a in range(nd)]
            ra = [torch.clamp((la[a] * inv_dx[a]).to(torch.int32), 0, g.n[a] - 1)
                  for a in range(nd)]
        for a in range(nd):
            pos[a].copy_(torch.where(out, la[a], npos[a]))
            idx[a].copy_(torch.where(out, ra[a], torch.clamp(nidx[a], 0, g.n[a] - 1)))
        for v, nv in zip(vel, nvel):
            v.copy_(nv)
        tau.copy_(ntau)
        if i_abs is not None:
            absorbed.copy_(absorbed | i_abs)
        alive.copy_(nalive)
        if g.ddmc:  # an inactive lane keeps its code
            face.copy_(torch.where(active, nface, face))
        n_ev += active.to(torch.int32)
        it += 1
    if lane_events is not None:
        lane_events.copy_(n_ev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    events = torch.stack([n_ev[sh.slot_lo:sh.slot_hi].sum(dtype=torch.int64) for sh in shards])
    iters = torch.stack([torch.cat([n_ev[sh.slot_lo:sh.slot_hi], zero]).max() for sh in shards])
    return iters, events


def _check_cuda_ledger(p, tabs: _Tables, real=torch.float32):
    """What the kernel takes, checked before anything touches the ledger: the
    ledger's and the tables' floats at the census's precision ``real``."""
    dev = p.x.device
    floats = (p.x, p.y, p.z, p.vx, p.vy, p.vz, p.tau, p.energy)
    ints = (p.i, p.j, p.k, p.block, p.face, p.leak)
    bools = (p.alive, p.absorbed)
    tables = tuple(t for t in (tabs.cell, tabs.block, tabs.level, tabs.lookup, *(tabs.cols or ()))
                   if t is not None)
    for t in (*floats, *ints, *bools, *tables):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("transport kernel: ledger tensors must be contiguous on one GPU")
    if any(t.shape != (p.capacity,) for t in (*floats, *ints, *bools)):
        raise ValueError("transport kernel: ledger columns differ in length")
    tab_floats = tuple(t for t in (tabs.cell, tabs.block, *(tabs.cols or ())) if t is not None)
    if (any(t.dtype != real for t in floats + tab_floats)
            or any(t.dtype != torch.int32 for t in ints)):
        raise ValueError(f"transport kernel: {real} state and tables and int32 cell indices "
                         "only")
    if any(t.dtype != torch.bool for t in bools):
        raise ValueError("transport kernel: the alive and absorbed masks must be torch.bool")
    if p.capacity >= 2**31:
        raise ValueError("transport kernel: capacity must fit in int32")


# the shards one launch takes (csrc/transport_kernel.cuh, kMaxShards); a call over
# more makes one launch for each group of as many
MAX_SHARDS_PER_LAUNCH = 64
# threads a block of the census kernel (csrc/transport_kernel.cuh, kThreads)
THREADS = 256
# the routes whose launch spreads its shards' slices over the card's first wave
# of blocks (csrc/transport_kernel.cuh, kSpreadShards, which the launch of no
# other instantiation reads): the spatial round of the 2D SMR+DDMC block route
# (K4s), its shards' slot groups interleaved
SPREAD_ROUTES = ("transport_2d_ddmc_smr@blocks",)


def spread_width(sms: int, resident: int, shards: int, slice_: int) -> int:
    """The blocks of a launch's first wave that take its shards' interleaved slot
    groups (``Shards::width``), for ``shards`` slices of ``slice_`` slots: the
    card's resident blocks or the launch's blocks if fewer, less as few as make
    it prime to the shard count, so that a block's warps come from several
    shards (with a multiple of the count, block b's groups would all be shard b
    modulo the count's)."""
    blocks = -(-shards * -(-slice_ // 32) * 32 // THREADS)
    width = min(sms * resident, blocks)
    while math.gcd(width, shards) > 1:
        width -= 1
    return width


def launch_shape(slots: int, sms: int, resident: int, max_rounds: int) -> tuple:
    """(spread, grid) of a census launch over ``slots`` ledger slots on ``sms`` SMs
    that hold ``resident`` blocks each, as the C launch entry takes them. An
    instantiation that runs in rounds (csrc/transport_kernel.cuh kRounds) is
    launched on the card's resident grid where its slots take at most
    ``max_rounds`` rounds (kRoundsMax; 0 for an instantiation that does not run
    in rounds): at most sms x resident blocks, one wave, each round the next
    THREADS x blocks slots spread over them (grid is that bound; the kernel
    launches fewer blocks where the slots need fewer). A ledger keeps its live
    slots first and at least as many after them to grow into, so its live lanes
    then run in the first rounds, on every SM. A longer ledger, and any other
    instantiation, takes one thread a slot (grid 0) and spreads where its blocks
    fit on the card at once (``spreads``): in rounds, a ledger with live lanes in
    several rounds runs each round's share of them alone (measured, see the
    kernel's note)."""
    if max_rounds and -(-slots // THREADS) <= max_rounds * sms * resident:
        return 1, sms * resident
    return int(spreads(slots, sms, resident)), 0


def spreads(slots: int, sms: int, resident: int) -> bool:
    """Whether a census launch over ``slots`` ledger slots spreads them: when its
    blocks of THREADS slots all fit on the card at once (``resident`` blocks on each
    of ``sms`` SMs), each block's warps take slot groups from across the launch, so
    that live slots gathered at one end of the ledger (a ledger with room to grow
    holds them first) run on every SM, not on the SMs that happen to take the
    blocks that hold them. A launch of several waves keeps consecutive slots: a
    block of dead slots ends at once and its SM takes the next."""
    return -(-slots // THREADS) <= sms * resident


@functools.lru_cache(maxsize=None)
def _occupancy(ndim, absorb, ddmc, smr, nongray, dtype) -> tuple:
    return occupancy(ndim, absorb, ddmc, smr, nongray, dtype)


def census_counters(n: int, device) -> torch.Tensor:
    """The counters of a census call over ``n`` shards, uninitialised: the events
    (int64) and, after them, the iteration maxima (int32, in the int64 words'
    place). The table's launch zeroes them where the call launches a table
    (``_run``), the census's launch entry everywhere else."""
    return torch.empty(2 * n, dtype=torch.int64, device=device)


def _census_cuda(p, tabs: _Tables, g: _Geom, shards: tuple, max_iters: int, fold=None,
                 seeds=None, counters=None, zeroed=False, go=None):
    """The census kernel on PyTorch's current stream (no synchronisation), one
    launch for every MAX_SHARDS_PER_LAUNCH shards; the ledger was checked by
    ``_check_cuda_ledger``. With ``fold`` a uniform mesh of several blocks, the
    kernel folds ``collapse_plain`` into its reads and ``expand_plain`` into its
    writes, on every slot, so the launches must cover the whole ledger. The
    counters (``census_counters``; ``counters``, or made here) need no fill: with
    ``zeroed`` the table's launch zeroed them on the stream, else the launch
    entry zeroes each group's before its launch. The kernel reads each shard's seed
    from device memory: ``seeds``, an int32 tensor of one per shard on the
    ledger's device (a CUDA graph's launch keeps its pointer, and a replay reads
    what was copied there since), or when None the shards' own, copied there
    from pinned memory without waiting. ``go``, a 0-dim bool tensor on the
    ledger's device or None, gates every launch: the kernel reads it before any
    slot, and where it is false the call changes nothing and its counters read 0
    (``_census_plain``'s meaning)."""
    dev = p.x.device
    n = len(shards)
    if go is not None and (go.device != dev or go.dtype != torch.bool or go.numel() != 1):
        raise ValueError("transport kernel: go must be one bool on the ledger's GPU")
    if seeds is None:
        seeds = torch.tensor([sh.seed for sh in shards], dtype=torch.int32,
                             pin_memory=True).to(dev, non_blocking=True)
    elif (seeds.dtype != torch.int32 or seeds.device != dev or seeds.shape != (n,)
          or not seeds.is_contiguous()):
        raise ValueError(f"transport kernel: the seeds must be {n} contiguous int32 on {dev}")
    groups = [shards[k:k + MAX_SHARDS_PER_LAUNCH] for k in range(0, n, MAX_SHARDS_PER_LAUNCH)]
    if fold is not None and (min(sh.slot_lo for sh in shards) != 0
                             or max(sh.slot_hi for sh in shards) != p.capacity):
        raise ValueError("transport kernel: a collapsed census covers the whole ledger")
    if counters is None:
        counters = census_counters(n, dev)
    events, iters = counters[:n], counters[n:].view(torch.int32)[:n]
    cols = (p.x, p.y, p.z, p.vx, p.vy, p.vz, p.tau, p.i, p.j, p.k, p.alive, p.absorbed,
            p.face, p.block, p.energy, p.leak)
    ptrs = (ctypes.c_void_p * len(cols))(*(t.data_ptr() for t in cols))
    nrbz, nrby, nrbx = fold.root_grid if fold is not None else (1, 1, 1)
    nloc = (fold.nx, fold.ny, fold.nz) if fold is not None else (1, 1, 1)
    shifts = _block_shifts(fold, g.real) if fold is not None else (0.0, 0.0, 0.0)
    ints = (*g.n, *g.bc, int(max_iters), *g.ntiles, int(fold is not None), nrbx, nrby, *nloc)
    floats = (*g.dx, *g.inv_dx, *g.org, *g.lo, *g.hi, *g.lo_half, *g.hi_half, *g.span,
              g.dmin, g.c, g.inv_c, g.cdt, g.inv_cdt, g.tau_ddmc, g.eps_imc, g.eps_ddmc,
              g.dt, g.inv_dt, g.lam2, g.pf2_num, *g.tile, *g.nudge_cross, *g.nudge_tilt,
              *g.ng, *shifts)
    smr = (tabs.block, tabs.level, tabs.lookup) if g.smr else (None, None, None)
    cell = 0 if tabs.cell is None else tabs.cell.data_ptr()
    record = (None if tabs.cols is None
              else (ctypes.c_void_p * 4)(*(t.data_ptr() for t in tabs.cols)))
    name = launch_name(g.ndim, g.absorb, g.ddmc, g.smr, g.nongray, g.route, g.real)
    c_real = ctypes.c_double if g.real == torch.float64 else ctypes.c_float
    for k, group in enumerate(groups):
        k0 = k * MAX_SHARDS_PER_LAUNCH
        first = min(sh.slot_lo for sh in group)
        slots = max(sh.slot_hi for sh in group) - first
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        resident, rounds = _occupancy(g.ndim, g.absorb, g.ddmc, g.smr, g.nongray, g.real)
        spread, grid = launch_shape(slots, sms, resident, rounds)
        width = 0
        if (name in SPREAD_ROUTES and slots > 0
                and len({sh.slot_hi - sh.slot_lo for sh in group}) == 1):
            width = spread_width(sms, resident, len(group), slots // len(group))
        rows = [v for sh in group for v in dataclasses.astuple(sh)[:5]]
        cuda_lib.library().call(
            "jb_transport_launch" + _f64(g.real), g.ndim, int(g.absorb), int(g.ddmc),
            int(g.smr), int(g.nongray), ptrs, cell, record,
            *(0 if t is None else t.data_ptr() for t in smr),
            p.capacity, (ctypes.c_int * len(ints))(*ints),
            (c_real * len(floats))(*map(float, floats)),
            len(group), (ctypes.c_int * len(rows))(*rows), seeds[k0:].data_ptr(),
            None if go is None else go.data_ptr(), spread, grid, width,
            events[k0:].data_ptr(), iters[k0:].data_ptr(), int(zeroed),
            cuda_lib.stream_handle(dev),
        )
        if slots > 0:  # a group without slots launches nothing, its counters zeroed
            cuda_lib.LAUNCHES[name] += 1
    return iters, events


@dataclasses.dataclass(frozen=True)
class _Shard:
    """One shard of a census call, in the kernel's shard-table order: its slots
    [slot_lo, slot_hi) of the call's ledger, its owned range [own_lo, own_hi),
    the first row of that range in the cell table and its signed 32-bit K2
    seed (None where the call's seeds are a device tensor)."""

    slot_lo: int
    slot_hi: int
    own_lo: int
    own_hi: int
    row: int
    seed: int | None


@dataclasses.dataclass(frozen=True)
class Census:
    """A census set-up, built by ``prepare``: the geometry and the tables of one
    step's coefficients and the owned ranges they cover. Coefficients do not
    change within a step, so a spatial step builds it once and every round
    reuses it. The ranges' tables lie one after another: ``rows[k]`` is range k's
    first row."""

    g: _Geom
    tabs: _Tables
    owns: tuple
    rows: tuple


def _concat_coefs(coefs: list):
    """One coefficient set over several ranges: each tensor concatenated in range
    order along its block (or cell) axis."""
    first = coefs[0]
    return dataclasses.replace(first, **{
        f.name: torch.cat([getattr(c, f.name) for c in coefs])
        for f in dataclasses.fields(first) if isinstance(getattr(first, f.name), torch.Tensor)})


def prepare(coefs, mesh, prm, dt, own=None) -> Census:
    """The census set-up of one step ``dt``: with ``own`` None the whole mesh and
    its coefficients; with an ``OwnedRange`` that range and its coefficients (see
    ``OwnedRange``); with a sequence of ranges, all of one kind, a sequence of
    coefficient sets, one per range (the local shards of a spatial round). On a
    GPU the table kernel builds the cell table, on the CPU its plain version. The
    census runs at the coefficients' precision."""
    first = coefs[0] if own is not None and not isinstance(own, OwnedRange) else coefs
    return _prepare(coefs, mesh, prm, dt, own, first.sigma_s.device.type == "cuda")


def _prepare(coefs, mesh, prm, dt, own, kernel, real=None, zero=None, n=1) -> Census:
    """``prepare``'s set-up; with ``own`` None for ``n`` shards, each of which owns
    the whole mesh and reads the one table of ``coefs`` from its first row."""
    multi = own is not None and not isinstance(own, OwnedRange)
    owns = tuple(own) if multi else (whole_mesh(mesh) if own is None else own,)
    cset = list(coefs) if multi else [coefs]
    if not owns or len(cset) != len(owns) or len({o.kind for o in owns}) != 1:
        raise ValueError("transport: one coefficient set per owned range, all of one kind")
    smr = mesh.max_level > 0 or (own is not None and owns[0].kind == "blocks")
    rows, total = [], 0
    for o, c in zip(owns, cset):
        if own is not None:
            o.check(mesh)
        n_cells = mesh.total_cells if own is None else o.n_blocks(mesh) * mesh.ncells_per_block
        if any(t.shape != (n_cells,) for t in (c.sigma_a, c.sigma_s, c.fleck)):
            raise ValueError(f"transport: {n_cells} coefficients expected, one per owned cell")
        rows.append(total)
        total += n_cells
    g = _geometry(mesh, prm, dt, cset[0], smr, real)
    if own is not None:
        g = dataclasses.replace(g, route=owns[0].route)
    elif n > 1:
        owns, rows = owns * n, rows * n
    return Census(g, _tables(cset, mesh, g, kernel, zero), owns, tuple(rows))


def _run(census, particles, coefs, mesh, seed, prm, dt, own, **kw):
    multi = isinstance(particles, (list, tuple))
    ledgers = list(particles) if multi else [particles]
    seed_dev = None
    if isinstance(seed, torch.Tensor):  # one per range, on the device
        seed_dev = seed
        seeds = seed.tolist() if census is not _census_cuda else [None] * seed.numel()
    else:
        seeds = list(seed) if multi else [seed]
    p, slices = join_slices(ledgers)
    check_supported(mesh, prm, p.x.dtype)
    if isinstance(coefs, Census):
        if own is not None:
            raise ValueError("transport: a prepared census carries its owned ranges")
        setup = coefs
    elif census is _census_cuda:
        # the census's counters, made first so that the table's launch zeroes them,
        # and the shards' seeds copied first, so that the census launch follows the
        # table's with nothing queued between them
        kw["counters"] = census_counters(len(ledgers), p.x.device)
        if seed_dev is None:
            kw["seeds"] = torch.tensor(seeds, dtype=torch.int32, pin_memory=True).to(
                p.x.device, non_blocking=True)
        setup = _prepare(coefs, mesh, prm, dt, own, True, p.x.dtype, kw["counters"],
                         len(ledgers))
        kw["zeroed"] = setup.tabs.cell is not None
    else:
        setup = _prepare(coefs, mesh, prm, dt, own, False, p.x.dtype, n=len(ledgers))
    if not (len(ledgers) == len(seeds) == len(setup.owns)):
        raise ValueError("transport: one ledger and one seed per owned range")
    if p.x.dtype != setup.g.real:
        raise ValueError(f"transport: a {p.x.dtype} ledger and {setup.g.real} coefficients")
    if census is _census_cuda:
        _check_cuda_ledger(p, setup.tabs, setup.g.real)
    shards = tuple(_Shard(lo, hi, *o.bounds(), row, None if sd is None else int(sd))
                   for (lo, hi), o, row, sd in zip(slices, setup.owns, setup.rows, seeds))
    # a uniform forest of several blocks runs collapsed to one; a forest run block
    # by block (SMR) stays as it is
    fold = mesh if mesh.n_blocks > 1 and not setup.g.smr else None
    if seed_dev is not None and census is _census_cuda:
        kw["seeds"] = seed_dev
    iters, events = census(p, setup.tabs, setup.g, shards, prm.max_iters, fold, **kw)
    if multi:
        return particles, iters, events
    return particles, iters[0], events[0]


def transport(particles, coefs, mesh, seed, prm, dt, own=None, go=None):
    """Census transport of ``particles`` (updated in place) over one step ``dt``:
    the CUDA kernel for a ledger on a GPU, the plain version for one on the CPU.
    ``seed`` is the step's signed 32-bit K2 seed, or an int32 tensor of one seed
    per range on the ledger's device, which the kernel reads there (the step's
    seeds, which a CUDA graph's replay rewrites). With ``own`` an ``OwnedRange``
    the call is one round of the spatial decomposition: only the range's lanes
    run, each until it leaves the range, and ``coefs`` are the range's. With
    ``own`` a sequence of ranges, ``particles``, ``coefs`` and ``seed`` are
    sequences too, one per range: the local shards' ledgers, which must be
    adjacent slices of one ledger, and one launch runs them all; a lane is its
    slot's index in its own shard's ledger. With ``own`` None and a sequence of
    ledgers (the particle decomposition's local shards, adjacent slices of one
    ledger) and of seeds, every shard owns the whole mesh and reads the one
    table of ``coefs``: one launch, bitwise the calls shard by shard where their
    coefficients are the same. ``coefs`` may also be a ``Census``
    from ``prepare`` (``own`` None), reused across calls. Returns ``(particles,
    iterations, events)``, the last two per range ([n] tensors) with a sequence
    of ledgers. ``go``, a 0-dim bool tensor on the ledger's device, gates a
    spatial round: where it is false the call changes no slot and counts nothing
    (the kernel reads it on the device; no host read)."""
    p = particles[0] if isinstance(particles, (list, tuple)) else particles
    dev = p.x.device.type
    if dev == "cuda":
        return _run(_census_cuda, particles, coefs, mesh, seed, prm, dt, own, go=go)
    if dev == "cpu":
        return _run(_census_plain, particles, coefs, mesh, seed, prm, dt, own, go=go)
    raise ValueError(f"transport: unsupported device {p.x.device}")


def transport_plain(particles, coefs, mesh, seed, prm, dt, own=None, lane_events=None,
                    go=None):
    """The plain PyTorch version of ``transport`` on any device. ``lane_events``, an
    int32 tensor as long as the (joined) ledger, receives each slot's events."""
    return _run(_census_plain, particles, coefs, mesh, seed, prm, dt, own,
                lane_events=lane_events, go=go)


def warp_efficiency(lane_events, width: int = 32) -> float:
    """The share of issued lane-events that are real when each group of ``width``
    consecutive slots runs until its longest lane ends (one thread per slot in
    slot order): sum of the events over ``width`` times the sum of each group's
    largest count."""
    ev = lane_events.to(torch.int64)
    pad = (-ev.numel()) % width
    groups = torch.cat([ev, ev.new_zeros(pad)]).reshape(-1, width)
    issued = int(groups.max(dim=1).values.sum()) * width
    return float(int(ev.sum()) / issued) if issued else 1.0


def subface_resample(p, faces, mesh, c, gen, offset, n_local, go=None):
    """The coarse-to-fine subface resample of the DDMC particles that arrived by
    migration with a pending leak code (IN PLACE; port of
    ``jaybenne_tpu/parallel/spatial.py::_fixup_subface_arrivals`` through
    ``ops/transport.py::_ddmc_subface_resample``): each live particle in the
    blocks [offset, offset + n_local) with ``leak != 0`` is re-seated on one of
    the fine faces around its coarse landing point, picked by the shard's own
    face probabilities ``faces`` = (px, py, pz) of its [n_local, ...] blocks, with
    a hemisphere direction into the block, and its code is cleared. ``gen`` draws
    five uniforms per slot (``rng.PHASE_FIXUP``) every round, whether or not a
    slot needs them: the round's generator is its own, so no other stream moves,
    and the resample, masked by ``need``, changes only the slots that need it. It
    runs between rounds and does not wait for the device. With ``go`` (a 0-dim bool
    tensor) false no slot needs it."""
    nd = mesh.ndim
    if nd < 2:
        return p
    need = p.alive & (p.leak != 0) & (p.block >= offset) & (p.block < offset + n_local)
    if go is not None:
        need = need & go
    from . import rng

    real = p.x.dtype
    dev = p.x.device
    u = rng.uniform(gen, (5, p.capacity), real, dev)
    mu = torch.sqrt(u[3])
    nu = torch.sqrt(torch.clamp_min(1.0 - mu * mu, 0.0))
    phi = (2.0 * np.pi) * u[4]
    hemi = (mu, nu * torch.cos(phi), nu * torch.sin(phi))
    b_loc = torch.clamp(p.block - offset, 0, n_local - 1).long()
    ndx = [mesh.block_dx[p.block.long(), a].to(real) for a in range(nd)]
    nx, ny, nz = mesh.nx, mesh.ny, mesh.nz
    pairs = _face_pairs(*faces, mesh)

    def face_prob(ax, upper, ijk):
        i, j, k = (ijk + [torch.zeros_like(ijk[0])] * 3)[:3]
        cell = ((b_loc * nz + k.long()) * ny + j.long()) * nx + i.long()
        return torch.where(upper, pairs[2 * ax + 1][cell], pairs[2 * ax][cell]).to(real)

    loc = [p.x, p.y, p.z][:nd]
    idx = [p.i, p.j, p.k][:nd]
    vel = [p.vx, p.vy, p.vz]
    zero = torch.zeros((), dtype=real, device=dev)
    loc, idx, vel = _subface_pick(nd, (nx, ny, nz), need, p.leak, list(loc), list(idx), ndx,
                                  list(vel), face_prob, u[0], [u[1], u[2]][: nd - 1], hemi,
                                  device_const(c, real, dev), zero,
                                  device_const(limits(real)[1], real, dev))
    for dst, src in zip([p.x, p.y, p.z][:nd] + [p.i, p.j, p.k][:nd] + [p.vx, p.vy, p.vz],
                        loc + idx + vel):
        dst.copy_(src)
    p.leak.copy_(torch.where(need, 0, p.leak))
    return p
