"""Fixed-capacity SoA photon ledger (port of ``jaybenne_tpu/particles.py``).

One flat struct-of-arrays ledger with an ``alive`` mask. Positions are local to the
owning block, ``tau`` is the time within the current step in units of dt (census is
``tau >= 1``), and cell identity is tracked by the integers ``(block, i, j, k)``.

Dtypes: the run's precision (f32, or f64 with ``precision = f64``) for positions,
velocities, ``tau``, ``weight`` and ``energy``; int32
for ``block``, ``i``, ``j``, ``k`` and ``face``; ``torch.bool`` for ``alive`` and
``absorbed``; int32 ``leak``, the pending coarse-to-fine DDMC leak code of the spatial
decomposition (zero-filled when a constructor leaves it out).

Capacity is whatever the caller asks for: the census kernel runs one thread per
slot and needs no tile multiple.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch


@dataclasses.dataclass
class ParticleLedger:
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    tau: torch.Tensor
    weight: torch.Tensor
    energy: torch.Tensor
    block: torch.Tensor
    i: torch.Tensor
    j: torch.Tensor
    k: torch.Tensor
    alive: torch.Tensor
    # absorbed-this-step flag (absorption clears ``alive`` and sets this)
    absorbed: torch.Tensor
    # face-arrival code for the DDMC albedo test: +-(axis+1) after an IMC crossing
    face: torch.Tensor
    # spatial decomposition: +-(axis+1) when a DDMC leak landed in a finer block that
    # another shard owns, for that shard to resample onto a fine face; else 0
    leak: torch.Tensor | None = None

    def __post_init__(self):
        if self.leak is None:
            self.leak = torch.zeros_like(self.face)

    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    def num_alive(self) -> torch.Tensor:
        return self.alive.sum(dtype=torch.int32)

    def global_position(self, mesh):
        """Physical (x, y, z) of each particle (block origin + local offset)."""
        org = mesh.block_origin[self.block.long()]
        return org[:, 0] + self.x, org[:, 1] + self.y, org[:, 2] + self.z

    def clone(self) -> "ParticleLedger":
        return ParticleLedger(
            **{f.name: getattr(self, f.name).clone() for f in dataclasses.fields(self)}
        )


def join_slices(ledgers) -> tuple:
    """One ledger over ``ledgers``, which must be adjacent slices of one ledger in
    order (the local shards' views of a process's ledger), and each slice's [lo,
    hi) in it: ``(ledger, ((lo, hi), ...))``. The joined columns are views, so
    updates through it reach every slice. One ledger is returned as it is."""
    bounds, lo = [], 0
    for p in ledgers:
        bounds.append((lo, lo + p.capacity))
        lo += p.capacity
    if len(ledgers) == 1:
        return ledgers[0], tuple(bounds)
    cols = {}
    for f in dataclasses.fields(ParticleLedger):
        ts = [getattr(p, f.name) for p in ledgers]
        t0 = ts[0]
        for t, (start, _) in zip(ts, bounds):
            if (t.device != t0.device or t.dtype != t0.dtype or t.dim() != 1
                    or t.stride() != (1,) or t.untyped_storage().data_ptr()
                    != t0.untyped_storage().data_ptr()
                    or t.storage_offset() != t0.storage_offset() + start):
                raise ValueError("join_slices: the ledgers are not adjacent slices of one "
                                 f"ledger ({f.name})")
        cols[f.name] = t0.as_strided((lo,), (1,), t0.storage_offset())
    return ParticleLedger(**cols), tuple(bounds)


def insert_particles(ledger: ParticleLedger, cand: dict, valid: torch.Tensor,
                     reserved: torch.Tensor | None = None, plain: bool = False):
    """Write candidate particles into the ledger's dead slots, IN PLACE (port of
    ``jaybenne_tpu/particles.py::insert_particles``, shape for shape).

    ``cand`` maps field name -> candidate tensor (of ``valid``'s shape, any
    strides); ``valid`` masks real candidates (bool, or integers: nonzero). The
    r-th valid candidate in flat index order goes to the r-th dead slot in slot
    order. Returns ``(ledger, n_dropped)``, where dropped candidates exceeded the
    free-slot count; ``n_dropped`` is a 0-dim int64 device tensor. Every
    destination slot is distinct, so the writes are deterministic on any device.

    No shape depends on the data, so nothing waits for the device: on a GPU one
    pass of the insert kernel (``csrc/insert_kernel.cu``: the destinations from
    its scans of the free slots and the valid candidates, then every column), on
    the CPU (or with ``plain``) its plain version, ``insert_destinations`` and
    ``write_columns``.

    ``reserved`` marks dead rows that must not be recycled yet: the spatial census
    inserts migration arrivals mid-step, while this step's absorbed rows still carry
    the weight that the absorption tally deposits after the census.
    """
    if ledger.alive.is_cuda and not plain:
        return ledger, _insert_cuda(ledger, cand, valid, reserved, 1)[0]
    if ledger.alive.device.type != "cpu" and not plain:
        raise ValueError(f"insert_particles: unsupported device {ledger.alive.device}")
    if valid.dtype != torch.bool:
        valid = valid != 0
    dest, n_dropped = insert_destinations(ledger, valid, reserved)
    write_columns(ledger, cand, dest)
    return ledger, n_dropped


def insert_arrivals(ledgers, cand: dict, valid: torch.Tensor, plain: bool = False):
    """A migration round's arrivals into the local shards' ledgers (IN PLACE):
    ``cand``'s and ``valid``'s one axis is ``len(ledgers)`` equal parts, part s
    inserted (``insert_particles``) into ``ledgers[s]`` with its absorbed rows
    reserved. Returns each shard's dropped count, an int64 tensor of one a
    shard. On a GPU the ledgers must be adjacent slices of one ledger
    (``join_slices``), and one pass of the insert kernel scans and writes every
    shard's slice; on the CPU (or with ``plain``) a shard at a time."""
    m = len(ledgers)
    if valid.dim() != 1 or valid.shape[0] % m:
        raise ValueError(f"insert_arrivals: {tuple(valid.shape)} candidates for {m} shards")
    if ledgers[0].alive.is_cuda and not plain:
        joined, _ = join_slices(ledgers)
        return _insert_cuda(joined, cand, valid, joined.absorbed, m)
    nc = valid.shape[0] // m
    return torch.stack([
        insert_particles(p, {k: v[s * nc:(s + 1) * nc] for k, v in cand.items()},
                         valid[s * nc:(s + 1) * nc], reserved=p.absorbed, plain=plain)[1]
        for s, p in enumerate(ledgers)])


def insert_destinations(ledger: ParticleLedger, valid: torch.Tensor,
                        reserved: torch.Tensor | None = None) -> tuple:
    """``insert_particles``'s destination of each candidate (the ledger's capacity
    for one not written) and the count of valid candidates dropped: the plain
    version of the insert kernel's scans. The r-th valid candidate's rank comes
    from a prefix sum of the valid flags, the r-th free slot from one of the free
    flags (each free slot put at its rank), with no sort: the map of the JAX
    package's stable free-first argsort."""
    cap = ledger.capacity
    vflat = valid.reshape(-1)
    rank = torch.cumsum(vflat.to(torch.int64), 0) - 1
    occupied = ledger.alive if reserved is None else ledger.alive | reserved
    free = ~occupied
    free_rank = torch.cumsum(free.to(torch.int64), 0) - 1
    n_free = free.sum()
    order = torch.full((cap + 1,), cap, dtype=torch.int64, device=vflat.device)
    slots = torch.arange(cap, dtype=torch.int64, device=vflat.device)
    _put(order[:cap], torch.where(free, free_rank, cap), slots)  # the r-th free slot
    ok = vflat & (rank < n_free)
    n_dropped = vflat.sum() - ok.sum()
    dest = torch.where(ok, order[rank.clamp(0, cap)], cap)  # cap -> dropped
    return dest, n_dropped


def write_columns(ledger: ParticleLedger, cand: dict, dest: torch.Tensor) -> None:
    """``insert_particles``'s writes, the plain version (IN PLACE): each candidate
    column of ``cand`` and the fills (``alive``; ``absorbed``, ``face`` and
    ``leak`` unless ``cand`` has them) at ``dest``, the capacity dropped."""
    for col, val in _columns(ledger, cand):
        _put(col, dest, val.reshape(-1) if isinstance(val, torch.Tensor) else val)


def _columns(ledger: ParticleLedger, cand: dict) -> list:
    """(ledger column, candidate tensor or fill value) pairs of an insert."""
    cols = [(getattr(ledger, name), val) for name, val in cand.items()]
    cols.append((ledger.alive, True))
    cols += [(getattr(ledger, name), fill) for name, fill in
             (("absorbed", False), ("face", 0), ("leak", 0)) if name not in cand]
    return cols


def _put(col: torch.Tensor, dest: torch.Tensor, val) -> None:
    """``col[dest] = val`` IN PLACE, the writes to index ``col.shape[0]`` dropped:
    the column is extended by one dump slot, written, and copied back. The plain
    version of the insert kernel's writes, a column at a time."""
    ext = torch.cat([col, col[:1]])
    if isinstance(val, torch.Tensor):
        ext.index_put_((dest,), val.to(col.dtype))
    else:
        ext.index_fill_(0, dest, val)
    col.copy_(ext[:-1])


# candidates or slots a tile of the insert kernel's scans (csrc/insert_kernel.cu,
# kTile)
INSERT_TILE = 2048


def _insert_cuda(ledger: ParticleLedger, cand: dict, valid: torch.Tensor,
                 reserved: torch.Tensor | None, m: int) -> torch.Tensor:
    """One pass of the insert kernel on PyTorch's current stream, without waiting
    for it: the ledger's ``m`` equal slices each take their part of the
    candidates (``valid``'s flat axis in ``m`` equal parts). Returns the dropped
    count of each part, ``m`` int64 on the device. Raises unless the ledger's
    columns are contiguous on one GPU with the candidates."""
    from .ops import cuda_lib

    dev = ledger.alive.device
    cols = _columns(ledger, cand)
    shape = tuple(valid.shape)
    rows, k = shape if len(shape) == 2 else (valid.numel(), 1)
    vflat = valid.reshape(-1)
    n = vflat.numel()
    if ledger.capacity % m or n % m:
        raise ValueError(f"insert kernel: {ledger.capacity} slots and {n} candidates in "
                         f"{m} shards")
    flags = [ledger.alive] + ([] if reserved is None else [reserved])
    if (vflat.device != dev or vflat.dtype not in (torch.bool, torch.int32)
            or any(t.device != dev or t.dtype != torch.bool or t.shape != (ledger.capacity,)
                   or not t.is_contiguous() for t in flags)):
        raise ValueError("insert kernel: bool alive and reserved columns and bool or int32 "
                         "valid flags on one GPU")
    dst, src, strides, widths, fills, keep = [], [], [], [], [], []
    for col, val in cols:
        if col.device != dev or col.dim() != 1 or not col.is_contiguous():
            raise ValueError("insert kernel: ledger columns must be contiguous on one GPU")
        dst.append(col.data_ptr())
        widths.append(col.element_size())
        if isinstance(val, torch.Tensor):
            v = val.to(col.dtype).reshape(rows, k)
            if v.device != dev:
                raise ValueError("insert kernel: candidates must lie on the ledger's GPU")
            keep.append(v)
            src.append(v.data_ptr())
            strides += [st * v.element_size() for st in v.stride()]
            fills.append(0)
        else:
            src.append(None)
            strides += [0, 0]
            fills.append(int(val))
    cap_l, nc = ledger.capacity // m, n // m
    tiles = -(-cap_l // INSERT_TILE) + -(-nc // INSERT_TILE)
    scratch = torch.empty(m * tiles + 2 * n + m, dtype=torch.int32, device=dev)
    dropped = (torch.empty if nc else torch.zeros)(m, dtype=torch.int64, device=dev)
    nk = len(cols)
    cuda_lib.library().call(
        "jb_insert_launch", nk, (ctypes.c_void_p * nk)(*dst), (ctypes.c_void_p * nk)(*src),
        (ctypes.c_longlong * (2 * nk))(*strides), (ctypes.c_int * nk)(*widths),
        (ctypes.c_ulonglong * nk)(*fills), k, ledger.alive.data_ptr(),
        None if reserved is None else reserved.data_ptr(), vflat.data_ptr(),
        vflat.stride(0) * vflat.element_size(), vflat.element_size(), m, cap_l, nc,
        scratch.data_ptr(), dropped.data_ptr(), cuda_lib.stream_handle(dev))
    if nc:
        cuda_lib.LAUNCHES["ledger_insert"] += 3  # counts, lists, writes
    return dropped


def empty_ledger(capacity: int, dtype=torch.float32, device="cpu") -> ParticleLedger:
    def f():
        return torch.zeros((capacity,), dtype=dtype, device=device)

    def i():
        return torch.zeros((capacity,), dtype=torch.int32, device=device)

    def b():
        return torch.zeros((capacity,), dtype=torch.bool, device=device)

    return ParticleLedger(
        x=f(), y=f(), z=f(), vx=f(), vy=f(), vz=f(),
        tau=f(), weight=f(), energy=f(),
        block=i(), i=i(), j=i(), k=i(),
        alive=b(), absorbed=b(), face=i(), leak=i(),
    )


def uniform_ledger(mesh, n: int, generator: torch.Generator, c: float,
                   dtype=torch.float32) -> ParticleLedger:
    """A ledger of ``n`` live particles of unit weight at uniform positions over a
    uniform (single-level) mesh, with isotropic directions at speed ``c``, drawn
    from ``generator`` on its device, its floats of ``dtype``. For kernel checks
    and timings."""
    dev = generator.device
    p = empty_ledger(n, dtype, dev)
    nloc = (mesh.nx, mesh.ny, mesh.nz)
    nrb = mesh.root_grid[::-1]
    b = mesh.bounds
    blocks = []
    for a, (pos, idx) in enumerate((("x", "i"), ("y", "j"), ("z", "k"))):
        cells = nloc[a] * nrb[a]
        gc = torch.randint(0, cells, (n,), generator=generator, device=dev, dtype=torch.int32)
        blk = torch.div(gc, nloc[a], rounding_mode="floor")
        getattr(p, idx).copy_(gc - blk * nloc[a])
        if a < mesh.ndim:
            dx = (b[2 * a + 1] - b[2 * a]) / cells
            u = torch.rand(n, generator=generator, device=dev, dtype=dtype)
            getattr(p, pos).copy_((getattr(p, idx).to(dtype) + u) * dx)
        blocks.append(blk)
    p.block.copy_((blocks[2] * nrb[1] + blocks[1]) * nrb[0] + blocks[0])
    return _isotropic(p, generator, c)


def forest_ledger(mesh, n: int, generator: torch.Generator, c: float,
                  blocks: tuple | None = None, dtype=torch.float32) -> ParticleLedger:
    """The counterpart of ``uniform_ledger`` on any block forest, refined or not:
    each particle in a cell drawn uniformly from all the forest's cells (so a fine
    block holds as many as a coarse one), or from those of the blocks ``blocks`` =
    (lo, hi), at a uniform position in it, ``block`` set, its floats of ``dtype``.
    For kernel checks and timings."""
    dev = generator.device
    p = empty_ledger(n, dtype, dev)
    lo, hi = (0, mesh.n_blocks) if blocks is None else blocks
    ncpb = mesh.ncells_per_block
    cell = torch.randint(lo * ncpb, hi * ncpb, (n,), generator=generator, device=dev)
    blk = torch.div(cell, mesh.ncells_per_block, rounding_mode="floor")
    rem = cell - blk * mesh.ncells_per_block
    p.block.copy_(blk)
    p.i.copy_(rem % mesh.nx)
    p.j.copy_(torch.div(rem, mesh.nx, rounding_mode="floor") % mesh.ny)
    p.k.copy_(torch.div(rem, mesh.nx * mesh.ny, rounding_mode="floor"))
    dx = mesh.block_dx.to(device=dev, dtype=dtype)[blk]
    for a, (pos, idx) in enumerate((("x", "i"), ("y", "j"), ("z", "k"))[: mesh.ndim]):
        u = torch.rand(n, generator=generator, device=dev, dtype=dtype)
        getattr(p, pos).copy_((getattr(p, idx).to(dtype) + u) * dx[:, a])
    return _isotropic(p, generator, c)


def _isotropic(p: ParticleLedger, generator: torch.Generator, c: float) -> ParticleLedger:
    """Isotropic directions at speed ``c``, every slot alive with unit weight."""
    n, dev, dt = p.capacity, generator.device, p.x.dtype
    mu = 1.0 - 2.0 * torch.rand(n, generator=generator, device=dev, dtype=dt)
    phi = (2.0 * math.pi) * torch.rand(n, generator=generator, device=dev, dtype=dt)
    st = torch.sqrt(torch.clamp_min(1.0 - mu * mu, 0.0))
    p.vx.copy_(c * st * torch.cos(phi))
    p.vy.copy_(c * st * torch.sin(phi))
    p.vz.copy_(c * mu)
    p.alive.fill_(True)
    p.weight.fill_(1.0)
    return p


def place_on_faces(p: ParticleLedger, mesh, select: torch.Tensor,
                   generator: torch.Generator) -> ParticleLedger:
    """Move the ``select``-ed particles of a ledger onto a face of their cell as an
    IMC crossing leaves them (IN PLACE): each on its lower or upper face along a
    random active axis with probability 1/2, flying into the cell, with the
    face-arrival code +-(axis + 1) that the DDMC albedo test reads. On a refined
    forest each particle takes its own block's cell size. For kernel checks."""
    dev = p.x.device
    n = p.capacity
    axis = torch.randint(0, mesh.ndim, (n,), generator=generator, device=dev)
    lower = torch.rand(n, generator=generator, device=dev) < 0.5
    b = mesh.bounds
    nrb = mesh.root_grid[::-1]
    nloc = (mesh.nx, mesh.ny, mesh.nz)
    for a, (pos, idx, vel) in enumerate((("x", "i", "vx"), ("y", "j", "vy"),
                                        ("z", "k", "vz"))[: mesh.ndim]):
        m = select & (axis == a)
        if mesh.max_level > 0:
            dx = mesh.block_dx.to(device=dev, dtype=p.x.dtype)[p.block.long(), a]
        else:
            dx = (b[2 * a + 1] - b[2 * a]) / (nloc[a] * nrb[a])
        cell = getattr(p, idx).to(p.x.dtype)
        face = torch.where(lower, cell, cell + 1.0) * dx
        getattr(p, pos).copy_(torch.where(m, face, getattr(p, pos)))
        v = getattr(p, vel).abs()
        getattr(p, vel).copy_(torch.where(m, torch.where(lower, v, -v), getattr(p, vel)))
        p.face.copy_(torch.where(m, torch.where(lower, a + 1, -(a + 1)), p.face).to(torch.int32))
    return p
