"""The spatial (block) decomposition with particle migration (port of
``jaybenne_tpu/parallel/spatial.py``).

Blocks are assigned contiguously to the shards, ``Bl = ceil(B / n)`` each (the
last shard may own padding blocks, which cover no volume and source nothing), and
each shard holds only its blocks' fields and the particles in them. A step's
census is the reference's iterative task list (``jaybenne.cpp:113-131``):

    until the summed unfinished count is 0 or max_migration_rounds is reached:
        subface fixup of DDMC arrivals -> local census -> all_to_all migration

The local census is one call of the census kernel over every local shard, each
with its owned range (``transport_kernel.OwnedRange``): on a uniform IMC mesh
whose shards own whole z planes of blocks the range is the shard's global z
cells (the JAX package's K3s, ``pallas_grid.py::make_spatial_grid``), on every
other mesh the shard's blocks (K4s, ``pallas_bucketed.py::make_spatial_transport``).
The local shards' ledgers are adjacent slices of the process's ledger, so one
launch runs them all; its tables are built once a step (``transport_kernel.
prepare``), since the coefficients do not change within one. A lane runs until
census, absorption, exit, or the event that takes it out of its shard's range,
where it pauses; migration then ships it to its owner.

Block metadata (origins, sizes, levels, the lookup grid) stays whole on every
shard, so a shard computes the whole block transition of a leaving particle. The
one field exchange is that of the DDMC face probabilities: each shard
all-gathers the blocks' boundary-surface sigma_t (``fleck.pack_boundary_surface``).

Migration sends fixed ``[n, K]`` buffers: a sent particle past K stays in transit
and rides the next round; a received one that finds no free slot is dropped and
counted (the driver warns). A DDMC leak into a finer block of another shard
carries its pending-leak code, and the owner resamples it onto a fine face before
its next census (``transport_kernel.subface_resample``).

The rounds run in batches (of ``ROUNDS_PER_BATCH`` where the step runs as CUDA
graphs, else of one round), and a batch reads the device once, for its exit
test: the summed count of live particles short of census. A round that begins
with that count at 0 changes nothing, so the batches repeat the step of one
round a batch. On a GPU, where the step is capturable, the next batch is queued
before the host waits for that read (``step.ahead``), each batch's count copied
to a pinned slot of its own, so the card does not idle through it; the JAX
package's ``lax.while_loop`` (``jaybenne_tpu/parallel/spatial.py:494``) has no
host in the loop at all. Every other counter stays on the device until the
step's ``StepStats``, which the driver reads in one copy. No shape depends on
the data (the insert of the arrivals is the static one of ``particles.py``), so
nothing else in a step waits for the device, and on a GPU the step's head, a
batch and its tail are each a CUDA graph (``graph.GraphedSpatialStep``), as the
JAX package runs its rounds in a ``lax.while_loop``.

At restart, ``rehome_restart_ledger`` moves each live particle that a checkpoint
left in another shard's ledger slice into a free slot of its owner's.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses

import torch
from torch.profiler import record_function

from ..config import InitialRadiation, RunConfig
from ..ops import counts
from ..ops import fleck as fleck_ops
from ..ops import rng, sourcing, tally
from ..ops import transport as transport_ops
from ..ops import transport_kernel
from ..particles import insert_arrivals, join_slices
from ..step import (StepStats, census_fn, make_transport_params, total_sigma, with_faces,
                    with_fleck)
from .exchange import InProcess

# particle fields shipped during migration, sent as int32 words: one for a 4-byte
# column, two for a float64 one (precision = f64), as the JAX package packs them
# (jaybenne_tpu/parallel/spatial.py:100, pallas_grid._pack_cols)
MIGRATE_FIELDS = ("x", "y", "z", "vx", "vy", "vz", "tau", "weight", "energy",
                  "block", "i", "j", "k", "face", "leak")


# rounds a batch runs before its one host read where the step runs as CUDA
# graphs (``build_spatial_step_core``'s default on a GPU). Chosen on one H100
# (NVIDIA H100 80GB HBM3, 700.00 W; ``census_bench.py --only round``: the step as
# CUDA graphs by ``profile.py --rounds-per-batch``, 4 and 8 in turns, 4, 8, 8, 4
# twice over, 7 profiled steps each). A round with nothing to do is now an
# early-exit census launch, a migration and an insert that write nothing and one
# count launch, yet 8 rounds a batch gave no shorter step than 4: the 8-shard
# big_mesh_spatial step's wall medians 44.6-49.3 ms at 8 against 45.2-47.9 at 4
# (device 39.65-39.78 ms against 39.61-39.80, 89.1 rounds queued a step against
# 87.4), the float64 stepdiff's at 8 shards 33.2-35.7 against 31.8-33.9. An eager
# step gains nothing from a batch but the read it saves, and pays each no-op
# round in full: it runs one round a batch
ROUNDS_PER_BATCH = 4


def _words(t):
    """A column as [capacity, w] int32 words (w = its itemsize / 4)."""
    return t.view(torch.int32).reshape(t.shape[0], -1)

# matter fields whose padding blocks hold 1, not 0, so that the pointwise EOS and
# Fleck factor stay finite there
PAD_ONES = ("rho", "sie", "u")


def blocks_per_shard(mesh, n: int) -> int:
    return -(-mesh.n_blocks // n)


def misplaced(p, mesh, n: int) -> tuple:
    """The live slots of a ledger of ``n`` equal shard slices (``sharding.
    split_ledger``) whose block another shard owns, and each slot's owner."""
    if p.capacity % n:
        raise ValueError(f"ledger capacity {p.capacity} is not a multiple of {n} shards")
    cap_l = p.capacity // n
    owner = torch.clamp(p.block.long() // blocks_per_shard(mesh, n), 0, n - 1)
    slot_shard = torch.arange(p.capacity, device=p.block.device) // cap_l
    return p.alive & (owner != slot_shard), owner


def rehome_restart_ledger(p, mesh, n: int):
    """The ledger with every misplaced live particle (``misplaced``) moved into a
    free slot of its owner's slice, in slot order (JAX ``rehome_restart_ledger``).
    A checkpoint written at any shard count then resumes at any other: a particle
    left in another shard's slice would otherwise wait for migration, or be
    stranded where every real block is on one shard. Every other slot stays
    byte-identical, since a slot keys its random streams: at the writing run's
    shard count nothing moves and the resume is bitwise. Raises when a slice has
    too few free slots."""
    move, owner = misplaced(p, mesh, n)
    if not bool(move.any()):
        return p
    cap_l = p.capacity // n
    out = p.clone()
    out.alive[move] = False  # the vacated slots become free
    free = ~p.alive | move
    for s in range(n):
        src = torch.nonzero(move & (owner == s)).flatten()
        if src.numel() == 0:
            continue
        dst = torch.nonzero(free[s * cap_l:(s + 1) * cap_l]).flatten() + s * cap_l
        if src.numel() > dst.numel():
            raise ValueError(f"restart re-homing: shard {s} owns {src.numel()} relocated "
                             f"particles but its ledger slice has only {dst.numel()} free "
                             "slots; raise jaybenne/capacity_factor")
        dst = dst[:src.numel()]
        for f in dataclasses.fields(p):
            getattr(out, f.name)[dst] = getattr(p, f.name)[src]
    return out


def pad_field_blocks(fields, mesh, n: int):
    """Every field's block axis padded from ``B`` to ``n * ceil(B / n)``, the
    padding blocks holding ``rho = sie = u = 1`` and zeros elsewhere."""
    n_pad = n * blocks_per_shard(mesh, n) - mesh.n_blocks
    if n_pad == 0:
        return fields

    def pad(name, arr):
        fill = 1.0 if name in PAD_ONES else 0.0
        return torch.cat([arr, arr.new_full((n_pad,) + arr.shape[1:], fill)])

    return dataclasses.replace(fields, **{f.name: pad(f.name, getattr(fields, f.name))
                                          for f in dataclasses.fields(fields)})


def shard_fields(padded, mesh, n: int, shard: int):
    """Shard ``shard``'s [Bl, ...] slice of the padded fields."""
    bl = blocks_per_shard(mesh, n)
    return dataclasses.replace(padded, **{
        f.name: getattr(padded, f.name)[shard * bl:(shard + 1) * bl].clone()
        for f in dataclasses.fields(padded)})


def gather_fields(fields_list, mesh):
    """The whole mesh's fields from the shards' slices, padding dropped."""
    first = fields_list[0]
    return dataclasses.replace(first, **{
        f.name: torch.cat([getattr(fl, f.name) for fl in fields_list])[:mesh.n_blocks]
        for f in dataclasses.fields(first)})


def owned_range(mesh, prm, n: int, shard: int) -> transport_kernel.OwnedRange:
    """The census route of one shard: its global z cells (K3s) on a uniform IMC
    mesh whose shards own whole z planes of blocks (``pallas_grid.py:1925-1940``),
    else its blocks (K4s)."""
    nrbz, nrby, nrbx = mesh.root_grid
    B = mesh.n_blocks
    bl = blocks_per_shard(mesh, n)
    if mesh.max_level == 0 and not prm.use_ddmc and B % n == 0 and bl % (nrbx * nrby) == 0:
        kz = bl // (nrbx * nrby) * mesh.nz
        return transport_kernel.OwnedRange("z", shard * kz, kz)
    return transport_kernel.OwnedRange("blocks", shard * bl, bl)


def row_words(ledger) -> int:
    """The int32 words of a migration row of ``ledger``: each MIGRATE_FIELDS
    column's (one for a 4-byte column, two for a float64 one), a zero pad word
    where a float64 row would have an odd count (an even count holds the float64
    values on 8-byte boundaries, so the receiver reads them in place), and the
    valid word last."""
    used = sum(getattr(ledger, name).element_size() // 4 for name in MIGRATE_FIELDS) + 1
    return used + (used % 2 if ledger.x.element_size() == 8 else 0)


def migration_map(p, offset, bl, n, K, go=None) -> tuple:
    """The plain version's map of one shard's round (JAX ``migrate``'s): the live
    particles whose block lies outside [offset, offset + bl) are grouped by
    destination shard with a stable sort. Returns (src, sent): the source slot of
    each of the [n K] buffer rows (the capacity for a row that no slot takes),
    and the slots sent, the first K for each destination."""
    cap, dev = p.capacity, p.x.device
    in_transit = p.alive & ((p.block < offset) | (p.block >= offset + bl))
    if go is not None:
        in_transit = in_transit & go
    dest = torch.where(in_transit, torch.clamp(p.block // bl, 0, n - 1), n).to(torch.int64)
    order = torch.argsort(dest, stable=True)
    sdest = dest[order]
    first = torch.searchsorted(sdest, torch.arange(n + 1, device=dev))
    rank = torch.arange(cap, device=dev) - first[sdest]
    ok = (sdest < n) & (rank < K)
    slot = torch.where(ok, sdest * K + rank, n * K)
    src = torch.full((n * K + 1,), cap, dtype=torch.int64, device=dev)
    src[slot] = order  # every ok slot distinct; the rest land on the dump slot
    # ok scattered back through the permutation order: each slot once
    sent = torch.zeros(cap, dtype=torch.bool, device=dev).scatter_(0, order, ok)
    return src[: n * K], sent


def pack_plain(ledgers, offsets, bl, K, n, go=None) -> tuple:
    """The migration's sort and pack, the plain version (IN PLACE: the sent slots
    leave ``alive``), a shard at a time (``migration_map``): each local shard's
    [n, K, row_words] int32 buffer of rows, every column's words then the valid
    word (a row that no slot takes all zeros), and its sent count. Returns
    (buffers, sent), one int64 a local shard."""
    bufs, sent_counts = [], []
    for p, offset in zip(ledgers, offsets):
        src, sent = migration_map(p, offset, bl, n, K, go)
        cols = [_words(getattr(p, name)) for name in MIGRATE_FIELDS]
        if row_words(p) > sum(c.shape[1] for c in cols) + 1:  # the pad word
            cols.append(torch.zeros_like(cols[-1][:, :1]))
        rows = torch.cat(cols + [torch.ones_like(cols[-1][:, :1])], dim=1)
        rows = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])  # the empty row
        bufs.append(rows[src].reshape(n, K, rows.shape[1]))
        p.alive.copy_(p.alive & ~sent)
        sent_counts.append(sent.sum(dtype=torch.int64))
    return bufs, torch.stack(sent_counts)


# slots a tile of the migration kernel's scans (csrc/migrate_kernel.cu, kTile),
# in rounds of MIGRATE_THREADS consecutive slots (kThreads)
MIGRATE_TILE, MIGRATE_THREADS = 1024, 256


def migrate_scratch_len(m: int, cap_l: int, n: int) -> int:
    """The migration kernel's scratch for ``m`` local shards of ``cap_l`` slots and
    ``n`` shards, in int64 words: its ticket and a status word a tile and
    destination."""
    return 1 + m * -(-cap_l // MIGRATE_TILE) * n


class MigrateScratch:
    """The migration kernel's scratch of a step: zeroed when it is made, and left
    ready by every launch (csrc/migrate_kernel.cu: the ticket moves to the next
    epoch, which tags the status words), so a replay queues no memset. ``reserve``
    makes a larger one where the ledger grew, outside any capture (the step's
    prologue); the ones before it are kept, so that a graph captured on one keeps
    its memory. Launches that share one must be ordered on one stream."""

    def __init__(self):
        self.tensors = []

    def reserve(self, m: int, cap_l: int, n: int, device) -> torch.Tensor:
        need = migrate_scratch_len(m, cap_l, n)
        if not self.tensors or self.tensors[-1].numel() < need:
            self.tensors.append(torch.zeros(need, dtype=torch.int64, device=device))
        return self.tensors[-1]


def _pack_cuda(ledgers, offsets, bl, K, n, go, work=None) -> tuple:
    """One launch of the migration kernel (``csrc/migrate_kernel.cu``) over every
    local shard's adjacent slice (``join_slices``) on PyTorch's current stream,
    without waiting for it: ``pack_plain``'s buffers, in the receivers' layout
    (one [n, m, K, row_words] tensor, local shard s's buffer at ``[:, s]``, as the
    in-process exchange would stack them), every row that no slot takes left
    unwritten; their valid flags apart, one bool a row in the same layout ([n, m,
    K], the buffers' valid column); and the sent counts. ``work`` is the kernel's
    scratch (``MigrateScratch.reserve``; None: a fresh one). Raises unless the
    ledgers are adjacent slices on one GPU with their shards' offsets
    ``offsets[0] + i bl``."""
    from ..ops import cuda_lib

    joined, _ = join_slices(ledgers)
    m, dev = len(ledgers), joined.alive.device
    if list(offsets) != [offsets[0] + i * bl for i in range(m)]:
        raise ValueError(f"migration kernel: offsets {list(offsets)} are not {bl} blocks apart")
    if go is not None and (go.device != dev or go.dtype != torch.bool or go.numel() != 1):
        raise ValueError("migration kernel: go must be one bool on the ledger's GPU")
    cols = [getattr(joined, name) for name in MIGRATE_FIELDS]
    if any(c.device != dev or not c.is_contiguous() for c in cols + [joined.alive]):
        raise ValueError("migration kernel: ledger columns must be contiguous on one GPU")
    reals, ints = cols[:9], cols[9:]  # the kernel's row layout (kReals, kInts)
    if (joined.alive.dtype != torch.bool or any(c.dtype != torch.int32 for c in ints)
            or any(c.dtype != joined.x.dtype for c in reals)):
        raise ValueError("migration kernel: a bool alive column, nine reals of one dtype "
                         "and six int32 columns")
    words = row_words(joined)
    cap_l = joined.capacity // m
    if work is None:
        work = MigrateScratch().reserve(m, cap_l, n, dev)
    if (work.dtype != torch.int64 or work.device != dev or not work.is_contiguous()
            or work.numel() < migrate_scratch_len(m, cap_l, n)):
        raise ValueError(f"migration kernel: a scratch of {migrate_scratch_len(m, cap_l, n)} "
                         f"int64 on {dev} expected")
    buf = torch.empty((n, m, K, words), dtype=torch.int32, device=dev)
    flags = torch.empty((n, m, K), dtype=torch.bool, device=dev)
    sent = torch.empty(m, dtype=torch.int64, device=dev)
    cuda_lib.library().call(
        "jb_migrate_launch", (ctypes.c_void_p * len(cols))(*[c.data_ptr() for c in cols]),
        joined.x.element_size(), words, joined.alive.data_ptr(), joined.block.data_ptr(),
        None if go is None else go.data_ptr(), m, n, cap_l, bl, offsets[0], K,
        buf.data_ptr(), flags.data_ptr(), work.data_ptr(), work.numel(), sent.data_ptr(),
        cuda_lib.stream_handle(dev))
    cuda_lib.LAUNCHES["migrate_pack"] += 1
    return buf, flags, sent


def migrate(ledgers, offsets, bl, K, exchange, go=None, plain=False, work=None):
    """One round of all_to_all migration over the local shards' ledgers (IN
    PLACE; JAX ``migrate``): the live particles whose block lies outside their
    shard's [offset, offset + bl) are grouped by destination shard as a stable
    sort groups them, the first K for each destination packed into an [n, K]
    buffer and sent; the rest stay in transit for the next round. On a GPU one
    launch of the migration kernel over every local shard (``_pack_cuda`` with
    its scratch ``work``, straight into the in-process exchange's receivers'
    layout, so nothing is stacked; the rows' valid flags apart, sent beside them
    through any other exchange), on the CPU (or with ``plain``) its plain version
    (``pack_plain``, the rows' valid column as the flags). Shard s receives, from
    each shard j in j order, what j addressed to s, and inserts it into its free
    slots without recycling this step's absorbed rows: on a GPU one pass of the
    insert kernel over every local shard (``particles.insert_arrivals``). With
    ``go`` (a 0-dim bool tensor) false nothing is sent and nothing changes.
    Returns (received particles dropped for want of a free slot, particles sent),
    one int64 tensor each of one a local shard."""
    n = exchange.n
    if ledgers[0].alive.is_cuda and not plain:
        buf, flags, sent = _pack_cuda(ledgers, offsets, bl, K, n, go, work)
        if isinstance(exchange, InProcess):
            recv, valid = buf, flags
        else:  # the flags as bytes, which every backend sends
            recv = exchange.all_to_all(buf.unbind(1))
            valid = exchange.all_to_all(flags.view(torch.uint8).unbind(1)).view(torch.bool)
    else:
        bufs, sent = pack_plain(ledgers, offsets, bl, K, n, go)
        recv, valid = exchange.all_to_all(bufs), None  # [local shards, n, K, words]
    recv = recv.reshape(-1, recv.shape[-1])
    valid = recv[:, -1] if valid is None else valid.reshape(-1)
    cand, c = {}, 0
    for name in MIGRATE_FIELDS:
        dt = getattr(ledgers[0], name).dtype
        w = dt.itemsize // 4
        cand[name] = recv[:, c:c + w].view(dt)[:, 0]
        c += w
    return insert_arrivals(ledgers, cand, valid), sent


class _CountRead:
    """One batch's summed unfinished count on its way to the host, for a read made
    after the next batch was queued: on a GPU copied into a pinned host slot of
    its own behind the batch on the stream, an event recorded after the copy (the
    graphs rewrite ``unfinished`` in place, so a later batch must not overwrite
    what this read needs); on the CPU a copy."""

    def __init__(self, unfinished: torch.Tensor):
        self.event = None
        if unfinished.is_cuda:
            self.host = torch.empty((), dtype=unfinished.dtype, pin_memory=True)
            self.host.copy_(unfinished, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = unfinished.clone()

    def item(self) -> int:
        if self.event is not None:
            self.event.synchronize()
        return self.host.item()


def _exit_read(count) -> int:
    """A batch's one host read: the summed count of particles short of census (the
    device tensor, or the batch's ``_CountRead``)."""
    with record_function("spatial.exit_read"):
        return int(count.item())


@dataclasses.dataclass
class StepTensors:
    """What a spatial step's head hands its rounds and its tail, on the device:
    the shards' fields, the census set-up, and the counters that the rounds
    update in place (per local shard: census iterations, events, iteration cap
    hits, particles dropped and sent; the summed rounds run and unfinished
    particles). A CUDA graph of the rounds reads and writes these tensors."""

    fs: list
    setup: object
    iters: torch.Tensor
    events: torch.Tensor
    hits: torch.Tensor
    dropped: torch.Tensor
    sent: torch.Tensor
    rounds: torch.Tensor
    unfinished: torch.Tensor


def build_spatial_step_core(mesh, cfg: RunConfig, exchange, rounds_per_batch=None):
    """``step(states, dt) -> (states, StepStats)`` over the local shards' states,
    each with its [Bl, ...] fields and its ledger (JAX ``build_spatial_step_core``).

    The step is ``step.prologue(states, dt)`` (on the host: the sourcing
    generators seeded by ``manual_seed``, the external source's window copied to
    the device), ``step.head(states, dt)`` (Fleck factor, faces, sourcing,
    coefficients and the census set-up; returns the ``StepTensors``), batches of
    rounds (``step.run_rounds``: before each batch ``step.round_prologue`` seeds
    the batch's fixup generators and copies its census seeds to the device, then
    ``step.batch(states, tensors, nr)`` queues ``nr`` rounds, then the batch's one
    host read, made one batch behind the queue where ``step.ahead``) and
    ``step.tail(states, tensors, dt)`` (tallies, feedback, the counters).
    ``step.capturable`` says whether the head, a batch and the tail can
    each be captured in a CUDA graph (``graph.GraphedSpatialStep``): with the
    in-process exchange and the kernel's census.

    A batch runs ``rounds_per_batch`` rounds (fewer where it would run past
    ``max_migration_rounds``, one where nothing can migrate); by default
    ``ROUNDS_PER_BATCH`` where the step is capturable on a GPU (its graphs, and
    the eager step that ``Simulation(graph=False)`` holds them against), else one.
    A round that begins with nothing unfinished changes nothing (its writes and
    counts are gated by a device flag), so any batch size gives the step of one
    round a batch, bitwise, and so does a batch queued before the read of the one
    before it: with ``step.ahead`` each is, where the read would wait on the card
    (the step capturable, on a GPU; not on the CPU, which has nothing to overlap,
    nor in a process group, whose rounds meet in collectives; a test may set
    it). ``step.rounds_run``
    counts the rounds queued, no-op rounds too; ``step.rounds_per_batch`` is the
    batch."""
    eos = cfg.mcblock.build_eos()
    opacity = cfg.mcblock.build_opacity()
    scattering = cfg.mcblock.build_scattering()
    models = (eos, opacity, scattering)
    consts = opacity.get_runtime_physical_constants()
    jb = cfg.jaybenne
    dtype = jb.dtype
    prm = make_transport_params(cfg, dtype)
    transport_kernel.check_supported(mesh, prm, dtype)
    periodic = cfg.mesh.periodic_flags
    n = exchange.n
    B = mesh.n_blocks
    bl = blocks_per_shard(mesh, n)
    smr_ddmc = jb.use_ddmc and mesh.max_level > 0
    # every real block on shard 0: nothing can be in transit, so migration is skipped
    can_migrate = n > 1 and B > bl
    census = census_fn(cfg)
    shards = exchange.shards
    # some shards run in other processes (a process group): the counts that the
    # count kernel sums over the local shards are summed over the group too
    remote = len(shards) != n
    work = counts.scratch(len(shards), mesh.device)  # the count kernel's
    moves = MigrateScratch()  # the migration kernel's, sized by the prologue
    offsets = [s * bl for s in shards]
    owns = [owned_range(mesh, prm, n, s) for s in shards]
    # the plain census interleaves its rounds by an iteration budget (JAX
    # spatial.py:431-446); the round cap is scaled to keep the total backstop
    prm_round, max_rounds = prm, jb.max_migration_rounds
    if jb.use_pallas == "off" and can_migrate and jb.census_iters_per_round > 0:
        budget = min(jb.census_iters_per_round, prm.max_iters)
        prm_round = dataclasses.replace(prm, max_iters=budget)
        max_rounds = max_rounds * -(-prm.max_iters // budget)
    dev = mesh.device
    capturable = isinstance(exchange, InProcess) and census is transport_kernel.transport
    if rounds_per_batch is None:
        rounds_per_batch = ROUNDS_PER_BATCH if capturable and dev.type == "cuda" else 1
    R = rounds_per_batch if can_migrate else 1
    external = None
    if jb.external_source_q > 0:
        external = sourcing.external_source_setup(mesh, jb)
        ext_num = jb.external_source_num or jb.num_particles
        # each shard's source cells, fixed for the run
        ext_cells = [sourcing.shard_source_cells(mesh, external, off, bl) for off in offsets]
    phases = ((rng.PHASE_SOURCE,) if jb.do_emission else ()) + (
        (rng.PHASE_EXTERNAL,) if external else ())
    gens = {(ph, s): torch.Generator(device=dev) for ph in phases for s in shards}
    fixup = {(s, k): torch.Generator(device=dev) for s in shards for k in range(R)
             } if smr_ddmc else {}
    window = torch.empty(2, dtype=dtype, device=dev) if external else None
    # the census seeds of a batch's rounds: on a GPU rows of an int32 device
    # tensor that each round prologue rewrites, on the CPU host ints
    seeds = {"buf": None, "now": None}

    def prologue(states, dt):
        if can_migrate and dev.type == "cuda":
            moves.reserve(len(states), states[0].particles.capacity, n, dev)
        if external:
            window.copy_(torch.tensor(external.window(states[0].t, dt), dtype=dtype,
                                      pin_memory=dev.type == "cuda"), non_blocking=True)
        for ph in phases:
            for st, s in zip(states, shards):
                rng.reseed(gens[(ph, s)], st.seed, st.cycle, ph, (s,))

    def round_prologue(states, r0, nr):
        """Rounds r0 .. r0 + nr - 1's fixup generators seeded and census seeds set.
        On a GPU the seeds' copy is queued on the stream, behind any batch still
        queued that reads the buffer (the caching host allocator keeps its pinned
        source until the copy has run); a registered generator's replay takes its
        seed on the stream too."""
        with record_function("spatial.round_prologue"):
            for k in range(nr) if smr_ddmc else ():
                for st, s in zip(states, shards):
                    rng.reseed(fixup[(s, k)], st.seed, st.cycle, rng.PHASE_FIXUP, (s, r0 + k))
            now = [[rng.kernel_seed(st.seed, st.cycle, s, r0 + k) for st, s in zip(states, shards)]
                   for k in range(nr)]
            if dev.type != "cuda":
                seeds["now"] = now
                return
            if seeds["buf"] is None:
                seeds["buf"] = torch.empty((R, len(shards)), dtype=torch.int32, device=dev)
                seeds["now"] = list(seeds["buf"].unbind())
            seeds["buf"][:nr].copy_(torch.tensor(now, dtype=torch.int32, pin_memory=True),
                                    non_blocking=True)

    def head(states, dt) -> StepTensors:
        with record_function("spatial.head"):
            fs, ps = [st.fields for st in states], [st.particles for st in states]
            fs = [with_fleck(f, models, dt, dtype) for f in fs]
            if jb.use_ddmc:
                # each shard's faces read its own blocks whole and every block's surface
                sig = [total_sigma(f, models, dtype) for f in fs]
                surf = exchange.all_gather([fleck_ops.pack_boundary_surface(mesh, t)
                                            for t in sig])
                faces = fleck_ops.ddmc_face_probs_shards(mesh, sig, surf, offsets, jb.tau_ddmc,
                                                         periodic, dtype)
                fs = [with_faces(f, q) for f, q in zip(fs, faces)]
            dropped = [torch.zeros((), dtype=torch.int64, device=dev) for _ in states]
            if not jb.do_emission:
                fs = [dataclasses.replace(f, energy_delta=torch.zeros_like(f.energy_delta))
                      for f in fs]
                if external:
                    fs = [dataclasses.replace(f, source_num=torch.zeros_like(f.source_num),
                                              source_ew=torch.zeros_like(f.source_ew))
                          for f in fs]
            for i, (s, off) in enumerate(zip(shards, offsets)):
                kw = dict(eos=eos, opacity=opacity, sb=consts.sb, c=consts.c, dt=dt,
                          dtype=dtype, block_offset=off)
                if jb.do_emission:  # each shard sources its own blocks: nothing is summed
                    fs[i], ps[i], d = sourcing.source_photons(
                        fs[i], ps[i], mesh, gens[(rng.PHASE_SOURCE, s)], source_type="emission",
                        num_particles=jb.num_particles, **kw)
                    dropped[i] = dropped[i] + d
                if external:
                    fs[i], ps[i], d = sourcing.source_photons(
                        fs[i], ps[i], mesh, gens[(rng.PHASE_EXTERNAL, s)],
                        source_type="external", num_particles=ext_num, external=external,
                        window=window, cells=ext_cells[i], **kw)
                    dropped[i] = dropped[i] + d
            coefs = [transport_ops.precompute_coefs(f, mesh, eos, opacity, scattering,
                                                    jb.use_ddmc, dtype) for f in fs]
            setup = transport_kernel.prepare(coefs, mesh, prm_round, dt, owns)

            def zeros(shape, dtype=torch.int64):
                return torch.zeros(shape, dtype=dtype, device=dev)

            m = len(states)
            # ``unfinished`` starts at 1, so that the first round's gate opens
            return StepTensors(fs, setup, zeros(m, torch.int32), zeros(m), zeros(m),
                               torch.stack(dropped), zeros(m), zeros(()),
                               torch.ones((), dtype=torch.int64, device=dev))

    def one_round(ps, t: StepTensors, k, go, dt):
        """Round ``k`` of a batch; ``go`` None where it is known to have work, else
        the device flag that it has. Each part reads the flag on the device and
        changes nothing where it is false: the fixup, the census (its launch
        touches no slot, the fold's round trip included, and its counters read 0)
        and the migration; the round's counts (``counts.round_counts``: the
        census's and the migration's counts added to the step's, the round counted
        by its flag, the unfinished count written afresh) are one launch on a
        GPU."""
        with record_function("spatial.round.fixup"):
            for i, (s, off) in enumerate(zip(shards, offsets)) if smr_ddmc else ():
                f = t.fs[i]  # pending coarse-to-fine leaks, before the census
                transport_kernel.subface_resample(
                    ps[i], (f.ddmc_px, f.ddmc_py, f.ddmc_pz), mesh, prm.c, fixup[(s, k)], off,
                    bl, go=go)
        with record_function("spatial.round.census"):
            _, it, ev = census(ps, t.setup, mesh, seeds["now"][k], prm_round, dt, go=go)
        with record_function("spatial.round.migrate"):
            drop = n_sent = None
            if can_migrate:
                K = jb.migration_buffer_k or max(64, ps[0].capacity // (2 * n))
                drop, n_sent = migrate(ps, offsets, bl, K, exchange, go=go,
                                       work=moves.tensors[-1] if moves.tensors else None)
        with record_function("spatial.round.counts"):
            counts.round_counts(ps, t, it, ev, drop, n_sent, go, prm.max_iters, work)
            if remote:
                t.unfinished.copy_(exchange.sum([t.unfinished])[0])

    def batch(states, t: StepTensors, nr, dt):
        """``nr`` rounds with no host read, each gated by the unfinished count
        before it (the head's 1 for a step's first round), so that a batch may be
        queued before the read of the one before it."""
        ps = [st.particles for st in states]
        for k in range(nr):
            with record_function("spatial.round"):
                one_round(ps, t, k, t.unfinished > 0, dt)

    def run_rounds(states, unfinished, run_batch):
        """The step's batches, each ``run_batch(nr)`` after its round prologue, and
        one host read of ``unfinished`` a batch, until a read of 0 or
        ``max_rounds`` rounds queued; with ``step.ahead`` the reads run one batch
        behind the queue, each of its own copy of the count (``_CountRead``)."""
        done, reads = 0, collections.deque()
        while True:
            while done < max_rounds and len(reads) <= step.ahead:
                nr = min(R, max_rounds - done)
                round_prologue(states, done, nr)
                run_batch(nr)
                reads.append(_CountRead(unfinished) if step.ahead else unfinished)
                done += nr
                step.rounds_run += nr
            if not reads or _exit_read(reads.popleft()) == 0:
                return

    def tail(states, t: StepTensors, dt):
        with record_function("spatial.tail"):
            fs, ps = list(t.fs), [st.particles for st in states]
            # tallies and feedback: each cell on one shard
            fs = tally.tallies(fs, ps, mesh, prm.has_absorption, block_offsets=offsets)
            if jb.do_feedback:
                fs = [tally.update_fluid(f, mesh, block_offset=off) for f, off in zip(fs, offsets)]
            for p in ps:
                p.absorbed.zero_()
                p.tau.zero_()
            _, totals = counts.counts(ps, work)  # the live counts' sum and max
            n_alive, alive_max = totals[0], totals[1]
            if remote:
                n_alive, alive_max = exchange.sum([n_alive])[0], exchange.max([alive_max])[0]
            dropped = exchange.sum(list(t.dropped.unbind()))
            stats = StepStats.pack(
                iterations=exchange.max(list(t.iters.unbind()))[0],
                events=exchange.sum(list(t.events.unbind()))[0],
                n_alive=n_alive,
                dropped=dropped[0],
                cap_hits=exchange.sum(list(t.hits.unbind()))[0],
                unfinished=t.unfinished,
                migration_rounds=t.rounds,
                migrated=exchange.sum(list(t.sent.unbind()))[0],
                alive_max=alive_max,
            )
            new = [dataclasses.replace(st, fields=f, particles=p, t=st.t + dt,
                                       cycle=st.cycle + 1, overflow=st.overflow + dropped[0])
                   for st, f, p in zip(states, fs, ps)]
            return new, stats

    def step(states, dt):
        prologue(states, dt)
        t = head(states, dt)
        run_rounds(states, t.unfinished, lambda nr: batch(states, t, nr, dt))
        return tail(states, t, dt)

    step.prologue, step.head, step.batch, step.tail = prologue, head, batch, tail
    step.run_rounds, step.round_prologue, step.one_round = run_rounds, round_prologue, one_round
    step.generators = lambda: list(gens.values()) + list(fixup.values())
    step.capturable = capturable
    step.rounds_run, step.rounds_per_batch = 0, R
    step.ahead = capturable and dev.type == "cuda"
    return step


def make_spatial_init(mesh, cfg: RunConfig, exchange):
    """``init(states) -> states``: each shard thermal-sources its own blocks' cells
    and tallies them (JAX ``make_spatial_init``)."""
    bl = blocks_per_shard(mesh, exchange.n)

    def init(states):
        jb = cfg.jaybenne
        fs, ps, drops = [], [], []
        for st, s in zip(states, exchange.shards):
            f, p = st.fields, st.particles
            d = torch.zeros((), dtype=torch.int64, device=mesh.device)
            if cfg.mcblock.initial_radiation == InitialRadiation.thermal:
                consts = cfg.mcblock.build_opacity().get_runtime_physical_constants()
                gen = rng.generator(st.seed, 0, rng.PHASE_INIT, mesh.device, (s,))
                f, p, d = sourcing.source_photons(
                    f, p, mesh, gen, source_type="thermal", eos=cfg.mcblock.build_eos(),
                    sb=consts.sb, c=consts.c, num_particles=jb.num_particles, dtype=jb.dtype,
                    block_offset=s * bl)
            fs.append(f)
            ps.append(p)
            drops.append(d.to(torch.int64))
        fs = tally.tallies(fs, ps, mesh, False, block_offsets=[s * bl for s in exchange.shards])
        dropped = exchange.sum(drops)[0]
        return [dataclasses.replace(st, fields=f, particles=p, overflow=st.overflow + dropped)
                for st, f, p in zip(states, fs, ps)]

    return init
