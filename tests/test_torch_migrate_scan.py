"""The spatial migration's sort and pack by scans on the CPU: a mirror in PyTorch
of the migration kernel's one-launch plan (``csrc/migrate_kernel.cu``: a tile's
in-transit slots counted by destination a round's warp at a time, those counts
scanned into each warp's offset in the tile, the tile's prefix from a decoupled
look-back over the tiles before it in its slice, each slot ranked by its tile's
prefix, its warp's offset and its place among its warp's lanes of the same
destination, and the slice's last tile writing the flags) against the plain
version's stable sort (``spatial.migration_map``, ``pack_plain``): the look-back's
prefixes the exclusive scan of the tile counts whatever the predecessors had
published, the same destinations, ranks, rows, sent slots and counts, and the
flags ``pack_plain``'s valid column, over 2, 3 and 8 shards, with K overflowing,
``go`` false, float64 columns (the pad word), empty shards and slices of several
and of 64 or more tiles; the insert fed the flags apart as fed the rows' valid
column; and the port's plain ``migrate`` against the JAX package's
(``jaybenne_tpu/parallel/spatial.py::migrate`` under ``shard_map`` on the host's
CPU devices) on the same ledgers: every column bitwise, the counts equal."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from jaybenne_tpu import particles as jparticles
from jaybenne_tpu.parallel import spatial as jspatial
from jaybenne_tpu_torch.parallel import exchange, spatial
from jaybenne_tpu_torch.parallel.sharding import split_ledger
from jaybenne_tpu_torch.particles import ParticleLedger, insert_arrivals

THREADS = spatial.MIGRATE_THREADS
ITEMS = spatial.MIGRATE_TILE // THREADS
WARPS = THREADS // 32
FLOATS = ("x", "y", "z", "vx", "vy", "vz", "tau", "weight", "energy")
INTS = ("block", "i", "j", "k", "face", "leak")
BOOLS = ("alive", "absorbed")


def _ledger(m, n, cap_l, bl, off0, alive_share, dtype, rng, empty=()):
    """``m`` adjacent shard slices of ``cap_l`` slots, local shard s owning blocks
    [off0 + s bl, off0 + (s + 1) bl) of ``n`` shards' n bl: live slots at random
    (none in the shards of ``empty``), half of them in their own shard's blocks,
    the rest in any block; random columns."""
    cap = m * cap_l
    shard = np.arange(cap) // cap_l
    own = off0 + shard * bl + rng.integers(0, bl, cap)
    anywhere = rng.integers(0, n * bl, cap)
    cols = {k: rng.standard_normal(cap).astype(dtype) for k in FLOATS}
    cols.update({k: rng.integers(-3, 9, cap).astype(np.int32) for k in INTS})
    cols["block"] = np.where(rng.random(cap) < 0.5, own, anywhere).astype(np.int32)
    cols["alive"] = (rng.random(cap) < alive_share) & ~np.isin(shard, empty)
    cols["absorbed"] = rng.random(cap) < 0.1
    return cols


def _torch(cols):
    return ParticleLedger(**{k: torch.from_numpy(v.copy()) for k, v in cols.items()})


def look_back(agg, rng, ready=0.5):
    """The tiles' exclusive prefixes by the kernel's look-back over ``agg`` ([m
    local shards, lt tiles, n destinations]: each tile's count): the tiles in
    ticket order (a slice's in order), each walking back over the tiles before it
    in its slice 32 at a time (lane l reads the tile l before the window's top),
    each word an inclusive prefix where that tile had published one when read (a
    slice's first tile always; another with chance ``ready``, drawn from ``rng``
    for each tile and destination), else the tile's aggregate; a window adds its
    words up to and including its nearest prefix and ends the walk there, or all
    32 and moves on. Each tile's inclusive prefix is its walk's sum plus its
    count, as the kernel publishes it."""
    a = agg.numpy()
    m, lt, n = a.shape
    excl, incl = np.zeros_like(a), np.zeros_like(a)
    for s in range(m):
        incl[s, 0] = a[s, 0]
        for j in range(1, lt):
            prefix = rng.random((j, n)) < ready
            prefix[0] = True
            word = np.where(prefix, incl[s, :j], a[s, :j])
            total = np.zeros(n, dtype=a.dtype)
            done = np.zeros(n, dtype=bool)
            for top in range(j - 1, -1, -32):
                pred = top - np.arange(32)
                live = pred >= 0
                p = np.where(live[:, None], prefix[np.maximum(pred, 0)], True)  # [32, n]
                w = np.where(live[:, None], word[np.maximum(pred, 0)], 0)
                first = np.where(p.any(0), p.argmax(0), 32)
                take = np.arange(32)[:, None] <= first[None, :]
                total += np.where(done, 0, (w * take).sum(0))
                done |= p.any(0)
                if done.all():
                    break
            excl[s, j], incl[s, j] = total, total + a[s, j]
    return torch.from_numpy(excl)


def mirror_plan(joined, m, n, cap_l, bl, off0, K, go=True, rng=None):
    """The migration kernel's plan, thread by thread (vectorised): each round's
    warp's count by destination (__match_any_sync's leaders), scanned over the
    tile's rounds and warps into each warp's offset and the tile's count, the
    tile's prefix from the look-back (``look_back``), each slot's rank its tile's
    prefix, its warp's offset and its place among its warp's lanes with its
    destination; the slice's last tile's inclusive prefix its counts. Returns
    (dest, rank) of every slot (dest n where it is not in transit), each tile's
    count and prefix ([m, lt, n]), each slice's counts by destination and its sent
    count, and the flags in the receivers' layout [n, m, K] (1 below min(count,
    K))."""
    rng = np.random.default_rng(0) if rng is None else rng
    lt = max(1, -(-cap_l // (ITEMS * THREADS)))
    alive = joined.alive.view(m, cap_l)
    block = joined.block.view(m, cap_l).long()
    lo = off0 + torch.arange(m)[:, None] * bl
    transit = alive & ((block < lo) | (block >= lo + bl)) & go
    dest = torch.where(transit, torch.div(block, bl, rounding_mode="trunc").clamp(0, n - 1), n)
    pad = torch.full((m, lt * ITEMS * THREADS), n, dtype=torch.int64)
    pad[:, :cap_l] = dest
    # slot e of tile j is round e // THREADS, warp (e % THREADS) // 32, lane e % 32
    onehot = torch.nn.functional.one_hot(pad.view(m, lt, ITEMS, WARPS, 32), n + 1)[..., :n]
    warps = onehot.sum(4).reshape(m, lt, ITEMS * WARPS, n)  # each round's warp's counts
    offsets = (warps.cumsum(2) - warps).view(m, lt, ITEMS, WARPS, 1, n)
    agg = warps.sum(2)  # the tile's count by destination
    excl = look_back(agg, rng)
    lower_lanes = onehot.cumsum(4) - onehot  # popc(match_any & lanes below)
    ranks = excl[:, :, None, None, None, :] + offsets + lower_lanes
    rank = ranks.gather(-1, pad.clamp(max=n - 1).view(m, lt, ITEMS, WARPS, 32, 1))
    rank = rank.view(m, -1)[:, :cap_l]
    tot = excl[:, -1] + agg[:, -1]
    lim = torch.minimum(tot, torch.tensor(K))
    flags = (torch.arange(K) < lim[..., None]).permute(1, 0, 2)
    return dest, rank, agg, excl, tot, lim.sum(1), flags


def mirror_rows(joined, m, n, cap_l, K, dest, rank, words):
    """The rows the kernel writes, from the plan (``mirror_plan``): each in-transit
    slot of rank below K puts its columns' int32 words (a float64 column's low
    word first), a zero pad and the valid word 1 into row rank of its
    destination's buffer, in the receivers' layout [n, m, K, words]; every other
    row is 0 here (the kernel leaves it unwritten). Returns the buffers and the
    slots sent."""
    ok = (dest < n) & (rank < K)
    s, e = torch.nonzero(ok, as_tuple=True)
    q = s * cap_l + e
    cols = [spatial._words(getattr(joined, name))[q] for name in spatial.MIGRATE_FIELDS]
    used = sum(c.shape[1] for c in cols)
    cols += [torch.zeros((q.numel(), words - used - 1), dtype=torch.int32),
             torch.ones((q.numel(), 1), dtype=torch.int32)]
    buf = torch.zeros((n, m, K, words), dtype=torch.int32)
    buf[dest[ok], s, rank[ok]] = torch.cat(cols, dim=1)
    return buf, ok.flatten()


CASES = {  # m local shards, n shards, slots a shard, blocks a shard, the first
    # shard's first block, K, alive share, empty shards, float64, go
    "n2_several_tiles": (2, 2, 4500, 3, 0, 4000, 0.6, (), False, True),
    "n3_overflow": (3, 3, 2100, 2, 0, 40, 0.7, (), False, True),
    "n8": (8, 8, 700, 4, 0, 300, 0.5, (), False, True),
    "n8_overflow_several_tiles": (8, 8, 2500, 2, 0, 30, 0.8, (), False, True),
    "go_false": (3, 3, 2100, 2, 0, 400, 0.7, (), False, False),
    "f64_pad_word": (3, 3, 2100, 2, 0, 200, 0.6, (), True, True),
    "f64_overflow": (8, 8, 600, 3, 0, 10, 0.9, (), True, True),
    "empty_shards": (8, 8, 2100, 2, 0, 500, 0.6, (0, 3, 7), False, True),
    "all_empty": (2, 2, 300, 2, 0, 64, 0.0, (), False, True),
    # one process's shard of a group (backend (a)): shard 2 of 4
    "one_of_four": (1, 4, 3000, 5, 10, 200, 0.7, (), False, True),
    # slices of 64 tiles and more: the look-back crosses many windows of 32
    "n2_many_tiles": (2, 2, 66000, 3, 0, 18000, 0.5, (), False, True),
    "four_of_eight_many_tiles_overflow": (4, 8, 66000, 2, 0, 1500, 0.6, (), False, True),
    "f64_many_tiles": (3, 3, 66000, 2, 0, 12000, 0.4, (1,), True, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_plan_is_the_stable_sort(case):
    """The mirror of the kernel's plan gives every tile the exclusive scan of the
    tile counts as its prefix, every slot the destination and rank of the plain
    version's stable sort, the same sent slots and counts, ``pack_plain``'s rows,
    and flags equal to ``pack_plain``'s valid column."""
    m, n, cap_l, bl, off0, K, share, empty, wide, go = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    dtype = np.float64 if wide else np.float32
    joined = _torch(_ledger(m, n, cap_l, bl, off0, share, dtype, rng, empty))
    dest, rank, agg, excl, tot, sent, flags = mirror_plan(joined, m, n, cap_l, bl, off0, K,
                                                          go, rng)
    assert torch.equal(excl, agg.cumsum(1) - agg)
    flag = torch.tensor(go)
    for s, p in enumerate(split_ledger(joined, m)):
        src, plain_sent = spatial.migration_map(p, off0 + s * bl, bl, n, K, flag)
        want = torch.full((n * K,), cap_l, dtype=torch.int64)
        ok = (dest[s] < n) & (rank[s] < K)
        want[dest[s][ok] * K + rank[s][ok]] = torch.nonzero(ok).flatten()
        assert torch.equal(src, want)
        assert torch.equal(plain_sent, ok)
        assert int(sent[s]) == int(ok.sum())
    words = spatial.row_words(joined)
    assert words == (26 if wide else 16)
    want_buf, want_sent = mirror_rows(joined, m, n, cap_l, K, dest, rank, words)
    q = joined.clone()
    bufs, plain_counts = spatial.pack_plain(split_ledger(q, m), [off0 + s * bl for s in range(m)],
                                            bl, K, n, flag)
    got = torch.stack(bufs, dim=1)  # the receivers' layout
    assert torch.equal(got, want_buf)
    assert torch.equal(got[..., -1] == 1, flags) and bool((got[..., -1] <= 1).all())
    assert torch.equal(plain_counts, sent)
    assert torch.equal(q.alive, joined.alive & ~want_sent)
    if not go or case == "all_empty":
        assert int(sent.sum()) == 0 and bool((got == 0).all()) and not bool(flags.any())
    if "overflow" in case:
        assert bool((tot > K).any())
    if "many_tiles" in case:
        assert agg.shape[1] >= 64
    if empty:
        assert all(int(sent[s]) == 0 for s in empty)


@pytest.mark.parametrize("ready", [0.0, 0.05, 0.5, 1.0])
def test_look_back_is_the_exclusive_scan(ready):
    """The look-back (``look_back``) gives each tile the exclusive scan of its
    slice's tile counts whatever its predecessors had published when it read them:
    none but the slice's first tile a prefix (walks across several windows of
    32), few, half, or every one."""
    rng = np.random.default_rng(int(ready * 100))
    agg = torch.from_numpy(rng.integers(0, 40, (3, 150, 5)))
    assert torch.equal(look_back(agg, rng, ready), agg.cumsum(1) - agg)


@pytest.mark.parametrize("wide,K", [(False, 300), (True, 40)], ids=["f32", "f64_overflow"])
def test_insert_takes_the_flags_apart(wide, K):
    """``insert_arrivals`` fed the flags apart (one bool a row, as the kernel
    writes them) gives every ledger column and each shard's dropped count bitwise
    as fed the rows' valid column (``pack_plain``'s), with ledgers full enough
    that some arrivals are dropped."""
    m = n = 3
    cap_l, bl = 2500, 2
    rng = np.random.default_rng(7 + wide)
    cols = _ledger(m, n, cap_l, bl, 0, 0.97, np.float64 if wide else np.float32, rng)
    base = _torch(cols)  # packed from a clone: the senders' slots stay taken
    bufs, _ = spatial.pack_plain(split_ledger(base.clone(), m), [s * bl for s in range(m)], bl,
                                 K, n)
    recv = exchange.InProcess(n).all_to_all(bufs)
    flags = (recv[..., -1] == 1).contiguous()
    recv = recv.reshape(-1, recv.shape[-1])
    cand, c = {}, 0
    for name in spatial.MIGRATE_FIELDS:
        dt = getattr(base, name).dtype
        cand[name] = recv[:, c:c + dt.itemsize // 4].view(dt)[:, 0]
        c += dt.itemsize // 4
    a, b = base.clone(), base.clone()
    drop_a = insert_arrivals(split_ledger(a, m), cand, recv[:, -1])
    drop_b = insert_arrivals(split_ledger(b, m), cand, flags.reshape(-1))
    assert int(flags.sum()) > 0 and int(drop_a.sum()) > 0
    assert torch.equal(drop_a, drop_b)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8)), f.name


def _jax(fn, wide):
    """``fn()`` with the JAX package in float64 where ``wide``."""
    if not wide:
        return fn()
    jax.config.update("jax_enable_x64", True)
    try:
        return fn()
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("n,wide,K", [(8, False, 64), (8, False, 7), (2, True, 64), (8, True, 9)],
                         ids=["n8", "n8_overflow", "n2_f64", "n8_f64_overflow"])
def test_plain_migrate_is_the_jax_migrate(n, wide, K):
    """The port's plain ``migrate`` (sort, pack, in-process exchange, insert with
    the absorbed rows reserved) and the JAX package's, under ``shard_map`` over
    ``n`` host CPU devices, on the same ledgers made from a seed: every column of
    every shard bitwise equal, each shard's dropped and sent counts equal."""
    cap_l, bl = 160, 3
    rng = np.random.default_rng(21 + n + 2 * wide + K)
    cols = _ledger(n, n, cap_l, bl, 0, 0.7, np.float64 if wide else np.float32, rng)
    if K < 64:  # shard 0's slice full of its own, half the others' bound for it
        cols["alive"][:cap_l] = True
        cols["block"][:cap_l] = rng.integers(0, bl, cap_l)
        to0 = rng.random(n * cap_l) < 0.5
        to0[:cap_l] = False
        cols["block"][to0] = rng.integers(0, bl, int(to0.sum()))
    tl = _torch(cols)
    drop, sent = spatial.migrate(split_ledger(tl, n), [s * bl for s in range(n)], bl, K,
                                 exchange.InProcess(n))

    def run_jax():
        mesh = Mesh(np.array(jax.devices()[:n]), ("shard",))
        jl = jparticles.ParticleLedger(**{k: jnp.asarray(v) for k, v in cols.items()})
        spec = jax.tree_util.tree_map(lambda _: P("shard"), jl)

        def core(p):
            offset = jax.lax.axis_index("shard") * bl
            out, dropped, n_sent = jspatial.migrate(p, offset, bl, n, K, "shard")
            return out, jnp.reshape(dropped, (1,)), jnp.reshape(n_sent, (1,))

        fn = jax.shard_map(core, mesh=mesh, in_specs=(spec,), out_specs=(spec, P("shard"),
                                                                        P("shard")),
                           check_vma=False)
        out, dropped, n_sent = jax.jit(fn)(jl)
        return ({k: np.asarray(getattr(out, k)) for k in FLOATS + INTS + BOOLS},
                np.asarray(dropped), np.asarray(n_sent))

    jout, jdrop, jsent = _jax(run_jax, wide)
    assert drop.tolist() == jdrop.tolist() and sent.tolist() == jsent.tolist()
    assert int(sent.sum()) > 0
    if K < 64:
        assert int(drop.sum()) > 0
    for f in dataclasses.fields(tl):
        got = getattr(tl, f.name).numpy()
        assert got.dtype == jout[f.name].dtype, f.name
        assert np.array_equal(got.view(np.uint8), jout[f.name].view(np.uint8)), f.name


def test_go_false_round_changes_nothing():
    """A round whose ``go`` is false sends nothing, receives nothing and leaves
    every column as it was (batches of rounds rely on it)."""
    n, cap_l, bl = 3, 500, 2
    rng = np.random.default_rng(5)
    tl = _torch(_ledger(n, n, cap_l, bl, 0, 0.8, np.float32, rng))
    before = tl.clone()
    drop, sent = spatial.migrate(split_ledger(tl, n), [s * bl for s in range(n)], bl, 64,
                                 exchange.InProcess(n), go=torch.tensor(False))
    assert drop.tolist() == [0] * n and sent.tolist() == [0] * n
    for f in dataclasses.fields(tl):
        assert torch.equal(getattr(tl, f.name), getattr(before, f.name)), f.name


def test_tile_plan_is_the_kernels():
    """MIGRATE_TILE and MIGRATE_THREADS, which size the kernel's scratch and drive
    the mirror above, are csrc/migrate_kernel.cu's kTile and kThreads, and the
    scratch is its ticket and a status word a tile and destination (the C entry
    refuses a smaller one)."""
    import pathlib
    import re

    src = (pathlib.Path(spatial.__file__).parents[1] / "csrc" / "migrate_kernel.cu").read_text()
    consts = dict(re.findall(r"constexpr int (kThreads|kItems) = (\d+);", src))
    assert int(consts["kThreads"]) == spatial.MIGRATE_THREADS
    assert int(consts["kThreads"]) * int(consts["kItems"]) == spatial.MIGRATE_TILE
    assert "constexpr int kTile = kThreads * kItems;" in src
    assert "const long long lt = (cap_l + kTile - 1) / kTile;" in src
    assert "scratch_len < 1 + m * lt * n)" in src
    tile = spatial.MIGRATE_TILE
    assert spatial.migrate_scratch_len(8, 81 * tile - 5, 8) == 1 + 8 * 81 * 8
    scratch = spatial.MigrateScratch()
    first = scratch.reserve(2, tile + 1, 2, "cpu")
    assert first.numel() == 1 + 2 * 2 * 2 and not bool(first.any())
    assert scratch.reserve(2, 2 * tile, 2, "cpu") is first  # large enough: kept
    grown = scratch.reserve(2, 2 * tile + 1, 2, "cpu")
    assert grown.numel() == 1 + 2 * 3 * 2 and scratch.tensors == [first, grown]
