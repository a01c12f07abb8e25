"""The spatial migration's sort and pack by scans on the CPU: a mirror in PyTorch
of the migration kernel's tile plan (``csrc/migrate_kernel.cu``: a tile's
in-transit slots counted by destination, the counts of the earlier tiles of its
slice added, and each slot ranked in rounds of consecutive slots by its warp's
lanes of the same destination and the lower warps' counts) against the plain
version's stable sort (``spatial.migration_map``, ``pack_plain``): the same
destinations, ranks, rows, sent slots and counts, over 2, 3 and 8 shards, with K
overflowing, ``go`` false, float64 columns (the pad word), empty shards and
slices of several tiles; and the port's plain ``migrate`` against the JAX
package's (``jaybenne_tpu/parallel/spatial.py::migrate`` under ``shard_map`` on
the host's CPU devices) on the same ledgers: every column bitwise, the counts
equal."""

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
from jaybenne_tpu_torch.particles import ParticleLedger

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


def mirror_plan(joined, m, n, cap_l, bl, off0, K, go=True):
    """The migration kernel's plan, thread by thread (vectorised): the count
    launch's per-tile counts by destination, then the pack launch's ranks, each
    the counts of the earlier tiles of its slice, of the earlier rounds of its
    tile, of the lower warps in its round and of the lower lanes of its warp with
    its destination. Returns (dest, rank) of every slot (dest n where it is not in
    transit), each slice's in-transit totals by destination and its sent count,
    and the pack launch's tiles' shares of the empty rows' valid words."""
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
    counts = onehot.sum(dim=(2, 3, 4))  # the count launch: [m, lt, n]
    before_tile = counts.cumsum(1) - counts
    tot = counts.sum(1)
    warp = onehot.sum(4)  # a round's slots of each warp by destination
    per_round = warp.sum(3)
    before_round = per_round.cumsum(2) - per_round
    lower_warps = warp.cumsum(3) - warp
    lower_lanes = onehot.cumsum(4) - onehot  # popc(match_any & lanes below)
    ranks = (before_tile[:, :, None, None, None] + before_round[:, :, :, None, None]
             + lower_warps[..., None, :] + lower_lanes)
    rank = ranks.gather(-1, pad.clamp(max=n - 1).view(m, lt, ITEMS, WARPS, 32, 1))
    rank = rank.view(m, -1)[:, :cap_l]
    sent = torch.minimum(tot, torch.tensor(K)).sum(1)
    rows = n * K
    chunk = -(-rows // lt)
    shares = [(j * chunk, min(rows, (j + 1) * chunk)) for j in range(lt)]
    return dest, rank, tot, sent, shares


def mirror_rows(joined, m, n, cap_l, K, dest, rank, words):
    """The rows the pack launch writes, from the plan (``mirror_plan``): each
    in-transit slot of rank below K puts its columns' int32 words (a float64
    column's low word first), a zero pad and the valid word 1 into row rank of
    its destination's buffer; every other row's valid word is 0 (its other words
    here 0). Returns the [m, n, K, words] buffers and the slots sent."""
    buf = torch.zeros((m, n, K, words), dtype=torch.int32)
    sent = torch.zeros(m * cap_l, dtype=torch.bool)
    for s in range(m):
        for e in range(cap_l):
            d, r = int(dest[s, e]), int(rank[s, e])
            if d == n or r >= K:
                continue
            q, w = s * cap_l + e, 0
            for name in spatial.MIGRATE_FIELDS:
                col = getattr(joined, name)
                for word in col[q:q + 1].view(torch.int32).tolist():
                    buf[s, d, r, w] = word
                    w += 1
            buf[s, d, r, words - 1] = 1
            sent[q] = True
    return buf, sent


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
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_plan_is_the_stable_sort(case):
    """The mirror of the kernel's plan gives every slot the destination and rank
    of the plain version's stable sort, the same sent slots and counts, and
    ``pack_plain``'s rows; its tiles' shares of the empty rows cover each row
    once."""
    m, n, cap_l, bl, off0, K, share, empty, wide, go = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    dtype = np.float64 if wide else np.float32
    joined = _torch(_ledger(m, n, cap_l, bl, off0, share, dtype, rng, empty))
    dest, rank, tot, sent, shares = mirror_plan(joined, m, n, cap_l, bl, off0, K, go)
    flag = torch.tensor(go)
    for s, p in enumerate(split_ledger(joined, m)):
        src, plain_sent = spatial.migration_map(p, off0 + s * bl, bl, n, K, flag)
        want = torch.full((n * K,), cap_l, dtype=torch.int64)
        ok = (dest[s] < n) & (rank[s] < K)
        want[dest[s][ok] * K + rank[s][ok]] = torch.nonzero(ok).flatten()
        assert torch.equal(src, want)
        assert torch.equal(plain_sent, ok)
        assert int(sent[s]) == int(ok.sum())
    covered = torch.zeros(n * K, dtype=torch.int64)
    for a, b in shares:
        covered[a:b] += 1
    assert bool((covered == 1).all())
    words = spatial.row_words(joined)
    assert words == (26 if wide else 16)
    want_buf, want_sent = mirror_rows(joined, m, n, cap_l, K, dest, rank, words)
    q = joined.clone()
    bufs, plain_counts = spatial.pack_plain(split_ledger(q, m), [off0 + s * bl for s in range(m)],
                                            bl, K, n, flag)
    assert torch.equal(torch.stack(bufs), want_buf)
    assert torch.equal(plain_counts, sent)
    assert torch.equal(q.alive, joined.alive & ~want_sent)
    if not go or case == "all_empty":
        assert int(sent.sum()) == 0 and bool((torch.stack(bufs) == 0).all())
    if "overflow" in case:
        assert bool((tot > K).any())
    if empty:
        assert all(int(sent[s]) == 0 for s in empty)


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
    the mirror above, are csrc/migrate_kernel.cu's kTile and kThreads (the C entry
    also refuses a scratch of another size)."""
    import pathlib
    import re

    src = (pathlib.Path(spatial.__file__).parents[1] / "csrc" / "migrate_kernel.cu").read_text()
    consts = dict(re.findall(r"constexpr int (kThreads|kItems) = (\d+);", src))
    assert int(consts["kThreads"]) == spatial.MIGRATE_THREADS
    assert int(consts["kThreads"]) * int(consts["kItems"]) == spatial.MIGRATE_TILE
    assert "constexpr int kTile = kThreads * kItems;" in src
    assert "scratch_len != m * ((cap_l + kTile - 1) / kTile) * n" in src
