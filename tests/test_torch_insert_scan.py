"""The ledger insert by scans (``particles.insert_destinations``, the plain
version of ``csrc/insert_kernel.cu``) on the CPU: each valid candidate's
destination and the dropped count bitwise equal to the JAX package's insert
(``jaybenne_tpu.particles.insert_particles``, a stable free-first argsort), to
that argsort map written in PyTorch, and to an independent count in numpy; and
the one-pass insert of a migration round's arrivals over eight adjacent shard
slices (``particles.insert_arrivals``) equal to eight inserts of the JAX package,
a shard's drops its own."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaybenne_tpu import particles as jparticles
from jaybenne_tpu_torch.parallel import sharding
from jaybenne_tpu_torch.particles import (ParticleLedger, insert_arrivals, insert_destinations,
                                          insert_particles)

FLOATS = ("x", "y", "z", "vx", "vy", "vz", "tau", "weight", "energy")
INTS = ("block", "i", "j", "k", "face", "leak")
BOOLS = ("alive", "absorbed")


def _columns(cap, alive_share, dtype, rng):
    cols = {k: rng.standard_normal(cap).astype(dtype) for k in FLOATS}
    cols.update({k: rng.integers(-3, 9, cap).astype(np.int32) for k in INTS})
    cols.update(alive=rng.random(cap) < alive_share, absorbed=rng.random(cap) < 0.2)
    return cols


def _jax(fn, wide):
    """``fn()`` with the JAX package in float64 where ``wide``."""
    if not wide:
        return fn()
    jax.config.update("jax_enable_x64", True)
    try:
        return fn()
    finally:
        jax.config.update("jax_enable_x64", False)


def _numpy_map(occupied, valid):
    """The destination of each candidate (len(occupied) where not written) and the
    dropped count, by numpy indexing alone."""
    free = np.flatnonzero(~occupied)
    want = np.flatnonzero(valid)
    dest = np.full(valid.size, occupied.size, np.int64)
    n = min(free.size, want.size)
    dest[want[:n]] = free[:n]
    return dest, want.size - n


def _argsort_map(ledger, valid, reserved):
    """The insert's destinations as the parent of the scan computed them: the
    ranks' cumsum and a stable free-first argsort of the ledger."""
    cap = ledger.capacity
    vflat = valid.reshape(-1)
    rank = torch.cumsum(vflat.to(torch.int64), 0) - 1
    occupied = ledger.alive if reserved is None else ledger.alive | reserved
    order = torch.argsort(occupied.to(torch.uint8), stable=True)
    ok = vflat & (rank < cap - occupied.sum())
    return torch.where(ok, order[rank.clamp(0, max(cap - 1, 0))], cap), vflat.sum() - ok.sum()


CASES = {  # alive share, valid share, reserved, candidate strides, float64
    "empty_ledger": (0.0, 0.5, False, "k1", False),
    "full_ledger_all_dropped": (1.0, 1.0, False, "k1", False),
    "reserved": (0.3, 0.5, True, "k1", False),
    "valid_none": (0.3, 0.0, False, "k1", False),
    "valid_all": (0.3, 1.0, True, "k1", False),
    "broadcast_1_0": (0.5, 0.5, False, "b10", False),
    "f64": (0.4, 0.5, True, "k1", True),
    "f64_broadcast_overflow": (0.9, 1.0, False, "b10", True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_scan_destinations_match_jax_argsort_and_numpy(case):
    """Every column and ``n_dropped`` bitwise the JAX package's insert; the
    destinations and drops those of the parent's argsort map and of numpy."""
    alive_share, valid_share, reserved, strides, wide = CASES[case]
    dtype = np.float64 if wide else np.float32
    rng = np.random.default_rng(sorted(CASES).index(case))
    cap, shape = 300, (40, 5)
    cols = _columns(cap, alive_share, dtype, rng)
    names = FLOATS + ("block", "i", "j", "k") + (("face", "leak") if reserved else ())
    cand = {}
    for k in names:
        if strides == "b10":  # one value a row, broadcast along its candidates
            v = (rng.standard_normal((shape[0], 1)).astype(dtype) if k in FLOATS
                 else rng.integers(0, 7, (shape[0], 1)).astype(np.int32))
            cand[k] = np.broadcast_to(v, shape)
        else:
            cand[k] = (rng.standard_normal(shape).astype(dtype) if k in FLOATS
                       else rng.integers(0, 7, shape).astype(np.int32))
    valid = rng.random(shape) < valid_share

    tl = ParticleLedger(**{k: torch.from_numpy(v.copy()) for k, v in cols.items()})
    tres = tl.absorbed.clone() if reserved else None
    tcand = {k: torch.from_numpy(v) if v.flags.writeable
             else torch.from_numpy(np.array(v[:, :1])).expand(shape)
             for k, v in cand.items()}
    if strides == "b10":
        assert all(t.stride() == (1, 0) for t in tcand.values())
    tvalid = torch.from_numpy(valid)
    dest, drop = insert_destinations(tl, tvalid, tres)
    old_dest, old_drop = _argsort_map(tl, tvalid, tres)
    occupied = cols["alive"] | (cols["absorbed"] if reserved else False)
    np_dest, np_drop = _numpy_map(occupied, valid.reshape(-1))
    assert torch.equal(dest, old_dest) and int(drop) == int(old_drop)
    assert np.array_equal(dest.numpy(), np_dest) and int(drop) == np_drop
    if case == "full_ledger_all_dropped":
        assert np_drop == valid.size
    tout, tdrop = insert_particles(tl, tcand, tvalid, reserved=tres)

    def run_jax():
        jl = jparticles.ParticleLedger(**{k: jnp.asarray(v) for k, v in cols.items()})
        out, n = jparticles.insert_particles(
            jl, {k: jnp.asarray(np.ascontiguousarray(v)) for k, v in cand.items()},
            jnp.asarray(valid), reserved=jl.absorbed if reserved else None)
        return {k: np.asarray(getattr(out, k)) for k in FLOATS + INTS + BOOLS}, int(n)

    jout, jdrop = _jax(run_jax, wide)
    assert int(tdrop) == jdrop == np_drop
    for k in FLOATS + INTS + BOOLS:
        got = getattr(tout, k).numpy()
        assert got.dtype == jout[k].dtype, k
        assert np.array_equal(got.view(np.uint8), jout[k].view(np.uint8)), k


@pytest.mark.parametrize("wide", [False, True], ids=["f32", "f64"])
def test_eight_shards_in_one_pass(wide):
    """A migration round's arrivals into eight adjacent slices of one ledger in one
    call, its candidates strided views of one buffer of int32 words and its valid
    flags the last word (as ``spatial.migrate`` hands them over): every slice and
    each shard's drop count equal to the JAX package's insert of that shard's part
    into that slice, with its absorbed rows reserved; some shards overflow."""
    rng = np.random.default_rng(8 + wide)
    m, cap_l, nc = 8, 40, 24
    dtype = np.float64 if wide else np.float32
    cols = _columns(m * cap_l, 0.0, dtype, rng)
    for s in range(m):  # a different fill a shard: shard 7 has 4 free slots
        cols["alive"][s * cap_l:(s + 1) * cap_l] = rng.random(cap_l) < (0.1 + 0.1 * s)
    cols["alive"][7 * cap_l:8 * cap_l] = True
    cols["alive"][7 * cap_l:7 * cap_l + 4] = False
    whole = ParticleLedger(**{k: torch.from_numpy(v.copy()) for k, v in cols.items()})
    ledgers = sharding.split_ledger(whole, m)
    names = FLOATS + ("block", "i", "j", "k", "face", "leak")
    vals = {k: (rng.standard_normal(m * nc).astype(dtype) if k in FLOATS
                else rng.integers(0, 7, m * nc).astype(np.int32)) for k in names}
    valid = rng.random(m * nc) < 0.6
    valid[5 * nc:6 * nc] = False  # a shard that receives nothing
    # the round's buffer: a row of words a candidate, an even count, valid last
    words = [torch.from_numpy(vals[k]).view(torch.int32).reshape(m * nc, -1) for k in names]
    if wide:
        words.append(torch.zeros(m * nc, 1, dtype=torch.int32))
    words.append(torch.from_numpy(valid.astype(np.int32))[:, None])
    buf = torch.cat(words, dim=1)
    cand, c = {}, 0
    for k in names:
        dt = torch.float64 if wide and k in FLOATS else (
            torch.float32 if k in FLOATS else torch.int32)
        w = dt.itemsize // 4
        cand[k] = buf[:, c:c + w].view(dt)[:, 0]
        c += w
    drops = insert_arrivals(ledgers, cand, buf[:, -1])
    assert drops.dtype == torch.int64 and drops.shape == (m,)

    def run_jax():
        outs = []
        for s in range(m):
            sl = slice(s * cap_l, (s + 1) * cap_l)
            jl = jparticles.ParticleLedger(**{k: jnp.asarray(v[sl]) for k, v in cols.items()})
            out, n = jparticles.insert_particles(
                jl, {k: jnp.asarray(vals[k][s * nc:(s + 1) * nc]) for k in names},
                jnp.asarray(valid[s * nc:(s + 1) * nc]), reserved=jl.absorbed)
            outs.append(({k: np.asarray(getattr(out, k)) for k in FLOATS + INTS + BOOLS}, int(n)))
        return outs

    want = _jax(run_jax, wide)
    for s in range(m):
        sl = slice(s * cap_l, (s + 1) * cap_l)
        occupied = cols["alive"][sl] | cols["absorbed"][sl]
        _, np_drop = _numpy_map(occupied, valid[s * nc:(s + 1) * nc])
        assert int(drops[s]) == want[s][1] == np_drop, s
        for k in FLOATS + INTS + BOOLS:
            got = getattr(whole, k)[sl].numpy()
            assert np.array_equal(got.view(np.uint8), want[s][0][k].view(np.uint8)), (s, k)
    assert int(drops[7]) > 0 and int(drops[5]) == 0

