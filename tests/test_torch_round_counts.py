"""The step's and the spatial round's counts (``ops/counts.py``) and the census's
round gate, on the CPU: each local shard's live and unfinished counts against
the JAX package's own expressions on the same ledgers (float32 and float64; 1, 3
and 8 shards; slots at tau == 1 exactly, dead slots short of census, an empty
shard), a round's bookkeeping against the JAX round loop's carry adds, and the
plain census gated by ``go``: false changes no column and counts nothing, on the
z route with the collapse's round trip and on the block route; true is bitwise
the ungated call."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaybenne_tpu import particles as jparticles
from jaybenne_tpu_torch.ops import counts, transport_kernel
from jaybenne_tpu_torch.parallel.sharding import split_ledger
from jaybenne_tpu_torch.particles import empty_ledger

CAP = 700  # slots a shard
DTYPES = {"f32": (torch.float32, np.float32), "f64": (torch.float64, np.float64)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ledger_arrays(m, np_dtype, seed):
    """Numpy alive and tau of ``m`` shards of CAP slots: 60 % alive; tau uniform in
    [0, 1.2), a tenth exactly 1, a tenth one ulp below 1 (short of census) and a
    tenth one ulp above; the last of several shards empty (every slot dead, some
    of them short of census)."""
    rng = np.random.default_rng(seed)
    n = m * CAP
    alive = rng.random(n) < 0.6
    tau = rng.uniform(0.0, 1.2, n).astype(np_dtype)
    pick = rng.integers(0, 10, n)
    one = np_dtype(1.0)
    tau[pick == 0] = one
    tau[pick == 1] = np.nextafter(one, np_dtype(0.0))
    tau[pick == 2] = np.nextafter(one, np_dtype(2.0))
    if m > 1:
        alive[(m - 1) * CAP:] = False
    return alive, tau


def _torch_shards(alive, tau, m, dtype):
    p = empty_ledger(m * CAP, dtype)
    p.alive.copy_(torch.from_numpy(alive))
    p.tau.copy_(torch.from_numpy(tau))
    return split_ledger(p, m) if m > 1 else [p]


def _jax_counts(alive, tau, m, np_dtype):
    """The JAX package's own expressions, shard by shard: ``ParticleLedger.
    num_alive`` (particles.py:78-79) and the spatial round's ``local_unfinished``
    (parallel/spatial.py:480-482)."""
    x64 = np_dtype == np.float64
    jax.config.update("jax_enable_x64", x64)
    try:
        live, short = [], []
        for s in range(m):
            sl = slice(s * CAP, (s + 1) * CAP)
            led = dataclasses.replace(jparticles.empty_ledger(CAP, jnp.asarray(tau).dtype),
                                      alive=jnp.asarray(alive[sl]), tau=jnp.asarray(tau[sl]))
            assert led.tau.dtype == np_dtype
            live.append(int(led.num_alive()))
            short.append(int(jnp.sum((led.alive & (led.tau < 1.0)).astype(jnp.int32),
                                     dtype=jnp.int32)))
        return live, short
    finally:
        if x64:
            jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_counts_match_jax(dtype, m):
    """Each shard's live and unfinished counts (``counts_plain``, and ``counts`` on
    the CPU) equal to the JAX package's on the same ledgers, and their totals the
    sum and max of the live counts and the sum of the unfinished ones."""
    tdtype, np_dtype = DTYPES[dtype]
    alive, tau = _ledger_arrays(m, np_dtype, seed=m + 10 * (dtype == "f64"))
    live, short = _jax_counts(alive, tau, m, np_dtype)
    shards = _torch_shards(alive, tau, m, tdtype)
    for per, totals in (counts.counts_plain(shards), counts.counts(shards)):
        assert per.dtype == totals.dtype == torch.int64 and per.shape == (2, m)
        assert per[0].tolist() == live and per[1].tolist() == short
        assert totals.tolist() == [sum(live), max(live), sum(short)]
    if m > 1:
        assert live[-1] == 0 and short[-1] == 0  # the empty shard
    assert 0 < sum(short) < sum(live)


def _acc(m):
    z = torch.zeros
    return types.SimpleNamespace(
        iters=torch.tensor(list(range(m)), dtype=torch.int32), events=z(m, dtype=torch.int64) + 5,
        hits=z(m, dtype=torch.int64), dropped=z(m, dtype=torch.int64) + 2,
        sent=z(m, dtype=torch.int64) + 3, rounds=torch.tensor(4, dtype=torch.int64),
        unfinished=torch.tensor(99, dtype=torch.int64))


@pytest.mark.parametrize("migrates", [True, False])
@pytest.mark.parametrize("go", [None, True, False])
def test_round_counts_are_the_jax_carry(go, migrates):
    """A spatial round's bookkeeping (``round_counts`` on the CPU) against the JAX
    round loop's carry (parallel/spatial.py:483-488): iterations, events, dropped
    and sent added, a cap hit where the census reached max_iters, the round counted
    by its flag, the unfinished count the shards' sum written afresh."""
    m, max_iters = 3, 40
    alive, tau = _ledger_arrays(m, np.float32, seed=5)
    shards = _torch_shards(alive, tau, m, torch.float32)
    _, short = _jax_counts(alive, tau, m, np.float32)
    acc = _acc(m)
    want = {k: v.clone() for k, v in vars(acc).items()}
    it = torch.tensor([3, max_iters, 7], dtype=torch.int32)
    ev = torch.tensor([30, 400, 0], dtype=torch.int64)
    drop = torch.tensor([1, 0, 2], dtype=torch.int64) if migrates else None
    sent = torch.tensor([6, 1, 0], dtype=torch.int64) if migrates else None
    flag = None if go is None else torch.tensor(go)
    counts.round_counts(shards, acc, it, ev, drop, sent, flag, max_iters)
    on = go is not False
    assert torch.equal(acc.iters, want["iters"] + it)
    assert torch.equal(acc.events, want["events"] + ev)
    assert acc.hits.tolist() == [0, int(on), 0]
    if migrates:
        assert torch.equal(acc.dropped, want["dropped"] + drop)
        assert torch.equal(acc.sent, want["sent"] + sent)
    else:
        assert torch.equal(acc.dropped, want["dropped"]) and torch.equal(acc.sent, want["sent"])
    assert int(acc.rounds) == 4 + int(on)
    assert int(acc.unfinished) == sum(short)


def _columns(p) -> dict:
    return {f.name: getattr(p, f.name).clone() for f in dataclasses.fields(p)}


def _bitwise(a: dict, b: dict):
    for k in a:
        assert torch.equal(a[k].view(torch.uint8) if a[k].is_floating_point() else a[k],
                           b[k].view(torch.uint8) if b[k].is_floating_point() else b[k]), k


@pytest.mark.parametrize("route", ["z", "blocks"])
def test_gated_census_changes_nothing(route):
    """The plain census over 8 shards' slices (tests/test_torch_schedule.py's
    round) with ``go`` false: every column bitwise as it was, no iteration and no
    event counted, ``lane_events`` untouched (on the z route the call runs the
    collapse to one block and back, which the gate undoes); with ``go`` true
    bitwise the ungated call."""
    from test_torch_schedule import N_SHARDS, shard_case

    p0, coefs, mesh, seeds, prm, dt, owns = shard_case(route, 96)
    assert (route == "z") == (mesh.n_blocks > 1 and mesh.max_level == 0)
    runs = {}
    for go in (None, True, False):
        p = p0.clone()
        lanes = torch.full((p.capacity,), -1, dtype=torch.int32)
        flag = None if go is None else torch.tensor(go)
        _, it, ev = transport_kernel.transport_plain(split_ledger(p, N_SHARDS), coefs, mesh,
                                                     seeds, prm, dt, owns, lane_events=lanes,
                                                     go=flag)
        runs[go] = (_columns(p), it, ev, lanes)
    cols, it, ev, lanes = runs[False]
    _bitwise(cols, _columns(p0))
    assert not bool(it.any()) and not bool(ev.any()) and bool((lanes == -1).all())
    assert it.dtype == runs[None][1].dtype and ev.dtype == runs[None][2].dtype
    _bitwise(runs[True][0], runs[None][0])
    for a, b in zip(runs[True][1:], runs[None][1:]):
        assert torch.equal(a, b)
    assert int(runs[None][2].sum()) > 0
