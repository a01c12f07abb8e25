"""The spatial step's batches queued one ahead of the host's exit read, on the
CPU: ``run_rounds`` with ``step.ahead = True``, driven with an injected batch and
each count read from its own copy (``spatial._CountRead``), gives bitwise the
states and counters of the loop that reads each batch before it queues the next
(``ahead = False``), at 1, 3 and 8 rounds a batch, with the same host reads; a step
never queues a round past ``max_migration_rounds``, even where the cap cuts the
step short."""

import dataclasses
import os
import tempfile

import pytest
import torch

from jaybenne_tpu_torch import config as tcm
from jaybenne_tpu_torch.driver import Simulation
from jaybenne_tpu_torch.parallel import spatial
from jaybenne_tpu_torch.step import STAT_NAMES
from jaybenne_tpu_torch.utils.deck import Deck

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the 2-shard SMR+DDMC deck of tests/test_torch_spatial_batches.py: the block
# route, its fixup generators and pending coarse-to-fine leaks
DECK = ("stepdiff_smr_ddmc.in",
        {"parthenon/mesh/nx1": 32, "parthenon/mesh/nx2": 16, "parthenon/meshblock/nx1": 8,
         "parthenon/meshblock/nx2": 8, "jaybenne/num_particles": 3000, "jaybenne/dt": "1.e-11",
         "jaybenne/n_devices": 2, "jaybenne/decomposition": "spatial",
         "parthenon/output0/file_type": "none"})
STEPS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(tmp, rounds_per_batch, ahead, max_rounds=None):
    """``STEPS`` steps of DECK driven by hand (prologue, head, ``run_rounds`` with a
    batch that records its length, tail), with the next batch queued before a
    batch's read where ``ahead``. Returns, a step, (the StepStats counters, the rounds queued, every
    ledger column, every shard's fields)."""
    deck, mods = DECK
    if max_rounds is not None:
        mods = {**mods, "jaybenne/max_migration_rounds": max_rounds}
    cfg = tcm.from_deck(Deck.from_file(os.path.join(_ROOT, "inputs", deck)).update(mods))
    sim = Simulation(cfg, outdir=tmp, quiet=True, device="cpu")
    step = spatial.build_spatial_step_core(sim.mesh, cfg, sim.exchange, rounds_per_batch)
    assert step.ahead is False  # the CPU's own choice
    step.ahead = ahead
    states, dt, out = sim.shards, cfg.jaybenne.dt, []
    for _ in range(STEPS):
        queued = []

        def run_batch(nr):
            queued.append(nr)
            step.batch(states, t, nr, dt)

        step.prologue(states, dt)
        t = step.head(states, dt)
        step.run_rounds(states, t.unfinished, run_batch)
        states, stats = step.tail(states, t, dt)
        p = sim._ledger
        out.append((dict(zip(STAT_NAMES, stats.packed.tolist())), sum(queued),
                    {f.name: getattr(p, f.name).clone() for f in dataclasses.fields(p)},
                    [{f.name: getattr(st.fields, f.name).clone()
                      for f in dataclasses.fields(st.fields)} for st in states]))
    return out, step.rounds_run


def _same(a, b, what):
    for (ca, qa, la, fa), (cb, qb, lb, fb) in zip(a, b):
        assert ca == cb, (what, ca, cb)
        for k in la:
            assert torch.equal(la[k], lb[k]), (what, "ledger", k)
        for x, y in zip(fa, fb):
            for k in x:
                assert torch.equal(x[k], y[k]), (what, "fields", k)


@pytest.fixture
def counted_reads(monkeypatch):
    reads = []
    real = spatial._exit_read
    monkeypatch.setattr(spatial, "_exit_read",
                        lambda count: reads.append(type(count).__name__) or real(count))
    return reads


@pytest.mark.parametrize("rounds_per_batch", [1, 3, 8])
def test_one_batch_ahead_repeats_the_loop(rounds_per_batch, counted_reads):
    """Two steps at ``rounds_per_batch`` rounds a batch, reading each batch before
    queueing the next and one batch ahead: the counters, every ledger column and
    every shard's field bitwise equal after each step; the same number of host
    reads (one a batch with work, ``ceil(rounds / R)``), one ahead of a read of its
    own copy; at most one more batch queued a step, and never past the cap."""
    R = rounds_per_batch
    with tempfile.TemporaryDirectory() as tmp:
        today, run_today = _run(tmp, R, False)
        n_today = len(counted_reads)
        ahead, run_ahead = _run(tmp, R, True)
    reads_ahead = counted_reads[n_today:]
    _same(today, ahead, R)
    batches = sum(-(-c["migration_rounds"] // R) for c, *_ in today)
    assert counted_reads[:n_today] == ["Tensor"] * batches
    assert reads_ahead == ["_CountRead"] * batches
    max_rounds = 128
    for (c, q_today, *_), (_, q_ahead, *_) in zip(today, ahead):
        assert c["migration_rounds"] >= 2 and c["unfinished"] == 0
        assert q_today == R * -(-c["migration_rounds"] // R)
        assert q_ahead == min(q_today + R, max_rounds)
    assert run_today == sum(q for _, q, *_ in today) and run_ahead == sum(q for _, q, *_ in ahead)


def test_never_past_max_rounds():
    """A cap of 5 rounds at 3 rounds a batch, where the first step needs 3 rounds
    and the second more than 5: one batch ahead, each step queues a batch of 3
    and one cut to 2 and no more; the second stops at the cap with particles
    unfinished, as the loop that reads each batch first does, bitwise alike."""
    with tempfile.TemporaryDirectory() as tmp:
        today, _ = _run(tmp, 3, False, max_rounds=5)
        ahead, _ = _run(tmp, 3, True, max_rounds=5)
    _same(today, ahead, "cap")
    (c1, q1, *_), (c2, q2, *_) = today
    assert (c1["migration_rounds"], c1["unfinished"], q1) == (3, 0, 3), c1
    assert c2["migration_rounds"] == 5 and c2["unfinished"] > 0 and q2 == 5, c2
    assert [q for _, q, *_ in ahead] == [5, 5]
