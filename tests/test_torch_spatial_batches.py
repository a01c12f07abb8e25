"""The spatial step's rounds in batches, on the CPU: a round over a ledger with
nothing unfinished writes nothing and counts nothing (the census, the migration
and the subface fixup, and a round gated off by its device flag on every route);
batches of 3 and 8 rounds give the step of one round a batch, bitwise, with one
host read a batch; a restore keeps every shard's tensors."""

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
# the 2-shard SMR+DDMC deck of tests/test_torch_sync_free.py (the block route,
# K4s, pending coarse-to-fine leaks), and 8 shards of a uniform 3D mesh, each a z
# plane of 2x2 blocks (the z route, K3s, whose census gives every slot the
# collapse's round trip)
DECKS = {
    "smr_ddmc_2": ("stepdiff_smr_ddmc.in",
                   {"parthenon/mesh/nx1": 32, "parthenon/mesh/nx2": 16,
                    "parthenon/meshblock/nx1": 8, "parthenon/meshblock/nx2": 8,
                    "jaybenne/num_particles": 3000, "jaybenne/dt": "1.e-11",
                    "jaybenne/n_devices": 2}),
    "uniform_8": ("stepdiff.in",
                  {"parthenon/mesh/nx1": 8, "parthenon/mesh/nx2": 8, "parthenon/mesh/nx3": 32,
                   "parthenon/mesh/ix2_bc": "periodic", "parthenon/mesh/ox2_bc": "periodic",
                   "parthenon/mesh/ix3_bc": "periodic", "parthenon/mesh/ox3_bc": "periodic",
                   "parthenon/meshblock/nx1": 4, "parthenon/meshblock/nx2": 4,
                   "parthenon/meshblock/nx3": 4, "jaybenne/num_particles": 4000,
                   "jaybenne/dt": "1.e-11", "mcblock/scattering_constant_value": 100,
                   "jaybenne/n_devices": 8}),
}
ROUTES = {"smr_ddmc_2": "blocks", "uniform_8": "z"}
STEPS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sim(name, tmp, rounds_per_batch=None):
    deck, mods = DECKS[name]
    cfg = tcm.from_deck(Deck.from_file(os.path.join(_ROOT, "inputs", deck)).update(
        {**mods, "jaybenne/decomposition": "spatial", "parthenon/output0/file_type": "none"}))
    return Simulation(cfg, outdir=tmp, quiet=True, device="cpu",
                      rounds_per_batch=rounds_per_batch)


def _columns(sim) -> dict:
    p = sim.state.particles
    return {f.name: getattr(p, f.name).clone() for f in dataclasses.fields(p)}


def _counters(t) -> dict:
    return {k: getattr(t, k).clone() for k in ("iters", "events", "hits", "dropped", "sent",
                                               "rounds", "unfinished")}


def _same(a: dict, b: dict, what):
    for k in a:
        assert torch.equal(a[k], b[k]), (what, k)


@pytest.mark.parametrize("name", sorted(DECKS))
def test_a_round_with_nothing_unfinished_changes_nothing(name):
    """After a step's rounds (nothing unfinished), one more round gated off by its
    flag leaves every ledger column and counter as it was. On the block route an
    ungated round does too: its census, migration and fixup find no particle to
    move, and it adds only to the round count; on the z route the census's round
    trip of the collapse is what the gate puts back."""
    with tempfile.TemporaryDirectory() as tmp:
        sim = _sim(name, tmp)
        step = spatial.build_spatial_step_core(sim.mesh, sim.cfg, sim.exchange, 1)
        states, dt = sim.shards, sim.cfg.jaybenne.dt
        assert spatial.owned_range(sim.mesh, spatial.make_transport_params(
            sim.cfg, sim.cfg.jaybenne.dtype), sim.exchange.n, 0).kind == ROUTES[name]
        step.prologue(states, dt)
        t = step.head(states, dt)
        step.run_rounds(states, t.unfinished, lambda nr: step.batch(states, t, nr, dt))
        assert int(t.unfinished) == 0 and int(t.rounds) > 1 and int(t.sent.sum()) > 0
        ps = [st.particles for st in states]
        cols, counts = _columns(sim), _counters(t)
        step.round_prologue(states, step.rounds_run, 1)
        step.one_round(ps, t, 0, torch.tensor(False), dt)
        _same(cols, _columns(sim), "gated round: ledger")
        _same(counts, _counters(t), "gated round: counters")
        if ROUTES[name] == "blocks":
            step.one_round(ps, t, 0, None, dt)
            _same(cols, _columns(sim), "ungated round: ledger")
            counts["rounds"] += 1
            _same(counts, _counters(t), "ungated round: counters")


@pytest.mark.parametrize("name", sorted(DECKS))
def test_batches_repeat_one_round_a_batch(name, monkeypatch):
    """Two steps with 1, 3 and 8 rounds a batch: every ledger column, every field of
    every shard and every ``StepStats`` counter bitwise equal after each step,
    one host read a batch (``ceil(rounds / R)``) and ``R`` rounds queued a batch."""
    reads = []
    real = spatial._exit_read
    monkeypatch.setattr(spatial, "_exit_read", lambda u: reads.append(1) or real(u))
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for R in (1, 3, 8):
            sim = _sim(name, tmp, R)
            out = []
            for _ in range(STEPS):
                k = len(reads)
                shards, stats = sim.step_fn(sim.shards, sim.cfg.jaybenne.dt)
                sim.shards = shards
                counts = dict(zip(STAT_NAMES, stats.packed.tolist()))
                batches = len(reads) - k
                assert batches == -(-counts["migration_rounds"] // R), (R, counts)
                out.append((counts, _columns(sim),
                            [{f.name: getattr(st.fields, f.name).clone()
                              for f in dataclasses.fields(st.fields)} for st in shards]))
            assert sim.step_fn.rounds_run == R * sum(
                -(-o[0]["migration_rounds"] // R) for o in out)
            runs[R] = out
    for R in (3, 8):
        for k, (a, b) in enumerate(zip(runs[1], runs[R])):
            assert a[0] == b[0], (R, k)
            _same(a[1], b[1], (R, k, "ledger"))
            for fa, fb in zip(a[2], b[2]):
                _same(fa, fb, (R, k, "fields"))
    # some step runs more rounds than a batch of 3 holds, and migrates
    assert max(o[0]["migration_rounds"] for o in runs[1]) > 3
    assert all(o[0]["migrated"] > 0 for o in runs[1])


def test_restore_keeps_the_shards_tensors():
    """``Simulation.restore`` copies a snapshot into every shard's own tensors
    (the spatial step's CUDA graphs hold their addresses): the restored run
    repeats the snapshot's steps bitwise, on the same tensor objects."""
    with tempfile.TemporaryDirectory() as tmp:
        sim = _sim("smr_ddmc_2", tmp)
        snap = sim.snapshot()
        sim.run(nlim=2)
        first = [{k: v for k, v in h.items() if k != "step_seconds"} for h in sim.history]
        after = _columns(sim)
        ids = [id(t) for st in sim.shards for t in (st.fields.energy_tally, st.particles.x)]
        sim.restore(snap)
        assert (sim.t, sim.cycle) == (0.0, 0)
        assert [id(t) for st in sim.shards
                for t in (st.fields.energy_tally, st.particles.x)] == ids
        sim.run(nlim=2)
        again = [{k: v for k, v in h.items() if k != "step_seconds"} for h in sim.history[2:]]
        assert again == first
        _same(after, _columns(sim), "restored run")
