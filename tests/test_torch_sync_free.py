"""The step without host synchronisation, on the CPU: the static-shape insert
against the JAX package's, bitwise; no host read of a tensor inside a step (the
plain census's own exit test aside), and one read a round under the spatial
decomposition; the driver's history and overflow on a deck that overflows.

A GPU run proves the CUDA graph and the card's own synchronisations
(``chip_smoke.py`` phase 45); the CPU runs the eager step, whose host reads these
tests count."""

import contextlib
import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaybenne_tpu import particles as jparticles

from jaybenne_tpu_torch import config as tcm
from jaybenne_tpu_torch import particles as particles_mod
from jaybenne_tpu_torch.driver import Simulation
from jaybenne_tpu_torch.ops import transport_kernel
from jaybenne_tpu_torch.parallel import spatial
from jaybenne_tpu_torch.particles import ParticleLedger, insert_particles
from jaybenne_tpu_torch.utils.deck import Deck

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPDIFF = os.path.join(_ROOT, "inputs", "stepdiff.in")
STEPDIFF_DDMC = os.path.join(_ROOT, "inputs", "stepdiff_ddmc.in")
SMR_DDMC = os.path.join(_ROOT, "inputs", "stepdiff_smr_ddmc.in")

FLOATS = ("x", "y", "z", "vx", "vy", "vz", "tau", "weight", "energy")
INTS = ("block", "i", "j", "k", "face", "leak")
BOOLS = ("alive", "absorbed")


def _ledgers(cap, n_alive, seed):
    """The same ledger for both packages (numpy columns from ``seed``), its first
    ``n_alive`` slots of a random order alive."""
    rng = np.random.default_rng(seed)
    cols = {k: rng.standard_normal(cap).astype(np.float32) for k in FLOATS}
    cols.update({k: rng.integers(-3, 9, cap).astype(np.int32) for k in INTS})
    alive = np.zeros(cap, bool)
    alive[rng.permutation(cap)[:n_alive]] = True
    cols.update(alive=alive, absorbed=rng.random(cap) < 0.2)
    jl = jparticles.ParticleLedger(**{k: jnp.asarray(v) for k, v in cols.items()})
    tl = ParticleLedger(**{k: torch.from_numpy(v.copy()) for k, v in cols.items()})
    return jl, tl, rng


@pytest.mark.parametrize("reserved", [False, True], ids=["no_reserved", "reserved"])
@pytest.mark.parametrize("room", ["room", "overflow", "none_valid"])
def test_static_insert_matches_jax(reserved, room):
    """The port's insert against ``jaybenne_tpu.particles.insert_particles`` on the
    same ledger and candidates: every column and ``n_dropped`` bitwise. With
    ``reserved`` the dead absorbed rows are kept (the spatial census's arrivals),
    and the candidates carry ``face`` and ``leak`` as migration's do."""
    cap, shape = 96, (16, 3)
    n_alive = {"room": 30, "overflow": 84, "none_valid": 30}[room]
    seed = 10 * int(reserved) + ("room", "overflow", "none_valid").index(room)
    jl, tl, rng = _ledgers(cap, n_alive, seed)
    names = FLOATS + ("block", "i", "j", "k") + (("face", "leak") if reserved else ())
    cand = {}
    for k in names:
        v = (rng.standard_normal(shape).astype(np.float32) if k in FLOATS
             else rng.integers(0, 7, shape).astype(np.int32))
        cand[k] = v
    valid = rng.random(shape) < (0.0 if room == "none_valid" else 0.6)
    res_j = jl.absorbed if reserved else None
    res_t = tl.absorbed.clone() if reserved else None
    jout, jdrop = jparticles.insert_particles(
        jl, {k: jnp.asarray(v) for k, v in cand.items()}, jnp.asarray(valid), reserved=res_j)
    tout, tdrop = insert_particles(tl, {k: torch.from_numpy(v) for k, v in cand.items()},
                                   torch.from_numpy(valid), reserved=res_t)
    assert isinstance(tdrop, torch.Tensor)
    assert int(tdrop) == int(jdrop)
    if room == "overflow":
        assert int(tdrop) > 0
    if room == "room":
        assert int(tdrop) == 0 and int(valid.sum()) > 0
    for k in FLOATS + INTS + BOOLS:
        want = np.asarray(getattr(jout, k))
        got = getattr(tout, k).numpy()
        assert got.dtype == want.dtype, k
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), k


@contextlib.contextmanager
def host_reads(reads=None):
    """While active, a host read of a tensor (``item``, ``int``, ``bool``,
    ``float``, ``tolist``) raises, or with a list ``reads`` is appended to it;
    reads inside the plain census (``transport_kernel._census_plain``, whose loop
    reads its exit test on the CPU by design) are let through."""
    names = ("item", "__int__", "__bool__", "__float__", "tolist")
    saved = {n: getattr(torch.Tensor, n) for n in names}
    plain = transport_kernel._census_plain
    inside = [0]

    def census(*args, **kw):
        inside[0] += 1
        try:
            return plain(*args, **kw)
        finally:
            inside[0] -= 1

    def guarded(name):
        real = saved[name]

        def read(self, *args, **kw):
            if not inside[0]:
                if reads is None:
                    raise AssertionError(f"a host read (Tensor.{name}) inside a step")
                reads.append(name)
            return real(self, *args, **kw)
        return read

    for n in names:
        setattr(torch.Tensor, n, guarded(n))
    transport_kernel._census_plain = census
    try:
        yield
    finally:
        for n in names:
            setattr(torch.Tensor, n, saved[n])
        transport_kernel._census_plain = plain


def _sim(deck, mods, tmp):
    cfg = tcm.from_deck(Deck.from_file(deck).update(
        {"parthenon/output0/file_type": "none", **mods}))
    return Simulation(cfg, outdir=tmp, quiet=True, device="cpu")


SINGLE = {
    "stepdiff": (STEPDIFF, {"parthenon/mesh/nx1": 32, "parthenon/meshblock/nx1": 32,
                            "jaybenne/num_particles": 2000,
                            "mcblock/scattering_constant_value": 50}),
    # emission and feedback: the step inserts its births
    "2d_feedback": (STEPDIFF, {"parthenon/mesh/nx1": 16, "parthenon/mesh/nx2": 16,
                               "parthenon/meshblock/nx1": 8, "parthenon/meshblock/nx2": 8,
                               "jaybenne/num_particles": 2000,
                               "jaybenne/do_emission": "true", "jaybenne/do_feedback": "true",
                               "mcblock/opacity_model": "constant",
                               "mcblock/opacity_constant_value": 3.0,
                               "mcblock/scattering_constant_value": 50}),
    "1d_ddmc": (STEPDIFF_DDMC, {"parthenon/mesh/nx1": 32, "parthenon/meshblock/nx1": 32,
                                "jaybenne/num_particles": 2000}),
    # the particle decomposition at 2 in-process shards: one census call over both
    # shards' slices, the births' counts and the tallies summed over the shards
    "particle": (STEPDIFF, {"parthenon/mesh/nx1": 32, "parthenon/meshblock/nx1": 8,
                            "jaybenne/num_particles": 2000, "jaybenne/do_emission": "true",
                            "mcblock/opacity_model": "constant",
                            "mcblock/opacity_constant_value": 3.0,
                            "mcblock/scattering_constant_value": 50,
                            "jaybenne/n_devices": 2}),
}


@pytest.mark.parametrize("name", sorted(SINGLE))
def test_single_device_step_reads_nothing(name):
    """One step of each path makes no host read outside the plain census."""
    deck, mods = SINGLE[name]
    with tempfile.TemporaryDirectory() as tmp:
        sim = _sim(deck, mods, tmp)
        before = sim.state.particles.alive.clone()
        with host_reads():
            out, stats = sim.step_fn(sim._state if sim.shards is None else sim.shards,
                                     sim.cfg.jaybenne.dt)
        counts = stats.values(stats.packed.clone())
        assert counts["events"] > 0 and counts["n_alive"] > 0
        states = [out] if sim.shards is None else out
        assert all(st.cycle == 1 and st.overflow.dim() == 0 for st in states)
        if name in ("2d_feedback", "particle"):  # births went in
            assert bool((sim.state.particles.alive & ~before).any())


@pytest.mark.parametrize("rounds_per_batch", [1, 3, 8])
def test_spatial_step_reads_once_a_round(rounds_per_batch):
    """An SMR+DDMC spatial step at 2 in-process shards reads the host once a
    batch of migration rounds, for its exit test, and nowhere else: once a
    round at one round a batch."""
    mods = {"parthenon/mesh/nx1": 32, "parthenon/mesh/nx2": 16,
            "parthenon/meshblock/nx1": 8, "parthenon/meshblock/nx2": 8,
            "jaybenne/num_particles": 3000, "jaybenne/dt": "1.e-11",
            "jaybenne/decomposition": "spatial", "jaybenne/n_devices": 2}
    with tempfile.TemporaryDirectory() as tmp:
        sim = _sim(SMR_DDMC, mods, tmp)
        step = spatial.build_spatial_step_core(sim.mesh, sim.cfg, sim.exchange,
                                               rounds_per_batch)
        reads = []
        with host_reads(reads):
            shards, stats = step(sim.shards, sim.cfg.jaybenne.dt)
        counts = stats.values(stats.packed.clone())
    assert counts["migration_rounds"] >= 2 and counts["migrated"] > 0
    if rounds_per_batch == 1:
        assert reads == ["item"] * counts["migration_rounds"]
    assert reads == ["item"] * -(-counts["migration_rounds"] // rounds_per_batch)
    assert step.rounds_run == rounds_per_batch * len(reads)


# a deck that overflows its ledger: the thermal source of the initial radiation
# finds too few slots, and under the spatial decomposition migration arrivals
# find none; the counts are those of the driver before its step ran without host
# reads (same seed, same CPU)
OVERFLOW = {"parthenon/mesh/nx1": 32, "parthenon/meshblock/nx1": 32,
            "jaybenne/num_particles": 1500, "mcblock/scattering_constant_value": 20,
            "jaybenne/capacity_factor": 0.2, "parthenon/output0/file_type": "none"}
KNOWN = {
    "single": ({}, 146, [(69, 73520, 1356, 0, 0, 0, 0), (68, 73384, 1356, 0, 0, 0, 0),
                         (69, 74008, 1356, 0, 0, 0, 0)]),
    "particle": ({"jaybenne/n_devices": 2}, 144,
                 [(69, 73633, 1356, 0, 0, 0, 0), (70, 73664, 1356, 0, 0, 0, 0),
                  (71, 73708, 1356, 0, 0, 0, 0)]),
    "spatial": ({"jaybenne/n_devices": 2, "jaybenne/decomposition": "spatial",
                 "parthenon/meshblock/nx1": 16}, 186,
                [(296, 73138, 1315, 41, 8, 583, 0), (318, 71565, 1315, 0, 9, 584, 0),
                 (325, 71640, 1315, 0, 9, 617, 0)]),
}
HISTORY = ("iterations", "events", "alive", "dropped", "migration_rounds", "migrated",
           "unfinished")


@pytest.mark.parametrize("name", sorted(KNOWN))
def test_history_and_overflow_unchanged(name, monkeypatch):
    """Three steps of an overflowing deck: every count of ``history.json`` and the
    state's ``overflow`` (a device tensor now) are the known ones, and agree with
    an independent count: each insert drops its valid candidates beyond the
    ledger's free slots (dead and not reserved), counted in numpy from the
    ledger before the insert."""
    extra, overflow, want = KNOWN[name]
    real, drops = particles_mod.insert_destinations, []

    def counted(ledger, valid, reserved=None):
        occupied = ledger.alive.numpy() | (False if reserved is None else reserved.numpy())
        drops.append(max(0, int(valid.numpy().sum()) - int((~occupied).sum())))
        dest, n_dropped = real(ledger, valid, reserved)
        assert int(n_dropped) == drops[-1]
        return dest, n_dropped

    monkeypatch.setattr(particles_mod, "insert_destinations", counted)
    with tempfile.TemporaryDirectory() as tmp:
        sim = _sim(STEPDIFF, {**OVERFLOW, **extra}, tmp)
        step_drops = []
        for _ in range(3):
            k = len(drops)
            sim.run(nlim=1)
            step_drops.append(sum(drops[k:]))
    assert isinstance(sim.state.overflow, torch.Tensor) and sim.state.overflow.dim() == 0
    assert int(sim.state.overflow) == overflow == sum(drops)
    assert [tuple(h[k] for k in HISTORY) for h in sim.history] == want
    assert [h["dropped"] for h in sim.history] == step_drops
    assert [h["cycle"] for h in sim.history] == [1, 2, 3]


def test_restore_in_place_repeats_the_steps():
    """``Simulation.restore`` copies a snapshot into the state's own tensors (a
    CUDA graph holds their addresses): the restored run repeats the snapshot's
    steps bitwise, on the same tensor objects."""
    deck, mods = SINGLE["2d_feedback"]
    with tempfile.TemporaryDirectory() as tmp:
        sim = _sim(deck, mods, tmp)
        snap = sim.snapshot()
        sim.run(nlim=2)
        first = [{k: v for k, v in h.items() if k != "step_seconds"} for h in sim.history]
        after = [t.clone() for t in (sim.state.fields.energy_tally, sim.state.particles.x,
                                     sim.state.overflow)]
        ids = [id(t) for t in (sim.state.fields.energy_tally, sim.state.particles.x)]
        sim.restore(snap)
        assert (sim.t, sim.cycle) == (0.0, 0)
        assert [id(t) for t in (sim.state.fields.energy_tally, sim.state.particles.x)] == ids
        sim.run(nlim=2)
        again = [{k: v for k, v in h.items() if k != "step_seconds"} for h in sim.history[2:]]
        assert again == first
        for a, b in zip(after, (sim.state.fields.energy_tally, sim.state.particles.x,
                                sim.state.overflow)):
            assert torch.equal(a, b)
