"""The port's particle decomposition and its exchange backends on the CPU: the
in-process collectives' deliveries, the particle-sharded tally against the
concatenated ledger's, the ledger slices, ports of ``tests/test_sharding.py``,
and one run of two gloo ranks against the in-process backend.

Everything here runs the census's plain version (CPU tensors). The decks are the
JAX tests' stepdiff slab cut to a CPU size (sigma_s = 200 and dt = 1e-11 s: about
60 events a particle and step)."""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from jaybenne_tpu_torch import config as cm
from jaybenne_tpu_torch.driver import Simulation
from jaybenne_tpu_torch.ops import tally
from jaybenne_tpu_torch.parallel import exchange, sharding
from jaybenne_tpu_torch.particles import empty_ledger
from jaybenne_tpu_torch.utils import constants
from jaybenne_tpu_torch.utils.deck import Deck

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DECK = """
<parthenon/job>
problem_id = stepdiff
<parthenon/mesh>
nx1 = 32
x1min = -0.5
x1max = 0.5
ix1_bc = outflow
ox1_bc = outflow
nx2 = 1
x2min = -0.5
x2max = 0.5
nx3 = 1
x3min = -0.5
x3max = 0.5
<parthenon/swarm>
ix1_bc = jaybenne_reflecting
ox1_bc = jaybenne_reflecting
<parthenon/meshblock>
nx1 = 8
<parthenon/time>
tlim = 2.e-11
<jaybenne>
num_particles = 4000
dt = 1.e-11
do_emission = false
do_feedback = false
seed = 11
<mcblock>
opacity_model = none
scattering_model = constant
scattering_constant_value = 2.0e2
cv = 1.0e8
initial_density = 1.0
initial_temperature = 1.0e5
initial_radiation = thermal
<parthenon/output0>
file_type = none
"""
# tally against the live weights, and conservation without absorption: float32
# weights summed in float64
ENERGY_RTOL = 1e-5
# two independent runs of the slab at 8000 particles differ by a few % weighted
# (tests/test_sharding.py allows 0.05 at 64k particles)
STAT_TOL = 0.08
GLOO_TIMEOUT_S = 240


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tensors are small, and the suite runs in several
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sim(mods=None, deck=DECK, path=None, tmp="."):
    d = Deck.from_file(path) if path else Deck.parse(deck)
    return Simulation(cm.from_deck(d.update(dict(mods or {}))), outdir=str(tmp), quiet=True,
                      device="cpu")


def _weights(sim):
    p = sim.state.particles
    return float(p.weight.double()[p.alive].sum())


def _tally_energy(sim):
    dv = sim.mesh.block_volume.double()[:, None, None, None]
    return float((sim.state.fields.energy_tally.double() * dv).sum())


# ------------------------------------------------------------------ the exchange


def test_in_process_all_to_all_delivers_by_source_shard():
    """Shard s receives out[j] = what shard j addressed to s, in j order
    (``lax.all_to_all(split_axis=0, concat_axis=0)``)."""
    n = 4
    ex = exchange.InProcess(n)
    xs = [torch.arange(n * 3, dtype=torch.int32).reshape(n, 3) + 100 * j for j in range(n)]
    out = ex.all_to_all(xs)
    for s in range(n):
        for j in range(n):
            assert torch.equal(out[s][j], xs[j][s])
    g = ex.all_gather([torch.full((2,), j) for j in range(n)])
    assert all(torch.equal(t, torch.tensor([0, 0, 1, 1, 2, 2, 3, 3])) for t in g)
    assert int(ex.sum([torch.tensor(j) for j in range(n)])[0]) == 6
    assert int(ex.max([torch.tensor(j) for j in range(n)])[3]) == 3
    with pytest.raises(TypeError):
        ex.sum([torch.tensor(1.0)] * n)
    with pytest.raises(ValueError):
        ex.sum([torch.tensor(1)] * (n - 1))


def test_exchange_choice_outside_a_process_group():
    """Outside a process group the in-process backend runs n_devices shards (0:
    the world size, 1); a negative count raises."""
    assert exchange.world_size() == 1
    assert isinstance(exchange.exchange_for(8), exchange.InProcess)
    assert exchange.exchange_for(8).n == 8 and exchange.exchange_for(0).n == 1
    with pytest.raises(ValueError):
        exchange.exchange_for(-1)


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_tally_bitwise_equals_concatenated(n):
    """The particle decomposition's tally (an integer MAX of the exponents, then a
    SUM of the int64 accumulators, with ``bits`` from every shard's slots) is
    bitwise ``deterministic_segment_sum`` over the concatenated shard ledgers, for
    values spread over 30 orders of magnitude and zeros."""
    rng = np.random.default_rng(n)
    cap, cells = 3000, 64
    vals = [torch.from_numpy(np.where(rng.random(cap) < 0.2, 0.0,
                                      10.0 ** rng.uniform(-20, 10, cap))) for _ in range(n)]
    segs = [torch.from_numpy(rng.integers(0, cells, cap)) for _ in range(n)]
    got = tally.sharded_segment_sum(vals, segs, cells, exchange.InProcess(n))
    want = tally.deterministic_segment_sum(torch.cat(vals), torch.cat(segs), cells)
    for g in got:
        assert torch.equal(g, want)


def test_ledger_slices_and_growth():
    """The shards' ledgers are views of one ledger; growth keeps each particle in
    its shard and slot."""
    p = empty_ledger(12)
    p.x.copy_(torch.arange(12, dtype=torch.float32))
    p.alive[::2] = True
    views = sharding.split_ledger(p, 3)
    views[1].tau.fill_(0.5)
    assert torch.equal(p.tau[4:8], torch.full((4,), 0.5)) and float(p.tau[:4].sum()) == 0.0
    g = sharding.grow_ledger(p, 3, 6)
    assert g.capacity == 18
    for s in range(3):
        assert torch.equal(g.x[6 * s:6 * s + 4], p.x[4 * s:4 * s + 4])
        assert not bool(g.alive[6 * s + 4:6 * s + 6].any())
    assert sharding.pad_capacity(13, 8) == 16 and sharding.pad_capacity(16, 8) == 16
    with pytest.raises(ValueError):
        sharding.split_ledger(p, 5)


# ------------------------------------------------- ports of tests/test_sharding.py


def test_sharded_smoke_two_shards(tmp_path):
    """A 2-shard particle-sharded run conserves energy exactly and its tally holds
    the live weights (tests/test_sharding.py::test_sharded_smoke_two_devices)."""
    sim = _sim({"jaybenne/n_devices": 2}, tmp=tmp_path)
    assert len(sim.shards) == 2 and sim.state.particles.capacity % 2 == 0
    w0 = _weights(sim)
    sim.run()
    w1 = _weights(sim)
    assert abs(w1 - w0) <= ENERGY_RTOL * w0
    assert abs(_tally_energy(sim) - w1) <= ENERGY_RTOL * w1
    assert sim.state.overflow == 0 and sim.history[-1]["unfinished"] == 0
    # the replicated fields are one on every shard
    assert torch.equal(sim.shards[0].fields.energy_tally, sim.shards[1].fields.energy_tally)
    assert all(h["migration_rounds"] == 0 for h in sim.history)


def test_sharded_matches_single_device_statistics(tmp_path):
    """One and eight shards of the same problem agree to MC noise, and hold the
    thermal energy a T^4 V_hot (tests/test_sharding.py::
    test_sharded_matches_single_device_statistics and
    test_sharded_energy_conservation)."""
    mods = {"jaybenne/num_particles": 8000}
    s1 = _sim(mods, tmp=tmp_path)
    s8 = _sim({**mods, "jaybenne/n_devices": 8}, tmp=tmp_path)
    births = [int(s.state.particles.alive.sum()) for s in (s1, s8)]
    assert abs(births[1] - births[0]) < 0.05 * births[0]
    for s in (s1, s8):
        s.run()
    t1, t8 = (s.state.fields.energy_tally.double().reshape(-1) for s in (s1, s8))
    w = t1 + t8
    err = float((t1 - t8).abs()[w > 0].sum() / w[w > 0].sum())
    assert err < STAT_TOL, err
    expect = constants.AR * (1.0e5 ** 4) * 0.5
    for s in (s1, s8):
        assert abs(_weights(s) - expect) / expect < 2e-2
        assert s.state.overflow == 0


def test_sharded_emission_feedback_and_growth(tmp_path):
    """Emission, feedback and ledger growth at 2 shards on inputs/inf.in: matter +
    radiation energy conserved and nothing dropped
    (tests/test_sharding.py::test_sharded_emission_feedback_and_growth, cut to 4
    steps of 64 cells at sigma_s = 1e3)."""
    sim = _sim({"jaybenne/n_devices": 2, "jaybenne/num_particles": 600,
                "parthenon/time/tlim": "4.e-12", "jaybenne/do_feedback": "true",
                "jaybenne/capacity_factor": "1.2", "parthenon/output0/file_type": "none",
                "mcblock/scattering_constant_value": "1.0e3",
                **{f"parthenon/mesh/nx{k}": 4 for k in "123"},
                **{f"parthenon/meshblock/nx{k}": 4 for k in "123"}},
               path=os.path.join(_ROOT, "inputs", "inf.in"), tmp=tmp_path)
    dv = sim.mesh.block_volume.double()[:, None, None, None]

    def total():
        return float((sim.state.fields.u.double() * dv).sum()) + _weights(sim)

    cap0, e0 = sim.state.particles.capacity, total()
    sim.run()
    assert sim.state.overflow == 0
    assert sim.state.particles.capacity > cap0  # the ledger grew, both slices alike
    assert int(sim.state.particles.alive.sum()) > 600
    assert abs(total() - e0) / e0 < 5e-4


# ------------------------------------------------------------------ two gloo ranks

def _gloo_worker(rank, path, out_dir):
    """One rank of a 2-process gloo group: both decompositions on a tiny deck,
    saving each rank's ledger and fields, and from rank 0 a dump and a checkpoint
    of the whole run; then both ranks resume from that checkpoint for a step and
    save their ledgers again. A deck asking for another world size raises."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{path}", world_size=2, rank=rank)
    try:
        with pytest.raises(ValueError):
            exchange.exchange_for(3)
        for name, mods in GLOO_RUNS.items():
            outdir = os.path.join(out_dir, f"gloo_{name}")
            sim = _sim({**mods, **GLOO_DUMP, "jaybenne/n_devices": 0}, tmp=outdir)
            assert isinstance(sim.exchange, exchange.Distributed) and sim.exchange.n == 2
            sim.run()
            st = sim.shards[0]
            torch.save({"particles": dataclasses.asdict(st.particles),
                        "fields": dataclasses.asdict(st.fields),
                        "history": sim.history},
                       os.path.join(out_dir, f"{name}.{rank}.pt"))
            ck = sim.write_checkpoint(os.path.join(outdir, "run.rhdf"))
            dist.barrier()  # rank 0 has written it
            again = _sim({**mods, "jaybenne/n_devices": 0, "parthenon/time/tlim": "3.e-11"},
                         tmp=outdir)
            resumed = Simulation(again.cfg, outdir=outdir, quiet=True, device="cpu",
                                 restart=ck)
            assert resumed.cycle == 2
            resumed.run()
            torch.save(dataclasses.asdict(resumed.shards[0].particles),
                       os.path.join(out_dir, f"{name}.resumed.{rank}.pt"))
    finally:
        dist.destroy_process_group()


# the gloo runs' outputs: the compact dump with swarm variables, at the start and
# the end
GLOO_DUMP = {"parthenon/output0/file_type": "hdf5",
             "parthenon/output0/variables": "field.material.density, field.jaybenne.energy_tally",
             "parthenon/output0/swarm_variables": "swarm.x, swarm.weight"}
GLOO_RUNS = {
    "particle": {"jaybenne/num_particles": 1000},
    "spatial": {"jaybenne/num_particles": 1000, "jaybenne/decomposition": "spatial",
                "parthenon/mesh/nx1": 16, "parthenon/meshblock/nx1": 4,
                "jaybenne/use_ddmc": "true", "jaybenne/tau_ddmc": 2.5},
}


def test_gloo_ranks_match_in_process_bitwise(tmp_path):
    """Two gloo ranks (torch.multiprocessing, ``init_method=file://``) run both
    decompositions; each rank's ledger and fields are bitwise those of the
    in-process backend's shard of the same index at n = 2; rank 0's dumps and
    checkpoint, gathered through the exchange, are the in-process run's; and
    both ranks resume from that checkpoint as the in-process shards do."""
    ctx = mp.start_processes(_gloo_worker, args=(str(tmp_path / "pg"), str(tmp_path)),
                             nprocs=2, join=False, start_method="spawn")
    t0 = time.time()
    while not ctx.join(timeout=5):
        if time.time() - t0 > GLOO_TIMEOUT_S:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail(f"the gloo ranks did not finish in {GLOO_TIMEOUT_S} s")
    import h5py

    def contents(path):
        out = {}
        with h5py.File(path, "r") as h:
            out["/"] = dict(h.attrs)
            h.visititems(lambda k, v: out.__setitem__(
                k, v[...] if isinstance(v, h5py.Dataset) else dict(v.attrs)))
        return out

    for name, mods in GLOO_RUNS.items():
        outdir = tmp_path / f"in_process_{name}"
        sim = _sim({**mods, **GLOO_DUMP, "jaybenne/n_devices": 2}, tmp=outdir)
        sim.run()
        for rank in range(2):
            got = torch.load(os.path.join(tmp_path, f"{name}.{rank}.pt"))
            st = sim.shards[rank]
            for field, t in dataclasses.asdict(st.particles).items():
                assert torch.equal(got["particles"][field], t), (name, rank, field)
            for field, t in dataclasses.asdict(st.fields).items():
                assert torch.equal(got["fields"][field], t), (name, rank, field)
            assert got["history"][-1]["events"] == sim.history[-1]["events"]
        if name == "spatial":
            assert sim.history[-1]["migrated"] > 0
        # rank 0's dumps and checkpoint are those of the in-process run, bit for bit
        ck = sim.write_checkpoint(str(outdir / "run.rhdf"))
        gloo_dir = tmp_path / f"gloo_{name}"
        files = sorted(p.name for p in outdir.iterdir())
        assert files == sorted(p.name for p in gloo_dir.iterdir()), name
        for f in files:
            if f.endswith((".phdf", ".rhdf")):
                a, b = contents(outdir / f), contents(gloo_dir / f)
                assert sorted(a) == sorted(b), (name, f)
                for k in a:
                    if isinstance(a[k], dict):
                        assert a[k].keys() == b[k].keys(), (name, f, k)
                        for key in a[k]:
                            np.testing.assert_array_equal(a[k][key], b[k][key])
                    else:
                        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {f} {k}")
        # the ranks resumed from it as the in-process backend does
        again = _sim({**mods, "jaybenne/n_devices": 2, "parthenon/time/tlim": "3.e-11"},
                     tmp=outdir)
        resumed = Simulation(again.cfg, outdir=str(outdir), quiet=True, device="cpu",
                             restart=ck)
        resumed.run()
        for rank in range(2):
            got = torch.load(os.path.join(tmp_path, f"{name}.resumed.{rank}.pt"))
            for field, t in dataclasses.asdict(resumed.shards[rank].particles).items():
                assert torch.equal(got[field], t), (name, "resumed", rank, field)
