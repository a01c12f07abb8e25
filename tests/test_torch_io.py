"""The port's checkpoint/restart and dumps on the CPU, against the JAX package:
bitwise restarts at one shard and at two in-process spatial shards, restarts
across decompositions with re-homing, checkpoints that each package writes and
the other reads, the Parthenon dump layout against the JAX writer, the ledger
re-fit rules, the ``rng_key`` pinned to ``jax.random.PRNGKey``, the pending-leak
column at a step's end, and ``-r`` through the CLI.

The deck is ``tests/test_io.py``'s: 16 cells, 2000 particles, weak absorption."""

import dataclasses
import json
import os

import h5py
import jax
import numpy as np
import pytest
import torch

from jaybenne_tpu import config as jcm
from jaybenne_tpu import io as jio
from jaybenne_tpu import state as jstate
from jaybenne_tpu.driver import Simulation as JSimulation
from jaybenne_tpu.mesh import build_mesh as jbuild_mesh
from jaybenne_tpu.utils.deck import Deck as JDeck

from jaybenne_tpu_torch import bridge
from jaybenne_tpu_torch import config as tcm
from jaybenne_tpu_torch import driver as tdriver
from jaybenne_tpu_torch import io as tio
from jaybenne_tpu_torch import state as tstate
from jaybenne_tpu_torch.driver import Simulation
from jaybenne_tpu_torch.mesh import build_mesh
from jaybenne_tpu_torch.ops import transport_kernel
from jaybenne_tpu_torch.parallel import spatial
from jaybenne_tpu_torch.particles import empty_ledger
from jaybenne_tpu_torch.utils.deck import Deck as TDeck

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(_ROOT, "inputs")

DECK = """
<parthenon/job>
problem_id = ckpt

<parthenon/mesh>
nx1 = 16
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

<parthenon/time>
tlim = 4.e-11

<jaybenne>
num_particles = 2000
dt = 1.e-11
seed = 7

<mcblock>
opacity_model = constant
opacity_constant_value = 1.0
scattering_model = constant
scattering_constant_value = 1.0e2
cv = 1.0e8
initial_density = 1.0
initial_temperature = 1.0e5
initial_radiation = thermal

<parthenon/output0>
file_type = hdf5
dt = 4.e-11
variables = field.material.density, field.jaybenne.energy_tally
swarms = photons
swarm_variables = swarm.x, swarm.weight
"""
# tests/test_io.py:224-250's spatial run: 3 blocks over 2 shards (a padding block)
SPATIAL2 = {"jaybenne/decomposition": "spatial", "jaybenne/n_devices": 2,
            "parthenon/mesh/nx1": 24, "parthenon/meshblock/nx1": 8}
# tests/test_io.py:175's refined forest
SMR2 = {"parthenon/mesh/nx1": 32, "parthenon/mesh/nx2": 16,
        "parthenon/meshblock/nx1": 8, "parthenon/meshblock/nx2": 8,
        "jaybenne/num_particles": 1000, "jaybenne/dt": "1.e-11",
        "parthenon/time/tlim": "1.e-11"}
# every dump variable, and every swarm variable, of both writers
VARIABLES = list(tio.VARIABLE_MAP)
SWARM = ("swarm.x", "swarm.y", "swarm.z", "swarm.weight")
# the weight the live ledger carries over a restart across decompositions
# (tests/test_io.py:319)
WEIGHT_RTOL = 1e-6


# the precisions the checkpoint tests run at, and each one's numpy float type
PRECISIONS = ["f32", "f64"]
REALS = {"f32": np.dtype(np.float32), "f64": np.dtype(np.float64)}


def _torch(real):
    """The torch dtype of a numpy float type."""
    return torch.float64 if real == np.float64 else torch.float32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcfg(deck=None, path=None, **mods):
    d = TDeck.from_file(path) if path else TDeck.parse(deck or DECK)
    return tcm.from_deck(d.update(mods))


def _jcfg(deck=None, path=None, **mods):
    d = JDeck.from_file(path) if path else JDeck.parse(deck or DECK)
    return jcm.from_deck(d.update(mods))


def _sim(tmp, restart=None, **mods):
    return Simulation(_tcfg(**mods), outdir=str(tmp), quiet=True, device="cpu",
                      restart=restart)


def _weight(sim):
    p = sim.state.particles
    return float(p.weight.double()[p.alive].sum())


def _same_ledger(a, b):
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


def _same_fields(a, b):
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


def _jax_dict(js, seed):
    """A JAX state flattened for ``bridge.state_from_numpy``."""
    return {
        "fields": {f.name: np.asarray(getattr(js.fields, f.name))
                   for f in dataclasses.fields(js.fields)},
        "particles": {f.name: np.asarray(getattr(js.particles, f.name))
                      for f in dataclasses.fields(js.particles)},
        "t": float(js.t), "cycle": int(js.cycle), "overflow": int(js.overflow), "seed": seed,
    }


def _h5_layout(path) -> dict:
    """Every dataset's and group's attributes, shape, dtype and values."""
    out = {}

    def visit(name, obj):
        attrs = {k: np.asarray(v) for k, v in obj.attrs.items()}
        if isinstance(obj, h5py.Dataset):
            out[name] = (obj.shape, obj.dtype, obj[...], attrs)
        else:
            out[name] = (None, None, None, attrs)

    with h5py.File(path, "r") as h:
        out["/"] = (None, None, None, {k: np.asarray(v) for k, v in h.attrs.items()})
        h.visititems(visit)
    return out


def _same_layout(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        (sa, da, va, aa), (sb, db, vb, ab) = a[name], b[name]
        assert sa == sb and da == db, name
        if va is not None:
            np.testing.assert_array_equal(va, vb, err_msg=name)
        assert sorted(aa) == sorted(ab), name
        for k in aa:
            assert aa[k].dtype == ab[k].dtype, (name, k)
            np.testing.assert_array_equal(aa[k], ab[k], err_msg=f"{name} {k}")


# ----------------------------------------------------------------- restarts


@pytest.mark.parametrize("precision", PRECISIONS)
def test_checkpoint_restart_bitwise(precision, tmp_path):
    """tests/test_io.py:219: 4 cycles straight against 2 + checkpoint + restart +
    2: the streams are keyed by (seed, cycle, slot), so the resumed run is the
    straight one bit for bit; at f64 the checkpoint's float datasets are float64
    and the resumed state keeps float64."""
    prec = {"jaybenne/precision": precision}
    a = _sim(tmp_path, **prec)
    a.run()
    b = _sim(tmp_path, **{"parthenon/time/tlim": "2.e-11", **prec})
    b.run()
    ck = b.write_checkpoint()
    assert os.path.basename(ck) == "ckpt.ckpt.00002.rhdf"
    real = REALS[precision]
    with h5py.File(ck, "r") as h:
        for name in ("x", "tau", "weight", "energy"):
            assert h[f"particles/{name}"].dtype == real, name
    c = _sim(tmp_path, restart=ck, **prec)
    assert c.cycle == 2 and c.t == b.t
    assert c.state.particles.x.dtype == c.state.fields.u.dtype == _torch(real)
    c.run()
    assert c.cycle == 4
    _same_fields(a.state.fields, c.state.fields)
    _same_ledger(a.state.particles, c.state.particles)


def test_checkpoint_restart_spatial_two_shards(tmp_path):
    """tests/test_io.py:243 with two in-process spatial shards (24 cells in 8-cell
    blocks: a padding block): the resume is bitwise, fields stay split."""
    a = _sim(tmp_path, **SPATIAL2)
    a.run()
    b = _sim(tmp_path, **{**SPATIAL2, "parthenon/time/tlim": "2.e-11"})
    b.run()
    ck = b.write_checkpoint()
    c = _sim(tmp_path, restart=ck, **SPATIAL2)
    assert c.cycle == 2 and len(c.shards) == 2
    assert [st.fields.rho.shape[0] for st in c.shards] == [2, 2]
    c.run()
    assert sum(h["migrated"] for h in c.history) > 0
    _same_fields(a.state.fields, c.state.fields)
    _same_ledger(a.state.particles, c.state.particles)


def test_checkpoint_restart_across_decompositions(tmp_path):
    """tests/test_io.py:286: a 2-shard spatial checkpoint resumes on one device;
    the live weight carries over and the run completes."""
    b = _sim(tmp_path, **{**SPATIAL2, "parthenon/time/tlim": "2.e-11"})
    b.run()
    ck = b.write_checkpoint()
    c = _sim(tmp_path, restart=ck, **{"parthenon/mesh/nx1": 24,
                                      "parthenon/meshblock/nx1": 8})
    assert c.shards is None
    assert _weight(c) == pytest.approx(_weight(b), rel=WEIGHT_RTOL)
    c.run()
    assert c.cycle == 4 and all(h["unfinished"] == 0 for h in c.history)


def test_restart_rehomes_particles_onto_owning_shards(tmp_path):
    """tests/test_io.py:329: a one-device checkpoint of a one-block deck resumed
    as 2 spatial shards. Every block is shard 0's (migration never runs), so
    re-homing must leave shard 1's slice empty; every census completes and the
    weight falls a little to absorption, none stranded."""
    b = _sim(tmp_path, **{"parthenon/time/tlim": "2.e-11"})
    b.run()
    ck = b.write_checkpoint()
    c = _sim(tmp_path, restart=ck, **{"jaybenne/decomposition": "spatial",
                                      "jaybenne/n_devices": 2})
    p = c.state.particles
    assert not bool(p.alive[p.capacity // 2:].any())
    w0 = _weight(c)
    assert w0 == pytest.approx(_weight(b), rel=WEIGHT_RTOL)
    c.run()
    assert c.cycle == 4 and all(h["unfinished"] == 0 for h in c.history)
    assert 0.9 * w0 < _weight(c) < w0


def test_rehome_moves_only_misplaced_slots():
    """``rehome_restart_ledger`` moves each misplaced live particle into a free slot
    of its owner's slice, in slot order, and leaves every other slot byte-identical;
    a slice without room raises."""
    mesh = build_mesh(_tcfg(**{"parthenon/mesh/nx1": 32,
                               "parthenon/meshblock/nx1": 4}).mesh)
    n, cap = 4, 64
    g = torch.Generator().manual_seed(3)
    p = empty_ledger(cap)
    for f in dataclasses.fields(p):
        col = getattr(p, f.name)
        if col.dtype == torch.bool:
            col.copy_(torch.rand(cap, generator=g) < 0.4)
        elif col.is_floating_point():
            col.copy_(torch.rand(cap, generator=g))
        else:
            col.copy_(torch.randint(0, mesh.n_blocks, (cap,), generator=g))
    move, owner = spatial.misplaced(p, mesh, n)
    assert 0 < int(move.sum()) < int(p.alive.sum())
    q = spatial.rehome_restart_ledger(p, mesh, n)
    assert not bool(spatial.misplaced(q, mesh, n)[0].any())
    assert int(q.alive.sum()) == int(p.alive.sum())
    changed = torch.zeros(cap, dtype=torch.bool)
    for f in dataclasses.fields(p):
        changed |= getattr(p, f.name) != getattr(q, f.name)
    # the vacated slots and the destination slots (dead or vacated before) only
    filled = q.alive & ~(p.alive & ~move)
    assert not bool((changed & ~(move | filled)).any())
    assert int(filled.sum()) == int(move.sum())
    assert spatial.rehome_restart_ledger(q, mesh, n) is q
    full = p.clone()
    full.alive.fill_(True)
    full.block.fill_(0)  # every particle is shard 0's: its slice has no room
    with pytest.raises(ValueError, match="free slots"):
        spatial.rehome_restart_ledger(full, mesh, n)


def test_ledger_refit_rules():
    """The JAX reader's re-fit (``jaybenne_tpu/io.py:280-307``): a larger ledger
    grows by dead slots; a smaller one drops dead tail slots, compacts live-first
    and stably when a live particle lies past it, and raises when the live ones do
    not fit; a tree without ``leak`` is zero-filled; fields re-pad with the
    spatial fill."""
    mesh = build_mesh(_tcfg().mesh)
    st = tstate.initial_state(mesh, 8, seed=7)
    tree = tio.checkpoint_tree(st, mesh, t=1e-11, cycle=1)
    alive = np.array([1, 0, 1, 0, 0, 0, 1, 0], bool)
    tree["particles/alive"] = alive
    tree["particles/x"] = np.arange(8, dtype=np.float32)
    tree["particles/leak"] = np.arange(8, dtype=np.int32)
    grown = tio.state_from_checkpoint_tree(tree, tstate.initial_state(mesh, 12, seed=0))
    assert grown.particles.x.tolist() == list(range(8)) + [0] * 4
    assert grown.seed == 7 and grown.cycle == 1 and grown.t == 1e-11
    shrunk = tio.state_from_checkpoint_tree(tree, tstate.initial_state(mesh, 4, seed=0))
    assert shrunk.particles.x.tolist() == [0, 2, 6, 1]  # live first, in slot order
    assert shrunk.particles.alive.tolist() == [True, True, True, False]
    tail = dict(tree, **{"particles/alive": alive & (np.arange(8) < 4)})
    cut = tio.state_from_checkpoint_tree(tail, tstate.initial_state(mesh, 4, seed=0))
    assert cut.particles.x.tolist() == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="capacity_factor"):
        tio.state_from_checkpoint_tree(tree, tstate.initial_state(mesh, 2, seed=0))
    del tree["particles/leak"]
    assert not bool(tio.state_from_checkpoint_tree(
        tree, tstate.initial_state(mesh, 8, seed=0)).particles.leak.any())
    padded = dataclasses.replace(st, fields=spatial.pad_field_blocks(st.fields, mesh, 3))
    back = tio.state_from_checkpoint_tree(tree, padded)
    assert back.fields.rho.shape[0] == 3
    assert bool((back.fields.rho[1:] == 1.0).all()) and not bool(back.fields.fleck[1:].any())


def test_rng_key_is_jax_prng_key():
    """A checkpoint's ``rng_key`` is the JAX package's ``PRNGKey(seed)``; the reader
    recovers the seed and refuses a key of any other form."""
    for seed in (0, 1, 7, 123, 349857, (1 << 31) - 1, 1 << 31, (1 << 32) - 1):
        key = np.asarray(jax.random.PRNGKey(seed))
        np.testing.assert_array_equal(tio.prng_key(seed), key)
        assert tio.prng_key(seed).dtype == key.dtype
        assert tio.seed_from_key(key) == seed
    for bad in (np.array([1, 7], np.uint32), np.array([0, 7], np.int64),
                np.array([0, 0, 7], np.uint32)):
        with pytest.raises(ValueError, match="PRNGKey"):
            tio.seed_from_key(bad)
    with pytest.raises(ValueError, match="2\\^32"):
        tio.prng_key(-1)


def test_live_slots_carry_no_pending_leak_at_step_end(tmp_path, monkeypatch):
    """Spatial SMR + DDMC at 2 shards: coarse-to-fine leaks into the other shard's
    finer blocks are pending during a step and each is resampled by its owner
    before the next round's census, so no live particle carries a code at a step's
    end, and a checkpoint's live ``leak`` entries are 0."""
    pending = []
    resample = transport_kernel.subface_resample

    def counted(p, *args, **kw):
        pending.append(int((p.alive & (p.leak != 0)).sum()))
        return resample(p, *args, **kw)

    monkeypatch.setattr(transport_kernel, "subface_resample", counted)
    mods = {"parthenon/mesh/nx1": 32, "parthenon/mesh/nx2": 16,
            "parthenon/meshblock/nx1": 8, "parthenon/meshblock/nx2": 8,
            "jaybenne/num_particles": 6000, "jaybenne/dt": "1.e-11",
            "parthenon/time/tlim": "2.e-11", "jaybenne/decomposition": "spatial",
            "jaybenne/n_devices": 2, "parthenon/output0/file_type": "none"}
    sim = Simulation(_tcfg(path=os.path.join(INPUTS, "stepdiff_smr_ddmc.in"), **mods),
                     outdir=str(tmp_path), quiet=True, device="cpu")
    for _ in range(2):
        sim.run(nlim=1)
        p = sim.state.particles
        assert not bool((p.alive & (p.leak != 0)).any())
    assert sum(pending) > 0, pending
    tree = sim.checkpoint_tree()
    assert not tree["particles/leak"][tree["particles/alive"]].any()


# ----------------------------------------------------- files across the packages


def _jax_run(tmp, **mods):
    jsim = JSimulation(_jcfg(**{"parthenon/time/tlim": "2.e-11", **mods}),
                       outdir=str(tmp), quiet=True)
    jsim.run()
    return jsim


@pytest.mark.parametrize("precision", PRECISIONS)
def test_jax_checkpoint_restores_in_port(precision, tmp_path):
    """The JAX package's checkpoint after 2 cycles, read by the port onto a state
    of the same capacity, is ``bridge.state_from_numpy`` of the JAX state bit for
    bit: every field, every ledger column, t, cycle, seed and overflow; at f64 a
    float64 state of the JAX package's float64 run."""
    prec = {"jaybenne/precision": precision}
    real = _torch(REALS[precision])
    try:
        jsim = _jax_run(tmp_path / "jax", **prec)  # at f64 its driver enables x64
        path = jsim.write_checkpoint()
        js = jsim.state
        want = bridge.state_from_numpy(_jax_dict(js, 7))
        overflow = int(js.overflow)
        cap = js.particles.capacity
        jt = float(js.t)
    finally:
        jax.config.update("jax_enable_x64", False)
    assert want.particles.x.dtype == real
    mesh = build_mesh(_tcfg(**prec).mesh, real)
    got = tio.read_checkpoint(path, tstate.initial_state(mesh, cap, 0, real))
    _same_fields(want.fields, got.fields)
    _same_ledger(want.particles, got.particles)
    assert (got.t, got.cycle, got.seed, got.overflow) == (jsim.t, 2, 7, overflow)
    assert np.float32(got.t) == pytest.approx(jt, rel=1e-6)
    assert got.particles.x.dtype == real
    # and the port resumes from it
    sim = _sim(tmp_path, restart=path, **prec)
    assert sim.cycle == 2
    sim.run()
    assert sim.cycle == 4 and all(h["unfinished"] == 0 for h in sim.history)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_port_checkpoint_restores_in_jax(precision, tmp_path):
    """``jaybenne_tpu.io.read_checkpoint`` reads the port's checkpoint into a state
    equal to the port's; and the port's checkpoint of a bridged JAX state is the
    JAX package's checkpoint of it: the same dataset names, shapes, dtypes,
    attributes and values; at f64 both packages' float64 states and files."""
    prec = {"jaybenne/precision": precision}
    real = REALS[precision]
    sim = _sim(tmp_path / "port", **{"parthenon/time/tlim": "2.e-11", **prec})
    sim.run()
    path = sim.write_checkpoint()
    p = sim.state.particles
    if precision == "f64":
        jax.config.update("jax_enable_x64", True)
    try:
        jmesh = jbuild_mesh(_jcfg(**prec).mesh, dtype=real)
        js = jio.read_checkpoint(path, jstate.initial_state(jmesh, p.capacity, 0, real))
        for f in dataclasses.fields(sim.state.fields):
            got = np.asarray(getattr(js.fields, f.name))
            assert got.dtype == real, f.name
            np.testing.assert_array_equal(got, getattr(sim.state.fields, f.name).numpy(), f.name)
        for f in dataclasses.fields(p):
            np.testing.assert_array_equal(np.asarray(getattr(js.particles, f.name)),
                                          getattr(p, f.name).numpy(), f.name)
        assert int(js.cycle) == 2 and int(js.overflow) == sim.state.overflow
        assert float(js.t) == float(real.type(sim.t))
        np.testing.assert_array_equal(np.asarray(js.rng_key),
                                      np.asarray(jax.random.PRNGKey(7)))

        jsim = _jax_run(tmp_path / "jax", **prec)
        jpath = jsim.write_checkpoint(str(tmp_path / "jax.rhdf"))
        bridged = bridge.state_from_numpy(_jax_dict(jsim.state, 7))
        jt, jcycle = jsim.t, jsim.cycle
    finally:
        jax.config.update("jax_enable_x64", False)
    tpath = str(tmp_path / "port.rhdf")
    tio.write_checkpoint(tpath, bridged, build_mesh(_tcfg(**prec).mesh, _torch(real)), t=jt,
                         cycle=jcycle)
    _same_layout(_h5_layout(jpath), _h5_layout(tpath))


@pytest.mark.parametrize("case", ["uniform", "smr_forest"])
def test_parthenon_dump_matches_jax_writer(case, tmp_path):
    """``write_dump_parthenon`` of one bridged state is the JAX writer's file
    dataset by dataset and attribute by attribute: on the 16-cell deck after 2
    cycles, and on tests/test_io.py:175's refined forest (LogicalLocations from
    the lookup grid's integers)."""
    if case == "uniform":
        jsim = _jax_run(tmp_path)
        tcfg = _tcfg()
    else:
        path = os.path.join(INPUTS, "stepdiff_smr2.in")
        jsim = JSimulation(_jcfg(path=path, **SMR2), outdir=str(tmp_path), quiet=True)
        tcfg = _tcfg(path=path, **SMR2)
        assert jsim.mesh.max_level == 2
    js = jsim.state
    mesh = build_mesh(tcfg.mesh)
    jpath, tpath = str(tmp_path / "jax.phdf"), str(tmp_path / "port.phdf")
    jio.write_dump_parthenon(jpath, js, jsim.mesh, jsim.cfg, VARIABLES, SWARM)
    tio.write_dump_parthenon(tpath, bridge.state_from_numpy(_jax_dict(js, 7)), mesh,
                             VARIABLES, SWARM)
    _same_layout(_h5_layout(jpath), _h5_layout(tpath))


def test_phdf_parthenon_output_and_rst_cadence(tmp_path):
    """``file_type = phdf_parthenon`` writes the Parthenon layout on its dt, and an
    ``rst`` output writes ``{problem_id}.ckpt.{cycle:05d}.rhdf`` on its dt."""
    deck = DECK.replace("file_type = hdf5", "file_type = phdf_parthenon") + """
<parthenon/output1>
file_type = rst
dt = 2.e-11
"""
    sim = Simulation(_tcfg(deck=deck), outdir=str(tmp_path), quiet=True, device="cpu")
    sim.run()
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["ckpt.ckpt.00002.rhdf", "ckpt.ckpt.00004.rhdf", "ckpt.out0.00000.phdf",
                     "ckpt.out0.00001.phdf", "ckpt.out0.00002.phdf", "history.json"]
    with h5py.File(tmp_path / "ckpt.out0.00001.phdf", "r") as h:
        assert int(h["Info"].attrs["NCycle"]) == 4
        np.testing.assert_array_equal(h["field.jaybenne.energy_tally"][...],
                                      sim.state.fields.energy_tally.double().numpy())
    resumed = _sim(tmp_path / "r", restart=str(tmp_path / "ckpt.ckpt.00002.rhdf"))
    resumed.run()
    _same_ledger(sim.state.particles, resumed.state.particles)


def test_cli_restart(tmp_path):
    """``-r`` resumes at the checkpoint's cycle (``--device cpu``): the run's
    history starts at cycle 3 and ends at 4, bitwise the straight run."""
    deck = tmp_path / "ckpt.in"
    deck.write_text(DECK)
    common = ["-i", str(deck), "-q", "--device", "cpu"]
    assert tdriver.main(common + ["-d", str(tmp_path / "a"), "parthenon/output0/file_type=none",
                                  "parthenon/time/tlim=2.e-11",
                                  "parthenon/output1/file_type=rst",
                                  "parthenon/output1/dt=2.e-11"]) == 0
    ck = tmp_path / "a" / "ckpt.ckpt.00002.rhdf"
    assert ck.exists()
    assert tdriver.main(common + ["-d", str(tmp_path / "b"), "-r", str(ck),
                                  "parthenon/output0/file_type=none"]) == 0
    hist = json.loads((tmp_path / "b" / "history.json").read_text())
    assert [h["cycle"] for h in hist["cycles"]] == [3, 4]
    straight = _sim(tmp_path / "c", **{"parthenon/output0/file_type": "none"})
    straight.run()
    assert [h["events"] for h in straight.history[2:]] == [h["events"] for h in hist["cycles"]]


def test_unwritten_output_type_is_skipped(tmp_path):
    """A deck with an output type neither driver writes (``file_type = hst``, a
    Parthenon history output) builds in both packages, and a one-step run of the
    port writes the same dumps as the same deck without that output."""
    base = open(os.path.join(os.path.dirname(__file__), "..", "inputs", "stepdiff.in")).read()
    hst = base + "\n<parthenon/output1>\nfile_type = hst\ndt = 3.335641e-11\n"
    small = {"parthenon/mesh/nx1": 32, "parthenon/meshblock/nx1": 32,
             "jaybenne/num_particles": 4000}
    paths = {}
    for name, text in (("hst", hst), ("plain", base)):
        paths[name] = tmp_path / f"{name}.in"
        paths[name].write_text(text)
    jsim = JSimulation(_jcfg(path=str(paths["hst"]), **small), outdir=str(tmp_path / "jax"),
                       quiet=True)
    assert [o.file_type for o in jsim.cfg.outputs] == ["hdf5", "hst"]
    dumps = {}
    for name in ("hst", "plain"):
        out = tmp_path / name
        if name == "hst":
            with pytest.warns(UserWarning, match="file_type = hst is not written"):
                sim = Simulation(_tcfg(path=str(paths[name]), **small), outdir=str(out),
                                 quiet=True, device="cpu")
        else:
            sim = Simulation(_tcfg(path=str(paths[name]), **small), outdir=str(out),
                             quiet=True, device="cpu")
        sim.run(nlim=1)
        assert sim.cycle == 1
        dumps[name] = {p.name: _h5_layout(p) for p in sorted(out.glob("*.phdf"))}
    assert list(dumps["hst"]) == list(dumps["plain"]) and dumps["plain"]
    for fname in dumps["plain"]:
        _same_layout(dumps["hst"][fname], dumps["plain"][fname])
