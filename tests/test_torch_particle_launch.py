"""The particle decomposition's census as one call over every local shard, on the
CPU: one plain census call over the adjacent ledger slices of 2 or 3 shards,
each owning the whole mesh and reading the one table, is bitwise the per-shard
calls (every column, each shard's iterations and events) on a 1D mesh of one
block, a uniform multi-block mesh (the collapse to one block), a 2D SMR forest
and an SMR+DDMC forest, in float32 and float64; every shard's coefficients are
bitwise equal over the steps of an emission, feedback and DDMC deck, the premise
of the one table; and the particle step calls the census once a step.

Imports no jax: ``tests/test_torch_cuda.py`` builds its 8-shard case from
``particle_case`` here, on the card."""

import dataclasses
import os
import tempfile

import pytest
import torch

from jaybenne_tpu_torch import config as cm
from jaybenne_tpu_torch.driver import Simulation
from jaybenne_tpu_torch.ops import fleck as fleck_ops
from jaybenne_tpu_torch.ops import rng, transport_kernel
from jaybenne_tpu_torch.ops import transport as transport_ops
from jaybenne_tpu_torch.parallel.sharding import split_ledger
from jaybenne_tpu_torch.step import (make_transport_params, total_sigma, with_faces,
                                     with_fleck)
from jaybenne_tpu_torch.utils.deck import Deck

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(_ROOT, "inputs")
SMR_2D = {"parthenon/mesh/nx1": 32, "parthenon/mesh/nx2": 16,
          "parthenon/meshblock/nx1": 8, "parthenon/meshblock/nx2": 8}
# (deck, overrides): the initial radiation of each, a full census from tau = 0
CASES = {
    "1d": ("stepdiff.in", {"parthenon/mesh/nx1": 32, "parthenon/meshblock/nx1": 32,
                           "mcblock/scattering_constant_value": 100}),
    # four blocks of a uniform mesh: the census collapses the ledger to one block
    "1d_blocks": ("stepdiff.in", {"parthenon/mesh/nx1": 32, "parthenon/meshblock/nx1": 8,
                                  "mcblock/scattering_constant_value": 100}),
    "2d_smr": ("stepdiff_smr.in", {**SMR_2D, "jaybenne/dt": "1.e-11"}),
    "smr_ddmc": ("stepdiff_smr_ddmc.in", SMR_2D),
}
# (case, precision, shards)
PARAMS = [(c, p, n) for c in sorted(CASES) for p, n in (("f32", 2), ("f32", 3), ("f64", 3))]
PARTICLES = 1500
# emission, feedback and DDMC at 3 shards (the coefficients' premise)
EMISSION_DDMC = ("stepdiff_ddmc.in", {
    "parthenon/mesh/nx1": 32, "parthenon/meshblock/nx1": 8, "jaybenne/num_particles": 1500,
    "jaybenne/do_emission": "true", "jaybenne/do_feedback": "true",
    "mcblock/opacity_model": "constant", "mcblock/opacity_constant_value": 30.0,
    "jaybenne/n_devices": 3, "parthenon/output0/file_type": "none"})


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sim(deck, mods, tmp, device="cpu"):
    cfg = cm.from_deck(Deck.from_file(os.path.join(INPUTS, deck)).update(mods))
    return Simulation(cfg, outdir=tmp, quiet=True, device=device)


def coefs_of(sim, fields, dt):
    """The census coefficients of ``fields`` as the step makes them: this step's
    Fleck factor and, with DDMC, face probabilities."""
    cfg, dtype = sim.cfg, sim.cfg.jaybenne.dtype
    models = (cfg.mcblock.build_eos(), cfg.mcblock.build_opacity(),
              cfg.mcblock.build_scattering())
    f = with_fleck(fields, models, dt, dtype)
    if cfg.jaybenne.use_ddmc:
        f = with_faces(f, fleck_ops.ddmc_face_probs(
            sim.mesh, total_sigma(f, models, dtype), cfg.jaybenne.tau_ddmc,
            cfg.mesh.periodic_flags, dtype))
    return transport_ops.precompute_coefs(f, sim.mesh, *models, cfg.jaybenne.use_ddmc, dtype)


def particle_case(name, n, precision="f32", device="cpu", particles=PARTICLES):
    """The initial radiation of deck ``name`` of CASES at ``n`` particle shards:
    (the whole ledger of the shards' adjacent slices, the coefficients, mesh, the
    shards' seeds of the first step, prm, dt)."""
    deck, mods = CASES[name]
    mods = {**mods, "jaybenne/num_particles": particles, "jaybenne/n_devices": n,
            "jaybenne/precision": precision, "parthenon/output0/file_type": "none"}
    with tempfile.TemporaryDirectory() as tmp:
        sim = _sim(deck, mods, tmp, device)
    dt = sim.cfg.jaybenne.dt
    seeds = [rng.kernel_seed(st.seed, 0, s) for st, s in zip(sim.shards, sim.exchange.shards)]
    assert len(set(seeds)) == n
    return (sim._ledger, coefs_of(sim, sim.shards[0].fields, dt), sim.mesh, seeds,
            make_transport_params(sim.cfg, sim.cfg.jaybenne.dtype), dt)


def per_shard_calls(census, p, coefs, mesh, seeds, prm, dt):
    """The census shard by shard on ``p``'s slices (IN PLACE): (iterations, events)
    per shard."""
    its, evs = [], []
    for q, s in zip(split_ledger(p, len(seeds)), seeds):
        _, it, ev = census(q, coefs, mesh, s, prm, dt)
        its.append(it)
        evs.append(ev)
    return torch.stack(its), torch.stack(evs)


def one_call(census, p, coefs, mesh, seeds, prm, dt):
    """The census as one call over every shard's slice (IN PLACE)."""
    _, it, ev = census(split_ledger(p, len(seeds)), coefs, mesh, seeds, prm, dt)
    return it, ev


def assert_same(a, b, it_a, ev_a, it_b, ev_b, what):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype and torch.equal(x, y), (what, f.name, int((x != y).sum()))
    assert torch.equal(it_a.to(torch.int64), it_b.to(torch.int64)), (what, it_a, it_b)
    assert torch.equal(ev_a, ev_b), (what, ev_a, ev_b)


@pytest.mark.parametrize("name, precision, n", PARAMS)
def test_one_call_is_the_per_shard_calls(name, precision, n):
    """One plain census call over ``n`` particle shards' slices against the ``n``
    calls shard by shard on the same ledger, coefficients and seeds: every column
    bitwise, each shard's iterations and events equal; every shard ran events."""
    p0, coefs, mesh, seeds, prm, dt = particle_case(name, n, precision)
    assert p0.x.dtype == (torch.float64 if precision == "f64" else torch.float32)
    a, b = p0.clone(), p0.clone()
    it_a, ev_a = per_shard_calls(transport_kernel.transport, a, coefs, mesh, seeds, prm, dt)
    it_b, ev_b = one_call(transport_kernel.transport, b, coefs, mesh, seeds, prm, dt)
    assert it_b.shape == ev_b.shape == (n,)
    assert_same(a, b, it_a, ev_a, it_b, ev_b, (name, precision, n))
    assert bool((ev_b > 0).all()) and not torch.equal(a.tau, p0.tau)
    assert int(it_b.max()) < prm.max_iters


def test_shards_coefficients_are_equal_every_step():
    """Three steps of an emission, feedback and DDMC deck at 3 particle shards:
    before each step every shard's fields are bitwise equal, and so are the
    coefficients the step's census would make from each (the one table's
    premise); the run emits, feeds back and takes the DDMC branch."""
    deck, mods = EMISSION_DDMC
    with tempfile.TemporaryDirectory() as tmp:
        sim = _sim(deck, mods, tmp)
        dt = sim.cfg.jaybenne.dt
        sie0 = sim.shards[0].fields.sie.clone()
        for _ in range(3):
            first = sim.shards[0].fields
            for st in sim.shards[1:]:
                for f in dataclasses.fields(first):
                    assert torch.equal(getattr(st.fields, f.name), getattr(first, f.name)), f.name
            cs = [coefs_of(sim, st.fields, dt) for st in sim.shards]
            for c in cs[1:]:
                for f in dataclasses.fields(c):
                    x, y = getattr(c, f.name), getattr(cs[0], f.name)
                    if isinstance(x, torch.Tensor):
                        assert torch.equal(x, y), f.name
            sim.run(nlim=1)
        assert sim.cycle == 3 and all(h["events"] > 0 for h in sim.history)
        assert not torch.equal(sim.shards[0].fields.sie, sie0)  # feedback
        assert float(cs[0].px.max()) > 0.0  # DDMC faces
        assert int(sim.shards[0].fields.source_num.sum()) > 0  # emission


def test_particle_step_calls_the_census_once(monkeypatch):
    """Three steps at 2 particle shards: one census call a step, over both shards'
    slices, and one run of the plain census inside it."""
    calls, plain = [], []
    real, real_plain = transport_kernel.transport, transport_kernel._census_plain

    def census(particles, *args, **kw):
        calls.append(len(particles) if isinstance(particles, (list, tuple)) else 1)
        return real(particles, *args, **kw)

    def counted(p, tabs, g, shards, *args, **kw):
        plain.append(len(shards))
        return real_plain(p, tabs, g, shards, *args, **kw)

    monkeypatch.setattr(transport_kernel, "transport", census)
    monkeypatch.setattr(transport_kernel, "_census_plain", counted)
    deck, mods = CASES["1d_blocks"]
    with tempfile.TemporaryDirectory() as tmp:
        sim = _sim(deck, {**mods, "jaybenne/num_particles": PARTICLES, "jaybenne/n_devices": 2,
                          "parthenon/output0/file_type": "none"}, tmp)
        assert not sim.graphed and sim.step_fn.capturable
        sim.run(nlim=3)
    assert calls == [2, 2, 2] and plain == [2, 2, 2], (calls, plain)
    assert all(h["events"] > 0 for h in sim.history)
