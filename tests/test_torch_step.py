"""The port's slice as a whole against the JAX package: one JAX ``Simulation``'s
state after ``initialize_radiation`` is bridged into the port, both packages step
it, and the totals and tally profiles are compared. Also: the port's dumps read
back through ``analysis/jhdf.py``, its CLI, and its deterministic tally."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jaybenne_tpu import config as jcm
from jaybenne_tpu.driver import Simulation as JSimulation
from jaybenne_tpu.utils.deck import Deck as JDeck

from jaybenne_tpu_torch import bridge
from jaybenne_tpu_torch import config as tcm
from jaybenne_tpu_torch.driver import run_file
from jaybenne_tpu_torch.io import latest_dump
from jaybenne_tpu_torch.mesh import build_mesh
from jaybenne_tpu_torch.ops.tally import deterministic_segment_sum
from jaybenne_tpu_torch.step import build_step_core
from jaybenne_tpu_torch.utils.deck import Deck as TDeck

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "analysis"))
STEPDIFF = os.path.join(_ROOT, "inputs", "stepdiff.in")
SMALL = {
    "parthenon/mesh/nx1": 32,
    "parthenon/meshblock/nx1": 16,  # two blocks: the census collapses the forest
    "jaybenne/num_particles": 4000,
    "mcblock/scattering_constant_value": 2.0e2,
}
N_STEPS = 3
ENERGY_RTOL = 1e-5
# per-cell tallies of two independent Monte Carlo runs: |difference| within this
# many combined standard deviations (estimated per cell as sqrt(sum (w/dV)^2))
N_SIGMA = 5.0
EVENTS_RTOL = 0.05


def _energy(tally, dv):
    return float((np.asarray(tally, np.float64) * dv).sum())


def _tally_sigma2(p, mesh_dv, n_cells, nx):
    """Per-cell variance estimate sum (w/dV)^2 over live particles (numpy ledger)."""
    alive = p["alive"]
    cell = (p["block"] * nx + p["i"])[alive]
    w = (p["weight"][alive] / mesh_dv[p["block"][alive]]).astype(np.float64)
    return np.bincount(cell, weights=w * w, minlength=n_cells)


def test_step_matches_jax(tmp_path):
    jcfg = jcm.from_deck(JDeck.from_file(STEPDIFF).update(dict(SMALL)))
    jsim = JSimulation(jcfg, outdir=str(tmp_path), quiet=True)
    js = jsim.state
    d = {
        "fields": {f.name: np.asarray(getattr(js.fields, f.name))
                   for f in dataclasses.fields(js.fields)},
        "particles": {f.name: np.asarray(getattr(js.particles, f.name))
                      for f in dataclasses.fields(js.particles)},
        "t": float(js.t), "cycle": int(js.cycle), "overflow": int(js.overflow),
        "seed": jcfg.jaybenne.seed,
    }
    ts = bridge.state_from_numpy(d)
    tcfg = tcm.from_deck(TDeck.from_file(STEPDIFF).update(dict(SMALL)))
    tmesh = build_mesh(tcfg.mesh)
    assert tmesh.n_blocks == 2
    dv = tmesh.block_volume.double().numpy()[:, None, None, None]
    e0 = _energy(js.fields.energy_tally, dv)
    np.testing.assert_allclose(_energy(ts.fields.energy_tally.numpy(), dv), e0, rtol=1e-7)

    step = build_step_core(tmesh, tcfg)
    dt = tcfg.jaybenne.dt
    ev_t = ev_j = 0
    for _ in range(N_STEPS):
        js, jstats = jsim.step_fn(js, jnp.float32(dt))
        ts, tstats = step(ts, dt)
        ev_j += int(jstats.events)
        ev_t += int(tstats.events)
        assert int(tstats.unfinished) == 0 and int(tstats.cap_hits) == 0
    assert ts.cycle == N_STEPS and abs(ts.t - N_STEPS * dt) < 1e-20

    tt = ts.fields.energy_tally.numpy().astype(np.float64)
    tj = np.asarray(js.fields.energy_tally, np.float64)
    # no absorption, reflecting walls: the radiation energy is conserved in both
    np.testing.assert_allclose(_energy(tt, dv), e0, rtol=ENERGY_RTOL)
    np.testing.assert_allclose(_energy(tj, dv), e0, rtol=ENERGY_RTOL)
    np.testing.assert_allclose(_energy(tt, dv), _energy(tj, dv), rtol=ENERGY_RTOL)
    assert abs(ev_t - ev_j) / ev_j < EVENTS_RTOL

    nc, nx = tmesh.total_cells, tmesh.nx
    bv = tmesh.block_volume.numpy()
    pt = bridge.state_to_numpy(ts.particles)
    pj = {f.name: np.asarray(getattr(js.particles, f.name))
          for f in dataclasses.fields(js.particles)}
    sigma = np.sqrt(_tally_sigma2(pt, bv, nc, nx) + _tally_sigma2(pj, bv, nc, nx))
    diff = np.abs(tt.reshape(-1) - tj.reshape(-1))
    assert (diff <= N_SIGMA * sigma + 1e-30).all(), (diff / np.maximum(sigma, 1e-300)).max()
    # the profile moved: radiation diffused into the cold half
    assert tt.reshape(-1)[nc // 2 :].sum() > 1e-3 * tt.sum()


def test_port_runs_are_deterministic_and_dump_reads_back(tmp_path):
    import jhdf

    import h5py

    mods = {**SMALL, "parthenon/output0/swarm_variables": "swarm.x, swarm.weight"}
    sims = [
        run_file(STEPDIFF, outdir=str(tmp_path / f"run{k}"), modified_inputs=mods,
                 quiet=True, nlim=2, device="cpu")
        for k in range(2)
    ]
    a, b = (s.state.fields.energy_tally for s in sims)
    assert torch.equal(a, b)
    dump = jhdf.jhdf(latest_dump("stepdiff", str(tmp_path / "run0")))
    assert dump.NumBlocks == 2 and dump.NX1 == 16
    assert dump.Time == pytest.approx(sims[0].t, rel=1e-12)
    np.testing.assert_array_equal(dump.Get("field.jaybenne.energy_tally"), a.numpy())
    np.testing.assert_array_equal(dump.Get("field.material.density"),
                                  sims[0].state.fields.rho.numpy())
    np.testing.assert_allclose(dump.X1c.reshape(-1)[[0, -1]], [-0.5 + 1 / 64, 0.5 - 1 / 64])
    p = sims[0].state.particles
    with h5py.File(dump.file, "r") as h:
        x = h["swarm/photons/swarm.x"][...]
        w = h["swarm/photons/swarm.weight"][...]
        assert "swarm/photons/swarm.y" not in h
    assert x.shape == w.shape == (int(p.alive.sum()),)
    assert (x >= -0.5).all() and (x <= 0.5).all()
    np.testing.assert_array_equal(w, p.weight[p.alive].numpy())


def test_no_dump_when_file_type_none(tmp_path):
    sim = run_file(STEPDIFF, outdir=str(tmp_path),
                   modified_inputs={**SMALL, "parthenon/output0/file_type": "none"},
                   quiet=True, nlim=1, device="cpu")
    # no dump: the run's one file is its per-cycle record
    assert sim.cycle == 1 and [p.name for p in tmp_path.iterdir()] == ["history.json"]


def test_cli_runs_one_cycle(tmp_path):
    cmd = [sys.executable, "-m", "jaybenne_tpu_torch.driver", "-i", STEPDIFF,
           "-d", str(tmp_path), "-n", "1", "--device", "cpu",
           *(f"{k}={v}" for k, v in SMALL.items()), "jaybenne/num_particles=1000"]
    res = subprocess.run(cmd, cwd=_ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "cycle=1 " in res.stdout and "events/s" in res.stdout
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "history.json", "stepdiff.out0.00000.phdf", "stepdiff.out0.00001.phdf"
    ]


def test_deterministic_segment_sum():
    rng = np.random.default_rng(3)
    n, nseg = 5000, 17
    seg = rng.integers(0, nseg, n)
    # a hot/cold spread: the upper bins hold values 1e-20 of the lower ones
    vals = (rng.lognormal(0.0, 3.0, n) * np.where(seg > nseg // 2, 1e-20, 1.0)).astype(np.float32)
    want = np.bincount(seg, weights=vals.astype(np.float64), minlength=nseg)
    got = deterministic_segment_sum(torch.from_numpy(vals), torch.from_numpy(seg), nseg)
    # each value is rounded at 2^-(62 - ceil(log2 n)) = 2^-49 of its bin's largest
    # value, so a bin of ~300 values is good to ~1e-12 of that value
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=0)
    perm = torch.from_numpy(rng.permutation(n))
    again = deterministic_segment_sum(torch.from_numpy(vals)[perm], torch.from_numpy(seg)[perm], nseg)
    assert torch.equal(got, again)  # order-independent, bit for bit
    zero = deterministic_segment_sum(torch.zeros(4), torch.zeros(4, dtype=torch.int64), 3)
    assert torch.equal(zero, torch.zeros(3, dtype=torch.float64))
