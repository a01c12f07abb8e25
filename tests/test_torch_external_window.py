"""The external source's window read from a device buffer (the Su-Olson step as a
CUDA graph): the step's prologue writes the window from the host clock and its
body holds no host float of ``t``. On the CPU, steps across ``tmax`` (a full, a
partial and then empty windows) repeat bitwise the eager steps of the code
before the window moved, whose counts and state digests are recorded here, on
one device and under both decompositions."""

import dataclasses
import hashlib
import os
import tempfile

import numpy as np
import pytest
import torch

from jaybenne_tpu_torch import config as tcm
from jaybenne_tpu_torch.driver import Simulation
from jaybenne_tpu_torch.ops import sourcing
from jaybenne_tpu_torch.step import build_step_core
from jaybenne_tpu_torch.utils.deck import Deck

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUOLSON = os.path.join(_ROOT, "inputs", "suolson.in")
# suolson.in as tst/suolson.py closes it, at 600 + 600 particles, with tmax in the
# middle of the third step: steps 1-2 a full window, 3 half of one, 4-5 none
MODS = {"parthenon/swarm/ix1_bc": "jaybenne_reflecting",
        "parthenon/swarm/ox1_bc": "jaybenne_reflecting",
        "parthenon/output0/file_type": "none", "jaybenne/num_particles": 600,
        "jaybenne/external_source_num": 600, "jaybenne/external_source_tmax": "2.5e-12",
        "parthenon/time/tlim": "5.e-12"}
STEPS = 5
# (iterations, events, alive, migration rounds, digest of every field and ledger
# column) after each step, recorded from the eager step whose sourcing computed
# the window from the host clock inside the step (same seed, same CPU)
KNOWN = {
    "single": ({}, [(4, 2006, 900, 0, "5c92821020c51106"), (4, 4031, 1379, 0, "db0c0829a59a804a"),
                    (4, 5490, 1588, 0, "fb5b6a2b6956a415"), (4, 4714, 1315, 0, "797829cae27a179a"),
                    (4, 4133, 1197, 0, "bfa25b317a749a48")]),
    "particle": ({"jaybenne/n_devices": 2},
                 [(4, 1999, 914, 0, "d620b6e6779d9933"), (4, 4229, 1429, 0, "e0d4e8de1e1f4bc0"),
                  (4, 5600, 1613, 0, "d6d197d2da96f5c3"), (4, 4842, 1350, 0, "ff0d2f773925054f"),
                  (4, 4221, 1189, 0, "b38c21e00c444872")]),
    "spatial": ({"jaybenne/n_devices": 2, "jaybenne/decomposition": "spatial",
                 "parthenon/meshblock/nx1": 16},
                [(7, 1969, 890, 2, "a65d2ee0dd92eab6"), (7, 4108, 1365, 2, "006fbb85bfcf7561"),
                 (7, 5548, 1643, 2, "f740334156b96300"), (7, 4889, 1325, 2, "e5337b99b4497659"),
                 (7, 4222, 1182, 2, "086d6b24e0c5fe41")]),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _digest(state) -> str:
    h = hashlib.sha256()
    for obj in (state.fields, state.particles):
        for f in dataclasses.fields(obj):
            t = getattr(obj, f.name)
            if isinstance(t, torch.Tensor):
                h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def _sim(mods, tmp):
    cfg = tcm.from_deck(Deck.from_file(SUOLSON).update({**MODS, **mods}))
    return Simulation(cfg, outdir=tmp, quiet=True, device="cpu")


@pytest.mark.parametrize("name", sorted(KNOWN))
def test_steps_across_tmax_repeat_the_eager_steps(name):
    """Five steps across ``tmax`` (full, half and empty windows) repeat the
    recorded counts and every field and ledger column bitwise."""
    extra, want = KNOWN[name]
    with tempfile.TemporaryDirectory() as tmp:
        sim = _sim(extra, tmp)
        got = []
        for _ in range(STEPS):
            sim.run(nlim=1)
            h = sim.history[-1]
            got.append((h["iterations"], h["events"], h["alive"], h["migration_rounds"],
                        _digest(sim.state)))
    assert got == want


def test_prologue_writes_the_window_and_the_body_reads_no_clock():
    """The single-device Su-Olson step is capturable. Its prologue writes the
    window (``q * overlap``, ``overlap / dt``, each formed in float64 and rounded
    once to float32) for a full, a partial and an empty window; its body, given
    states whose host clock is NaN after the prologue, makes the step the
    prologue's clock makes, bitwise."""
    with tempfile.TemporaryDirectory() as tmp:
        sim = _sim({}, tmp)
        step = build_step_core(sim.mesh, sim.cfg)
        assert step.capturable
        ext = sourcing.external_source_setup(sim.mesh, sim.cfg.jaybenne)
        dt = sim.cfg.jaybenne.dt
        seen = []
        real = sourcing.birth_counts

        def spy(*args, **kw):
            if kw.get("source_type") == "external":
                seen.append(kw["window"].clone())
            return real(*args, **kw)

        sourcing.birth_counts = spy
        try:
            state = sim.state
            for t, kind in ((0.0, "full"), (2.0e-12, "partial"), (3.0e-12, "empty")):
                # the window as the step computed it before it moved to the prologue
                overlap = min(max(min(t + dt, ext.tmax) - t, 0.0), dt)
                assert (overlap == dt, 0.0 < overlap < dt, overlap == 0.0)[
                    ("full", "partial", "empty").index(kind)]
                got = ext.window(t, dt)
                assert got == (ext.q * overlap, overlap / dt)
                base = dataclasses.replace(state, t=t)
                snap = [base.particles.clone(), base.fields]
                step.prologue([base], dt)
                a, _ = step.body([base], dt)
                assert seen[-1].numpy().tobytes() == np.float32(got).tobytes()
                first = _digest(a[0])
                base = dataclasses.replace(state, particles=snap[0], fields=snap[1],
                                           t=float("nan"))
                step.prologue([dataclasses.replace(base, t=t)], dt)
                b, _ = step.body([base], dt)
                assert _digest(b[0]) == first
                state = dataclasses.replace(a[0], t=state.t)
        finally:
            sourcing.birth_counts = real
