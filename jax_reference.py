#!/usr/bin/env python3
"""Reference numbers of the JAX package (``jaybenne_tpu``) for the non-gray paths
of ``chip_smoke.py``: phases 23 (``k1e``), 24 (``k3``) and 25 (``k4``).

Runs the JAX package's ``Simulation`` on the CPU with ``use_pallas = off`` (its
XLA event loop) at the configuration of the phase and prints one JSON line:
events, the initial and surviving particle counts, the survivors' mean photon
energy before and after, the live weight and the absorbed energy. chip_smoke.py
holds the port's run on the GPU to these numbers; it imports nothing of JAX.

    JAX_PLATFORMS=cpu python jax_reference.py k1e     # about 5 s
    JAX_PLATFORMS=cpu python jax_reference.py k3      # about 20 s
    JAX_PLATFORMS=cpu python jax_reference.py k4      # about 5 s
    JAX_PLATFORMS=cpu python jax_reference.py k4 --seed 2   # another seed
"""

import argparse

import json
import os
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# chip_smoke.py's EPB, NG_GATE, NG_BIG and NG_SMR
EPB = {"mcblock/opacity_model": "ep_bremss", "mcblock/initial_temperature": "1.0e6",
       "mcblock/cv": "1.0e8", "mcblock/scattering_constant_value": "1.0e2",
       "jaybenne/do_emission": "false", "jaybenne/do_feedback": "false",
       "jaybenne/dt": "1.e-12", "parthenon/time/tlim": "1.e-12"}
CONFIGS = {
    "k1e": ("stepdiff.in", {"parthenon/mesh/nx1": 128, "parthenon/meshblock/nx1": 128,
                            "jaybenne/num_particles": 100000, **EPB}),
    "k3": ("stepdiff.in", {
        "parthenon/mesh/nx1": 64, "parthenon/mesh/nx2": 64, "parthenon/mesh/nx3": 64,
        "parthenon/mesh/ix2_bc": "periodic", "parthenon/mesh/ox2_bc": "periodic",
        "parthenon/mesh/ix3_bc": "periodic", "parthenon/mesh/ox3_bc": "periodic",
        "parthenon/meshblock/nx1": 8, "parthenon/meshblock/nx2": 8,
        "parthenon/meshblock/nx3": 8, "jaybenne/num_particles": 200000,
        "jaybenne/capacity_factor": 3, **EPB, "jaybenne/do_emission": "true",
        "jaybenne/do_feedback": "true", "parthenon/time/tlim": "3.e-12"}),
    "k4": ("stepdiff_smr.in", {**EPB, "jaybenne/use_ddmc": "false"}),
}


def main(which, seed=None):
    from jaybenne_tpu import config as cm
    from jaybenne_tpu.driver import Simulation
    from jaybenne_tpu.utils.deck import Deck

    deck, mods = CONFIGS[which]
    mods = {**mods, "jaybenne/use_pallas": "off", "parthenon/output0/file_type": "none"}
    if seed is not None:
        mods["jaybenne/seed"] = seed
    cfg = cm.from_deck(Deck.from_file(os.path.join(ROOT, "inputs", deck)).update(mods))
    with tempfile.TemporaryDirectory() as outdir:
        sim = Simulation(cfg, quiet=True, outdir=outdir)
        p0 = sim.state.particles
        a0 = np.asarray(p0.alive)
        t0 = time.time()
        sim.run()
    p = sim.state.particles
    a = np.asarray(p.alive)
    print(json.dumps({
        "which": which, "seed": cfg.jaybenne.seed, "seconds": time.time() - t0, "cycles": sim.cycle,
        "events": int(sim.total_events), "overflow": int(sim.state.overflow),
        "n0": int(a0.sum()), "surv": int(a.sum()),
        "mean_E0": float(np.asarray(p0.energy, np.float64)[a0].mean()),
        "mean_E": float(np.asarray(p.energy, np.float64)[a].mean()),
        "w0": float(np.asarray(p0.weight, np.float64)[a0].sum()),
        "w_live": float(np.asarray(p.weight, np.float64)[a].sum()),
        "absorbed": float(np.asarray(sim.state.fields.energy_delta, np.float64).sum()),
    }))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", choices=sorted(CONFIGS))
    ap.add_argument("--seed", type=int, default=None, help="jaybenne/seed (default: the deck's)")
    args = ap.parse_args()
    main(args.which, args.seed)
