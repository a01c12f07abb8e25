"""Evolution driver and CLI (port of ``jaybenne_tpu/driver.py``, single device).

CLI: ``python -m jaybenne_tpu_torch.driver -i inputs/stepdiff.in [-d outdir]
[-n cycles] [-t HH:MM:SS] [--device cuda|cpu] [block/key=value ...]``.

Restart (``-r``), checkpoint outputs, the Parthenon dump layout, ``history.json``
and profiling arrive with slice 7 (ROADMAP Queue 1, item 16); more than one device
with item 17.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time as _time

import torch

from . import config as config_mod
from . import io as io_mod
from . import state as state_mod
from .mesh import build_mesh
from .models.problems import generate_problem
from .particles import ParticleLedger
from .step import build_step_core, initialize_radiation

_DUMP_TYPES = ("hdf5", "phdf")


class Simulation:
    """Host-side orchestration around the step, on one ``device``."""

    def __init__(self, cfg: config_mod.RunConfig, outdir: str = ".", quiet: bool = False,
                 device="cuda"):
        self.cfg = cfg
        self.outdir = outdir
        os.makedirs(outdir, exist_ok=True)
        self.quiet = quiet
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device cuda requested but torch.cuda.is_available() is false")
        for out in cfg.outputs:
            if out.file_type not in _DUMP_TYPES + ("none",):
                raise config_mod.not_ported(
                    f"output file_type = {out.file_type}", "Queue 1, item 16"
                )
        jb = cfg.jaybenne
        self.dtype = jb.dtype
        self.mesh = build_mesh(cfg.mesh, dtype=self.dtype, device=self.device)
        self.step_fn = build_step_core(self.mesh, cfg)
        state = state_mod.initial_state(self.mesh, self._capacity(), jb.seed, self.dtype)
        state.fields = generate_problem(state.fields, self.mesh, cfg, self.dtype)
        self.state = initialize_radiation(state, self.mesh, cfg)
        self.t = 0.0  # authoritative (host float64) simulation time
        self.cycle = 0
        self.total_events = 0
        self.dump_count = 0
        self._next_dump_t = 0.0
        self.history = []  # per-cycle diagnostics

    def _capacity(self) -> int:
        jb = self.cfg.jaybenne
        # room for census survivors + one step of births + stochastic slack
        return (int(jb.num_particles * jb.capacity_factor) + self.mesh.total_cells + 1024
                + self._ext_births())

    def _ext_births(self) -> int:
        """Births of the external source in one step (0 without it)."""
        jb = self.cfg.jaybenne
        if jb.external_source_q <= 0:
            return 0
        return jb.external_source_num or jb.num_particles

    def _ensure_headroom(self):
        """Grow the particle ledger before the next sourcing could overflow it (the
        JAX driver's ``_ensure_headroom``, the reference's swarm pool growth in
        ``AddEmptyParticles``). Growth at least doubles capacity and keeps every
        particle in its slot. It replaces the ledger's tensors, so nothing may hold
        a pointer or a shape of the old ones across a step."""
        p = self.state.particles
        need = (int(p.num_alive()) + self.cfg.jaybenne.num_particles
                + self._ext_births() + self.mesh.total_cells + 64)
        if need <= p.capacity:
            return
        new_cap = max(need, 2 * p.capacity)
        pad = new_cap - p.capacity
        grown = ParticleLedger(**{
            f.name: torch.cat([getattr(p, f.name), getattr(p, f.name).new_zeros(pad)])
            for f in dataclasses.fields(p)
        })
        self.state = dataclasses.replace(self.state, particles=grown)
        if not self.quiet:
            print(f"ledger grown: capacity {p.capacity} -> {new_cap}", flush=True)

    def _maybe_dump(self, force=False):
        outs = [o for o in self.cfg.outputs if o.file_type in _DUMP_TYPES]
        if not outs:
            return
        out = outs[0]
        if force or (out.dt > 0 and self.t >= self._next_dump_t - 1e-12 * max(out.dt, 1.0)):
            path = io_mod.dump_filename(self.cfg.problem_id, self.dump_count, self.outdir)
            io_mod.write_dump(path, self.state, self.mesh, out.variables, out.swarm_variables)
            self.dump_count += 1
            while out.dt > 0 and self._next_dump_t <= self.t + 1e-12 * max(out.dt, 1.0):
                self._next_dump_t += out.dt

    def run(self, wall_limit_s=None, nlim=None) -> None:
        """Evolve to ``tlim``; ``wall_limit_s`` stops cleanly when the wall clock is
        exceeded, ``nlim`` caps the number of cycles."""
        cfg = self.cfg
        dt = cfg.jaybenne.dt
        tlim = cfg.time.tlim
        n_cycles = max(1, int(round(tlim / dt)))
        if nlim is not None:
            n_cycles = min(n_cycles, max(0, int(nlim)))
        self._maybe_dump()  # initial conditions

        wall0 = _time.time()
        for _ in range(n_cycles):
            step_dt = min(dt, tlim - self.t)
            if step_dt <= 0:
                break
            if wall_limit_s is not None and _time.time() - wall0 >= wall_limit_s:
                print(f"walltime limit reached after {self.cycle} cycles; stopping",
                      file=sys.stderr)
                break
            if cfg.jaybenne.do_emission or self._ext_births():
                self._ensure_headroom()
            t0 = _time.perf_counter()
            self.state, stats = self.step_fn(self.state, step_dt)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            step_s = _time.perf_counter() - t0
            ev = int(stats.events)
            self.t += step_dt
            self.cycle += 1
            iters = int(stats.iterations)
            self.total_events += ev
            self.history.append(
                {
                    "cycle": self.cycle,
                    "time": self.t,
                    "dt": step_dt,
                    "iterations": iters,
                    "events": ev,
                    "alive": int(stats.n_alive),
                    "dropped": int(stats.dropped),
                    "unfinished": int(stats.unfinished),
                    "step_seconds": step_s,
                }
            )
            if not self.quiet:
                print(
                    f"cycle={self.cycle} time={self.t:.6e} dt={step_dt:.6e} "
                    f"iters={iters} events={ev} alive={int(stats.n_alive)}",
                    flush=True,
                )
            if int(stats.unfinished) > 0:
                print(
                    f"WARNING: census incomplete this cycle — "
                    f"{int(stats.unfinished)} particles unfinished",
                    file=sys.stderr,
                )
            if int(stats.dropped) > 0:
                print(
                    f"WARNING: particle ledger overflow, dropped {int(stats.dropped)} "
                    f"sourced particles (raise jaybenne/capacity_factor)",
                    file=sys.stderr,
                )
            if int(stats.cap_hits) > 0:
                print(
                    f"WARNING: transport hit max_transport_iterations "
                    f"({cfg.jaybenne.max_transport_iterations}); census incomplete "
                    "this cycle",
                    file=sys.stderr,
                )
            self._maybe_dump()
        self.walltime = _time.time() - wall0
        self._maybe_dump(force=True)
        if not self.quiet:
            rate = self.total_events / max(self.walltime, 1e-9)
            print(
                f"walltime={self.walltime:.3f}s events={self.total_events} "
                f"({rate:.3e} events/s)",
                flush=True,
            )


def run_file(input_path, outdir=".", modified_inputs=None, quiet=False,
             wall_limit_s=None, nlim=None, device="cuda") -> Simulation:
    from .utils.deck import Deck

    deck = Deck.from_file(input_path).update(modified_inputs or {})
    cfg = config_mod.from_deck(deck)
    sim = Simulation(cfg, outdir=outdir, quiet=quiet, device=device)
    sim.run(wall_limit_s=wall_limit_s, nlim=nlim)
    return sim


def _parse_walltime(text):
    """'HH:MM:SS' / 'MM:SS' / plain seconds -> seconds; ValueError on bad input."""
    fields = str(text).split(":")
    if len(fields) > 3:
        raise ValueError(f"walltime {text!r} has more than 3 ':' fields")
    secs = 0.0
    for v in (float(x) for x in fields):
        secs = secs * 60.0 + v
    return secs


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="IMC thermal photon transport on PyTorch + CUDA"
    )
    ap.add_argument("-i", "--input", required=True, help="input deck (.in)")
    ap.add_argument("-d", "--outdir", default=".", help="output directory")
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("-t", "--walltime", default=None, metavar="HH:MM:SS",
                    help="wall-clock limit; stop cleanly (with final dumps) when exceeded")
    ap.add_argument("-n", "--nlim", type=int, default=None, help="max number of cycles")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("overrides", nargs="*", metavar="block/key=value",
                    help="input-deck overrides, e.g. jaybenne/num_particles=1000")
    args = ap.parse_args(argv)
    wall_limit_s = None
    if args.walltime:
        try:
            wall_limit_s = _parse_walltime(args.walltime)
        except ValueError:
            ap.error(f"invalid -t/--walltime {args.walltime!r}: expected seconds, "
                     "MM:SS, or HH:MM:SS")
    mods = {}
    for ov in args.overrides:
        if "=" not in ov or "/" not in ov.split("=", 1)[0]:
            ap.error(f"override must look like block/key=value, got: {ov!r}")
        k, v = ov.split("=", 1)
        mods[k] = v
    run_file(args.input, outdir=args.outdir, modified_inputs=mods, quiet=args.quiet,
             wall_limit_s=wall_limit_s, nlim=args.nlim, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
