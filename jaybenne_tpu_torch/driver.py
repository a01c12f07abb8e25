"""Evolution driver and CLI (port of ``jaybenne_tpu/driver.py``).

CLI: ``python -m jaybenne_tpu_torch.driver -i inputs/stepdiff.in [-d outdir]
[-n cycles] [-t HH:MM:SS] [--device cuda|cpu] [block/key=value ...]``.

``jaybenne/n_devices`` shards (0: the world size of an initialised
``torch.distributed`` group, 1 outside one) run the particle decomposition, or
with ``jaybenne/decomposition = spatial`` (at any count) the spatial one. Outside
a process group every shard runs in this process on the one device (backend (b)
of ``parallel/exchange.py``); inside one each rank runs its own shard. The capacity
is padded to a multiple of the shard count, and each shard's ledger is a slice of
it.

Restart (``-r``), checkpoint outputs, the Parthenon dump layout, ``history.json``
and profiling arrive with slice 7 (ROADMAP Queue 1, item 16), and with it dumps
from a process group.
"""

from __future__ import annotations

import argparse
import copy
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
from .parallel import exchange as exchange_mod
from .parallel import sharding, spatial
from .particles import ParticleLedger
from .step import build_step_core, initialize_radiation

_DUMP_TYPES = ("hdf5", "phdf")


class Simulation:
    """Host-side orchestration around the step, on one ``device``. ``state`` is
    the run's ``SimState``; under a decomposition it is assembled from the local
    shards' states (the fields of every shard, the one ledger their ledgers are
    slices of), the process's own shard only in a process group."""

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
        world = exchange_mod.world_size()
        self.n_shards = jb.n_devices or world
        self.spatial = jb.decomposition == "spatial"
        # the spatial decomposition always runs through its rounds, at one shard too
        self.exchange = None
        if self.n_shards > 1 or self.spatial or world > 1:
            self.exchange = exchange_mod.exchange_for(jb.n_devices)
            if world > 1 and any(o.file_type != "none" for o in cfg.outputs):
                raise config_mod.not_ported("dumps from a process group", "Queue 1, item 16")
        state = state_mod.initial_state(self.mesh, self._capacity(), jb.seed, self.dtype)
        state.fields = generate_problem(state.fields, self.mesh, cfg, self.dtype)
        self.shards, self._state, self._ledger = None, None, None
        if self.exchange is None:
            self.step_fn = build_step_core(self.mesh, cfg)
            self._state = initialize_radiation(state, self.mesh, cfg)
        else:
            self._ledger = state.particles
            ex, mesh = self.exchange, self.mesh
            if self.spatial:
                self.step_fn = spatial.build_spatial_step_core(mesh, cfg, ex)
                padded = spatial.pad_field_blocks(state.fields, mesh, ex.n)
                states = sharding.local_states(
                    state, ex, lambda s: spatial.shard_fields(padded, mesh, ex.n, s))
                self.shards = spatial.make_spatial_init(mesh, cfg, ex)(states)
            else:
                self.step_fn = sharding.make_sharded_step(mesh, cfg, ex)
                states = sharding.local_states(state, ex)
                self.shards = sharding.make_sharded_init(mesh, cfg, ex)(states)
        self.t = 0.0  # authoritative (host float64) simulation time
        self.cycle = 0
        self.total_events = 0
        self.dump_count = 0
        self._next_dump_t = 0.0
        self.history = []  # per-cycle diagnostics

    @property
    def state(self) -> state_mod.SimState:
        if self.shards is None:
            return self._state
        first = self.shards[0]
        fields = first.fields
        if self.spatial and len(self.shards) == self.exchange.n:
            fields = spatial.gather_fields([st.fields for st in self.shards], self.mesh)
        return dataclasses.replace(first, fields=fields, particles=self._ledger)

    def snapshot(self):
        """A copy of the run's state and clock, for ``restore``."""
        return copy.deepcopy((self._state, self.shards, self._ledger, self.t, self.cycle))

    def restore(self, snap) -> None:
        """Back to a ``snapshot`` (which stays usable)."""
        (self._state, self.shards, self._ledger, self.t, self.cycle) = copy.deepcopy(snap)

    def _capacity(self) -> int:
        """The process's ledger capacity: under a decomposition its shards' slices,
        the whole padded to a multiple of the shard count."""
        jb = self.cfg.jaybenne
        # room for census survivors + one step of births + stochastic slack
        cap = (int(jb.num_particles * jb.capacity_factor) + self.mesh.total_cells + 1024
               + self._ext_births())
        if self.exchange is None:
            return cap
        cap = sharding.pad_capacity(cap, self.exchange.n)
        return cap // self.exchange.n * len(self.exchange.shards)

    def _ext_births(self) -> int:
        """Births of the external source in one step (0 without it); under the
        spatial decomposition as many per shard, since one shard may own the whole
        source box."""
        jb = self.cfg.jaybenne
        if jb.external_source_q <= 0:
            return 0
        n = jb.external_source_num or jb.num_particles
        return n * (self.exchange.n if self.spatial else 1)

    def _ensure_headroom(self):
        """Grow the particle ledger before the next sourcing could overflow it (the
        JAX driver's ``_ensure_headroom``, the reference's swarm pool growth in
        ``AddEmptyParticles``). Growth at least doubles capacity and keeps every
        particle in its slot. It replaces the ledger's tensors, so nothing may hold
        a pointer or a shape of the old ones across a step."""
        p = self.state.particles
        extra = (self.cfg.jaybenne.num_particles + self._ext_births() + self.mesh.total_cells
                 + 64)
        if self.exchange is None:
            need = int(p.num_alive()) + extra
            if need <= p.capacity:
                return
            new_cap = max(need, 2 * p.capacity)
            pad = new_cap - p.capacity
            grown = ParticleLedger(**{
                f.name: torch.cat([getattr(p, f.name), getattr(p, f.name).new_zeros(pad)])
                for f in dataclasses.fields(p)
            })
            self._state = dataclasses.replace(self._state, particles=grown)
        else:
            # every shard grows alike and keeps its particles in their slots
            ex = self.exchange
            alive = ex.sum([st.particles.alive.sum(dtype=torch.int64) for st in self.shards])
            cap_l = p.capacity // len(ex.shards)
            need = int(alive[0]) + extra
            if need <= cap_l * ex.n:
                return
            new_cap = sharding.pad_capacity(max(need, 2 * cap_l * ex.n), ex.n)
            self._ledger = sharding.grow_ledger(p, len(ex.shards), new_cap // ex.n)
            self.shards = [dataclasses.replace(st, particles=q) for st, q in zip(
                self.shards, sharding.split_ledger(self._ledger, len(ex.shards)))]
            new_cap = self._ledger.capacity
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
            if self.shards is None:
                self._state, stats = self.step_fn(self._state, step_dt)
            else:
                self.shards, stats = self.step_fn(self.shards, step_dt)
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
                    "migration_rounds": stats.migration_rounds,
                    "migrated": stats.migrated,
                    "unfinished": int(stats.unfinished),
                    "step_seconds": step_s,
                }
            )
            if not self.quiet:
                mig = (f" mig_rounds={stats.migration_rounds} migrated={stats.migrated}"
                       if stats.migration_rounds else "")
                print(
                    f"cycle={self.cycle} time={self.t:.6e} dt={step_dt:.6e} "
                    f"iters={iters} events={ev} alive={int(stats.n_alive)}" + mig,
                    flush=True,
                )
            if int(stats.unfinished) > 0:
                after = (f" after {stats.migration_rounds} migration rounds"
                         if self.spatial else "")
                print(
                    f"WARNING: census incomplete this cycle — "
                    f"{int(stats.unfinished)} particles unfinished{after}",
                    file=sys.stderr,
                )
            if int(stats.dropped) > 0:
                what = ("sourced or migrated particles (a migration arrival finds no free "
                        "slot)" if self.spatial else "sourced particles")
                print(
                    f"WARNING: particle ledger overflow, dropped {int(stats.dropped)} "
                    f"{what} (raise jaybenne/capacity_factor)",
                    file=sys.stderr,
                )
            if int(stats.cap_hits) > 0:
                print(
                    f"WARNING: {int(stats.cap_hits)} transport call(s) hit "
                    f"max_transport_iterations ({cfg.jaybenne.max_transport_iterations}); "
                    "census incomplete this cycle",
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
