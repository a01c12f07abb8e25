"""Evolution driver and CLI (port of ``jaybenne_tpu/driver.py``).

CLI: ``python -m jaybenne_tpu_torch.driver -i inputs/stepdiff.in [-d outdir]
[-r checkpoint.rhdf] [-n cycles] [-t HH:MM:SS] [--device cuda|cpu]
[--profile-dir DIR] [block/key=value ...]``.

``jaybenne/n_devices`` shards (0: the world size of an initialised
``torch.distributed`` group, 1 outside one) run the particle decomposition, or
with ``jaybenne/decomposition = spatial`` (at any count) the spatial one. Outside
a process group every shard runs in this process on the one device (backend (b)
of ``parallel/exchange.py``); inside one each rank runs its own shard. The capacity
is padded to a multiple of the shard count, and each shard's ledger is a slice of
it.

Outputs: dumps (``file_type = hdf5`` or ``phdf``: the compact schema;
``phdf_parthenon``: Parthenon's layout) and checkpoints (``rst`` or ``restart``:
``{problem_id}.ckpt.{cycle:05d}.rhdf``), each on its ``dt``, and ``history.json``
(the per-cycle record) at the run's end; any other output type (Parthenon's
``hst``, say) is skipped with a warning, as the JAX driver skips it. In a process group rank 0 gathers the
real blocks' fields and the whole ledger through the exchange and writes; the
other ranks write nothing. ``restart`` (``-r``) resumes from a checkpoint file of
either package, or from a checkpoint tree (``io.checkpoint_tree``), at any shard
count: under the spatial decomposition the ledger is first re-homed
(``spatial.rehome_restart_ledger``), and in a process group each rank keeps its
own slices. ``jaybenne/debug_checks`` validates the state after every step
(``utils/debug.py``); ``--profile-dir`` runs the run under ``torch.profiler`` and
writes its Chrome trace there.

On a GPU a step that runs the kernel's census runs as CUDA graphs (``graph.py``):
the first step eagerly, then captured and replayed. The single-device step (an
external source's too: its window is copied to the device before each replay) is
one graph, and so is the particle decomposition's step over the in-process
exchange's shards (one census launch over every shard's slice); the spatial
decomposition's step with the in-process exchange is a graph of its head, one of
a batch of migration rounds and one of its tail, with one host read a batch, the
next batch queued before it. The CPU, ``use_pallas = off`` (the plain census
reads its exit test) and a ``torch.distributed`` step of either decomposition run
eagerly (``capturable``); ``Simulation(graph=False)`` asks for the eager step
anywhere. Either way the step queues its work without waiting for the device but
for a spatial batch's exit read, and the driver waits once a step: it enqueues
one copy of the step's packed counters (``StepStats``) into a pinned buffer,
synchronises, and reads every counter from there.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import sys
import time as _time
import warnings

import torch

from . import config as config_mod
from . import io as io_mod
from . import state as state_mod
from .mesh import build_mesh
from .models.problems import generate_problem
from .parallel import exchange as exchange_mod
from .parallel import sharding, spatial
from .graph import GraphedSpatialStep, GraphedStep, state_tensors
from .particles import ParticleLedger
from .step import STAT_NAMES, StepStats, build_step_core, initialize_radiation
from .utils.debug import validate_state

_DUMP_TYPES = ("hdf5", "phdf", "phdf_parthenon")
_RESTART_TYPES = ("rst", "restart")


class Simulation:
    """Host-side orchestration around the step, on one ``device``. ``state`` is
    the run's ``SimState``; under a decomposition it is assembled from the local
    shards' states (the fields of every shard, the one ledger their ledgers are
    slices of), the process's own shard only in a process group.
    ``rounds_per_batch`` is the spatial step's (``build_spatial_step_core``'s
    default when None)."""

    def __init__(self, cfg: config_mod.RunConfig, outdir: str = ".", quiet: bool = False,
                 device="cuda", restart=None, graph=True, rounds_per_batch=None):
        self.cfg = cfg
        self.outdir = outdir
        os.makedirs(outdir, exist_ok=True)
        self.quiet = quiet
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device cuda requested but torch.cuda.is_available() is false")
        # an output type this driver does not write (a Parthenon history file,
        # ``hst``, say) is skipped, as the JAX driver skips it
        for out in cfg.outputs:
            if out.file_type not in _DUMP_TYPES + _RESTART_TYPES + ("none",):
                warnings.warn(f"output file_type = {out.file_type} is not written (only "
                              f"{', '.join(_DUMP_TYPES + _RESTART_TYPES)} are)", stacklevel=2)
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
        # the process that writes outputs: rank 0 of a process group
        self.writes = self.exchange is None or self.exchange.shards[0] == 0
        if restart is None:
            state = state_mod.initial_state(self.mesh, self._capacity(local=True), jb.seed,
                                            self.dtype)
            state.fields = generate_problem(state.fields, self.mesh, cfg, self.dtype)
        else:
            state = self._restored(restart)
        self.shards, self._state, self._ledger = None, None, None
        self.graphed = False
        if self.exchange is None:
            self.step_fn = build_step_core(self.mesh, cfg)
            # a CUDA graph where the step can be captured, unless graph=False asks
            # for the eager step
            self.graphed = graph and self.device.type == "cuda" and self.step_fn.capturable
            if self.graphed:
                self.step_fn = GraphedStep(self.step_fn)
            self._state = state if restart is not None else initialize_radiation(
                state, self.mesh, cfg)
        else:
            self._ledger = state.particles
            ex, mesh = self.exchange, self.mesh
            if self.spatial:
                self.step_fn = spatial.build_spatial_step_core(mesh, cfg, ex,
                                                               rounds_per_batch)
                self.graphed = (graph and self.device.type == "cuda"
                                and self.step_fn.capturable)
                if self.graphed:
                    self.step_fn = GraphedSpatialStep(self.step_fn)
                padded = spatial.pad_field_blocks(state.fields, mesh, ex.n)
                states = sharding.local_states(
                    state, ex, lambda s: spatial.shard_fields(padded, mesh, ex.n, s))
                init = spatial.make_spatial_init(mesh, cfg, ex)
            else:
                self.step_fn = sharding.make_sharded_step(mesh, cfg, ex)
                self.graphed = (graph and self.device.type == "cuda"
                                and self.step_fn.capturable)
                if self.graphed:
                    self.step_fn = GraphedStep(self.step_fn)
                states = sharding.local_states(state, ex)
                init = sharding.make_sharded_init(mesh, cfg, ex)
            self.shards = states if restart is not None else init(states)
        self.t = float(state.t)  # authoritative (host float64) simulation time
        self.cycle = int(state.cycle)
        # the last step's counters, read from one copy of StepStats.packed; before
        # the first step the live counts of the initial or restored ledger
        self._stats_buf = torch.empty(len(STAT_NAMES), dtype=torch.int64,
                                      pin_memory=self.device.type == "cuda")
        self._counts = self._live_counts()
        self.total_events = 0
        self.dump_count = 0
        self._next_dump_t = self.t
        self._next_rst_t = None
        self.history = []  # per-cycle diagnostics (written to history.json)
        if restart is not None and not quiet:
            what = restart if isinstance(restart, (str, os.PathLike)) else "a checkpoint tree"
            print(f"restarted from {what} at t={self.t:.6e} cycle={self.cycle}", flush=True)

    def _live_counts(self) -> dict:
        """``StepStats``'s ``n_alive`` and ``alive_max`` of the present ledger, in
        one read (under a decomposition a collective: every rank calls it)."""
        if self.exchange is None:
            n = self._state.particles.alive.sum(dtype=torch.int64)
            alive = [n, n]
        else:
            ex = self.exchange
            mine = [st.particles.alive.sum(dtype=torch.int64) for st in self.shards]
            alive = [ex.sum(mine)[0], ex.max(mine)[0]]
        return dict(zip(("n_alive", "alive_max"), torch.stack(alive).tolist()))

    def _restored(self, restart) -> state_mod.SimState:
        """The process's state from a checkpoint (a file, or a tree of
        ``io.checkpoint_tree``): the whole ledger at the deck's capacity or the
        checkpoint's, whichever is larger (a ledger that grew keeps every slot, and
        with it every stream), under the spatial decomposition re-homed onto its
        shards' slices; then the process's own slices of it."""
        tree = (io_mod.read_checkpoint_tree(restart)
                if isinstance(restart, (str, os.PathLike)) else restart)
        cap = max(self._capacity(local=False), len(tree["particles/alive"]))
        if self.exchange is not None:
            cap = sharding.pad_capacity(cap, self.exchange.n)
        whole = state_mod.initial_state(self.mesh, cap, self.cfg.jaybenne.seed, self.dtype)
        state = io_mod.state_from_checkpoint_tree(tree, whole)
        if self.exchange is None:
            return state
        ex = self.exchange
        p = state.particles
        if self.spatial:
            p = spatial.rehome_restart_ledger(p, self.mesh, ex.n)
        cap_l = p.capacity // ex.n
        lo, hi = ex.shards[0] * cap_l, (ex.shards[-1] + 1) * cap_l
        if (lo, hi) != (0, p.capacity):
            p = ParticleLedger(**{f.name: getattr(p, f.name)[lo:hi].clone()
                                  for f in dataclasses.fields(p)})
        return dataclasses.replace(state, particles=p)

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
        """Back to a ``snapshot`` (which stays usable). The snapshot's values are
        copied into the state's own tensors (each shard's) where they have its
        shapes, so that a step's CUDA graphs, which hold their pointers, stay
        valid."""
        mine = [self._state] if self.shards is None else self.shards
        theirs = [snap[0]] if self.shards is None else snap[1]
        if len(mine) == len(theirs) and all(map(_same_layout, mine, theirs)):
            for a, b in zip(mine, theirs):
                for dst, src in zip(state_tensors(a), state_tensors(b)):
                    dst.copy_(src)
            new = [dataclasses.replace(a, t=b.t, cycle=b.cycle) for a, b in zip(mine, theirs)]
            if self.shards is None:
                self._state = new[0]
            else:
                self.shards = new
            self.t, self.cycle = snap[3], snap[4]
        else:
            (self._state, self.shards, self._ledger, self.t, self.cycle) = copy.deepcopy(snap)
        self._counts = self._live_counts()

    def _capacity(self, local: bool) -> int:
        """The run's ledger capacity, under a decomposition padded to a multiple of
        the shard count; with ``local`` the process's shards' slices of it."""
        jb = self.cfg.jaybenne
        # room for census survivors + one step of births + stochastic slack
        cap = (int(jb.num_particles * jb.capacity_factor) + self.mesh.total_cells + 1024
               + self._ext_births())
        if self.exchange is None:
            return cap
        cap = sharding.pad_capacity(cap, self.exchange.n)
        return cap // self.exchange.n * len(self.exchange.shards) if local else cap

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
            need = self._counts["n_alive"] + extra
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
            cap_l = p.capacity // len(ex.shards)
            if self.spatial:
                # a birth lands in the slice of the shard that owns its cell, and one
                # shard may own every source: the fullest slice needs a step's room
                need_l = self._counts["alive_max"] + extra
            else:
                need_l = -(-(self._counts["n_alive"] + extra) // ex.n)
            if need_l <= cap_l:
                return
            self._ledger = sharding.grow_ledger(p, len(ex.shards), max(need_l, 2 * cap_l))
            self.shards = [dataclasses.replace(st, particles=q) for st, q in zip(
                self.shards, sharding.split_ledger(self._ledger, len(ex.shards)))]
            new_cap = self._ledger.capacity
        if not self.quiet:
            print(f"ledger grown: capacity {p.capacity} -> {new_cap}", flush=True)

    def whole_state(self) -> state_mod.SimState:
        """The run's state with the real blocks' fields and the whole ledger: in a
        process group gathered through the exchange (a collective: every rank
        calls it), else ``state``."""
        if self.exchange is None or len(self.exchange.shards) == self.exchange.n:
            return self.state
        ex, st = self.exchange, self.shards[0]

        def gather(t):
            if t.dtype == torch.bool:  # gathered as bytes
                return ex.all_gather([t.to(torch.uint8)])[0].bool()
            return ex.all_gather([t])[0]

        fields = st.fields
        if self.spatial:
            fields = dataclasses.replace(fields, **{
                f.name: gather(getattr(fields, f.name))[:self.mesh.n_blocks]
                for f in dataclasses.fields(fields)})
        ledger = ParticleLedger(**{f.name: gather(getattr(st.particles, f.name))
                                   for f in dataclasses.fields(st.particles)})
        return dataclasses.replace(st, fields=fields, particles=ledger)

    def checkpoint_tree(self) -> dict:
        """The run's checkpoint tree (``io.checkpoint_tree`` of ``whole_state`` at the
        host clock), what ``restart`` takes."""
        return io_mod.checkpoint_tree(self.whole_state(), self.mesh, t=self.t,
                                      cycle=self.cycle)

    def write_checkpoint(self, path=None) -> str:
        """Write ``{problem_id}.ckpt.{cycle:05d}.rhdf`` (or ``path``) from rank 0;
        every rank of a process group calls it. Returns the path."""
        path = path or os.path.join(self.outdir,
                                    f"{self.cfg.problem_id}.ckpt.{self.cycle:05d}.rhdf")
        st = self.whole_state()
        if self.writes:
            io_mod.write_checkpoint(path, st, self.mesh, t=self.t, cycle=self.cycle)
        return path

    def _maybe_dump(self, force=False):
        outs = [o for o in self.cfg.outputs if o.file_type in _DUMP_TYPES]
        if outs:
            out = outs[0]
            if force or (out.dt > 0
                         and self.t >= self._next_dump_t - 1e-12 * max(out.dt, 1.0)):
                path = io_mod.dump_filename(self.cfg.problem_id, self.dump_count, self.outdir)
                writer = (io_mod.write_dump_parthenon if out.file_type == "phdf_parthenon"
                          else io_mod.write_dump)
                st = self.whole_state()
                if self.writes:
                    writer(path, st, self.mesh, out.variables, out.swarm_variables)
                self.dump_count += 1
                while out.dt > 0 and self._next_dump_t <= self.t + 1e-12 * max(out.dt, 1.0):
                    self._next_dump_t += out.dt
        rsts = [o for o in self.cfg.outputs if o.file_type in _RESTART_TYPES]
        if rsts:
            out = rsts[0]
            if self._next_rst_t is None:
                self._next_rst_t = out.dt
            if out.dt > 0 and self.t >= self._next_rst_t - 1e-12 * out.dt:
                self.write_checkpoint()
                while self._next_rst_t <= self.t + 1e-12 * out.dt:
                    self._next_rst_t += out.dt

    def write_history(self) -> None:
        """``history.json`` in the output directory (rank 0): the JAX package's keys
        and, a cycle, the port's ``step_seconds``."""
        if not self.writes:
            return
        with open(os.path.join(self.outdir, "history.json"), "w") as fh:
            json.dump({"problem_id": self.cfg.problem_id, "walltime_s": self.walltime,
                       "total_events": self.total_events, "cycles": self.history}, fh,
                      indent=1)

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
            stats.copy_to(self._stats_buf)  # the step's one read, enqueued
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            step_s = _time.perf_counter() - t0
            c = self._counts = StepStats.values(self._stats_buf)
            ev = c["events"]
            self.t += step_dt
            self.cycle += 1
            self.total_events += ev
            self.history.append(
                {
                    "cycle": self.cycle,
                    "time": self.t,
                    "dt": step_dt,
                    "iterations": c["iterations"],
                    "events": ev,
                    "alive": c["n_alive"],
                    "dropped": c["dropped"],
                    "migration_rounds": c["migration_rounds"],
                    "migrated": c["migrated"],
                    "unfinished": c["unfinished"],
                    "step_seconds": step_s,
                }
            )
            if not self.quiet:
                mig = (f" mig_rounds={c['migration_rounds']} migrated={c['migrated']}"
                       if c["migration_rounds"] else "")
                print(
                    f"cycle={self.cycle} time={self.t:.6e} dt={step_dt:.6e} "
                    f"iters={c['iterations']} events={ev} alive={c['n_alive']}" + mig,
                    flush=True,
                )
            if c["unfinished"] > 0:
                after = (f" after {c['migration_rounds']} migration rounds"
                         if self.spatial else "")
                print(
                    f"WARNING: census incomplete this cycle — "
                    f"{c['unfinished']} particles unfinished{after}",
                    file=sys.stderr,
                )
            if c["dropped"] > 0:
                what = ("sourced or migrated particles (a migration arrival finds no free "
                        "slot)" if self.spatial else "sourced particles")
                print(
                    f"WARNING: particle ledger overflow, dropped {c['dropped']} "
                    f"{what} (raise jaybenne/capacity_factor)",
                    file=sys.stderr,
                )
            if cfg.jaybenne.debug_checks:
                validate_state(self.state, self.mesh, cfg)
            if c["cap_hits"] > 0:
                print(
                    f"WARNING: {c['cap_hits']} transport call(s) hit "
                    f"max_transport_iterations ({cfg.jaybenne.max_transport_iterations}); "
                    "census incomplete this cycle",
                    file=sys.stderr,
                )
            self._maybe_dump()
        self.walltime = _time.time() - wall0
        self._maybe_dump(force=True)
        self.write_history()
        if not self.quiet:
            rate = self.total_events / max(self.walltime, 1e-9)
            print(
                f"walltime={self.walltime:.3f}s events={self.total_events} "
                f"({rate:.3e} events/s)",
                flush=True,
            )


def _same_layout(a, b) -> bool:
    """Whether two states' tensors agree in shape, dtype and device, one by one."""
    return all(x.shape == y.shape and x.dtype == y.dtype and x.device == y.device
               for x, y in zip(state_tensors(a), state_tensors(b)))


def run_file(input_path, outdir=".", modified_inputs=None, quiet=False, restart=None,
             wall_limit_s=None, nlim=None, device="cuda", graph=True) -> Simulation:
    """Run a deck; ``graph`` is ``Simulation``'s (False: the eager step)."""
    from .utils.deck import Deck

    deck = Deck.from_file(input_path).update(modified_inputs or {})
    cfg = config_mod.from_deck(deck)
    sim = Simulation(cfg, outdir=outdir, quiet=quiet, device=device, restart=restart,
                     graph=graph)
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
    ap.add_argument("-r", "--restart", default=None, help="checkpoint (.rhdf) to resume")
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("--profile-dir", default=None,
                    help="run under torch.profiler and write its Chrome trace here")
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
    with (profiled(args.profile_dir, args.device) if args.profile_dir
          else contextlib.nullcontext()):
        run_file(args.input, outdir=args.outdir, modified_inputs=mods, quiet=args.quiet,
                 restart=args.restart, wall_limit_s=wall_limit_s, nlim=args.nlim,
                 device=args.device)
    return 0


@contextlib.contextmanager
def profiled(trace_dir, device):
    """Run the body under ``torch.profiler`` (CPU activities, and on a GPU the
    device's), then write its Chrome trace to ``trace_dir``: ``trace.json``, or
    ``trace.<rank>.json`` in a process group. ``profile.device_time_by_name``
    reads it."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    name = "trace.json"
    if exchange_mod.world_size() > 1:
        import torch.distributed as dist

        name = f"trace.{dist.get_rank()}.json"
    prof.export_chrome_trace(os.path.join(trace_dir, name))


if __name__ == "__main__":
    sys.exit(main())
