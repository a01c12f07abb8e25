"""The radiation step (port of ``jaybenne_tpu/step.py``).

One cycle from t to t + dt: derived fields (the Fleck factor and, with DDMC, the
face probabilities), emission sourcing, the external volume source, census
transport, the absorption deposition, the tally, the fluid update, and the
per-step reset of ``tau`` and ``absorbed``.

``build_step_core`` without an exchange is the single-device step on one
``SimState``. With one (``parallel/exchange.py``) it is the particle
decomposition's step (JAX ``build_step_core(axis_name=...)`` under ``shard_map``):
it takes and returns the list of the local shards' states, each holding a slice
of the ledger and a replica of the fields. Each shard sources its share of the
births, with the per-cell birth counts summed over the shards before the weights
are set, transports its own particles with no communication, and the tallies are
reduced over the shards in the integer domain, so they are bitwise those of the
concatenated ledger. The replicated fields give every shard the same
coefficients, so one census call runs every local shard's slice in one launch on
one table, each lane keyed by its slot in its own shard's slice: bitwise the
calls shard by shard. The spatial decomposition's step is
``parallel/spatial.py``.

A step waits for the device nowhere: every shape is fixed by the configuration
(the static-shape insert of ``particles.py``), every counter stays a device
tensor (``StepStats``, packed for the driver's one read a step; ``overflow``),
and each constant it needs is made once (``utils/device.py``). So the body of the
single-device step, and the particle decomposition's over the in-process
shards, can be captured into a CUDA graph and replayed (``graph.py``), as the
JAX package jits them (``jaybenne_tpu/step.py:94-96``,
``jaybenne_tpu/parallel/sharding.py:92-118``).

Census selection mirrors the JAX package's ``_pallas_ok``, by configuration and
never by failure: ``use_pallas = auto`` or ``on`` runs
``transport_kernel.transport`` (the CUDA kernel on a GPU, its plain version on the
CPU), ``use_pallas = off`` runs the plain version on any device, in float32 or
float64 (``precision = f64``) alike: the JAX package sends float64 to its XLA loop
instead, and the port to the census's float64 instantiation.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from .config import InitialRadiation, RunConfig
from .ops import counts
from .ops import fleck as fleck_ops
from .ops import rng, sourcing, tally
from .ops import transport as transport_ops
from .ops import transport_kernel
from .parallel.exchange import InProcess
from .utils.device import as_device


# the step's counters, in their order in ``StepStats.packed``
STAT_NAMES = ("iterations", "events", "n_alive", "dropped", "cap_hits", "unfinished",
              "migration_rounds", "migrated", "alive_max")


class StepStats:
    """One step's counters, packed in one int64 tensor on the run's device
    (``packed``, in ``STAT_NAMES`` order) so that the driver reads them all in
    one copy (``copy_to``). Each name reads its 0-dim view of ``packed``:

      * ``iterations``: census-loop iterations this step;
      * ``events``: particle events this step;
      * ``n_alive``: live particles after the step;
      * ``dropped``: sourced (or, spatial, migrated) particles dropped for a full
        ledger;
      * ``cap_hits``: census calls that hit max_transport_iterations;
      * ``unfinished``: live particles short of census after transport;
      * ``migration_rounds``, ``migrated``: the spatial decomposition's census
        rounds this step and the particles shipped between shards (0 elsewhere);
      * ``alive_max``: the live particles of the fullest shard (``n_alive``
        without a decomposition), which the driver's ledger growth reads.
    """

    def __init__(self, packed: torch.Tensor):
        self.packed = packed

    @classmethod
    def pack(cls, **counts) -> "StepStats":
        """The counters ``counts`` (0-dim integer tensors on one device, by the
        names of ``STAT_NAMES``; the spatial ones default to 0 and ``alive_max``
        to ``n_alive``) stacked into one int64 tensor."""
        zero = torch.zeros((), dtype=torch.int64, device=counts["events"].device)
        counts.setdefault("alive_max", counts["n_alive"])
        return cls(torch.stack([counts.get(name, zero).to(torch.int64)
                                for name in STAT_NAMES]))

    def __getattr__(self, name):
        if name in STAT_NAMES:
            return self.packed[STAT_NAMES.index(name)]
        raise AttributeError(name)

    def copy_to(self, buf: torch.Tensor) -> torch.Tensor:
        """Enqueue the one copy of ``packed`` into ``buf`` (an int64 host buffer of
        ``len(STAT_NAMES)``, pinned on a GPU run) without waiting for it: the
        caller synchronises before ``values(buf)`` reads it."""
        return buf.copy_(self.packed, non_blocking=True)

    @staticmethod
    def values(buf: torch.Tensor) -> dict:
        """The counters of a ``copy_to`` buffer as host ints, by name."""
        return dict(zip(STAT_NAMES, buf.tolist()))


def make_transport_params(cfg: RunConfig, dtype) -> transport_ops.TransportParams:
    consts = cfg.mcblock.build_opacity().get_runtime_physical_constants()
    return transport_ops.TransportParams(
        ndim=cfg.mesh.ndim,
        use_ddmc=cfg.jaybenne.use_ddmc,
        max_iters=cfg.jaybenne.max_transport_iterations,
        swarm_bc=cfg.mesh.swarm_bc,
        c=consts.c,
        tau_ddmc=cfg.jaybenne.tau_ddmc,
        has_absorption=cfg.mcblock.opacity_model != "none",
        **transport_ops.default_eps(dtype),
    )


def shard_share(total: int, n: int) -> int:
    """One shard's share of ``total`` births under the particle decomposition (JAX
    ``sharding.py:95``)."""
    return total if n == 1 else max(1, round(total / n))


def census_fn(cfg: RunConfig):
    """The census the configuration selects: the kernel's entry or its plain
    version (``use_pallas = off``)."""
    return (transport_kernel.transport_plain if cfg.jaybenne.use_pallas == "off"
            else transport_kernel.transport)


def with_fleck(f, models, dt, dtype):
    """The fields with this step's Fleck factor; ``models`` = (eos, opacity,
    scattering)."""
    eos, opacity, _ = models
    return dataclasses.replace(
        f, fleck=fleck_ops.fleck_factor(f.rho, f.sie, eos, opacity, dt, dtype))


def total_sigma(f, models, dtype):
    """Per-cell sigma_t = sigma_a + sigma_s of the fields' matter state, the DDMC
    face probabilities' input."""
    eos, opacity, scattering = models
    temp = eos.temperature_from_density_internal_energy(f.rho, f.sie)
    sig_t = (opacity.absorption_coefficient(f.rho, temp)
             + scattering.total_scattering_coefficient(f.rho, temp))
    return as_device(sig_t, dtype, f.rho.device).expand(f.rho.shape)


def with_faces(f, faces):
    """The fields with the DDMC face probabilities ``faces`` = (px, py, pz)."""
    return dataclasses.replace(f, ddmc_px=faces[0], ddmc_py=faces[1], ddmc_pz=faces[2])


def _source(fs, ps, gens, mesh, exchange, **kw):
    """Each shard's births of one source, each from its own generator; under the
    particle decomposition the per-cell birth counts are summed over the shards
    before the weights are set, so the summed energy of a cell is exactly its
    source's. ``kw`` are ``sourcing.birth_counts``'s. Returns (fields, particles
    dropped) per shard."""
    counts = [sourcing.birth_counts(f, mesh, g, **kw) for f, g in zip(fs, gens)]
    n_glob = ([None] * len(fs) if exchange is None
              else exchange.sum([c.n_cell for c in counts]))
    out = [sourcing.births(f, p, mesh, g, c, ng, source_type=kw["source_type"], sb=kw["sb"],
                           c=kw["c"], dtype=kw["dtype"], dt=kw.get("dt", 0.0),
                           external=kw.get("external"))
           for f, p, g, c, ng in zip(fs, ps, gens, counts, n_glob)]
    return [o[0] for o in out], [o[2].to(torch.int64) for o in out]


def build_step_core(mesh, cfg: RunConfig, exchange=None):
    """The per-cycle step ``step(state, dt) -> (state, StepStats)``, or with
    ``exchange`` the particle decomposition's ``step(states, dt) -> (states,
    StepStats)`` over the local shards' states (see the module docstring). The
    particle ledgers are updated in place; fields are replaced.

    The step is ``step.prologue(states, dt)``, which sets what changes from cycle
    to cycle on the host (each random stream's generator seeded by
    ``manual_seed``; the census kernel's seeds and the external source's window,
    from the host clock, copied to the device), then ``step.body(states, dt)``,
    which takes the lists of states and queues the device work without waiting
    for it. A CUDA graph (``graph.py``) captures the body once and replays it
    after the prologue. ``step.generators()`` are the generators the body draws
    from: one per (phase, shard), kept across steps. ``step.capturable`` says
    whether the body makes no host read, and so can be captured: with the
    kernel's census (the plain census reads its exit test), on one device or
    over the in-process exchange's shards (a ``torch.distributed`` group's
    collectives are not captured)."""
    eos = cfg.mcblock.build_eos()
    opacity = cfg.mcblock.build_opacity()
    scattering = cfg.mcblock.build_scattering()
    consts = opacity.get_runtime_physical_constants()
    jb = cfg.jaybenne
    dtype = jb.dtype
    prm = make_transport_params(cfg, dtype)
    transport_kernel.check_supported(mesh, prm, dtype)
    periodic = cfg.mesh.periodic_flags
    n = 1 if exchange is None else exchange.n
    shards = (0,) if exchange is None else exchange.shards
    num_particles = shard_share(jb.num_particles, n)
    # the external volume source (the Su-Olson driving term): fixed geometry
    external = None
    if jb.external_source_q > 0:
        external = sourcing.external_source_setup(mesh, jb)
        ext_num = shard_share(jb.external_source_num or jb.num_particles, n)
    census = census_fn(cfg)
    models = (eos, opacity, scattering)
    dev = mesh.device
    work = counts.scratch(len(shards), dev)  # the count kernel's
    phases = ((rng.PHASE_SOURCE,) if jb.do_emission else ()) + (
        (rng.PHASE_EXTERNAL,) if external else ())
    gens = {(ph, s): torch.Generator(device=dev) for ph in phases for s in shards}
    # the census kernel's seed of each shard: on a GPU the int32 device tensor
    # ``buf`` of one seed a shard, which each prologue rewrites; on the CPU the list
    # ``now`` of host ints
    seeds = {"buf": None, "now": None}
    # the external source's window (``sourcing.ExternalSource.window``), which
    # each prologue writes from the host clock: a tensor of the run's dtype
    window = torch.empty(2, dtype=dtype, device=dev) if external else None

    def words(s):
        """The shard word of every stream key under the decomposition, none without."""
        return () if exchange is None else (s,)

    def prologue(states, dt):
        if external:  # one pinned copy on a GPU, each value rounded once
            window.copy_(torch.tensor(external.window(states[0].t, dt), dtype=dtype,
                                      pin_memory=dev.type == "cuda"), non_blocking=True)
        for ph in phases:
            for st, s in zip(states, shards):
                rng.reseed(gens[(ph, s)], st.seed, st.cycle, ph, words(s))
        now = [rng.kernel_seed(st.seed, st.cycle, *words(s)) for st, s in zip(states, shards)]
        if dev.type == "cuda":
            if seeds["buf"] is None:
                seeds["buf"] = torch.empty(len(now), dtype=torch.int32, device=dev)
            seeds["buf"].copy_(torch.tensor(now, dtype=torch.int32, pin_memory=True),
                               non_blocking=True)
        else:
            seeds["now"] = now

    def body(states, dt):
        fs = [with_fleck(st.fields, models, dt, dtype) for st in states]
        if jb.use_ddmc:
            # a span of its own: profile.py reads its device time in an eager step
            with record_function("step.face_probs"):
                fs = [with_faces(f, fleck_ops.ddmc_face_probs(
                    mesh, total_sigma(f, models, dtype), jb.tau_ddmc, periodic, dtype))
                    for f in fs]
        ps = [st.particles for st in states]

        def stream(phase):
            return [gens[(phase, s)] for s in shards]

        kw = dict(eos=eos, opacity=opacity, sb=consts.sb, c=consts.c, dtype=dtype, dt=dt)
        dropped = [torch.zeros((), dtype=torch.int64, device=dev) for _ in states]
        if jb.do_emission:
            fs, dropped = _source(fs, ps, stream(rng.PHASE_SOURCE), mesh, exchange,
                                  source_type="emission", num_particles=num_particles, **kw)
        else:
            fs = [dataclasses.replace(f, energy_delta=torch.zeros_like(f.energy_delta))
                  for f in fs]
            if external:  # the external pass accumulates onto clean diagnostics
                fs = [dataclasses.replace(f, source_num=torch.zeros_like(f.source_num),
                                          source_ew=torch.zeros_like(f.source_ew))
                      for f in fs]
        if external:
            fs, ext_drop = _source(fs, ps, stream(rng.PHASE_EXTERNAL), mesh, exchange,
                                   source_type="external", num_particles=ext_num,
                                   external=external, window=window, **kw)
            dropped = [d + e for d, e in zip(dropped, ext_drop)]
        # the shards' fields are replicated, so their coefficients are the same:
        # one set, and one census call over every local shard's slice
        coefs = transport_ops.precompute_coefs(
            fs[0], mesh, eos, opacity, scattering, jb.use_ddmc, dtype)
        _, it, ev = census(ps, coefs, mesh, seeds["buf"] if dev.type == "cuda" else seeds["now"],
                           prm, dt)
        iters, events = list(it.to(torch.int64).unbind()), list(ev.unbind())
        # the live counts and the survivors still short of end-of-step, every local
        # shard's in one count: before the tau reset below (the tally changes
        # neither alive nor tau)
        _, totals = counts.counts(ps, work)
        n_alive, alive_max, unfinished = totals[0], totals[1], totals[2]
        fs = tally.tallies(fs, ps, mesh, prm.has_absorption, exchange)
        if jb.do_feedback:
            fs = [tally.update_fluid(f, mesh) for f in fs]
        for p in ps:  # census survivors restart at tau = 0 next cycle
            p.absorbed.zero_()
            p.tau.zero_()
        if exchange is not None:
            iters = exchange.max(iters)
            events, dropped = exchange.sum(events), exchange.sum(dropped)
            if len(shards) != n:  # shards in other processes
                n_alive, unfinished = (exchange.sum([v])[0] for v in (n_alive, unfinished))
                alive_max = exchange.max([alive_max])[0]
        stats = StepStats.pack(
            iterations=iters[0],
            events=events[0],
            n_alive=n_alive,
            dropped=dropped[0],
            cap_hits=iters[0] >= prm.max_iters,
            unfinished=unfinished,
            alive_max=alive_max,
        )
        new = [dataclasses.replace(st, fields=f, particles=p, t=st.t + dt, cycle=st.cycle + 1,
                                   overflow=st.overflow + dropped[0])
               for st, f, p in zip(states, fs, ps)]
        return new, stats

    def step(states, dt):
        single = exchange is None
        states = [states] if single else list(states)
        prologue(states, dt)
        new, stats = body(states, dt)
        return (new[0] if single else new), stats

    step.prologue = prologue
    step.body = body
    step.generators = lambda: list(gens.values())
    step.capturable = (census is transport_kernel.transport
                       and (exchange is None or isinstance(exchange, InProcess)))
    return step


def initialize_radiation(state, mesh, cfg: RunConfig, exchange=None):
    """Thermal-source the initial photon field (if requested) and evaluate the tally
    for outputs. The ledger is filled in place. With ``exchange`` (the particle
    decomposition, JAX ``sharding.make_sharded_init``) ``state`` is the list of
    the local shards' states, each sourcing its share. The drops are added to
    ``overflow`` on the device."""
    jb = cfg.jaybenne
    single = exchange is None
    states = [state] if single else state
    shards = (0,) if single else exchange.shards
    n = 1 if single else exchange.n
    fs = [st.fields for st in states]
    ps = [st.particles for st in states]
    dropped = [torch.zeros((), dtype=torch.int64, device=mesh.device) for _ in states]
    if cfg.mcblock.initial_radiation == InitialRadiation.thermal:
        consts = cfg.mcblock.build_opacity().get_runtime_physical_constants()
        gens = [rng.generator(st.seed, 0, rng.PHASE_INIT, mesh.device, () if single else (s,))
                for st, s in zip(states, shards)]
        fs, drops = _source(fs, ps, gens, mesh, exchange, source_type="thermal",
                            eos=cfg.mcblock.build_eos(), sb=consts.sb, c=consts.c,
                            num_particles=shard_share(jb.num_particles, n), dtype=jb.dtype)
        dropped = drops if single else exchange.sum(drops)
    fs = tally.tallies(fs, ps, mesh, False, exchange)
    new = [dataclasses.replace(st, fields=f, particles=p, overflow=st.overflow + d)
           for st, f, p, d in zip(states, fs, ps, dropped)]
    return new[0] if single else new
