"""The radiation step (port of ``jaybenne_tpu/step.py``, single device).

One cycle from t to t + dt: derived fields (the Fleck factor and, with DDMC, the
face probabilities), emission sourcing, the external volume source, census
transport, the absorption deposition, the tally, the fluid update, and the
per-step reset of ``tau`` and ``absorbed``. Both decompositions arrive with ROADMAP
Queue 1, item 17.

Census selection mirrors the JAX package's ``_pallas_ok``, by configuration and
never by failure: ``use_pallas = auto`` or ``on`` runs
``transport_kernel.transport`` (the CUDA kernel on a GPU, its plain version on the
CPU), ``use_pallas = off`` runs the plain version on any device, and a
configuration the kernel does not take raises ``NotImplementedError`` when the step
is built.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import InitialRadiation, RunConfig, not_ported
from .ops import fleck as fleck_ops
from .ops import rng, sourcing, tally
from .ops import transport as transport_ops
from .ops import transport_kernel


@dataclasses.dataclass
class StepStats:
    iterations: torch.Tensor  # census-loop iterations this step (int32)
    events: torch.Tensor      # particle events this step (int64)
    n_alive: torch.Tensor     # live particles after the step
    dropped: torch.Tensor     # sourced particles dropped (ledger overflow)
    cap_hits: torch.Tensor    # 1 when the census hit max_transport_iterations
    unfinished: torch.Tensor  # live particles short of census after transport


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


def _check_step_supported(cfg: RunConfig) -> None:
    """Raise ``NotImplementedError`` for step features this port does not run yet."""
    jb = cfg.jaybenne
    if jb.n_devices != 1 or jb.decomposition == "spatial":
        raise not_ported("multi-device runs and the spatial decomposition", "Queue 1, item 17")
    if jb.debug_checks:
        raise not_ported("debug_checks (validate_state)", "Queue 1, item 16")


def build_step_core(mesh, cfg: RunConfig):
    """The per-cycle step ``step(state, dt) -> (state, StepStats)``. The particle
    ledger is updated in place; fields are replaced."""
    _check_step_supported(cfg)
    eos = cfg.mcblock.build_eos()
    opacity = cfg.mcblock.build_opacity()
    scattering = cfg.mcblock.build_scattering()
    consts = opacity.get_runtime_physical_constants()
    jb = cfg.jaybenne
    dtype = jb.dtype
    prm = make_transport_params(cfg, dtype)
    periodic = cfg.mesh.periodic_flags
    transport_kernel.check_supported(mesh, prm, dtype)
    # the external volume source (the Su-Olson driving term): fixed geometry
    external = None
    if jb.external_source_q > 0:
        external = sourcing.external_source_setup(mesh, jb)
        ext_num = jb.external_source_num or jb.num_particles
    census = (
        transport_kernel.transport_plain if jb.use_pallas == "off"
        else transport_kernel.transport
    )

    def step(state, dt):
        f, p = state.fields, state.particles
        f = dataclasses.replace(
            f, fleck=fleck_ops.fleck_factor(f.rho, f.sie, eos, opacity, dt, dtype)
        )
        if jb.use_ddmc:
            temp = eos.temperature_from_density_internal_energy(f.rho, f.sie)
            sig_t = (opacity.absorption_coefficient(f.rho, temp)
                     + scattering.total_scattering_coefficient(f.rho, temp))
            sig_t = torch.as_tensor(sig_t, dtype=dtype, device=f.rho.device).expand(
                f.rho.shape)
            px, py, pz = fleck_ops.ddmc_face_probs(mesh, sig_t, jb.tau_ddmc, periodic, dtype)
            f = dataclasses.replace(f, ddmc_px=px, ddmc_py=py, ddmc_pz=pz)
        if jb.do_emission:
            gen = rng.generator(state.seed, state.cycle, rng.PHASE_SOURCE, mesh.device)
            f, p, dropped = sourcing.source_photons(
                f, p, mesh, gen,
                source_type="emission",
                eos=eos, opacity=opacity,
                sb=consts.sb, c=consts.c,
                num_particles=jb.num_particles,
                dt=dt, dtype=dtype,
            )
        else:
            f = dataclasses.replace(f, energy_delta=torch.zeros_like(f.energy_delta))
            if external:  # the external pass accumulates onto clean diagnostics
                f = dataclasses.replace(f, source_num=torch.zeros_like(f.source_num),
                                        source_ew=torch.zeros_like(f.source_ew))
            dropped = torch.zeros((), dtype=torch.int64, device=mesh.device)
        if external:
            gen = rng.generator(state.seed, state.cycle, rng.PHASE_EXTERNAL, mesh.device)
            f, p, ext_drop = sourcing.source_photons(
                f, p, mesh, gen,
                source_type="external",
                eos=eos, opacity=opacity,
                sb=consts.sb, c=consts.c,
                num_particles=ext_num,
                dt=dt, t=state.t, external=external, dtype=dtype,
            )
            dropped = dropped + ext_drop
        coefs = transport_ops.precompute_coefs(
            f, mesh, eos, opacity, scattering, jb.use_ddmc, dtype
        )
        seed = rng.kernel_seed(state.seed, state.cycle)
        p, iters, events = census(p, coefs, mesh, seed, prm, dt)
        # survivors still short of end-of-step, before the tau reset below
        unfinished = (p.alive & (p.tau < 1.0)).sum()
        if prm.has_absorption:
            f = tally.accumulate_absorption(f, p, mesh)
        f = tally.evaluate_radiation_energy(f, p, mesh)
        if jb.do_feedback:
            f = tally.update_fluid(f, mesh)
        # census survivors restart at tau = 0 next cycle
        p.absorbed.zero_()
        p.tau.zero_()
        new_state = dataclasses.replace(
            state, fields=f, particles=p, t=state.t + dt, cycle=state.cycle + 1,
            overflow=state.overflow + int(dropped),
        )
        stats = StepStats(
            iterations=iters,
            events=events,
            n_alive=p.num_alive(),
            dropped=dropped,
            cap_hits=(iters >= prm.max_iters).to(torch.int32),
            unfinished=unfinished,
        )
        return new_state, stats

    return step


def initialize_radiation(state, mesh, cfg: RunConfig):
    """Thermal-source the initial photon field (if requested) and evaluate the tally
    for outputs. The ledger is filled in place."""
    jb = cfg.jaybenne
    f, p = state.fields, state.particles
    dropped = 0
    if cfg.mcblock.initial_radiation == InitialRadiation.thermal:
        consts = cfg.mcblock.build_opacity().get_runtime_physical_constants()
        gen = rng.generator(state.seed, 0, rng.PHASE_INIT, mesh.device)
        f, p, n_drop = sourcing.source_photons(
            f, p, mesh, gen,
            source_type="thermal",
            eos=cfg.mcblock.build_eos(),
            sb=consts.sb, c=consts.c,
            num_particles=jb.num_particles,
            dtype=jb.dtype,
        )
        dropped = int(n_drop)
    f = tally.evaluate_radiation_energy(f, p, mesh)
    return dataclasses.replace(
        state, fields=f, particles=p, overflow=state.overflow + dropped
    )
