"""The radiation step (port of ``jaybenne_tpu/step.py``, single device).

One cycle from t to t + dt: derived fields (Fleck factor), census transport, tally,
and the per-step reset of ``tau`` and ``absorbed``. Emission sourcing and the fluid
update arrive with slice 2 (ROADMAP Queue 1, item 11), the external source with
slice 5 (item 14), and both decompositions with item 17.

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
    if jb.do_emission:
        raise not_ported("emission sourcing (do_emission = true)", "Queue 1, item 11")
    if jb.do_feedback:
        raise not_ported("fluid feedback (do_feedback = true)", "Queue 1, item 11")
    if jb.external_source_q > 0:
        raise not_ported("the external volume source", "Queue 1, item 14")
    if jb.debug_checks:
        raise not_ported("debug_checks (validate_state)", "Queue 1, item 16")


def build_step_core(mesh, cfg: RunConfig):
    """The per-cycle step ``step(state, dt) -> (state, StepStats)``. The particle
    ledger is updated in place; fields are replaced."""
    _check_step_supported(cfg)
    eos = cfg.mcblock.build_eos()
    opacity = cfg.mcblock.build_opacity()
    scattering = cfg.mcblock.build_scattering()
    jb = cfg.jaybenne
    dtype = jb.dtype
    prm = make_transport_params(cfg, dtype)
    transport_kernel.check_supported(mesh, prm, dtype)
    census = (
        transport_kernel.transport_plain if jb.use_pallas == "off"
        else transport_kernel.transport
    )

    def step(state, dt):
        f = state.fields
        f = dataclasses.replace(
            f,
            fleck=fleck_ops.fleck_factor(f.rho, f.sie, eos, opacity, dt, dtype),
            energy_delta=torch.zeros_like(f.energy_delta),
        )
        coefs = transport_ops.precompute_coefs(
            f, mesh, eos, opacity, scattering, jb.use_ddmc, dtype
        )
        seed = rng.kernel_seed(state.seed, state.cycle)
        p, iters, events = census(state.particles, coefs, mesh, seed, prm, dt)
        # survivors still short of end-of-step, before the tau reset below
        unfinished = (p.alive & (p.tau < 1.0)).sum()
        f = tally.evaluate_radiation_energy(f, p, mesh)
        # census survivors restart at tau = 0 next cycle
        p.absorbed.zero_()
        p.tau.zero_()
        new_state = dataclasses.replace(
            state, fields=f, particles=p, t=state.t + dt, cycle=state.cycle + 1
        )
        stats = StepStats(
            iterations=iters,
            events=events,
            n_alive=p.num_alive(),
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
