"""Simulation state (port of ``jaybenne_tpu/state.py``).

Cell arrays are ``[n_blocks, nz, ny, nx]`` tensors on the run's device. The JAX
state's PRNG key becomes the integer ``seed`` that ``ops.rng`` keys every stream
with, and the scalar counters are host numbers. The DDMC face-probability fields
(``ddmc_px/py/pz``) arrive with DDMC (ROADMAP Queue 1, item 12).
"""

from __future__ import annotations

import dataclasses

import torch

from .particles import ParticleLedger, empty_ledger


@dataclasses.dataclass
class Fields:
    rho: torch.Tensor
    sie: torch.Tensor
    u: torch.Tensor
    energy_tally: torch.Tensor
    fleck: torch.Tensor
    energy_delta: torch.Tensor
    source_ew: torch.Tensor
    source_num: torch.Tensor


@dataclasses.dataclass
class SimState:
    fields: Fields
    particles: ParticleLedger
    t: float       # simulation time
    cycle: int     # cycle counter
    seed: int      # run seed: keys every random stream (see ops/rng.py)
    overflow: int  # sourced particles dropped due to a full ledger


def empty_fields(n_blocks, nz, ny, nx, dtype=torch.float32, device="cpu") -> Fields:
    def c():
        return torch.zeros((n_blocks, nz, ny, nx), dtype=dtype, device=device)

    return Fields(
        rho=c(), sie=c(), u=c(),
        energy_tally=c(), fleck=c(), energy_delta=c(),
        source_ew=c(), source_num=c(),
    )


def initial_state(mesh, capacity, seed, dtype=torch.float32) -> SimState:
    dev = mesh.device
    return SimState(
        fields=empty_fields(mesh.n_blocks, mesh.nz, mesh.ny, mesh.nx, dtype, dev),
        particles=empty_ledger(capacity, dtype, dev),
        t=0.0,
        cycle=0,
        seed=int(seed),
        overflow=0,
    )
