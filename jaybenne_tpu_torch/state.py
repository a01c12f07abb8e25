"""Simulation state (port of ``jaybenne_tpu/state.py``).

Cell arrays are ``[n_blocks, nz, ny, nx]`` tensors on the run's device; the DDMC
face-probability fields ``ddmc_px/py/pz`` gain one entry along their axis
(``[B, nz, ny, nx+1]``, ``[B, nz, ny+1, nx]``, ``[B, nz+1, ny, nx]``) and hold
zeros on inactive axes and in runs without DDMC. The JAX state's PRNG key becomes
the integer ``seed`` that ``ops.rng`` keys every stream with. The clock (``t``,
``cycle``) and the seed are host numbers; ``overflow`` is a 0-dim int64 tensor on
the run's device, so that a step adds its drops to it without waiting for the
device (a host number given to the constructor is moved there).
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
    ddmc_px: torch.Tensor  # [B, nz, ny, nx+1]
    ddmc_py: torch.Tensor  # [B, nz, ny+1, nx]
    ddmc_pz: torch.Tensor  # [B, nz+1, ny, nx]


@dataclasses.dataclass
class SimState:
    fields: Fields
    particles: ParticleLedger
    t: float       # simulation time
    cycle: int     # cycle counter
    seed: int      # run seed: keys every random stream (see ops/rng.py)
    overflow: torch.Tensor  # sourced particles dropped due to a full ledger (int64)

    def __post_init__(self):
        if not isinstance(self.overflow, torch.Tensor):
            self.overflow = torch.tensor(int(self.overflow), dtype=torch.int64,
                                         device=self.fields.rho.device)


def empty_fields(n_blocks, nz, ny, nx, dtype=torch.float32, device="cpu") -> Fields:
    def c(shape=(n_blocks, nz, ny, nx)):
        return torch.zeros(shape, dtype=dtype, device=device)

    return Fields(
        rho=c(), sie=c(), u=c(),
        energy_tally=c(), fleck=c(), energy_delta=c(),
        source_ew=c(), source_num=c(),
        ddmc_px=c((n_blocks, nz, ny, nx + 1)),
        ddmc_py=c((n_blocks, nz, ny + 1, nx)),
        ddmc_pz=c((n_blocks, nz + 1, ny, nx)),
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
