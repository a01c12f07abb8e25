"""Transport parameters and per-cell coefficients (port of the setup half of
``jaybenne_tpu/ops/transport.py``).

The census loop itself is ``ops/transport_kernel.py``: the CUDA kernel and, on
CPU tensors, its plain PyTorch version. The JAX package's XLA event loop
(``_one_event``/``transport``) draws threefry variates in another structure; its
port waits for the slices that need it (f64, DDMC, SMR; ROADMAP Queue 1, item 7).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import not_ported


@dataclasses.dataclass
class TransportCoefs:
    """Per-cell gray transport coefficients, computed once per step (the fields do
    not change during transport). Each is f[NC] in block cell order."""

    sigma_a: torch.Tensor  # absorption coefficient
    sigma_s: torch.Tensor  # scattering coefficient
    fleck: torch.Tensor    # Fleck factor


@dataclasses.dataclass(frozen=True)
class TransportParams:
    ndim: int
    use_ddmc: bool
    max_iters: int
    swarm_bc: tuple     # 6 BC enums (ix1, ox1, ix2, ox2, ix3, ox3)
    c: float            # speed of light (code units)
    tau_ddmc: float
    eps_imc: float      # relative face offset for albedo bounce-back
    eps_ddmc: float     # relative face offset for DDMC leak placement
    # absorption opacity identically zero (opacity_model = none): the Fleck factor
    # is exactly 1 and absorption never fires
    has_absorption: bool = True


def default_eps(dtype):
    """Face-offset epsilons, scaled up from the reference's 1e6/1e8 x DBL_EPSILON
    so that in float32 they clear the position representation error."""
    if dtype == torch.float64:
        return dict(eps_imc=2.2e-10, eps_ddmc=2.2e-8)
    return dict(eps_imc=1.0e-3, eps_ddmc=1.0e-2)


def precompute_coefs(fields, mesh, eos, opacity, scattering, use_ddmc, dtype):
    if use_ddmc:
        raise not_ported("DDMC", "Queue 1, item 12")
    if not (opacity.is_gray and scattering.is_gray):
        raise not_ported("frequency-dependent models", "Queue 1, item 14")
    temp = eos.temperature_from_density_internal_energy(fields.rho, fields.sie)
    shape = fields.rho.shape

    def cellwise(v):
        return torch.as_tensor(v, dtype=dtype, device=fields.rho.device).expand(shape).reshape(-1)

    return TransportCoefs(
        sigma_a=cellwise(opacity.absorption_coefficient(fields.rho, temp)),
        sigma_s=cellwise(scattering.total_scattering_coefficient(fields.rho, temp)),
        fleck=fields.fleck.reshape(-1).to(dtype),
    )
