"""Transport parameters and per-cell coefficients (port of the setup half of
``jaybenne_tpu/ops/transport.py``).

The census loop itself is ``ops/transport_kernel.py``: the CUDA kernel and, on
CPU tensors, its plain PyTorch version, for IMC and DDMC, gray and non-gray alike,
in float32 and float64. The JAX package runs float64 through its XLA event loop
(``_one_event``/``transport``), which draws threefry variates in another
structure; the port runs it through the same census at double precision instead
(``transport_kernel``'s module docstring), so the two agree in distribution.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.device import as_device


@dataclasses.dataclass
class TransportCoefs:
    """Per-cell transport coefficients, computed once per step (the fields do not
    change during transport). The cell ones are f[NC] in block cell order; the
    DDMC face probabilities are the fields' face arrays, None without DDMC.

    With a frequency-dependent model the census evaluates ``opacity`` at each
    particle's photon energy, per event, from the cell's ``rho`` and ``temp``, as
    the JAX package's ``TransportCoefs`` with its models attached does;
    ``sigma_a`` then holds the Planck mean and ``sigma_s`` the (gray) scattering.
    Gray runs leave the three at None."""

    sigma_a: torch.Tensor  # absorption coefficient (the Planck mean if non-gray)
    sigma_s: torch.Tensor  # scattering coefficient
    fleck: torch.Tensor    # Fleck factor
    px: torch.Tensor | None = None  # [B, nz, ny, nx+1] DDMC face probabilities
    py: torch.Tensor | None = None  # [B, nz, ny+1, nx]
    pz: torch.Tensor | None = None  # [B, nz+1, ny, nx]
    rho: torch.Tensor | None = None   # non-gray: density per cell
    temp: torch.Tensor | None = None  # non-gray: temperature per cell
    opacity: object = None            # non-gray: the absorption model

    @property
    def is_gray(self) -> bool:
        return self.opacity is None


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
    temp = eos.temperature_from_density_internal_energy(fields.rho, fields.sie)
    shape = fields.rho.shape

    def cellwise(v):
        return as_device(v, dtype, fields.rho.device).expand(shape).reshape(-1)

    nongray = {}
    if not (opacity.is_gray and scattering.is_gray):
        # the census gathers (rho, T) and evaluates the models at the particle's
        # photon energy
        nongray = dict(rho=cellwise(fields.rho), temp=cellwise(temp), opacity=opacity)
    return TransportCoefs(
        sigma_a=cellwise(opacity.absorption_coefficient(fields.rho, temp)),
        sigma_s=cellwise(scattering.total_scattering_coefficient(fields.rho, temp)),
        fleck=fields.fleck.reshape(-1).to(dtype),
        **({"px": fields.ddmc_px, "py": fields.ddmc_py, "pz": fields.ddmc_pz}
           if use_ddmc else {}),
        **nongray,
    )
