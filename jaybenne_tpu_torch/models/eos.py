"""Equations of state (port of ``jaybenne_tpu/models/eos.py``).

Models are frozen dataclasses of Python scalars. Their methods take tensors (or
Python floats) and use plain arithmetic, so they broadcast over cell arrays on any
device.

``config.McblockConfig.build_eos`` always wraps the base model (``IdealGas`` or
``PowerLawCv``, the Su-Olson material) in ``UnitSystemEOS``, as the JAX package
does.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class IdealGas:
    """Gamma-law gas: ``sie = cv * T``, constant specific heat."""

    gm1: float  # gamma - 1
    cv: float   # specific heat at constant volume [erg/g/K]

    def temperature_from_density_internal_energy(self, rho, sie):
        del rho  # ideal gas: T independent of density
        return sie / self.cv

    def specific_heat_from_density_internal_energy(self, rho, sie):
        del rho
        if isinstance(sie, torch.Tensor):
            return torch.full_like(sie, self.cv)
        return self.cv

    def internal_energy_from_density_temperature(self, rho, temp):
        del rho
        return self.cv * temp


@dataclasses.dataclass(frozen=True)
class PowerLawCv:
    """Temperature-power-law specific heat: ``cv(T) = alpha * T**n`` per unit mass,
    so ``sie = alpha * T**(n+1) / (n+1)``. ``n = 3`` makes ``u_m`` proportional to
    ``T^4``, like the radiation field: the material of the Su & Olson (1996)
    benchmark (``inputs/suolson.in``)."""

    alpha: float    # cv prefactor [erg/g/K^(n+1)]
    n: float = 3.0  # temperature exponent

    def temperature_from_density_internal_energy(self, rho, sie):
        del rho
        p = self.n + 1.0
        v = p * sie / self.alpha
        v = torch.clamp_min(v, 0.0) if isinstance(v, torch.Tensor) else max(v, 0.0)
        return v ** (1.0 / p)

    def specific_heat_from_density_internal_energy(self, rho, sie):
        t = self.temperature_from_density_internal_energy(rho, sie)
        return self.alpha * t**self.n

    def internal_energy_from_density_temperature(self, rho, temp):
        del rho
        p = self.n + 1.0
        return self.alpha * temp**p / p


@dataclasses.dataclass(frozen=True)
class UnitSystemEOS:
    """Unit-scale wrapper around an EOS: converts code-unit (rho, sie) to CGS,
    evaluates the wrapped model, and converts the result back to code units."""

    base: object  # IdealGas or PowerLawCv
    time_scale: float = 1.0
    mass_scale: float = 1.0
    length_scale: float = 1.0
    temperature_scale: float = 1.0

    @property
    def _rho_scale(self):
        return self.mass_scale / self.length_scale**3

    @property
    def _sie_scale(self):
        # specific energy: (length/time)^2
        return (self.length_scale / self.time_scale) ** 2

    def temperature_from_density_internal_energy(self, rho, sie):
        t_cgs = self.base.temperature_from_density_internal_energy(
            rho * self._rho_scale, sie * self._sie_scale
        )
        return t_cgs / self.temperature_scale

    def specific_heat_from_density_internal_energy(self, rho, sie):
        cv_cgs = self.base.specific_heat_from_density_internal_energy(
            rho * self._rho_scale, sie * self._sie_scale
        )
        return cv_cgs * self.temperature_scale / self._sie_scale

    def internal_energy_from_density_temperature(self, rho, temp):
        sie_cgs = self.base.internal_energy_from_density_temperature(
            rho * self._rho_scale, temp * self.temperature_scale
        )
        return sie_cgs / self._sie_scale
