"""Gray absorption and scattering models (port of ``jaybenne_tpu/models/opacity.py``).

Conventions (CGS unless wrapped), as in the JAX package:

  * absorption coefficient  ``alpha = kappa * rho``        [1/cm]
  * total emissivity        ``J = alpha * c * a * T^4``    [erg/cm^3/s]
  * scattering coefficient  ``sigma_s = (rho / apm) * s``  [1/cm]

``config.McblockConfig`` always wraps the base model in ``NonCGSUnits`` /
``NonCGSUnitsS``. The frequency-dependent models (``EPBremss``, ``ThomsonS``,
``TabulatedOpacity``) arrive with slice 5 (ROADMAP Queue 1, item 14).
"""

from __future__ import annotations

import dataclasses

from ..utils import constants


@dataclasses.dataclass(frozen=True)
class RuntimePhysicalConstants:
    c: float
    sb: float


@dataclasses.dataclass(frozen=True)
class Gray:
    """Gray (frequency-independent) absorption opacity ``kappa`` [cm^2/g]."""

    kappa: float
    is_gray = True

    def absorption_coefficient(self, rho, temp, nu=None):
        del temp, nu
        return self.kappa * rho

    def emissivity(self, rho, temp):
        alpha = self.kappa * rho
        return alpha * constants.CC * constants.AR * temp**4

    def get_runtime_physical_constants(self) -> RuntimePhysicalConstants:
        return RuntimePhysicalConstants(c=constants.CC, sb=constants.SB)


@dataclasses.dataclass(frozen=True)
class NonCGSUnits:
    """Unit-scale wrapper around an absorption model. Scales convert code units to
    CGS (every shipped deck uses 1.0)."""

    base: Gray
    time_scale: float = 1.0
    mass_scale: float = 1.0
    length_scale: float = 1.0
    temperature_scale: float = 1.0

    @property
    def is_gray(self):
        return self.base.is_gray

    @property
    def _rho_scale(self):
        return self.mass_scale / self.length_scale**3

    @property
    def _energy_scale(self):
        return self.mass_scale * self.length_scale**2 / self.time_scale**2

    def absorption_coefficient(self, rho, temp, nu=None):
        alpha_cgs = self.base.absorption_coefficient(
            rho * self._rho_scale, temp * self.temperature_scale, nu
        )
        return alpha_cgs * self.length_scale  # [1/cm] -> [1/code-length]

    def emissivity(self, rho, temp):
        emis_cgs = self.base.emissivity(
            rho * self._rho_scale, temp * self.temperature_scale
        )
        # [erg/cm^3/s] -> code energy / code volume / code time
        return emis_cgs * self.length_scale**3 * self.time_scale / self._energy_scale

    def get_runtime_physical_constants(self) -> RuntimePhysicalConstants:
        cgs = self.base.get_runtime_physical_constants()
        return RuntimePhysicalConstants(
            c=cgs.c * self.time_scale / self.length_scale,
            sb=cgs.sb * self.time_scale**3 * self.temperature_scale**4 / self.mass_scale,
        )


@dataclasses.dataclass(frozen=True)
class GrayS:
    """Gray scattering: per-particle cross section ``s`` [cm^2] with average
    particle mass ``apm`` [g]."""

    s: float
    apm: float = 1.0
    is_gray = True

    def total_scattering_coefficient(self, rho, temp, nu=None):
        del temp, nu
        return (rho / self.apm) * self.s


@dataclasses.dataclass(frozen=True)
class NonCGSUnitsS:
    """Unit-scale wrapper around a scattering model."""

    base: GrayS
    time_scale: float = 1.0
    mass_scale: float = 1.0
    length_scale: float = 1.0
    temperature_scale: float = 1.0

    @property
    def is_gray(self):
        return self.base.is_gray

    @property
    def _rho_scale(self):
        return self.mass_scale / self.length_scale**3

    def total_scattering_coefficient(self, rho, temp, nu=None):
        sig_cgs = self.base.total_scattering_coefficient(
            rho * self._rho_scale, temp * self.temperature_scale, nu
        )
        return sig_cgs * self.length_scale
