"""Absorption and scattering models (port of ``jaybenne_tpu/models/opacity.py``).

Conventions (CGS unless wrapped), as in the JAX package:

  * absorption coefficient  ``alpha = kappa * rho``        [1/cm]
  * total emissivity        ``J = alpha * c * a * T^4``    [erg/cm^3/s]
  * scattering coefficient  ``sigma_s = (rho / apm) * s``  [1/cm]

``config.McblockConfig`` always wraps the base model in ``NonCGSUnits`` /
``NonCGSUnitsS``. Every model but ``EPBremss`` is gray: transport precomputes one
coefficient per cell. ``EPBremss`` is evaluated per census event at the particle's
photon energy (``ops/transport_kernel.py``, the ``NONGRAY`` kernels).

Float32 order of operations. The JAX package rounds each Python constant to
float32 where it meets a float32 array; a Python constant times a tensor does the
same here. A division by a Python constant, or a Python constant divided by a
tensor, would not: on a GPU PyTorch turns ``t / c`` into ``t * (1 / c)``, and
``c / t`` is ``t.reciprocal() * c`` on every device. The frequency-dependent
model therefore divides by float32 tensors of its constants (``_const``), so that
it rounds as the JAX package does on the CPU and as the CUDA kernel does on the
card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils import constants
from ..utils.device import device_const


@dataclasses.dataclass(frozen=True)
class RuntimePhysicalConstants:
    c: float
    sb: float


def _const(value, like):
    """``value`` as a 0-dim tensor of ``like``'s dtype and device."""
    return device_const(value, like.dtype, like.device)


# ---------------------------------------------------------------- absorption models
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
class EPBremss:
    """Electron-proton (free-free) bremsstrahlung absorption, the hydrogenic law
    with Gaunt factor 1::

        alpha_nu = cff * (rho/m_p)^2 * T^{-1/2} * nu^{-3} * (1 - e^{-h nu / k T})

    ``nu`` is the particle's photon-energy tag in ``sb * T`` units, so
    ``x = tag / (sb T)`` and ``nu = x k T / h``; ``nu`` is clamped at 1e10 Hz and
    ``h nu / k T`` at 80. ``cff / m_p^2`` overflows float32, so it enters as the
    float32 cube root ``g_ff`` divided by ``nu`` and cubed. With ``nu=None`` the
    Kramers Planck mean ``kff rho T^{-7/2}`` [cm^2/g] times ``rho``."""

    kff: float = 3.68e22   # Kramers Planck-mean constant [cgs]
    cff: float = 3.692e8   # spectral free-free constant [cgs]
    is_gray = False

    _MP = 1.67262192369e-24  # proton mass [g]
    FREQ_MIN = 1.0e10        # [Hz]
    XC_MAX = 80.0

    @property
    def g_ff(self) -> float:
        """``(cff / m_p^2)^(1/3)``, in float64 (rounded to float32 where it is used)."""
        return (self.cff / self._MP**2) ** (1.0 / 3.0)

    def absorption_coefficient(self, rho, temp, nu=None):
        if nu is None:
            return self.kff * rho * rho * temp ** (-3.5)
        x = nu / (constants.SB * temp)
        freq = torch.clamp_min(x * (constants.KB * temp) / _const(constants.HH, x),
                               self.FREQ_MIN)
        g = _const(self.g_ff, freq) / freq
        # the stimulated-emission factor from the same (clamped) frequency
        xc = torch.clamp_max(freq * constants.HH / (constants.KB * temp), self.XC_MAX)
        return rho * rho * g * g * g / torch.sqrt(temp) * (1.0 - torch.exp(-xc))

    def emissivity(self, rho, temp):
        alpha = self.absorption_coefficient(rho, temp)
        return alpha * constants.CC * constants.AR * temp**4

    def get_runtime_physical_constants(self) -> RuntimePhysicalConstants:
        return RuntimePhysicalConstants(c=constants.CC, sb=constants.SB)


@dataclasses.dataclass(frozen=True)
class TabulatedOpacity:
    """Tabulated gray Planck-mean opacity kappa(rho, T), bilinear in log-log space.

    ``log_rho``/``log_T`` are the ascending log10 grid axes, ``log_kappa`` is
    [n_rho, n_T] in log10(cm^2/g), all nested tuples so that the model stays
    hashable. Evaluation clamps to the table's edges."""

    log_rho: tuple
    log_T: tuple
    log_kappa: tuple
    is_gray = True

    @classmethod
    def from_arrays(cls, rho, temp, kappa):
        return cls(
            log_rho=tuple(np.log10(np.asarray(rho, dtype=float)).tolist()),
            log_T=tuple(np.log10(np.asarray(temp, dtype=float)).tolist()),
            log_kappa=tuple(tuple(row) for row in np.log10(np.asarray(kappa, dtype=float))),
        )

    @classmethod
    def from_file(cls, path):
        """Load from an .npz with arrays ``rho`` [nr], ``T`` [nt], ``kappa`` [nr, nt]."""
        with np.load(path) as d:
            return cls.from_arrays(d["rho"], d["T"], d["kappa"])

    def _interp(self, rho, temp):
        def axis(v):
            return device_const(v, rho.dtype, rho.device)

        lr_ax, lt_ax, lk = axis(self.log_rho), axis(self.log_T), axis(self.log_kappa)
        lr = torch.clamp(torch.log10(rho), lr_ax[0], lr_ax[-1])
        lt = torch.clamp(torch.log10(temp), lt_ax[0], lt_ax[-1])
        i = torch.clamp(torch.searchsorted(lr_ax, lr.contiguous()) - 1, 0, lr_ax.shape[0] - 2)
        j = torch.clamp(torch.searchsorted(lt_ax, lt.contiguous()) - 1, 0, lt_ax.shape[0] - 2)
        fr = (lr - lr_ax[i]) / (lr_ax[i + 1] - lr_ax[i])
        ft = (lt - lt_ax[j]) / (lt_ax[j + 1] - lt_ax[j])
        v = (
            lk[i, j] * (1 - fr) * (1 - ft)
            + lk[i + 1, j] * fr * (1 - ft)
            + lk[i, j + 1] * (1 - fr) * ft
            + lk[i + 1, j + 1] * fr * ft
        )
        return torch.pow(_const(10.0, v), v)

    def absorption_coefficient(self, rho, temp, nu=None):
        del nu
        return self._interp(rho, temp) * rho

    def emissivity(self, rho, temp):
        alpha = self.absorption_coefficient(rho, temp)
        return alpha * constants.CC * constants.AR * temp**4

    def get_runtime_physical_constants(self) -> RuntimePhysicalConstants:
        return RuntimePhysicalConstants(c=constants.CC, sb=constants.SB)


@dataclasses.dataclass(frozen=True)
class NonCGSUnits:
    """Unit-scale wrapper around an absorption model. Scales convert code units to
    CGS (every shipped deck uses 1.0)."""

    base: object
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


# ---------------------------------------------------------------- scattering models
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
class ThomsonS:
    """Thomson scattering: the Thomson cross section per average particle mass
    ``apm`` [g]."""

    apm: float = 1.0
    is_gray = True

    def total_scattering_coefficient(self, rho, temp, nu=None):
        del temp, nu
        return (rho / self.apm) * constants.SIGMA_THOMSON


@dataclasses.dataclass(frozen=True)
class NonCGSUnitsS:
    """Unit-scale wrapper around a scattering model."""

    base: object
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
