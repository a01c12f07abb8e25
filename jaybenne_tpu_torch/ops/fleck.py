"""Derived transport fields (port of ``jaybenne_tpu/ops/fleck.py``).

Fleck factor (Fleck & Cummings 1971), per cell::

    f = 1 / (1 + (4 * emis / (rho * cv * T)) * dt)

The DDMC face probabilities (``ddmc_face_probs``) arrive with DDMC (ROADMAP
Queue 1, item 12).
"""

from __future__ import annotations


def fleck_factor(rho, sie, eos, opacity, dt, dtype):
    """Per-cell Fleck factor."""
    temp = eos.temperature_from_density_internal_energy(rho, sie)
    cv = eos.specific_heat_from_density_internal_energy(rho, sie)
    emis = opacity.emissivity(rho, temp)
    return (1.0 / (1.0 + (4.0 * emis / (rho * cv * temp)) * dt)).to(dtype)
