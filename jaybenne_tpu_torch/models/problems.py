"""Problem generators (port of ``jaybenne_tpu/models/problems.py``).

Every problem initializes ``rho = rho0`` and ``sie = cv * T0`` everywhere;
``stepdiff`` drops the right half-space (``x >= 0``) to ``T = 1e-5 * T0``; then
``u = rho * sie``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import RunConfig


def generate_problem(fields, mesh, cfg: RunConfig, dtype):
    mc = cfg.mcblock
    eos = mc.build_eos()
    rho0 = mc.initial_density
    tt0 = mc.initial_temperature

    rho = torch.full_like(fields.rho, rho0)
    sie0 = eos.internal_energy_from_density_temperature(rho0, tt0)
    sie = torch.full_like(fields.sie, sie0)

    if cfg.problem_id == "stepdiff":
        xc, _, _ = mesh.cell_centers()
        sie_low = eos.internal_energy_from_density_temperature(rho0, 1.0e-5 * tt0)
        sie = torch.where(xc >= 0.0, torch.full_like(sie, sie_low), sie)

    u = rho * sie
    return dataclasses.replace(fields, rho=rho.to(dtype), sie=sie.to(dtype), u=u.to(dtype))
