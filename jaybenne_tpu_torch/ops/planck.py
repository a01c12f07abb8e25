"""Planck (blackbody) photon-energy sampling (port of ``jaybenne_tpu/ops/planck.py``).

Rejection-free sampler after Everett & Cashwell (1972):

  1. choose a series term ``l`` from the CDF ``sum_{j<=l} j^-4 >= xi * pi^4 / 90``;
  2. return ``E = -(1/l) * ln(xi1 xi2 xi3 xi4) * sb * T``.

The CDF is truncated at 64 terms with the tail folded into the last one, as in the
JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import device_const
from . import rng

_L = 64
_terms = np.arange(1, _L + 1, dtype=np.float64) ** -4.0
_CDF = np.cumsum(_terms) / (np.pi**4 / 90.0)
_CDF[-1] = 1.0  # absorb the truncated tail into the last term


def sample_planck_energy(gen, sb, temp, shape, dtype, device):
    """Draw Planck-distributed energies ``E`` with scale ``sb * temp``; ``temp``
    broadcasts against ``shape``."""
    cdf = device_const(_CDF, dtype, device)
    xi0 = rng.uniform(gen, shape, dtype, device)
    # first index with cdf[idx] >= xi0 -> l = idx + 1
    l = torch.bucketize(xi0, cdf).to(dtype) + 1.0
    u = rng.uniform_pos(gen, (4,) + tuple(shape), dtype, device)
    log_prod = torch.log(u).sum(0)
    return -(1.0 / l) * log_prod * sb * temp
