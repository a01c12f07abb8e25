"""Random streams (port of ``jaybenne_tpu/ops/rng.py``).

The JAX package folds (cycle, phase) tags into a threefry key. Here each stream is a
``torch.Generator`` on the run's device, seeded with a SplitMix64 hash of
``(run seed, cycle, phase)``:

  * ``PHASE_INIT`` — thermal initial radiation (cycle 0);
  * ``PHASE_TRANSPORT`` — the census kernel, which draws its own variates from the
    counter hash of ``ops/kernel_rng.py`` and takes only a 32-bit seed, so that
    stream is the hash value itself (``kernel_seed``) and needs no generator.

A stream is therefore fixed by (seed, cycle, phase) and the device: two runs with
the same seed on the same kind of device draw the same numbers. CPU and CUDA
generators differ, and neither matches threefry, so tests that run both packages
hand them the same ledger and compare statistics.
"""

from __future__ import annotations

import math

import torch

PHASE_INIT = 0
PHASE_TRANSPORT = 2  # 1 is kept for per-step sourcing

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def stream_key(seed: int, cycle: int, phase: int) -> int:
    """64-bit hash of (seed, cycle, phase)."""
    h = 0
    for w in (seed, cycle, phase):
        h = _splitmix64(h ^ (w & _M64))
    return h


def generator(seed: int, cycle: int, phase: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_key(seed, cycle, phase) >> 1)  # manual_seed takes < 2^63
    return g


def kernel_seed(seed: int, cycle: int) -> int:
    """Signed 32-bit seed of the census kernel's counter hash for one cycle."""
    s = stream_key(seed, cycle, PHASE_TRANSPORT) & 0xFFFFFFFF
    return s - (1 << 32) if s >= (1 << 31) else s


def uniform(gen, shape, dtype, device):
    """U[0, 1) of the requested float dtype."""
    return torch.rand(shape, generator=gen, dtype=dtype, device=device)


def uniform_pos(gen, shape, dtype, device):
    """U(0, 1): strictly positive, safe under ``log``."""
    return uniform(gen, shape, dtype, device).clamp_min(torch.finfo(dtype).tiny)


def isotropic_direction(gen, shape, dtype, device):
    """Uniform direction on the unit sphere as (nx, ny, nz), polar axis on z."""
    mu = 1.0 - 2.0 * uniform(gen, shape, dtype, device)
    phi = (2.0 * math.pi) * uniform(gen, shape, dtype, device)
    st = torch.sqrt(torch.clamp_min(1.0 - mu * mu, 0.0))
    return st * torch.cos(phi), st * torch.sin(phi), mu
