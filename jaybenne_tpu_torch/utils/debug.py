"""State invariant checks (port of ``jaybenne_tpu/utils/debug.py``), run after
each step under ``jaybenne/debug_checks = true``.

The checks are the JAX package's, in its order, on the state's tensors where
they lie: block and cell indices in range, positions inside their block and
finite, weights positive and finite, ``tau`` in [0, 1], speeds at c, and finite
matter and tally fields with a non-negative tally. Each check reads one boolean
back to the host.
"""

from __future__ import annotations

import torch


class InvariantError(AssertionError):
    pass


def _require(cond, msg):
    if not bool(cond):
        raise InvariantError(msg)


def validate_state(state, mesh, cfg) -> None:
    """Raise ``InvariantError`` on the first invariant the state breaks."""
    p = state.particles
    alive = p.alive
    if not bool(alive.any()):
        return

    b = p.block[alive]
    _require(((b >= 0) & (b < mesh.n_blocks)).all(), "block id out of range")
    for idx, n, name in ((p.i, mesh.nx, "i"), (p.j, mesh.ny, "j"), (p.k, mesh.nz, "k")):
        c = idx[alive]
        _require(((c >= 0) & (c < n)).all(), f"cell {name} out of logical bounds")

    dxv = mesh.block_dx.to(b.device)[b.long()]
    for q, d, nn, name in ((p.x, dxv[:, 0], mesh.nx, "x"), (p.y, dxv[:, 1], mesh.ny, "y"),
                           (p.z, dxv[:, 2], mesh.nz, "z")):
        q = q[alive]
        tol = 1e-3 * d  # the face offsets stay within a cell width
        _require(((q >= -tol) & (q <= d * nn + tol)).all(), f"particle {name} outside block extent")
        _require(torch.isfinite(q).all(), f"non-finite particle {name}")

    w = p.weight[alive]
    tau = p.tau[alive]
    speed = torch.sqrt(p.vx[alive] ** 2 + p.vy[alive] ** 2 + p.vz[alive] ** 2).double()
    _require((w > 0).all(), "non-positive particle weight")
    _require(torch.isfinite(w).all(), "non-finite particle weight")
    _require(((tau >= 0) & (tau <= 1.0 + 1e-6)).all(), "tau outside [0, 1]")
    c = cfg.mcblock.build_opacity().get_runtime_physical_constants().c
    _require(torch.allclose(speed, torch.full_like(speed, c), rtol=2e-3, atol=1e-8),
             "particle speed drifted from c")

    f = state.fields
    for name in ("energy_tally", "u", "sie", "rho"):
        _require(torch.isfinite(getattr(f, name)).all(), f"non-finite field {name}")
    _require((f.energy_tally >= 0).all(), "negative energy tally")
