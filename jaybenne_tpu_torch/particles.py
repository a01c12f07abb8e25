"""Fixed-capacity SoA photon ledger (port of ``jaybenne_tpu/particles.py``).

One flat struct-of-arrays ledger with an ``alive`` mask. Positions are local to the
owning block, ``tau`` is the time within the current step in units of dt (census is
``tau >= 1``), and cell identity is tracked by the integers ``(block, i, j, k)``.

Dtypes: f32 for positions, velocities, ``tau``, ``weight`` and ``energy``; int32
for ``block``, ``i``, ``j``, ``k`` and ``face``; ``torch.bool`` for ``alive`` and
``absorbed``. The JAX ledger's ``leak`` column (pending DDMC resamples of the spatial
decomposition) arrives with that decomposition (ROADMAP Queue 1, item 17).

Capacity is whatever the caller asks for: the census kernel runs one thread per
slot and needs no tile multiple.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class ParticleLedger:
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    tau: torch.Tensor
    weight: torch.Tensor
    energy: torch.Tensor
    block: torch.Tensor
    i: torch.Tensor
    j: torch.Tensor
    k: torch.Tensor
    alive: torch.Tensor
    # absorbed-this-step flag (absorption clears ``alive`` and sets this)
    absorbed: torch.Tensor
    # face-arrival code for the DDMC albedo test: +-(axis+1) after an IMC crossing
    face: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    def num_alive(self) -> torch.Tensor:
        return self.alive.sum(dtype=torch.int32)

    def global_position(self, mesh):
        """Physical (x, y, z) of each particle (block origin + local offset)."""
        org = mesh.block_origin[self.block.long()]
        return org[:, 0] + self.x, org[:, 1] + self.y, org[:, 2] + self.z

    def clone(self) -> "ParticleLedger":
        return ParticleLedger(
            **{f.name: getattr(self, f.name).clone() for f in dataclasses.fields(self)}
        )


def insert_particles(ledger: ParticleLedger, cand: dict, valid: torch.Tensor):
    """Write candidate particles into the ledger's dead slots, IN PLACE.

    ``cand`` maps field name -> candidate tensor (any shape, flattened); ``valid``
    masks real candidates. Valid candidates are ranked by prefix sum and written to
    dead slots in stable index order. Returns ``(ledger, n_dropped)``, where dropped
    candidates exceeded the free-slot count. Every destination slot is distinct, so
    the writes are deterministic on any device.
    """
    cap = ledger.capacity
    vflat = valid.reshape(-1)
    rank = torch.cumsum(vflat.to(torch.int64), 0) - 1
    order = torch.argsort(ledger.alive.to(torch.uint8), stable=True)  # free first
    n_dead = cap - ledger.alive.sum()
    ok = vflat & (rank < n_dead)
    n_dropped = vflat.sum() - ok.sum()
    dest = order[rank[ok]]

    for name, val in cand.items():
        arr = getattr(ledger, name)
        arr[dest] = val.reshape(-1)[ok].to(arr.dtype)
    ledger.alive[dest] = True
    if "absorbed" not in cand:
        ledger.absorbed[dest] = False
    if "face" not in cand:
        ledger.face[dest] = 0
    return ledger, n_dropped


def empty_ledger(capacity: int, dtype=torch.float32, device="cpu") -> ParticleLedger:
    def f():
        return torch.zeros((capacity,), dtype=dtype, device=device)

    def i():
        return torch.zeros((capacity,), dtype=torch.int32, device=device)

    def b():
        return torch.zeros((capacity,), dtype=torch.bool, device=device)

    return ParticleLedger(
        x=f(), y=f(), z=f(), vx=f(), vy=f(), vz=f(),
        tau=f(), weight=f(), energy=f(),
        block=i(), i=i(), j=i(), k=i(),
        alive=b(), absorbed=b(), face=i(),
    )
