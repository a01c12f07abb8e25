"""The particle decomposition (port of ``jaybenne_tpu/parallel/sharding.py``).

The ledger is split over the shards and the fields are replicated: every shard
transports its own particles to census with no communication, and a step meets
the other shards only to sum the per-cell birth counts and the tallies
(``step.build_step_core`` with an exchange). The random streams of shard s hash
the shard word s after the phase, the counterpart of the reference's
``seed + my_rank``.

A shard's ledger is what its census runs on, so its slot is its lane: in one
process the local shards' ledgers are contiguous views of one ledger of ``n``
equal slices (``split_ledger``); in a process group each rank holds its own.
Either way a slot draws the same numbers, so the two backends agree bitwise.
"""

from __future__ import annotations

import dataclasses

from ..particles import ParticleLedger
from ..step import build_step_core, initialize_radiation


def pad_capacity(capacity: int, n: int) -> int:
    """``capacity`` rounded up to a multiple of the shard count ``n``."""
    return ((capacity + n - 1) // n) * n


def split_ledger(p: ParticleLedger, n: int) -> list:
    """The ``n`` equal slices of a ledger, as views: the shards' ledgers in one
    process (updated in place, they update ``p``)."""
    if p.capacity % n:
        raise ValueError(f"ledger capacity {p.capacity} is not a multiple of {n} shards")
    cap = p.capacity // n
    return [ParticleLedger(**{f.name: getattr(p, f.name)[s * cap:(s + 1) * cap]
                              for f in dataclasses.fields(p)}) for s in range(n)]


def grow_ledger(p: ParticleLedger, n: int, new_cap: int) -> ParticleLedger:
    """A ledger of ``n`` slices of ``new_cap`` slots each holding the ``n`` slices of
    ``p`` at their starts: every particle keeps its shard and its slot."""
    old = p.capacity // n
    out = {}
    for f in dataclasses.fields(p):
        col = getattr(p, f.name)
        grown = col.new_zeros(n * new_cap)
        grown.view(n, new_cap)[:, :old] = col.view(n, old)
        out[f.name] = grown
    return ParticleLedger(**out)


def local_states(state, exchange, split_fields=None) -> list:
    """The local shards' states of one process's ``state``: its ledger split into
    the local shards' slices, its fields replicated (or ``split_fields(shard)``)."""
    ps = split_ledger(state.particles, len(exchange.shards))
    return [dataclasses.replace(state, particles=p,
                                fields=state.fields if split_fields is None else split_fields(s))
            for p, s in zip(ps, exchange.shards)]


def make_sharded_step(mesh, cfg, exchange):
    """``step(states, dt) -> (states, stats)`` of the particle decomposition over
    the local shards' states."""
    return build_step_core(mesh, cfg, exchange)


def make_sharded_init(mesh, cfg, exchange):
    """``init(states) -> states``: each shard thermal-sources its share."""
    def init(states):
        return initialize_radiation(states, mesh, cfg, exchange)

    return init

