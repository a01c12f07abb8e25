"""The collectives of the decompositions: the port's counterpart of the
``jax.lax`` collectives that ``shard_map`` gives the JAX package.

A step of either decomposition is written over the *local shards*: the shards this
process runs, each a ``SimState`` of its own. It does each shard's local work in a
loop and meets the other shards only through one ``Exchange``, whose four
collectives take one tensor per local shard and return one per local shard:

  * ``all_gather(xs)``: every shard's tensor, concatenated along dim 0 in shard
    order (``lax.all_gather(..., tiled=True)``);
  * ``all_to_all(xs)``: each ``xs[i]`` is ``[n, ...]``, row j addressed to shard j;
    shard s receives ``out[j]`` = what shard j addressed to s, in j order
    (``lax.all_to_all(..., split_axis=0, concat_axis=0)``), returned as one
    tensor whose row i is local shard i's (so one pass can take every shard's);
  * ``sum(xs)`` and ``max(xs)``: the elementwise integer sum and maximum over every
    shard (``lax.psum``, ``lax.pmax``). Only integers are reduced: an integer sum
    does not depend on the order of its terms, so a reduction over shards repeats
    bitwise on any backend.

Two backends implement it:

  (a) ``Distributed``: one shard per process of a ``torch.distributed`` process
      group (gloo on the CPU);
  (b) ``InProcess``: n shards in this process on one device, looped over by the
      host. Its deliveries are those of (a), so the slots that migrated particles
      land in, and with them their random streams, do not depend on the backend.

``exchange_for`` picks (a) when ``torch.distributed`` is initialised with a world
size above 1, else (b). There is no fallback between them: a deck that asks for
another shard count than the process group has raises, and a failing collective
raises.
"""

from __future__ import annotations

import torch


def _integers(xs):
    if any(x.is_floating_point() or x.is_complex() for x in xs):
        raise TypeError("exchange: only integer tensors are reduced over shards")


class Exchange:
    """``n`` shards in all; this process runs ``shards`` (their global indices)."""

    n: int
    shards: tuple

    def all_gather(self, xs):
        raise NotImplementedError

    def all_to_all(self, xs):
        raise NotImplementedError

    def sum(self, xs):
        raise NotImplementedError

    def max(self, xs):
        raise NotImplementedError


class InProcess(Exchange):
    """Backend (b): ``n`` shards in this process."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"exchange: {n} shards")
        self.n = n
        self.shards = tuple(range(n))

    def _check(self, xs):
        if len(xs) != self.n:
            raise ValueError(f"exchange: {len(xs)} tensors for {self.n} shards")

    def all_gather(self, xs):
        self._check(xs)
        out = torch.cat(list(xs))
        return [out] * self.n

    def all_to_all(self, xs):
        self._check(xs)
        return torch.stack(list(xs), dim=1)

    def sum(self, xs):
        self._check(xs)
        _integers(xs)
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return [out] * self.n

    def max(self, xs):
        self._check(xs)
        _integers(xs)
        out = xs[0]
        for x in xs[1:]:
            out = torch.maximum(out, x)
        return [out] * self.n


class Distributed(Exchange):
    """Backend (a): this process is one shard of a ``torch.distributed`` group."""

    def __init__(self):
        import torch.distributed as dist

        self._dist = dist
        self.n = dist.get_world_size()
        self.shards = (dist.get_rank(),)

    def all_gather(self, xs):
        (x,) = xs
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.n)]
        self._dist.all_gather(parts, x)
        return [torch.cat(parts)]

    def all_to_all(self, xs):
        (x,) = xs
        if x.shape[0] != self.n:
            raise ValueError(f"exchange: all_to_all of {x.shape[0]} rows for {self.n} shards")
        x = x.contiguous()
        out = torch.empty_like(x)
        self._dist.all_to_all_single(out, x)
        return out[None]

    def _reduce(self, xs, op):
        (x,) = xs
        _integers(xs)
        out = x.clone()
        self._dist.all_reduce(out, op=op)
        return [out]

    def sum(self, xs):
        return self._reduce(xs, self._dist.ReduceOp.SUM)

    def max(self, xs):
        return self._reduce(xs, self._dist.ReduceOp.MAX)


def world_size() -> int:
    """The size of the initialised ``torch.distributed`` group, else 1."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def exchange_for(n_devices: int) -> Exchange:
    """The backend for a deck's ``jaybenne/n_devices``: (a) inside a process group of
    more than one process, where ``n_devices`` must be 0 or the group's size; else
    (b) with ``n_devices`` shards (0 means the world size, 1 outside a group)."""
    world = world_size()
    if world > 1:
        if n_devices not in (0, world):
            raise ValueError(f"jaybenne/n_devices = {n_devices}, but the process group has "
                             f"{world} processes")
        return Distributed()
    if n_devices < 0:
        raise ValueError(f"jaybenne/n_devices = {n_devices}")
    return InProcess(n_devices or 1)
