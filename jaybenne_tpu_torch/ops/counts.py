"""The step's and the spatial round's counts: each local shard's live particles
and those alive short of census, and a round's counters (port of the JAX
package's ``num_alive``, ``jaybenne_tpu/particles.py:78-79``, its step's
``unfinished``, ``jaybenne_tpu/step.py:280, :317``, and its spatial round's
``local_unfinished`` with the loop carry's adds,
``jaybenne_tpu/parallel/spatial.py:480-488``).

On a GPU one launch of the count kernel (``csrc/count_kernel.cu``) over every
local shard's adjacent slice of one ledger (``particles.join_slices``); in a
spatial round the same launch adds the round's census and migration counts to
the step's accumulators. On the CPU the plain versions, a shard at a time. Every
count is an integer, so both give the same bits in any order.
"""

from __future__ import annotations

import ctypes

import torch

from ..particles import join_slices


def counts_plain(ledgers) -> tuple:
    """Each ledger's live count and its count alive with ``tau < 1`` (compared at
    the ledger's precision), as one [2, m] int64 tensor (live, then unfinished),
    and their totals, one [3] int64 tensor: the live counts' sum and max and the
    unfinished counts' sum."""
    live = torch.stack([p.alive.sum(dtype=torch.int64) for p in ledgers])
    short = torch.stack([(p.alive & (p.tau < 1.0)).sum(dtype=torch.int64) for p in ledgers])
    return torch.stack([live, short]), torch.stack([live.sum(), live.max(), short.sum()])


def round_counts_plain(ledgers, acc, it, ev, drop, sent, go, max_iters) -> None:
    """A spatial round's bookkeeping, the plain version (IN PLACE on ``acc``, an
    object with the step's accumulators ``iters`` (int32) ``events``, ``hits``,
    ``dropped``, ``sent`` (int64, one a local shard), ``rounds`` and
    ``unfinished`` (0-dim int64)): the census's iterations ``it`` and events
    ``ev``, a cap hit where ``it`` reached ``max_iters``, the migration's
    ``drop`` and ``sent`` (None where nothing migrates) added; ``rounds`` plus
    the round's ``go`` (a 0-dim bool tensor; None: the round has work, 1);
    ``unfinished`` the local shards' summed unfinished count, written afresh."""
    _, totals = counts_plain(ledgers)
    hit = it >= max_iters
    if go is not None:
        hit = hit & go
    acc.iters.add_(it)
    acc.events.add_(ev)
    acc.hits.add_(hit.to(torch.int64))
    if drop is not None:
        acc.dropped.add_(drop)
        acc.sent.add_(sent)
    acc.rounds.add_(1 if go is None else go.to(torch.int64))
    acc.unfinished.copy_(totals[2])


def scratch(m: int, device) -> torch.Tensor:
    """The count kernel's scratch for ``m`` local shards: 2 m + 1 int64 at 0 (each
    shard's two sums and the launches' ticket), which every launch leaves at 0. A
    step makes its own when it is built, outside any capture, so that a CUDA graph
    keeps its pointer and a replay queues no memset."""
    return torch.zeros(2 * m + 1, dtype=torch.int64, device=device)


def _launch(ledgers, per, totals, work, round_ptrs=None, max_iters=0, counters=()) -> None:
    """One launch of the count kernel over the local shards' ``ledgers``
    (adjacent equal slices of one ledger on one GPU) on PyTorch's current stream,
    without waiting for it; ``work`` is its ``scratch`` (None: a fresh one)."""
    from . import cuda_lib

    joined, bounds = join_slices(ledgers)
    m, dev = len(ledgers), joined.alive.device
    work = scratch(m, dev) if work is None else work
    if work.dtype != torch.int64 or work.shape != (2 * m + 1,) or work.device != dev:
        raise ValueError(f"count kernel: a scratch of {2 * m + 1} int64 on {dev} expected")
    cap_l = ledgers[0].capacity
    if any(hi - lo != cap_l for lo, hi in bounds):
        raise ValueError(f"count kernel: shards of {[hi - lo for lo, hi in bounds]} slots")
    tau = joined.tau
    if (joined.alive.dtype != torch.bool or tau.dtype not in (torch.float32, torch.float64)
            or tau.device != dev or not joined.alive.is_contiguous() or not tau.is_contiguous()):
        raise ValueError("count kernel: a bool alive and a float32 or float64 tau column, "
                         "contiguous on one GPU")
    for t in (per, totals, *counters):
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError("count kernel: its counters must be contiguous on the ledger's GPU")
    cuda_lib.library().call(
        "jb_counts_launch", joined.alive.data_ptr(), tau.data_ptr(), tau.element_size(), m,
        cap_l, work.data_ptr(), None if per is None else per.data_ptr(),
        None if totals is None else totals.data_ptr(), round_ptrs, int(max_iters),
        cuda_lib.stream_handle(dev))
    cuda_lib.LAUNCHES["round_counts"] += 1


def counts(ledgers, work=None, plain=False) -> tuple:
    """``counts_plain``'s counts of the local shards' ``ledgers``: on a GPU one
    launch of the count kernel (the ledgers adjacent slices of one ledger; ``work``
    its ``scratch``, None for a fresh one), on the CPU (or with ``plain``) the
    plain version. Returns ([2, m], [3]) int64 tensors on the ledgers' device."""
    dev = ledgers[0].alive.device
    if dev.type == "cuda" and not plain:
        m = len(ledgers)
        per = torch.empty((2, m), dtype=torch.int64, device=dev)
        totals = torch.empty(3, dtype=torch.int64, device=dev)
        _launch(ledgers, per, totals, work)
        return per, totals
    if dev.type != "cpu" and not plain:
        raise ValueError(f"counts: unsupported device {dev}")
    return counts_plain(ledgers)


def round_counts(ledgers, acc, it, ev, drop, sent, go, max_iters, work=None,
                 plain=False) -> None:
    """``round_counts_plain``'s bookkeeping of a spatial round (IN PLACE on
    ``acc``): on a GPU one launch of the count kernel (``work`` its ``scratch``,
    None for a fresh one), on the CPU (or with ``plain``) the plain version."""
    dev = ledgers[0].alive.device
    if dev.type != "cuda" or plain:
        if dev.type != "cpu" and not plain:
            raise ValueError(f"round_counts: unsupported device {dev}")
        return round_counts_plain(ledgers, acc, it, ev, drop, sent, go, max_iters)
    m = len(ledgers)
    want = ((it, torch.int32, (m,)), (ev, torch.int64, (m,)), (acc.iters, torch.int32, (m,)),
            (acc.events, torch.int64, (m,)), (acc.hits, torch.int64, (m,)),
            (acc.rounds, torch.int64, ()), (acc.unfinished, torch.int64, ()))
    if drop is not None:
        want += ((drop, torch.int64, (m,)), (sent, torch.int64, (m,)),
                 (acc.dropped, torch.int64, (m,)), (acc.sent, torch.int64, (m,)))
    if go is not None:
        want += ((go, torch.bool, ()),)
    if any(t.dtype != dtype or tuple(t.shape) != shape for t, dtype, shape in want):
        raise ValueError("count kernel: the round's counters are not of the step's types")
    ptrs = [go, it, ev, drop, sent, acc.iters, acc.events, acc.hits,
            None if drop is None else acc.dropped, None if drop is None else acc.sent,
            acc.rounds, acc.unfinished]
    round_ptrs = (ctypes.c_void_p * len(ptrs))(*[None if t is None else t.data_ptr()
                                                 for t in ptrs])
    _launch(ledgers, None, None, work, round_ptrs, max_iters, [t for t in ptrs if t is not None])
