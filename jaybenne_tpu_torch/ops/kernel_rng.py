"""Counter-hash variates of the census kernel (K2; port of
``jaybenne_tpu/ops/pallas_rng.py``).

The JAX kernel's interpret mode draws its uniforms from a murmur3-finalizer hash
keyed by ``(seed, lane, iteration, tag)``; the TPU's hardware PRNG is only its
compiled path. This module is that hash in PyTorch, and ``csrc/kernel_rng.cuh`` is
the same hash as CUDA device functions. With lane = ledger slot, the CUDA census
kernel, its plain version here and the JAX kernel under ``interpret=True`` all draw
the same variates.

PyTorch's uint32 supports too few operations, so the plain version computes in
int64 and masks with ``& 0xFFFFFFFF`` after every add and multiply: the low 32 bits
of a two's-complement product are right even when the int64 product wraps.
"""

from __future__ import annotations

import torch

from . import cuda_lib

_MASK = 0xFFFFFFFF
_TINY = 1.0e-37


def raw_bits_plain(seed: int, lane, it, tag):
    """The hash as uint32 values in an int64 tensor. ``seed`` is the kernel's
    signed 32-bit seed; ``lane``, ``it`` and ``tag`` are int tensors or ints that
    broadcast together."""
    x = torch.as_tensor(lane, dtype=torch.int64)
    it = torch.as_tensor(it, dtype=torch.int64, device=x.device)
    tag = torch.as_tensor(tag, dtype=torch.int64, device=x.device)
    x = (x + (seed & _MASK)) & _MASK
    x = (x + ((it * 0x9E3779B9) & _MASK)) & _MASK
    x = (x + ((tag * 0x85EBCA6B) & _MASK)) & _MASK
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _MASK
    return x ^ (x >> 16)


def raw_bits_cuda(seed: int, lane, it, tag):
    """The CUDA raw_bits kernel: int32 tensors of one shape on one GPU in, the hash
    as uint32 values in an int64 tensor out."""
    for t in (lane, it, tag):
        if t.device.type != "cuda" or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("raw_bits_cuda takes contiguous int32 CUDA tensors")
        if t.shape != lane.shape or t.device != lane.device:
            raise ValueError("raw_bits_cuda: lane, it and tag must share shape and device")
    out = torch.empty_like(lane)
    n = lane.numel()
    cuda_lib.library().call(
        "jb_raw_bits_launch", int(seed), lane.data_ptr(), it.data_ptr(), tag.data_ptr(),
        out.data_ptr(), n, cuda_lib.stream_handle(lane.device),
    )
    cuda_lib.LAUNCHES["raw_bits"] += 1
    return out.to(torch.int64) & _MASK


def raw_bits(seed: int, lane, it, tag):
    """The hash, through the CUDA kernel for CUDA tensors and the plain version
    for CPU tensors."""
    if lane.device.type == "cuda":
        return raw_bits_cuda(seed, lane, it, tag)
    if lane.device.type != "cpu":
        raise ValueError(f"raw_bits: unsupported device {lane.device}")
    return raw_bits_plain(seed, lane, it, tag)


def u23(bits):
    return ((bits >> 9) & 0x7FFFFF).to(torch.float32) * (1.0 / (1 << 23))


def u16_lo(bits):
    return (bits & 0xFFFF).to(torch.float32) * (1.0 / (1 << 16))


def u16_hi(bits):
    return ((bits >> 16) & 0xFFFF).to(torch.float32) * (1.0 / (1 << 16))


class DrawPool:
    """Serves one event's variates, allocating tags in the JAX ``DrawPool``'s order:
    each word takes the next tag; ``u16`` uses a word's low half and keeps the high
    half as the spare for the next ``u16``. Create one pool per event.

    ``raw(it, tag)`` returns the hash words (``raw_bits_plain`` bound to a seed
    and lanes)."""

    def __init__(self, raw):
        self._raw = raw
        self._tag = 0
        self._spare = None

    def _bits(self, it):
        b = self._raw(it, self._tag)
        self._tag += 1
        return b

    def u23(self, it):
        return u23(self._bits(it))

    def u16(self, it):
        if self._spare is not None:
            u, self._spare = self._spare, None
            return u
        b = self._bits(it)
        self._spare = u16_hi(b)
        return u16_lo(b)

    def exp23(self, it):
        return -torch.log(torch.clamp_min(self.u23(it), _TINY))

    def circle(self, it):
        """(cos phi, sin phi) for phi ~ U[0, 2pi) from one word."""
        b = self._bits(it)
        ch = torch.cos(3.14159265358979 * u23(b))
        sh = torch.sqrt(torch.clamp_min(1.0 - ch * ch, 0.0))
        return ch, torch.where((b & 1) != 0, -sh, sh)


def census_words_plain(seed: int, lane_events, words: int):
    """The xor of the hash words that each lane of a census draws: lane l draws
    tags 0 .. words - 1 in each of its ``lane_events[l]`` iterations. uint32 values
    in an int64 tensor."""
    ev = torch.as_tensor(lane_events, dtype=torch.int64)
    lane = torch.arange(ev.numel(), dtype=torch.int64, device=ev.device)
    out = torch.zeros_like(lane)
    for it in range(int(ev.max()) if ev.numel() else 0):
        live = ev > it
        for tag in range(words):
            out ^= torch.where(live, raw_bits_plain(seed, lane, it, tag), 0)
    return out


def census_words_cuda(seed: int, lane_events, words: int):
    """``census_words_plain`` by the CUDA probe of csrc/sass_probes.cu, which draws
    a census's words alone (its time is K2's share of the census): a contiguous
    int32 CUDA tensor of per-lane event counts in."""
    ev = lane_events
    if ev.device.type != "cuda" or ev.dtype != torch.int32 or not ev.is_contiguous():
        raise ValueError("census_words_cuda takes a contiguous int32 CUDA tensor")
    out = torch.empty_like(ev)
    cuda_lib.library().call(
        "jb_census_words_launch", int(seed), ev.data_ptr(), out.data_ptr(), ev.numel(),
        int(words), cuda_lib.stream_handle(ev.device),
    )
    cuda_lib.LAUNCHES["census_words"] += 1
    return out.to(torch.int64) & _MASK


def census_words(seed: int, lane_events, words: int):
    """The census's words, through the CUDA probe for a CUDA tensor and the plain
    version for a CPU tensor."""
    if lane_events.device.type == "cuda":
        return census_words_cuda(seed, lane_events, words)
    if lane_events.device.type != "cpu":
        raise ValueError(f"census_words: unsupported device {lane_events.device}")
    return census_words_plain(seed, lane_events, words)
