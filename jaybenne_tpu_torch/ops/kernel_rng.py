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

The float64 census (``precision = f64``) draws from the same hash with 53-bit
uniforms, as the JAX package's float64 event loop draws ``jax.random.uniform(...,
float64)``. A float64 pool allocates its tags exactly as the float32 pool does
(one tag a word, the ``u16`` spare kept), so both census kernels share one tag
layout, but the word of tag t is four hash words, of tags 4t .. 4t + 3: a uniform
is ``u53(hi, lo) = ((hi >> 5) 2^26 + (lo >> 6)) 2^-53`` of the words 4t and 4t + 1
(``u23``, a ``u16`` low half, an ``exp23``, a ``circle``), and the spare ``u16``
high half is ``u53`` of 4t + 2 and 4t + 3, a full double uniform too. ``circle``
takes cos(pi u53) and the sign of the sine from bit 0 of word 4t + 1, which u53
does not use; ``exp23`` floors its uniform at ``finfo(float64).tiny``, as the JAX
float64 loop does. ``csrc/kernel_rng.cuh`` (``Draw<double>``) is the same scheme
in CUDA. The float32 pool's tags and bits are unchanged.
"""

from __future__ import annotations

import torch

from . import cuda_lib

_MASK = 0xFFFFFFFF
_TINY = 1.0e-37
_TINY64 = float(torch.finfo(torch.float64).tiny)
_PI64 = 3.141592653589793


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


def u53(hi, lo):
    """53-bit uniform on [0, 1) from two words, as float64."""
    return ((hi >> 5) * (1 << 26) + (lo >> 6)).to(torch.float64) * (1.0 / (1 << 53))


def draws_f64_plain(seed: int, lane, it, tag):
    """What the float64 pool makes of the word of tag ``tag``, as a [..., 5]
    float64 tensor: its uniform (``u23``, a ``u16`` low half), its spare ``u16``
    high half, its ``exp23``, and its circle's (cos, sin); the plain version of
    ``jb_draws_f64_launch``."""
    w = [raw_bits_plain(seed, lane, it, 4 * torch.as_tensor(tag, dtype=torch.int64) + k)
         for k in range(4)]
    u = u53(w[0], w[1])
    ch, sh = _circle64(u, w[1])
    ex = -torch.log(torch.clamp_min(u, _TINY64))
    return torch.stack([u, u53(w[2], w[3]), ex, ch, sh], dim=-1)


def _circle64(u, lo):
    ch = torch.cos(_PI64 * u)
    sh = torch.sqrt(torch.clamp_min(1.0 - ch * ch, 0.0))
    return ch, torch.where((lo & 1) != 0, -sh, sh)


def draws_f64_cuda(seed: int, lane, it, tag):
    """The CUDA kernel of ``draws_f64_plain`` (``Draw<double>`` of
    csrc/kernel_rng.cuh): int32 tensors of one shape on one GPU in."""
    for t in (lane, it, tag):
        if t.device.type != "cuda" or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("draws_f64_cuda takes contiguous int32 CUDA tensors")
        if t.shape != lane.shape or t.device != lane.device:
            raise ValueError("draws_f64_cuda: lane, it and tag must share shape and device")
    out = torch.empty(lane.shape + (5,), dtype=torch.float64, device=lane.device)
    cuda_lib.library().call(
        "jb_draws_f64_launch", int(seed), lane.data_ptr(), it.data_ptr(), tag.data_ptr(),
        out.data_ptr(), lane.numel(), cuda_lib.stream_handle(lane.device),
    )
    cuda_lib.LAUNCHES["draws_f64"] += 1
    return out


class DrawPool:
    """Serves one event's variates, allocating tags in the JAX ``DrawPool``'s order:
    each word takes the next tag; ``u16`` uses a word's low half and keeps the high
    half as the spare for the next ``u16``. Create one pool per event.

    ``raw(it, tag)`` returns the hash words (``raw_bits_plain`` bound to a seed
    and lanes). With ``dtype`` float64 the variates are float64 and each word is
    four hash words (the module docstring); the tags are allocated alike."""

    def __init__(self, raw, dtype=torch.float32):
        self._raw = raw
        self._tag = 0
        self._spare = None
        self._f64 = dtype == torch.float64

    def _bits(self, it):
        b = self._raw(it, self._tag)
        self._tag += 1
        return b

    def _pair(self, it):
        """The float64 pool's next word t: (hi, lo) of its tags 4t, 4t + 1, and t."""
        t = self._tag
        self._tag += 1
        return self._raw(it, 4 * t), self._raw(it, 4 * t + 1), t

    def u23(self, it):
        if self._f64:
            hi, lo, _ = self._pair(it)
            return u53(hi, lo)
        return u23(self._bits(it))

    def u16(self, it):
        if self._f64:  # the spare is the tag whose second pair is still unused
            if self._spare is not None:
                t, self._spare = self._spare, None
                return u53(self._raw(it, 4 * t + 2), self._raw(it, 4 * t + 3))
            hi, lo, self._spare = self._pair(it)
            return u53(hi, lo)
        if self._spare is not None:
            u, self._spare = self._spare, None
            return u
        b = self._bits(it)
        self._spare = u16_hi(b)
        return u16_lo(b)

    def exp23(self, it):
        if self._f64:
            return -torch.log(torch.clamp_min(self.u23(it), _TINY64))
        return -torch.log(torch.clamp_min(self.u23(it), _TINY))

    def circle(self, it):
        """(cos phi, sin phi) for phi ~ U[0, 2pi) from one word."""
        if self._f64:
            hi, lo, _ = self._pair(it)
            return _circle64(u53(hi, lo), lo)
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
