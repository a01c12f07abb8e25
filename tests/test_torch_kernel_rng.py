"""K2: the port's counter-hash variates (``jaybenne_tpu_torch/ops/kernel_rng.py``)
against the JAX kernel's interpret-mode hash (``pallas_rng.make_raw_bits(...,
interpret=True)``) and ``DrawPool``. The raw bits, ``u23`` and ``u16`` must be
bitwise equal; ``exp23`` may differ by the last-ulp rounding of the two ``log``
implementations. The CUDA kernel is held against the same plain hash on a GPU in
``test_torch_cuda.py``."""

import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from jaybenne_tpu.ops import pallas_rng

from jaybenne_tpu_torch.ops import kernel_rng

SHAPE = (8, 128)
# the two float32 log implementations may differ by one ulp
EXP_RTOL = 2.5e-7


def _lanes(offset):
    return torch.arange(SHAPE[0] * SHAPE[1], dtype=torch.int64).reshape(SHAPE) + offset


def _jax_seed(key) -> int:
    """The JAX wrapper's seed: the key data's last word as int32
    (``pallas_transport.transport_pallas``)."""
    return int(np.asarray(jr.key_data(key)).reshape(-1)[-1].astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("seed", [-12345, 0, 349857, -(1 << 31), (1 << 31) - 1])
@pytest.mark.parametrize("lane_offset", [0, 3 * 16384])
def test_raw_bits_bitwise_equal(seed, lane_offset):
    jraw = pallas_rng.make_raw_bits(SHAPE, jnp.int32(seed), lane_offset, interpret=True)
    lanes = _lanes(lane_offset)
    for it in (0, 1, 7, 8, 1000, 12345, (1 << 31) - 1):
        for tag in range(6):
            want = np.asarray(jraw(jnp.int32(it), tag)).astype(np.int64)
            got = kernel_rng.raw_bits_plain(seed, lanes, it, tag).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"it={it} tag={tag}")
    # the dispatching wrapper takes the plain version for CPU tensors
    got = kernel_rng.raw_bits(seed, lanes.int(), torch.full(SHAPE, 5, dtype=torch.int32),
                              torch.full(SHAPE, 2, dtype=torch.int32))
    want = np.asarray(jraw(jnp.int32(5), 2)).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)


def test_seed_from_key_data_is_int32():
    """A key whose last word has its top bit set gives a negative int32 seed; both
    packages hash it as the same uint32 word."""
    key = jnp.asarray([7, 0xDEADBEEF], dtype=jnp.uint32)
    seed = _jax_seed(key)
    assert seed < 0 and seed & 0xFFFFFFFF == 0xDEADBEEF
    jraw = pallas_rng.make_raw_bits(SHAPE, jnp.int32(seed), 0, interpret=True)
    want = np.asarray(jraw(jnp.int32(3), 1)).astype(np.int64)
    got = kernel_rng.raw_bits_plain(seed, _lanes(0), 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("it", [0, 9, 4321])
def test_draw_pool_matches_jax(it):
    seed = -987654
    jpool = pallas_rng.DrawPool(
        pallas_rng.make_raw_bits(SHAPE, jnp.int32(seed), 16384, interpret=True)
    )
    lanes = _lanes(16384)
    tpool = kernel_rng.DrawPool(lambda i, tag: kernel_rng.raw_bits_plain(seed, lanes, i, tag))
    jit_ = jnp.int32(it)
    # tags are allocated in the same order: exp23 (0), u23 (1), u16 lo (2), u16 hi,
    # u16 lo (3), circle (4)
    e_j, e_t = np.asarray(jpool.exp23(jit_)), tpool.exp23(it).numpy()
    np.testing.assert_allclose(e_t, e_j, rtol=EXP_RTOL, atol=0)
    np.testing.assert_array_equal(tpool.u23(it).numpy(), np.asarray(jpool.u23(jit_)))
    for _ in range(3):
        np.testing.assert_array_equal(tpool.u16(it).numpy(), np.asarray(jpool.u16(jit_)))
    cj, sj = jpool.circle(jit_)
    ct, st = tpool.circle(it)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6, atol=1e-6)
    # sin = sqrt(1 - cos^2) magnifies a last-ulp cos difference near |cos| = 1
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=2e-5)
    np.testing.assert_array_equal(np.sign(st.numpy()), np.sign(np.asarray(sj)))
    assert (e_t >= 0).all() and np.isfinite(e_t).all()
