"""The port's counter PRNG (``ops/counter_prng.py``) against the JAX
package's (``ops/pallas_mppi.py`` ``_splitmix32``, ``_normals_from_counter``,
``_normals``): the hash bit for bit, including counters near 2^31 and
2^32-1 and a seed*FNV that wraps; the normals within 2e-6, the difference
of torch's and XLA's log and cos on the CPU (an ulp or two)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_toolkit_tpu.ops.pallas_mppi import _normals, _normals_from_counter, _splitmix32
from control_toolkit_tpu_torch.ops import counter_prng as cp

EDGES = np.array([0, 1, 2, 0x7F4A7C15, 2**31 - 2, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 0x7F4A7C15,
                  2**32 - 2, 2**32 - 1], np.uint64)
NORMAL_ATOL = 2e-6


def counters(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGES, rng.integers(0, 2**32, 4096, dtype=np.uint64)]).astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 1])
def test_splitmix32_is_bit_exact(seed):
    x = counters(seed)
    ref = np.asarray(_splitmix32(jnp.asarray(x))).astype(np.int64)
    got = cp.splitmix32(torch.tensor(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, ref)


def test_mul32_is_multiplication_mod_2_32():
    x = counters(2).astype(np.uint64)
    for c in (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, cp.FNV, 0xFFFFFFFF, 1):
        got = cp.mul32(torch.tensor(x.astype(np.int64)), c).numpy()
        np.testing.assert_array_equal(got, ((x * np.uint64(c)) % np.uint64(2**32)).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 2**31 - 2, 123456789])
def test_seed_base_wraps_as_uint32(seed):
    """seed*FNV overflows 32 bits for every seed above ~255; the base is the
    JAX kernel's uint32 product, and a negative int32 seed is taken mod 2^32
    as ``astype(uint32)`` takes it."""
    base, off = cp.seed_base(torch.tensor([seed, 5], dtype=torch.int32))
    ref = np.asarray(jnp.asarray(seed, jnp.int32).astype(jnp.uint32) * jnp.uint32(cp.FNV))
    assert int(base) == int(ref) and int(off) == 5
    neg, _ = cp.seed_base(torch.tensor([-seed - 1, 0], dtype=torch.int32))
    ref_neg = np.asarray(jnp.asarray(-seed - 1, jnp.int32).astype(jnp.uint32) * jnp.uint32(cp.FNV))
    assert int(neg) == int(ref_neg)


def test_normals_from_counter_match_jax():
    x = counters(3)
    ref = np.asarray(_normals_from_counter(jnp.asarray(x)))
    got = cp.normals_from_counter(torch.tensor(x.astype(np.int64))).numpy()
    assert got.dtype == np.float32 and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, rtol=0, atol=NORMAL_ATOL)


@pytest.mark.parametrize("base", [0, 2**32 - 100, 0xDEADBEEF])
def test_normals_layout_matches_jax(base):
    """``normals(base, (R, C))`` keys element [r, c] by ``base + r*C + c``
    (wrapping past 2^32), as ``_normals`` does."""
    ref = np.asarray(_normals(jnp.uint32(base), (16, 24)))
    got = cp.normals(base, (16, 24)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=NORMAL_ATOL)


def test_normals_are_standard():
    z = cp.normals(12345, (256, 512)).double()
    n = z.numel()
    assert abs(float(z.mean())) < 5.0 / n**0.5
    assert abs(float(z.var()) - 1.0) < 5.0 * (2.0 / n) ** 0.5


def test_rollout_coords_follow_the_tile_layout():
    """g = r*(K/ROWS) + t*C + c for rollout (sublane r, tile t, lane c)."""
    K, tile = 64, 16
    C = tile // cp.ROWS
    r, t, c = cp.rollout_coords(torch.arange(K), K, tile)
    np.testing.assert_array_equal((r * (K // cp.ROWS) + t * C + c).numpy(), np.arange(K))
    assert int(r.max()) == cp.ROWS - 1 and int(t.max()) == K // tile - 1 and int(c.max()) == C - 1
