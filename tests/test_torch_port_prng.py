"""The port's threefry2x32 sampler bits against ``jax.random``.

Keys, folded keys, random bits and uniform floats are integer arithmetic
and must equal JAX's bit for bit. Gumbel noise takes two float32
logarithms, which PyTorch and XLA round independently (each within one
ulp), so it is held within 2 ulp of float32 at the scale max(|g|, 1):
the noise is added to O(1) logits before the argmax.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.generation.engine import derive_keys as jderive_keys
from flexflow_tpu_torch.generation import prng
from flexflow_tpu_torch.generation.engine import derive_keys

pytestmark = pytest.mark.torch_port

SEEDS = [0, 1, 2**31 - 1, -7]
COUNTS = [0, 1, 31, 2**31 - 1]
TINY = np.finfo(np.float32).tiny
EPS = np.finfo(np.float32).eps


def _jkey(seed, count):
    return jax.random.fold_in(jax.random.key(np.int32(seed)), count)


def _words(k):
    return [int(k[0]), int(k[1])]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in_equal_jax(seed):
    jk = jax.random.key(np.int32(seed))
    assert _words(prng.key(seed)) == np.asarray(jax.random.key_data(jk)).tolist()
    for count in COUNTS:
        want = np.asarray(jax.random.key_data(_jkey(seed, count))).tolist()
        assert _words(prng.fold_in(prng.key(seed), count)) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_and_uniform_equal_jax(seed):
    for count in COUNTS:
        jk = _jkey(seed, count)
        tk = prng.fold_in(prng.key(seed), count)
        jbits = np.asarray(jax.random.bits(jk, (3, 129), jnp.uint32)).astype(np.int64)
        np.testing.assert_array_equal(prng.random_bits(tk, (3, 129)).numpy(), jbits)
        for lo, hi in ((0.0, 1.0), (TINY, 1.0), (-2.0, 3.0)):
            ju = np.asarray(jax.random.uniform(jk, (517,), minval=lo, maxval=hi))
            tu = prng.uniform(tk, (517,), minval=lo, maxval=hi).numpy()
            np.testing.assert_array_equal(tu.view(np.int32), ju.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_two_ulp_of_jax(seed):
    for count in COUNTS:
        jg = np.asarray(jax.random.gumbel(_jkey(seed, count), (4096,)))
        tg = prng.gumbel(prng.fold_in(prng.key(seed), count), (4096,)).numpy()
        assert np.isfinite(tg).all()
        assert (np.abs(tg - jg) <= 2 * EPS * np.maximum(np.abs(jg), 1.0)).all()


def test_derive_keys_batched_equal_jax():
    """The engine's batched derivation over slots: uint32 seeds (as the
    schedulers pass them) and generated-token counts."""
    seeds = np.asarray([0, 1, 2**31 - 1, 2**32 - 7, 12345], np.uint32)
    counts = np.asarray([0, 5, 2**31 - 1, 3, 999], np.int32)
    want = np.asarray(jax.random.key_data(jderive_keys(jnp.asarray(seeds), jnp.asarray(counts))))
    k1, k2 = derive_keys(torch.from_numpy(seeds.astype(np.int64)), torch.from_numpy(counts))
    np.testing.assert_array_equal(np.stack([k1.numpy(), k2.numpy()], -1), want.astype(np.int64))
    # one row of batched noise is the unbatched draw of its own key
    g = prng.gumbel((k1, k2), (64,))
    assert g.shape == (5, 64)
    solo = prng.gumbel(prng.fold_in(prng.key(int(seeds[3])), int(counts[3])), (64,))
    assert torch.equal(g[3], solo)
