"""Port parity: ``nos_tpu_torch.utils.prng`` against ``jax.random`` on the
CPU, over seeds, shapes (0-D to 3-D) and ranges.

Bounds: keys, ``fold_in``, ``split``, ``bits``, ``randint`` and
``uniform`` bit for bit. ``gumbel`` within 4 f32 ulp, the ulp taken at
max(|g|, 1): its two logs are XLA's on one side and the port's own on
the other, and below |g| = 1 the error is the inner log's, whose value
is near 1 there. ``categorical`` gives the same index on every row whose
top two perturbed logits (JAX's) differ by more than 1e-4, and such rows
are at least 99% of the grid.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from nos_tpu_torch.utils import prng  # noqa: E402

SEEDS = [0, 1, 42, 2 ** 31 - 1, 2 ** 32 - 1, 123456789]
SHAPES = [(), (1,), (7,), (4, 5), (2, 3, 7)]
GUMBEL_ULP = 4
GAP = 1e-4


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy()


@pytest.mark.parametrize("seed", SEEDS + [2 ** 32 + 5, 7 * 2 ** 31])
def test_prng_key(seed):
    np.testing.assert_array_equal(_np(prng.PRNGKey(seed)),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 1, 7, 2 ** 31, 2 ** 32 - 1])
def test_fold_in(seed, data):
    want = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    np.testing.assert_array_equal(_np(prng.fold_in(prng.PRNGKey(seed), data)),
                                  np.asarray(want))


def test_fold_in_batched_equals_vmap():
    seeds = np.array([0, 5, 2 ** 32 - 1, 77], np.uint32)
    data = np.array([3, 0, 9, 2 ** 31], np.uint32)
    want = jax.vmap(lambda s, d: jax.random.fold_in(jax.random.PRNGKey(s),
                                                    d))(seeds, data)
    got = prng.fold_in(prng.PRNGKey(torch.from_numpy(seeds.astype(np.int64))),
                       torch.from_numpy(data.astype(np.int64)))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [1, 2, 5, 64])
def test_split(seed, num):
    want = jax.random.split(jax.random.PRNGKey(seed), num)
    np.testing.assert_array_equal(_np(prng.split(prng.PRNGKey(seed), num)),
                                  np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_random_bits(seed, shape):
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape))
    got = _np(prng.random_bits(prng.PRNGKey(seed), shape))
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lo,hi", [(0, 7), (0, 32000), (0, 128256),
                                   (0, 1024), (-5, 9), (3, 3)])
def test_randint(seed, shape, lo, hi):
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, lo,
                                         hi))
    got = _np(prng.randint(prng.PRNGKey(seed), shape, lo, hi))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform(seed, shape):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape))
    got = _np(prng.uniform(prng.PRNGKey(seed), shape))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (7,), (64, 1000), (2, 3, 50)])
def test_gumbel(seed, shape):
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape))
    got = _np(prng.gumbel(prng.PRNGKey(seed), shape))
    assert got.dtype == np.float32
    ulp = np.spacing(np.maximum(np.abs(want), np.float32(1)))
    err = np.abs(got.astype(np.float64) - want) / ulp
    assert err.max() <= GUMBEL_ULP, err.max()


def _gap_rows(perturbed: np.ndarray) -> np.ndarray:
    top2 = np.sort(perturbed, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > GAP


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("rows,vocab,scale", [(256, 64, 1.0),
                                              (64, 1000, 3.0),
                                              (16, 32000, 2.0)])
def test_categorical(seed, rows, vocab, scale):
    rng = np.random.default_rng(seed % 1000)
    logits = (rng.normal(size=(rows, vocab)) * scale).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.categorical(key, logits))
    got = _np(prng.categorical(prng.PRNGKey(seed), torch.from_numpy(logits)))
    clear = _gap_rows(np.asarray(jax.random.gumbel(key, logits.shape))
                      + logits)
    assert clear.mean() >= 0.99, clear.mean()
    np.testing.assert_array_equal(got[clear], want[clear])


@pytest.mark.parametrize("vocab", [64, 32000])
def test_categorical_batched_keys_equal_vmap(vocab):
    """keys [B, 2] draw row b's noise from key b over one row, as the
    engine's ``jax.vmap(categorical)`` does."""
    rng = np.random.default_rng(vocab)
    seeds = np.array([0, 1, 99, 2 ** 32 - 1, 12, 4096], np.uint32)
    pos = np.array([5, 1, 0, 300, 17, 64], np.uint32)
    logits = (rng.normal(size=(len(seeds), vocab)) * 2).astype(np.float32)
    keys = jax.vmap(lambda s, i: jax.random.fold_in(jax.random.PRNGKey(s),
                                                    i))(seeds, pos)
    want = np.asarray(jax.vmap(jax.random.categorical)(keys, logits))
    tkeys = prng.fold_in(
        prng.PRNGKey(torch.from_numpy(seeds.astype(np.int64))),
        torch.from_numpy(pos.astype(np.int64)))
    got = _np(prng.categorical(tkeys, torch.from_numpy(logits)))
    noise = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (vocab,)))(
        keys))
    clear = _gap_rows(noise + logits)
    np.testing.assert_array_equal(got[clear], want[clear])
    assert clear.all()


def test_randint_refuses_bounds_outside_int32():
    with pytest.raises(ValueError, match="int32"):
        prng.randint(prng.PRNGKey(0), (2,), 0, 2 ** 31)


def test_draws_are_device_and_dtype_stable():
    """Keys and bits are int64 words in [0, 2^32); uniform is f32 in
    [0, 1); the same call twice gives the same bits."""
    key = prng.fold_in(prng.PRNGKey(3), 11)
    assert key.dtype == torch.int64 and key.shape == (2,)
    bits = prng.random_bits(key, (1000,))
    assert int(bits.min()) >= 0 and int(bits.max()) < 2 ** 32
    u = prng.uniform(key, (1000,))
    assert u.dtype == torch.float32 and float(u.min()) >= 0 \
        and float(u.max()) < 1
    assert torch.equal(prng.gumbel(key, (50,)), prng.gumbel(key, (50,)))
