"""core/prng.py against jax.random: keys, fold_in, split and 32-bit bits
bit for bit; uniforms bit for bit; normals within the measured ulp."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro_torch.core import prng, seeds

SEEDS = [0, 1, 5, 12345, 2**31 - 1]
# erfinv: the port evaluates XLA's polynomial but not XLA's log1p, so a
# normal may land a few ulp from JAX's (measured: at most 3 ulp, on ~1% of
# draws, over 1.2e6 draws against jax 0.9 on the CPU)
NORMAL_MAX_ULP = 3


def _kd(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def test_threefry_partitionable_is_on():
    assert jax.config.jax_threefry_partitionable


def test_known_vector():
    assert prng.fold_in(prng.key(0), 5).tolist() == [1524306142, 1887795613]


@pytest.mark.parametrize("seed", SEEDS + [-3])
def test_key_fold_in_split(seed):
    jk = jax.random.key(seed)
    tk = prng.key(seed)
    assert tk.tolist() == _kd(jk).tolist()
    for d in (0, 1, 7, 2**32 - 1):
        assert prng.fold_in(tk, d).tolist() == \
            _kd(jax.random.fold_in(jk, d)).tolist()
    for num in (1, 2, 5):
        assert prng.split(tk, num).tolist() == \
            _kd(jax.random.split(jk, num)).tolist()


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_bit_exact(seed):
    n = 50_000
    jk = jax.random.key(seed)
    tk = prng.key(seed)
    jb = np.asarray(jax.random.bits(jk, (n,), jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(prng.bits32(tk, n).numpy(), jb)
    ju = np.asarray(jax.random.uniform(jk, (n,)))
    np.testing.assert_array_equal(prng.uniform(tk, n).numpy(), ju)
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    ju2 = np.asarray(jax.random.uniform(jk, (n,), jnp.float32, lo, 1.0))
    np.testing.assert_array_equal(prng.uniform(tk, n, lo, 1.0).numpy(), ju2)


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_measured_ulp(seed):
    n = 200_000
    jn = np.asarray(jax.random.normal(jax.random.key(seed), (n,)))
    tn = prng.normal(prng.key(seed), n).numpy()
    ulp = np.abs(jn.view(np.int32).astype(np.int64)
                 - tn.view(np.int32).astype(np.int64))
    assert ulp.max() <= NORMAL_MAX_ULP
    assert (ulp > 0).mean() < 0.02


def test_round_keys_match_seed_ladder():
    from repro.core import seeds as jseeds
    for rnd in (0, 3, -1):
        for T in (1, 4):
            assert seeds.round_keys(7, rnd, T).tolist() == \
                _kd(jseeds.round_keys(7, rnd, T)).tolist()
    assert seeds.step_key(7, 2, 3).tolist() == \
        _kd(jseeds.step_key(7, 2, 3)).tolist()
