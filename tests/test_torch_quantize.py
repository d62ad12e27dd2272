"""``repro_torch.core.quantize`` against ``repro.core.quantize``: the host
codec bit for bit (encode, decode, pack, wire size), the in-loop roundtrip
bit for bit under the same key, the fold stream, idempotence and the spec
parser.

One recorded divergence (ROADMAP C17): on a CPU, XLA reads subnormal f32
inputs as zero, so the JAX package's in-loop roundtrip of a subnormal
scalar differs from its own host codec.  The port's roundtrip follows the
host codec there (the codec is what the exact-replay invariant holds it
to), and is held to the JAX roundtrip on every other input."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from repro.core import quantize as JQ
from repro_torch.core import prng
from repro_torch.core import quantize as TQ

F32_MAX = np.finfo(np.float32).max
TINY_NORMAL = np.finfo(np.float32).tiny


def _inputs(seed: int) -> np.ndarray:
    """Zeros, the f32 extremes, grid edges (qmax * 2^e and half steps),
    powers of two across the exponent range and random magnitudes."""
    rng = np.random.default_rng(seed)
    edges = [0.0, -0.0, 1.0, -1.0, 127.0, 127.5, -126.5, 7.0, 7.5, 0.3,
             63.75, 2.0 ** -120, 1.5 * 2.0 ** -121, TINY_NORMAL, 1e-37,
             F32_MAX, -F32_MAX, 3.3e38, 2.0 ** 127, -(2.0 ** 126)]
    rand = rng.normal(size=40) * 10.0 ** rng.uniform(-30, 30, size=40)
    return np.concatenate([edges, rand]).astype(np.float32)


SUBNORMALS = np.array([1e-45, -1.4e-45, 3e-40, -1.17e-38, 5.9e-39],
                      np.float32)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("chunk", [1, 5])
@pytest.mark.parametrize("seeded", [False, True], ids=["nearest", "rng"])
def test_host_codec_bitexact(bits, chunk, seeded):
    x = np.concatenate([_inputs(bits + chunk), SUBNORMALS])
    with np.errstate(over="ignore"):
        jw = JQ.encode(x, bits, chunk,
                       np.random.default_rng(3) if seeded else None)
        tw = TQ.encode(x, bits, chunk,
                       np.random.default_rng(3) if seeded else None)
        jd, td = JQ.decode(jw), TQ.decode(tw)
    assert np.array_equal(jw.codes, tw.codes)
    assert np.array_equal(jw.exps, tw.exps)
    assert jw.shape == tw.shape
    assert jw.tobytes() == tw.tobytes()
    assert jw.nbytes == tw.nbytes == len(tw.tobytes())
    assert np.array_equal(_bits(jd), _bits(td))
    assert TQ.pack_codes(tw.codes, bits) == JQ.pack_codes(jw.codes, bits)
    assert np.array_equal(TQ.unpack_codes(TQ.pack_codes(tw.codes, bits),
                                          bits, tw.n), tw.codes)
    for n in (1, 2, 7, 64):
        assert TQ.wire_nbytes(n, bits, chunk) == \
            JQ.wire_nbytes(n, bits, chunk)
    assert np.array_equal(TQ.pow2_exponent(np.abs(x), bits),
                          JQ.pow2_exponent(np.abs(x), bits))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("shape", [(), (7,)], ids=["scalar", "C"])
def test_roundtrip_bitexact_against_jax(bits, stochastic, shape):
    """Same scalars, same key: the same applied values, bit for bit."""
    x = _inputs(11)
    for i, seed in enumerate(range(0, len(x), max(1, int(np.prod(shape))))):
        g = x[seed:seed + int(np.prod(shape))]
        if g.size != int(np.prod(shape)):
            break
        g = g.reshape(shape)
        jk = jax.random.fold_in(jax.random.key(i), JQ.QUANT_FOLD)
        tk = prng.fold_in(prng.key(i), TQ.QUANT_FOLD)
        with np.errstate(over="ignore"):
            want = np.asarray(JQ.quantize_roundtrip(jnp.asarray(g), jk, bits,
                                                    stochastic))
        got = TQ.quantize_roundtrip(torch.from_numpy(g), tk, bits,
                                    stochastic)
        assert tuple(got.shape) == shape
        assert np.array_equal(_bits(got.numpy()), _bits(want)), (g, got,
                                                                 want)


@pytest.mark.parametrize("bits", [8, 4])
def test_roundtrip_subnormals_follow_the_host_codec(bits):
    """Nearest mode on subnormal inputs equals the host codec (C17: XLA on
    a CPU flushes them, so the JAX roundtrip does not)."""
    got = TQ.quantize_roundtrip(torch.from_numpy(SUBNORMALS), None, bits,
                                stochastic=False).numpy()
    host = np.stack([JQ.decode(JQ.encode(v, bits)) for v in SUBNORMALS])
    assert np.array_equal(got, host)  # equal values (codes carry no -0.0)
    jax_rt = np.asarray(JQ.quantize_roundtrip(jnp.asarray(SUBNORMALS), None,
                                              bits, stochastic=False))
    assert not np.array_equal(jax_rt, host)  # the recorded divergence


@pytest.mark.parametrize("bits", [8, 4])
def test_nearest_roundtrip_matches_host_codec(bits):
    x = _inputs(5)
    with np.errstate(over="ignore"):
        host = np.stack([TQ.decode(TQ.encode(v, bits)) for v in x])
    got = TQ.quantize_roundtrip(torch.from_numpy(x), None, bits,
                                stochastic=False).numpy()
    assert np.array_equal(got, host)


@pytest.mark.parametrize("bits", [8, 4])
def test_on_grid_values_pass_unchanged(bits):
    """Idempotence: a roundtrip output goes through again bit for bit (both
    modes), and the server's nearest re-encode reproduces it."""
    g = torch.from_numpy(_inputs(9))
    k = prng.fold_in(prng.key(4), TQ.QUANT_FOLD)
    once = TQ.quantize_roundtrip(g, k, bits, stochastic=True)
    once = once[torch.isfinite(once)]  # F32_MAX-scale inputs round to inf
    assert once.numel() > 50
    for stochastic in (True, False):
        again = TQ.quantize_roundtrip(once, prng.key(8), bits, stochastic)
        assert np.array_equal(_bits(again.numpy()), _bits(once.numpy()))
    dec = np.stack([TQ.decode(TQ.encode(v, bits)) for v in once.numpy()])
    assert np.array_equal(dec, once.numpy())


def test_quant_spec_uses_fold_stream():
    g = np.linspace(-3.1, 2.9, 9).astype(np.float32)
    spec = TQ.QuantSpec(8)
    got = spec.apply(torch.from_numpy(g), prng.key(5))
    direct = TQ.quantize_roundtrip(torch.from_numpy(g),
                                   prng.fold_in(prng.key(5), TQ.QUANT_FOLD),
                                   8, True)
    want = JQ.QuantSpec(8).apply(jnp.asarray(g), jax.random.key(5))
    assert np.array_equal(_bits(got.numpy()), _bits(direct.numpy()))
    assert np.array_equal(_bits(got.numpy()), _bits(np.asarray(want)))
    other = spec.apply(torch.from_numpy(g), prng.key(6))
    assert not torch.equal(got, other)  # the key drives the draw


@pytest.mark.parametrize("spec", ["none", "", None, "int8", "int4",
                                  "int8-nearest", "int4-nearest"])
def test_make_codec_parsing(spec):
    t, j = TQ.make_codec(spec), JQ.make_codec(spec)
    assert (t.spec, t.bits, t.chunk) == (j.spec, j.bits, j.chunk)
    if j.jax_spec() is None:
        assert t.jax_spec() is None
    else:
        assert (t.jax_spec().bits, t.jax_spec().stochastic) == \
            (j.jax_spec().bits, j.jax_spec().stochastic)
    assert t.nbytes(6) == j.nbytes(6)


def test_codec_validation():
    for bad in ("int2", "fp8"):
        with pytest.raises(ValueError):
            TQ.make_codec(bad)
    with pytest.raises(ValueError):
        TQ.IntCodec(bits=3)
    with pytest.raises(ValueError):
        TQ.IntCodec(bits=8, chunk=0)
    ident = TQ.IdentityCodec()
    x = np.array([1.5, -0.0, 3e-40], np.float32)
    assert np.array_equal(_bits(ident.decode(ident.encode(x))), _bits(x))
    assert ident.encode(x).nbytes == 12
