"""The precision claim of the flash kernels' 3xTF32 split
(``src/repro_torch/kernels/csrc/flash_attn.cu``, ``flash_attn_bwd.cu``),
checked without a card.

The kernels run every product on the tensor cores as TF32 (10 mantissa
bits) with f32 accumulation, splitting each f32 operand as ``hi =
cvt.rna.tf32(x)``, ``lo = cvt.rna.tf32(x - hi)`` and taking ``lo*hi + hi*lo
+ hi*hi`` (3xTF32).  Here numpy emulates that: ``cvt.rna`` rounds to nearest
with ties away from zero on the low 13 mantissa bits, a product of two TF32
values is exact in f32, and each ``mma.sync`` k-step of 8 adds its exact
partial sum into an f32 accumulator.  Against the float64 product of the same
f32 inputs, the 3-term split stays within 2e-6 of max|exact| on the kernels'
tile shapes, where one TF32 pass misses by more than the 1e-4 the kernels
are held to on the card.  The forward's whole tile path (the online softmax
over several key tiles, p split once, O rescaled and summed in f32) keeps
that accuracy on O and the logsumexp.
"""
import numpy as np
import pytest

K_STEP = 8  # the depth of one mma.sync.m16n8k8


def tf32_rna(x):
    """``cvt.rna.tf32.f32``: nearest, ties away from zero, 13 low bits 0."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)  # x - hi is exact in f32


def mma_f32(terms, m, n, k):
    """sum over ``terms`` of a @ b, accumulated as the tensor cores do: per
    k-step of 8 the exact partial sum of each term goes into an f32
    accumulator, small terms first."""
    d = np.zeros((m, n), np.float32)
    for k0 in range(0, k, K_STEP):
        for a, b in terms:
            part = a[:, k0:k0 + K_STEP].astype(np.float64) \
                @ b[k0:k0 + K_STEP].astype(np.float64)
            d = (d.astype(np.float64) + part).astype(np.float32)
    return d


def three_pass(a, b):
    (ah, al), (bh, bl) = split(a), split(b)
    return mma_f32([(al, bh), (ah, bl), (ah, bh)], a.shape[0], b.shape[1],
                   a.shape[1])


def one_pass(a, b):
    return mma_f32([(tf32_rna(a), tf32_rna(b))], a.shape[0], b.shape[1],
                   a.shape[1])


def rel_err(got, a, b):
    exact = a.astype(np.float64) @ b.astype(np.float64)
    return float(np.abs(got - exact).max() / np.abs(exact).max())


# (m, n, k): a dQ/dK/dV tile at head_dim 64 and an s tile at head_dim 256
SHAPES = [(64, 64, 64), (32, 32, 256)]


@pytest.mark.parametrize("m,n,k", SHAPES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_three_tf32_passes_reach_f32_accuracy(m, n, k, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    assert rel_err(three_pass(a, b), a, b) <= 2e-6
    assert rel_err(one_pass(a, b), a, b) > 1e-4


def test_rna_rounds_ties_away_and_keeps_ten_bits():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # a TF32 ulp at 1
    x = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                  one + 3 * ulp / 4, 3.0], np.float32)
    want = np.array([one + ulp, -(one + ulp), one, one + ulp, 3.0],
                    np.float32)
    np.testing.assert_array_equal(tf32_rna(x), want)
    hi, lo = split(np.float32(np.pi))
    assert hi.view(np.uint32) & 0x1FFF == 0 and lo.view(np.uint32) & 0x1FFF \
        == 0
    assert abs(float(hi) + float(lo) - float(np.float32(np.pi))) \
        <= 2.0 ** -21 * np.pi


def test_bf16_operand_is_exact_in_tf32():
    """A bf16 value widened to f32 has 7 stored mantissa bits, so hi is the
    value and lo is 0: the kernels skip the lo passes of a bf16 operand,
    and a product of two bf16 operands takes one pass at the same
    accuracy."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, 64)).astype(np.float32)
    bf = (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    hi, lo = split(bf)
    np.testing.assert_array_equal(hi, bf)
    assert not lo.any()
    y = (rng.normal(size=(64, 64)).astype(np.float32).view(np.uint32)
         & np.uint32(0xFFFF0000)).view(np.float32)
    assert rel_err(one_pass(bf, y), bf, y) <= 2e-6


# ------------------------------------------------------------- the forward --
def flash_forward(q, k, v, bk, product):
    """One query tile of the forward kernel (``flash_attn.cu``) as it runs:
    q [R, dh] against all keys of k, v [S, dh] (every pair live), key tile
    by key tile of ``bk``: s = q k^T by ``product`` (the tensor cores), the
    scale, the running max m and normalizer l and the rescale alpha in f32,
    p = exp(s - m) in f32 (split once: ``product`` splits it), the tile's p
    v by ``product``, and O = O * alpha + that tile in one f32 fma.
    Returns (O, lse) in f32."""
    R, dh = q.shape
    scale = np.float32(dh ** -0.5)
    m = np.full(R, -1e30, np.float32)
    l = np.zeros(R, np.float32)
    acc = np.zeros((R, dh), np.float32)
    for k0 in range(0, k.shape[0], bk):
        s = product(q, np.ascontiguousarray(k[k0:k0 + bk].T)) * scale
        m_new = np.maximum(m, s.max(axis=1))
        alpha = np.exp(m - m_new)
        p = np.exp(s - m_new[:, None])
        l = l * alpha + p.sum(axis=1, dtype=np.float32)
        part = product(p, v[k0:k0 + bk])
        acc = (acc.astype(np.float64) * alpha[:, None] + part).astype(
            np.float32)  # fmaf: one rounding (the product is exact in f64)
        m = m_new
    return acc / l[:, None], m + np.log(l)


def attention_f64(q, k, v):
    s = q.astype(np.float64) @ k.astype(np.float64).T * q.shape[1] ** -0.5
    m = s.max(axis=1, keepdims=True)
    p = np.exp(s - m)
    l = p.sum(axis=1, keepdims=True)
    return p @ v.astype(np.float64) / l, (m + np.log(l))[:, 0]


# (R rows, S keys, dh, key tile): the slice's query tile (64 rows against
# 512 keys, 16 tiles of 32) and Gemma-2's head_dim 256 (tiles of 16)
FWD_SHAPES = [(64, 512, 64, 32), (64, 128, 256, 16)]


@pytest.mark.parametrize("R,S,dh,bk", FWD_SHAPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_forward_tile_path_keeps_f32_accuracy(R, S, dh, bk, seed,
                                              record_property):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(n, dh)).astype(np.float32)
               for n in (R, S, S))
    o64, lse64 = attention_f64(q, k, v)

    def errs(product):
        o, lse = flash_forward(q, k, v, bk, product)
        return (float(np.abs(o - o64).max() / np.abs(o64).max()),
                float(np.abs(lse - lse64).max() / np.abs(lse64).max()))

    three, one = errs(three_pass), errs(one_pass)
    record_property("three_pass_rel_err", three)
    record_property("one_pass_rel_err", one)
    assert max(three) <= 2e-6
    # the one-pass control (flash_attention_fwd_probe's) is far off
    assert min(one) > 10 * max(three)
