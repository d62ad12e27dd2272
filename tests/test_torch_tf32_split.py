"""The precision claim of the flash backward kernels
(``src/repro_torch/kernels/csrc/flash_attn_bwd.cu``), checked without a card.

The kernels run every product on the tensor cores as TF32 (10 mantissa
bits) with f32 accumulation, splitting each f32 operand as ``hi =
cvt.rna.tf32(x)``, ``lo = cvt.rna.tf32(x - hi)`` and taking ``lo*hi + hi*lo
+ hi*hi`` (3xTF32).  Here numpy emulates that: ``cvt.rna`` rounds to nearest
with ties away from zero on the low 13 mantissa bits, a product of two TF32
values is exact in f32, and each ``mma.sync`` k-step of 8 adds its exact
partial sum into an f32 accumulator.  Against the float64 product of the same
f32 inputs, the 3-term split stays within 2e-6 of max|exact| on the kernels'
tile shapes, where one TF32 pass misses by more than the 1e-4 the kernels
are held to on the card.
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
