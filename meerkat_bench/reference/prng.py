"""Threefry-2x32 seed ladder and Gaussian draws: a frozen copy of the
port's ``core/prng.py`` (key, fold_in, split, uniform, normal), so that
the reference derives each step's perturbation z itself, and a later
change to the program cannot move the yardstick.

A key is an int64 tensor ``[2]`` of two uint32 words.  ``normal`` is a
uniform on ``(nextafter(-1, 0), 1)`` through ``sqrt(2) * erfinv``, with
XLA's erfinv polynomial, each Horner step a fused multiply-add formed from
error-free products and sums.
"""
from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 block (20 rounds) of counters (x0, x1) under key
    (k0, k1); every operand an int64 tensor (or int) holding uint32 words.
    Returns the two output words."""
    k0 = torch.as_tensor(k0, dtype=torch.int64)
    k1 = torch.as_tensor(k1, dtype=torch.int64)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def key(seed: int) -> torch.Tensor:
    """``jax.random.key(seed)`` for a 32-bit seed: the words [0, seed]."""
    seed = int(seed)
    if not -2**31 <= seed < 2**32:
        raise OverflowError(f"seed {seed} does not fit 32 bits")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64)


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: hash the counter [0, data] under ``k``."""
    y0, y1 = threefry2x32(k[0], k[1], torch.tensor(0, dtype=torch.int64),
                          torch.tensor(int(data) & _MASK, dtype=torch.int64))
    return torch.stack([y0, y1])


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable): key i hashes the counter
    [0, i] — the same as ``fold_in(k, i)``.  Returns [num, 2] on k's
    device (a key on the card splits there, without a host sync)."""
    counts = torch.arange(num, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[0], k[1], torch.zeros_like(counts), counts)
    return torch.stack([y0, y1], dim=-1)


def bits32(k: torch.Tensor, n: int, device=None) -> torch.Tensor:
    """``jax.random.bits(k, (n,), uint32)`` as int64 words on ``device``:
    word i is y0 ^ y1 of the counter [hi(i), lo(i)] hashed under ``k``."""
    if n >= 2**32:
        raise ValueError("bit streams of 2**32 words or more are not needed")
    lo = torch.arange(n, dtype=torch.int64, device=device)
    # a key derived on the CPU goes to the card without a stream sync
    kd = k.to(device, non_blocking=True)
    y0, y1 = threefry2x32(kd[0], kd[1], torch.zeros_like(lo), lo)
    return y0 ^ y1


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words -> f32 in [0, 1): the top 23 bits become the mantissa
    of a float in [1, 2), minus one (``jax.random._uniform``)."""
    fb = (bits >> 9) | 0x3F800000  # 1.0f's bit pattern
    return fb.to(torch.int32).view(torch.float32) - 1.0


def uniform(k: torch.Tensor, n: int, minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(k, (n,), float32, minval, maxval)``."""
    f = _bits_to_unit(bits32(k, n, device))
    # filled on the device: a scalar tensor copied from the host would sync
    lo = torch.full((), minval, dtype=torch.float32, device=device)
    hi = torch.full((), maxval, dtype=torch.float32, device=device)
    return torch.maximum(lo, f * (hi - lo) + lo)


# XLA's ErfInv32 coefficients (w < 5, then w >= 5), highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _split(a):
    """Veltkamp split of float32 ``a`` into hi + lo, 12 bits each."""
    t = a * 4097.0
    hi = t - (t - a)
    return hi, a - hi


def _fma(a, b, c):
    """a * b + c rounded once, in float32 tensors: Dekker's exact product
    p + e = a * b and Knuth's exact sum s + t = c + p, then s + (t + e).
    The last two roundings leave the exactly rounded result except where
    t + e straddles a rounding boundary of s, which the tests' ulp bound
    against XLA's FMA covers."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = c + p
    bb = s - c
    t = (c - (s - bb)) + (p - bb)
    return s + (t + e)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv by XLA's polynomial (see the module docstring)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for a, b in zip(_ERFINV_LT5, _ERFINV_GE5):
        c = torch.where(lt, a, b)
        p = c if p is None else _fma(p, w, c)
    return torch.where(x.abs() == 1, x * torch.finfo(torch.float32).max,
                       p * x)


# float32's nextafter(-1, 0): the open end of ``normal``'s uniform
_NEXT_ABOVE_MINUS_ONE = -1.0 + 2.0 ** -24


def normal(k: torch.Tensor, n: int, device=None) -> torch.Tensor:
    """``jax.random.normal(k, (n,), float32)``: sqrt(2) * erfinv(u) with u
    uniform on (nextafter(-1, 0), 1) in float32."""
    u = uniform(k, n, _NEXT_ABOVE_MINUS_ONE, 1.0, device)
    return torch.full((), math.sqrt(2), dtype=torch.float32,
                      device=device) * erfinv(u)
