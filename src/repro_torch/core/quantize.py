"""Quantized uplink for the ZO projected-gradient scalars
(``repro.core.quantize``).

The fleet-scale uplink compresses each client's [T] (or [T, K]) scalar
upload to ``bits``-bit integer codes plus one shared exponent per chunk.
Scales are **powers of two** chosen per chunk:

    e = min integer with  qmax * 2^e >= max|x|,   qmax = 2^(bits-1) - 1
    code = round(x * 2^-e)  (stochastic or nearest), clipped to [-qmax, qmax]
    x_hat = code * 2^e

Power-of-two scales make every op exact in f32 (``ldexp`` only shifts the
exponent), which buys the two invariants the virtual-path replay needs:

* **Idempotence** — ``decode(encode(x_hat))`` is bit-identical to ``x_hat``
  for any on-grid ``x_hat``, so the server's nearest re-encode of a
  client's applied value reproduces it exactly: the **exact-replay
  invariant** (the virtual path is bit-reconstructible from the wire).
* **Error bound** — the grid step ``2^e`` is at most ``2 * max|x| / qmax``.

Stochastic rounding (``floor(q) + Bernoulli(frac(q))``) keeps the quantizer
unbiased.  The client-side roundtrip draws its Bernoulli noise from the step
key folded with :data:`QUANT_FOLD` (``core/prng.py``, bit-exact with
``jax.random``), a stream disjoint from z sampling, so quantized runs
resume bit-exactly.

The host codec (``encode``/``decode``, :class:`IntCodec`) is numpy and the
same code as the JAX package's.  The in-loop :func:`quantize_roundtrip` is a
torch function on the device the scalars live on (per scalar, chunk=1): the
local T-step loop applies each quantized g_t before computing g_{t+1}.  It
forms ``2^e`` from its bit pattern and multiplies by it, one rounding as in
``ldexp``, and never reads a value back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core import prng

# largest integer code magnitude per bit width (symmetric signed grid)
QMAX = {4: 7, 8: 127}
# f32 exponent clip — keeps every ldexp finite and exact
E_MIN, E_MAX = -127, 127
# salt folded into the per-step/per-direction PRNG key for the rounding
# draw (disjoint from the z-sampling stream derived from the same key)
QUANT_FOLD = 0x51AD


def pow2_exponent(amax: np.ndarray, bits: int) -> np.ndarray:
    """Smallest ``e`` (int32, clipped to [E_MIN, E_MAX]) with
    ``qmax * 2^e >= amax``, computed with exact f32 ops (frexp/ldexp)."""
    qmax = np.float32(QMAX[bits])
    amax = np.asarray(amax, np.float32)
    _, e_frexp = np.frexp(amax)
    e0 = e_frexp.astype(np.int32) - (bits - 1)
    e = np.where(np.ldexp(qmax, e0) >= amax, e0, e0 + 1)
    return np.clip(e, E_MIN, E_MAX).astype(np.int32)


def wire_nbytes(n: int, bits: int, chunk: int = 1) -> int:
    """Serialized size of an n-scalar payload: packed codes (two int4
    codes per byte) + one exponent byte per chunk."""
    return (n * bits + 7) // 8 + math.ceil(n / chunk)


def pack_codes(codes: np.ndarray, bits: int) -> bytes:
    """Serialize int codes: int8 verbatim; int4 as offset nibble pairs."""
    codes = np.asarray(codes, np.int8).ravel()
    if bits == 8:
        return codes.tobytes()
    u = (codes.astype(np.int16) + 8).astype(np.uint8)  # [-7, 7] -> [1, 15]
    if u.size % 2:
        u = np.concatenate([u, np.zeros((1,), np.uint8)])
    return (u[0::2] | (u[1::2] << 4)).tobytes()


def unpack_codes(raw: bytes, bits: int, n: int) -> np.ndarray:
    """Inverse of :func:`pack_codes` — int8 [n] codes."""
    if bits == 8:
        return np.frombuffer(raw, np.int8, count=n).copy()
    b = np.frombuffer(raw, np.uint8)
    u = np.stack([b & 0x0F, b >> 4], axis=1).ravel()[:n]
    return (u.astype(np.int16) - 8).astype(np.int8)


@dataclasses.dataclass(frozen=True)
class Wire:
    """One encoded payload: integer codes + per-chunk pow2 exponents."""
    codes: np.ndarray  # int8 [n], in [-qmax, qmax]
    exps: np.ndarray   # int8 [ceil(n / chunk)]
    shape: tuple
    bits: int
    chunk: int

    @property
    def n(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def nbytes(self) -> int:
        return wire_nbytes(self.n, self.bits, self.chunk)

    def tobytes(self) -> bytes:
        return pack_codes(self.codes, self.bits) + \
            np.asarray(self.exps, np.int8).tobytes()


@dataclasses.dataclass(frozen=True)
class FloatWire:
    """Identity-codec payload: raw f32 scalars (4 bytes each)."""
    values: np.ndarray

    @property
    def nbytes(self) -> int:
        return 4 * self.values.size

    def tobytes(self) -> bytes:
        return np.asarray(self.values, np.float32).tobytes()


def encode(x, bits: int, chunk: int = 1,
           rng: Optional[np.random.Generator] = None) -> Wire:
    """Host-side encode.  ``rng=None`` rounds to nearest (deterministic —
    what the server uses, exact on on-grid inputs); an ``rng`` draws the
    stochastic rounding noise."""
    x = np.asarray(x, np.float32)
    flat = x.ravel()
    n = flat.size
    n_chunks = math.ceil(n / chunk) if n else 0
    pad = n_chunks * chunk - n
    g = np.concatenate([flat, np.zeros((pad,), np.float32)])
    g = g.reshape(n_chunks, chunk)
    amax = np.abs(g).max(axis=1)
    e = pow2_exponent(amax, bits)
    q = np.ldexp(g, -e[:, None])  # exact: |q| <= qmax by choice of e
    if rng is None:
        qr = np.rint(q)
    else:
        lo = np.floor(q)
        qr = lo + (rng.random(q.shape) < (q - lo))
    qr = np.clip(qr, -QMAX[bits], QMAX[bits])
    return Wire(codes=qr.astype(np.int8).ravel()[:n],
                exps=e.astype(np.int8), shape=x.shape, bits=bits,
                chunk=chunk)


def decode(wire: Wire) -> np.ndarray:
    """Exact dequantize: ``code * 2^e`` per chunk, f32 [*wire.shape]."""
    n_chunks = wire.exps.size
    pad = n_chunks * wire.chunk - wire.n
    c = np.concatenate([wire.codes.astype(np.float32),
                        np.zeros((pad,), np.float32)])
    out = np.ldexp(c.reshape(n_chunks, wire.chunk),
                   wire.exps.astype(np.int32)[:, None])
    return out.ravel()[:wire.n].reshape(wire.shape).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """The client-side in-loop quantization recipe."""
    bits: int
    stochastic: bool = True

    def apply(self, g, key):
        """Round the scalars ``g`` (a device tensor) to the wire grid under
        the step or direction ``key`` ([2] words)."""
        return quantize_roundtrip(g, prng.fold_in(key, QUANT_FOLD),
                                  self.bits, self.stochastic)


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """``2^e`` as exact f32 from its bit pattern, for int32 ``e`` in
    [-149, 127] (subnormal below -126)."""
    one = torch.ones_like(e)
    normal = torch.bitwise_left_shift(torch.clamp(e + 127, min=1), 23)
    sub = torch.bitwise_left_shift(one, torch.clamp(e + 149, 0, 22))
    return torch.where(e >= -126, normal, sub).view(torch.float32)


def _ldexp(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """``x * 2^e`` with a single rounding (``np.ldexp``), for int32 ``e``
    in [-149, 127]: the product with an exact power of two."""
    return x * _pow2(e)


def quantize_roundtrip(g, key, bits: int, stochastic: bool = True):
    """Per-scalar quantize + dequantize (chunk=1) on ``g``'s device — the
    value the client *applies* in its local update, and (being on-grid)
    the value the server's nearest re-encode reproduces bit-exactly.  The
    same frexp/ldexp arithmetic as the host codec.  ``key`` is the folded
    rounding key (unused when ``stochastic`` is False)."""
    g = torch.as_tensor(g, dtype=torch.float32)
    qmax = float(QMAX[bits])
    amax = torch.abs(g)
    _, e_frexp = torch.frexp(amax)
    e0 = e_frexp.to(torch.int32) - (bits - 1)
    # below -149, 2^e0 is not an f32; e0 + 1 clips to E_MIN there anyway
    cover = _ldexp(torch.full_like(amax, qmax),
                   torch.clamp(e0, min=-149)) >= amax
    e = torch.clamp(torch.where(cover, e0, e0 + 1), E_MIN, E_MAX)
    q = _ldexp(g, -e)
    if stochastic:
        lo = torch.floor(q)
        u = prng.uniform(key, max(1, q.numel()), device=q.device)
        qr = lo + (u.reshape(q.shape) < (q - lo)).to(torch.float32)
    else:
        qr = torch.round(q)  # half-to-even, matching np.rint
    return _ldexp(torch.clamp(qr, -qmax, qmax), e)


class IdentityCodec:
    """Pass-through codec: raw f32 scalars, 4 bytes each — the dense
    protocol, and the bit-parity baseline for the quantized path."""
    spec = "none"
    bits = 32
    chunk = 1

    def encode(self, x, rng=None) -> FloatWire:
        return FloatWire(values=np.asarray(x, np.float32))

    def decode(self, wire: FloatWire) -> np.ndarray:
        return np.asarray(wire.values, np.float32)

    def nbytes(self, n: int) -> int:
        return 4 * int(n)

    def jax_spec(self) -> None:
        return None  # no in-loop quantization


class IntCodec:
    """Stochastic-rounding int8/int4 codec with per-chunk pow2 scales.
    ``jax_spec`` keeps the JAX package's name: it is the in-loop recipe
    (:class:`QuantSpec`) the server hands the client loop."""

    def __init__(self, bits: int, chunk: int = 1, stochastic: bool = True):
        if bits not in QMAX:
            raise ValueError(f"bits must be one of {sorted(QMAX)}, "
                             f"got {bits}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.bits = int(bits)
        self.chunk = int(chunk)
        self.stochastic = bool(stochastic)

    @property
    def spec(self) -> str:
        return f"int{self.bits}" + ("" if self.stochastic else "-nearest")

    def encode(self, x, rng: Optional[np.random.Generator] = None) -> Wire:
        return encode(x, self.bits, self.chunk, rng)

    def decode(self, wire: Wire) -> np.ndarray:
        return decode(wire)

    def nbytes(self, n: int) -> int:
        return wire_nbytes(int(n), self.bits, self.chunk)

    def jax_spec(self) -> QuantSpec:
        return QuantSpec(bits=self.bits, stochastic=self.stochastic)


def make_codec(spec: str):
    """Codec from a config string: ``none`` | ``int8`` | ``int4`` (+
    ``-nearest`` suffix for deterministic rounding)."""
    if spec in (None, "", "none"):
        return IdentityCodec()
    m = spec.removesuffix("-nearest")
    if m in ("int4", "int8"):
        return IntCodec(bits=int(m[3:]), stochastic=not
                        spec.endswith("-nearest"))
    raise ValueError(
        f"unknown quantize spec {spec!r}: want none|int8|int4"
        f"[-nearest]")
