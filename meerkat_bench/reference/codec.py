"""The int8 uplink codec, frozen: power-of-two scales per scalar, the
client's stochastic rounding in the loop, and the server's nearest
re-encode.  Written from the codec's definition (a ``bits``-bit signed
grid, ``qmax = 2^(bits-1) - 1``, ``e`` the least integer with
``qmax * 2^e >= |x|``), not imported from the program.
"""
from __future__ import annotations

import numpy as np
import torch

from meerkat_bench.reference import prng

QMAX = {4: 7, 8: 127}
E_MIN, E_MAX = -127, 127
# the salt folded into a step key for its rounding draw
QUANT_FOLD = 0x51AD


def _exponent(amax: torch.Tensor, bits: int) -> torch.Tensor:
    """Least ``e`` with ``qmax * 2^e >= amax`` (int64), clipped."""
    qmax = float(QMAX[bits])
    _, e_frexp = torch.frexp(amax)
    e0 = e_frexp.to(torch.int64) - (bits - 1)
    cover = torch.ldexp(torch.full_like(amax, qmax), e0.float()) >= amax
    return torch.clamp(torch.where(cover, e0, e0 + 1), E_MIN, E_MAX)


def roundtrip(g: torch.Tensor, step_key, bits: int = 8):
    """The value a client applies and uploads: ``g`` rounded
    stochastically to its grid under ``fold_in(step_key, QUANT_FOLD)``.
    Returns (value, margin, grid step): the margin is how far the draw lay
    from the rounding threshold, in grid steps (a tiny margin is where
    rounding noise in ``g`` can pick the other neighbour)."""
    g = g.float().reshape(-1)
    e = _exponent(g.abs(), bits).double()
    q = g.double() * torch.pow(2.0, -e)          # exact: a power of two
    lo = torch.floor(q)
    u = prng.uniform(prng.fold_in(step_key, QUANT_FOLD), q.numel(),
                     device=g.device).double()
    qr = torch.clamp(lo + (u < (q - lo)).double(), -QMAX[bits], QMAX[bits])
    step = torch.pow(2.0, e)
    return (qr * step).float(), (u - (q - lo)).abs(), step


def wire_nearest(g: np.ndarray, bits: int = 8) -> np.ndarray:
    """The server's decode of a nearest re-encode of ``g`` (host)."""
    g = np.asarray(g, np.float32).reshape(-1)
    _, ef = np.frexp(g.astype(np.float64))
    e0 = ef.astype(np.int64) - (bits - 1)
    e = np.where(np.ldexp(float(QMAX[bits]), e0) >= np.abs(g), e0, e0 + 1)
    e = np.clip(e, E_MIN, E_MAX)
    q = np.clip(np.rint(np.ldexp(g.astype(np.float64), -e)), -QMAX[bits],
                QMAX[bits])
    return np.ldexp(q, e).astype(np.float32)
