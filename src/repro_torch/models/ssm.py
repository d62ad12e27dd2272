"""Mamba-style selective SSM block, the Jamba mixer (``repro.models.ssm``).

Training and evaluation forwards run through :func:`mamba_forward` on one
of two routes of the same function (``ModelCtx.mamba_mode``, resolved by
:func:`resolve_mamba_mode`):

* ``"kernel"`` — the selective-scan kernel (``kernels.ops.mamba_scan``:
  ``kernels/csrc/mamba_scan.cu`` on the card, its serial plain version on
  the CPU).  Like the JAX package's Pallas kernel it has no backward.
* ``"scan"``   — the JAX package's chunked associative scan: inside chunks
  of ``chunk`` positions the recurrence ``h_t = a_t h_{t-1} + b_t`` runs as
  the same parallel prefix ``jax.lax.associative_scan`` computes
  (:func:`associative_scan`), and a Python loop carries h across chunks.
  Differentiable by autograd; under autograd each chunk is recomputed in the
  backward (``torch.utils.checkpoint``, the counterpart of
  ``ShardCtx.remat``), so the [B, chunk, E, N] pairs of one chunk at a time
  are alive, not those of every chunk and layer.

The dry run (``launch/dryrun.py``) takes a third route, ``"stub"``, the
JAX package's stand-in for the kernel's memory traffic: it reads dt, B, C
and x once and writes y once (``y = dt x sum(B C)``), with a zero final
state.  It is not the selective scan; it is what a per-device count of the
kernel's bytes needs.

Serving prefills through :func:`mamba_forward` with ``return_state`` and
``valid``, and decodes one token at a time through :func:`mamba_decode`,
the recurrence written out in plain torch, as the JAX package computes it
outside any Pallas kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import ops

MAMBA_MODES = ("auto", "kernel", "scan", "stub")


def _dt_rank(cfg_d_model: int, scfg: SSMConfig) -> int:
    return scfg.dt_rank or math.ceil(cfg_d_model / 16)


def softplus(x):
    """``jax.nn.softplus`` (logaddexp(x, 0)): max(x, 0) + log1p(exp(-|x|)),
    exact everywhere; ``F.softplus`` is linear above a threshold instead."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _causal_conv(x, w, b, buf=None):
    """Depthwise causal conv. x: [B,S,E]; w: [K,E]; buf: [B,K-1,E] history."""
    K = w.shape[0]
    if buf is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = buf.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # [B, S+K-1, E]
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K))
    return y + b


def _combine(l, r):
    (al, bl), (ar, br) = l, r
    return al * ar, ar * bl + br


def _interleave(a, b, dim):
    """a's and b's entries alternating along ``dim`` (a first); a holds as
    many as b or one more (``jax.lax.associative_scan``'s ``_interleave``)."""
    n = a.shape[dim] + b.shape[dim]
    if b.shape[dim] < a.shape[dim]:
        b = torch.cat([b, torch.zeros_like(a.narrow(dim, 0, 1))], dim)
    out = torch.stack([a, b], dim + 1).flatten(dim, dim + 1)
    return out.narrow(dim, 0, n)


def associative_scan(elems, dim: int):
    """Inclusive scan of the (a, b) pairs along ``dim`` under
    ``(al, bl) . (ar, br) = (al ar, ar bl + br)``, by the odd/even recursion
    of ``jax.lax.associative_scan``, so every product is taken in its
    order."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(t, start, stop=None, step=1):
        return t[(slice(None),) * dim + (slice(start, stop, step),)]

    reduced = _combine([sl(e, 0, -1, 2) for e in elems],
                       [sl(e, 1, None, 2) for e in elems])
    odd = associative_scan(reduced, dim)
    if n % 2 == 0:
        even = _combine([sl(o, 0, -1) for o in odd],
                        [sl(e, 2, None, 2) for e in elems])
    else:
        even = _combine(odd, [sl(e, 2, None, 2) for e in elems])
    even = [torch.cat([e.narrow(dim, 0, 1), r], dim)
            for e, r in zip(elems, even)]
    return [_interleave(e, o, dim) for e, o in zip(even, odd)]


def _ssm_inner(dt, B_in, C_in, x, A):
    """Prefix products and sums of one chunk. dt, x: [B,L,E]; B_in, C_in:
    [B,L,N]; A: [E,N] -> (aprod, bcum), each [B,L,E,N]."""
    a = torch.exp(dt[..., None] * A)                     # [B,L,E,N]
    b = (dt * x)[..., None] * B_in[:, :, None, :]        # [B,L,E,N]
    return associative_scan((a, b), 1)


def _chunk(h0, dt_i, B_i, C_i, x_i, A):
    """One chunk from state h0 [B,E,N] -> (h_last [B,E,N], y [B,L,E])."""
    aprod, bcum = _ssm_inner(dt_i, B_i, C_i, x_i, A)
    h = aprod * h0[:, None] + bcum                       # [B,L,E,N]
    y = torch.einsum("blen,bln->ble", h, C_i)
    return h[:, -1], y


def resolve_mamba_mode(mode, *, differentiable: bool) -> str:
    """Map a requested route to 'kernel' | 'scan' | 'stub' (ROADMAP C7, the
    port's rule).  "auto" takes the kernel when autograd does not record
    through the layer and the scan when it does; an explicit route is
    honoured, and an explicit "kernel" under autograd then raises in the
    kernel's wrapper, as ``jax.grad`` through the Pallas kernel fails.
    "stub" is the dry run's traffic stand-in (module doc)."""
    mode = mode or "auto"
    if mode not in MAMBA_MODES:
        raise ValueError(f"mamba mode must be one of {MAMBA_MODES}, got "
                         f"{mode!r}")
    if mode != "auto":
        return mode
    return "scan" if differentiable else "kernel"


def mamba_forward(x, p, scfg: SSMConfig, *, chunk: int = 64,
                  return_state: bool = False, mode: str = "auto",
                  valid=None):
    """x: [B,S,D] -> [B,S,D] (training / prefill); with ``return_state``
    also (conv_buf [B,K-1,E], h_last [B,E,N] f32).

    ``valid``: [B,S] bool for right-padded prefill.  Invalid steps zero dt,
    which freezes the recurrence exactly (decay exp(0*A)=1, input dt*x*B=0)
    on both routes: the final state equals the state after the last valid
    token, and the conv history buffer is gathered per row at its own
    length.  ``mode``: auto | kernel | scan | stub (module doc)."""
    B, S, D = x.shape
    E = scfg.expand * D
    N = scfg.d_state
    xz = x @ p["in_proj"]
    xs_raw, z = torch.split(xz, E, dim=-1)
    xs = F.silu(_causal_conv(xs_raw, p["conv_w"], p["conv_b"]))
    dbc = xs @ p["x_proj"]
    r = p["dt_proj"].shape[0]
    dt_r, B_in, C_in = torch.split(dbc, [r, N, N], dim=-1)
    dt = softplus(dt_r @ p["dt_proj"] + p["dt_bias"])
    if valid is not None:
        dt = torch.where(valid[..., None], dt, 0.0)
    lengths = None if valid is None else valid.sum(1).to(torch.int32)
    A = -torch.exp(p["A_log"].float())  # [E,N]
    dt, B_in, C_in, xf = (t.float().contiguous()
                          for t in (dt, B_in, C_in, xs))
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (dt, B_in, C_in, xf, A))

    route = resolve_mamba_mode(mode, differentiable=grad)
    if route == "kernel":
        y, h_fin = ops.mamba_scan(dt, B_in, C_in, xf, A)
        return _finish(y, xs, xs_raw, z, x, p, B, E, h_fin, return_state,
                       lengths=lengths)
    if route == "stub":
        # the kernel's footprint: dt/B/C/x read once, y written once
        y = dt * xf * torch.sum(B_in * C_in, dim=-1, keepdim=True)
        h_fin = torch.zeros((B, E, N), dtype=torch.float32, device=x.device)
        return _finish(y, xs, xs_raw, z, x, p, B, E, h_fin, return_state,
                       lengths=lengths)

    Lc = min(chunk, S)
    n_chunks = math.ceil(S / Lc)
    pad = n_chunks * Lc - S

    def chunks(t):
        if pad:
            t = F.pad(t, (0, 0, 0, pad))
        return t.reshape(B, n_chunks, Lc, t.shape[-1]).unbind(1)

    h = torch.zeros((B, E, N), dtype=torch.float32, device=x.device)
    ys = []
    for inp in zip(*(chunks(t) for t in (dt, B_in, C_in, xf))):
        if grad:
            h, y = checkpoint(_chunk, h, *inp, A, use_reentrant=False)
        else:
            h, y = _chunk(h, *inp, A)
        ys.append(y)
    y = torch.cat(ys, 1)[:, :S]
    return _finish(y, xs, xs_raw, z, x, p, B, E, h, return_state,
                   lengths=lengths)


def _finish(y, xs, xs_raw, z, x, p, B, E, h_fin, return_state, lengths=None):
    """Shared mamba epilogue: skip term, gate, out-projection, state.

    ``lengths``: per-row valid length (right-padded prefill) — the conv
    history buffer then holds each row's last K-1 *valid* inputs."""
    y = y + xs.float() * p["D"]
    y = (y * F.silu(z.float())).to(x.dtype)
    out = y @ p["out_proj"]
    if return_state:
        K = p["conv_w"].shape[0]
        pad = torch.zeros((B, K - 1, E), dtype=xs_raw.dtype,
                          device=xs_raw.device)
        xp = torch.cat([pad, xs_raw], dim=1)  # [B, K-1+S, E]
        if lengths is None:
            conv_buf = xp[:, -(K - 1):]
        else:
            # xp[b, len_b + j] = xs_raw[b, len_b + j - (K-1)], zeros for j
            # reaching before the sequence start
            idx = lengths[:, None].long() + torch.arange(
                K - 1, device=xp.device)[None, :]
            conv_buf = torch.gather(xp, 1, idx[:, :, None].expand(-1, -1, E))
        return out, (conv_buf, h_fin)
    return out


def mamba_decode(x1, p, scfg: SSMConfig, conv_buf, state):
    """One-token decode. x1: [B,1,D]; conv_buf: [B,K-1,E] (the last K-1
    conv inputs); state: [B,E,N] f32.  Returns (out [B,1,D], the shifted
    conv buffer in its dtype, the new state), the buffer and the state new
    tensors."""
    N = scfg.d_state
    xs, z = torch.chunk(x1 @ p["in_proj"], 2, dim=-1)
    new_buf = torch.cat([conv_buf[:, 1:], xs.to(conv_buf.dtype)], dim=1)
    xs = F.silu(_causal_conv(xs, p["conv_w"], p["conv_b"], buf=conv_buf))
    r = p["dt_proj"].shape[0]
    dt_r, B_in, C_in = torch.split(xs @ p["x_proj"], [r, N, N], dim=-1)
    dt = softplus(dt_r @ p["dt_proj"] + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dt[:, 0, :, None].float() * A)              # [B,E,N]
    b = (dt[:, 0] * xs[:, 0]).float()[..., None] \
        * B_in[:, 0, None, :].float()
    h = a * state + b
    y = torch.einsum("ben,bn->be", h, C_in[:, 0].float())
    y = y + xs[:, 0].float() * p["D"]
    y = (y * F.silu(z[:, 0].float())).to(x1.dtype)
    return (y @ p["out_proj"])[:, None], new_buf, h
