"""xLSTM blocks: the parallel mLSTM and the recurrent sLSTM
(``repro.models.xlstm``).

The mLSTM's matrix-memory recurrence has an attention-like parallel form,
h_t = (sum_s w_ts (q_t . k_s) v_s) / n_t with decay weights
w_ts = exp(G_s - M_t), G_s = log i_s - F_s, F the cumulative log forget
gate and M_t the running max of G that stabilises it: plain matmuls,
optionally tiled over query blocks (``mlstm_forward``'s ``block``).
The sLSTM's scalar-memory recurrence (exponential gating with a normaliser)
is not associative, so it runs as a Python loop over time with the input
projections hoisted out of it.  Neither block reaches a Pallas kernel in the
JAX package, so both are plain torch here.

Prefill takes ``valid`` ([B, S] bool, right-padded rows) and
``return_state``; the one-token ``mlstm_decode`` and ``slstm_decode`` carry
the states on (``models/decode.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import XLSTMConfig
from repro_torch.models.layers import split_heads
from repro_torch.utils.tree import is_dtensor
from repro_torch.models.ssm import softplus


def log_sigmoid(x):
    """``jax.nn.log_sigmoid``: -softplus(-x), with the exact softplus."""
    return -softplus(-x)


# ------------------------------------------------------------------ mLSTM --
def _cummax(G):
    """Running max over dim 1.  DTensor has no rule for ``cummax``: a
    DTensor's is taken on the whole tensor ([B, S, H], small), replicated."""
    if not is_dtensor(G):
        return torch.cummax(G, dim=1).values
    from torch.distributed.tensor import DTensor, Replicate
    mesh = G.device_mesh
    return DTensor.from_local(torch.cummax(G.full_tensor(), dim=1).values,
                              mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _mlstm_parallel(q, k, v, logi, logf, block: int = 0):
    """q, k, v: [B,S,H,dh]; logi, logf: [B,S,H] f32.  Returns [B,S,H,dh]
    in v's dtype.  ``block`` (dividing S) tiles the queries: the same
    function, one [B, H, block, S] weight tile at a time."""
    B, S, H, dh = q.shape
    Fc = torch.cumsum(logf, dim=1)                  # [B,S,H]
    G = logi - Fc                                   # log i_s - F_s
    M = _cummax(G)                                  # running max
    qf = q.float() * dh ** -0.5
    kf, vf = k.float(), v.float()
    Gt = G.transpose(1, 2)[:, :, None, :]           # [B,H,1,S]
    ki = torch.arange(S, device=q.device)[None, :]

    def blk(qb, Mb, offset):
        s = torch.einsum("bqhd,bshd->bhqs", qb, kf)
        logw = Gt - Mb.transpose(1, 2)[..., None]   # [B,H,q,S]
        qi = torch.arange(qb.shape[1], device=q.device)[:, None] + offset
        w = torch.where((ki <= qi)[None, None], torch.exp(logw), 0.0)
        sw = s * w
        num = torch.einsum("bhqs,bshd->bqhd", sw, vf)
        den = torch.clamp_min(sw.sum(-1).abs(), 1.0).transpose(1, 2)[..., None]
        return num / den

    if not block or block >= S:
        return blk(qf, M, 0).to(v.dtype)
    if S % block:
        raise ValueError(f"mLSTM block {block} does not divide S = {S}")
    out = [blk(qf[:, o:o + block], M[:, o:o + block], o)
           for o in range(0, S, block)]
    return torch.cat(out, dim=1).to(v.dtype)


def _mlstm_qkv(x, p, H):
    """(xi's q, k, v [B,S,H,dh], the f32 gate input xi, the gate z)."""
    B, S, _ = x.shape
    xi, z = torch.chunk(x @ p["up_proj"], 2, dim=-1)     # [B,S,E] each
    dh = xi.shape[-1] // H
    q, k, v = (split_heads(xi @ p[w], B, S, H, dh)
               for w in ("wq", "wk", "wv"))
    return q, k, v, xi.float(), z


def _group_norm(h, scale, dtype):
    """Per-head normalisation over dh (population variance, eps 1e-6)."""
    hf = h.float()
    mu = hf.mean(-1, keepdim=True)
    var = hf.var(-1, keepdim=True, unbiased=False)
    return ((hf - mu) * torch.rsqrt(var + 1e-6) * scale).to(dtype)


def mlstm_forward(x, p, xcfg: XLSTMConfig, *, block: int = 0,
                  return_state: bool = False, valid=None, ctx=None):
    """mLSTM block. x: [B,S,D] -> [B,S,D]; with ``return_state`` also the
    final (C [B,H,dh,dh], n [B,H,dh], m [B,H]), all f32.

    ``block``: the parallel form's query block (0: the whole sequence);
    when it is 0, ``ctx.mlstm_block`` sets it (``ModelCtx``), as the JAX
    package's model code passes ``ShardCtx.mlstm_block``.

    ``valid``: [B,S] bool for right-padded prefill.  Invalid steps get
    input gate 0 (logi = -1e30) and forget gate 1 (logf = 0), so they add
    nothing to the matrix memory, and the final state equals the state
    after the last valid token."""
    B, S, D = x.shape
    H = xcfg.n_heads
    if not block and ctx is not None:
        block = ctx.mlstm_block
    q, k, v, xf, z = _mlstm_qkv(x, p, H)
    E = xf.shape[-1]
    dh = E // H
    logi = xf @ p["w_i"] + p["b_i"]
    logf = log_sigmoid(xf @ p["w_f"] + p["b_f"])
    if valid is not None:
        logi = torch.where(valid[..., None], logi, -1e30)
        logf = torch.where(valid[..., None], logf, 0.0)
    h = _mlstm_parallel(q, k, v, logi, logf, block=block)
    h = _group_norm(h, p["gn_scale"], x.dtype)
    h = h.reshape(B, S, E) * F.silu(z)
    out = h @ p["down_proj"]
    if not return_state:
        return out
    Fc = torch.cumsum(logf, dim=1)
    G = logi - Fc
    M_S = G.amax(dim=1)                                   # [B,H]
    w = torch.exp(G - M_S[:, None])                       # [B,S,H]
    kf = k.float() * dh ** -0.5
    C = torch.einsum("bsh,bshd,bshe->bhde", w, kf, v.float())
    n = torch.einsum("bsh,bshd->bhd", w, kf)
    m = Fc[:, -1] + M_S
    return out, (C, n, m)


def mlstm_decode(x1, p, xcfg: XLSTMConfig, C, n, m):
    """One-token mLSTM. x1: [B,1,D]; C: [B,H,dh,dh]; n: [B,H,dh]; m: [B,H].
    Returns (out [B,1,D], C, n, m), the states new tensors."""
    B = x1.shape[0]
    H = xcfg.n_heads
    q, k, v, xf, z = _mlstm_qkv(x1, p, H)
    E = xf.shape[-1]
    dh = E // H
    q, k, v = (split_heads(t, B, H, dh) for t in (q, k, v))
    logi = xf[:, 0] @ p["w_i"] + p["b_i"]
    logf = log_sigmoid(xf[:, 0] @ p["w_f"] + p["b_f"])
    m_new = torch.maximum(logf + m, logi)
    fs = torch.exp(logf + m - m_new)[..., None]
    is_ = torch.exp(logi - m_new)[..., None]
    kf = k.float() * dh ** -0.5
    C_new = fs[..., None] * C + is_[..., None] * (
        kf[..., :, None] * v.float()[..., None, :])
    n_new = fs * n + is_ * kf
    qf = q.float()
    num = torch.einsum("bhde,bhd->bhe", C_new, qf)
    den = torch.clamp_min(torch.einsum("bhd,bhd->bh", n_new, qf).abs(), 1.0)
    h = _group_norm(num / den[..., None], p["gn_scale"], x1.dtype)
    h = h.reshape(B, 1, E) * F.silu(z)
    return h @ p["down_proj"], C_new, n_new, m_new


# ------------------------------------------------------------------ sLSTM --
def _slstm_cell(carry, gates_x, R, heads: int):
    """One sLSTM step. carry: (c, n, h, m) each [B,E]; gates_x: [B,4E]
    (W x + b), gate-major (i, f, z, o); R: [H, dh, 4, dh] block-diagonal
    recurrence."""
    c, n, h, m = carry
    B, E = c.shape
    dh = E // heads
    rec = torch.einsum("bhd,hdgf->bghf", split_heads(h, B, heads, dh),
                       R.to(h.dtype))
    gi, gf, gz, go = torch.chunk(gates_x + rec.reshape(B, 4 * E), 4, dim=-1)
    m_new = torch.maximum(gf + m, gi)
    i = torch.exp(gi - m_new)
    f = torch.exp(gf + m - m_new)
    c_new = f * c + i * torch.tanh(gz)
    n_new = f * n + i
    h_new = torch.sigmoid(go) * c_new / torch.clamp_min(n_new, 1e-6)
    return c_new, n_new, h_new, m_new


def _slstm_out(h, p, dtype):
    """The gated up/down projection (proj factor 4/3) of the cell output."""
    u1, u2 = torch.chunk(h.to(dtype) @ p["up_proj"], 2, dim=-1)
    return (F.silu(u1) * u2) @ p["down_proj"]


def slstm_forward(x, p, xcfg: XLSTMConfig, *, return_state: bool = False,
                  valid=None):
    """sLSTM block. x: [B,S,D] -> [B,S,D]; with ``return_state`` also the
    final (c, n, h, m), each [B,E] f32.

    ``valid``: [B,S] bool for right-padded prefill; invalid steps carry
    the previous state through unchanged."""
    B, S, D = x.shape
    E = p["w_gates"].shape[1] // 4
    gates_x = (x @ p["w_gates"]).float() + p["b_gates"]   # [B,S,4E]
    R = p["r_gates"]
    mesh = None
    if is_dtensor(gates_x):
        # tensor-parallel: the S serial steps run on whole local tensors,
        # one op a step and not one DTensor dispatch (the gates and the
        # block-diagonal recurrence are small next to the projections)
        mesh = gates_x.device_mesh
        gates_x = gates_x.full_tensor()
        R = R.full_tensor() if is_dtensor(R) else R
    state = tuple(torch.zeros((B, E), dtype=torch.float32,
                              device=gates_x.device) for _ in range(4))
    hs = []
    for t in range(S):
        new = _slstm_cell(state, gates_x[:, t], R, xcfg.n_heads)
        if valid is not None:
            vt = valid[:, t, None]
            new = tuple(torch.where(vt, a, b) for a, b in zip(new, state))
        state = new
        hs.append(state[2])
    h = torch.stack(hs, dim=1)
    if mesh is not None:
        from torch.distributed.tensor import DTensor, Replicate
        rep = [Replicate()] * mesh.ndim
        h = DTensor.from_local(h, mesh, rep, run_check=False)
        state = tuple(DTensor.from_local(t, mesh, rep, run_check=False)
                      for t in state)
    out = _slstm_out(h, p, x.dtype)
    if return_state:
        return out, state
    return out


def slstm_decode(x1, p, xcfg: XLSTMConfig, c, n, h, m):
    """One-token sLSTM. x1: [B,1,D]; states [B,E] each.  Returns (out
    [B,1,D], c, n, h, m)."""
    gates_x = (x1 @ p["w_gates"])[:, 0].float() + p["b_gates"]
    c, n, h, m = _slstm_cell((c, n, h, m), gates_x, p["r_gates"],
                             xcfg.n_heads)
    return _slstm_out(h, p, x1.dtype)[:, None], c, n, h, m
