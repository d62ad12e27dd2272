"""Mixture-of-Experts FFN (``repro.models.moe``).

:func:`moe_dense_ref` is the JAX package's capacity-based one-hot dispatch
(Switch-style): each (token, slot) pair takes the next free position of its
expert's buffer, token-major, and a pair past the expert's capacity is
dropped.  It returns ``(y, aux_loss)``, aux being the standard load-balance
loss.  It is the port's only route, so the JAX package's ``moe_ffn``
dispatcher has no counterpart: its other route, the expert-parallel
``moe_sharded`` (experts sharded over a mesh axis), comes with the port's
multi-GPU work.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig


def _act(h, act: str):
    return F.silu(h) if act == "silu" else F.gelu(h, approximate="tanh")


def _router(x2d, router_w):
    """x2d: [T, D] -> probs [T, E] (f32)."""
    return torch.softmax(x2d.float() @ router_w.float(), dim=-1)


def _top_k(probs, k: int):
    """``jax.lax.top_k``: the k largest of each row, larger first, and of
    equal values the lower index first."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx, n: int):
    """f32 one-hot of integer-valued ``idx`` (int or float); indices outside
    [0, n) give a zero row, as ``jax.nn.one_hot``."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _aux_loss(probs, topk_idx, n_experts: int):
    """Switch-style load-balance loss: E * sum_e f_e * P_e."""
    T = probs.shape[0]
    onehot = _one_hot(topk_idx, n_experts)                     # [T,k,E]
    f = onehot.sum(dim=(0, 1)) / (T * topk_idx.shape[1])
    P = probs.mean(dim=0)
    return n_experts * torch.sum(f * P)


def _positions(oh):
    """Exclusive capacity position of every (token, slot) pair in its
    expert's buffer, token-major along dim -2: oh [..., M, E] -> [..., M]."""
    pos = torch.cumsum(oh, dim=-2) - oh
    return torch.sum(pos * oh, dim=-1)


def _expert_ffn(xg, w1, w2, w3, act):
    """xg: [..., E, C, D]; w1/w3: [E, D, F]; w2: [E, F, D]."""
    h = _act(torch.einsum("...ecd,edf->...ecf", xg, w1), act)
    if w3 is not None:
        h = h * torch.einsum("...ecd,edf->...ecf", xg, w3)
    return torch.einsum("...ecf,efd->...ecd", h, w2)


def _shared_expert(x2d, p, act):
    h = _act(x2d @ p["sw1"], act)
    if "sw3" in p:
        h = h * (x2d @ p["sw3"])
    return h @ p["sw2"]


def moe_dense_ref(x, p, mcfg: MoEConfig, act: str = "silu", valid=None):
    """x: [B, S, D] -> (y, aux).  One-hot capacity dispatch (oracle).

    ``valid``: [B] or [B, S] bool token mask (right-padded serving
    batches / inactive continuous-batching slots).  With a mask, dispatch
    runs **per row**: each row gets its own capacity cumsum, its own
    capacity threshold derived from its own valid-token count, and its own
    expert buffers, so a padded batched row routes as that row alone at its
    exact length.  ``None`` keeps the batch-global dispatch (training)."""
    B, S, D = x.shape
    E, k = mcfg.n_experts, mcfg.top_k
    cf = mcfg.capacity_factor
    x2d = x.reshape(B * S, D)
    T = B * S
    probs = _router(x2d, p["router"])
    gate, idx = _top_k(probs, k)                               # [T,k]
    gate = gate / (gate.sum(-1, keepdim=True) + 1e-9)
    aux = _aux_loss(probs, idx, E)
    onehot = _one_hot(idx, E)                                  # [T,k,E]

    if valid is None:
        C = max(1, math.ceil(T * k / E * cf))
        pos = _positions(onehot.reshape(T * k, E)).reshape(T, k)
        keep = pos < C
        pos_oh = _one_hot(pos, C) * keep[..., None]
        disp = torch.einsum("tke,tkc->tec", onehot, pos_oh)
        xg = torch.einsum("tec,td->ecd", disp, x2d.float()).to(x.dtype)
        yg = _expert_ffn(xg, p["w1"], p["w2"], p.get("w3"), act)
        comb = torch.einsum("tke,tkc,tk->tec", onehot, pos_oh, gate)
        y = torch.einsum("tec,ecd->td", comb, yg.float()).to(x.dtype)
        y = y.reshape(B, S, D)
    else:
        v = valid.reshape(B, -1).expand(B, S)
        oh = onehot.reshape(B, S, k, E) * v.float()[..., None, None]
        # per-row exclusive capacity positions (token-major within the row)
        pos = _positions(oh.reshape(B, S * k, E)).reshape(B, S, k)
        # per-row capacity from the row's own valid length (the global
        # formula at T = row length); the static buffer capacity bounds it
        Ls = v.sum(dim=1)                                      # [B]
        C_row = torch.clamp_min(torch.ceil(Ls * k / E * cf), 1).to(
            torch.int32)
        C = max(1, math.ceil(S * k / E * cf))
        keep = pos < C_row[:, None, None]
        pos_oh = _one_hot(pos, C) * keep[..., None]
        disp = torch.einsum("bske,bskc->bsec", oh, pos_oh)
        xg = torch.einsum("bsec,bsd->becd", disp, x.float()).to(x.dtype)
        yg = _expert_ffn(xg, p["w1"], p["w2"], p.get("w3"), act)
        comb = torch.einsum("bske,bskc,bsk->bsec", oh, pos_oh,
                            gate.reshape(B, S, k))
        y = torch.einsum("bsec,becd->bsd", comb, yg.float()).to(x.dtype)
    if "sw1" in p:
        y = y + _shared_expert(x2d, p, act).reshape(B, S, D)
    return y, aux
