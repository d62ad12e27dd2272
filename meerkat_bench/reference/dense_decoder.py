"""Plain float32 reference of a dense decoder-only transformer: Qwen2
(full RoPE, QKV bias, tied embeddings) and ChatGLM3 (RoPE on half of each
head, two KV groups, QKV bias, an untied head).

Plain ``torch`` operations only, with TF32 off; no kernel, cache or batching
of the program.  The weights are the dict that ``meerkat_bench.weights``
makes from the seed, its layer leaves stacked over the layers.

Departures from the published models, the same in the program: RMSNorm
multiplies by ``1 + scale`` (the published ones by ``scale``; a
reparameterisation), and the rotated half of a ChatGLM3 head pairs dim i
with dim i + rot/2 (the published model pairs neighbours; a fixed
permutation of q's and k's rotated dims, which the scores do not see).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _rms(x, scale, eps):
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def _rope(x, positions, theta, partial):
    """x [B, S, heads, hd]: the first ``partial * hd`` dims (even) rotated,
    rotate-half pairing, the rest passed through."""
    hd = x.shape[-1]
    rot = int(hd * partial)
    rot -= rot % 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                        device=x.device) / rot))
    ang = positions.float()[:, None] * inv[None, :]          # [S, rot/2]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :rot // 2], x[..., rot // 2:rot]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin,
                      x[..., rot:]], dim=-1)


def _layer(x, w, i, m, positions):
    B, S, D = x.shape
    H, KV = m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or D // H
    p = w["stack"]["p0"]
    h = _rms(x, p["norm"]["scale"][i], m["norm_eps"])
    q = h @ p["wq"][i]
    k = h @ p["wk"][i]
    v = h @ p["wv"][i]
    if m.get("qkv_bias"):
        q, k, v = q + p["bq"][i], k + p["bk"][i], v + p["bv"][i]
    q = q.view(B, S, H, hd)
    k = k.view(B, S, KV, hd)
    v = v.view(B, S, KV, hd)
    if m.get("rope_style", "full") != "none":
        part = m.get("rope_partial_factor", 0.5) \
            if m.get("rope_style") == "partial" else 1.0
        theta = m.get("rope_theta", 10_000.0)
        q, k = _rope(q, positions, theta, part), _rope(k, positions, theta,
                                                       part)
    G = H // KV
    k = k.repeat_interleave(G, dim=2)                  # head h uses kv h // G
    v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    x = x + o.reshape(B, S, H * hd) @ p["wo"][i]
    h = _rms(x, p["norm2"]["scale"][i], m["norm_eps"])
    return x + (F.silu(h @ p["w1"][i]) * (h @ p["w3"][i])) @ p["w2"][i]


def hidden(w, m, tokens):
    """The final-normed hidden states [B, S, D] of int ``tokens`` [B, S]."""
    tokens = torch.as_tensor(tokens, device=w["embed"].device).long()
    x = w["embed"][tokens].float()
    positions = torch.arange(tokens.shape[1], device=x.device)
    for i in range(m["n_layers"]):
        x = _layer(x, w, i, m, positions)
    return _rms(x, w["final_norm"]["scale"], m["norm_eps"])


def head(w, m, cols=None):
    """The unembedding [D, V] (or its columns ``cols``, a slice)."""
    hw = w["embed"].T if m.get("tie_embeddings") else w["lm_head"]
    return hw if cols is None else hw[:, cols]


def lm_loss(w, m, tokens):
    """Next-token cross-entropy over every position (mean per example, then
    over the batch): the loss of the pre-training batches."""
    tokens = torch.as_tensor(tokens, device=w["embed"].device).long()
    lg = hidden(w, m, tokens) @ head(w, m)
    lp = torch.log_softmax(lg[:, :-1].float(), dim=-1)
    nll = -lp.gather(-1, tokens[:, 1:, None])[..., 0]
    return nll.mean(-1).mean()


def task_loss(w, m, batch, n_classes: int):
    """The classification loss: cross-entropy over the verbalizer columns
    ``0..n_classes-1`` at the last (SEP) position, mean over the batch."""
    x = hidden(w, m, batch["tokens"])[:, -1]
    lg = x @ head(w, m, slice(0, n_classes))
    label = torch.as_tensor(batch["label"], device=lg.device).long()
    lp = torch.log_softmax(lg, dim=-1)
    return -lp.gather(1, label[:, None])[:, 0].mean()


def served_logits(w, m, tokens, start: int, block: int = 1024):
    """Logits [len - start, V] at positions ``start..len-1`` of one
    sequence ``tokens`` [len], the head applied ``block`` rows at a time."""
    x = hidden(w, m, torch.as_tensor(tokens)[None])[0, start:]
    hw = head(w, m)
    return torch.cat([x[i:i + block] @ hw for i in range(0, x.shape[0],
                                                           block)])
