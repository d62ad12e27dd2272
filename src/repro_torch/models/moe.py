"""Mixture-of-Experts FFN (``repro.models.moe``).

Two implementations, one dispatcher (:func:`moe_ffn`):

* :func:`moe_dense_ref` is the JAX package's capacity-based one-hot
  dispatch (Switch-style): each (token, slot) pair takes the next free
  position of its expert's buffer, token-major, and a pair past the
  expert's capacity is dropped.
* :func:`moe_sharded` is the expert-parallel route of the tensor-parallel
  layout (``ModelCtx.use_sharded_moe``): the experts are sharded over the
  model axis and each rank holds its own tokens (its batch rows),
  replicated over the model axis.  Each rank routes its tokens, keeps the
  (token, slot) pairs of its ``E_loc`` experts with JAX's local capacity
  ``C = ceil(T_loc k / E cf)``, gathers them, runs the grouped expert
  matmuls, scatter-adds the gated results and sums over the model axis
  (JAX's ``psum``); the aux loss is averaged over the batch axes (JAX's
  ``pmean``), and the shared expert's hidden dim is sharded over the model
  axis.

Both return ``(y, aux_loss)``, aux being the standard load-balance loss.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.utils.tree import is_dtensor


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


# ------------------------------------------------------------- sharded -----
def _moe_local(x2d, router_w, w1, w2, w3, shared, *, mcfg: MoEConfig,
               act: str, first: int):
    """One rank's share of :func:`moe_sharded` on plain tensors: x2d [T, D]
    (the rank's tokens), w1/w3 [E_loc, D, F] and w2 [E_loc, F, D] its
    experts ``first .. first + E_loc``, ``shared`` its (sw1, sw2, sw3)
    hidden-dim shard or None.  Returns (routed y [T, D] f32, shared y
    [T, D] f32 or None, aux): the partial sums the model axis adds up."""
    T, D = x2d.shape
    E, k = mcfg.n_experts, mcfg.top_k
    E_loc = w1.shape[0]
    dev = x2d.device
    C = max(1, math.ceil(T * k / E * mcfg.capacity_factor))
    probs = _router(x2d, router_w)
    gate, idx = _top_k(probs, k)                               # [T, k]
    gate = gate / (gate.sum(-1, keepdim=True) + 1e-9)
    aux = _aux_loss(probs, idx, E)
    local = idx - first                      # valid if in [0, E_loc)
    valid = (local >= 0) & (local < E_loc)
    local_c = torch.where(valid, local, 0)
    onehot = _one_hot(local_c, E_loc) * valid[..., None]
    pos = _positions(onehot.reshape(T * k, E_loc)).reshape(T, k)
    keep = valid & (pos < C)
    # the token routed to (local expert e, capacity slot c); dropped pairs
    # go to a dummy expert row E_loc, a free slot to the dummy token T
    tok_ids = torch.arange(T, device=dev)[:, None].expand(T, k)
    e_flat = torch.where(keep, local_c, E_loc).reshape(-1)
    c_flat = torch.where(keep, pos, 0).long().reshape(-1)
    slot_tok = torch.full((E_loc + 1, C), T, dtype=torch.long, device=dev)
    slot_tok[e_flat, c_flat] = tok_ids.reshape(-1)
    slot_gate = torch.zeros((E_loc + 1, C), dtype=torch.float32, device=dev)
    slot_gate[e_flat, c_flat] = gate.reshape(-1)
    slot_tok, slot_gate = slot_tok[:E_loc], slot_gate[:E_loc]
    x_pad = torch.cat([x2d, x2d.new_zeros((1, D))])
    xg = x_pad[slot_tok]                                       # [E_loc,C,D]
    yg = _expert_ffn(xg, w1, w2, w3, act).float() * slot_gate[..., None]
    y = torch.zeros((T + 1, D), dtype=torch.float32, device=dev)
    y = y.index_add_(0, slot_tok.reshape(-1), yg.reshape(-1, D))[:T]
    ys = None
    if shared is not None:
        sw1, sw2, sw3 = shared
        h = _act(x2d @ sw1, act)
        if sw3 is not None:
            h = h * (x2d @ sw3)
        ys = (h @ sw2).float()
    return y, ys, aux


def _local(t, dim=None):
    """The rank's local tensor of a (possibly DTensor) leaf: its shard
    along ``dim`` over the 1-D model sub-mesh, or the whole leaf where
    ``dim`` is None; raises where the leaf is not sharded as asked."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    want = [Replicate()] if dim is None else [Shard(dim)]
    if list(t.placements) != want:
        t = t.redistribute(t.device_mesh, want)
    return t.to_local()


def moe_sharded(x, p, mcfg: MoEConfig, act: str, ctx):
    """Expert-parallel MoE (module doc) under ``ctx``'s mesh.  x: [B,S,D],
    the rank's rows (a plain tensor, or a DTensor replicated on the model
    sub-mesh); the expert stacks [E, ...] and the shared expert's leaves
    are DTensors on the model sub-mesh, the experts sharded on E (which the
    model axis must divide, as JAX's ``shard_map`` requires).  Returns
    (y like x, aux)."""
    from torch.distributed import _functional_collectives as funcol
    B, S, D = x.shape
    mesh = ctx.model_mesh
    tp, r = mesh.size(), mesh.get_local_rank()
    if mcfg.n_experts % tp:
        raise ValueError(f"moe_sharded needs the model axis ({tp}) to divide "
                         f"the experts ({mcfg.n_experts})")
    E_loc = mcfg.n_experts // tp
    shared = None
    if "sw1" in p:
        shared = (_local(p["sw1"], 1), _local(p["sw2"], 0),
                  _local(p["sw3"], 1) if "sw3" in p else None)
    x2d = _local(x).reshape(B * S, D)
    y, ys, aux = _moe_local(
        x2d, _local(p["router"]), _local(p["w1"], 0), _local(p["w2"], 0),
        _local(p["w3"], 0) if "w3" in p else None, shared, mcfg=mcfg,
        act=act, first=r * E_loc)
    y = funcol.wait_tensor(funcol.all_reduce(y, "sum", mesh))
    if ys is not None:
        y = y + funcol.wait_tensor(funcol.all_reduce(ys, "sum", mesh))
    for a in ctx.batch_axes:                     # pmean over the batch axes
        aux = funcol.wait_tensor(funcol.all_reduce(aux, "sum", ctx.mesh[a]))
    aux = aux / ctx.dp_size
    y = y.to(x.dtype).reshape(B, S, D)
    if is_dtensor(x):
        from torch.distributed.tensor import DTensor, Replicate
        y = DTensor.from_local(y, mesh, [Replicate()], run_check=False)
        aux = DTensor.from_local(aux, mesh, [Replicate()], run_check=False)
    return y, aux


def moe_ffn(x, p, mcfg: MoEConfig, act: str, ctx=None, valid=None):
    """The MoE layer on ``ctx``'s route: :func:`moe_sharded` under a mesh
    with ``ctx.use_sharded_moe`` (a training-forward route where every token
    is real, so ``valid`` does not apply), else :func:`moe_dense_ref`."""
    if ctx is not None and ctx.use_sharded_moe and ctx.mesh is not None:
        return moe_sharded(x, p, mcfg, act, ctx)
    return moe_dense_ref(x, p, mcfg, act, valid=valid)
