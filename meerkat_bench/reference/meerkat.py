"""Plain reference of MEERKAT's federated rounds: the sensitivity mask, the
pre-training gradient, each client's zeroth-order steps on the masked
coordinates, the server's virtual-path replay, the FedAvg aggregate, the
GradIP trajectories and the int8 uplink.

It takes the weights as ``meerkat_bench.weights`` makes them from the seed,
the harness's client data, and the model's plain forward
(``dense_decoder``).  Coordinates are laid out as the protocol defines
them: leaves in sorted-key order, indices ascending within a leaf, and
step t's z is ``normal(key_t, n)`` over that layout.
"""
from __future__ import annotations

import numpy as np
import torch

from meerkat_bench.reference import codec, prng


def leaves(tree, prefix=""):
    """[(path, tensor)] of a nested dict, keys visited sorted."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves(tree[k], f"{prefix}{k}.")
        return out
    return [(prefix[:-1], tree)]


def round_keys(seed: int, rnd: int, T: int):
    """The round's T step keys [T, 2]: the seed's key folded with the
    round (uint32), then split T ways."""
    return prng.split(prng.fold_in(prng.key(seed), rnd & 0xFFFFFFFF), T)


class Coords:
    """The masked coordinates over the leaves of ``w``: per-leaf int64 flat
    indices (sorted), and the [n] vector's segment of each leaf."""

    def __init__(self, w, idx_per_leaf):
        self.flat = [t.view(-1) for _, t in leaves(w)]
        self.names = [p for p, _ in leaves(w)]
        self.idx = [torch.as_tensor(i, device=f.device).long()
                    for i, f in zip(idx_per_leaf, self.flat)]
        sizes = [int(i.numel()) for i in self.idx]
        self.off = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
        self.n = int(self.off[-1])

    def get(self):
        return torch.cat([f[i] for f, i in zip(self.flat, self.idx)])

    def put(self, vals):
        for j, (f, i) in enumerate(zip(self.flat, self.idx)):
            if i.numel():
                f[i] = vals[self.off[j]:self.off[j + 1]]

    def leaf_norms(self, vec):
        """Per-leaf Euclidean norms of an [n] vector (f64)."""
        v = vec.double()
        return np.array([float(torch.linalg.vector_norm(
            v[self.off[j]:self.off[j + 1]])) for j in range(len(self.idx))])


def sensitivity(w, m, batches, loss_fn):
    """(mean squared gradient, mean gradient) per leaf over ``batches``."""
    names = [p for p, _ in leaves(w)]
    sq = {p: torch.zeros_like(t) for p, t in leaves(w)}
    mean = {p: torch.zeros_like(t) for p, t in leaves(w)}
    params = [t for _, t in leaves(w)]
    for b in batches:
        for t in params:
            t.requires_grad_(True)
        with torch.enable_grad():
            grads = torch.autograd.grad(loss_fn(w, m, b["tokens"]), params)
        for t in params:
            t.requires_grad_(False)
        for p, g in zip(names, grads):
            sq[p].add_(g.square())
            mean[p].add_(g)
        del grads
    n = max(len(batches), 1)
    return ({p: v.div_(n) for p, v in sq.items()},
            {p: v.div_(n) for p, v in mean.items()})


def topk_mask(scores, density: float):
    """The global top ``max(1, round(N * density))`` scores: per-leaf
    sorted flat indices, in the order of ``scores`` (a dict in leaf
    order)."""
    names = list(scores)
    sizes = [scores[p].numel() for p in names]
    k = max(1, int(round(sum(sizes) * density)))
    flat = torch.cat([scores[p].reshape(-1) for p in names])
    top = torch.sort(torch.topk(flat, k, sorted=False).indices).values
    del flat
    out, off = [], 0
    for s in sizes:
        lo, hi = torch.searchsorted(
            top, torch.tensor([off, off + s], device=top.device)).tolist()
        out.append(top[lo:hi] - off)
        off += s
    return out


def mask_miss(a, b, sizes) -> float:
    """Share of mask ``b``'s coordinates that mask ``a`` lacks."""
    off = np.concatenate([[0], np.cumsum(sizes)])
    ga = torch.cat([i.long() + int(o) for i, o in zip(a, off)])
    gb = torch.cat([i.long().to(ga.device) + int(o) for i, o in zip(b, off)])
    return 1.0 - float(torch.isin(gb, ga).sum()) / max(gb.numel(), 1)


class Clients:
    """Each client's data and pointer: T x batch rows a round, in order,
    wrapping around."""

    def __init__(self, parts, batch_size: int):
        self.parts = parts
        self.bs = batch_size
        self.ptr = [0] * len(parts)

    def next(self, cid: int, T: int):
        d = self.parts[cid]
        n = len(d["label"])
        idx = (self.ptr[cid] + np.arange(T * self.bs)) % n
        self.ptr[cid] = int((self.ptr[cid] + T * self.bs) % n)
        return [{k: v[idx[t * self.bs:(t + 1) * self.bs]]
                 for k, v in d.items()} for t in range(T)]


def cohorts(n_clients: int, frac: float, seed: int):
    """The cohort of each round in turn: all clients at ``frac`` 1, else
    ``max(1, round(frac * K))`` drawn without replacement by one
    ``default_rng(seed).choice`` a round, sorted."""
    rng = np.random.default_rng(seed)
    m = max(1, int(round(frac * n_clients)))
    while True:
        if frac >= 1.0:
            yield list(range(n_clients))
        else:
            yield sorted(int(i) for i in rng.choice(n_clients, size=m,
                                                    replace=False))


@torch.no_grad()
def run_rounds(w, m, coords: Coords, clients: Clients, fl: dict,
               rounds: int, task_loss, gp=None, follow=None):
    """``rounds`` federated rounds from ``w`` (updated in place at the
    coordinates).  Returns a record: ``loss`` [(round, cid, l+, l-)],
    ``g`` [(round, cid, uploaded g [T])], ``steps`` [(round, cid, t, own
    g before rounding, own uploaded g, the g used, rounding margin, grid
    step)], ``v`` the coordinates' values before round 0 and after each
    round, ``gradip`` [(round, cid, [T])] when ``gp`` is given.

    ``follow`` ({(round, cid): [T] uploaded g}, another side's uploads):
    each step then goes on with that side's g in place of its own, so that
    the trajectories stay comparable where a rounding threshold splits
    them; the record keeps both."""
    eps, lr, T = float(fl["eps"]), float(fl["lr"]), int(fl["local_steps"])
    bits = {"int8": 8, "int4": 4}.get(fl.get("quantize", "none"))
    rec = {"loss": [], "g": [], "steps": [], "v": [coords.get().clone()],
           "gradip": []}
    draw = cohorts(len(clients.parts), float(fl.get("sample_frac", 1.0)),
                   int(fl["seed"]))
    dev = coords.flat[0].device
    # the server's replay, delta_t = round(-lr * (g_t z_t) + delta), takes
    # -lr in f32 and rounds the product g z to f32 first
    neg_lr = float(np.float32(-lr))
    for r in range(rounds):
        keys = round_keys(int(fl["seed"]), r, T)
        zs = [prng.normal(k, coords.n, dev) for k in keys]
        base = coords.get().clone()
        deltas = []
        for cid in next(draw):
            delta = torch.zeros(coords.n, dtype=torch.float32, device=dev)
            gs = []
            for t, batch in enumerate(clients.next(cid, T)):
                step = eps * zs[t]
                coords.put((base + delta) + step)
                lp = task_loss(w, m, batch)
                coords.put((base + delta) - step)
                lm = task_loss(w, m, batch)
                raw = (lp - lm) / (2.0 * eps)
                own, margin, grid = raw, None, None
                if bits:
                    own, margin, grid = codec.roundtrip(raw, keys[t], bits)
                    own, margin, grid = own[0], float(margin[0]), \
                        float(grid[0])
                g = own
                if follow is not None:
                    g = torch.tensor(follow[(r, cid)][t], dtype=torch.float32,
                                     device=dev)
                delta = delta + (-lr * g) * zs[t]
                gs.append(float(g))
                rec["loss"].append((r, cid, float(lp), float(lm)))
                rec["steps"].append((r, cid, t, float(raw), float(own),
                                     float(g), margin, grid))
            coords.put(base)
            if bits:
                gs = [float(x) for x in codec.wire_nearest(np.array(gs),
                                                           bits)]
            rec["g"].append((r, cid, gs))
            rep = torch.zeros(coords.n, dtype=torch.float64, device=dev)
            for t, g in enumerate(gs):
                gz = (torch.tensor(g, dtype=torch.float32, device=dev)
                      * zs[t]).double()
                rep = (gz * neg_lr + rep).float().double()
            deltas.append(rep.float())
            if gp is not None:
                rec["gradip"].append((r, cid, [
                    g * float(torch.dot(gp.double(), zs[t].double()))
                    for t, g in enumerate(gs)]))
        total = deltas[0]
        for d in deltas[1:]:
            total = total + d
        coords.put(base + total / len(deltas))
        rec["v"].append(coords.get().clone())
    return rec
