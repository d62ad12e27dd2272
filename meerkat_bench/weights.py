"""Random weights of a dense decoder, made on the device from the run's
seed: one ``torch.randn`` per leaf (each leaf stacked over the layers) from
one ``torch.Generator`` on that device, in float32, the type the
configurations run in.

The tree has the layout the program takes (``embed``, ``final_norm``, an
untied ``lm_head``, ``stack.p0.*`` with a leading layer axis), and the
reference reads the same tree: the benchmark makes the inputs and hands
the same to both sides.  Norm scales and biases are drawn too (std 0.02),
so that the comparison sees every parameter.
"""
from __future__ import annotations

import math

import torch

STD = 0.02


def shapes(m: dict) -> dict:
    """Leaf name -> (shape, std), in draw order."""
    L, D, F, V = m["n_layers"], m["d_model"], m["d_ff"], m["vocab"]
    H, KV = m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or D // H
    out_std = STD / math.sqrt(2 * L)
    s = {"embed": ((V, D), STD), "final_norm.scale": ((D,), STD)}
    if not m.get("tie_embeddings"):
        s["lm_head"] = ((D, V), STD)
    s.update({
        "stack.p0.norm.scale": ((L, D), STD),
        "stack.p0.wq": ((L, D, H * hd), STD),
        "stack.p0.wk": ((L, D, KV * hd), STD),
        "stack.p0.wv": ((L, D, KV * hd), STD),
        "stack.p0.wo": ((L, H * hd, D), out_std),
        "stack.p0.norm2.scale": ((L, D), STD),
        "stack.p0.w1": ((L, D, F), STD),
        "stack.p0.w2": ((L, F, D), out_std),
        "stack.p0.w3": ((L, D, F), STD)})
    if m.get("qkv_bias"):
        s.update({"stack.p0.bq": ((L, H * hd), STD),
                  "stack.p0.bk": ((L, KV * hd), STD),
                  "stack.p0.bv": ((L, KV * hd), STD)})
    return s


def make(m: dict, seed: int, device) -> dict:
    """The nested weight dict for the model sizes ``m`` from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    tree: dict = {}
    for name, (shape, std) in shapes(m).items():
        t = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32).mul_(std)
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t
    return tree


def n_params(m: dict) -> int:
    return sum(math.prod(s) for s, _ in shapes(m).values())
