#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card, PyTorch built for
CUDA and ``nvcc``.  Phases, one JSON line each:

1. card         the GPU's name and power limit (nvidia-smi);
2. build        compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernels      hold each kernel against its plain PyTorch version at the
                main path's shapes and at ragged and small ones, and time
                the kernel, the plain version and, where one exists, the
                PyTorch library call that computes the same function;
4. slice        MEERKAT-VP on full-size Llama-3.2-1B (random weights from a
                seed): sensitivity mask and pre-training gradient through
                the flash kernels' backward, held against the dense
                attention route (the whole-model gradient and the mask), VP
                calibration, three federated rounds of eight Dirichlet
                clients, evaluation before and after, and one client's
                trajectory against the server's replay; then one more ZO
                step under torch.profiler;
5. first_order  the backprop baseline on the same model: two Adam steps
                (``make_train_step``) and one FedAvg round of eight
                Dirichlet clients (``fedavg_round``); then one more Adam
                step under torch.profiler.

Phases 4 and 5 each count every kernel's launches from zero, and each count
must be the count its run implies.

Then the kernels line, the card line, and ``{"ok": true, "device": ...}``
last.  Any failed check raises and the script exits non-zero; without a
CUDA device, or outside a checkout, it exits non-zero before printing a
result.
"""
from __future__ import annotations

import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the slice: examples/quickstart.py's calls plus MEERKAT-VP, at full size
SEED = 0
N_CLIENTS = 8
CLIENT_BATCH = 16
SEQ_LEN = 512
DENSITY = 1e-3
T_CALI = 4
ROUNDS = 3
EVAL_EXAMPLES = 32
PRETRAIN_BATCHES, PRETRAIN_BATCH = 2, 4
# the first-order baseline: Adam steps and one FedAvg round, batch 4 x 512
FO_BATCH = 4
FO_ADAM_STEPS = 2
FO_LOCAL_STEPS = 1
FO_LR = 1e-4
# kernel-route vs dense-route gradient of the whole model: per leaf, max |d|
# over max |g|, within the JAX package's own whole-model rtol
# (tests/test_attn_vjp.py); and the share of mask coordinates both pick
GRAD_REL_BOUND = 2e-3
MASK_OVERLAP_MIN = 0.999
# backward kernels against their plain versions: both compute in f32 from
# the same (widened) operands, summing up to S*G terms in another order
BWD_REL_TOL = 1e-4

# H100 SXM data sheet: HBM3 rate, and the f32 rate outside the tensor cores
# (the kernels compute in f32 on CUDA cores)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

KERNEL_SOURCES = {
    "zo_dual_perturb_flat": ("src/repro_torch/kernels/csrc/zo_update.cu",
                             "src/repro/kernels/zo_update.py:40"),
    "zo_fused_update_flat": ("src/repro_torch/kernels/csrc/zo_update.cu",
                             "src/repro/kernels/zo_update.py:90"),
    "gradip_flat": ("src/repro_torch/kernels/csrc/gradip.cu",
                    "src/repro/kernels/gradip_reduce.py:33"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attn.cu",
                        "src/repro/kernels/flash_attention.py:159"),
    "flash_attention_bwd_dq": ("src/repro_torch/kernels/csrc/flash_attn_bwd.cu",
                               "src/repro/kernels/flash_attention.py:285"),
    "flash_attention_bwd_dkv": (
        "src/repro_torch/kernels/csrc/flash_attn_bwd.cu",
        "src/repro/kernels/flash_attention.py:310"),
}
# the variant grid of the flash kernels: (S, window, softcap, lengths)
FLASH_VARIANTS = ((128, 0, 0.0, None),       # causal
                  (200, 0, 0.0, (200, 77)),  # ragged S, lengths
                  (256, 48, 0.0, None),      # window
                  (130, 32, 30.0, (130, 1)))  # window, softcap, length 1


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def timed(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls after two warm-up calls (CUDA
    events around the whole run)."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(n_bytes: float, n_ops: float):
    mem_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    op_ms = n_ops / F32_FLOP_PER_S * 1e3
    return max(mem_ms, op_ms), ("bytes" if mem_ms >= op_ms else "operations")


# ----------------------------------------------------------------- kernels --
def check_elementwise(torch, ops, ref, dev, n_slice: int):
    """dual_perturb and fused_update: bit-equal to the plain version (both
    round the f32 product, then add in w's dtype)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    for n in (1, 1023, 1_000_003, 4096 * 1024):
        for dtype in (torch.float32, torch.bfloat16):
            w = torch.randn(n, generator=gen, device=dev).to(dtype)
            z = torch.randn(n, generator=gen, device=dev)
            m = (torch.rand(n, generator=gen, device=dev) < 0.3).float()
            for mm in (None, m):
                p, q = ops.zo_dual_perturb_flat(w, z, mm, 1e-3)
                rp, rq = ref.dual_perturb_ref(w, z, mm, 1e-3)
                s = torch.tensor(-7.31e-4, device=dev)
                u = ops.zo_fused_update_flat(w, z, mm, s)
                ru = ref.fused_update_ref(w, z, mm, s)
                if not (torch.equal(p, rp) and torch.equal(q, rq)
                        and torch.equal(u, ru)):
                    fail(f"elementwise kernels differ from plain at n={n} "
                         f"{dtype} masked={mm is not None}")
    emit("kernels.elementwise_variants", ok=True,
         checked="n in {1, 1023, 1000003, 4194304} x {f32, bf16} x {m, no m}")

    # the slice's shape: the flat Llama-3.2-1B vector, f32, pre-masked z
    w = torch.randn(n_slice, generator=gen, device=dev)
    z = torch.randn(n_slice, generator=gen, device=dev)
    out = {}
    p, q = ops.zo_dual_perturb_flat(w, z, None, 1e-3)
    rp, rq = ref.dual_perturb_ref(w, z, None, 1e-3)
    err = max(float((p - rp).abs().max()), float((q - rq).abs().max()))
    del p, q, rp, rq
    if err != 0.0:
        fail(f"dual_perturb differs from plain at the slice shape: {err}")
    b_ms, b_by = bound(16.0 * n_slice, 3.0 * n_slice)
    out["zo_dual_perturb_flat"] = dict(
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        ms=timed(lambda: ops.zo_dual_perturb_flat(w, z, None, 1e-3), 10),
        plain_ms=timed(lambda: ref.dual_perturb_ref(w, z, None, 1e-3), 10),
        shape=f"[{n_slice}] f32, pre-masked z")
    s = torch.tensor(-1e-3 * 0.731, device=dev)
    u = ops.zo_fused_update_flat(w, z, None, s)
    err = float((u - ref.fused_update_ref(w, z, None, s)).abs().max())
    del u
    if err != 0.0:
        fail(f"fused_update differs from plain at the slice shape: {err}")
    b_ms, b_by = bound(12.0 * n_slice, 2.0 * n_slice)
    s_host = float(s)
    out["zo_fused_update_flat"] = dict(
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        ms=timed(lambda: ops.zo_fused_update_flat(w, z, None, s), 10),
        plain_ms=timed(lambda: ref.fused_update_ref(w, z, None, s), 10),
        library_ms=timed(lambda: torch.add(w, z, alpha=s_host), 10),
        shape=f"[{n_slice}] f32, pre-masked z")
    return out


def check_gradip(torch, ops, ref, dev, n_slice: int):
    gen = torch.Generator(device=dev).manual_seed(2)
    out = {}
    for n in (1, 777, 10_000_000, n_slice):
        gp = torch.randn(n, generator=gen, device=dev)
        z = torch.randn(n, generator=gen, device=dev)
        got = ops.gradip_flat(gp, z, 1.7)
        want = ref.gradip_reduce_ref(gp, z, 1.7)
        err = abs(float(got) - float(want))
        # f32 sums in two orders: within 1e-5 of the sum of |terms|
        if err > 1e-5 * 1.7 * float((gp * z).abs().sum()):
            fail(f"gradip differs from plain at n={n}: {err}")
        if float(ops.gradip_flat(gp, z, 1.7)) != float(got):
            fail("gradip is not deterministic")
    b_ms, b_by = bound(8.0 * n_slice + 4, 2.0 * n_slice)
    out["gradip_flat"] = dict(
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        ms=timed(lambda: ops.gradip_flat(gp, z, 1.7), 50),
        plain_ms=timed(lambda: ref.gradip_reduce_ref(gp, z, 1.7), 50),
        library_ms=timed(lambda: torch.dot(gp, z), 50),
        shape=f"[{n_slice}] f32")
    emit("kernels.gradip_variants", ok=True,
         checked="n in {1, 777, 1e7, slice n}; repeat-call bit-equal")
    return out


def _attn(torch, dev, gen, B, S, KV, G, dh, dtype):
    q = torch.randn(B, S, KV * G, dh, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, S, KV, dh, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, S, KV, dh, generator=gen, device=dev).to(dtype)
    return q, k, v


def check_flash(torch, ops, ref, dev, cfg, batch: int):
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(3)
    n_var = 0
    for dtype in (torch.float32, torch.bfloat16):
        for G, dh in ((1, 64), (4, 64), (1, 128), (4, 128)):
            for S, window, softcap, lens in FLASH_VARIANTS:
                q, k, v = _attn(torch, dev, gen, 2, S, 2, G, dh, dtype)
                L = torch.tensor(lens or (S, S), device=dev)
                o, lse = ops.flash_attention(q, k, v, L, window=window,
                                             softcap=softcap,
                                             return_lse=True)
                ro, rlse = ref.flash_attention_ref(
                    q, k, v, L, window=window, softcap=softcap, causal=True)
                # f32: two summation orders; bf16: one bf16 rounding of the
                # same f32 result (a bf16 ulp at |O| < 4)
                atol = 1e-4 if dtype == torch.float32 else 1.6e-2
                e_o = float((o.float() - ro.float()).abs().max())
                e_l = float((lse - rlse).abs().max())
                if e_o > atol or e_l > 1e-4:
                    fail(f"flash differs from plain: {dtype} G={G} dh={dh} "
                         f"S={S} window={window} softcap={softcap} "
                         f"lengths={lens}: O {e_o}, lse {e_l}")
                n_var += 1
    emit("kernels.flash_variants", ok=True, checked=n_var,
         grid="{f32,bf16} x G{1,4} x dh{64,128} x {causal; ragged S with "
              "lengths; window; window+softcap+lengths}")

    # the slice's shape: one attention layer of the ZO loss forward
    B, S = batch, SEQ_LEN
    KV, G, dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, \
        cfg.resolved_head_dim
    q, k, v = _attn(torch, dev, gen, B, S, KV, G, dh, torch.float32)
    L = torch.full((B,), S, device=dev)
    o, lse = ops.flash_attention(q, k, v, L, return_lse=True)
    ro, rlse = ref.flash_attention_ref(q, k, v, L, window=0, softcap=0.0,
                                       causal=True)
    err = max(float((o - ro).abs().max()), float((lse - rlse).abs().max()))
    if err > 1e-4:
        fail(f"flash differs from plain at the slice shape: {err}")
    live = int(ref.attention_valid(S, L, window=0, causal=True).sum()) \
        * KV * G                                   # live (query, key) pairs
    n_bytes = 4.0 * (q.numel() + k.numel() + v.numel() + o.numel()
                     + lse.numel() + L.numel())
    b_ms, b_by = bound(n_bytes, 4.0 * dh * live)   # QK^T and PV: 2 FMA each
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    out = {"flash_attention": dict(
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        ms=timed(lambda: ops.flash_attention(q, k, v, L), 10),
        plain_ms=timed(lambda: ref.flash_attention_ref(
            q, k, v, L, window=0, softcap=0.0, causal=True), 5),
        library_ms=timed(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True, enable_gqa=True), 10),
        shape=f"q [{B},{S},{KV * G},{dh}] f32, causal, G={G}",
        gflop=4.0 * dh * live / 1e9, mbytes=n_bytes / 1e6)}
    return out


def check_flash_bwd(torch, ops, ref, dev, cfg, batch: int):
    """The dQ and dK/dV kernels against their plain versions on the same
    (q, k, v, lengths, lse, delta, dO), bit-equal over two calls, over the
    variant grid and at the first-order shape."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(4)

    def inputs(B, S, KV, G, dh, dtype, lens, window, softcap):
        q, k, v = _attn(torch, dev, gen, B, S, KV, G, dh, dtype)
        do = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
        L = torch.tensor(lens or (S,) * B, device=dev, dtype=torch.int32)
        o, lse = ref.flash_attention_ref(q, k, v, L, window=window,
                                         softcap=softcap, causal=True)
        return (q, k, v, L, lse, ref.flash_attention_delta(o, do, KV), do)

    def both(args, kw):
        return ((ops.flash_attention_bwd_dq(*args, **kw),
                 *ops.flash_attention_bwd_dkv(*args, **kw)),
                (ref.flash_attn_bwd_dq_ref(*args, **kw),
                 *ref.flash_attn_bwd_dkv_ref(*args, **kw)))

    def rel_err(got, want):
        return [float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
                for g, w in zip(got, want)]

    n_var, worst = 0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for G, dh in ((1, 64), (4, 64), (1, 128), (4, 128), (6, 64)):
            for S, window, softcap, lens in FLASH_VARIANTS:
                kw = dict(window=window, softcap=softcap, causal=True)
                args = inputs(2, S, 2, G, dh, dtype, lens, window, softcap)
                got, want = both(args, kw)
                errs = rel_err(got, want)
                worst = max(worst, *errs)
                if max(errs) > BWD_REL_TOL:
                    fail(f"flash backward differs from plain: {dtype} G={G} "
                         f"dh={dh} S={S} window={window} softcap={softcap} "
                         f"lengths={lens}: dQ, dK, dV {errs}")
                again = (ops.flash_attention_bwd_dq(*args, **kw),
                         *ops.flash_attention_bwd_dkv(*args, **kw))
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    fail(f"flash backward is not bit-equal over two calls: "
                         f"{dtype} G={G} dh={dh} S={S}")
                n_var += 1
    emit("kernels.flash_bwd_variants", ok=True, checked=n_var,
         max_rel_err=worst, tol=BWD_REL_TOL, repeat_bit_equal=True,
         grid="{f32,bf16} x (G,dh) in {(1,64),(4,64),(1,128),(4,128),(6,64)}"
              " x {causal; ragged S with lengths; window; window+softcap+"
              "lengths with a length-1 row}")

    # the first-order shape: one attention layer of a B x 512 backward
    B, S = batch, SEQ_LEN
    KV, G, dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, \
        cfg.resolved_head_dim
    kw = dict(window=0, softcap=0.0, causal=True)
    args = inputs(B, S, KV, G, dh, torch.float32, None, 0, 0.0)
    q, k, v, L, lse, delta, do = args
    got, want = both(args, kw)
    errs = rel_err(got, want)
    if max(errs) > BWD_REL_TOL:
        fail(f"flash backward differs from plain at the first-order shape: "
             f"dQ, dK, dV {errs}")
    abs_errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    del got, want
    live = int(ref.attention_valid(S, L, window=0, causal=True).sum()) \
        * KV * G                                   # live (query, key) pairs
    read = 4.0 * (q.numel() + k.numel() + v.numel() + do.numel()
                  + lse.numel() + delta.numel() + L.numel())
    # the library yardstick: SDPA's f32 backward (dQ, dK and dV in one call)
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    doh = do.transpose(1, 2).contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                                  enable_gqa=True)
    lib_ms = timed(lambda: torch.autograd.grad(sdpa(), (qh, kh, vh), doh),
                   20) - timed(sdpa, 20)
    shape = f"q [{B},{S},{KV * G},{dh}] f32, causal, G={G}"
    out = {}
    for name, n_ops, n_out, sl, fn, plain in (
            ("flash_attention_bwd_dq", 6.0, q.numel(), slice(0, 1),
             ops.flash_attention_bwd_dq, ref.flash_attn_bwd_dq_ref),
            ("flash_attention_bwd_dkv", 8.0, k.numel() + v.numel(),
             slice(1, 3), ops.flash_attention_bwd_dkv,
             ref.flash_attn_bwd_dkv_ref)):
        n_bytes = read + 4.0 * n_out
        # per live pair: QK^T and dO V^T (2 FMA x dh each), then dS K for
        # dQ, or P^T dO and dS^T Q for dK/dV
        b_ms, b_by = bound(n_bytes, n_ops * dh * live)
        out[name] = dict(
            max_abs_err=max(abs_errs[sl]), max_rel_err=max(errs[sl]),
            bound_ms=b_ms, bound_by=b_by,
            ms=timed(lambda: fn(*args, **kw), 10),
            plain_ms=timed(lambda: plain(*args, **kw), 5),
            library_ms=lib_ms, shape=shape,
            gflop=n_ops * dh * live / 1e9, mbytes=n_bytes / 1e6)
    return out


# ------------------------------------------------------------------- slice --
def phase_clock(torch, on_card):
    """(done, times, peaks, resident): ``done(name, t0)`` records the phase's
    wall time, its peak device memory and what stays allocated after it."""
    times, peaks, resident = {}, {}, {}

    def done(name, t0):
        if on_card:
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated() / 1e9
            resident[name] = torch.cuda.memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
        times[name] = time.perf_counter() - t0

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    return done, times, peaks, resident


def named_leaves(tree, prefix=""):
    """(path, leaf) pairs of a parameter tree, in the port's leaf order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named_leaves(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def mask_overlap(torch, a, b, params) -> float:
    """Share of space a's coordinates that space b selects too."""
    def flat(space):
        off, out = 0, []
        for idx, leaf in zip(named_leaves(space.idx_tree),
                             named_leaves(params)):
            out.append(idx[1] + off)
            off += leaf[1].numel()
        return torch.cat(out)
    fa = flat(a)
    return float(torch.isin(fa, flat(b)).sum()) / max(1, fa.numel())


def run_slice(torch, dev, cfg):
    """The slice on ``cfg`` through the port's public API; returns
    (launch counts over the run, the counts the run implies)."""
    import numpy as np

    import repro_torch.core as C
    from repro_torch.configs import FLConfig
    from repro_torch.core.gradip import grad_tree
    from repro_torch.data import (TaskSpec, dirichlet_partition,
                                  make_task_fns, pretrain_batches,
                                  sample_dataset, subset)
    from repro_torch.kernels import ops
    from repro_torch.models import Model, ModelCtx

    on_card = dev.type == "cuda"
    phase_done, times, peaks, resident = phase_clock(torch, on_card)
    t0 = time.perf_counter()
    # one model for every pass: forwards and, under autograd, the backward
    # go through the flash kernels
    model = Model(cfg, ModelCtx(attn_backend="kernel"), device=dev)
    # the dense attention route, only to hold the kernel route against
    dense = Model(cfg, ModelCtx(attn_backend="dense"), device=dev)
    params = model.init(seed=SEED)
    spec = TaskSpec(vocab=512, seq_len=SEQ_LEN)
    loss, _, evaluate = make_task_fns(model, spec)
    train = sample_dataset(spec, 1024, seed=1)
    parts = dirichlet_partition(train["label"], n_clients=N_CLIENTS,
                                alpha=0.5)
    clients = [C.Client(k, subset(train, p), batch_size=CLIENT_BATCH)
               for k, p in enumerate(parts)]
    ev = sample_dataset(spec, EVAL_EXAMPLES, seed=2)
    pre = pretrain_batches(spec, n_batches=PRETRAIN_BATCHES,
                           batch_size=PRETRAIN_BATCH)
    phase_done("setup", t0)

    ops.reset_launches()  # the main path starts here
    t0 = time.perf_counter()
    m0 = {k: float(v) for k, v in evaluate(params, ev).items()}
    phase_done("eval_before", t0)

    t0 = time.perf_counter()
    space = C.sensitivity_mask(lambda p, b: model.loss(p, b), params, pre,
                               density=DENSITY, device=dev)
    phase_done("mask", t0)

    # the kernel route against the dense one: the mask, and the whole-model
    # LM-loss gradient of one pre-training batch, leaf by leaf
    t0 = time.perf_counter()
    dense_space = C.sensitivity_mask(lambda p, b: dense.loss(p, b), params,
                                     pre, density=DENSITY, device=dev)
    overlap = mask_overlap(torch, space, dense_space, params)
    del dense_space
    phase_done("mask_dense", t0)
    t0 = time.perf_counter()
    gk = grad_tree(lambda p, b: model.loss(p, b), params, pre[0])
    phase_done("grad_kernel", t0)
    t0 = time.perf_counter()
    gd = grad_tree(lambda p, b: dense.loss(p, b), params, pre[0])
    grad_rel = {
        name: float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        for (name, a), (_, b) in zip(named_leaves(gk), named_leaves(gd))}
    del gk, gd
    phase_done("grad_dense", t0)

    fl = FLConfig(n_clients=N_CLIENTS, local_steps=1, eps=1e-3,
                  density=DENSITY, zo_backend="kernel", vp_init_steps=2,
                  vp_later_steps=2, vp_sigma_relative=True, seed=SEED)
    server = C.FederatedZO(loss, params, space, fl, clients,
                           eval_fn=evaluate, device=dev)
    t0 = time.perf_counter()
    gp = C.pretrain_gradient_vec(lambda p, b: model.loss(p, b), params,
                                 space, pre)
    phase_done("pretrain_gradient", t0)
    t0 = time.perf_counter()
    results, flagged, trajs = server.calibrate_vp(gp, T_cali=T_CALI)
    phase_done("calibrate_vp", t0)
    t0 = time.perf_counter()
    server.run(ROUNDS, gp_vec=gp)
    phase_done("rounds", t0)
    t0 = time.perf_counter()
    m1 = {k: float(v) for k, v in evaluate(server.params, ev).items()}
    phase_done("eval_after", t0)

    # one client's own trajectory against the server's replay of its scalar
    t0 = time.perf_counter()
    run = C.make_local_run(loss, space, fl.eps, fl.lr, backend="kernel")
    keys = C.round_keys(fl.seed, server.round, 1)
    batches = {k: torch.as_tensor(v, device=dev)
               for k, v in clients[0].next_batches(1).items()}
    delta, gs = run(server.params, keys, batches,
                    torch.zeros(space.n, device=dev))
    rec = C.reconstruct_delta(space, keys, gs.cpu().numpy(), fl.lr)
    rel = float((delta - rec).abs().max() / rec.abs().max())
    replay_ok = bool(torch.allclose(delta, rec, rtol=1e-6,
                                    atol=1e-6 * float(rec.abs().max())))
    phase_done("replay_check", t0)
    counts = ops.launches()  # the main path ends here

    n_steps = N_CLIENTS * T_CALI + ROUNDS * N_CLIENTS + 1
    n_forwards = 2 * n_steps + 2  # two per ZO step, plus the two evals
    # differentiated passes on the kernel route: mask and pre-training
    # gradient batches, and the gradient check's one
    n_grads = 2 * PRETRAIN_BATCHES + 1
    expected = {"zo_dual_perturb_flat": n_steps,
                "zo_fused_update_flat": n_steps,
                "gradip_flat": N_CLIENTS * T_CALI + ROUNDS * N_CLIENTS,
                "flash_attention": cfg.n_layers * (n_forwards + n_grads),
                "flash_attention_bwd_dq": cfg.n_layers * n_grads,
                "flash_attention_bwd_dkv": cfg.n_layers * n_grads}
    scalars = [g for h in server.gradip_log.values() for g in h]
    finite = (all(np.isfinite(v) for v in (*m0.values(), *m1.values()))
              and all(np.all(np.isfinite(t)) for t in trajs)
              and all(np.all(np.isfinite(g)) for g in scalars)
              and bool(torch.isfinite(gp).all())
              and bool(torch.isfinite(gs).all()))
    grad_ok = max(grad_rel.values()) <= GRAD_REL_BOUND
    emit("slice", model=cfg.name, n_params=model.n_params,
         mask_coords=space.n, clients=N_CLIENTS, client_batch=CLIENT_BATCH,
         seq_len=SEQ_LEN, T_cali=T_CALI, rounds=ROUNDS, flagged=flagged,
         eval_before=m0, eval_after=m1, up_bytes=server.comm.up_bytes,
         down_bytes=server.comm.down_bytes, launches=counts,
         expected_launches=expected, replay_max_rel_err=rel,
         replay_ok=replay_ok, finite=finite,
         mask_overlap_kernel_vs_dense=overlap,
         mask_overlap_min=MASK_OVERLAP_MIN,
         grad_rel_kernel_vs_dense=grad_rel,
         grad_rel_max=max(grad_rel.values()), grad_rel_bound=GRAD_REL_BOUND,
         times_s=times, round_s=times["rounds"] / ROUNDS,
         zo_step_s=times["rounds"] / (ROUNDS * N_CLIENTS),
         peak_gb=peaks, resident_gb=resident,
         max_memory_allocated_gb=max(peaks.values(), default=None))
    if not finite:
        fail("non-finite loss, scalar or GradIP in the slice")
    if not replay_ok:
        fail(f"client delta and server replay differ (max rel {rel})")
    if not grad_ok:
        fail(f"kernel-route gradient differs from the dense route's: "
             f"{grad_rel} > {GRAD_REL_BOUND}")
    if overlap < MASK_OVERLAP_MIN:
        fail(f"kernel-route mask overlaps the dense-route mask by {overlap}")
    if on_card:
        profile_step(torch, "zo_step", lambda: run(
            server.params, keys, batches, torch.zeros(space.n, device=dev)))
    return counts, expected


# ------------------------------------------------------------- first order --
def run_first_order(torch, dev, cfg):
    """The backprop baseline on ``cfg``: Adam steps through
    ``make_train_step`` and one FedAvg round through ``fedavg_round``, on
    the task loss, every pass through the flash kernels; returns (launch
    counts over the run, the counts the run implies)."""
    import numpy as np

    import repro_torch.core as C
    from repro_torch.data import (TaskSpec, dirichlet_partition,
                                  make_task_fns, sample_dataset, subset)
    from repro_torch.kernels import ops
    from repro_torch.models import Model, ModelCtx
    from repro_torch.train import fedavg_round, make_train_step
    from repro_torch.utils import tree_leaves

    on_card = dev.type == "cuda"
    phase_done, times, peaks, resident = phase_clock(torch, on_card)
    t0 = time.perf_counter()
    model = Model(cfg, ModelCtx(attn_backend="kernel"), device=dev)
    params = model.init(seed=SEED)
    spec = TaskSpec(vocab=512, seq_len=SEQ_LEN)
    loss, _, evaluate = make_task_fns(model, spec)
    train = sample_dataset(spec, 1024, seed=1)
    parts = dirichlet_partition(train["label"], n_clients=N_CLIENTS,
                                alpha=0.5)
    per_client = [C.Client(k, subset(train, p), batch_size=FO_BATCH)
                  .next_batches(FO_LOCAL_STEPS) for k, p in enumerate(parts)]
    client_batches = {k: np.stack([b[k] for b in per_client])
                      for k in per_client[0]}      # [K, T, b, ...]
    adam_batches = [{k: v[i * FO_BATCH:(i + 1) * FO_BATCH]
                     for k, v in train.items()} for i in range(FO_ADAM_STEPS)]
    ev = sample_dataset(spec, EVAL_EXAMPLES, seed=2)

    def moved(new):
        return max(float((a - b).abs().max())
                   for a, b in zip(tree_leaves(new), tree_leaves(params)))
    phase_done("setup", t0)

    ops.reset_launches()  # the path starts here
    t0 = time.perf_counter()
    init, step = make_train_step(loss, "adam", lr=FO_LR, device=dev)
    state, p, adam_losses = init(params), params, []
    for b in adam_batches:
        p, state, lval = step(p, state, b)
        adam_losses.append(float(lval))
    adam_moved = moved(p)
    del state, p
    phase_done("adam", t0)
    t0 = time.perf_counter()
    avg = fedavg_round(loss, params, client_batches, FO_LR,
                       local_steps=FO_LOCAL_STEPS, device=dev)
    fedavg_moved = moved(avg)
    m = {k: float(v) for k, v in evaluate(avg, ev).items()}
    del avg
    phase_done("fedavg", t0)
    counts = ops.launches()  # the path ends here

    n_grads = FO_ADAM_STEPS + N_CLIENTS * FO_LOCAL_STEPS
    expected = {name: 0 for name in counts}
    expected.update({"flash_attention": cfg.n_layers * (n_grads + 1),
                     "flash_attention_bwd_dq": cfg.n_layers * n_grads,
                     "flash_attention_bwd_dkv": cfg.n_layers * n_grads})
    finite = bool(np.all(np.isfinite(adam_losses))
                  and all(np.isfinite(v) for v in m.values()))
    emit("first_order", model=cfg.name, batch=FO_BATCH, seq_len=SEQ_LEN,
         adam_steps=FO_ADAM_STEPS, adam_losses=adam_losses,
         adam_max_param_change=adam_moved, fedavg_clients=N_CLIENTS,
         fedavg_local_steps=FO_LOCAL_STEPS, fedavg_eval=m,
         fedavg_max_param_change=fedavg_moved, lr=FO_LR, finite=finite,
         launches=counts, expected_launches=expected, times_s=times,
         adam_step_s=times["adam"] / FO_ADAM_STEPS,
         fedavg_round_s=times["fedavg"], peak_gb=peaks, resident_gb=resident)
    if not finite:
        fail("non-finite loss in the first-order baseline")
    if not (adam_moved > 0 and fedavg_moved > 0):
        fail("the first-order steps left the parameters where they were")
    if on_card:
        state = init(params)
        profile_step(torch, "adam_step",
                     lambda: step(params, state, adam_batches[0]))
    return counts, expected


def profile_step(torch, name, step):
    """One more step (``step()``) under torch.profiler, after a warm one:
    device time by kernel, by kind, and the device's idle share of the
    step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()  # warm: allocator and caches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_ms(e):
        us = getattr(e, "self_device_time_total", None)
        return (us if us is not None else e.self_cuda_time_total) / 1e3

    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_ms(e) > 0]
    kinds = {"gemm": 0.0, "ported_kernels": 0.0, "other": 0.0}
    ported = ("flash_fwd", "flash_bwd", "dual_perturb_kernel",
              "fused_update_kernel", "gradip_")
    for e in kern:
        key = e.key.lower()
        kind = ("ported_kernels" if any(t in e.key for t in ported) else
                "gemm" if ("gemm" in key or "cutlass" in key
                           or "xmma" in key) else "other")
        kinds[kind] += dev_ms(e)
    busy = sum(kinds.values())
    top = sorted(kern, key=dev_ms, reverse=True)[:12]
    emit(f"profile.{name}", traced=bool(kern), wall_ms=wall_ms,
         device_busy_ms=busy, idle_share=1 - busy / wall_ms if kern else None,
         by_kind_ms=kinds,
         top=[{"kernel": e.key[:90], "ms": dev_ms(e), "calls": e.count}
              for e in top])


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout of the repo "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing ran", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit("card", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))

    from repro_torch.configs import LLAMA32_1B
    from repro_torch.kernels import build, ops, ref
    t0 = time.perf_counter()
    build.load()
    log = build.BUILD_DIR / "ptxas.log"
    text = log.read_text() if log.exists() else ""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
    spills = [int(r) for r in re.findall(r"(\d+) bytes spill stores", text)]
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=build.build_seconds, kernel_functions=len(regs),
         max_registers=max(regs, default=None), spill_bytes=sum(spills))

    from repro_torch.models.init import param_count
    n_flat = param_count(LLAMA32_1B)
    n_pad = -(-n_flat // 1024) * 1024
    n_mask = max(1, int(round(n_flat * DENSITY)))
    t0 = time.perf_counter()
    rows = {}
    rows.update(check_elementwise(torch, ops, ref, dev, n_pad))
    rows.update(check_gradip(torch, ops, ref, dev, n_mask))
    rows.update(check_flash(torch, ops, ref, dev, LLAMA32_1B, CLIENT_BATCH))
    rows.update(check_flash_bwd(torch, ops, ref, dev, LLAMA32_1B, FO_BATCH))
    torch.cuda.empty_cache()
    emit("kernels", seconds=time.perf_counter() - t0, rows=rows)

    launches = {name: 0 for name in KERNEL_SOURCES}
    for phase, run in (("slice", run_slice),
                       ("first_order", run_first_order)):
        t0 = time.perf_counter()
        counts, expected = run(torch, dev, LLAMA32_1B)
        if counts != expected:
            fail(f"{phase}: launch counts {counts} != expected {expected}")
        for name in launches:
            launches[name] += counts[name]
        gc.collect()  # the phase's model and trees go before the next
        torch.cuda.empty_cache()
        emit(f"{phase}.done", seconds=time.perf_counter() - t0,
             resident_gb=torch.cuda.memory_allocated() / 1e9)

    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        r = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    emit("total", seconds=time.perf_counter() - t_start)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
