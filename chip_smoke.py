#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card, PyTorch built for
CUDA and ``nvcc``.  Phases, one JSON line each:

1. card      the GPU's name and power limit (nvidia-smi);
2. build     compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernels   hold each kernel against its plain PyTorch version at the
             slice's shapes and at ragged and small ones, and time the
             kernel, the plain version and, where one exists, the PyTorch
             library call that computes the same function;
4. slice     MEERKAT-VP on full-size Llama-3.2-1B (random weights from a
             seed): sensitivity mask, pre-training gradient, VP calibration,
             three federated rounds of eight Dirichlet clients, evaluation
             before and after, and one client's trajectory against the
             server's replay; every kernel's launch count over that run must
             be the count the run implies.

Then the kernels line, the card line, and ``{"ok": true, "device": ...}``
last.  Any failed check raises and the script exits non-zero; without a
CUDA device, or outside a checkout, it exits non-zero before printing a
result.
"""
from __future__ import annotations

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
}


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
            for S, window, softcap, lens in ((128, 0, 0.0, None),
                                             (200, 0, 0.0, (200, 77)),
                                             (256, 48, 0.0, None),
                                             (130, 32, 30.0, (130, 1))):
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


# ------------------------------------------------------------------- slice --
def run_slice(torch, dev, cfg):
    """The slice on ``cfg`` through the port's public API; returns
    (launch counts over the run, the counts the run implies)."""
    import numpy as np

    import repro_torch.core as C
    from repro_torch.configs import FLConfig
    from repro_torch.data import (TaskSpec, dirichlet_partition,
                                  make_task_fns, pretrain_batches,
                                  sample_dataset, subset)
    from repro_torch.kernels import ops
    from repro_torch.models import Model, ModelCtx

    on_card = dev.type == "cuda"
    times, peaks, resident = {}, {}, {}

    def phase_done(name, t0):
        """Record the phase's wall time, its peak device memory and what
        stays allocated after it."""
        if on_card:
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated() / 1e9
            resident[name] = torch.cuda.memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
        times[name] = time.perf_counter() - t0

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, ModelCtx(attn_backend="kernel"), device=dev)
    # first-order passes (mask, pre-training gradient) differentiate through
    # the dense attention route: the kernel has no backward yet
    grad_model = Model(cfg, ModelCtx(attn_backend="dense"), device=dev)
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
    space = C.sensitivity_mask(lambda p, b: grad_model.loss(p, b), params,
                               pre, density=DENSITY, device=dev)
    phase_done("mask", t0)
    fl = FLConfig(n_clients=N_CLIENTS, local_steps=1, eps=1e-3,
                  density=DENSITY, zo_backend="kernel", vp_init_steps=2,
                  vp_later_steps=2, vp_sigma_relative=True, seed=SEED)
    server = C.FederatedZO(loss, params, space, fl, clients,
                           eval_fn=evaluate, device=dev)
    t0 = time.perf_counter()
    gp = C.pretrain_gradient_vec(lambda p, b: grad_model.loss(p, b), params,
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
    expected = {"zo_dual_perturb_flat": n_steps,
                "zo_fused_update_flat": n_steps,
                "gradip_flat": N_CLIENTS * T_CALI + ROUNDS * N_CLIENTS,
                "flash_attention": cfg.n_layers * n_forwards}
    scalars = [g for h in server.gradip_log.values() for g in h]
    finite = (all(np.isfinite(v) for v in (*m0.values(), *m1.values()))
              and all(np.all(np.isfinite(t)) for t in trajs)
              and all(np.all(np.isfinite(g)) for g in scalars)
              and bool(torch.isfinite(gp).all())
              and bool(torch.isfinite(gs).all()))
    emit("slice", model=cfg.name, n_params=model.n_params,
         mask_coords=space.n, clients=N_CLIENTS, client_batch=CLIENT_BATCH,
         seq_len=SEQ_LEN, T_cali=T_CALI, rounds=ROUNDS, flagged=flagged,
         eval_before=m0, eval_after=m1, up_bytes=server.comm.up_bytes,
         down_bytes=server.comm.down_bytes, launches=counts,
         expected_launches=expected, replay_max_rel_err=rel,
         replay_ok=replay_ok, finite=finite, times_s=times,
         round_s=times["rounds"] / ROUNDS,
         zo_step_s=times["rounds"] / (ROUNDS * N_CLIENTS),
         peak_gb=peaks, resident_gb=resident,
         max_memory_allocated_gb=max(peaks.values(), default=None))
    if not finite:
        fail("non-finite loss, scalar or GradIP in the slice")
    if not replay_ok:
        fail(f"client delta and server replay differ (max rel {rel})")
    if on_card:
        profile_step(torch, run, server.params, keys, batches,
                     torch.zeros(space.n, device=dev))
    return counts, expected


def profile_step(torch, run, params, keys, batches, delta0):
    """One more ZO client step under torch.profiler: device time by kernel,
    by kind, and the device's idle share of the step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run(params, keys, batches, delta0)  # warm: allocator and caches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(params, keys, batches, delta0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_ms(e):
        us = getattr(e, "self_device_time_total", None)
        return (us if us is not None else e.self_cuda_time_total) / 1e3

    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_ms(e) > 0]
    kinds = {"gemm": 0.0, "ported_kernels": 0.0, "other": 0.0}
    ported = ("flash_fwd", "dual_perturb_kernel", "fused_update_kernel",
              "gradip_")
    for e in kern:
        name = e.key.lower()
        kind = ("ported_kernels" if any(t in e.key for t in ported) else
                "gemm" if ("gemm" in name or "cutlass" in name
                           or "xmma" in name) else "other")
        kinds[kind] += dev_ms(e)
    busy = sum(kinds.values())
    top = sorted(kern, key=dev_ms, reverse=True)[:12]
    emit("profile.zo_step", traced=bool(kern), wall_ms=wall_ms,
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
    torch.cuda.empty_cache()
    emit("kernels", seconds=time.perf_counter() - t0, rows=rows)

    t0 = time.perf_counter()
    counts, expected = run_slice(torch, dev, LLAMA32_1B)
    if counts != expected:
        fail(f"launch counts {counts} != expected {expected}")
    emit("slice.done", seconds=time.perf_counter() - t0)

    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        r = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": counts[name],
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
