"""Roofline analysis (``repro.launch.roofline``): the analytic model FLOPs
of a step, and the three roofline terms of a dry-run record against the
card's peaks.

    compute term    = program FLOPs                  / peak FLOP/s
    memory  term    = program bytes                  / HBM bytes/s
    collective term = sum(op bytes x ring factor)    / link bytes/s

``analyze`` and ``collect`` read records in the JAX dry run's JSON schema
(``repro.launch.dryrun``: per-device ``cost``, ``collectives`` and
``memory``), which the port's dry run writes (``launch/dryrun.py``, into
``runs/dryrun_torch/``).
MODEL_FLOPS uses the analytic active-parameter count: a ZO step = 2
forwards, prefill = 1, decode = one token a row.

:data:`HW` is one NVIDIA H100 SXM's data sheet (dense rates, no sparsity,
at the full 700 W power limit), and nothing else: :data:`HW_CARD` names
the card as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` prints it.  A card set below 700 W runs slower.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline \
      [--dir runs/dryrun_torch] [--md runs/roofline.md] [--mesh single]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Optional

from repro_torch.launch.hlo_tools import COLLECTIVE_FACTOR

# the card the peaks below are for, as nvidia-smi names it
HW_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
HW = {
    "peak_flops_f32": 67e12,    # FLOP/s, CUDA cores (TF32 off)
    "peak_flops_tf32": 495e12,  # FLOP/s, tensor cores
    "peak_flops_bf16": 989e12,  # FLOP/s, tensor cores
    "hbm_bw": 3.35e12,          # B/s, HBM3
    "link_bw": 450e9,           # B/s per direction, NVLink 4
}


SHAPE_TOKENS = {  # (global_batch, seq_len)
    "train_4k": (256, 4096),
    "prefill_32k": (32, 32768),
    "decode_32k": (128, 1),
    "long_500k": (1, 1),
}

# Peak FLOP/s per measurement platform, for *measured*-MFU accounting,
# keyed as ``kernels.autotune.platform_key()`` names platforms: the card's
# name maps to the f32 peak, the dtype the port trains in with TF32 off;
# "cpu" keeps the JAX package's nominal single-socket f32 host peak.
# Unknown platforms raise in :func:`host_peak_flops` rather than silently
# giving a null MFU.
HOST_PEAK_FLOPS = {
    "nvidia_h100_80gb_hbm3": HW["peak_flops_f32"],
    "cpu": 1e11,
}


def host_peak_flops(platform: Optional[str] = None) -> float:
    """Peak FLOP/s for the measurement platform (default: this host's
    ``kernels.autotune.platform_key()``, the card's or ``cpu``).  Raises
    KeyError for platforms missing from ``HOST_PEAK_FLOPS``: MFU must
    never silently be null."""
    if platform is None:
        from repro_torch.kernels.autotune import platform_key
        platform = platform_key()
    if platform not in HOST_PEAK_FLOPS:
        raise KeyError(
            f"no peak-FLOP/s entry for platform {platform!r}: add it to "
            f"launch/roofline.py HOST_PEAK_FLOPS "
            f"(have {sorted(HOST_PEAK_FLOPS)})")
    return HOST_PEAK_FLOPS[platform]


def attention_flops(cfg, B: int, S: int, causal: bool = True) -> float:
    """Matmul FLOPs of the attention score + value contractions for one
    full-model forward: 4 * pairs * head_dim per (batch, head), with
    ``pairs`` the live (query, key) count — S(S+1)/2 causal, banded to the
    sliding window on 'local_attn' layers, per the layer pattern."""
    hd = cfg.resolved_head_dim
    H = cfg.n_heads

    def pairs(window: int) -> float:
        if not causal:
            return float(S) * S
        full = S * (S + 1) / 2
        if window and window < S:
            # banded: query t sees min(t+1, w) keys; the sum telescopes to
            # full minus the (S-w)-row tail triangle
            return full - (S - window) * (S - window + 1) / 2
        return full

    total = 0.0
    for mixer, _ in cfg.layer_pattern:
        if mixer == "attn":
            total += pairs(0)
        elif mixer == "local_attn":
            total += pairs(cfg.sliding_window)
    return 4.0 * B * H * hd * total * cfg.n_periods


def forward_model_flops(cfg, B: int, S: int) -> float:
    """Analytic FLOPs for one forward: 2 * N_active per token (matmul
    MACs x2, MoE-aware) plus the quadratic attention term."""
    from repro_torch.models.init import active_param_count
    return 2.0 * active_param_count(cfg) * B * S + attention_flops(cfg, B, S)


def step_model_flops(cfg, B: int, S: int, step: str) -> float:
    """Forward-equivalents per benchmark step: prefill = 1 forward,
    zo_step = 2 (the MEERKAT dual forward, Eq. 1, n_dirs=1), first_order =
    3 (forward + ~2x backward).  Unknown steps raise."""
    fwd = forward_model_flops(cfg, B, S)
    mult = {"prefill": 1.0, "forward": 1.0, "zo_step": 2.0,
            "first_order": 3.0}
    if step not in mult:
        raise KeyError(f"no FLOPs model for step {step!r} "
                       f"(have {sorted(mult)})")
    return mult[step] * fwd


def model_flops_per_device(rec: dict) -> float:
    """Analytic 'useful' FLOPs per device for the lowered step (the
    port's records of shapes off the registry carry ``global_batch`` and
    ``seq_len``)."""
    B, S = SHAPE_TOKENS.get(rec["shape"]) or (rec["global_batch"],
                                              rec["seq_len"])
    n_act = rec["n_active_params"]
    tokens = B * S
    if rec["step"] in ("zo_fl", "zo_dp"):
        per_tok = 4 * n_act        # two forwards, no backward
    elif rec["step"] == "first_order":
        per_tok = 6 * n_act
    else:                          # prefill / decode: one forward
        per_tok = 2 * n_act
    return per_tok * tokens / rec["n_devices"]


def analyze(rec: dict, hw: Optional[dict] = None) -> Optional[dict]:
    """The roofline row of one dry-run record against ``hw`` (default
    :data:`HW`; keys ``peak_flops_bf16``, ``hbm_bw``, ``link_bw``): the
    dry run lowers bf16 programs, so the compute term is at the bf16
    peak.  None for a record that did not lower."""
    if not rec.get("ok"):
        return None
    hw = HW if hw is None else hw
    cost = rec.get("cost") or rec.get("cost_full_scan")
    coll = rec.get("collectives") or rec.get("collectives_full_scan") or {}
    # depth-1/2 extrapolation can go slightly negative when a collective
    # is fused away at depth 2: clamp each term to >= 0
    t_comp = max(0.0, cost["flops"]) / hw["peak_flops_bf16"]
    t_mem = max(0.0, cost["bytes"]) / hw["hbm_bw"]
    coll_bytes = sum(max(0.0, v) * COLLECTIVE_FACTOR[k]
                     for k, v in coll.items())
    t_coll = coll_bytes / hw["link_bw"]
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops_per_device(rec)
    useful = mf / max(cost["flops"], 1.0)
    t_bound = max(terms.values())
    # MFU if the dominant term were the wall clock
    mfu = mf / hw["peak_flops_bf16"] / max(t_bound, 1e-30)
    return dict(arch=rec["arch"], shape=rec["shape"], step=rec["step"],
                mesh=rec["mesh"], compute_s=t_comp, memory_s=t_mem,
                collective_s=t_coll, dominant=dominant,
                collective_bytes=coll_bytes,
                model_flops_per_dev=mf, hlo_flops_per_dev=cost["flops"],
                useful_flop_ratio=useful, bound_mfu=mfu,
                peak_bytes_per_dev=rec["memory"]["peak_est_bytes"],
                note=suggest(dominant, rec))


def suggest(dominant: str, rec: dict) -> str:
    step = rec["step"]
    if dominant == "collective":
        return ("shrink cross-shard traffic: fewer all-gathers of sharded "
                "weights (batch the ZO scalar psum, keep scatters sharded)")
    if dominant == "memory":
        if step == "decode":
            return ("decode is KV/state-bandwidth bound: shrink cache dtype "
                    "(int8 KV), fuse the per-token weight read (multi-token "
                    "speculative or batched decode amortizes it)")
        return ("re-materialize less / fuse elementwise chains so each "
                "weight+activation byte is read once per layer")
    if step == "zo_fl":
        return ("compute-bound: ZO forward pair is matmul-dominated — raise "
                "tensor-core utilization (bigger per-device batch, bf16 "
                "everywhere)")
    return "compute-bound: increase arithmetic intensity per HBM byte"


def collect(dirname: str, mesh: str = "single",
            hw: Optional[dict] = None) -> List[dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("mesh") != mesh:
            continue
        r = analyze(rec, hw)
        if r:
            rows.append(r)
    return rows


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def to_markdown(rows: List[dict]) -> str:
    hdr = ("| arch | shape | step | compute | memory | collective | "
           "dominant | useful/HLO | bound MFU |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    body = ""
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        body += (f"| {r['arch']} | {r['shape']} | {r['step']} | "
                 f"{fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} | "
                 f"{fmt_s(r['collective_s'])} | **{r['dominant']}** | "
                 f"{r['useful_flop_ratio']:.2f} | {r['bound_mfu'] * 100:.1f}% |\n")
    return hdr + body


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="runs/dryrun_torch")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--md", default=None)
    ap.add_argument("--json", default=None)
    a = ap.parse_args(argv)
    rows = collect(a.dir, a.mesh)
    md = to_markdown(rows)
    print(f"peaks: {HW_CARD} data sheet")
    print(md)
    doms = {}
    for r in rows:
        doms[r["dominant"]] = doms.get(r["dominant"], 0) + 1
    print(f"{len(rows)} rows; dominant-term counts: {doms}")
    if a.md:
        with open(a.md, "w") as f:
            f.write(md)
    if a.json:
        with open(a.json, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
