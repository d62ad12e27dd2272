"""The dry run (``repro.launch.dryrun``): trace every (arch x input shape x
mesh) combination as one device of the production mesh runs it, and write
the per-device cost records that ``launch/roofline.py`` reads.

One process stands for one device: :func:`launch.mesh.fake_mesh` makes it
rank 0 of a ``"fake"`` process group of the mesh's size (16x16, or
2x16x16), whose collectives move nothing, and every parameter, batch and
cache is a fake tensor (``FakeTensorMode``) of the rank's local shape, a
DTensor placed by the sharding rules, so no byte is allocated and no
device is used: this entry point runs on the CPU by design.  The step runs
eagerly under the analyzer's recorder (``analysis/walk.py``), which counts
the local ops DTensor issues on the rank's shards: their FLOPs
(``flop_counter``'s matmul-class ops), their bytes (inputs and outputs,
unfused), the collectives' bytes, and the liveness peak.

The steps are the JAX package's:

* ``zo_fl`` (train shapes): the T=1 MEERKAT step of ``core/fl_step`` under
  ``rule="tp"`` (Megatron specs, clients over the batch axes, a balanced
  random mask at density 1e-3 clamped to 8,388,608 coordinates);
* ``zo_dp``: the ``fsdp`` rule, every mesh axis a batch axis, online
  attention with a query block of 512 (ROADMAP C22: the port gathers the
  weights once a step, not once a layer period);
* ``first_order``: one SGD step through autograd;
* ``prefill`` and ``decode`` (the rules' ``cache_specs``; the B=1
  long-context decode sequence-shards the cache, ``seq_shard``).

Eager PyTorch counts every op of every layer, so a full-depth trace is exact,
and every period adds the same ops: the depth-1/2 traces (``fit_points``)
extrapolate linearly to the full count, and ``fit_exact`` says whether they met
its FLOPs and collectives where both ran (``fit_bytes_rel`` the bytes' relative
miss: a ZO step's mask is drawn anew at each depth, so its bytes are linear
only to about 0.2%).  A fake op costs ~0.2 ms of host time, so the full-depth
trace runs only where the depth-1/2 traces put it under ``FULL_TRACE_RECORDS``
ops (or with ``--full``); elsewhere the record's counts and memory are the
extrapolation (``full_depth`` false). A trace past ``TRACE_MAX_RECORDS`` ops
stops with an error, and so does a depth-1 trace whose depth-2 twin would
pass it: xLSTM's sLSTM steps one position at a time, ~25 ops a step, so
its prefill_32k (32,768 serial steps a layer, 820k ops at depth 1) is
such an error.  ``compile_s`` is the traces' seconds.  JAX's ``scan_unroll``
and ``unroll_chunks`` have no counterpart (ROADMAP C22).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs import ASSIGNED, get_config, get_shape
from repro_torch.configs.base import InputShape, MeshConfig, ModelConfig
from repro_torch.models.init import active_param_count, param_count
from repro_torch.models.transformer import ModelCtx

DTYPE = torch.bfloat16
FL_EPS = 1e-3
FL_LR = 1e-4
MASK_DENSITY = 1e-3
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
FULL_TRACE_RECORDS = 300_000
TRACE_MAX_RECORDS = 1_200_000
OUT_DIR = "runs/dryrun_torch"


def _shallow_cfg(cfg: ModelConfig, n: int) -> ModelConfig:
    kw = dict(n_layers=cfg.period * n)
    if cfg.encoder is not None:
        kw["encoder"] = dataclasses.replace(cfg.encoder, n_layers=n)
    return cfg.replace(**kw)


def _largest_block(S: int, target: int) -> int:
    """Largest divisor of S that is <= target (for q-block chunking)."""
    b = min(target, S)
    while S % b:
        b -= 1
    return b


def make_ctx(cfg: ModelConfig, shape: InputShape, mesh,
             mc: MeshConfig) -> ModelCtx:
    """The model context of one combination, field for field JAX's
    ``make_ctx`` (without ``scan_unroll``/``unroll_chunks``)."""
    dp = mc.data * mc.pods
    seq_shard = shape.global_batch % dp != 0
    B_loc = max(1, shape.global_batch // dp)
    S = shape.seq_len + (cfg.n_patches if cfg.frontend == "vision_stub"
                         else 0)
    q_block = 0
    if shape.kind != "decode" and S > 2048:
        # keep per-device f32 scores [B_loc, H, q_block, S] under ~1.5 GB
        budget = int(1.5e9)
        h_loc = max(1, cfg.n_heads // mc.model)
        target = max(128, budget // max(1, B_loc * h_loc * S * 4))
        q_block = _largest_block(S, min(target, 2048))
    mlstm_block = 0
    if cfg.xlstm is not None and shape.kind != "decode" and S > 2048:
        mlstm_block = _largest_block(S, 512)
    return ModelCtx(
        mesh=mesh, batch_axes=mc.batch_axes, model_axis="model",
        use_sharded_moe=(cfg.moe is not None and shape.kind != "decode"
                         and not seq_shard),
        attn_q_block=q_block, mamba_chunk=64, mlstm_block=mlstm_block,
        seq_shard=seq_shard,
        # the selective-scan kernel's traffic (read dt/B/C/x once, write y
        # once), as the JAX dry run models it
        mamba_mode="stub" if shape.kind != "decode" else "scan")


STEP_FOR_SHAPE = {"train": "zo_fl", "prefill": "prefill", "decode": "decode"}


def applicable(cfg: ModelConfig, shape: InputShape) -> bool:
    if shape.name == "long_500k":
        return cfg.supports_long_context
    return True


# ------------------------------------------------------------- inputs ----
def _fake_dtensor(shape, dtype, mesh, placements, device="cpu"):
    """A DTensor of global ``shape`` whose local shard (this rank's) is an
    empty tensor, fake under the caller's ``FakeTensorMode``."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models.decode import _contiguous_stride
    from repro_torch.sharding.fl import local_shape
    local = torch.empty(local_shape(shape, mesh, placements), dtype=dtype,
                        device=device)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _placed(abstract, specs, mesh, fn, device="cpu"):
    """A tree of fake DTensors: leaf ``a`` of ``abstract`` placed by
    ``fn(spec) -> (mesh, placements)``."""
    from repro_torch.utils.tree import tree_flatten, tree_unflatten
    leaves, treedef = tree_flatten(abstract)
    sl = tree_flatten(specs)[0]
    out = []
    for a, s in zip(leaves, sl):
        m, pl = fn(s)
        out.append(_fake_dtensor(tuple(a.shape), a.dtype, m, pl, device))
    return tree_unflatten(treedef, out)


def _batch(cfg, shape, rows: int, dtype=DTYPE, device="cpu"):
    """Fake model inputs of ``shape`` with ``rows`` rows (plain tensors:
    each rank holds its rows)."""
    from repro_torch.models.model import input_specs
    local = dataclasses.replace(shape, global_batch=rows)
    return {k: (torch.zeros(v.shape, dtype=v.dtype, device=device)
                if v.dtype == torch.int32
                else torch.empty(v.shape, dtype=v.dtype, device=device))
            for k, v in input_specs(cfg, local, dtype=dtype).items()}


def build_step(cfg: ModelConfig, shape: InputShape, mesh, mc: MeshConfig,
               step_kind: str, idx_tree=None, dtype=DTYPE, device="cpu"):
    """``(fn, args)``: the step of one combination and its arguments, the
    counterpart of JAX's ``build_lowerable``.  Call it under an active
    ``FakeTensorMode`` (with ``allow_non_fake_inputs``: the mask's indices
    are real) and a fake group of ``mc``'s size; ``idx_tree`` is the
    mask's concrete indices (:func:`abstract_mask` and
    ``concrete_balanced_mask_like``, made outside the fake mode) for the
    ZO steps; ``dtype`` the parameters', embeddings' and caches';
    ``device`` where a real run (not fake) puts them."""
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    from repro_torch.models.init import abstract_params
    from repro_torch.sharding.fl import FLShardPlan, compute_placements
    from repro_torch.sharding.rules import param_specs, to_placements
    ctx = make_ctx(cfg, shape, mesh, mc)
    ap = abstract_params(cfg, dtype=dtype)
    dp = mc.data * mc.pods
    if step_kind in ("zo_fl", "zo_dp"):
        from repro_torch.core.fl_step import make_fl_train_step
        from repro_torch.core.prng import key
        from repro_torch.core.spaces import MaskedSpace
        rule = "tp"
        if step_kind == "zo_dp":
            rule = "fsdp"
            ctx = dataclasses.replace(ctx, batch_axes=tuple(mc.axis_names),
                                      use_sharded_moe=False,
                                      attn_backend="online", attn_q_block=512)
        plan = FLShardPlan(mesh, mc, rule)
        specs = plan.param_specs(ap)
        params = _placed(ap, specs, mesh,
                         lambda s: (mesh, to_placements(s, mesh)), device)
        n = plan.dp
        n_clients = n if shape.global_batch % n == 0 else 1
        batch = _batch(cfg, shape, shape.global_batch, dtype, device)
        if device != "cpu":
            from repro_torch.utils.tree import tree_map
            idx_tree = tree_map(lambda t: t.to(device), idx_tree)
        step = make_fl_train_step(
            lambda p, b: T.lm_loss(p, b, cfg, ctx, per_example=True),
            MaskedSpace(idx_tree), eps=FL_EPS, lr=FL_LR,
            n_clients=n_clients, constrain_params=plan.constrain_params_fn(),
            backend="ref")
        k0 = key(0).to(device)
        return (lambda p, b: step(p, k0, b)), (params, batch)
    rows = shape.global_batch // dp if not ctx.seq_shard else \
        shape.global_batch
    if step_kind == "first_order":
        specs = param_specs(cfg, ap, mc, train=True)
        params = _placed(ap, specs, mesh,
                         lambda s: compute_placements(mesh, s), device)
        batch = _batch(cfg, shape, rows, dtype, device)

        def fo(p, b):
            from repro_torch.utils.tree import tree_leaves, tree_map
            leaves = [t.requires_grad_() for t in tree_leaves(p)]
            loss = T.lm_loss(p, b, cfg, ctx)
            grads = iter(torch.autograd.grad(loss, leaves))
            with torch.no_grad():
                return tree_map(lambda t: t - FL_LR * next(grads), p)
        return fo, (params, batch)
    specs = param_specs(cfg, ap, mc, train=False)
    params = _placed(ap, specs, mesh,
                     lambda s: compute_placements(mesh, s, ctx.seq_shard),
                     device)
    if step_kind == "prefill":
        @torch.no_grad()
        def pf(p, b):
            return D.prefill(p, b, cfg, ctx)
        return pf, (params, _batch(cfg, shape, rows, dtype, device))
    if step_kind == "decode":
        S_tot = shape.seq_len + (cfg.n_patches
                                 if cfg.frontend == "vision_stub" else 0)
        cache = D.init_cache(cfg, rows, S_tot, dtype=dtype, device=device,
                             ctx=ctx)
        token = torch.zeros((rows,), dtype=torch.int32, device=device)

        @torch.no_grad()
        def dec(p, t, c):
            return D.decode_step(p, t, c, cfg, ctx)
        return dec, (params, token, cache)
    raise ValueError(step_kind)


# ------------------------------------------------------------- records ---
def _memory(trace) -> dict:
    """JAX's ``memory_analysis`` keys from one trace's liveness (each value
    freed at its last use, as XLA frees it): the arguments (the call's
    own; the constants it meets inside are left out), the outputs, the
    outputs that are arguments updated in place (alias), and the rest of
    the peak."""
    from repro_torch.analysis import walk
    live = walk.liveness(trace, deaths=False, args_only=True)
    new = {o.sid: o.new_bytes for r in trace.records for o in r.outs
           if o.new_bytes}
    outs = set(trace.outputs)
    alias = sum(trace.roots[s] for s in outs if s in trace.args)
    out_b = alias + sum(new.get(s, 0) for s in outs if s not in trace.roots)
    arg = live["input_bytes"]
    peak = live["peak_bytes"]
    return {"argument_bytes": int(arg), "output_bytes": int(out_b),
            "temp_bytes": int(max(0, peak - arg - out_b + alias)),
            "alias_bytes": int(alias), "peak_est_bytes": int(peak)}


def trace_step(cfg, shape, mesh, mc, step_kind, idx_tree=None,
               fake: bool = True, dtype=DTYPE, device="cpu"):
    """One recorded run of the combination's step on this rank: fake
    tensors under ``fake`` (the dry run), else real ones (the fake record
    held against a real group's); returns (trace, seconds)."""
    from repro_torch.analysis import walk
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.time()
    mode = FakeTensorMode(allow_non_fake_inputs=True) if fake else None
    with (mode if fake else contextlib.nullcontext()):
        fn, args = build_step(cfg, shape, mesh, mc, step_kind, idx_tree,
                              dtype, device)
        # without the propagation hook, a warm-up fills DTensor's
        # propagation cache (the ZO steps update their parameters in
        # place, which a second run may repeat)
        trace = walk.record(fn, args, device=device, fake=fake,
                            warmup=not walk.can_quiet_propagation(),
                            max_records=TRACE_MAX_RECORDS)
    if trace.raised:
        raise RuntimeError(trace.raised)
    return trace, time.time() - t0


def counts(trace) -> dict:
    """FLOPs, bytes and collective bytes of one trace."""
    from repro_torch.analysis import walk
    c = walk.cost(trace)
    return {"flops": c["flops"], "bytes": c["bytes"],
            "coll": walk.collective_bytes(trace)}


def mask_indices(cfg: ModelConfig, seed: int = 0, dtype=DTYPE):
    """The dry run's mask: :func:`core.masks.abstract_mask` at
    ``MASK_DENSITY``, drawn concrete (``concrete_balanced_mask_like``);
    returns (idx tree, eff_density)."""
    from repro_torch.core.masks import (abstract_mask,
                                        concrete_balanced_mask_like)
    from repro_torch.models.init import abstract_params
    ap = abstract_params(cfg, dtype=dtype)
    idx, eff = abstract_mask(ap, density=MASK_DENSITY)
    return concrete_balanced_mask_like(idx, ap, seed=seed), eff


def run_combo(arch: str, shape_name: str, multi_pod: bool,
              step_kind: Optional[str] = None, fit: bool = True,
              verbose: bool = True, full: bool = False, mc=None,
              dtype=DTYPE, full_budget: int = FULL_TRACE_RECORDS) -> dict:
    """The record of one combination (JAX's keys: ``dryrun.py:206-261``,
    plus ``full_depth`` and the fit's ``fit_extrapolation`` and
    ``fit_exact``).  ``full`` traces the full depth whatever its size.
    ``arch`` and ``shape_name`` are registry names, or a ``ModelConfig``
    and an ``InputShape`` (the tests' small ones); ``mc`` a mesh other
    than the production one, ``dtype`` another than bf16, and
    ``full_budget`` the estimated ops past which the full depth is not
    traced."""
    from repro_torch.analysis import walk
    from repro_torch.launch.mesh import fake_mesh, mesh_config
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = get_shape(shape_name) if isinstance(shape_name, str) \
        else shape_name
    mc = mc or mesh_config(multi_pod=multi_pod)
    step_kind = step_kind or STEP_FOR_SHAPE[shape.kind]
    rec = {"arch": cfg.name, "shape": shape.name,
           "mesh": "multi" if multi_pod else "single",
           "step": step_kind, "ok": False,
           "n_params": param_count(cfg),
           "n_active_params": active_param_count(cfg),
           "n_devices": mc.n_devices}
    if not applicable(cfg, shape):
        rec["skipped"] = "long_500k requires a sub-quadratic mixer (DESIGN.md)"
        return rec
    try:
        zo = step_kind in ("zo_fl", "zo_dp")
        nper = cfg.n_periods
        with fake_mesh(mc) as mesh:
            secs, pts = 0.0, {}
            for n in (1, 2):
                cfg_n = _shallow_cfg(cfg, n)
                tr, s = trace_step(cfg_n, shape, mesh, mc, step_kind,
                                   mask_indices(cfg_n, dtype=dtype)[0]
                                   if zo else None, dtype=dtype)
                secs += s
                pts[n] = dict(counts(tr), memory=_memory(tr),
                              records=len(tr.records))
                del tr
                if n == 1 and 2 * pts[n]["records"] > TRACE_MAX_RECORDS:
                    raise walk.TraceBudgetExceeded(
                        f"depth 2 would record about "
                        f"{2 * pts[n]['records']} ops, past "
                        f"{TRACE_MAX_RECORDS}")
            ext = {k: _extrap(pts[1][k], pts[2][k], nper)
                   for k in ("flops", "bytes", "coll", "memory", "records")}
            run_full = full or nper <= 2 or \
                ext["records"] <= full_budget
            if nper <= 2:
                got = pts[nper]
            elif run_full:
                tr, s = trace_step(cfg, shape, mesh, mc, step_kind,
                                   mask_indices(cfg, dtype=dtype)[0]
                                   if zo else None, dtype=dtype)
                secs += s
                got = dict(counts(tr), memory=_memory(tr))
                del tr
            else:
                got = ext
        rec["compile_s"] = round(secs, 1)
        rec["full_depth"] = bool(run_full)
        rec["global_batch"], rec["seq_len"] = shape.global_batch, \
            shape.seq_len
        rec["memory"] = {k: int(v) for k, v in got["memory"].items()}
        rec["cost_full_scan"] = {"flops": got["flops"],
                                 "bytes": got["bytes"]}
        rec["collectives_full_scan"] = dict(got["coll"])
        rec["cost"] = dict(rec["cost_full_scan"])
        rec["collectives"] = dict(got["coll"])
        if fit:
            rec["fit_points"] = {n: {"flops": p["flops"], "bytes": p["bytes"],
                                     "coll": p["coll"]}
                                 for n, p in pts.items()}
            rec["fit_extrapolation"] = {"flops": ext["flops"],
                                        "bytes": ext["bytes"],
                                        "collectives": ext["coll"]}
            if run_full:
                # FLOPs and collectives are linear in depth; the ZO steps'
                # bytes are not quite, as each depth draws its own mask and
                # rank 0's share of it
                rec["fit_exact"] = (ext["flops"] == got["flops"]
                                    and ext["coll"] == got["coll"])
                rec["fit_bytes_rel"] = abs(ext["bytes"] - got["bytes"]) / \
                    max(got["bytes"], 1.0)
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 - record and continue the sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(rec["error"])
    return rec


def _extrap(a, b, n):
    """The depth-n value of a quantity that is a at depth 1 and b at 2,
    linear in depth (dicts key by key)."""
    if isinstance(a, dict):
        return {k: _extrap(a[k], b[k], n) for k in a}
    return a + (b - a) * (n - 1)


def _run_one(args):
    """One combination in a worker process: (path, record)."""
    arch, shape, mp, step, fit, full, path = args
    t0 = time.time()
    rec = run_combo(arch, shape, mp, step_kind=step, fit=fit, full=full)
    rec["wall_s"] = round(time.time() - t0, 1)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path, rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--step", default=None,
                    help="override step kind "
                         "(zo_fl|zo_dp|first_order|prefill|decode)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-fit", action="store_true",
                    help="leave the depth-1/2 points out of the records")
    ap.add_argument("--full", action="store_true",
                    help="trace the full depth whatever its size")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="combinations traced at once, one process each")
    args = ap.parse_args(argv)

    archs = sorted(ASSIGNED) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    todo = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}_{shape}_{'multi' if mp else 'single'}"
                if args.step:
                    tag += f"_{args.step}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path) and not args.force:
                    print(f"[skip] {tag} (cached)")
                    continue
                # the fit traces only serve the single-pod roofline mesh
                todo.append((arch, shape, mp, args.step,
                             (not args.no_fit) and not mp, args.full, path))
    t0 = time.time()
    if args.jobs > 1 and len(todo) > 1:
        import multiprocessing as mp_
        with mp_.get_context("spawn").Pool(args.jobs) as pool:
            done = pool.imap_unordered(_run_one, todo)
            for path, rec in done:
                _say(path, rec)
    else:
        for item in todo:
            print(f"[run ] {os.path.basename(item[-1])} ...", flush=True)
            _say(*_run_one(item))
    print(f"{len(todo)} combinations in {time.time() - t0:.1f} s")


def _say(path, rec):
    status = "ok" if rec["ok"] else ("SKIP" if "skipped" in rec else "FAIL")
    print(f"[{status:4s}] {os.path.basename(path)} wall={rec['wall_s']}s",
          flush=True)


if __name__ == "__main__":
    main()
