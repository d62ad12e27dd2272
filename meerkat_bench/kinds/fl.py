"""A federated cell: MEERKAT's rounds through the program's
``FederatedZO.run_round``.

Set-up makes the weights and the traffic from the seed, derives the
sensitivity mask (and, for GradIP, the pre-training gradient) with the
program, builds the server, and drives it through its first
``checked_rounds`` rounds, recording each client's two losses and the
masked coordinates' values after each round; those rounds warm every
shape.  The window runs whole rounds, server work included, until
``--seconds`` have passed.  Then the program's state is freed and the
plain reference repeats the checked rounds from the same seed.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from meerkat_bench import weights
from meerkat_bench.reference import dense_decoder, meerkat
from meerkat_bench.trace import DeviceTrace, Spans
from meerkat_bench.traffic import fl as traffic


def build(h):
    """The program's server from the seed, and what the check needs."""
    from repro_torch.configs import FLConfig, ModelConfig
    from repro_torch.core import (Client, FederatedZO, pretrain_gradient_vec,
                                  sensitivity_mask)
    from repro_torch.data import TaskSpec, make_task_fns
    from repro_torch.models import Model

    wl, m, dev = h.wl, h.m, h.device
    w_seed, t_seed = h.seeds(2)
    model = Model(ModelConfig(name=h.cfg["name"], family="dense", **m),
                  device=dev)
    data = traffic.make(wl, t_seed)
    task = wl["task"]
    spec = TaskSpec(vocab=task["vocab"], n_classes=task["n_classes"],
                    seq_len=task["seq_len"],
                    topic_tokens=task["topic_tokens"], noise=task["noise"],
                    seed=task["class_vocab_seed"])
    loss, _, _ = make_task_fns(model, spec)
    rec = {"on": False, "loss": []}

    def client_loss(p, b):
        v = loss(p, b)
        if rec["on"]:
            rec["loss"].append(v.detach())
        return v

    params = weights.make(m, w_seed, dev)
    fl = wl["fl"]
    flc = FLConfig(n_clients=wl["clients"], local_steps=fl["local_steps"],
                   lr=fl["lr"], eps=fl["eps"], density=fl["density"],
                   seed=h.seed % (1 << 31), batch_size=wl["batch_size"],
                   zo_backend=fl["zo_backend"],
                   sample_frac=fl["sample_frac"], quantize=fl["quantize"])
    lm = lambda p, b: model.loss(p, b)
    space = sensitivity_mask(lm, params, data["pretrain"],
                             density=fl["density"], device=dev)
    gp = (pretrain_gradient_vec(lm, params, space, data["pretrain"])
          if wl["gradip"] else None)
    clients = [Client(k, part, wl["batch_size"])
               for k, part in enumerate(data["parts"])]
    server = FederatedZO(client_loss, params, space, flc, clients,
                         device=dev)
    return dict(server=server, space=space, gp=gp, rec=rec, data=data,
                w_seed=w_seed, fl_seed=flc.seed)


def run(h):
    from repro_torch.core.dispatch import get_backing
    from repro_torch.utils.tree import tree_leaves

    wl = h.wl
    s = build(h)
    server, space, gp, rec = s["server"], s["space"], s["gp"], s["rec"]
    # the checked rounds: the program's own first rounds, recorded
    v = [space.slice(server.params).clone()]
    uploads = {}
    rec["on"] = True
    for r in range(wl["checked_rounds"]):
        for cid, g in server.run_round(gp_vec=gp).items():
            uploads[(r, cid)] = [float(x) for x in np.asarray(g).reshape(-1)]
        v.append(space.slice(server.params).clone())
    rec["on"] = False
    n_pad = get_backing(space, server.params).n_pad
    h.spans = spans = Spans(h.device)
    if h.trace:
        inner = server._run

        def run_client(*a, **k):
            with DeviceTrace.label("bench.client_run"), \
                    spans.device_span("client_run"):
                return inner(*a, **k)
        server._run = run_client
    sync(h)
    if h.trace:
        DeviceTrace.warm()
    h.set_up_done()

    # the window: whole rounds until --seconds have passed
    rounds = clients_run = 0
    traced = None
    t0 = time.perf_counter()
    while True:
        if h.trace and rounds == 0:
            h.tracer = DeviceTrace()
            h.tracer.start()
        t = time.perf_counter()
        with DeviceTrace.label("bench.round"):
            server.run_round(gp_vec=gp)
        spans.host["round"].append(time.perf_counter() - t)
        clients_run += server.last_round_info["n_reporting"]
        if h.tracer is not None and traced is None:
            h.tracer.stop()
            traced = server.last_round_info["n_reporting"]
        rounds += 1
        if time.perf_counter() - t0 >= h.seconds:
            break
    sync(h)
    window = time.perf_counter() - t0
    h.memory_peak = memory_peak(h)
    h.attempted, h.failed = clients_run, 0

    B, S = wl["batch_size"], wl["task"]["seq_len"]
    T = wl["fl"]["local_steps"]
    tokens = clients_run * T * B * S
    h.e2e = {"train_tokens_per_s": tokens / window,
             "peak_mem_gb": h.memory_peak / 1e9, "setup_s": h.setup_s}
    h.facts = {"rounds": rounds, "window_s": window, "n_pad": n_pad,
               "batch": B, "seq_len": S, "local_steps": T,
               "n_classes": wl["task"]["n_classes"],
               "traced_clients": traced, "client_ms": None}
    if h.trace:
        ms = spans.device_ms("client_run")
        h.facts["client_ms"] = [x for x, _ in ms]

    # the program's outputs, then its state freed
    out = {"idx": [i.detach().cpu() for i in tree_leaves(space.idx_tree)],
           "v": [x.cpu() for x in v],
           "loss": [float(x) for x in rec["loss"]], "g": uploads,
           "gradip": {c: [np.asarray(e, np.float64) for e in log]
                      for c, log in server.gradip_log.items()}}
    del server, space, gp, rec, v, s["server"], s["space"], s["gp"]
    h.free()
    t_check = time.perf_counter()
    check(h, out, s["data"], s["w_seed"], s["fl_seed"])
    h.facts["check_s"] = time.perf_counter() - t_check


def sync(h):
    if h.device.type == "cuda":
        torch.cuda.synchronize()


def memory_peak(h) -> int:
    if h.device.type == "cuda":
        return torch.cuda.max_memory_allocated()
    return 0


def reference_rounds(h, data, w_seed, fl_seed, idx, *, half=False,
                     follow=None):
    """The plain reference's mask and checked rounds: (own mask indices,
    the record of ``meerkat.run_rounds``, its coordinates).  ``follow``:
    another side's uploads, which the rounds go on with (see
    ``meerkat.run_rounds``)."""
    wl, m = h.wl, h.m
    w = weights.make(m, w_seed, h.device)
    pre = data["pretrain"]
    sq, mean = meerkat.sensitivity(w, m, pre, dense_decoder.lm_loss)
    own = meerkat.topk_mask(sq, wl["fl"]["density"])
    del sq
    coords = meerkat.Coords(w, idx)
    gp = None
    if wl["gradip"]:
        gp = torch.cat([mean[p].reshape(-1)[i]
                        for p, i in zip(coords.names, coords.idx)])
    del mean
    parts = data["parts"]
    bs = wl["batch_size"]
    if half:   # a fault: half of each batch left out
        bs = bs // 2
    clients = meerkat.Clients(parts, wl["batch_size"])
    C = wl["task"]["n_classes"]

    def task_loss(w_, m_, batch):
        if half:
            batch = {k: v[:bs] for k, v in batch.items()}
        return dense_decoder.task_loss(w_, m_, batch, C)

    fl = dict(wl["fl"], seed=fl_seed)
    rec = meerkat.run_rounds(w, m, coords, clients, fl,
                             wl["checked_rounds"], task_loss, gp, follow)
    return own, rec, coords


def compare(h, coords, prog, ref):
    """The compared numbers of one side (``prog``: loss list, v list,
    gradip dict) against the reference record ``ref``."""
    lr = float(h.wl["fl"]["lr"])
    R = h.wl["checked_rounds"]
    rl = np.array([x for r in ref["loss"] for x in r[2:]])
    pl = np.asarray(prog["loss"], np.float64)
    out = {"loss_gap": float(np.max(np.abs(pl - rl) / np.abs(rl)))
           if len(pl) == len(rl) else float("inf")}
    rg = coords.leaf_norms((ref["v"][1] - ref["v"][0]) / lr)
    pg = coords.leaf_norms((prog["v"][1].to(ref["v"][0].device)
                            - prog["v"][0].to(ref["v"][0].device)) / lr)
    rc = coords.leaf_norms(ref["v"][R] - ref["v"][0])
    pc = coords.leaf_norms(prog["v"][R].to(ref["v"][0].device)
                           - prog["v"][0].to(ref["v"][0].device))
    has = np.array([i.numel() > 0 for i in coords.idx])
    med_g, med_c = np.median(rg[has]), np.median(rc[has])
    # leaves whose reference gradient is nought to rounding are left out
    counted = has & (rg >= 1e-3 * med_g)
    out["grad_gap"] = float(np.max(np.abs(pg - rg)[counted]
                                   / np.maximum(rg, med_g)[counted]))
    out["change_gap"] = float(np.max(np.abs(pc - rc)[counted]
                                     / np.maximum(rc, med_c)[counted]))
    # each uploaded g against the reference's own, over the round's
    # largest |g|; with the int8 uplink, beyond the one grid step by which
    # a rounded upload may lie from the unrounded g
    steps = ref["steps"]       # (round, cid, t, raw, own, used, margin, grid)
    big = {}
    for r, _, _, raw, *_ in steps:
        big[r] = max(big.get(r, 0.0), abs(raw))
    out["g_gap"] = max(max(0.0, abs(used - raw) - (grid or 0.0)) / big[r]
                       for r, _, _, raw, _, used, _, grid in steps)
    if h.wl["gradip"]:
        ri = {(r, c): np.asarray(x) for r, c, x in ref["gradip"]}
        scale = max(float(np.max(np.abs(x))) for x in ri.values())
        gaps = [float(np.max(np.abs(prog["gradip"][c][r] - x)))
                for (r, c), x in ri.items()]
        out["gradip_gap"] = max(gaps) / scale
    return out


def diagnose(h, coords, prog, ref):
    """Where the gaps sit, on standard error: each round's worst loss gap,
    the reference's scalars g, and the leaves' change gaps, worst first."""
    rl = np.array([x for r in ref["loss"] for x in r[2:]])
    pl = np.asarray(prog["loss"], np.float64)
    rounds = np.array([r[0] for r in ref["loss"] for _ in r[2:]])
    if len(pl) == len(rl):
        gap = np.abs(pl - rl) / np.abs(rl)
        print("loss gap by round", [float(gap[rounds == r].max())
                                    for r in sorted(set(rounds))],
              file=sys.stderr)
    print("g by round and client", [[round(float(x), 5) for x in g]
                                     for _, _, g in ref["g"]],
          file=sys.stderr)
    R = h.wl["checked_rounds"]
    dev = ref["v"][0].device
    rc = coords.leaf_norms(ref["v"][R] - ref["v"][0])
    pc = coords.leaf_norms(prog["v"][R].to(dev) - prog["v"][0].to(dev))
    worst = sorted(((abs(p - r) / max(r, 1e-30), n, r) for n, p, r in
                    zip(coords.names, pc, rc) if r > 0), reverse=True)[:4]
    print("change gap by leaf", [(n, f"{g:.2e}", f"{r:.3e}")
                                 for g, n, r in worst], file=sys.stderr)


def check(h, out, data, w_seed, fl_seed):
    own, ref, coords = reference_rounds(h, data, w_seed, fl_seed,
                                        out["idx"], follow=out["g"])
    sizes = [f.numel() for f in coords.flat]
    nums = {"mask_miss": meerkat.mask_miss(out["idx"], own, sizes)}
    nums.update(compare(h, coords, out, ref))
    diagnose(h, coords, out, ref)
    limits = h.wl["limits"]
    h.checks = [(k, v, limits[k]) for k, v in nums.items()]
    if h.control:
        control(h, data, w_seed, fl_seed, out["idx"], own, ref, sizes)


def control(h, data, w_seed, fl_seed, idx, own, ref, sizes):
    """The reference in the program's place, one precision down (TF32),
    and with half of each batch left out: each side's rounds, then the
    float32 reference following its uploads, and the same numbers."""
    for name, tf32, half in (("tf32", True, False),
                             ("half_batch", False, True)):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            own_c, rec, coords = reference_rounds(h, data, w_seed, fl_seed,
                                                  idx, half=half)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        side = {"loss": [x for r in rec["loss"] for x in r[2:]],
                "v": rec["v"], "gradip": {},
                "g": {(r, c): g for r, c, g in rec["g"]}}
        for r, c, x in rec["gradip"]:
            side["gradip"].setdefault(c, {})[r] = np.asarray(x)
        h.free()
        _, ref_f, coords = reference_rounds(h, data, w_seed, fl_seed, idx,
                                            follow=side["g"])
        nums = {"mask_miss": meerkat.mask_miss(own_c, own, sizes)}
        nums.update(compare(h, coords, side, ref_f))
        h.add_control(name, nums)
        h.free()
