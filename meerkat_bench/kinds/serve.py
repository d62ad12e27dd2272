"""A serving cell: an open loop of users against the program's
``ContinuousBatchingEngine`` (``submit``/``step``), at the rate the
workload fixes.

Set-up makes the weights from the seed, builds the engine, captures every
key the traffic can reach (each prefill bucket at each wave size up to
``admit_per_step``, each decode burst tailed and not), then runs the
loop for ``warm_s`` seconds, so the window starts in steady state.
Requests arrive on their schedule; at most ``admit_per_step`` wait in the
engine's queue at a step, so no wave is larger than the keys captured,
and the rest wait in the users' queue.  A request is timed from when it
was due, so every wait counts.  After the window the program's state is
freed and the plain reference scores a sample of the finished requests'
served tokens.
"""
from __future__ import annotations

import sys
import time
from collections import deque

import numpy as np
import torch

from meerkat_bench import flops, weights
from meerkat_bench.trace import DeviceTrace, Spans
from meerkat_bench.traffic import serve as traffic


class Loop:
    """The schedule, the users' queue, the engine and the per-request
    record."""

    def __init__(self, h, eng, arrivals, t_start: float):
        self.eng, self.arrivals, self.t_start = eng, arrivals, t_start
        self.queue = deque()        # (due, tokens, n_out) not yet sent
        self.info = {}              # rid -> [Request, due, P, sent]
        self.done_seen = 0
        self.completed_at = {}      # rid -> host time its step returned
        self.cap = h.wl["admit_per_step"]

    def arrive(self, now: float):
        while self.t_start + self.arrivals.peek() <= now:
            due, toks, n_out = self.arrivals.next()
            self.queue.append((self.t_start + due, toks, n_out))

    def step(self):
        now = time.perf_counter()
        self.arrive(now)
        while self.queue and len(self.eng.pending) < self.cap:
            due, toks, n_out = self.queue.popleft()
            rid = self.eng.submit(toks, n_out)
            self.info[rid] = [self.eng.pending[-1], due, len(toks), now]
        if not self.eng.step():     # idle: wait for the next arrival
            wait = self.t_start + self.arrivals.peek() - time.perf_counter()
            time.sleep(min(max(wait, 0.0), 0.002))
        done = list(self.eng.done)
        now = time.perf_counter()
        for rid in done[self.done_seen:]:
            self.completed_at[rid] = now
        self.done_seen = len(done)

    def out_lengths(self):
        return {rid: len(r[0].out) for rid, r in self.info.items()}

    def ttft(self, t0: float, t1: float) -> list:
        """Seconds from due to first token of every request due in
        [t0, t1]; one with no first token by t1 counts what it waited."""
        self.arrive(t1)
        out = []
        for req, due, _, _ in self.info.values():
            if t0 <= due <= t1:
                first = req.t_first
                out.append((first if first is not None and first <= t1
                            else t1) - due)
        out += [t1 - due for due, _, _ in self.queue if t0 <= due <= t1]
        return out


def warm_keys(eng, wl):
    """Capture every prefill and decode key the traffic can reach, on
    placeholder inputs (the slots' state is overwritten at admission)."""
    dev = eng.device
    top = -(-wl["prompt"]["max"] // eng.bucket) * eng.bucket
    for S_pad in range(eng.bucket, top + 1, eng.bucket):
        for g in range(1, wl["admit_per_step"] + 1):
            eng._prefill_fn(S_pad, g)(
                tokens=torch.zeros((g, S_pad), dtype=torch.int32, device=dev),
                lengths=torch.full((g,), S_pad, dtype=torch.int32,
                                   device=dev),
                slots=torch.arange(g, dtype=torch.int64, device=dev))
    zeros = torch.zeros(eng.max_slots, dtype=torch.int32, device=dev)
    for n in eng.BURSTS:
        for tailed in (False, True):
            eng._decode(n, zeros if tailed else None, None)
    eng.slots = [None] * eng.max_slots


def instrument(h, loop):
    """Device spans and the needed work around the engine's admission and
    decode bursts (traced runs)."""
    eng, m, spans = loop.eng, h.m, h.spans
    admit, decode = eng._admit, eng._decode
    D, H, KV, hd, F, L, V = flops.dims(m)
    work = h.facts.setdefault("traced", {"flops": 0.0, "decode_bytes": 0.0})

    def counting():
        return h.tracer is not None and h.tracer.prof is not None

    def timed_admit():
        free = sum(r is None for r in eng.slots)
        take = min(free, len(eng.pending))
        if counting():
            for r in list(eng.pending)[:take]:
                work["flops"] += flops.prefill_flops(m, len(r.tokens))
        with DeviceTrace.label("bench.admit"), \
                spans.device_span("prefill", weight=take):
            return admit()

    def timed_decode(n_steps, remaining, key):
        if counting():
            for r in eng.slots:
                if r is None:
                    continue
                k = r.max_new_tokens - r.remaining   # tokens out before
                P = len(r.tokens)
                for i in range(min(n_steps, r.remaining)):
                    keys = P + k + i + 1
                    work["decode_bytes"] += L * flops.decode_attn_bytes(
                        keys, KV, hd, H)
                    if i < r.remaining - 1:   # its logits yield a token
                        work["flops"] += flops.decode_flops(m, keys)
        with DeviceTrace.label("bench.decode"), \
                spans.device_span("decode", weight=n_steps):
            return decode(n_steps, remaining, key)

    eng._admit = timed_admit
    eng._decode = timed_decode


def build(h, rate: float):
    """The engine with every key captured, and the loop at ``rate``."""
    from repro_torch.configs import ModelConfig
    from repro_torch.models import Model
    from repro_torch.serving.engine import ContinuousBatchingEngine

    wl, m, dev = h.wl, h.m, h.device
    w_seed, t_seed, s_seed = h.seeds(3)
    model = Model(ModelConfig(name=h.cfg["name"], family="dense", **m),
                  device=dev)
    params = weights.make(m, w_seed, dev)
    eng = ContinuousBatchingEngine(model, params,
                                   max_slots=wl["max_slots"],
                                   S_max=wl["S_max"], bucket=wl["bucket"])
    del params
    warm_keys(eng, wl)
    arrivals = traffic.Arrivals(wl, m["vocab"], t_seed, rate)
    return eng, Loop(h, eng, arrivals, time.perf_counter()), w_seed, s_seed


def window(h, loop, seconds: float, trace: bool = False) -> dict:
    """Run the loop for ``seconds``; the window's numbers."""
    eng, wl = loop.eng, h.wl
    misses0 = eng.compile_cache.misses
    before = loop.out_lengths()
    t0 = time.perf_counter()
    t_trace, t_trace_end = t0 + wl["trace_at_s"], None
    while time.perf_counter() - t0 < seconds:
        if trace and h.tracer is None and time.perf_counter() >= t_trace:
            h.tracer = DeviceTrace()
            h.tracer.start()
            t_trace_end = time.perf_counter() + wl["trace_s"]
        loop.step()
        if h.tracer is not None and h.tracer.prof is not None \
                and time.perf_counter() >= t_trace_end:
            h.tracer.stop()
    eng._collect()
    sync(h)
    t1 = time.perf_counter()
    if h.tracer is not None and h.tracer.prof is not None:
        h.tracer.stop()
    after = loop.out_lengths()
    ttft = loop.ttft(t0, t1)
    late = [sent - due for _, due, _, sent in loop.info.values()
            if t0 <= due <= t1]
    return {"t0": t0, "t1": t1, "window_s": t1 - t0,
            "tokens": sum(n - before.get(r, 0) for r, n in after.items()),
            "ttft": ttft, "requests": len(ttft),
            "finished": [r for r, t in loop.completed_at.items()
                         if t0 <= t <= t1],
            "backlog": len(loop.queue) + len(eng.pending)
            + sum(r is not None for r in eng.slots),
            "late_s_max": max(late, default=0.0),
            "misses_in_window": eng.compile_cache.misses - misses0}


def run(h):
    wl = h.wl
    eng, loop, w_seed, s_seed = build(h, wl["rate_per_s"])
    while time.perf_counter() - loop.t_start < wl["warm_s"]:
        loop.step()
    eng._collect()
    h.spans = Spans(h.device)
    if h.trace:
        instrument(h, loop)
        DeviceTrace.warm()
    sync(h)
    h.set_up_done()

    w = window(h, loop, h.seconds, trace=h.trace)
    h.memory_peak = (torch.cuda.max_memory_allocated()
                     if h.device.type == "cuda" else 0)
    h.attempted, h.failed = w["requests"], 0
    pct = wl["ttft_percentile"]
    h.e2e = {f"ttft_ms_p{pct}": float(np.percentile(w["ttft"], pct)) * 1e3,
             "peak_mem_gb": h.memory_peak / 1e9, "setup_s": h.setup_s}
    h.facts.update({k: w[k] for k in ("window_s", "tokens", "requests",
                                      "backlog", "misses_in_window")})
    if h.trace:
        h.facts["prefill_ms"] = h.spans.device_ms("prefill")
        h.facts["decode_ms"] = h.spans.device_ms("decode")
    print(f"serve: {w['requests']} requests due, {len(w['finished'])} "
          f"finished, {w['tokens']} tokens ({w['tokens'] / w['window_s']:.1f}"
          f" tokens/s), backlog {w['backlog']}, latest send "
          f"{w['late_s_max']:.3f} s after due, graph misses in the window "
          f"{w['misses_in_window']}", file=sys.stderr)

    sample = pick(wl, loop, w["finished"], s_seed)
    del loop, eng
    h.free()
    t_check = time.perf_counter()
    check(h, sample, w_seed)
    h.facts["check_s"] = time.perf_counter() - t_check


def sync(h):
    if h.device.type == "cuda":
        torch.cuda.synchronize()


def pick(wl, loop, finished, seed):
    """A sample of the finished requests drawn from the seed, the longest
    among them, until ``check_tokens`` served tokens: [(prompt, served)]."""
    rng = np.random.default_rng(seed)
    if not finished:
        return []
    by_len = sorted(finished, key=lambda r: -(loop.info[r][2]
                                              + len(loop.info[r][0].out)))
    chosen = [by_len[0]]
    rest = [r for r in rng.permutation(finished) if r != by_len[0]]
    served = len(loop.info[by_len[0]][0].out)
    for rid in rest:
        if served >= wl["check_tokens"]:
            break
        chosen.append(int(rid))
        served += len(loop.info[rid][0].out)
    return [(np.asarray(loop.info[r][0].tokens, np.int64),
             np.asarray(loop.info[r][0].out, np.int64)) for r in chosen]


def gaps(h, w, sample, *, lower_first=False):
    """The widest gap by which a served token's logit lies below the
    reference's best at its position; with ``lower_first`` (the control)
    the gap of the token that a TF32 pass puts first, at the same served
    positions."""
    ref = h.reference()
    worst = 0.0
    for prompt, out in sample:
        seq = torch.as_tensor(np.concatenate([prompt, out[:-1]]))
        start = len(prompt) - 1
        lg = ref.served_logits(w, h.m, seq, start)
        if lower_first:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            try:
                pick_ = ref.served_logits(w, h.m, seq, start).argmax(-1)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
        else:
            pick_ = torch.as_tensor(out, device=lg.device)
        best = lg.max(-1).values
        got = lg.gather(1, pick_[:, None].to(lg.device))[:, 0]
        worst = max(worst, float((best - got).max()))
        del lg
    return worst


def check(h, sample, w_seed):
    w = weights.make(h.m, w_seed, h.device)
    gap = gaps(h, w, sample) if sample else float("inf")
    h.checks = [("logit_gap", gap, h.wl["limits"]["logit_gap"])]
    if h.control:
        h.add_control("tf32", {"logit_gap": gaps(h, w, sample,
                                                 lower_first=True)})
