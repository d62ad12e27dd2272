"""Serving engines: generation and continuous batching
(``repro.serving.engine``).

Two layers:

* :func:`generate` + :class:`ServeEngine`: the naive flush engine kept as
  the baseline: collect requests, right-pad to a bucket, run one prefill and
  a fixed-length decode loop for the whole batch (every request rides to
  ``max(max_new_tokens)``).
* :class:`ContinuousBatchingEngine`: fixed-capacity decode *slots* over one
  shared cache.  A wave of queued requests prefills together (bucketed) and
  is copied into free slots, also mid-decode; every decode step advances all
  slots in one batched call, and finished slots retire early (their state
  left as it was by ``decode_step(active=...)``) and free capacity for
  queued requests.

Correctness contract: right-padded batched generation with per-sequence
``lengths`` gives the same greedy tokens as running each request alone
(``models/decode.prefill``), for every cache family.  Token-only requests
to Pixtral and Whisper get zero patch and frame embeddings
(``_frontend_stub``), and Pixtral's patches count against ``S_max``.

The continuous engine keeps the JAX package's ``CompileCache`` and its
keys, ``("prefill", S_pad, g)`` for an admission wave and ``("decode",
n_steps, tailed)`` for a burst, with its ``compile_hits`` /
``compile_misses`` in ``stats``.  Where the JAX package caches a jitted
callable, an entry here is, on the card, a CUDA graph of the wave's
prefill (scatter into the slots included) or of the burst's ``n_steps``
decode steps over static buffers, captured at the key's miss after the
eager call that serves it and replayed at every hit (:class:`GraphedCall`;
one memory pool for all of an engine's graphs); on the CPU it is the eager
callable, and the counters count the same keys.  Decoded tokens stay on
the device until a TTFT or :meth:`run` needs them, so a burst runs without
a host sync per token; a replay's tokens are copied out of its static
output before the next replay.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from collections import deque
from typing import Callable, Dict, Hashable, List, Optional

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.kernels import ops
from repro_torch.models import decode as D
from repro_torch.models import layers as L
from repro_torch.models.model import Model
from repro_torch.utils.device import check_params_on
from repro_torch.utils.tree import tree_leaves


def _frontend_stub(cfg, B: int, device) -> Dict:
    """Zero frontend embeddings (f32) for token-only serving requests:
    Pixtral's patches, Whisper's audio frames."""
    extras = {}
    if cfg.frontend == "vision_stub":
        extras["patch_embeds"] = torch.zeros((B, cfg.n_patches, cfg.d_model),
                                             device=device)
    if cfg.frontend == "audio_stub":
        extras["audio_embeds"] = torch.zeros(
            (B, cfg.encoder.n_frames, cfg.d_model), device=device)
    return extras


def _frontend_extra(cfg) -> int:
    """Cache positions a request's frontend prefix takes (Pixtral's
    patches; Whisper's frames live in the cross-attention cache)."""
    return cfg.n_patches if cfg.frontend == "vision_stub" else 0


def _pick(logits, key, temperature: float):
    """Greedy argmax, or a categorical draw at ``temperature`` (int32)."""
    if temperature > 0:
        tok = prng.categorical(key, logits / temperature)
    else:
        tok = torch.argmax(logits, dim=-1)
    return tok.to(torch.int32)


# ------------------------------------------------------------- generate ----
@torch.no_grad()
def generate(model: Model, params, batch: Dict, max_new_tokens: int,
             S_max: int = 0, temperature: float = 0.0, key=None,
             lengths=None):
    """Prefill the prompt, then decode ``max_new_tokens`` greedily (or with
    temperature sampling).  Returns int32 [B, max_new_tokens] on the model's
    device.

    ``lengths``: per-row valid token counts of a right-padded batch (see
    ``models/decode.prefill``)."""
    S = batch["tokens"].shape[1]
    S_max = S_max or (S + _frontend_extra(model.cfg) + max_new_tokens)
    logits, cache = model.prefill(params, batch, S_max=S_max, lengths=lengths)
    key = key if key is not None else prng.key(0)
    toks = []
    for _ in range(max_new_tokens):
        key, sub = prng.split(key)
        tok = _pick(logits, sub, temperature)
        logits, cache = model.decode_step(params, tok, cache)
        toks.append(tok)
    return torch.stack(toks, dim=1)


# ------------------------------------------------------- compile cache -----
class CompileCache:
    """Shape-keyed cache of callables with hit/miss counters (the JAX
    package's ``CompileCache``).

    The counters are the steady-state guarantee: once every shape bucket
    has been seen, ``misses`` must stop growing."""

    def __init__(self):
        self._fns: Dict[Hashable, Callable] = {}
        self.hits = 0
        self.misses = 0

    def get(self, key: Hashable, build: Callable[[], Callable]) -> Callable:
        fn = self._fns.get(key)
        if fn is None:
            self.misses += 1
            fn = self._fns[key] = build()
        else:
            self.hits += 1
        return fn

    @property
    def n_entries(self) -> int:
        return len(self._fns)


class GraphedCall:
    """A cache entry on the card: ``body(**inputs)`` as a CUDA graph over
    static input buffers.  ``body`` reads and writes the engine's state (its
    cache leaves and ``last_logits``) in place and allocates nothing that
    outlives it but its return value.

    The first call (the key's miss) copies its tensor inputs into fresh
    static buffers, runs ``body`` eagerly on them and returns that result;
    then it captures ``body`` over the same buffers into a graph in
    ``pool`` (capture runs nothing).  Each later call (a hit) copies its
    inputs into the buffers and replays the graph; the returned tensors are
    the graph's static outputs, overwritten by its next replay, and
    ``pool``'s graphs share memory, so a caller copies out what it keeps
    before any graph of the pool replays again.  A graph that fails to
    capture raises: nothing falls back to the eager call.

    The kernel wrappers count their launches in Python, and a replay calls
    none: the counts the capture added are taken back and added again on
    each replay, so they stay the eager route's.  Python's cyclic garbage
    collector is held off during a capture: an engine and its entries form
    a cycle, and a dead engine's graphs collected mid-capture would free
    their pool there, which invalidates the capture."""

    def __init__(self, body: Callable, pool):
        self.body = body
        self.pool = pool
        self.graph = None
        self.static: Dict[str, torch.Tensor] = {}
        self.out = None
        self.launches: Dict[str, int] = {}
        self.capture_s = 0.0

    def __call__(self, **inputs):
        if self.graph is None:
            return self._first(inputs)
        for name, t in self.static.items():
            t.copy_(inputs[name])
        self.graph.replay()
        for fn in ops.KERNEL_WRAPPERS:
            fn.launches += self.launches[fn.__name__]
        return self.out

    def _first(self, inputs):
        self.static = {k: v.clone() for k, v in inputs.items()
                       if v is not None}
        args = {k: self.static.get(k) for k in inputs}
        out = self.body(**args)  # serves the miss
        torch.cuda.synchronize()  # its device time is not the capture's
        t0 = time.perf_counter()
        before = ops.launches()
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                self.out = self.body(**args)
        finally:
            if collecting:
                gc.enable()
            after = ops.launches()
            for fn in ops.KERNEL_WRAPPERS:
                fn.launches = before[fn.__name__]
        self.launches = {k: after[k] - before[k] for k in after}
        self.graph = graph
        self.capture_s = time.perf_counter() - t0
        return out


# ------------------------------------------------------- naive engine ------
class ServeEngine:
    """Minimal batched-request engine (the naive baseline): collects
    requests up to a batch size, right-pads prompts to a bucket, runs one
    prefill and a fixed-length decode for the whole batch."""

    def __init__(self, model: Model, params, max_batch: int = 8,
                 bucket: int = 64):
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.bucket = bucket
        self.queue = []

    def submit(self, tokens: np.ndarray, max_new_tokens: int = 16):
        self.queue.append((np.asarray(tokens, np.int32), max_new_tokens))

    def flush(self):
        """Run all queued requests in padded batches; returns the generated
        tokens (numpy int32) in submit order."""
        out = []
        while self.queue:
            chunk, self.queue = (self.queue[:self.max_batch],
                                 self.queue[self.max_batch:])
            lens = [len(t) for t, _ in chunk]
            S = ((max(lens) + self.bucket - 1) // self.bucket) * self.bucket
            new = max(m for _, m in chunk)
            toks = np.zeros((len(chunk), S), np.int32)
            for i, (t, _) in enumerate(chunk):
                toks[i, :len(t)] = t  # right-pad; masked via lengths
            batch = {"tokens": toks,
                     **_frontend_stub(self.model.cfg, len(chunk),
                                      self.model.device)}
            gen = generate(self.model, self.params, batch, new,
                           lengths=np.asarray(lens, np.int32)).cpu().numpy()
            for i, (_, m) in enumerate(chunk):
                out.append(gen[i, :m])
        return out


# ------------------------------------------- continuous-batching engine ----
@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray
    max_new_tokens: int
    out: List[int] = dataclasses.field(default_factory=list)
    remaining: int = 0
    t_submit: float = 0.0
    t_first: Optional[float] = None  # first-token wall time (TTFT end)


class ContinuousBatchingEngine:
    """Slot-based continuous batching over one fixed-capacity cache.

    * ``max_slots`` decode slots share a [max_slots, S_max] cache; each slot
      tracks its own position (``cache['pos']`` is per-row).
    * Admission: the queued requests that fit the free slots prefill
      together as one wave (prompts right-padded to the wave's largest
      ``bucket`` multiple, exact lengths passed through), and their caches
      and logits are copied into their slots in place (``index_copy_``),
      also into slots freed mid-decode.
    * One decode *burst* advances every slot by a length from the fixed
      ladder ``BURSTS``: while requests queue, up to the smallest remaining
      budget, so a freed slot admits at once; once the queue is empty, up to
      the largest, and slots past their budget freeze mid-burst
      (``active = i < remaining``).  Budgets are host-known, so burst
      scheduling equals stepping one token at a time.
    * ``decode_steps`` counts exactly as the JAX engine's does.

    ``decode_backend`` selects the decode-attention route ("kernel" | "ref"
    | "auto", ``models/layers.resolve_decode_backend``); ``attn_backend``
    the prefill forward-attention route ("kernel" | "online" | "dense" |
    "auto", ``models/layers.resolve_attn_backend``).  The engine runs on
    the model's device and never moves ``params``.

    ``compile_cache`` holds one entry per ``("prefill", S_pad, g)`` and
    ``("decode", n_steps, tailed)`` key, as the JAX engine's does: a CUDA
    graph (:class:`GraphedCall`) where ``graphs`` (default: the device is
    a CUDA card), else the eager callable; :attr:`capture_s` sums the
    host seconds spent capturing.
    """

    BURSTS = (32, 24, 16, 12, 8, 6, 4, 3, 2, 1)  # decode burst lengths

    def __init__(self, model: Model, params, max_slots: int = 4,
                 S_max: int = 128, bucket: int = 16,
                 decode_backend: str = "auto", attn_backend: str = "auto",
                 temperature: float = 0.0, seed: int = 0,
                 graphs: Optional[bool] = None):
        self.model = model
        self.cfg = model.cfg
        L.resolve_decode_backend(decode_backend, self.cfg)  # validates
        L.resolve_attn_backend(attn_backend, self.cfg)
        self.ctx = dataclasses.replace(model.ctx,
                                       decode_backend=decode_backend,
                                       attn_backend=attn_backend)
        self.device = model.device
        check_params_on(params, self.device)
        self.params = params
        self.max_slots = max_slots
        self.S_max = S_max
        self.bucket = bucket
        self.temperature = temperature
        self.cache = D.init_cache(self.cfg, max_slots, S_max,
                                  dtype=params["embed"].dtype,
                                  device=self.device)
        self.last_logits = torch.zeros((max_slots, self.cfg.vocab),
                                       dtype=torch.float32,
                                       device=self.device)
        self.slots: List[Optional[Request]] = [None] * max_slots
        self.pending: deque = deque()
        self.done: Dict[int, Request] = {}
        self._next_rid = 0
        # the sampling key lives on the device: a burst splits it there, so
        # a graph reads it from a static buffer and no step syncs the host
        self._key = prng.key(seed).to(self.device)
        self.n_decode_steps = 0
        self.graphs = self.device.type == "cuda" if graphs is None else graphs
        if self.graphs and self.device.type != "cuda":
            raise ValueError("CUDA graphs need the engine on a CUDA device")
        self._pool = torch.cuda.graph_pool_handle() if self.graphs else None
        self.compile_cache = CompileCache()
        self.prefill_waves: List[tuple] = []  # (requests, padded length)
        # bursts whose token values have not been fetched yet: scheduling
        # never reads token values, so fetches wait until a TTFT needs
        # recording or results are collected
        self._deferred: List = []

    # ---------------------------------------------------------- submit ----
    def submit(self, tokens: np.ndarray, max_new_tokens: int = 16) -> int:
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        budget = self.S_max - _frontend_extra(self.cfg) - max_new_tokens
        if len(tokens) > budget:
            raise ValueError(
                f"prompt of {len(tokens)} tokens + {max_new_tokens} new "
                f"exceeds S_max={self.S_max}")
        req = Request(rid=self._next_rid, tokens=tokens,
                      max_new_tokens=max_new_tokens,
                      remaining=max_new_tokens, t_submit=time.perf_counter())
        self._next_rid += 1
        self.pending.append(req)
        return req.rid

    # --------------------------------------------------- cached entries ----
    def _entry(self, key: tuple, body: Callable) -> Callable:
        """The compile cache's callable for ``key``: a :class:`GraphedCall`
        of ``body`` on the card (``graphs``), else ``body``."""
        def build():
            return GraphedCall(body, self._pool) if self.graphs else body
        return self.compile_cache.get(key, build)

    @property
    def capture_s(self) -> Dict[str, float]:
        """Host seconds spent capturing graphs, by kind of key."""
        out = {"prefill": 0.0, "decode": 0.0}
        for key, fn in self.compile_cache._fns.items():
            if isinstance(fn, GraphedCall):
                out[key[0]] += fn.capture_s
        return out

    def _prefill_fn(self, S_pad: int, g: int) -> Callable:
        """Prefill-into-slots of one wave of ``g`` prompts padded to
        ``S_pad``: the prefill, then its caches and logits copied into the
        slots (``index_copy_`` into the engine's leaves, in place).  Takes
        ``tokens`` [g, S_pad] int32, ``lengths`` [g] int32 and ``slots``
        [g] int64 on the device."""
        cfg, S_max = self.cfg, self.S_max

        def body(tokens, lengths, slots):
            batch = {"tokens": tokens,
                     **_frontend_stub(cfg, g, self.device)}
            logits, sub = D.prefill(self.params, batch, cfg, self.ctx,
                                    S_max=S_max, lengths=lengths)
            for big, small in zip(tree_leaves(self.cache["stack"]),
                                  tree_leaves(sub["stack"])):
                big.index_copy_(1, slots, small.to(big.dtype))
            self.cache["pos"].index_copy_(0, slots, sub["pos"])
            self.last_logits.index_copy_(0, slots, logits)
        return self._entry(("prefill", S_pad, g), body)

    def _decode_fn(self, n_steps: int, tailed: bool) -> Callable:
        """A burst of ``n_steps`` decode steps from ``last_logits``; with
        ``tailed``, ``remaining`` ([B] int32 on the device) freezes slot b
        from step ``remaining[b]`` on; with temperature sampling ``key``
        ([2] on the device) is the burst's key.  Leaves the last logits in
        ``last_logits`` and the positions in ``cache["pos"]`` (in place:
        ``decode_step`` rebinds the position) and returns the tokens
        [n_steps, B]."""
        def body(remaining=None, key=None):
            logits, toks = self.last_logits, []
            cache = dict(self.cache)
            for i in range(n_steps):
                sub = None
                if self.temperature > 0:
                    key, sub = prng.split(key)
                tok = _pick(logits, sub, self.temperature)
                active = (i < remaining) if tailed else None
                logits, cache = D.decode_step(self.params, tok, cache,
                                              self.cfg, self.ctx,
                                              active=active)
                toks.append(tok)
            self.last_logits.copy_(logits)
            self.cache["pos"].copy_(cache["pos"])
            return torch.stack(toks)
        return self._entry(("decode", n_steps, tailed), body)

    # ------------------------------------------------------------ step ----
    def _admit(self):
        free = [i for i, r in enumerate(self.slots) if r is None]
        take = min(len(free), len(self.pending))
        if not take:
            return
        items = [(self.pending.popleft(), free[i]) for i in range(take)]
        # one prefill per admission wave: everyone pads to the wave's
        # largest bucket; right-pad masking keeps the extra columns inert
        g = len(items)
        S_pad = max(-(-max(len(req.tokens), 1) // self.bucket) * self.bucket
                    for req, _ in items)
        toks = np.zeros((g, S_pad), np.int32)
        for i, (req, _) in enumerate(items):
            toks[i, :len(req.tokens)] = req.tokens
        lengths = torch.as_tensor(
            np.array([len(r.tokens) for r, _ in items], np.int32),
            device=self.device)
        slots = torch.as_tensor(np.array([s for _, s in items], np.int64),
                                device=self.device)
        self._prefill_fn(S_pad, g)(
            tokens=torch.as_tensor(toks, device=self.device),
            lengths=lengths, slots=slots)
        self.prefill_waves.append((g, S_pad))
        for req, slot in items:
            self.slots[slot] = req

    def _decode(self, n_steps: int, remaining, key):
        """``n_steps`` decode steps from ``last_logits`` (``remaining``: [B]
        int32 on the device, or None for a burst where every slot stays
        live; ``key``: the burst's sampling key, or None).  Returns the
        tokens [n_steps, B] on the device, copied out of a graph's static
        output."""
        toks = self._decode_fn(n_steps, remaining is not None)(
            remaining=remaining, key=key)
        return toks.clone() if self.graphs else toks

    @torch.no_grad()
    def step(self) -> bool:
        """Admit pending requests into free slots, then advance every
        active slot by one decode burst.  Returns False when drained."""
        self._admit()
        reqs = [r for r in self.slots if r is not None]
        if not reqs:
            return False
        lo = min(r.remaining for r in reqs)
        k = lo if self.pending else max(r.remaining for r in reqs)
        burst = next(b for b in self.BURSTS if b <= k)
        # the uniform burst (no per-step masking) needs every slot live for
        # the whole burst: no budget runs out mid-burst and no empty slot
        # decodes placeholder tokens
        tailed = burst > lo or len(reqs) < self.max_slots
        remaining = None
        if tailed:
            remaining = torch.as_tensor(
                np.array([r.remaining if r is not None else 0
                          for r in self.slots], np.int32),
                device=self.device)
        key = None
        if self.temperature > 0:
            self._key, key = prng.split(self._key)
        toks = self._decode(burst, remaining, key)
        self.n_decode_steps += burst
        first_timers = any(r is not None and r.t_first is None
                           for r in self.slots)
        takes = []
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            take = min(burst, req.remaining)
            takes.append((req, slot, take))
            req.remaining -= take
            if req.remaining == 0:
                self.done[req.rid] = req
                self.slots[slot] = None  # early exit: slot freed mid-decode
        self._deferred.append((toks, takes))
        if first_timers:
            self._collect()  # block now: these requests' TTFT ends here
        return True

    def _collect(self):
        """Bring deferred burst tokens to the host (waits for the device)."""
        for toks, takes in self._deferred:
            toks_np = toks.cpu().numpy()  # [burst, B]
            now = time.perf_counter()
            for req, slot, take in takes:
                if req.t_first is None:
                    req.t_first = now
                req.out.extend(int(t) for t in toks_np[:take, slot])
        self._deferred.clear()

    def run(self) -> List[np.ndarray]:
        """Drain queue and slots; returns the tokens of the requests this
        call completed, in submit order (a reused engine keeps earlier
        waves in ``done`` for stats but does not return them again)."""
        already = set(self.done)
        while self.step():
            pass
        self._collect()
        return [np.asarray(self.done[rid].out, np.int32)
                for rid in sorted(self.done) if rid not in already]

    # ------------------------------------------------------------ stats ----
    @property
    def stats(self) -> Dict[str, float]:
        reqs = self.done.values()
        ttfts = [r.t_first - r.t_submit for r in reqs if r.t_first is not None]
        return {
            "completed": len(self.done),
            "decode_steps": self.n_decode_steps,
            "compile_hits": self.compile_cache.hits,
            "compile_misses": self.compile_cache.misses,
            "ttft_mean_s": float(np.mean(ttfts)) if ttfts else 0.0,
        }
