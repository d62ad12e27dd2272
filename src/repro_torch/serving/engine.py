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

PyTorch runs eagerly, so the JAX package's ``jit`` cache and its
``CompileCache`` hit/miss counters have no counterpart here and are left
out (``stats`` has no ``compile_hits`` / ``compile_misses``).  A CUDA graph
per ``(burst, tailed)`` is the later analogue of its compiled bursts.
Decoded tokens stay on the device until a TTFT or :meth:`run` needs them, so
a burst runs without a host sync per token.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import prng
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
    """

    BURSTS = (32, 24, 16, 12, 8, 6, 4, 3, 2, 1)  # decode burst lengths

    def __init__(self, model: Model, params, max_slots: int = 4,
                 S_max: int = 128, bucket: int = 16,
                 decode_backend: str = "auto", attn_backend: str = "auto",
                 temperature: float = 0.0, seed: int = 0):
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
        self._key = prng.key(seed)
        self.n_decode_steps = 0
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
        batch = {"tokens": torch.as_tensor(toks, device=self.device),
                 **_frontend_stub(self.cfg, g, self.device)}
        logits, sub = D.prefill(self.params, batch, self.cfg, self.ctx,
                                S_max=self.S_max, lengths=lengths)
        for big, small in zip(tree_leaves(self.cache["stack"]),
                              tree_leaves(sub["stack"])):
            big.index_copy_(1, slots, small.to(big.dtype))
        self.cache["pos"].index_copy_(0, slots, sub["pos"])
        self.last_logits.index_copy_(0, slots, logits)
        self.prefill_waves.append((g, S_pad))
        for req, slot in items:
            self.slots[slot] = req

    def _decode(self, n_steps: int, remaining, key):
        """``n_steps`` decode steps from ``last_logits``; ``remaining`` ([B]
        int32 on the device, or None for a burst where every slot stays
        live) freezes slot b from step ``remaining[b]`` on.  Returns the
        tokens [n_steps, B] on the device."""
        logits, toks = self.last_logits, []
        for i in range(n_steps):
            sub = None
            if self.temperature > 0:
                key, sub = prng.split(key)
            tok = _pick(logits, sub, self.temperature)
            active = None if remaining is None else i < remaining
            logits, self.cache = D.decode_step(self.params, tok, self.cache,
                                               self.cfg, self.ctx,
                                               active=active)
            toks.append(tok)
        self.last_logits = logits
        return torch.stack(toks)

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
            "ttft_mean_s": float(np.mean(ttfts)) if ttfts else 0.0,
        }
