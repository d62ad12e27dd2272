"""Serving entry point: continuous-batching generation with one of the port's
architectures (``repro.launch.serve``).

Per-request bucketed prefill into fixed-capacity decode slots, then batched
one-token decode steps over all slots, with mid-decode admission and
per-slot early exit (``serving/engine.py``).  Runs on the CUDA card unless
``--device`` says otherwise.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch tiny
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import TINY, get_config
from repro_torch.models import Model, ModelCtx
from repro_torch.serving.engine import ContinuousBatchingEngine, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny")
    ap.add_argument("--engine", default="continuous",
                    choices=["continuous", "naive"])
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "kernel", "ref"],
                    help="decode-attention route (continuous engine)")
    ap.add_argument("--attn-backend", default="auto",
                    choices=["auto", "kernel", "online", "dense"],
                    help="prefill forward-attention route")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4,
                    help="decode slots (continuous) / batch size (naive)")
    ap.add_argument("--s-max", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    a = ap.parse_args(argv)

    cfg = TINY if a.arch == "tiny" else get_config(a.arch).reduced()
    model = Model(cfg, ctx=ModelCtx(attn_backend=a.attn_backend),
                  device=a.device)
    params = model.init(seed=a.seed)
    print(f"arch={cfg.name} params={model.n_params:,} engine={a.engine} "
          f"device={model.device}")

    rng = np.random.default_rng(a.seed)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(4, 24)))
               for _ in range(a.requests)]
    t0 = time.time()
    if a.engine == "continuous":
        engine = ContinuousBatchingEngine(
            model, params, max_slots=a.max_batch, S_max=a.s_max, bucket=16,
            decode_backend=a.backend, attn_backend=a.attn_backend)
        for p in prompts:
            engine.submit(p, max_new_tokens=a.max_new)
        outs = engine.run()
        stats = engine.stats
    else:
        engine = ServeEngine(model, params, max_batch=a.max_batch, bucket=16)
        for p in prompts:
            engine.submit(p, max_new_tokens=a.max_new)
        outs = engine.flush()
        stats = {}
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    for i, o in enumerate(outs):
        print(f"req {i}: generated {len(o)} tokens: {o.tolist()}")
    n_tok = sum(len(o) for o in outs)
    extra = (f" ttft={stats['ttft_mean_s']:.2f}s "
             f"compiles={stats['compile_misses']}" if stats else "")
    print(f"{n_tok} tokens in {dt:.1f}s ({n_tok / dt:.1f} tok/s,"
          f" {a.engine} batching with cache{extra})")


if __name__ == "__main__":
    main()
