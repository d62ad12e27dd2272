"""Continuous-batching serving on the PyTorch port across architecture
families.

    PYTHONPATH=src python examples/serve_batch_torch.py            # the card
    PYTHONPATH=src python examples/serve_batch_torch.py --device cpu

``examples/serve_batch.py`` step for step, through ``repro_torch``: the
reduced variants of three assigned archs (dense gemma2 with local/global
attention and softcaps, hybrid jamba with Mamba and MoE layers, and
pixtral with the vision-stub frontend) behind the slot-based engine
(``serving/engine.py``): bucketed prefill admits each prompt into a free
decode slot, one step advances all active slots, and finished requests
retire early to make room for the queue.  On the card each admission
wave and decode burst is a CUDA graph, decode attention runs the
flash-decode kernel and Jamba's prefill the selective-scan kernel.  Runs
on the CUDA card unless ``--device cpu``.
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import Model
from repro_torch.serving.engine import ContinuousBatchingEngine
from repro_torch.utils.device import resolve_device


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default="gemma2-27b,jamba-1.5-large-398b,"
                    "pixtral-12b",
                    help="comma-separated registered arch names (reduced "
                         "variants are served)")
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def run(args, *, params=None, device=None):
    """The example's steps; ``params`` ({arch: tree of numpy arrays})
    replaces the seeded initial weights of the archs it names.  Returns
    {arch: its engine, prompts and generations}."""
    device = resolve_device(device if device is not None else args.device)
    rng = np.random.default_rng(0)
    served = {}
    for name in args.archs.split(","):
        cfg = get_config(name).reduced()
        model = Model(cfg, device=device)
        p = (params_from_numpy(params[name], device)
             if params is not None and name in params else model.init(seed=0))
        engine = ContinuousBatchingEngine(model, p, max_slots=4, S_max=96,
                                          bucket=16)
        prompts = []
        for i in range(args.requests):
            prompt = rng.integers(0, cfg.vocab,
                                  size=int(rng.integers(4, 20)))
            prompts.append(prompt)
            engine.submit(prompt, max_new_tokens=args.max_new)
        t0 = time.time()
        outs = engine.run()
        dt = time.time() - t0
        n = sum(len(o) for o in outs)
        s = engine.stats
        print(f"{cfg.name:32s} family={cfg.family:6s} "
              f"{model.n_params / 1e6:6.1f}M params | {len(outs)} reqs, "
              f"{n} tokens in {dt:5.1f}s ({n / dt:5.1f} tok/s, "
              f"{s['decode_steps']} steps, {s['compile_misses']} compiles)")
        print(f"  first generation: {outs[0].tolist()}")
        served[name] = {"engine": engine, "prompts": prompts, "outs": outs,
                        "seconds": dt, "stats": s}
    return served


def main(argv=None):
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
