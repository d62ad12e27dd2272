"""End-to-end federated fine-tuning on the PyTorch port: a llama-style model
of millions of parameters for a few hundred steps.

    PYTHONPATH=src python examples/train_e2e_torch.py            # ~8M, card
    PYTHONPATH=src python examples/train_e2e_torch.py --large    # ~110M
    PYTHONPATH=src python examples/train_e2e_torch.py --rounds 2 --T 2 \\
        --device cpu --ckpt /tmp/e2e_ckpt_torch.msgpack           # CI smoke

``examples/train_e2e.py`` step for step, through ``repro_torch``: model
init, sensitivity-mask calibration on the C4-proxy corpus, Dirichlet
Non-IID partition, MEERKAT-VP GradIP calibration and early stopping, T>1
rounds with virtual-path aggregation, a checkpoint in the port's own
MessagePack codec (``repro_torch.checkpoint.io``), and the final
evaluation from it.  Runs on the CUDA card unless ``--device cpu``.
"""
import argparse
import os
import time

import numpy as np

from repro_torch.checkpoint.io import load_pytree, save_pytree
from repro_torch.configs.base import FLConfig, ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import (Client, FederatedZO, pretrain_gradient_vec,
                              sensitivity_mask)
from repro_torch.data import (TaskSpec, dirichlet_partition, make_task_fns,
                              pretrain_batches, sample_dataset,
                              single_label_partition, subset)
from repro_torch.models import Model
from repro_torch.utils.device import resolve_device

SMALL = ModelConfig(name="llama-8m", family="dense", n_layers=4, d_model=256,
                    n_heads=4, n_kv_heads=2, d_ff=704, vocab=2048,
                    tie_embeddings=True, source="llama-3.2 family, CPU-scaled")
LARGE = ModelConfig(name="llama-110m", family="dense", n_layers=12,
                    d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
                    vocab=32_000, tie_embeddings=True,
                    source="llama-3.2 family, 100M-class")


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--large", action="store_true")
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--T", type=int, default=10)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--density", type=float, default=5e-3)
    ap.add_argument("--lr", type=float, default=5e-2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default="runs/e2e_ckpt_torch.msgpack")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def run(args, *, params=None, device=None):
    """The example's steps; ``params`` (a tree of numpy arrays) replaces
    the seeded initial weights.  Returns what it printed and its final
    state."""
    a = args
    device = resolve_device(device if device is not None else a.device)
    cfg = LARGE if a.large else SMALL
    spec = TaskSpec(vocab=cfg.vocab, seq_len=32, topic_tokens=64)
    model = Model(cfg, device=device)
    params = (model.init(seed=a.seed) if params is None
              else params_from_numpy(params, device))
    print(f"{cfg.name}: {model.n_params:,} params")
    loss, per_example, evaluate = make_task_fns(model, spec)
    lm = lambda p, b: model.loss(p, b)

    t0 = time.time()
    pre = pretrain_batches(spec, n_batches=4, batch_size=8, seed=a.seed + 3)
    space = sensitivity_mask(lm, params, pre, density=a.density,
                             device=device)
    print(f"sensitivity mask: {space.n:,} coords ({time.time() - t0:.0f}s)")

    train = sample_dataset(spec, 4096, seed=a.seed + 1)
    nb = a.clients * 3 // 4
    parts = (dirichlet_partition(train["label"], nb, alpha=0.5, seed=a.seed)
             + single_label_partition(train["label"], a.clients - nb,
                                      seed=a.seed + 1))
    clients = [Client(k, subset(train, p), a.batch)
               for k, p in enumerate(parts)]
    ev = sample_dataset(spec, 512, seed=a.seed + 2)
    eval_batch = {k: np.asarray(v) for k, v in ev.items()}

    fl = FLConfig(n_clients=a.clients, local_steps=a.T, lr=a.lr, eps=1e-3,
                  density=a.density, seed=a.seed, batch_size=a.batch,
                  vp_calibration_steps=100, vp_init_steps=20,
                  vp_later_steps=20, vp_rho_later=2.0,
                  vp_sigma=0.25, vp_sigma_relative=True)
    server = FederatedZO(loss, params, space, fl, clients, eval_fn=evaluate,
                         device=device)

    # MEERKAT-VP: GradIP calibration -> flag extreme Non-IID clients
    gp = pretrain_gradient_vec(lm, params, space, pre)
    _, flagged, trajectories = server.calibrate_vp(gp)
    print(f"VPCS early-stopped clients: {flagged} "
          f"(true extremes: {list(range(nb, a.clients))})")

    m0 = evaluate(params, eval_batch)
    print(f"round 0: acc={float(m0['acc']):.3f}")
    history = server.run(a.rounds, eval_every=max(1, a.rounds // 6),
                         eval_batch=eval_batch, verbose=True)

    os.makedirs(os.path.dirname(a.ckpt) or ".", exist_ok=True)
    save_pytree(a.ckpt, server.params)
    restored = load_pytree(a.ckpt, server.params)
    m = evaluate(restored, eval_batch)
    total_steps = a.rounds * a.T
    print(f"final (from checkpoint): acc={float(m['acc']):.3f} after "
          f"{total_steps} local steps x {a.clients} clients "
          f"({time.time() - t0:.0f}s)")
    dense_down = 4 * model.n_params * a.rounds * a.clients
    print(f"comm: up={server.comm.up_bytes}B down={server.comm.down_bytes}B "
          f"(dense refresh would be {dense_down:,}B down)")
    return {"n_params": model.n_params, "mask_n": space.n,
            "flagged": list(flagged), "trajectories": trajectories,
            "acc_before": float(m0["acc"]), "history": history,
            "acc_final": float(m["acc"]), "params": server.params,
            "restored": restored, "ckpt": a.ckpt,
            "up_bytes": server.comm.up_bytes,
            "down_bytes": server.comm.down_bytes}


def main(argv=None):
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
