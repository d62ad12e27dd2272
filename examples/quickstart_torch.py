"""Quickstart on the PyTorch port: MEERKAT sparse-ZO federated fine-tuning.

    PYTHONPATH=src python examples/quickstart_torch.py              # the card
    PYTHONPATH=src python examples/quickstart_torch.py --rounds 10 \\
        --device cpu                                               # CI smoke

``examples/quickstart.py`` step for step, through ``repro_torch``: a tiny
decoder LM, the transferable sensitivity mask from a C4-proxy corpus, a
synthetic classification task over 8 Non-IID clients (Dirichlet
alpha=0.5), and high-frequency (T=1) MEERKAT rounds: clients upload one
scalar per step, the server replays their virtual paths and aggregates.
Runs on the CUDA card unless ``--device cpu``; the ZO perturb and update
go through the fused CUDA kernels there (``--zo-backend``: ``kernel`` is
the route JAX calls ``pallas``).
"""
import argparse

import numpy as np

from repro_torch.configs.base import FLConfig
from repro_torch.configs.tiny import TINY
from repro_torch.convert import params_from_numpy
from repro_torch.core import Client, FederatedZO, sensitivity_mask
from repro_torch.data import (TaskSpec, dirichlet_partition, make_task_fns,
                              pretrain_batches, sample_dataset, subset)
from repro_torch.models import Model
from repro_torch.utils.device import resolve_device


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=150)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--zo-backend", default="auto",
                    choices=["auto", "kernel", "ref"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def run(args, *, params=None, device=None):
    """The example's steps; ``params`` (a tree of numpy arrays) replaces
    the seeded initial weights.  Returns what it printed and its final
    state."""
    device = resolve_device(device if device is not None else args.device)
    spec = TaskSpec()
    model = Model(TINY, device=device)
    params = (model.init(seed=0) if params is None
              else params_from_numpy(params, device))
    loss, per_example, evaluate = make_task_fns(model, spec)

    # 1. transferable sparse mask from pre-training-gradient sensitivity
    pre = pretrain_batches(spec, n_batches=8, batch_size=32)
    space = sensitivity_mask(lambda p, b: model.loss(p, b), params, pre,
                             density=1e-2, device=device)
    print(f"mask: {space.n} / {model.n_params} params "
          f"({space.n / model.n_params:.2%} density)")

    # 2. Non-IID clients (Dirichlet alpha=0.5)
    train = sample_dataset(spec, 2048, seed=1)
    parts = dirichlet_partition(train["label"], n_clients=args.clients,
                                alpha=0.5)
    clients = [Client(k, subset(train, p), batch_size=16)
               for k, p in enumerate(parts)]

    # 3. high-frequency MEERKAT (T=1): scalar-only sync every local step
    fl = FLConfig(n_clients=args.clients, local_steps=1, lr=5e-2, eps=1e-3,
                  density=1e-2, zo_backend=args.zo_backend)
    server = FederatedZO(loss, params, space, fl, clients, eval_fn=evaluate,
                         device=device)

    ev = sample_dataset(spec, 512, seed=2)
    eval_batch = {k: np.asarray(v) for k, v in ev.items()}
    m0 = evaluate(params, eval_batch)
    print(f"before: acc={float(m0['acc']):.3f}")
    history = server.run(args.rounds, eval_every=max(1, args.rounds // 3),
                         eval_batch=eval_batch, verbose=True)
    m = evaluate(server.params, eval_batch)
    print(f"after {args.rounds} rounds: acc={float(m['acc']):.3f}  "
          f"(upload/client/round = 4 bytes)")
    return {"mask_n": space.n, "n_params": model.n_params,
            "acc_before": float(m0["acc"]), "acc_after": float(m["acc"]),
            "history": history, "up_bytes": server.comm.up_bytes,
            "params": server.params, "space": space, "server": server,
            "loss": loss}


def main(argv=None):
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
