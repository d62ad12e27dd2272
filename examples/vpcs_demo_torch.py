"""GradIP phenomenon + Virtual-Path Client Selection on the PyTorch port.

    PYTHONPATH=src python examples/vpcs_demo_torch.py              # the card
    PYTHONPATH=src python examples/vpcs_demo_torch.py --steps 60 \\
        --device cpu                                              # CI smoke

``examples/vpcs_demo.py`` step for step, through ``repro_torch``: the
server reconstructs each client's gradient trajectory from uploaded
scalars and shared seeds (the virtual path), computes GradIP against its
pre-training gradient (the ``gradip_reduce`` kernel on the card), and
flags extreme Non-IID clients, printed as ASCII sparklines so the
decay-vs-oscillation signature is visible.  Runs on the CUDA card unless
``--device cpu``.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.configs.tiny import TINY
from repro_torch.convert import params_from_numpy
from repro_torch.core import (Client, analyze_trajectory, gradip_trajectory,
                              make_local_run, pretrain_gradient_vec,
                              round_keys, sensitivity_mask)
from repro_torch.data import (TaskSpec, dirichlet_partition, make_task_fns,
                              pretrain_batches, sample_dataset,
                              single_label_partition, subset)
from repro_torch.models import Model
from repro_torch.utils.device import resolve_device

BARS = " .:-=+*#%@"


def spark(x, width=60):
    x = np.asarray(x, np.float64)
    x = np.abs(x)
    bins = np.array_split(x, width)
    m = np.array([b.mean() for b in bins])
    m = m / (m.max() + 1e-12)
    return "".join(BARS[int(v * (len(BARS) - 1))] for v in m)


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200,
                    help="calibration-phase local steps (T)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def run(args, *, params=None, device=None):
    """The example's steps; ``params`` (a tree of numpy arrays) replaces
    the seeded initial weights.  Returns what it printed: each client's
    GradIP trajectory and VPCS result."""
    device = resolve_device(device if device is not None else args.device)
    spec = TaskSpec()
    model = Model(TINY, device=device)
    params = (model.init(seed=0) if params is None
              else params_from_numpy(params, device))
    loss, _, _ = make_task_fns(model, spec)
    lm = lambda p, b: model.loss(p, b)

    pre = pretrain_batches(spec, n_batches=8, batch_size=32)
    space = sensitivity_mask(lm, params, pre, density=5e-2, device=device)
    gp = pretrain_gradient_vec(lm, params, space, pre)

    train = sample_dataset(spec, 2048, seed=1)
    parts = (dirichlet_partition(train["label"], 4, alpha=5.0, seed=0)
             + single_label_partition(train["label"], 2, seed=1))
    clients = [Client(k, subset(train, p), 32) for k, p in enumerate(parts)]
    kinds = ["balanced"] * 4 + ["single-label"] * 2

    T = args.steps
    local_run = make_local_run(loss, space, eps=1e-3, lr=5e-2)
    keys = round_keys(0, 0, T)
    # thresholds are scale-relative: GradIP magnitudes on the tiny model
    # are ~1e-2 (the paper's sigma=1 suits 1-3B models)
    fl = FLConfig(vp_rho_later=3.0, vp_sigma=0.01,
                  vp_init_steps=min(40, T // 2),
                  vp_later_steps=min(40, T // 2))

    print(f"GradIP over {T} local steps (server-side virtual path):\n")
    trajectories, results, scalars = [], [], []
    for c, kind in zip(clients, kinds):
        b = {k: torch.as_tensor(v, device=device)
             for k, v in c.next_batches(T).items()}
        _, gs = local_run(params, keys, b,
                          torch.zeros((space.n,), dtype=torch.float32,
                                      device=device))
        ips, _, _ = gradip_trajectory(space, keys, gs.cpu(), gp)
        ips = ips.cpu().numpy()
        r = analyze_trajectory(ips, fl)
        scalars.append(gs.cpu().numpy())
        trajectories.append(ips)
        results.append(r)
        flag = "EARLY-STOP" if r.flagged else "          "
        print(f"client {c.cid} [{kind:12s}] {flag} rho={r.rho_later:5.2f} "
              f"|{spark(ips)}|")
    print("\nflagged clients are limited to T=1 local step per round "
          "(Algorithm 1); their data is still consumed via the data "
          "pointer.")
    return {"trajectories": trajectories, "results": results,
            "scalars": scalars,
            "flagged": [c.cid for c, r in zip(clients, results)
                        if r.flagged],
            "space": space, "gp": gp, "keys": keys}


def main(argv=None):
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
