"""Sharded federated round on the PyTorch port: the same MEERKAT round, on
a device mesh.

    PYTHONPATH=src python examples/mesh_round_torch.py --device cpu  # 2x2
    PYTHONPATH=src python examples/mesh_round_torch.py --mesh 1x1    # a card

``examples/mesh_round.py`` step for step, through ``repro_torch``: it runs
the rounds unsharded, then on a ``sharding/fl.FLShardPlan`` mesh
(parameters FSDP-sharded per ``sharding/rules.py``, the client axis over
the mesh's batch axes), and checks the invariant: **the aggregated
update and every GradIP trajectory are bit-identical**, since the
seed-replay reconstruction of the virtual path does not care how the
round was sharded.  The mesh's ranks are processes of one
``torch.distributed`` group (``launch/mesh.py``): gloo ranks on the CPU
with ``--device cpu``, else one card a rank over NCCL; a mesh that asks
for more cards than there are raises.  A one-device mesh runs its lone
rank in this process.  The rounds take the port's mesh route, which keeps
the unsharded ZO route (``zo_backend="auto"``: the fused kernels on the
card), where the JAX example asks for its ``ref`` route (ROADMAP C20).
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.configs.tiny import TINY
from repro_torch.convert import params_from_numpy, space_from_numpy
from repro_torch.core import (Client, FederatedZO, pretrain_gradient_vec,
                              sensitivity_mask)
from repro_torch.data import (TaskSpec, dirichlet_partition, make_task_fns,
                              pretrain_batches, sample_dataset, subset)
from repro_torch.launch import mesh as M
from repro_torch.models import Model
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_leaves, tree_map

K = 4


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="2x2", help="DxM device mesh spec")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--T", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device of the ranks: 'cpu' (gloo) or the "
                         "CUDA cards, one a rank (default)")
    return ap


def _task(device):
    spec = TaskSpec()
    model = Model(TINY, device=device)
    loss, _, _ = make_task_fns(model, spec)
    return spec, model, loss


def make_server(loss, params, space, T, device, plan=None):
    train = sample_dataset(TaskSpec(), 1024, seed=1)
    parts = dirichlet_partition(train["label"], K, alpha=0.5, seed=0)
    clients = [Client(k, subset(train, p), 16) for k, p in enumerate(parts)]
    fl = FLConfig(n_clients=K, local_steps=T, lr=5e-2, eps=1e-3)
    return FederatedZO(loss, params, space, fl, clients, device=device,
                       plan=plan)


def _flat(params) -> np.ndarray:
    return np.concatenate([t.detach().cpu().numpy().ravel()
                           for t in tree_leaves(params)])


def _summary(srv, params) -> dict:
    return {"params": _flat(params),
            "gradip": {c: np.stack(log) for c, log in srv.gradip_log.items()},
            "up_bytes": srv.comm.up_bytes}


def sharded_rank(dev, mesh, rounds, T, params_np, idx_np, gp_np):
    """One rank of the mesh: the same rounds under the plan; every rank
    returns the gathered parameters, its GradIP log and bytes."""
    from repro_torch.sharding.fl import make_fl_plan
    plan = make_fl_plan(spec=mesh)
    _, _, loss = _task(dev)
    srv = make_server(loss, params_from_numpy(params_np, dev),
                      space_from_numpy(idx_np, dev), T, dev, plan)
    for _ in range(rounds):
        srv.run_round(gp_vec=torch.as_tensor(gp_np, device=dev))
    out = _summary(srv, srv.full_params())
    out.update(n_devices=plan.mesh_cfg.n_devices, rule=plan.rule,
               batch_axes=plan.batch_axes)
    return out


def run(args, *, params=None, device=None):
    """The example's steps; ``params`` (a tree of numpy arrays) replaces
    the seeded initial weights.  Returns the checks it printed and both
    runs' final state."""
    a = args
    n_dev = M.parse_mesh_spec(a.mesh).n_devices
    device = resolve_device(device if device is not None else a.device)
    spec, model, loss = _task(device)
    params = (model.init(seed=0) if params is None
              else params_from_numpy(params, device))
    pre = pretrain_batches(spec, n_batches=4, batch_size=16)
    space = sensitivity_mask(lambda p, b: model.loss(p, b), params, pre,
                             density=1e-2, device=device)
    gp = pretrain_gradient_vec(lambda p, b: model.loss(p, b), params, space,
                               pre)

    print(f"single-device reference ({a.rounds} rounds, T={a.T}, K={K}) ...")
    ref = make_server(loss, params, space, a.T, device)
    for _ in range(a.rounds):
        ref.run_round(gp_vec=gp)

    to_np = lambda t: t.detach().cpu().numpy()
    call = (a.mesh, a.rounds, a.T, tree_map(to_np, params),
            tree_map(to_np, space.idx_tree), to_np(gp))
    if n_dev == 1:
        with M.process_group(device.type) as dev:
            got = sharded_rank(dev, *call)
    else:
        got = M.spawn(sharded_rank, n_dev, device.type, *call)[0]
    print(f"mesh {a.mesh}: {got['n_devices']} devices, params "
          f"{got['rule']}-sharded, client axis over {got['batch_axes']}")

    want = _summary(ref, ref.params)
    bit_params = bool(np.array_equal(want["params"], got["params"]))
    bit_gradip = all(np.array_equal(want["gradip"][c], got["gradip"][c])
                     for c in want["gradip"])
    up_equal = want["up_bytes"] == got["up_bytes"]
    print(f"aggregated params bit-identical: {bit_params}")
    print(f"GradIP trajectories bit-identical: {bit_gradip}")
    print(f"comm per client per round: up 4*T = {4 * a.T} B "
          f"(mesh-invariant: {up_equal})")
    if bit_params and bit_gradip:
        print("sharded round == single-device round, bit for bit.")
    return {"bit_params": bit_params, "bit_gradip": bit_gradip,
            "up_equal": up_equal, "ref": ref, "space": space, "gp": gp,
            "sharded": got, "unsharded": want}


def main(argv=None):
    out = run(parser().parse_args(argv))
    if not (out["bit_params"] and out["bit_gradip"]):
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
