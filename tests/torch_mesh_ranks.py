"""The rank side of ``tests/test_torch_mesh_round.py``: the port's federated
round, unsharded and on a mesh, for every rank of a process group.

Each spawned rank imports this module (``launch.mesh.spawn`` pickles
:func:`scenarios` by name), so it imports torch and the port only.  A
``bundle`` of numpy arrays (:func:`make_bundle`: TINY's parameters and a
random mask from seeds, the clients' data) builds the same problem on
every rank and in the JAX package.
"""
import os

import numpy as np
import torch

import repro_torch.core as C
from repro_torch.configs.base import FLConfig
from repro_torch.configs.tiny import TINY
from repro_torch.convert import params_from_numpy, space_from_numpy
from repro_torch.core import prng
from repro_torch.core.fl_step import make_fl_train_loop
from repro_torch.data import (TaskSpec, dirichlet_partition, make_task_fns,
                              sample_dataset, subset)
from repro_torch.fault import FaultPlan
from repro_torch.models import Model
from repro_torch.utils.tree import tree_leaves, tree_map

SPEC = TaskSpec()
RULES = ("fsdp", "replicate")
# the round of tools/fl_mesh_parity.py: T=3 after a VP calibration of 8
VP = dict(local_steps=3, lr=5e-2, eps=1e-3, seed=0, zo_backend="ref",
          vp_calibration_steps=8, vp_init_steps=4, vp_later_steps=4,
          vp_rho_later=2.0, vp_sigma=0.25, vp_sigma_relative=True)
# the plain round: 4 clients of batch 4, T=2, GradIP
PLAIN = dict(n_clients=4, local_steps=2, lr=5e-2, zo_backend="ref")
LOOP_STEPS, LOOP_B = 3, 4
FAULTS = dict(drop_rate=0.25, late_rate=0.3, max_staleness=2, seed=5)


def make_bundle(ckpt_dir: str) -> dict:
    """The problem as numpy arrays, from seeds: TINY's parameters, a random
    mask of density 1e-2, a GradIP vector, 512 training examples split
    Dirichlet(0.5) over 4 and over 8 clients, the train loop's batches."""
    from repro_torch.core import random_mask
    params = Model(TINY, device="cpu").init(seed=0)
    space = random_mask(params, density=1e-2, seed=3, balanced=False)
    train = sample_dataset(SPEC, 512, seed=1)
    loop = sample_dataset(SPEC, LOOP_STEPS * 4 * LOOP_B, seed=7)
    return dict(
        params=tree_map(lambda t: t.numpy(), params),
        idx=tree_map(lambda t: t.numpy(), space.idx_tree),
        gp=np.random.default_rng(7).normal(size=space.n).astype(np.float32),
        train=train,
        parts4=dirichlet_partition(train["label"], 4, 0.5, seed=0),
        parts8=dirichlet_partition(train["label"], 8, 0.5, seed=0),
        loop={k: v.reshape(LOOP_STEPS, 4 * LOOP_B, *v.shape[1:])
              for k, v in loop.items()},
        dir=ckpt_dir)


def flat(tree) -> np.ndarray:
    """The leaves of a torch, numpy or JAX tree as one f32 vector."""
    return np.concatenate([
        np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x,
                   np.float32).ravel() for x in tree_leaves(tree)])


def problem(bundle, dev):
    model = Model(TINY, device=dev)
    loss, per_example, _ = make_task_fns(model, SPEC)
    return dict(params=params_from_numpy(bundle["params"], device=dev),
                space=space_from_numpy(bundle["idx"], device=dev),
                gp=torch.as_tensor(bundle["gp"], device=dev), loss=loss,
                per_example=per_example, dev=dev)


def clients(bundle, parts, batch):
    return [C.Client(k, subset(bundle["train"], p), batch)
            for k, p in enumerate(bundle[parts])]


def server(prob, plan, fl, cs):
    return C.FederatedZO(prob["loss"], prob["params"], prob["space"], fl, cs,
                         device=prob["dev"], plan=plan)


def state(srv) -> dict:
    """What the parity checks compare of a server."""
    return dict(
        params=flat(srv.full_params()),
        gradip={c: [None if g is None else np.asarray(g) for g in v]
                for c, v in srv.gradip_log.items()},
        flags=sorted(srv.early_stopped),
        comm=(srv.comm.up_bytes, srv.comm.down_bytes),
        ptrs=[c.ptr for c in srv.clients],
        info={k: v for k, v in (srv.last_round_info or {}).items()
              if k != "arrived"})


def run_vp(prob, plan, bundle):
    """tools/fl_mesh_parity.py's run: VP calibration, 2 rounds with
    GradIP."""
    srv = server(prob, plan, FLConfig(n_clients=4, **VP),
                 clients(bundle, "parts4", 16))
    srv.calibrate_vp(prob["gp"])
    for _ in range(2):
        srv.run_round(gp_vec=prob["gp"])
    return state(srv)


def run_fleet(prob, plan, bundle):
    """A cohort of 4 of 8 a round (ClientSampler), the int8 uplink."""
    fl = FLConfig(n_clients=8, local_steps=2, lr=5e-2, sample_frac=0.5,
                  quantize="int8", zo_backend="ref")
    srv = server(prob, plan, fl, clients(bundle, "parts8", 4))
    for _ in range(2):
        srv.run_round(gp_vec=prob["gp"])
    return dict(state(srv), sampler=srv.sampler.state_dict())


def run_plain(prob, plan, bundle):
    """Two plain rounds with GradIP (the round held against JAX's)."""
    srv = server(prob, plan, FLConfig(**PLAIN), clients(bundle, "parts4", 4))
    for _ in range(2):
        srv.run_round(gp_vec=prob["gp"])
    return state(srv)


def run_faults(prob, plan, bundle):
    """Drops and stragglers (a FaultPlan), GradIP every round."""
    srv = server(prob, plan, FLConfig(**PLAIN), clients(bundle, "parts4", 4))
    fp = FaultPlan(4, 3, **FAULTS)
    srv.run(3, gp_vec=prob["gp"], fault_plan=fp)
    return dict(state(srv), pending=[(p["cid"], p["arrive"])
                                     for p in srv._pending])


def run_reshape(prob, plan, bundle, tag):
    """One round, a checkpoint, one more round; then a server of the other
    kind restored from the checkpoint runs that round too.  Returns the
    checkpoint's bytes and the final parameters of both servers."""
    fl = FLConfig(**PLAIN)
    path = os.path.join(bundle["dir"], f"{tag}.msgpack")
    src = server(prob, plan, fl, clients(bundle, "parts4", 4))
    src.run_round(gp_vec=prob["gp"])
    src.save_checkpoint(path)
    with open(path, "rb") as f:
        blob = f.read()
    src.run_round(gp_vec=prob["gp"])
    twin = server(prob, None if plan is not None else bundle.get("plan"),
                  fl, clients(bundle, "parts4", 4))
    twin.load_checkpoint(path)
    twin.run_round(gp_vec=prob["gp"])
    return dict(blob=blob, params=flat(src.full_params()),
                twin=flat(twin.full_params()))


def run_loop(prob, plan, bundle):
    """make_fl_train_loop: LOOP_STEPS steps of 4 clients x LOOP_B rows."""
    loop = make_fl_train_loop(
        prob["per_example"], prob["space"], eps=1e-3, lr=5e-2, n_clients=4,
        n_steps=LOOP_STEPS,
        constrain_params=None if plan is None else plan.constrain_params_fn())
    params = prob["params"] if plan is None else \
        plan.place_params(prob["params"])
    batches = {k: torch.as_tensor(v, device=prob["dev"])
               for k, v in bundle["loop"].items()}
    p, gs, m = loop(params, prng.key(11), batches)
    p = p if plan is None else plan.compute_view(p)
    return dict(params=flat(p), gs=gs.cpu().numpy(), loss=float(m["loss"]))


def scenarios(dev, bundle, spec, unsharded=True):
    """Every scenario on ``spec``'s mesh under each rule, and unsharded
    unless told not to; a mesh server also restores the unsharded server's
    checkpoint and an unsharded one the mesh server's."""
    from repro_torch.sharding.fl import make_fl_plan
    torch.set_num_threads(1)  # the same GEMM bits in every process
    rank = torch.distributed.get_rank()
    prob = problem(bundle, dev)
    # rank 0's tree on every rank, whatever each rank's leaves' shapes
    out = {"broadcast": make_fl_plan(spec=spec).broadcast(
        {"a": torch.full((3,), float(rank), device=dev),
         "b": [torch.arange(rank + 1, device=dev)]})}
    out["broadcast"] = tree_map(lambda t: t.cpu().numpy(), out["broadcast"])
    if unsharded:
        out["unsharded"] = dict(
            vp=run_vp(prob, None, bundle), plain=run_plain(prob, None, bundle),
            fleet=run_fleet(prob, None, bundle),
            faults=run_faults(prob, None, bundle),
            loop=run_loop(prob, None, bundle))
    for rule in RULES:
        plan = make_fl_plan(spec=spec, rule=rule)
        tag = f"{spec}-{rule}"
        out[rule] = dict(
            vp=run_vp(prob, plan, bundle),
            plain=run_plain(prob, plan, bundle),
            fleet=run_fleet(prob, plan, bundle),
            faults=run_faults(prob, plan, bundle),
            loop=run_loop(prob, plan, bundle),
            # mesh -> unsharded, and unsharded (one file a rank) -> mesh
            to_unsharded=run_reshape(prob, plan, bundle, tag),
            to_mesh=run_reshape(prob, None, dict(bundle, plan=plan),
                                f"{tag}-u{rank}"))
    return out
