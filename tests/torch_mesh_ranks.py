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
from repro_torch.configs.base import FLConfig, InputShape
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


def run_plain(prob, plan, bundle, fl=PLAIN):
    """Two plain rounds with GradIP (the round held against JAX's)."""
    srv = server(prob, plan, FLConfig(**fl), clients(bundle, "parts4", 4))
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


def run_loop(prob, plan, bundle, stack_forwards=None):
    """make_fl_train_loop: LOOP_STEPS steps of 4 clients x LOOP_B rows
    (TINY: the auto rule stacks the (w+, w-) forwards)."""
    loop = make_fl_train_loop(
        prob["per_example"], prob["space"], eps=1e-3, lr=5e-2, n_clients=4,
        n_steps=LOOP_STEPS, stack_forwards=stack_forwards,
        constrain_params=None if plan is None else plan.constrain_params_fn())
    params = prob["params"] if plan is None else \
        plan.place_params(prob["params"])
    batches = {k: torch.as_tensor(v, device=prob["dev"])
               for k, v in bundle["loop"].items()}
    p, gs, m = loop(params, prng.key(11), batches)
    p = p if plan is None else plan.full(p)
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


# ------------------------------------------------ tensor parallelism (tp) --
# tests/test_torch_tp.py: the tp round and loop, TINY served on tp shards
# (seq_shard decode at B=1 too), moe_sharded against JAX's, and one dry-run
# step's counts on a real rank
MOE = dict(E=4, k=2, F=16, D=32, Fs=24, B=4, S=8, cfs=(2.0, 0.5))
# the tp round: the plain scenario at T=1 (its forwards run on DTensors),
# and at T=2 on the kernel route (the flat kernels on each rank's shards)
TP_PLAIN = dict(PLAIN, local_steps=1)
TP_KERNEL = dict(PLAIN, zo_backend="kernel")
# the dry run's records of a TINY ZO step: 2 rows a rank on a 2x2 mesh
TEST_SHAPE = InputShape("train_test", seq_len=32, global_batch=4,
                        kind="train")
SERVE_PROMPT, SERVE_STEPS = 12, 3


def make_tp_bundle(ckpt_dir: str) -> dict:
    """:func:`make_bundle` plus the MoE layer's inputs (numpy, from
    seeds): x [B, S, D] and a gated layer with a shared expert."""
    b = make_bundle(ckpt_dir)
    m = MOE
    rng = np.random.default_rng(11)

    def w(*shape):
        return (0.2 * rng.standard_normal(shape)).astype(np.float32)

    b["moe"] = dict(
        x=w(m["B"], m["S"], m["D"]), E=m["E"], k=m["k"], F=m["F"],
        cfs=np.asarray(m["cfs"]), p_router=w(m["D"], m["E"]),
        p_w1=w(m["E"], m["D"], m["F"]), p_w2=w(m["E"], m["F"], m["D"]),
        p_w3=w(m["E"], m["D"], m["F"]), p_sw1=w(m["D"], m["Fs"]),
        p_sw2=w(m["Fs"], m["D"]), p_sw3=w(m["D"], m["Fs"]))
    return b


def tp_serve(prob, plan, bundle, seq_shard=False):
    """TINY's prefill of SERVE_PROMPT tokens and SERVE_STEPS decode steps,
    unsharded and on the plan's tp shards (``seq_shard``: B=1, the cache
    sequence over the batch axes, the parameters on the whole mesh);
    returns the logits of both and the forward's max |logit|."""
    import dataclasses
    from repro_torch.models import decode as D
    from repro_torch.models.transformer import ModelCtx
    from repro_torch.sharding.fl import tp_params
    dev = prob["dev"]
    B = 1 if seq_shard else 2
    S_max = SERVE_PROMPT + 2 * SERVE_STEPS + 2   # even: splits over data
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, TINY.vocab, (B, SERVE_PROMPT)), device=dev)
    ctx = dataclasses.replace(plan.model_ctx(ModelCtx()), seq_shard=seq_shard)
    out = {}
    for name, params, c in (
            ("unsharded", prob["params"], ModelCtx()),
            ("tp", tp_params(prob["params"], plan.mesh, plan.mesh_cfg,
                             full=seq_shard), ctx)):
        lg, cache = D.prefill(params, {"tokens": toks}, TINY, c,
                              S_max=S_max)
        seq = [lg]
        tok = lg.argmax(-1).to(torch.int32)
        for _ in range(SERVE_STEPS):
            lg, cache = D.decode_step(params, tok, cache, TINY, c)
            seq.append(lg)
            tok = lg.argmax(-1).to(torch.int32)
        out[name] = torch.stack(seq).cpu().numpy()
    fwd, _ = Model(TINY, device=dev).forward(prob["params"],
                                             {"tokens": toks})
    out["scale"] = float(fwd.abs().max())
    return out


def tp_moe(plan, bundle, dev):
    """``moe_sharded`` on the plan's mesh: each rank's rows of x (by its
    data index), the experts and the shared expert sharded over 'model';
    returns this rank's rows of y and the aux loss per capacity factor."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models.moe import moe_sharded
    from repro_torch.models.transformer import ModelCtx
    from torch.distributed.tensor import DTensor, Replicate, Shard
    m = bundle["moe"]
    sub = plan.mesh["model"]
    dims = {"router": None, "w1": 0, "w2": 0, "w3": 0, "sw1": 1, "sw2": 0,
            "sw3": 1}
    p = {}
    for k, d in dims.items():
        whole = DTensor.from_local(torch.as_tensor(m["p_" + k], device=dev),
                                   sub, [Replicate()], run_check=False)
        p[k] = whole.redistribute(sub, [Replicate() if d is None
                                        else Shard(d)])
    ctx = plan.model_ctx(ModelCtx(use_sharded_moe=True))
    blk = plan.client_block(m["x"].shape[0])
    x = torch.as_tensor(m["x"][blk.start:blk.stop], device=dev)
    out = []
    for cf in m["cfs"]:
        mcfg = MoEConfig(n_experts=int(m["E"]), top_k=int(m["k"]),
                         d_ff_expert=int(m["F"]), capacity_factor=float(cf))
        y, aux = moe_sharded(x, p, mcfg, "silu", ctx)
        out.append((blk.start, y.cpu().numpy(), float(aux)))
    return out


def tp_trace_counts(dev, spec):
    """The dry run's TINY ZO step recorded on this real rank
    (``launch.dryrun.trace_step(fake=False)``): FLOPs, bytes, collective
    bytes and the liveness peak."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_from_config, parse_mesh_spec
    mc = parse_mesh_spec(spec)
    mesh = make_mesh_from_config(mc)
    trace, _ = dryrun.trace_step(TINY, TEST_SHAPE, mesh, mc, "zo_fl",
                                 dryrun.mask_indices(TINY)[0], fake=False)
    return dict(dryrun.counts(trace), memory=dryrun._memory(trace))


def tp_scenarios(dev, bundle, spec, unsharded=False):
    """Every tp scenario on ``spec``'s mesh, and with ``unsharded`` the
    unsharded round and loop they are held to (one thread: every process
    computes their bits alike)."""
    from repro_torch.sharding.fl import make_fl_plan
    torch.set_num_threads(1)  # the same GEMM bits in every process
    prob = problem(bundle, dev)
    plan = make_fl_plan(spec=spec, rule="tp")
    out = {}
    if unsharded:
        out["unsharded"] = dict(plain=run_plain(prob, None, bundle,
                                                TP_PLAIN),
                                kernel=run_plain(prob, None, bundle,
                                                 TP_KERNEL),
                                loop=run_loop(prob, None, bundle, False))
    # the tp loop runs its forwards in sequence: stacking them raises on
    # DTensor parameters (ROADMAP C9)
    out.update(
        plain=run_plain(prob, plan, bundle, TP_PLAIN),
        kernel=run_plain(prob, plan, bundle, TP_KERNEL),
        loop=run_loop(prob, plan, bundle, False),
        serve=tp_serve(prob, plan, bundle),
        serve_seq=tp_serve(prob, plan, bundle, seq_shard=True),
        moe=tp_moe(plan, bundle, dev))
    if spec != "1x1":
        out["trace"] = tp_trace_counts(dev, spec)
    return out
