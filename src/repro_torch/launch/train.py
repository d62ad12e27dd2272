"""Federated MEERKAT training entry point (``repro.launch.train``).

Runs sparse-ZO federated fine-tuning of the tiny model or any registered
architecture's *reduced* variant on the synthetic classification-LM task
family with Dirichlet Non-IID clients: Algorithm 2 end to end (mask
calibration from the C4-proxy corpus, per-round seed ladders, client local
ZO steps, server virtual-path reconstruction and aggregation), optional
MEERKAT-VP calibration and early stopping, fault injection, fleet sampling
with a quantized uplink, and checkpoint/resume.  ``--method lora`` is
LoRA-FedZO: ZO over the q/v adapters only (``LoRASpace``; rank 4 unless the
config sets one).  Runs on the CUDA card unless ``--device`` says otherwise.

``--mesh DxM|PxDxM`` runs every round sharded on a device mesh
(``sharding/fl.FLShardPlan``; ``--mesh-rule``, FSDP by default): started
alone, the CLI spawns the mesh's ranks itself (``launch/mesh.spawn``: gloo
ranks with ``--device cpu``, else one card a rank); under ``torchrun`` it
runs as one of its ranks.  Rank 0 alone prints and writes; under ``fsdp``
and ``replicate`` the final checkpoint is the unsharded run's, byte for
byte.  ``--mesh-rule tp`` computes tensor-parallel (Megatron shards over
the ``model`` axis, clients over the others), within the JAX tool's
tolerance of the unsharded run (bit-equal on ``1x1``).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --rounds 4
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --checkpoint-dir runs/ckpt_torch --checkpoint-every 1 --rounds 8
      # then the same command + --resume
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --drop-rate 0.2 --late-rate 0.1 --sample-frac 0.5 --quantize int8
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --mesh 2x2 --rounds 2 --T 2 --clients 4
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint.state import FINAL_NAME, LATEST_NAME
from repro_torch.configs import TINY, get_config
from repro_torch.configs.base import FLConfig
from repro_torch.core import (Client, DenseSpace, FederatedZO, LoRASpace,
                              MaskedSpace, magnitude_mask,
                              pretrain_gradient_vec, random_mask,
                              sensitivity_mask)
from repro_torch.data import (TaskSpec, dirichlet_partition, iid_partition,
                              make_task_fns, pretrain_batches, sample_dataset,
                              single_label_partition, subset)
from repro_torch.fault import FaultPlan
from repro_torch.fault.plan import kill_now
from repro_torch.launch import mesh as M
from repro_torch.models import Model, ModelCtx


def build_space(method, loss_fn, params, pre, density, seed, device):
    if method == "meerkat":
        return sensitivity_mask(loss_fn, params, pre, density, device=device)
    if method == "magnitude":
        return magnitude_mask(params, density)
    if method == "random":
        return random_mask(params, density, seed=seed, balanced=False)
    if method == "full":
        return DenseSpace(params)
    if method == "lora":
        return LoRASpace(params)
    raise ValueError(method)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny",
                    help="tiny or any registered arch (reduced variant used)")
    ap.add_argument("--method", default="meerkat",
                    choices=["meerkat", "magnitude", "random", "full", "lora"])
    ap.add_argument("--partition", default="dirichlet",
                    choices=["iid", "dirichlet", "single_label", "mixed"])
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--T", type=int, default=10)
    ap.add_argument("--lr", type=float, default=5e-2)
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--density", type=float, default=1e-2)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--zo-backend", default="auto",
                    choices=["auto", "kernel", "ref"],
                    help="ZO perturb/update route (core/dispatch.py)")
    ap.add_argument("--attn-backend", default="auto",
                    choices=["auto", "kernel", "online", "dense"],
                    help="forward-attention route for the ZO loss forwards")
    ap.add_argument("--mesh", default=None,
                    help="run rounds sharded on a device mesh: DxM / PxDxM "
                         "ranks (e.g. 2x2), one device a rank")
    ap.add_argument("--mesh-rule", default="fsdp",
                    choices=["fsdp", "tp", "replicate"],
                    help="parameter sharding rule under --mesh "
                         "(sharding/fl.py; fsdp and replicate are bit-exact "
                         "against the unsharded run; tp computes "
                         "tensor-parallel)")
    ap.add_argument("--vp", action="store_true",
                    help="MEERKAT-VP: calibrate GradIP + early-stop")
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--out", default=None, help="write history json here")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="write server snapshots here (ckpt_latest every "
                         "--checkpoint-every rounds, ckpt_final at the end)")
    ap.add_argument("--checkpoint-every", type=int, default=1,
                    help="rounds between snapshots under --checkpoint-dir")
    ap.add_argument("--resume", action="store_true",
                    help="restore ckpt_latest from --checkpoint-dir and "
                         "continue to --rounds (bit-exact vs uninterrupted)")
    ap.add_argument("--drop-rate", type=float, default=0.0,
                    help="per-(round, client) offline probability "
                         "(repro_torch.fault.FaultPlan)")
    ap.add_argument("--late-rate", type=float, default=0.0,
                    help="per-(round, client) straggler probability; "
                         "uploads land 1..--max-staleness rounds late")
    ap.add_argument("--max-staleness", type=int, default=2,
                    help="straggler staleness bound in rounds")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the deterministic fault schedule")
    ap.add_argument("--kill-at-round", type=int, default=None,
                    help="SIGKILL this process mid-round r (the unclean "
                         "death that --resume recovers from)")
    ap.add_argument("--sample-frac", type=float, default=1.0,
                    help="per-round participation fraction; < 1 enables the "
                         "seeded ClientSampler (cohort size "
                         "max(1, round(frac*K)))")
    ap.add_argument("--sample-weighted", action="store_true",
                    help="weight cohort draws by client dataset size "
                         "(uniform otherwise)")
    ap.add_argument("--quantize", default="none",
                    choices=["none", "int8", "int4", "int8-nearest",
                             "int4-nearest"],
                    help="uplink codec for the ZO scalars "
                         "(core/quantize.py exact-replay quantizer)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    a = ap.parse_args(argv)
    if not a.mesh:
        return train(a, a.device)
    try:
        mc = M.parse_mesh_spec(a.mesh)
    except ValueError as e:
        ap.error(str(e))
    device_type = "cpu" if a.device == "cpu" else "cuda"
    if torch.distributed.is_initialized() or M.torchrun_env() is not None:
        with M.process_group(device_type) as dev:
            return _rank(dev, a)
    try:
        M.spawn(_rank, mc.n_devices, device_type, a)
    except RuntimeError as e:
        # a --kill-at-round run's ranks SIGKILL themselves mid-round; the
        # launcher then dies by SIGKILL too, as a one-process run does
        if a.kill_at_round is not None and "exited with code -9" in str(e):
            kill_now()
        raise


def _rank(dev, a):
    """One rank of a ``--mesh`` run."""
    from repro_torch.sharding.fl import make_fl_plan
    plan = make_fl_plan(spec=a.mesh, rule=a.mesh_rule)
    return train(a, dev, plan)


def train(a, device, plan=None):
    """The run of parsed arguments ``a`` on ``device``, sharded on
    ``plan``'s mesh when one is given (then only rank 0 prints and
    writes)."""
    writer = plan is None or torch.distributed.get_rank() == 0
    say = print if writer else (lambda *args, **kw: None)
    cfg = TINY if a.arch == "tiny" else get_config(a.arch).reduced()
    if a.method == "lora" and cfg.lora_rank == 0:
        cfg = cfg.replace(lora_rank=4)
    spec = TaskSpec(vocab=min(cfg.vocab, 512), seq_len=16)
    if plan is not None:
        say(f"mesh: {a.mesh} ({plan.mesh_cfg.n_devices} ranks, "
            f"rule={a.mesh_rule}, client axis over {plan.batch_axes})")
    ctx = ModelCtx(attn_backend=a.attn_backend)
    if plan is not None and plan.rule == "tp":
        ctx = plan.model_ctx(ctx)  # tensor-parallel forwards on the shards
    model = Model(cfg, ctx=ctx, device=device)
    say(f"arch={cfg.name} params={model.n_params:,} method={a.method} "
          f"device={model.device}")

    params = model.init(seed=a.seed)
    loss, _, evaluate = make_task_fns(model, spec)

    def lm_loss_fn(p, b):
        return model.loss(p, b)

    pre = pretrain_batches(spec, n_batches=8, batch_size=32, seed=a.seed + 3)

    t0 = time.time()
    space = build_space(a.method, lm_loss_fn, params, pre, a.density, a.seed,
                        model.device)
    if plan is not None and isinstance(space, MaskedSpace):
        space = MaskedSpace(plan.broadcast(space.idx_tree))  # rank 0's mask
    say(f"space: n={space.n:,} coords ({time.time() - t0:.1f}s)")

    train = sample_dataset(spec, 2048, seed=a.seed + 1)
    ev = sample_dataset(spec, 512, seed=a.seed + 2)
    eval_batch = {k: np.asarray(v) for k, v in ev.items()}
    labels = train["label"]
    if a.partition == "iid":
        parts = iid_partition(len(labels), a.clients, seed=a.seed)
    elif a.partition == "dirichlet":
        parts = dirichlet_partition(labels, a.clients, a.alpha, seed=a.seed)
    elif a.partition == "single_label":
        parts = single_label_partition(labels, a.clients, seed=a.seed)
    else:  # mixed: 3/4 mildly heterogeneous + 1/4 single-label extremes
        nb = max(1, a.clients * 3 // 4)
        parts = (dirichlet_partition(labels, nb, 5.0, seed=a.seed)
                 + single_label_partition(labels, a.clients - nb,
                                          seed=a.seed + 1))
    clients = [Client(k, subset(train, p), a.batch)
               for k, p in enumerate(parts)]

    fl = FLConfig(n_clients=a.clients, rounds=a.rounds, local_steps=a.T,
                  lr=a.lr, eps=a.eps, density=a.density, seed=a.seed,
                  zo_backend=a.zo_backend,
                  batch_size=a.batch, vp_calibration_steps=100,
                  vp_init_steps=20, vp_later_steps=20, vp_rho_later=2.0,
                  vp_sigma=0.25, vp_sigma_relative=True,
                  sample_frac=a.sample_frac,
                  sample_weighted=a.sample_weighted, quantize=a.quantize)
    server = FederatedZO(loss, params, space, fl, clients, eval_fn=evaluate,
                         device=model.device, plan=plan)
    if server.sampler is not None or server.codec.spec != "none":
        m = "full" if server.sampler is None else server.sampler.m
        say(f"fleet: cohort {m}/{a.clients} per round"
              + (" (weighted)" if a.sample_weighted else "")
              + f", uplink codec {server.codec.spec}")

    fault_plan = None
    if a.drop_rate or a.late_rate or a.kill_at_round is not None:
        kills = (a.kill_at_round,) if a.kill_at_round is not None else ()
        fault_plan = FaultPlan(a.clients, a.rounds, drop_rate=a.drop_rate,
                               late_rate=a.late_rate,
                               max_staleness=a.max_staleness,
                               seed=a.fault_seed, kill_rounds=kills)
        say("faults:", fault_plan.summary())

    resumed = False
    if a.resume:
        if not a.checkpoint_dir:
            ap.error("--resume requires --checkpoint-dir")
        latest = os.path.join(a.checkpoint_dir, LATEST_NAME)
        server.load_checkpoint(latest)
        resumed = True
        say(f"resumed from {latest} at round {server.round}")

    if a.vp and not resumed:
        # (resume restores the calibrated VPCS flags and the consumed data
        # pointers; recalibrating would reset both and break bit-exactness)
        gp = pretrain_gradient_vec(lm_loss_fn, params, space, pre)
        if plan is not None:
            gp = plan.broadcast(gp)
        results, flagged, _ = server.calibrate_vp(gp)
        say(f"VPCS flagged clients {flagged} "
              f"(rho_later={[round(r.rho_later, 2) for r in results]})")

    m0 = evaluate(server.full_params(), eval_batch)
    say(f"round {server.round}: acc={float(m0['acc']):.4f} "
          f"loss={float(m0['loss']):.4f}")
    server.run(max(0, a.rounds - server.round), eval_every=a.eval_every,
               eval_batch=eval_batch, verbose=writer, fault_plan=fault_plan,
               checkpoint_dir=a.checkpoint_dir,
               checkpoint_every=a.checkpoint_every)
    if a.checkpoint_dir:
        final = server.save_checkpoint(os.path.join(a.checkpoint_dir,
                                                    FINAL_NAME))
        say("wrote", final)
    m = evaluate(server.full_params(), eval_batch)
    say(f"final: acc={float(m['acc']):.4f} loss={float(m['loss']):.4f} "
          f"({time.time() - t0:.0f}s total)  comm: up={server.comm.up_bytes}B "
          f"down={server.comm.down_bytes}B")
    if a.out and writer:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            json.dump({"history": server.history,
                       "final": {k: float(v) for k, v in m.items()},
                       "args": vars(a)}, f, indent=1)
        say("wrote", a.out)


if __name__ == "__main__":
    main()
