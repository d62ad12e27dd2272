"""The registered hot paths (``repro.analysis.registry``): every program the
port's performance story rests on, built with small concrete shapes on the
device each builder is given, so the whole rule sweep takes seconds on the
CPU.

Shape plan of the LM programs: ``TINY`` with ``vocab=256`` and
``d_model=256`` at ``S=320``.  The JAX registry keeps TINY's d_model of 64
(head_dim 16); the port's flash kernels take head_dim 64, 128 or 256, so
at head_dim 16 its ``auto`` route would fall to the dense route and hold a
[S, S] score tensor, where the JAX package's takes its blockwise kernel.
d_model 256 gives head_dim 64 (4 heads), and S = 320 still exceeds every
non-sequence dim (d_model 256, d_ff 128, vocab 256) and the attention
route's threshold (256), so (a) only a genuine [S, S]-class tensor trips
the dense rule and (b) ``auto`` takes the kernels, as at full size.

Liveness budgets (``peak_bytes_budget``) are regression gates set at about
2x the port's own estimate on the CPU, as the JAX registry sets its
budgets: a change that doubles a hot path's working set fails loudly,
normal drift does not.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.analysis.core import Built, Program

S = 320              # sequence length: > vocab, d_model > ATTN_AUTO_MIN_S
MiB = 2 ** 20


def _tiny_lm(dev):
    """(cfg, model, params, space) of the LM-shaped programs."""
    from repro_torch.configs.tiny import TINY
    from repro_torch.core import random_mask
    from repro_torch.models import Model
    cfg = TINY.replace(vocab=256, d_model=256)
    model = Model(cfg, device=dev)
    params = model.init(seed=0)
    space = random_mask(params, density=1e-2, seed=3, balanced=False)
    return cfg, model, params, space


def _tokens(dev, *shape, high=256):
    rng = np.random.default_rng(0)
    return torch.as_tensor(rng.integers(0, high, size=shape, dtype=np.int32),
                           device=dev)


def build_zo_train_loop(dev) -> Built:
    """The training burst: ``fl_step.make_fl_train_loop`` (T=1 MEERKAT
    steps), flat kernel route, 2 steps x 2 clients at S=320.  At 656,640
    flat parameters the auto rule stacks the (w+, w-) forwards
    (``fl_step.STACK_FORWARDS_MAX_PARAMS``): one vmapped forward a step,
    one folded flash-attention record a layer."""
    from repro_torch.core import prng
    from repro_torch.core.fl_step import make_fl_train_loop
    cfg, model, params, space = _tiny_lm(dev)
    n_steps, n_clients, b = 2, 2, 1
    loop = make_fl_train_loop(
        lambda p, bt: model.loss(p, bt, per_example=True), space,
        eps=1e-3, lr=1e-2, n_clients=n_clients, n_steps=n_steps)
    batches = {"tokens": _tokens(dev, n_steps, n_clients * b, S)}
    return Built(loop, (params, prng.key(1), batches),
                 meta=dict(seq_threshold=S,
                           peak_bytes_budget=32 * MiB))  # estimate 16.6 MiB


def _round_problem(dev):
    """The synthetic-classification round problem: the FederatedZO server's
    client-group program at its production shape class."""
    from repro_torch.configs.tiny import TINY
    from repro_torch.core import random_mask
    from repro_torch.data import TaskSpec, make_task_fns
    from repro_torch.models import Model
    model = Model(TINY, device=dev)
    params = model.init(seed=0)
    loss, _, _ = make_task_fns(model, TaskSpec())
    space = random_mask(params, density=1e-2, seed=3, balanced=False)
    return model, params, loss, space


def _group_fn(loss, space, *, eps=1e-3, lr=5e-2):
    """The server's client group: each client's T-step local loop
    (``zo.make_local_run``), one client after another."""
    from repro_torch.core import zo
    run = zo.make_local_run(loss, space, eps, lr, n_dirs=1, backend="ref")

    def group(params, keys, batches):
        zeros = torch.zeros((space.n,), dtype=torch.float32,
                            device=space.device)
        K = batches["tokens"].shape[0]
        out = [run(params, keys, {k: v[c] for k, v in batches.items()},
                   zeros) for c in range(K)]
        return (torch.stack([d for d, _ in out]),
                torch.stack([g for _, g in out]))

    return group


def build_fl_round(dev) -> Built:
    """Unsharded ``FederatedZO`` round group: K=4 clients x T=2 local steps
    over the synthetic task."""
    from repro_torch.core import prng
    model, params, loss, space = _round_problem(dev)
    K, T, b = 4, 2, 8
    batches = {"tokens": _tokens(dev, K, T, b, 16, high=512),
               "label": _tokens(dev, K, T, b, high=4)}
    return Built(_group_fn(loss, space),
                 (params, prng.split(prng.key(2), T), batches),
                 meta=dict(peak_bytes_budget=2 * MiB))  # estimate 1.13 MiB


def build_fl_round_sharded(dev) -> Built:
    """The sharded round on the process group the analyzer runs in (a
    one-rank ``1x1`` mesh in a single process, ``analysis.core.run_program``):
    the group body under an ``FLShardPlan`` (parameters at rest as
    DTensors and gathered at entry, the rank's block of the clients, their
    scalars gathered in client order).  Also runs one live ``FederatedZO``
    round on the plan to cross-check ``CommLog`` against the protocol's
    4*K*T*n_dirs bytes."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core import Client, FederatedZO, prng
    from repro_torch.data import (TaskSpec, dirichlet_partition,
                                  sample_dataset, subset)
    from repro_torch.sharding.fl import make_fl_plan
    from repro_torch.utils.tree import tree_leaves
    model, params, loss, space = _round_problem(dev)
    plan = make_fl_plan(spec="1x1")
    K, T, b = 4, 2, 8
    group = _group_fn(loss, space)

    def sharded(at_rest, keys, batches):
        local = {k: v.to_local() for k, v in batches.items()}
        deltas, gs = group(plan.compute_view(at_rest), keys.to_local(),
                           local)
        return deltas, plan.gather_clients(gs, K)

    batches = {"tokens": _tokens(dev, K, T, b, 16, high=512),
               "label": _tokens(dev, K, T, b, high=4)}
    args = (plan.place_params(params),
            plan.place_replicated(prng.split(prng.key(2), T)),
            plan.place_client_batches(batches, K))

    # live round on the same plan: the protocol's byte accounting
    fl = FLConfig(n_clients=K, local_steps=T, lr=5e-2, eps=1e-3, seed=0,
                  zo_backend="ref")
    train = sample_dataset(TaskSpec(), 256, seed=1)
    parts = dirichlet_partition(train["label"], K, 0.5, seed=0)
    clients = [Client(k, subset(train, p), b) for k, p in enumerate(parts)]
    srv = FederatedZO(loss, params, space, fl, clients, device=dev,
                      plan=plan)
    srv.run_round()
    param_bytes = int(sum(p.numel() * p.element_size()
                          for p in tree_leaves(params)))
    return Built(
        sharded, args,
        meta=dict(
            peak_bytes_budget=3 * MiB,  # estimate 1.54 MiB
            comm=dict(
                param_bytes=param_bytes,
                # one ZeRO-3 gather of the weights per round body
                allgather_max_bytes=3 * param_bytes,
                # uplink-class traffic: deltas [K, n] + gs [K, T] + slop,
                # still ~100x under one model copy
                other_collective_max_bytes=8 * K * (space.n + T) + 2 ** 16,
                expected_up_bytes=4 * K * T * fl.n_dirs,
                commlog_up_bytes=int(srv.comm.up_bytes))))


def build_ckpt_roundtrip(dev) -> Built:
    """The fault-tolerance save/restore round trip (``checkpoint/state.py``):
    a live ``FederatedZO`` server runs a round, snapshots, and restores into
    a fresh twin; the analyzed program is the round group *as driven by the
    restored parameters*, so the rule sweep covers the resume path.
    Restore fidelity is asserted here at build time: a checkpoint that loses
    bits fails the sweep."""
    import os
    import tempfile

    from repro_torch.configs.base import FLConfig
    from repro_torch.core import Client, FederatedZO, prng
    from repro_torch.data import (TaskSpec, dirichlet_partition,
                                  sample_dataset, subset)
    from repro_torch.utils.tree import tree_leaves
    model, params, loss, space = _round_problem(dev)
    K, T, b = 4, 2, 8
    fl = FLConfig(n_clients=K, local_steps=T, lr=5e-2, eps=1e-3, seed=0,
                  zo_backend="ref")
    train = sample_dataset(TaskSpec(), 256, seed=1)
    parts = dirichlet_partition(train["label"], K, 0.5, seed=0)

    def mk():
        clients = [Client(k, subset(train, p), b)
                   for k, p in enumerate(parts)]
        return FederatedZO(loss, params, space, fl, clients, device=dev)

    srv = mk()
    srv.run_round()
    twin = mk()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt.msgpack")
        srv.save_checkpoint(path)
        twin.load_checkpoint(path)
    for a, c in zip(tree_leaves(srv.params), tree_leaves(twin.params)):
        if not torch.equal(a, c):
            raise AssertionError("checkpoint round trip lost parameter bits")

    batches = {"tokens": _tokens(dev, K, T, b, 16, high=512),
               "label": _tokens(dev, K, T, b, high=4)}
    return Built(_group_fn(loss, space),
                 (twin.params, prng.split(prng.key(2), T), batches),
                 meta=dict(peak_bytes_budget=2 * MiB))  # same body as fl_round


def build_prefill(dev) -> Built:
    """``models/decode.prefill``, the serving admission path: a right-
    padded B=2 prompt batch with per-row lengths at S=320."""
    from repro_torch.models import decode as D
    cfg, model, params, _ = _tiny_lm(dev)

    def fn(p, batch, lengths):
        with torch.no_grad():
            return D.prefill(p, batch, cfg, model.ctx, S_max=S,
                             lengths=lengths)

    lengths = torch.tensor([S, 200], dtype=torch.int32, device=dev)
    return Built(fn, (params, {"tokens": _tokens(dev, 2, S)}, lengths),
                 meta=dict(seq_threshold=S,
                           peak_bytes_budget=19 * MiB))  # estimate 9.4 MiB


def build_decode_burst(dev) -> Built:
    """The continuous-batching engine's decode burst
    (``ContinuousBatchingEngine._decode``), tailed: 4 steps over 2 slots
    against an S_max=320 cache, the steady-state serving inner loop.  The
    engine runs its bursts eagerly here (``graphs=False``): those are the
    ops each of its CUDA graphs captures on the card, and a replay shows
    the recorder none."""
    from repro_torch.serving.engine import ContinuousBatchingEngine
    cfg, model, params, _ = _tiny_lm(dev)
    eng = ContinuousBatchingEngine(model, params, max_slots=2, S_max=S,
                                   bucket=16, graphs=False)

    def fn(remaining):
        with torch.no_grad():
            return eng._decode(4, remaining, None)

    remaining = torch.tensor([3, 2], dtype=torch.int32, device=dev)
    return Built(fn, (remaining,),
                 meta=dict(seq_threshold=S,
                           peak_bytes_budget=8 * MiB))  # estimate 3.8 MiB


def build_first_order(dev) -> Built:
    """``train/first_order.make_train_step``: the backprop baseline (and
    the mask's gradient path), through the flash kernels' backward."""
    from repro_torch.train.first_order import make_train_step
    cfg, model, params, _ = _tiny_lm(dev)
    init, step = make_train_step(lambda p, b: model.loss(p, b), lr=1e-3,
                                 device=dev)
    batch = {"tokens": _tokens(dev, 2, S)}
    return Built(step, (params, init(params), batch),
                 meta=dict(seq_threshold=S,
                           peak_bytes_budget=40 * MiB))  # estimate 21.3 MiB


HOT_PATHS = (
    Program("zo_train_loop",
            "fl_step.make_fl_train_loop: T=1 MEERKAT burst",
            build_zo_train_loop),
    Program("fl_round",
            "FederatedZO round group (clients in sequence), unsharded",
            build_fl_round),
    Program("fl_round_sharded",
            "FederatedZO round group under FLShardPlan (1x1 mesh)",
            build_fl_round_sharded),
    Program("ckpt_roundtrip",
            "checkpoint save/restore round trip, then the round group on "
            "the restored parameters",
            build_ckpt_roundtrip),
    Program("prefill",
            "models/decode.prefill: right-padded serving admission",
            build_prefill),
    Program("decode_burst",
            "ContinuousBatchingEngine._decode: a decode burst",
            build_decode_burst),
    Program("first_order",
            "train/first_order.make_train_step: backprop baseline",
            build_first_order),
)


def programs_by_name(names: Optional[List[str]] = None) -> List[Program]:
    table = {p.name: p for p in HOT_PATHS}
    if names is None:
        return list(HOT_PATHS)
    missing = [n for n in names if n not in table]
    if missing:
        raise KeyError(f"unknown program(s) {missing}; "
                       f"have {sorted(table)}")
    return [table[n] for n in names]
