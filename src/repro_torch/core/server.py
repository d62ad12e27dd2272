"""Federated orchestration (``repro.core.server``): MEERKAT (Alg. 2),
high-frequency MEERKAT (Alg. 3) and MEERKAT-VP (Alg. 1).

The server never sees client data: it receives only projected-gradient
scalars and replays virtual paths from the shared seed ladder.  Clients run
one after another on the server's device (the JAX package maps over them);
the aggregated update is always computed from the server-side virtual-path
reconstruction of the uploaded scalars.

**Mesh route** (``plan=``, a :class:`repro_torch.sharding.fl.FLShardPlan`):
every rank of the plan's mesh holds a server.  Parameters rest as DTensors
placed by the plan (FSDP by default); each round gathers them once, every rank
runs its block of each T-group's clients through the same client loop as the
unsharded server (same routes and kernels), the decoded uploads are
``all_gather``-ed in cohort order, and every rank replays, aggregates and
applies the identical update, then re-places it.  Under ``rule="tp"`` the round
computes on the Megatron shards instead (``FLShardPlan.compute_view``):
clients over the batch axes, the masked perturbation and the update in place on
each rank's shards (``core/spaces.ShardedMask``).  Cohorts, faults, data
pointers, GradIP and ``CommLog`` are computed on every rank from the shared
seed, so the sharded round is bit-identical to the unsharded one.

**Fault tolerance**: ``run_round(faults=)`` tolerates clients dropping
(aggregate over survivors) and straggling (bounded staleness, seed-replayed
exactly at arrival), and ``save_checkpoint``/``load_checkpoint`` snapshot
and restore the complete server state for bit-exact resume after a kill
(``checkpoint/state.py``; the files are the JAX package's, byte for byte).
Deterministic fault schedules come from ``repro_torch.fault.FaultPlan``.

**Fleet scale**: with ``fl.sample_frac < 1`` each round runs a seeded
fixed-size cohort (``core/sampling.ClientSampler``; fault events restrict to
the cohort, unsampled clients get explicit GradIP gaps), and ``fl.quantize``
routes the scalar uplink through the ``core/quantize`` codec: clients apply
the wire-grid values in-loop (exact replay), so the server reconstructs
virtual paths from the *decoded* upload bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core import seeds as S
from repro_torch.core import virtual_path as VP
from repro_torch.core import vpcs as VPCS
from repro_torch.core import zo as ZO
from repro_torch.core.gradip import gradip_trajectory
from repro_torch.core.quantize import make_codec
from repro_torch.core.sampling import ClientSampler
from repro_torch.core.spaces import has_dtensors, sharded
from repro_torch import fault
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import tree_leaves


class Client:
    """Holds a local dataset and a data pointer (paper §2.5: flagged clients
    resume from where they stopped so all data is eventually used).

    ``data``: dict of equally-long numpy arrays (leading dim = examples);
    ``batch_size``: examples per local step."""

    def __init__(self, cid: int, data: Dict[str, np.ndarray], batch_size: int):
        self.cid = cid
        self.data = data
        self.batch_size = batch_size
        self.ptr = 0
        self.n = len(next(iter(data.values())))

    def next_batches(self, T: int):
        """Stack of T batches — each value [T, batch_size, ...] — advancing
        the pointer with wraparound."""
        idx = (self.ptr + np.arange(T * self.batch_size)) % self.n
        self.ptr = int((self.ptr + T * self.batch_size) % self.n)
        sel = {k: v[idx] for k, v in self.data.items()}
        return {k: v.reshape(T, self.batch_size, *v.shape[1:])
                for k, v in sel.items()}


def _per_step(g: np.ndarray) -> np.ndarray:
    """Reduce a client's uploaded scalars to one per local step: [T] stays
    [T]; multi-direction [T, K] averages over K."""
    g = np.asarray(g)
    return g.mean(axis=1) if g.ndim > 1 else g


@dataclass
class CommLog:
    """Cumulative FL protocol traffic in **bytes** (f32 scalars = 4 B each,
    or the codec's wire size; seeds = 8 B): the paper's client<->server
    payloads only."""
    up_bytes: int = 0
    down_bytes: int = 0

    def add(self, up: int, down: int):
        self.up_bytes += int(up)
        self.down_bytes += int(down)


class FederatedZO:
    """Generic sparse-ZO FL server; the ``space`` argument selects the method
    (MEERKAT sensitivity mask, or dense Full-FedZO).

    Args:
      loss_fn: scalar client loss ``(params, batch) -> f32 tensor``.
      params: initial parameter tree, on ``device``.  With ``plan`` set it
        is placed on the mesh per the plan's rule at construction.
      space: coordinate space (``core/spaces.py``).
      fl: :class:`FLConfig` hyper-parameters.
      clients: the client fleet (``Client`` instances).
      eval_fn: optional ``(params, batch) -> {metric: tensor}``.
      device: where the rounds run; the CUDA card unless ``"cpu"`` is
        asked for (under a ``plan``, the rank's device).
      plan: optional :class:`repro_torch.sharding.fl.FLShardPlan`: run
        every round on the plan's mesh (see the module docstring).
      sampler: optional :class:`repro_torch.core.sampling.ClientSampler`
        override; by default one is built from ``fl.sample_frac < 1``
        (seeded with ``fl.seed``, weighted by client data size when
        ``fl.sample_weighted``).  None with ``sample_frac == 1`` runs the
        whole fleet every round.
      codec: optional uplink codec override (``core/quantize.py``); by
        default built from ``fl.quantize`` (``"none"`` = raw f32).

    The client loops dispatch through ``fl.zo_backend`` ("auto" routes the
    per-step perturb/update through the fused flat kernels when the layout
    supports it; see core/dispatch.py)."""

    def __init__(self, loss_fn: Callable, params, space, fl: FLConfig,
                 clients: Sequence[Client], eval_fn: Optional[Callable] = None,
                 device=None, plan=None, sampler=None, codec=None):
        self.device = resolve_device(device)
        for p in tree_leaves(params):
            if p.device.type != self.device.type:
                raise ValueError(f"params live on {p.device}, not "
                                 f"{self.device}")
        self.loss_fn = loss_fn
        self.plan = plan
        self.params = params if plan is None else plan.place_params(params)
        self.space = space
        self.fl = fl
        self.backend = fl.zo_backend
        self.clients = list(clients)
        self.eval_fn = eval_fn
        self.high_freq = fl.local_steps == 1  # Alg. 3 downlink accounting
        self.codec = codec if codec is not None else make_codec(fl.quantize)
        if sampler is None and fl.sample_frac < 1.0:
            weights = ([c.n for c in self.clients] if fl.sample_weighted
                       else None)
            sampler = ClientSampler([c.cid for c in self.clients],
                                    frac=fl.sample_frac, weights=weights,
                                    seed=fl.seed)
        self.sampler = sampler
        self.comm = CommLog()
        self.round = 0
        self.history: List[Dict[str, Any]] = []
        self.early_stopped: set = set()
        self.velocity = None  # FedAvgM server momentum state (beyond-paper)
        self.gradip_log: Dict[int, list] = {c.cid: [] for c in self.clients}
        # straggler uploads in flight: dicts of (arrive, cid, src_round,
        # gip_idx, gs), part of the checkpointed state
        self._pending: List[dict] = []
        self.last_round_info: Optional[dict] = None
        self._run = ZO.make_local_run(self.loss_fn, self.space, fl.eps, fl.lr,
                                      n_dirs=fl.n_dirs, backend=self.backend,
                                      quantize=self.codec.jax_spec())

    def _client_T(self, cid: int) -> int:
        return 1 if cid in self.early_stopped else self.fl.local_steps

    def full_params(self):
        """The parameters as full tensors: the plan's gather
        (``FLShardPlan.full``, a collective every rank joins), or the tree
        itself without a plan."""
        if self.plan is None:
            return self.params
        return self.plan.full(self.params)

    def _compute_params(self):
        """What a round computes with: the plan's compute view (the full
        tensors, or under ``rule="tp"`` the Megatron shards,
        ``FLShardPlan.compute_view``), or the tree itself."""
        if self.plan is None:
            return self.params
        return self.plan.compute_view(self.params)

    def _run_clients(self, cs: List[Client], keys, T: int,
                     params) -> np.ndarray:
        """Clients ``cs`` run T local ZO steps each from ``params`` and
        upload their scalars: [len(cs), T] (or [.., T, n_dirs]) f32 on the
        host, in the order of ``cs``.  Every client's data pointer advances
        on every rank; under a plan the rank runs its block of ``cs`` and
        the blocks are gathered."""
        data = [c.next_batches(T) for c in cs]
        blk = (range(len(cs)) if self.plan is None
               else self.plan.client_block(len(cs)))
        zeros = torch.zeros(self.space.n, dtype=torch.float32,
                            device=self.device)
        gs = []
        for i in blk:
            batches = {k: torch.as_tensor(v, device=self.device)
                       for k, v in data[i].items()}
            gs.append(self._run(params, keys, batches, zeros)[1])
        gs = torch.stack(gs)
        if self.plan is not None:
            gs = self.plan.gather_clients(gs, len(cs))
        return gs.cpu().numpy().astype(np.float32)

    def _recon(self, keys, gs: np.ndarray):
        return VP.reconstruct_delta(self.space, keys, gs, self.fl.lr)

    def _cohort(self, r: int) -> tuple:
        """Participating client ids for round ``r``: the whole fleet
        without a sampler, else the sampler's seeded draw (sorted, of fixed
        size)."""
        if self.sampler is None:
            return tuple(c.cid for c in self.clients)
        return self.sampler.cohort(r)

    def _gradip(self, keys, g: np.ndarray, gp_vec) -> np.ndarray:
        ips, _, _ = gradip_trajectory(self.space, keys, _per_step(g), gp_vec)
        return ips.cpu().numpy()

    # -- one federated round (Alg. 2 + the failure model) --------------------
    def run_round(self, gp_vec=None, faults=None):
        """Execute one round: group the cohort's clients by local-step count
        T, run each client's local ZO loop, send every upload through the
        codec, reconstruct every reporting client's virtual path from (seed
        list, decoded scalars), aggregate, and apply the update.

        ``gp_vec`` ([n] pre-training gradient): also log each client's
        GradIP trajectory for this round.  Returns {cid: gs [T] or
        [T, n_dirs]}: the decoded scalars each client uploaded *this round*.

        ``faults`` (a :class:`repro_torch.fault.RoundFaults`) injects the
        failure model:

        * ``drops``: offline clients run no local steps, move no bytes,
          keep their data pointer and get an explicit ``None`` GradIP gap.
        * ``late`` (cid -> delay): stragglers run this round's local steps
          on its seeds and data, but their upload lands ``delay`` rounds
          later; the server replays it with the *source* round's keys and
          bills the uplink at arrival.
        * ``kill``: ``fault.plan.kill_now()`` mid-round (after client
          compute, before the update applies).

        With a sampler only the round's cohort participates (fault events
        restrict to it; unsampled clients get a ``None`` GradIP gap).  The
        server bills the *encoded* byte count and stores and replays the
        *decoded* scalars, bit for bit the ones the client applied.  The
        round aggregates over whoever reported (prompt survivors by sorted
        T in cohort order, then arrivals sorted by (source round, cid));
        a round where nobody reports applies a zero update.  Diagnostics
        land in ``self.last_round_info``."""
        f = faults if faults is not None else fault.NO_FAULTS
        r = self.round
        params = self._compute_params()  # under a plan: the gather at entry
        cohort = self._cohort(r)
        in_cohort = set(cohort)
        f = f.restrict(in_cohort)
        if gp_vec is not None:
            for c in self.clients:
                if c.cid not in in_cohort:
                    self.gradip_log[c.cid].append(None)  # unsampled gap
        groups: Dict[int, List[Client]] = {}
        for c in self.clients:
            if c.cid in in_cohort:
                groups.setdefault(self._client_T(c.cid), []).append(c)
        deltas, gs_by_cid, arrived = [], {}, []
        for T in sorted(groups):
            if gp_vec is not None:
                for c in groups[T]:
                    if c.cid in f.drops:
                        self.gradip_log[c.cid].append(None)  # explicit gap
            cs = [c for c in groups[T] if c.cid not in f.drops]
            if not cs:
                continue
            keys = S.round_keys(self.fl.seed, r, T)
            # (1) the clients run T local ZO steps each; their scalars
            # cross the wire through the codec, and the server keeps the
            # decoded values (the ones the clients applied)
            for c, g in zip(cs, self._run_clients(cs, keys, T, params)):
                wire = self.codec.encode(g)
                g = self.codec.decode(wire)
                if c.cid in f.late:
                    # straggler: the downlink happened, the upload is in
                    # flight until its arrival round
                    self.comm.add(up=0, down=self._down_bytes(T))
                    gip_idx = -1
                    if gp_vec is not None:
                        self.gradip_log[c.cid].append(None)
                        gip_idx = len(self.gradip_log[c.cid]) - 1
                    self._pending.append(dict(
                        arrive=r + int(f.late[c.cid]), cid=c.cid,
                        src_round=r, gip_idx=gip_idx, gs=g))
                    continue
                # (2) the server replays its virtual path from (seeds, g)
                deltas.append(self._recon(keys, g))
                gs_by_cid[c.cid] = g
                self.comm.add(up=wire.nbytes, down=self._down_bytes(T))
                if gp_vec is not None:
                    self.gradip_log[c.cid].append(
                        self._gradip(keys, g, gp_vec))
        # (2b) stragglers landing this round: replayed with the *source*
        # round's keys (the seed ladder is a pure function of (fl.seed,
        # round, T)); fill the GradIP gap logged at the source round
        due = sorted((p for p in self._pending if p["arrive"] <= r),
                     key=lambda p: (p["src_round"], p["cid"]))
        self._pending = [p for p in self._pending if p["arrive"] > r]
        for p in due:
            gs_l = np.asarray(p["gs"])
            src_keys = S.round_keys(self.fl.seed, p["src_round"],
                                    gs_l.shape[0])
            deltas.append(self._recon(src_keys, gs_l))
            self.comm.add(up=self.codec.nbytes(gs_l.size), down=0)
            if gp_vec is not None and p["gip_idx"] >= 0:
                self.gradip_log[p["cid"]][p["gip_idx"]] = self._gradip(
                    src_keys, gs_l, gp_vec)
            arrived.append((p["cid"], p["src_round"], gs_l))
        if f.kill:
            fault.plan.kill_now()  # mid-round: work done, update not applied
        # (3) aggregate the reconstructed sparse updates of whoever reported
        # (+ optional FedAvgM server momentum — beyond-paper)
        n_report = len(deltas)
        if n_report:
            agg = VP.aggregate(torch.stack(deltas), n_report)
        else:  # zero-survivor round: well-defined no-op update
            agg = torch.zeros(self.space.n, dtype=torch.float32,
                              device=self.space.device)
        del deltas
        if self.fl.server_momentum > 0.0:
            self.velocity = (agg if self.velocity is None
                             else self.fl.server_momentum * self.velocity
                             + agg)
            agg = self.velocity
        if has_dtensors(params):   # tp: the shards, in place
            params = sharded(self.space, params).add_(params, agg)
        else:
            params = self.space.add(params, agg)
        self.params = (params if self.plan is None
                       else self.plan.place_params(params))
        del params
        self.round += 1
        self.last_round_info = dict(
            round=r, n_reporting=n_report, drops=sorted(f.drops),
            late=dict(f.late), arrived=arrived,
            pending=len(self._pending), cohort=list(cohort),
            n_unsampled=len(self.clients) - len(cohort))
        return gs_by_cid

    def _down_bytes(self, T: int) -> int:
        """Per-client downlink bytes for a T-step round (Alg. 2/3)."""
        if self.high_freq:
            # aggregated scalars + next seed; with the K-direction estimator
            # all T*K per-direction scalars come down (mirrors the uplink)
            return 4 * T * self.fl.n_dirs + 8
        return 4 * self.space.n  # sparse (or dense) model refresh

    # -- calibration + VPCS (MEERKAT-VP, Alg. 1) ----------------------------
    def calibrate_vp(self, gp_vec, T_cali: Optional[int] = None):
        """Run the calibration phase (round index -1 in the seed ladder),
        analyze GradIP trajectories, flag extreme Non-IID clients for early
        stopping.  Returns (results [VPCSResult per client], flagged client
        ids, trajectories [GradIP [T_cali] arrays])."""
        T = T_cali or self.fl.vp_calibration_steps
        keys = S.round_keys(self.fl.seed, -1, T)
        gs = self._run_clients(self.clients, keys, T,
                               self._compute_params())
        trajs = []
        for c, g in zip(self.clients, gs):
            trajs.append(self._gradip(keys, g, gp_vec))
            c.ptr = 0  # calibration does not consume training order
        results, flagged = VPCS.select_clients(trajs, self.fl)
        self.early_stopped = set(flagged)
        return results, flagged, trajs

    def early_stop_random(self, n: int, seed: int = 0):
        """Random-client-selection baseline (Table 6): early-stop ``n``
        clients drawn by ``np.random.default_rng(seed)`` without
        replacement, the JAX package's draw, so the flags are equal."""
        rng = np.random.default_rng(seed)
        ids = rng.choice([c.cid for c in self.clients], size=n, replace=False)
        self.early_stopped = set(int(i) for i in ids)

    # -- fault tolerance: snapshot / restore ---------------------------------
    def save_checkpoint(self, path: str) -> str:
        """Atomically snapshot the full server state (params, velocity,
        round, CommLog, GradIP trajectories + gaps, VPCS flags, client
        data pointers, straggler queue, sampler state, history) to
        ``path`` (``checkpoint/state.py``; bit-exact resume)."""
        from repro_torch.checkpoint.state import save_server_state
        return save_server_state(path, self)

    def load_checkpoint(self, path: str) -> dict:
        """Restore a :meth:`save_checkpoint` snapshot (this package's or
        the JAX package's) into this server, config-fingerprint checked;
        parameters land on this server's device, placed per its ``plan``
        (so a checkpoint moves between meshes and the unsharded server).
        Returns the meta dict."""
        from repro_torch.checkpoint.state import restore_server_state
        return restore_server_state(path, self)

    # -- training loop -------------------------------------------------------
    def run(self, rounds: int, eval_every: int = 0, eval_batch=None,
            gp_vec=None, verbose: bool = False, fault_plan=None,
            checkpoint_dir=None, checkpoint_every: int = 0):
        """Run ``rounds`` federated rounds; evaluate every ``eval_every``
        rounds with ``eval_fn(params, eval_batch)``.  Returns the history
        list of metric dicts (each tagged with its round index).

        ``fault_plan`` (a :class:`repro_torch.fault.FaultPlan`) injects that
        plan's per-round drop/late/kill events.  With ``checkpoint_dir``
        set, the snapshot is written to ``<dir>/ckpt_latest.msgpack``
        every ``checkpoint_every`` rounds (after eval, so the history is
        captured); cadence and eval use the *global* round index, so a
        resumed run checkpoints and evaluates on the schedule of an
        uninterrupted one."""
        import os
        from repro_torch.checkpoint.state import LATEST_NAME
        for _ in range(rounds):
            faults = (fault_plan.round_faults(self.round)
                      if fault_plan is not None else None)
            self.run_round(gp_vec=gp_vec, faults=faults)
            if eval_every and self.round % eval_every == 0 \
                    and self.eval_fn is not None:
                m = self.eval_fn(self.full_params(), eval_batch)
                m = {k: float(v) for k, v in m.items()}
                m["round"] = self.round
                self.history.append(m)
                if verbose:
                    print(f"  round {self.round}: " +
                          " ".join(f"{k}={v:.4f}" for k, v in m.items()
                                   if k != "round"))
            if checkpoint_dir and checkpoint_every \
                    and self.round % checkpoint_every == 0:
                self.save_checkpoint(os.path.join(checkpoint_dir,
                                                  LATEST_NAME))
        return self.history
