"""Federated orchestration (``repro.core.server``): MEERKAT (Alg. 2),
high-frequency MEERKAT (Alg. 3) and MEERKAT-VP (Alg. 1).

The server never sees client data: it receives only projected-gradient
scalars and replays virtual paths from the shared seed ladder.  Clients run
one after another on the server's device (the JAX package maps over them);
the aggregated update is always computed from the server-side virtual-path
reconstruction of the uploaded scalars.

Not ported yet (``ROADMAP.md``): the mesh route (``plan``), client sampling,
the quantized uplink codec, fault injection and checkpointing.  A config
asking for sampling or a codec raises.
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
    """Cumulative FL protocol traffic in **bytes** (f32 scalars = 4 B each;
    seeds = 8 B): the paper's client<->server payloads only."""
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
      params: initial parameter tree, on ``device``.
      space: coordinate space (``core/spaces.py``).
      fl: :class:`FLConfig` hyper-parameters.
      clients: the client fleet (``Client`` instances).
      eval_fn: optional ``(params, batch) -> {metric: tensor}``.
      device: where the rounds run; the CUDA card unless ``"cpu"`` is
        asked for.

    The client loops dispatch through ``fl.zo_backend`` ("auto" routes the
    per-step perturb/update through the fused flat kernels when the layout
    supports it; see core/dispatch.py)."""

    def __init__(self, loss_fn: Callable, params, space, fl: FLConfig,
                 clients: Sequence[Client], eval_fn: Optional[Callable] = None,
                 device=None):
        self.device = resolve_device(device)
        for p in tree_leaves(params):
            if p.device.type != self.device.type:
                raise ValueError(f"params live on {p.device}, not "
                                 f"{self.device}")
        if fl.sample_frac < 1.0 or fl.quantize != "none":
            raise NotImplementedError(
                "client sampling and the quantized uplink are not ported yet")
        self.loss_fn = loss_fn
        self.params = params
        self.space = space
        self.fl = fl
        self.backend = fl.zo_backend
        self.clients = list(clients)
        self.eval_fn = eval_fn
        self.high_freq = fl.local_steps == 1  # Alg. 3 downlink accounting
        self.comm = CommLog()
        self.round = 0
        self.history: List[Dict[str, Any]] = []
        self.early_stopped: set = set()
        self.velocity = None  # FedAvgM server momentum state (beyond-paper)
        self.gradip_log: Dict[int, list] = {c.cid: [] for c in self.clients}
        self._run = ZO.make_local_run(self.loss_fn, self.space, fl.eps, fl.lr,
                                      n_dirs=fl.n_dirs, backend=self.backend)

    def _client_T(self, cid: int) -> int:
        return 1 if cid in self.early_stopped else self.fl.local_steps

    def _run_client(self, c: Client, keys, T: int) -> np.ndarray:
        """Client ``c`` runs T local ZO steps from the current params and
        uploads its scalars: [T] (or [T, n_dirs]) f32 on the host."""
        batches = {k: torch.as_tensor(v, device=self.device)
                   for k, v in c.next_batches(T).items()}
        zeros = torch.zeros(self.space.n, dtype=torch.float32,
                            device=self.device)
        _, gs = self._run(self.params, keys, batches, zeros)
        return gs.cpu().numpy().astype(np.float32)

    def _recon(self, keys, gs: np.ndarray):
        return VP.reconstruct_delta(self.space, keys, gs, self.fl.lr)

    # -- one federated round (Alg. 2) ----------------------------------------
    def run_round(self, gp_vec=None):
        """Execute one round: group clients by local-step count T, run each
        client's local ZO loop, account the scalar uploads, reconstruct every
        client's virtual path from (seed list, scalars), aggregate, and apply
        the update.

        ``gp_vec`` ([n] pre-training gradient): also log each client's GradIP
        trajectory for this round.  Returns {cid: gs [T] or [T, n_dirs]} —
        the scalars each client uploaded this round."""
        r = self.round
        groups: Dict[int, List[Client]] = {}
        for c in self.clients:
            groups.setdefault(self._client_T(c.cid), []).append(c)
        deltas, gs_by_cid = [], {}
        for T in sorted(groups):
            keys = S.round_keys(self.fl.seed, r, T)
            for c in groups[T]:
                # (1) the client runs T local ZO steps and uploads g^{1..T}
                g = self._run_client(c, keys, T)
                # (2) the server replays its virtual path from (seeds, g)
                deltas.append(self._recon(keys, g))
                gs_by_cid[c.cid] = g
                self.comm.add(up=4 * g.size, down=self._down_bytes(T))
                if gp_vec is not None:
                    ips, _, _ = gradip_trajectory(self.space, keys,
                                                  _per_step(g), gp_vec)
                    self.gradip_log[c.cid].append(ips.cpu().numpy())
        # (3) aggregate the reconstructed sparse updates (+ optional FedAvgM
        # server momentum — beyond-paper)
        agg = VP.aggregate(torch.stack(deltas))
        if self.fl.server_momentum > 0.0:
            self.velocity = (agg if self.velocity is None
                             else self.fl.server_momentum * self.velocity
                             + agg)
            agg = self.velocity
        self.params = self.space.add(self.params, agg)
        self.round += 1
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
        trajs = []
        for c in self.clients:
            g = self._run_client(c, keys, T)
            ips, _, _ = gradip_trajectory(self.space, keys, _per_step(g),
                                          gp_vec)
            trajs.append(ips.cpu().numpy())
            c.ptr = 0  # calibration does not consume training order
        results, flagged = VPCS.select_clients(trajs, self.fl)
        self.early_stopped = set(flagged)
        return results, flagged, trajs

    # -- training loop -------------------------------------------------------
    def run(self, rounds: int, eval_every: int = 0, eval_batch=None,
            gp_vec=None, verbose: bool = False):
        """Run ``rounds`` federated rounds; evaluate every ``eval_every``
        rounds with ``eval_fn(params, eval_batch)``.  Returns the history
        list of metric dicts (each tagged with its round index)."""
        for _ in range(rounds):
            self.run_round(gp_vec=gp_vec)
            if eval_every and self.round % eval_every == 0 \
                    and self.eval_fn is not None:
                m = self.eval_fn(self.params, eval_batch)
                m = {k: float(v) for k, v in m.items()}
                m["round"] = self.round
                self.history.append(m)
                if verbose:
                    print(f"  round {self.round}: " +
                          " ".join(f"{k}={v:.4f}" for k, v in m.items()
                                   if k != "round"))
        return self.history
