"""Virtual-Path Client Selection (paper Algorithm 1).

From each client's GradIP trajectory over a calibration phase, compute

* rho_later  = mean(GradIP over initial phase) / mean(GradIP over later phase)
* rho_quie   = fraction of later-phase steps with |GradIP| < sigma

Clients whose rho_later or rho_quie exceed the thresholds are flagged as
extremely Non-IID and early-stopped to T=1 local step per round.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from repro_torch.configs.base import FLConfig


@dataclass
class VPCSResult:
    """Per-client VPCS verdict.

    ``rho_later``: mean |GradIP| over the initial phase divided by the
    later-phase mean (dimensionless; > ``fl.vp_rho_later`` flags).
    ``rho_quie``: fraction of later-phase steps with |GradIP| below sigma
    (in [0, 1]; > ``fl.vp_rho_quie`` flags).
    ``flagged``: client is extreme Non-IID — early-stop to T=1."""
    rho_later: float
    rho_quie: float
    flagged: bool


def analyze_trajectory(gradip: np.ndarray, fl: FLConfig) -> VPCSResult:
    """Apply Alg. 1 steps 2-3 to one client's GradIP trajectory.

    ``gradip``: [T_cali] GradIP scalars (units: squared-gradient inner
    product — loss²/param²; only relative magnitudes matter, |.| is taken
    internally).  Phase lengths come from ``fl.vp_init_steps`` /
    ``fl.vp_later_steps``, clamped to the trajectory length.

    With ``fl.vp_sigma_relative`` the quiescence threshold is
    ``vp_sigma * mean(|GradIP|) over the initial phase`` instead of the
    paper's absolute sigma — GradIP magnitudes scale with model size and
    mask density, so an absolute threshold tuned at 1-3B params does not
    transfer; the relative form is scale-free (beyond-paper robustness)."""
    g = np.abs(np.asarray(gradip, np.float64))
    t_init = min(fl.vp_init_steps, len(g))
    t_later = min(fl.vp_later_steps, len(g))
    init_avg = float(g[:t_init].mean())
    later = g[-t_later:]
    later_avg = float(later.mean())
    rho_later = init_avg / (later_avg + 1e-12)
    sigma = (fl.vp_sigma * init_avg if fl.vp_sigma_relative else fl.vp_sigma)
    rho_quie = float((later < sigma).mean())
    flagged = (rho_later > fl.vp_rho_later) or (rho_quie > fl.vp_rho_quie)
    return VPCSResult(rho_later, rho_quie, flagged)


def select_clients(trajectories: Sequence[np.ndarray], fl: FLConfig):
    """Apply :func:`analyze_trajectory` to every client.

    ``trajectories``: one [T_cali] GradIP array per client, indexed by
    client id.  Returns (results: [VPCSResult per client], flagged:
    sorted list of flagged client ids)."""
    results = [analyze_trajectory(t, fl) for t in trajectories]
    flagged = [k for k, r in enumerate(results) if r.flagged]
    return results, flagged
