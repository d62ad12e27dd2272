"""Seeded per-round client sampling for fleet-scale federated rounds
(``repro.core.sampling``; numpy only, the same code).

With K in the thousands, running every client every round is neither
realistic nor necessary: each round the server draws a fixed-size cohort
``m = max(1, round(frac * K))`` — uniformly, or weighted by client data
size — and only the cohort runs local steps, uploads scalars, and
receives downlink.  Unsampled clients get an explicit GradIP gap
(``None``), mirroring the dropout bookkeeping.

Determinism contract: the sampler is a *stateful* seeded
``numpy.random.Generator`` advancing exactly one draw per round, in
lockstep with the server's round counter (``cohort(r)`` asserts the
lockstep).  Its full bit-generator state is serialized into server
checkpoints (``checkpoint/state.py``), so a resumed server re-draws the
killed round's cohort identically — the sampled analogue of the seed
ladder's bit-exact-replay invariant.  Cohorts have *fixed size* and are
returned sorted, so every round reuses one compiled group program (the
cohort is data, not shape).
"""
from __future__ import annotations

import json
from typing import Optional, Sequence

import numpy as np


class ClientSampler:
    """Per-round cohort draws over a fixed client-id universe.

    Args:
      cids: the fleet's client ids (deduplicated, sorted internally).
      frac: participation fraction; cohort size ``max(1, round(frac*K))``.
      m: explicit cohort size (overrides ``frac``).
      weights: optional per-client sampling weights aligned with the
        *sorted* cids (e.g. client dataset sizes); drawn without
        replacement, so at least ``m`` weights must be positive.
      seed: generator seed (conventionally ``fl.seed``).
    """

    def __init__(self, cids: Sequence[int], *, frac: Optional[float] = None,
                 m: Optional[int] = None,
                 weights: Optional[Sequence[float]] = None, seed: int = 0):
        self.cids = tuple(sorted(int(c) for c in cids))
        if len(set(self.cids)) != len(self.cids):
            raise ValueError(f"duplicate client ids: {cids}")
        k = len(self.cids)
        if m is None:
            if frac is None:
                raise ValueError("need frac or m")
            if not 0.0 < frac <= 1.0:
                raise ValueError(f"frac must be in (0, 1], got {frac}")
            m = max(1, int(round(frac * k)))
        if not 1 <= m <= k:
            raise ValueError(f"cohort size m={m} outside [1, {k}]")
        self.m = int(m)
        if weights is not None:
            w = np.asarray(weights, np.float64)
            if w.shape != (k,):
                raise ValueError(f"weights shape {w.shape} != ({k},)")
            if (w < 0).any() or w.sum() <= 0:
                raise ValueError("weights must be >= 0 with positive sum")
            if int((w > 0).sum()) < self.m:
                raise ValueError(
                    f"only {int((w > 0).sum())} clients have positive "
                    f"weight but the cohort needs {self.m} (sampling is "
                    "without replacement)")
            self._p = w / w.sum()
        else:
            self._p = None
        self.seed = int(seed)
        self.rounds_sampled = 0
        self._rng = np.random.default_rng(self.seed)

    @property
    def weighted(self) -> bool:
        return self._p is not None

    def cohort(self, rnd: Optional[int] = None) -> tuple:
        """Draw the next round's cohort: sorted tuple of ``m`` distinct
        cids.  ``rnd`` (the server's round counter) asserts the lockstep
        — one draw per round, in order — that makes resumed draws land
        on the same rng state as the uninterrupted run."""
        if rnd is not None and int(rnd) != self.rounds_sampled:
            raise ValueError(
                f"out-of-order cohort draw: round {rnd} but the sampler "
                f"has drawn {self.rounds_sampled} rounds (one draw per "
                "round, in round order)")
        idx = self._rng.choice(len(self.cids), size=self.m, replace=False,
                               p=self._p)
        self.rounds_sampled += 1
        return tuple(sorted(self.cids[int(i)] for i in idx))

    # -- checkpoint plumbing (msgpack-safe: PCG64's 128-bit state ints
    # travel as a JSON string — json handles bignums, msgpack does not) --
    def state_dict(self) -> dict:
        return {"cids": list(self.cids), "m": self.m,
                "weighted": self.weighted, "seed": self.seed,
                "rounds_sampled": int(self.rounds_sampled),
                "rng": json.dumps(self._rng.bit_generator.state)}

    def load_state(self, d: dict) -> None:
        """Restore a :meth:`state_dict` snapshot (identity fields must
        match — the rng state only transfers onto the same universe)."""
        for field, have in (("cids", list(self.cids)), ("m", self.m),
                            ("weighted", self.weighted)):
            if d.get(field) != have:
                raise ValueError(
                    f"sampler state mismatch at {field!r}: checkpoint "
                    f"{d.get(field)!r} vs sampler {have!r}")
        self.rounds_sampled = int(d["rounds_sampled"])
        self._rng.bit_generator.state = json.loads(d["rng"])
