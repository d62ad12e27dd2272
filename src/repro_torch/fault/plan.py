"""Deterministic fault schedules for federated rounds (``repro.fault.plan``;
numpy only, the same code).

A :class:`FaultPlan` is a pure function of its constructor arguments —
the whole schedule (which client drops or straggles in which round, and
where the server is killed) is drawn once from a seeded generator at
construction.  That is what makes fault runs *replayable*: a resumed
process rebuilds the identical plan from the same flags, so rounds
re-executed after a crash see exactly the faults the dead process saw
(the bit-exact-resume invariant).

Per-round event kinds (consumed by ``FederatedZO.run_round``):

* **drop** — the client is offline for the round: it runs no local
  steps, uploads nothing, receives no downlink, and its data pointer
  does not advance.  The server aggregates over the survivors and logs
  an explicit GradIP gap for the client.
* **late** — a straggler: the client runs its local steps on the
  round's seeds/data as usual, but its scalar upload arrives
  ``delay`` rounds later (``1 <= delay <= max_staleness``).  Because the
  virtual path is reconstructed from ``(round seed keys, scalars)`` and
  the seed ladder is derivable from ``(fl.seed, round, T)``, the stale
  contribution is replayed *exactly* when it lands.
* **kill** — the server process dies mid-round (after client compute,
  before the aggregated update is applied): the crash/preemption case
  the checkpoint/resume path exists for.  The default killer is a real
  ``SIGKILL`` of the current process (no cleanup, no atexit) — tests
  monkeypatch :func:`kill_now`.
"""
from __future__ import annotations

import dataclasses
import os
import signal
from typing import Dict, FrozenSet, Mapping, Sequence

import numpy as np


def kill_now():  # pragma: no cover - exercised by launch/train.py
    """SIGKILL the current process: the unclean-death model. Module-level
    so harnesses/tests can monkeypatch it."""
    os.kill(os.getpid(), signal.SIGKILL)


@dataclasses.dataclass(frozen=True)
class RoundFaults:
    """The fault events of one round (``FaultPlan.round_faults``)."""
    drops: FrozenSet[int] = frozenset()
    late: Mapping[int, int] = dataclasses.field(default_factory=dict)
    kill: bool = False

    @property
    def empty(self) -> bool:
        return not (self.drops or self.late or self.kill)

    def restrict(self, cohort) -> "RoundFaults":
        """Project the round's client faults onto a sampled cohort
        (fleet-scale client sampling): drop/late events
        of clients outside the cohort are vacuous — the server never
        asked them to participate — so the effective faults are the
        plan's events intersected with the cohort.  ``kill`` is a
        server-side event and survives unchanged.  A fault plan drawn
        for the full fleet therefore composes with any participation
        fraction without redrawing the schedule."""
        if not (self.drops or self.late):
            return self
        cohort = frozenset(cohort)
        return RoundFaults(
            drops=self.drops & cohort,
            late={c: d for c, d in self.late.items() if c in cohort},
            kill=self.kill)


NO_FAULTS = RoundFaults()


class FaultPlan:
    """Seeded per-round schedule of client-drop / client-late /
    server-kill events.

    Each (round, client) cell draws one uniform: ``u < drop_rate`` is a
    drop, ``u < drop_rate + late_rate`` a straggler with delay drawn
    uniformly from ``[1, max_staleness]``.  Rounds at or beyond
    ``rounds`` are fault-free (so a resumed run that overshoots the
    planned horizon degrades to the clean protocol)."""

    def __init__(self, n_clients: int, rounds: int, *,
                 drop_rate: float = 0.0, late_rate: float = 0.0,
                 max_staleness: int = 2, seed: int = 0,
                 kill_rounds: Sequence[int] = ()):
        if not (0.0 <= drop_rate <= 1.0 and 0.0 <= late_rate <= 1.0
                and drop_rate + late_rate <= 1.0):
            raise ValueError(
                f"need drop_rate, late_rate >= 0 with sum <= 1; got "
                f"{drop_rate}, {late_rate}")
        if max_staleness < 1:
            raise ValueError(f"max_staleness must be >= 1, got "
                             f"{max_staleness}")
        if n_clients < 1 or rounds < 0:
            raise ValueError(f"need n_clients >= 1 and rounds >= 0; got "
                             f"{n_clients}, {rounds}")
        self.n_clients = int(n_clients)
        self.rounds = int(rounds)
        self.drop_rate = float(drop_rate)
        self.late_rate = float(late_rate)
        self.max_staleness = int(max_staleness)
        self.seed = int(seed)
        self.kill_rounds = frozenset(int(r) for r in kill_rounds)
        rng = np.random.default_rng(seed)
        u = rng.uniform(size=(self.rounds, self.n_clients))
        delays = rng.integers(1, self.max_staleness + 1,
                              size=(self.rounds, self.n_clients))
        self._schedule: Dict[int, RoundFaults] = {}
        for r in range(self.rounds):
            drops = frozenset(int(c) for c in np.nonzero(
                u[r] < self.drop_rate)[0])
            late = {int(c): int(delays[r, c])
                    for c in np.nonzero(
                        (u[r] >= self.drop_rate)
                        & (u[r] < self.drop_rate + self.late_rate))[0]}
            rf = RoundFaults(drops=drops, late=late,
                             kill=r in self.kill_rounds)
            if not rf.empty:
                self._schedule[r] = rf
        for r in self.kill_rounds - set(self._schedule):
            self._schedule[r] = RoundFaults(kill=True)

    def round_faults(self, r: int) -> RoundFaults:
        return self._schedule.get(int(r), NO_FAULTS)

    def kill_at(self, r: int) -> bool:
        return int(r) in self.kill_rounds

    def summary(self) -> dict:
        """Event counts over the horizon (for bench rows / logs)."""
        n_drop = sum(len(rf.drops) for rf in self._schedule.values())
        n_late = sum(len(rf.late) for rf in self._schedule.values())
        return dict(n_clients=self.n_clients, rounds=self.rounds,
                    drop_rate=self.drop_rate, late_rate=self.late_rate,
                    max_staleness=self.max_staleness, seed=self.seed,
                    n_drop_events=n_drop, n_late_events=n_late,
                    kill_rounds=sorted(self.kill_rounds))

    def __repr__(self):  # pragma: no cover - debugging aid
        s = self.summary()
        return (f"FaultPlan(K={s['n_clients']}, R={s['rounds']}, "
                f"drop={s['drop_rate']}, late={s['late_rate']}, "
                f"kills={s['kill_rounds']})")
