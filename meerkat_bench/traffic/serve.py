"""Serving traffic from a workload file and the run's seed: an open loop of
independent users, requests sent on a schedule at a fixed mean rate
whether or not earlier ones have finished.

Prompt and output lengths are lognormal (median, sigma), clipped, and the
gaps between arrivals exponential (mean 1, scaled by 1 / rate); all three
are drawn once from the workload's fixed ``length_seed`` into a pool of
``pool`` requests, sent in pool order.  The run's seed shuffles the
requests within each block of ``block`` consecutive ones and draws the
prompt tokens (uniform over ``[0, vocab)``), so every seed serves the same
sizes and gaps, in another order, in every stretch of the run: a seed
does not change the work a window holds.
"""
from __future__ import annotations

import numpy as np


def lengths(spec: dict, n: int, rng) -> np.ndarray:
    x = np.exp(np.log(spec["median"]) + spec["sigma"] * rng.standard_normal(n))
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def pool(wl: dict) -> tuple:
    """(sizes [pool, 2] of (prompt, output) lengths, gaps [pool])."""
    rng = np.random.default_rng(wl["length_seed"])
    n = wl["pool"]
    sizes = np.stack([lengths(wl["prompt"], n, rng),
                      lengths(wl["output"], n, rng)], axis=1)
    return sizes, rng.exponential(1.0, size=n)


class Arrivals:
    """The run's requests in the order they arrive, each with its due time
    (seconds after the schedule's start) at ``rate`` requests a second."""

    def __init__(self, wl: dict, vocab: int, seed: int, rate: float):
        self.sizes, self.gaps = pool(wl)
        self.rng = np.random.default_rng(int(seed))
        n, b = len(self.sizes), int(wl["block"])
        self.order = self.rng.permuted(np.arange(n).reshape(n // b, b),
                                       axis=1).reshape(-1)
        self.vocab = vocab
        self.rate = float(rate)
        self.i = 0
        self.t = 0.0

    def peek(self) -> float:
        """The next request's due time."""
        return self.t + self.gaps[self.order[self.i % len(self.order)]] \
            / self.rate

    def next(self):
        """(due time, prompt tokens int32 [P], output length)."""
        j = self.order[self.i % len(self.order)]
        self.t += self.gaps[j] / self.rate
        self.i += 1
        p, o = self.sizes[j]
        toks = self.rng.integers(0, self.vocab, size=int(p), dtype=np.int64)
        return self.t, toks.astype(np.int32), int(o)
