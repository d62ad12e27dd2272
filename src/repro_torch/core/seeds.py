"""Server seed ladder (paper Alg. 2: the server initializes a seed list
``{s_r^1..s_r^T}`` per round; clients and server derive identical Gaussian
perturbations from it — the basis of the virtual path).  The keys are those
of ``repro.core.seeds``, word for word (``core/prng.py``)."""
from __future__ import annotations

from repro_torch.core import prng


def round_keys(root_seed: int, rnd: int, T: int):
    """The T per-step keys [T, 2] for round ``rnd`` (shared by all clients).

    ``rnd`` may be negative (the VP calibration phase uses round -1); it is
    mapped into uint32 range for fold_in."""
    k = prng.fold_in(prng.key(root_seed), rnd & 0xFFFFFFFF)
    return prng.split(k, T)


def step_key(root_seed: int, rnd: int, t: int):
    return round_keys(root_seed, rnd, t + 1)[t]
