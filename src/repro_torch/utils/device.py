"""Where the port's entry points run."""
from __future__ import annotations

import torch

from repro_torch.utils.tree import tree_leaves


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card, which must then be present; the CPU
    runs only when the caller asks for it (``device="cpu"``, as the tests
    do).  Nothing falls back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)


def check_params_on(params, device: torch.device) -> None:
    """Raise unless every leaf of the parameter tree lives on ``device``'s
    kind of device (an entry point never moves parameters itself)."""
    for p in tree_leaves(params):
        if p.device.type != device.type:
            raise ValueError(f"params live on {p.device}, not {device}")


def rank_device(device_type: str, local_rank: int) -> torch.device:
    """The device of one rank of a process group: ``cuda:{local_rank}``
    on the card (which must be there: one card per rank, and nothing falls
    back to the CPU), or the CPU when ``device_type`` is ``"cpu"``."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"ranks run on 'cuda' or 'cpu', not {device_type!r}")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local_rank >= n:
        raise RuntimeError(
            f"rank {local_rank} needs cuda:{local_rank}, but {n} CUDA "
            "device(s) are visible (one card per rank)")
    return torch.device(f"cuda:{local_rank}")
