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
