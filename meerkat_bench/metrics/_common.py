"""Helpers the per-layer metric readers share: the traced window, the
card's peaks, kernel time by name.  A reader returns None where it finds
nothing to read, and the harness then leaves its metric out."""
from __future__ import annotations

import re

from meerkat_bench import flops

GEMM = re.compile(r"gemm|gemv|xmma|cutlass", re.I)


def traced(h):
    """The run's DeviceTrace once its window closed, else None."""
    t = h.tracer
    if t is None or t.window is None or not t.kernels:
        return None
    return t


def peaks(h):
    import torch
    if h.device.type != "cuda":
        return None
    return flops.peaks(torch.cuda.get_device_name(0))


def share(part: float, whole: float):
    return None if not whole or part is None else 100.0 * part / whole
