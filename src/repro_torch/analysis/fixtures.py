"""Known-bad and known-good fixture programs: the analyzer's self-test
(``repro.analysis.fixtures``, the same 15).

Every rule ships at least one deliberately broken program it must flag
and a minimal clean twin it must pass, so the analyzer itself is
falsifiable (``python -m repro_torch.analysis --selftest`` / ``--fixture
<rule>``; ``tests/test_torch_analysis.py`` runs the same matrix).  Each
builder takes the device to build on.

Two differ in form from the JAX package's: the bad retrace is a
``torch.compile`` function that reads a Python int its caller bumps on
every call, as a step counter would (a fresh ``jit`` per call does not
recompile in PyTorch: dynamo caches by code object); the host-sync bad one
prints ``.item()`` of a sum.  The memory-ceiling fixtures launch the
``fixture_double`` kernel (``kernels/csrc/fixture_double.cu``), the port
of the JAX fixtures' Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.analysis.core import Built, Program

_S = 128


def _ones(dev, *shape, dtype=torch.float32):
    return torch.ones(shape, dtype=dtype, device=dev)


# ---------------------------------------------------- dense fixtures ------
def _dense_bad(dev) -> Built:
    def fn(q, k):           # materialized [S, S] score matrix
        return (torch.einsum("sd,td->st", q, k) ** 2).sum()

    q = _ones(dev, _S, 16)
    return Built(fn, (q, q), meta=dict(seq_threshold=_S))


def _dense_good(dev) -> Built:
    def fn(q, k):           # same reduction, no [S, S] tensor
        return ((q * k).sum(-1) ** 2).sum()

    q = _ones(dev, _S, 16)
    return Built(fn, (q, q), meta=dict(seq_threshold=_S))


# ---------------------------------------------------- dtype fixtures ------
def _dtype_bad(dev) -> Built:
    def fn(x, y):
        # a bf16 reduction, and an f64 input doubled
        return x.to(torch.bfloat16).sum(), y * 2.0

    return Built(fn, (_ones(dev, 8), _ones(dev, 8, dtype=torch.float64)),
                 meta=dict(runtime=False))


def _dtype_good(dev) -> Built:
    def fn(x, y):
        return x.sum(), y * 2.0

    x = _ones(dev, 8)
    return Built(fn, (x, x))


# ------------------------------------------------- host-sync fixtures -----
def _hostsync_bad(dev) -> Built:
    def fn(x):
        print(f"loss={x.sum().item()}")   # reads the value on the host
        return x * 2.0

    return Built(fn, (_ones(dev, 8),))


def _hostsync_good(dev) -> Built:
    def fn(x):
        return x * 2.0

    return Built(fn, (_ones(dev, 8),))


# ------------------------------------------------- recompile fixtures -----
def _recompile_bad_const(dev) -> Built:
    table = np.arange(8192, dtype=np.float32)    # 32 KiB of host data

    def fn(x):
        return x + torch.as_tensor(table, device=x.device)[: x.shape[0]]

    return Built(fn, (_ones(dev, 8),), meta=dict(runtime=False))


def _recompile_bad_retrace(dev) -> Built:
    import torch._dynamo

    # a fresh cache, so earlier builds in this process do not spend the
    # recompile limit of the body's code object
    torch._dynamo.reset()
    state = {"step": 0}

    @torch.compile(backend="eager", dynamic=False)
    def body(x):
        return x * 2.0 + state["step"]

    def fn(x):
        state["step"] += 1      # the caller's step counter, read as a constant
        return body(x)

    return Built(fn, (_ones(dev, 8),))


def _recompile_good(dev) -> Built:
    body = torch.compile(lambda x: x * 2.0 + 1.0, backend="eager")
    return Built(body, (_ones(dev, 8),))


# ------------------------------------------------------ comm fixtures -----
# the collectives of the JAX fixtures' synthetic HLO (_HLO_BAD, _HLO_GOOD),
# as repro.launch.hlo_tools.collective_bytes counts them: an all-gather of
# f32[4000000] and an all-reduce of f32[1000000]; a gather of f32[1000000]
# and an all-reduce of f32[16]
_COLL_BAD = {"all-reduce": 4_000_000.0, "all-gather": 16_000_000.0,
             "reduce-scatter": 0.0, "all-to-all": 0.0,
             "collective-permute": 0.0}
_COLL_GOOD = {"all-reduce": 64.0, "all-gather": 4_000_000.0,
              "reduce-scatter": 0.0, "all-to-all": 0.0,
              "collective-permute": 0.0}


def _comm_bad(dev) -> Built:
    # O(model) uplink + blown gather budget + CommLog mismatch, given as
    # collectives so the self-test needs no process group
    pb = 4_000_000
    return Built(lambda: None, (), overrides={"collectives": dict(_COLL_BAD)},
                 meta=dict(comm=dict(
                     param_bytes=pb, allgather_max_bytes=3 * pb // 4,
                     other_collective_max_bytes=2 ** 16,
                     expected_up_bytes=64, commlog_up_bytes=pb)))


def _comm_good(dev) -> Built:
    pb = 1_000_000
    return Built(lambda: None, (),
                 overrides={"collectives": dict(_COLL_GOOD)},
                 meta=dict(comm=dict(
                     param_bytes=pb, allgather_max_bytes=4 * pb,
                     other_collective_max_bytes=2 ** 16,
                     expected_up_bytes=64, commlog_up_bytes=64)))


# ---------------------------------------------------- memory fixtures -----
def _memory_bad_peak(dev) -> Built:
    def fn(x):               # 64 MiB [4096, 4096] f32 intermediate
        return torch.outer(x, x).sum()

    return Built(fn, (_ones(dev, 4096),),
                 meta=dict(peak_bytes_budget=8 * 2 ** 20, runtime=False))


def _memory_bad_smem(dev) -> Built:
    from repro_torch.kernels import ops

    def fn(x):               # 16 MiB in + 16 MiB out in one block
        return ops.fixture_double(x, block_rows=x.shape[0])

    return Built(fn, (_ones(dev, 2048, 2048),), meta=dict(runtime=False))


def _memory_bad_residual_stack(dev) -> Built:
    """Differentiating a loop over query blocks keeps every block's [blk, S]
    softmax for the backward: O(S^2) live bytes.  The budget is
    recompute-sized (O(S*dh), what the flash kernel's backward keeps), so
    the kept residuals must trip it."""
    S, blk, dh = 1024, 128, 16

    def attn_loss(q, k):
        total = 0.0
        for qi in q.split(blk):
            p = torch.softmax(qi @ k.T, dim=-1)   # [blk, S], kept for grad
            total = total + (p @ k).sum()
        return total

    def fn(q, k):
        q = q.detach().requires_grad_()
        k = k.detach().requires_grad_()
        return torch.autograd.grad(attn_loss(q, k), (q, k))

    q = _ones(dev, S, dh)
    # O(S*dh) residuals are ~64 KiB here; the kept [S/blk, blk, S] scores
    # are ~4 MiB
    return Built(fn, (q, q), meta=dict(peak_bytes_budget=2 * 2 ** 20,
                                       runtime=False))


def _memory_good(dev) -> Built:
    from repro_torch.kernels import ops

    def fn(x):
        y = ops.fixture_double(x, block_rows=x.shape[0])
        return (y * x).sum()

    return Built(fn, (_ones(dev, 128, 128),),
                 meta=dict(peak_bytes_budget=8 * 2 ** 20))


FIXTURES: Dict[str, Dict[str, List[Program]]] = {
    "dense-materialization": dict(
        bad=[Program("fixture:dense:bad", "materialized [S,S] scores",
                     _dense_bad)],
        good=[Program("fixture:dense:good", "blockwise-style reduction",
                      _dense_good)]),
    "dtype-drift": dict(
        bad=[Program("fixture:dtype:bad", "f64 tensor + bf16 reduction",
                     _dtype_bad)],
        good=[Program("fixture:dtype:good", "f32 throughout",
                      _dtype_good)]),
    "host-sync": dict(
        bad=[Program("fixture:host-sync:bad", "print(.item()) in path",
                     _hostsync_bad)],
        good=[Program("fixture:host-sync:good", "pure fn", _hostsync_good)]),
    "recompile-hazard": dict(
        bad=[Program("fixture:recompile:bad-const",
                     "32 KiB host array per call", _recompile_bad_const),
             Program("fixture:recompile:bad-retrace",
                     "compiled fn reading a bumped int", _recompile_bad_retrace)],
        good=[Program("fixture:recompile:good", "stable compiled fn",
                      _recompile_good)]),
    "comm-budget": dict(
        bad=[Program("fixture:comm:bad",
                     "O(model) uplink / blown gather budget", _comm_bad)],
        good=[Program("fixture:comm:good", "gather + scalar all-reduce only",
                      _comm_good)]),
    "memory-ceiling": dict(
        bad=[Program("fixture:memory:bad-peak", "64 MiB dense outer",
                     _memory_bad_peak),
             Program("fixture:memory:bad-vmem",
                     "32 MiB kernel block working set", _memory_bad_smem),
             Program("fixture:memory:bad-residual-stack",
                     "kept attention residuals under autograd vs a "
                     "recompute-sized budget", _memory_bad_residual_stack)],
        good=[Program("fixture:memory:good", "small blocks, small peak",
                      _memory_good)]),
}
