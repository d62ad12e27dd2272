"""Measured tiling autotuner for the flash-attention kernels
(``repro.kernels.autotune``).

The forward kernel (``csrc/flash_attn.cu``) and the backward pair
(``csrc/flash_attn_bwd.cu``) each have a fixed set of tilings per head_dim
(``plans.FLASH_FWD_TILINGS``, ``plans.FLASH_BWD_TILINGS``).  Rather than
guess which is fastest, this module measures: for a given (op, S,
head_dim, G) problem it times the kernel at every candidate tiling *and*
the ``online`` route (plain torch online softmax) on the card, persists the
winner to an on-disk JSON table, and serves lookups to

* ``ops.flash_attention``: which (block_q, block_k) to launch when the
  caller does not pin them (the forward's from the ``fwd`` entry, the
  backward's from the ``grad`` entry), and
* ``models.layers.resolve_attn_backend``: whether ``"auto"`` should take
  the kernel at all for that key (``fastest_route``).

A pair (block_q, block_k) is a tiling as the JAX package names its blocks:
block_q queries (a tiling's score rows // G) by block_k keys a tile.

Table location: ``$REPRO_TORCH_AUTOTUNE_DIR`` or
``<repo>/runs/autotune_torch/`` (git-ignored; ``runs/autotune/`` and
``$REPRO_AUTOTUNE_DIR`` are the JAX package's), file ``attn_table.json``.
Keys are the JAX package's, ``{op}|{platform}|S{S}|hd{head_dim}|G{G}``,
with ``op`` in {fwd, grad} and ``platform`` the card's name (lowercased,
spaces to ``_``: ``nvidia_h100_80gb_hbm3``), or ``cpu`` without a card,
which is never measured (the kernels do not run there), so a table tuned
on the card never changes a route on the CPU.  Entry schema: the JAX
package's, with its ``pallas`` named ``kernel``::

    {"route": "kernel" | "online",      # measured-fastest route
     "block_q": 16, "block_k": 32,      # best kernel tiling
     "best_kernel_ms": 0.49, "online_ms": 2.4,
     "kernel_ms": {"16x32": 0.49, ...},  # every candidate's time
     "reps": 3, "batch": 1, "kv_heads": 1}

``grad`` entries time the forward (at the tiling a call would launch: the
``fwd`` entry's pick, else the default) plus the backward pair at each
backward tiling.  Cached entries are authoritative: ``ensure`` never
re-measures an existing key unless ``force=True``, so two runs over the
same shapes produce identical picks (the ``--require-cached`` gate).

CLI (the card; ``--list`` anywhere)::

    PYTHONPATH=src python -m repro_torch.kernels.autotune \\
        --s-list 512 --head-dim 64 --g 4 --kv-heads 8 --ops fwd,grad
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import types
from typing import Dict, Optional, Tuple

from repro_torch.kernels import plans

TABLE_NAME = "attn_table.json"
_REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                          "..", "..", ".."))
DEFAULT_TABLE_DIR = os.path.join(_REPO_ROOT, "runs", "autotune_torch")
OPS = ("fwd", "grad")
# the candidates: the kernels' tilings (R score rows, BK keys) per head_dim;
# op "fwd" picks the forward's, "grad" the backward pair's
CANDIDATES = {"fwd": plans.FLASH_FWD_TILINGS, "grad": plans.FLASH_BWD_TILINGS}


@functools.lru_cache(maxsize=None)
def platform_key() -> str:
    """Measurement-validity domain for table keys: ``cpu`` without a CUDA
    card (never measured), else the card's name, lowercased, spaces to
    ``_``."""
    import torch
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(0).replace(" ", "_").lower()


def table_dir(dirname: Optional[str] = None) -> str:
    return (dirname or os.environ.get("REPRO_TORCH_AUTOTUNE_DIR")
            or DEFAULT_TABLE_DIR)


def table_path(dirname: Optional[str] = None) -> str:
    return os.path.join(table_dir(dirname), TABLE_NAME)


_CACHE: Dict[str, dict] = {}


def clear_cache() -> None:
    """Drop the in-process table cache (tests / after external writes)."""
    _CACHE.clear()


def load_table(dirname: Optional[str] = None) -> dict:
    path = table_path(dirname)
    if path not in _CACHE:
        tab = {}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    tab = json.load(f)
            except (json.JSONDecodeError, OSError):
                tab = {}
        _CACHE[path] = tab
    return _CACHE[path]


def _save(tab: dict, dirname: Optional[str]) -> str:
    os.makedirs(table_dir(dirname), exist_ok=True)
    path = table_path(dirname)
    with open(path, "w") as f:
        json.dump(tab, f, indent=1, sort_keys=True)
    _CACHE[path] = tab
    return path


def key_for(op: str, S: int, head_dim: int, G: int,
            platform: Optional[str] = None) -> str:
    assert op in OPS, op
    return f"{op}|{platform or platform_key()}|S{S}|hd{head_dim}|G{G}"


def lookup(op: str, S: int, head_dim: int, G: int,
           dirname: Optional[str] = None) -> Optional[dict]:
    return load_table(dirname).get(key_for(op, S, head_dim, G))


def kernel_pairs(op: str, head_dim: int, G: int) -> tuple:
    """The (block_q, block_k) pairs of op's kernel at (head_dim, G): its
    tilings that take G heads a group, default first."""
    return tuple(plans.tiling_blocks(t, G)
                 for t in plans.flash_tilings(head_dim, G, bwd=op == "grad"))


def best_blocks(S: int, head_dim: int, G: int, op: str = "fwd",
                dirname: Optional[str] = None) -> Optional[Tuple[int, int]]:
    """Measured-best (block_q, block_k) for the key, or None if untuned.

    Falls back to the other op's entry, as the JAX package does, but only
    where that entry's pair is also a tiling of op's kernel (the forward
    and the backward have tilings of their own)."""
    names = kernel_pairs(op, head_dim, G)
    for o in (op,) + tuple(x for x in OPS if x != op):
        e = lookup(o, S, head_dim, G, dirname)
        if e and "block_q" in e:
            pair = int(e["block_q"]), int(e["block_k"])
            if pair in names:
                return pair
    return None


def fastest_route(S: int, head_dim: int, G: int, op: str = "fwd",
                  dirname: Optional[str] = None) -> Optional[str]:
    """Measured-fastest route ('kernel' | 'online') for the exact key, or
    None when the key was never tuned on this platform."""
    e = lookup(op, S, head_dim, G, dirname)
    return e.get("route") if e else None


# ----------------------------------------------------------- measuring ----
def usable(S: int, G: int, pairs, tilings=None) -> list:
    """The candidate pairs ``measure`` times, as the JAX package filters
    them: deduplicated, without those whose score block [block_q * G,
    block_k] reaches [S, S] (a degenerate single-tile launch, never
    eligible to win); where that drops every pair, block_k of the smallest
    is halved (at least 8) to keep the key axis tiled.  The port does not
    clamp a pair to S (a tiling is fixed; the kernels mask the ragged
    edge), and where ``tilings`` (the kernel's pairs) are given and the
    halved pair is none of them, takes the tiling of that block_q with the
    largest block_k below the pair's, else the pair itself."""
    out, seen = [], set()
    for bq, bk in pairs:
        if bq * G >= S and bk >= S:
            continue
        if (bq, bk) not in seen:
            seen.add((bq, bk))
            out.append((bq, bk))
    if out:
        return out
    bq, bk = min(pairs)
    half = (bq, max(8, min(bk, S) // 2))
    if tilings is None or half in tilings:
        return [half]
    below = [t for t in tilings if t[0] == bq and t[1] < bk]
    return [max(below, key=lambda t: t[1])] if below else [(bq, bk)]


def _time_best(fn, reps: int) -> float:
    """Best of ``reps`` device times (ms, CUDA events) of ``fn()`` after
    one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        best = min(best, t0.elapsed_time(t1))
    return best


def measure(op: str, S: int, head_dim: int, G: int, *, kv_heads: int = 1,
            batch: int = 1, reps: int = 3, candidates=None,
            seed: int = 0) -> dict:
    """Time the kernel at every candidate tiling (``candidates``: (block_q,
    block_k) pairs of op's kernel; None: all of them) and the online route
    on the card, f32 operands [batch, S, kv_heads * G, head_dim]; return a
    table entry (does not persist; see :func:`ensure`).  ``fwd`` times the
    forward, ``grad`` the forward and the backward of the sum of O.
    Raises where there is no CUDA card: the kernels run only there."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import layers as L

    assert op in OPS, op
    if not torch.cuda.is_available():
        raise RuntimeError("autotune.measure times the CUDA kernels: it "
                           "needs a CUDA card")
    dev = torch.device("cuda")
    names = kernel_pairs(op, head_dim, G)
    pairs = usable(S, G, candidates or names, names)
    bad = [p for p in pairs if p not in names]
    if bad:
        raise ValueError(f"{bad} name no tiling of the {op} kernel at "
                         f"head_dim {head_dim}, G {G}: it takes {names}")
    cfg = types.SimpleNamespace(attn_softcap=0.0)
    B, KV, H = batch, kv_heads, kv_heads * G
    rng = np.random.default_rng(seed)
    q, k, v = (torch.as_tensor(rng.normal(size=(B, S, n, head_dim)),
                               dtype=torch.float32, device=dev)
               for n in (H, KV, KV))
    lengths = torch.full((B,), S, dtype=torch.int32, device=dev)

    def online(q, k, v):
        return L.online_gqa_attention(q, k, v, cfg, q_block=min(128, S),
                                      kv_block=min(L.ONLINE_KV_BLOCK, S))

    if op == "fwd":
        def kernel(bq, bk):
            return lambda: ops.flash_attention(q, k, v, lengths, block_q=bq,
                                               block_k=bk)

        def route():
            with torch.no_grad():
                online(q, k, v)
    else:
        qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
        fwd = ops.fwd_tiling(S, head_dim, G)

        def grad_of(f):
            return lambda: torch.autograd.grad(f(qg, kg, vg).sum(),
                                               (qg, kg, vg))

        def kernel(bq, bk):
            bwd = plans.flash_tiling(head_dim, G, bq, bk, bwd=True)
            return grad_of(lambda q, k, v: ops.FlashAttentionFn.apply(
                q, k, v, lengths, 0, 0.0, True, fwd, bwd)[0])

        route = grad_of(online)

    kernel_ms = {f"{bq}x{bk}": _time_best(kernel(bq, bk), reps)
                 for bq, bk in pairs}
    online_ms = _time_best(route, reps)
    best_key = min(kernel_ms, key=kernel_ms.get)
    bq, bk = (int(x) for x in best_key.split("x"))
    best = kernel_ms[best_key]
    return dict(route="kernel" if best < online_ms else "online",
                block_q=bq, block_k=bk,
                best_kernel_ms=round(best, 4),
                online_ms=round(online_ms, 4),
                kernel_ms={k_: round(t, 4) for k_, t in kernel_ms.items()},
                reps=reps, batch=batch, kv_heads=kv_heads)


def ensure(op: str, S: int, head_dim: int, G: int, *, kv_heads: int = 1,
           batch: int = 1, reps: int = 3, candidates=None, force: bool = False,
           dirname: Optional[str] = None) -> Tuple[dict, bool]:
    """Return (entry, measured): the cached entry if present (measured =
    False: cached picks are authoritative and deterministic), else
    measure, persist, and return it (measured = True)."""
    key = key_for(op, S, head_dim, G)
    tab = load_table(dirname)
    if key in tab and not force:
        return tab[key], False
    entry = measure(op, S, head_dim, G, kv_heads=kv_heads, batch=batch,
                    reps=reps, candidates=candidates)
    tab = dict(tab)
    tab[key] = entry
    _save(tab, dirname)
    return entry, True


# ------------------------------------------------------------------ CLI ----
def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Tune the flash-attention kernels' tiling (block_q, "
                    "block_k) per (op, S, head_dim, G) on the CUDA card and "
                    "persist winners to runs/autotune_torch/attn_table.json")
    ap.add_argument("--s-list", default="512,1024,2048",
                    help="comma-separated sequence lengths to tune")
    ap.add_argument("--head-dim", type=int, default=64,
                    help="attention head dim (Llama-3.2-1B's default)")
    ap.add_argument("--g", type=int, default=4,
                    help="query heads per KV head (GQA group size)")
    ap.add_argument("--kv-heads", type=int, default=1,
                    help="KV heads in the measurement problem")
    ap.add_argument("--batch", type=int, default=1,
                    help="batch rows in the measurement problem")
    ap.add_argument("--reps", type=int, default=3,
                    help="best-of-N timing repetitions")
    ap.add_argument("--ops", default="fwd,grad",
                    help="which ops to tune: fwd, grad or both")
    ap.add_argument("--table-dir", default=None,
                    help="table directory (default: "
                         "$REPRO_TORCH_AUTOTUNE_DIR or runs/autotune_torch)")
    ap.add_argument("--smoke", action="store_true",
                    help="quick shape: S=256 only, reps=1, 2 candidates")
    ap.add_argument("--force", action="store_true",
                    help="re-measure keys already in the table")
    ap.add_argument("--require-cached", action="store_true",
                    help="exit 1 if any key had to be measured (the "
                         "determinism gate: a second run must be all-cached)")
    ap.add_argument("--list", action="store_true",
                    help="print the current table and exit")
    a = ap.parse_args(argv)

    if a.list:
        tab = load_table(a.table_dir)
        print(json.dumps(tab, indent=1, sort_keys=True))
        print(f"{len(tab)} entries at {table_path(a.table_dir)}")
        return 0

    s_list = [int(s) for s in a.s_list.split(",") if s]
    reps = a.reps
    ops_ = [o.strip() for o in a.ops.split(",") if o.strip()]
    if a.smoke:
        s_list, reps = [256], 1
    measured_any = False
    for op in ops_:
        cands = kernel_pairs(op, a.head_dim, a.g)[:2] if a.smoke else None
        for S in s_list:
            entry, measured = ensure(
                op, S, a.head_dim, a.g, kv_heads=a.kv_heads, batch=a.batch,
                reps=reps, candidates=cands, force=a.force,
                dirname=a.table_dir)
            measured_any |= measured
            tag = "measured" if measured else "cached"
            print(f"  {key_for(op, S, a.head_dim, a.g):48s} -> "
                  f"{entry['route']:6s} bq={entry['block_q']} "
                  f"bk={entry['block_k']} "
                  f"(kernel {entry['best_kernel_ms']:.4f}ms vs online "
                  f"{entry['online_ms']:.4f}ms) [{tag}]")
    print(f"table: {table_path(a.table_dir)}")
    if a.require_cached and measured_any:
        print("FAIL: --require-cached but keys were (re)measured")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
