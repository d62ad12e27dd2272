"""Op inspection of one dry-run step (``repro.launch.hlo_tools``).

The JAX package reads the HLO text of one compiled step; the port has no
HLO, so this module reads what the port's dry run records: the
``analysis/walk.Trace`` of one step on one rank of a fake process group
(``launch/dryrun.trace_step``).  It finds the *largest* collective, copy
and slice ops with their shapes, so a hypothesis can name the exact tensor
whose movement it claims to remove.

Each recorded aten op maps to one of the JAX module's eight op classes
(:data:`OPS`), by its output bytes as JAX counts an HLO op's result
(ROADMAP C24):

* the five collectives: the ``_c10d_functional`` / ``c10d`` ops, as
  ``walk.collective_bytes`` names them;
* ``copy``: ``copy_``, ``clone`` (what ``contiguous`` dispatches) and
  ``_to_copy`` of a whole buffer;
* ``dynamic-update-slice``: writes into a slice (``slice_scatter``,
  ``select_scatter``, ``index_put_``, ``index_copy_``, or ``copy_`` into a
  view smaller than its storage);
* ``dynamic-slice``: reads of a slice into a new buffer (``index_select``,
  ``gather``, or a ``clone``, ``_to_copy`` or ``copy_`` whose source is a
  view smaller than its storage, as ``narrow`` followed by a copy).

Any other op is not counted, as JAX counts only those eight classes.
:func:`cost_analysis` is the counterpart of JAX's: the trace's FLOPs,
bytes and collective bytes (``dryrun.counts``).

Usage (runs on fake tensors; touches no device):
  PYTHONPATH=src python -m repro_torch.launch.hlo_tools --arch qwen2-7b \\
      --shape decode_32k [--top 15] [--depth 1]
"""
from __future__ import annotations

import argparse
from collections import defaultdict
from typing import List, Tuple

import torch

from repro_torch.analysis import walk

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")
# per-device traffic multiplier relative to the op's output bytes (ring algs)
COLLECTIVE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0,
                     "reduce-scatter": 1.0, "all-to-all": 1.0,
                     "collective-permute": 1.0}
OPS = COLLECTIVE_OPS + ("copy", "dynamic-update-slice", "dynamic-slice")

_COPIES = ("aten.copy_.", "aten.clone.", "aten._to_copy.")
_UPDATES = ("aten.slice_scatter.", "aten.select_scatter.",
            "aten.index_put_.", "aten.index_put.", "aten.index_copy_.",
            "aten.index_copy.")
_SLICES = ("aten.index_select.", "aten.gather.")


def _storage_bytes(trace) -> dict:
    """sid -> bytes of the storage behind it (roots, and every value a
    record allocated)."""
    sizes = dict(trace.roots)
    for r in trace.records:
        for o in r.outs:
            if o.new_bytes:
                sizes[o.sid] = o.new_bytes
    return sizes


def _smaller_than_storage(sizes: dict, sid: int, nbytes: int) -> bool:
    return nbytes < sizes.get(sid, nbytes)


def op_class(record, sizes: dict):
    """The JAX op class of one record (module docstring), or None."""
    if record.kind != "op":
        return None
    name = record.name
    ns, _, op = name.partition(".")
    if ns in ("_c10d_functional", "c10d"):
        for key, kind in walk._COLLECTIVES:
            if op.startswith(key):
                return kind
        return None
    if name.startswith(_UPDATES):
        return "dynamic-update-slice"
    if name.startswith(_SLICES):
        return "dynamic-slice"
    if not name.startswith(_COPIES) or not record.outs:
        return None
    out = record.outs[0]
    n = 1
    for d in out.shape:
        n *= d
    if name.startswith("aten.copy_."):
        # copy_(dst, src): dst is the output, src the second input
        if _smaller_than_storage(sizes, out.sid, walk.record_bytes(out)):
            return "dynamic-update-slice"
        src = record.ins[1] if len(record.ins) > 1 else None
        dt = record.in_dtypes[1] if len(record.in_dtypes) > 1 else out.dtype
    else:
        src = record.ins[0] if record.ins else None
        dt = record.in_dtypes[0] if record.in_dtypes else out.dtype
    if src is not None and _smaller_than_storage(
            sizes, src, n * getattr(torch, dt).itemsize):
        return "dynamic-slice"
    return "copy"


def _classified(trace, ops):
    """(bytes, class, record index, record) of every counted record."""
    sizes = _storage_bytes(trace)
    for i, r in enumerate(trace.records):
        kind = op_class(r, sizes)
        if kind in ops:
            yield float(sum(walk.record_bytes(o) for o in r.outs)), kind, i, r


def _line(i: int, r) -> str:
    outs = ", ".join(f"{o.dtype}[{','.join(map(str, o.shape))}]"
                     for o in r.outs)
    return f"#{i} {r.name} -> {outs}"[:180]


def collective_bytes(trace) -> dict:
    """``{op: bytes}`` over :data:`COLLECTIVE_OPS`: the collectives' output
    bytes (``walk.collective_bytes``); multiply by
    :data:`COLLECTIVE_FACTOR` for ring-algorithm wire traffic."""
    return walk.collective_bytes(trace)


def top_ops(trace, ops=OPS, top: int = 20) -> List[Tuple[float, str, str]]:
    """Largest ops by output bytes: (bytes, op class, line), at most
    ``top`` of them, largest first (program order among equals)."""
    found = [(b, kind, _line(i, r))
             for b, kind, i, r in _classified(trace, ops)]
    found.sort(key=lambda t: -t[0])
    return found[:top]


def op_totals(trace, ops=OPS) -> dict:
    """``{op class: output bytes}`` of the classes the trace holds."""
    tot = defaultdict(float)
    for b, kind, _, _ in _classified(trace, ops):
        tot[kind] += b
    return dict(tot)


def cost_analysis(trace) -> dict:
    """The trace's ``{"flops", "bytes", "coll"}`` (``dryrun.counts``), the
    port's counterpart of ``compiled.cost_analysis()``."""
    from repro_torch.launch import dryrun
    return dryrun.counts(trace)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--step", default=None)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--depth", type=int, default=1,
                    help="periods to keep; 0 = full depth")
    ap.add_argument("--multi", action="store_true")
    a = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import fake_mesh, mesh_config

    cfg = get_config(a.arch)
    if a.depth:
        cfg = DR._shallow_cfg(cfg, a.depth)
    shape = get_shape(a.shape)
    mc = mesh_config(multi_pod=a.multi)
    step = a.step or DR.STEP_FOR_SHAPE[shape.kind]
    idx = DR.mask_indices(cfg)[0] if step in ("zo_fl", "zo_dp") else None
    with fake_mesh(mc) as mesh:
        trace, _ = DR.trace_step(cfg, shape, mesh, mc, step, idx)
    totals = op_totals(trace)
    tops = top_ops(trace, top=a.top)
    print(f"== {a.arch} x {a.shape} ({step}) depth={a.depth or 'full'} ==")
    print("op totals (per-device bytes):")
    for op, b in sorted(totals.items(), key=lambda kv: -kv[1]):
        print(f"  {op:22s} {b / 1e6:12.1f} MB")
    print(f"\ntop {a.top} ops:")
    for b, op, line in tops:
        print(f"  {b / 1e6:10.1f} MB  {line}")
    return {"step": step, "totals": totals, "top": tops,
            "records": len(trace.records)}


if __name__ == "__main__":
    main()
