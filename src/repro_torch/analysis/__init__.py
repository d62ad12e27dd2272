"""Rule-based static analysis of recorded PyTorch programs
(``repro.analysis`` in torch): prove the hot-path invariants the port's
performance rests on: no dense [S, S]/[K, P] intermediates, no dtype
drift, no host syncs, no steady-state rebuilds, collective bytes within the
FL comm budget, peak bytes and per-block shared memory under their
ceilings.

The JAX package analyzes jaxprs and compiled HLO; PyTorch runs eagerly, so
the port analyzes one real call recorded op by op (``walk.py``), with
every kernel wrapper as one record that carries its launch plan.

Entry points: ``python -m repro_torch.analysis`` (the CLI over the
registered hot paths in ``registry.py``), :data:`ALL_RULES` /
:data:`HOT_PATHS` for programmatic use, and
:func:`check_no_dense_intermediates` / :func:`max_square_dims` as
standalone predicates over a trace.  Attribute access is lazy (PEP 562),
so importing the package imports no module of it.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "Artifacts": "core", "Built": "core", "Finding": "core",
    "Program": "core", "ProgramSkip": "core", "Rule": "core",
    "run_analysis": "core", "run_program": "core", "write_report": "core",
    "ALL_RULES": "rules", "rules_by_name": "rules",
    "check_no_dense_intermediates": "rules", "host_sync_records": "rules",
    "HOT_PATHS": "registry", "programs_by_name": "registry",
    "FIXTURES": "fixtures",
    "record": "walk", "max_square_dims": "walk",
    "square_dim_findings": "walk", "liveness": "walk",
    "liveness_peak_bytes": "walk", "kernel_block_records": "walk",
    "iter_ops": "walk", "record_bytes": "walk", "constant_records": "walk",
    "collective_bytes": "walk",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.analysis' has no "
                             f"attribute {name!r}")
    return getattr(importlib.import_module(f"repro_torch.analysis.{mod}"),
                   name)
