"""The rule catalog (``repro.analysis.rules``): the same six invariants,
over a recorded eager call instead of a jaxpr.

Each rule reads per-program configuration from ``Built.meta``:

* ``seq_threshold``: the S of the dense-materialization scan (it must
  exceed every non-sequence dim of the program, so that only a genuine
  [S, S]-class tensor trips it); absent, the rule does not apply.
* ``dense_limit``: how many >= S dims make a violation (default 2).
* ``allow``: ``{rule_name: (op name, ...)}`` allowlists; an allowlisted
  op's outputs are exempt (say why at the registry site).
* ``const_bytes_limit``: the recompile rule's gate on tensors built from
  host data during the call (default 4 KiB).
* ``runtime``: False skips the repeat-call check.
* ``comm``: the comm-budget configuration (its presence enables the rule):
  ``param_bytes``, ``allgather_max_bytes``, ``other_collective_max_bytes``
  and optionally ``expected_up_bytes`` + ``commlog_up_bytes``.
* ``peak_bytes_budget``: the liveness-estimate ceiling (absent, the
  estimate is reported as info only).
* ``smem_budget_bytes``: the per-block shared-memory ceiling of kernel
  launches; by default the device's opt-in limit, or on the CPU the
  H100's (``SMEM_BUDGETS``).

Two JAX checks have no eager counterpart and are left out: the
literal-dim warning of the recompile rule (nothing is traced, so no
literal is baked in) and the HLO walk of the comm rule (collectives are
counted as ``torch.distributed`` dispatches them).
"""
from __future__ import annotations

from typing import List

from repro_torch.analysis.core import Built, Finding, Rule
from repro_torch.analysis.walk import (constant_records, iter_ops,
                                       kernel_block_records, liveness,
                                       square_dim_findings, tensors_of)
from repro_torch.kernels import plans

MAX_REPORTED = 8          # cap repeated findings per (rule, program)

# per-block shared-memory budgets of a kernel launch (bytes): the opt-in
# limit of the card, read from the device there; the H100's on the CPU
SMEM_BUDGETS = {"h100": plans.H100_SMEM_OPTIN}

F64_DTYPES = ("float64", "complex128")
LOWP_DTYPES = ("bfloat16", "float16")
# reductions whose output dtype is their accumulator's as PyTorch returns
# it: a low-precision output here means a low-precision result of a long
# sum (the kernels accumulate in f32)
REDUCE_OPS = ("aten.sum", "aten.mean", "aten.cumsum", "aten.mm", "aten.bmm",
              "aten.addmm", "aten.dot", "aten.prod", "aten.baddbmm",
              "aten.addmv", "aten.mv", "aten.matmul", "aten.cumprod",
              "aten.logsumexp", "aten.var", "aten.std", "aten.norm",
              "aten.linalg_vector_norm")
# ops whose output shape depends on the data, so the host waits for it
DATA_SHAPE_OPS = ("aten.nonzero", "aten.masked_select", "aten.unique",
                  "aten._unique", "aten._unique2", "aten.unique_dim",
                  "aten.unique_consecutive", "aten.repeat_interleave.Tensor",
                  "aten.masked_scatter")
BOOL_INDEX_OPS = ("aten.index", "aten.index_put", "aten.index_put_")
COPY_OPS = ("aten._to_copy", "aten.copy_")


def _base(name: str) -> str:
    """'aten.sum.dim_IntList' -> 'aten.sum'."""
    return ".".join(name.split(".")[:2])


def check_no_dense_intermediates(trace, S: int, limit: int = 2,
                                 allow=()) -> List[dict]:
    """The dense-materialization scan as a standalone predicate: the
    offending ``{op, shape, dtype}`` records; empty means no op or kernel
    output holds ``limit`` dims of size >= ``S``."""
    return square_dim_findings(trace, S, limit=limit, allow=allow)


class DenseMaterializationRule(Rule):
    """No op or kernel output may hold >= ``dense_limit`` dims of size >=
    ``seq_threshold``: the generalized no-[S, S] / no-[K, P] proof.  Kernel
    records count by their returned tensors only, so a kernel whose plain
    version builds the score matrix on the CPU passes as its kernel does on
    the card."""

    name = "dense-materialization"
    description = "no [S,S]/[K,P]-class dense intermediates"
    needs = ("trace",)

    def applicable(self, built: Built) -> bool:
        return built.meta.get("seq_threshold") is not None

    def check(self, program, built, artifacts):
        S = built.meta["seq_threshold"]
        limit = built.meta.get("dense_limit", 2)
        recs = check_no_dense_intermediates(artifacts.trace(), S, limit,
                                            self.allow(built))
        return [self.finding(
            program, f"{r['op']} materializes {r['dtype']}{r['shape']} "
            f"({limit}+ dims >= {S})", **r) for r in recs[:MAX_REPORTED]]


class DtypeDriftRule(Rule):
    """No f64 tensor anywhere (inputs or outputs: one Python-double
    promotion doubles every buffer it touches and leaves the f32 path),
    and no bf16/f16 output of a reduction."""

    name = "dtype-drift"
    description = "no f64 tensors; no f16/bf16 reduction results"
    needs = ("trace",)

    def check(self, program, built, artifacts):
        allow = self.allow(built)
        out: List[Finding] = []
        for t in tensors_of(built.args):
            if str(t.dtype).replace("torch.", "") in F64_DTYPES:
                out.append(self.finding(
                    program, f"f64 input {list(t.shape)}",
                    dtype=str(t.dtype)))
        for r in iter_ops(artifacts.trace()):
            if r.name in allow:
                continue
            for o in r.outs:
                if o.dtype in F64_DTYPES:
                    out.append(self.finding(
                        program, f"{r.name} produces {o.dtype} "
                        f"{list(o.shape)}", op=r.name, dtype=o.dtype))
                elif o.dtype in LOWP_DTYPES and _base(r.name) in REDUCE_OPS:
                    out.append(self.finding(
                        program, f"{r.name} returns a {o.dtype} reduction "
                        f"(reduce in f32)", op=r.name, dtype=o.dtype))
        return out[:MAX_REPORTED]


def host_sync_records(trace) -> List[dict]:
    """The records that make the host wait for the device: reading a value
    (``_local_scalar_dense``: ``.item()``, ``float()``, ``bool()``), an op
    whose output shape depends on the data, a copy from the device to the
    host, and a blocking copy from the host to the device (PyTorch
    synchronizes the stream after it)."""
    out = []
    for r in iter_ops(trace, "op"):
        base = _base(r.name)
        why = None
        if base == "aten._local_scalar_dense":
            why = "reads a tensor's value on the host"
        elif base in DATA_SHAPE_OPS or r.name in DATA_SHAPE_OPS:
            why = "has an output shape that depends on the data"
        elif base in BOOL_INDEX_OPS and "bool" in r.in_dtypes[1:]:
            why = "indexes with a boolean mask (a nonzero inside)"
        elif base in COPY_OPS and r.outs:
            src = {d for d in r.in_devices if d != "cpu"}
            dst = r.outs[0].device
            if src and dst == "cpu":
                why = "copies from the device to the host"
            elif (dst != "cpu" and "cpu" in r.in_devices
                  and not r.kwargs.get("non_blocking")):
                why = "copies from the host to the device and waits"
        if why:
            out.append(dict(op=r.name, why=why))
    return out


class HostSyncRule(Rule):
    """No host round-trips in a hot path (:func:`host_sync_records`): at
    ZO-step or decode-step granularity one stray ``.item()`` costs more
    than the step.  On the card ``chip_smoke.py`` holds this rule against
    ``torch.cuda.set_sync_debug_mode``."""

    name = "host-sync"
    description = "no value reads, data-shaped ops or blocking copies"
    needs = ("trace",)

    def check(self, program, built, artifacts):
        allow = self.allow(built)
        return [self.finding(program, f"{r['op']} {r['why']}", **r)
                for r in host_sync_records(artifacts.trace())
                if r["op"] not in allow][:MAX_REPORTED]


class RecompileHazardRule(Rule):
    """Two signals that a hot path rebuilds or recompiles:

    1. (error) a tensor built from host data during the call above
       ``const_bytes_limit``: an array shipped to the device on every call
       (the counterpart of a big baked-in jaxpr constant).
    2. (error) a repeat call with identical arguments that builds a kernel
       library (``kernels/build.py``) or compiles a dynamo graph: the hot
       path recompiles at steady state.
    """

    name = "recompile-hazard"
    description = "no host-data tensors per call; no steady-state rebuild"
    needs = ("trace", "runtime")

    def check(self, program, built, artifacts):
        out: List[Finding] = []
        limit = built.meta.get("const_bytes_limit", 4096)
        for rec in constant_records(artifacts.trace()):
            if rec["bytes"] > limit:
                out.append(self.finding(
                    program, f"tensor built from host data {rec['dtype']}"
                    f"{rec['shape']} ({rec['bytes']} B > {limit} B) on "
                    f"every call", **rec))
        if built.meta.get("runtime", True):
            rep = artifacts.repeat()
            if rep.get("raised"):
                out.append(self.finding(
                    program, f"the repeat call raised {rep['raised']}"))
            elif rep["builds"] or rep["graphs"]:
                out.append(self.finding(
                    program, f"a repeat call with identical arguments built "
                    f"{rep['builds']} kernel librar(ies) and compiled "
                    f"{rep['graphs']} dynamo graph(s): the hot path "
                    f"recompiles at steady state", **rep))
        return out


class CommBudgetRule(Rule):
    """The paper's headline invariant: the uplink stays O(seeds + scalars),
    never O(model).  The only model-sized collective allowed is the
    parameter all-gather (bounded by ``allgather_max_bytes``); everything
    else must fit ``other_collective_max_bytes``; a live round's CommLog
    uplink must equal the protocol's 4*K*T*n_dirs bytes."""

    name = "comm-budget"
    description = "collective bytes: gather <= plan budget, uplink O(scalars)"
    needs = ("collectives",)

    def applicable(self, built: Built) -> bool:
        return bool(built.meta.get("comm"))

    def check(self, program, built, artifacts):
        comm = built.meta["comm"]
        coll = artifacts.collectives()
        out = []
        ag = coll.get("all-gather", 0.0)
        others = sum(v for k, v in coll.items() if k != "all-gather")
        ag_max = comm.get("allgather_max_bytes")
        if ag_max is not None and ag > ag_max:
            out.append(self.finding(
                program, f"all-gather bytes {ag:.0f} exceed the plan's "
                f"parameter-gather budget {ag_max:.0f}", bytes=ag,
                budget=ag_max, collectives=coll))
        other_max = comm.get("other_collective_max_bytes")
        if other_max is not None and others > other_max:
            out.append(self.finding(
                program, f"non-gather collective bytes {others:.0f} exceed "
                f"the O(seeds+scalars) budget {other_max:.0f}",
                bytes=others, budget=other_max, collectives=coll))
        up = comm.get("commlog_up_bytes")
        expected = comm.get("expected_up_bytes")
        if up is not None and expected is not None and up != expected:
            out.append(self.finding(
                program, f"CommLog uplink {up} B != protocol accounting "
                f"{expected} B (4*K*T*n_dirs)", up=up, expected=expected))
        pb = comm.get("param_bytes")
        if up is not None and pb is not None and up * 8 > pb:
            out.append(self.finding(
                program, f"uplink {up} B is O(model) ({pb} B of "
                f"parameters): the scalar-only protocol is broken",
                up=up, param_bytes=pb))
        if not out:
            out.append(self.finding(
                program, f"collectives within budget: "
                f"all-gather {ag:.0f} B, other {others:.0f} B",
                severity="info", collectives=coll))
        return out


class MemoryCeilingRule(Rule):
    """The liveness estimate of the call's peak live bytes against
    ``peak_bytes_budget`` (always reported), and every kernel launch's
    shared bytes a block against the per-block limit (the counterpart of
    the Pallas block's VMEM working set)."""

    name = "memory-ceiling"
    description = "peak live bytes under budget; kernel blocks fit shared memory"
    needs = ("trace",)

    def check(self, program, built, artifacts):
        out: List[Finding] = []
        trace = artifacts.trace()
        peak = liveness(trace)["peak_bytes"]
        budget = built.meta.get("peak_bytes_budget")
        if budget is not None and peak > budget:
            out.append(self.finding(
                program, f"liveness peak estimate {peak} B exceeds budget "
                f"{budget} B", peak_bytes=peak, budget=budget))
        else:
            out.append(self.finding(
                program, f"liveness peak estimate {peak} B"
                + (f" (budget {budget} B)" if budget else ""),
                severity="info", peak_bytes=peak))
        smem = built.meta.get("smem_budget_bytes") or trace.smem_optin \
            or SMEM_BUDGETS["h100"]
        for rec in kernel_block_records(trace):
            if rec["block_bytes"] > smem:
                out.append(self.finding(
                    program, f"{rec['name']} ({rec['kernel']}) asks "
                    f"{rec['block_bytes']} B of shared memory a block, over "
                    f"the {smem} B limit", budget=smem, **rec))
        return out


ALL_RULES = (DenseMaterializationRule(), DtypeDriftRule(), HostSyncRule(),
             RecompileHazardRule(), CommBudgetRule(), MemoryCeilingRule())


def rules_by_name(names=None):
    table = {r.name: r for r in ALL_RULES}
    if names is None:
        return list(ALL_RULES)
    missing = [n for n in names if n not in table]
    if missing:
        raise KeyError(f"unknown rule(s) {missing}; "
                       f"have {sorted(table)}")
    return [table[n] for n in names]
