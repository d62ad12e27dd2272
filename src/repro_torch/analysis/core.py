"""Analysis framework: programs, artifacts, rules, runner, report
(``repro.analysis.core``).

A :class:`Program` is a registered hot path (``registry.py``) or fixture
(``fixtures.py``): its ``build(dev)`` returns a :class:`Built`, a callable
with concrete small arguments on the device ``dev`` and a ``meta`` dict
carrying the per-program rule configuration (thresholds, budgets,
allowlists).  The runner's ``dev=None`` means the CUDA card
(``utils.device.resolve_device``); the CPU runs only when the caller asks
for ``"cpu"``.

:class:`Artifacts` derives lazily what rules declare in ``needs``:
``"trace"`` (one recorded call, ``walk.record``: the counterpart of the
jaxpr), ``"collectives"`` (``{kind: bytes}`` of the collectives the call
dispatched, the counterpart of the HLO's) and ``"runtime"`` (a repeat call
with the same arguments, counting kernel builds and dynamo graphs).  A
fixture can pre-seed any artifact through ``Built.overrides``, e.g. the
collectives of the comm-budget twins, so their self-test needs no
process group.

The runner produces one JSON-stable report (``schema_version`` 1):
``results`` rows are ``(program, rule)`` pairs with ``ok``, ``findings``
(severity ``"error"`` gates the exit code, ``"warning"`` and ``"info"``
inform) and a ``skipped`` reason when a program cannot run here or a rule
does not apply to it.  A program whose recorded call raised fails every
rule that reads its trace.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.utils.device import resolve_device

SCHEMA_VERSION = 1


class ProgramSkip(Exception):
    """Raised by ``Program.build`` when the program cannot run in this
    process (a part of the JAX package the port does not have yet)."""


@dataclasses.dataclass
class Finding:
    rule: str
    program: str
    message: str
    severity: str = "error"          # "error" gates the exit code
    detail: Optional[dict] = None

    def to_json(self) -> dict:
        d = dict(rule=self.rule, program=self.program, message=self.message,
                 severity=self.severity)
        if self.detail:
            d["detail"] = self.detail
        return d


@dataclasses.dataclass
class Built:
    """One analyzable program instance."""
    fn: Callable                      # called as fn(*args)
    args: tuple                       # concrete small arguments
    meta: Dict = dataclasses.field(default_factory=dict)
    overrides: Dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class Program:
    name: str
    description: str
    build: Callable[[torch.device], Built]   # build(dev)


def _dynamo_graphs() -> int:
    """Graphs dynamo has compiled in this process (0 if it never loaded)."""
    utils = sys.modules.get("torch._dynamo.utils")
    return 0 if utils is None else int(
        utils.counters["stats"]["unique_graphs"])


class Artifacts:
    """Lazily derived views of one Built program on ``dev`` (where it was
    built), shared across rules so each program runs its recorded call at
    most once per analysis."""

    def __init__(self, built: Built, dev):
        self.built = built
        self.device = torch.device(dev)
        self._cache = dict(built.overrides)

    def trace(self):
        if "trace" not in self._cache:
            from repro_torch.analysis.walk import record
            self._cache["trace"] = record(self.built.fn, self.built.args,
                                          self.device)
        return self._cache["trace"]

    def collectives(self) -> Dict[str, float]:
        if "collectives" not in self._cache:
            from repro_torch.analysis.walk import collective_bytes
            self._cache["collectives"] = collective_bytes(self.trace())
        return self._cache["collectives"]

    def repeat(self) -> Dict[str, int]:
        """Kernel builds and dynamo graphs of a repeat call with the same
        arguments: a warm-up call, then the counted one.  The runner makes
        both before the recorded call, because dynamo does not compile a
        frame first met under a dispatch mode (and then never does)."""
        if "repeat" not in self._cache:
            from repro_torch.kernels import build
            rep = dict(builds=0, graphs=0)
            try:
                self.built.fn(*self.built.args)
                b0, g0 = build.builds, _dynamo_graphs()
                self.built.fn(*self.built.args)
                if self.device.type == "cuda":
                    torch.cuda.synchronize()
                rep = dict(builds=build.builds - b0,
                           graphs=_dynamo_graphs() - g0)
            except Exception as e:  # noqa: BLE001 - the trace reports it
                rep["raised"] = f"{type(e).__name__}: {e}"
            self._cache["repeat"] = rep
        return self._cache["repeat"]


class Rule:
    """One invariant.  ``needs`` names the artifacts the rule consumes;
    ``check`` returns findings, and an empty list means the invariant
    holds."""

    name: str = "rule"
    description: str = ""
    needs: Sequence[str] = ("trace",)

    def applicable(self, built: Built) -> bool:
        return True

    def check(self, program: str, built: Built,
              artifacts: Artifacts) -> List[Finding]:
        raise NotImplementedError

    # -- helpers -----------------------------------------------------------
    def allow(self, built: Built) -> tuple:
        """Per-program allowlist for this rule: ``meta["allow"][rule]``."""
        return tuple(built.meta.get("allow", {}).get(self.name, ()))

    def finding(self, program: str, message: str, severity: str = "error",
                **detail) -> Finding:
        return Finding(self.name, program, message, severity,
                       detail or None)


def check_rules(program: str, built: Built, artifacts: Artifacts,
                rules: Sequence[Rule]) -> List[dict]:
    """The rows of ``rules`` over one built program's artifacts."""
    rows = []
    for rule in rules:
        row = dict(program=program, rule=rule.name)
        if not rule.applicable(built):
            row.update(ok=True, skipped="not applicable", findings=[])
            rows.append(row)
            continue
        findings = rule.check(program, built, artifacts)
        if "trace" in rule.needs and artifacts.trace().raised:
            findings.insert(0, rule.finding(
                program, f"the recorded call raised "
                f"{artifacts.trace().raised}"))
        errors = [f for f in findings if f.severity == "error"]
        row.update(ok=not errors,
                   findings=[f.to_json() for f in findings])
        rows.append(row)
    return rows


def run_program(program: Program, rules: Sequence[Rule],
                dev=None) -> List[dict]:
    """All requested rules over one program built on ``dev`` (None: the
    card); one result row per rule.  The program runs in a process group:
    the caller's, or a one-rank group joined for it
    (``launch/mesh.process_group``), where a mesh program's ``1x1`` mesh
    lives."""
    from repro_torch.launch.mesh import process_group
    dev = resolve_device(dev)
    with process_group(dev.type):
        try:
            built = program.build(dev)
        except ProgramSkip as e:
            return [dict(program=program.name, rule=r.name, ok=True,
                         skipped=str(e), findings=[]) for r in rules]
        artifacts = Artifacts(built, dev)
        if built.meta.get("runtime", True) and any(
                "runtime" in r.needs and r.applicable(built) for r in rules):
            artifacts.repeat()  # before the recorded call (Artifacts.repeat)
        return check_rules(program.name, built, artifacts, rules)


def run_analysis(programs: Sequence[Program], rules: Sequence[Rule],
                 dev=None) -> dict:
    """Every rule over every program, on ``dev`` (None: the card)."""
    d = resolve_device(dev)
    results = []
    for program in programs:
        results.extend(run_program(program, rules, d))
    name = torch.cuda.get_device_name(d) if d.type == "cuda" else "cpu"
    n_dev = torch.cuda.device_count() if d.type == "cuda" else 1
    violations = sum(1 for r in results for f in r["findings"]
                     if f["severity"] == "error")
    return dict(
        schema_version=SCHEMA_VERSION,
        torch_version=torch.__version__,
        device=name,
        n_devices=n_dev,
        programs=[p.name for p in programs],
        rules=[r.name for r in rules],
        results=results,
        violations=violations,
        ok=violations == 0,
    )


def write_report(report: dict, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    return path
