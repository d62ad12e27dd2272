"""CLI body of ``python -m repro_torch.analysis``.

The flags are the JAX package's (``repro.analysis.cli``) except
``--devices``, which becomes ``--device cpu|cuda``: the programs run on
the CUDA card unless ``--device cpu`` is given, and without a card the CLI
exits 2 before running anything.  Exit codes: 0 = all invariants hold,
1 = violations (or a failed selftest), 2 = a usage or internal error.
"""
from __future__ import annotations

import argparse
import sys
import traceback

DEFAULT_OUT = "runs/analysis/ANALYSIS_torch.json"
SMOKE_OUT = "runs/analysis/ANALYSIS_torch_smoke.json"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static analysis of the registered hot paths: rules "
                    "over one recorded call of each, proving the port's "
                    "structural invariants.")
    ap.add_argument("--all", action="store_true",
                    help="run every rule over every registered hot path "
                         "(the default when no mode flag is given)")
    ap.add_argument("--programs", default=None,
                    help="comma-separated registry subset")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset")
    ap.add_argument("--out", default=None,
                    help=f"report path (default {DEFAULT_OUT})")
    ap.add_argument("--smoke", action="store_true",
                    help="CI mode: also run the fixture selftest and save "
                         "under ANALYSIS_torch_smoke.json")
    ap.add_argument("--selftest", action="store_true",
                    help="check every rule flags its known-bad fixture and "
                         "passes its known-good twin, then exit")
    ap.add_argument("--fixture", default=None, metavar="RULE",
                    help="run RULE over its seeded known-bad fixture(s); "
                         "exits non-zero iff the rule (correctly) fires")
    ap.add_argument("--list", action="store_true",
                    help="list registered programs and rules, then exit")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="where the programs run (default cuda: the card, "
                         "which must be present)")
    return ap


def _selftest(rules, dev) -> bool:
    from repro_torch.analysis.core import run_program
    from repro_torch.analysis.fixtures import FIXTURES
    ok = True
    for rule in rules:
        fx = FIXTURES.get(rule.name)
        if fx is None:
            print(f"FAIL {rule.name}: no fixtures registered")
            ok = False
            continue
        for kind, want_errors in (("bad", True), ("good", False)):
            for prog in fx[kind]:
                rows = run_program(prog, [rule], dev)
                errors = [f for r in rows for f in r["findings"]
                          if f["severity"] == "error"]
                good = bool(errors) == want_errors
                ok = ok and good
                print(f"{'ok  ' if good else 'FAIL'} {rule.name:22s} "
                      f"{prog.name:36s} errors={len(errors)} "
                      f"(want {'>=1' if want_errors else '0'})")
    print("selftest:", "ok" if ok else "FAIL")
    return ok


def run_cli(argv=None) -> int:
    a = build_parser().parse_args(argv)
    try:
        return _dispatch(a)
    except (KeyError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except Exception:
        traceback.print_exc()
        return 2


def _dispatch(a) -> int:
    import torch

    from repro_torch.analysis.core import run_analysis, write_report
    from repro_torch.analysis.registry import programs_by_name
    from repro_torch.analysis.rules import rules_by_name
    rules = rules_by_name(a.rules.split(",") if a.rules else None)

    if a.list:
        from repro_torch.analysis.registry import HOT_PATHS
        from repro_torch.analysis.rules import ALL_RULES
        print("programs:")
        for p in HOT_PATHS:
            print(f"  {p.name:18s} {p.description}")
        print("rules:")
        for r in ALL_RULES:
            print(f"  {r.name:22s} {r.description}")
        return 0

    if a.fixture:
        from repro_torch.analysis.fixtures import FIXTURES
        if a.fixture not in FIXTURES:
            raise KeyError(f"no fixtures for rule {a.fixture!r}; "
                           f"have {sorted(FIXTURES)}")
        programs = FIXTURES[a.fixture]["bad"]
        rules = rules_by_name([a.fixture])
    elif not a.selftest:
        programs = programs_by_name(
            a.programs.split(",") if a.programs else None)

    if a.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device; pass --device cpu to analyze on the "
              "CPU", file=sys.stderr)
        return 2
    if a.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    if a.selftest:
        return 0 if _selftest(rules, a.device) else 1
    report = run_analysis(programs, rules, a.device)
    for row in report["results"]:
        findings = row["findings"]
        errs = sum(1 for f in findings if f["severity"] == "error")
        if row.get("skipped"):
            status, extra = "skip", row["skipped"]
        elif errs:
            status, extra = "FAIL", f"{errs} violation(s)"
        else:
            status, extra = "ok  ", ""
        print(f"{status} {row['program']:36s} {row['rule']:22s} {extra}")
        for f in findings:
            if f["severity"] == "error":
                print(f"     - {f['message']}")

    if a.fixture:
        print(f"fixture '{a.fixture}': {report['violations']} "
              f"violation(s)")
        return 1 if report["violations"] else 0

    out = a.out or (SMOKE_OUT if a.smoke else DEFAULT_OUT)
    path = write_report(report, out)
    print(f"{report['violations']} violation(s) across "
          f"{len(report['programs'])} program(s) x "
          f"{len(report['rules'])} rule(s) on {report['device']}; "
          f"wrote {path}")
    if a.smoke and not _selftest(rules, a.device):
        return 1
    return 0 if report["ok"] else 1
