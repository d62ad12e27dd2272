"""Read a cell's controls on the chip: one run of the cell as the
benchmark runs it, then the plain reference put in the program's place one
precision down (TF32 for the configurations' float32) and, for a training
cell, with half of each batch left out (a planted fault), each held to the
float32 reference by the same numbers as the program.  The benchmark's own
runs never do this.

    python3 -m meerkat_bench.tools.control --workload <cell> --seed <n> \
        --seconds <s> [--seeds n1,n2,...]

Prints one result line a seed, each with a ``control`` key beside the
program's ``compared`` numbers; each control is judged by the cell's limits
through the expression that decides the program's ``correct``.  Exits
non-zero where a control comes out correct on some seed, or the program
does not: the limits then do not separate the two.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

from meerkat_bench import run


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    seeds = None
    if "--seeds" in argv:
        i = argv.index("--seeds")
        seeds = [int(s) for s in argv[i + 1].split(",")]
        del argv[i:i + 2]
    args = run.parse(argv)
    args.control = True
    run.cache_env(Path.cwd())
    separated = True
    for seed in seeds or [args.seed]:
        args.seed = seed
        out = run.run_cell(args)
        control = out.get("control") or {}
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "compared": out["compared"], "control": control,
                          "metrics": out["metrics"]}), flush=True)
        for name, c in control.items():
            print(f"seed {seed} control {name} correct {c['correct']}",
                  file=sys.stderr, flush=True)
        separated &= out["correct"] and bool(control) \
            and not any(c["correct"] for c in control.values())
    return 0 if separated else 1


if __name__ == "__main__":
    sys.exit(main())
