"""Find the highest request rate a serving cell sustains: one set-up, then
the cell's open loop at each rate in turn (warm, then a measured window),
printing the tokens per second completed, the time to first token at the
median, 90th and 95th percentiles, and the backlog left when the window
closes (a growing backlog is past the knee).  Run it once, when a serving
cell is defined; the cell then fixes its rate.

    python3 -m meerkat_bench.tools.sweep --workload <cell> --seed <n> \
        --seconds <s> --rates 1,2,3
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from meerkat_bench import run
from meerkat_bench.kinds import serve
from meerkat_bench.traffic import serve as traffic


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    i = argv.index("--rates")
    rates = [float(r) for r in argv[i + 1].split(",")]
    del argv[i:i + 2]
    args = run.parse(argv)
    root = Path.cwd()
    run.cache_env(root)
    sys.path.insert(0, str(root / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = run.cell_of(run.load_bench(root), args.workload)
    h = run.Harness(run.BENCH, cell, args, torch.device("cuda"))
    eng, loop, _, _ = serve.build(h, rates[0])
    for rate in rates:
        while eng.step():       # drain the last rate's requests
            pass
        eng._collect()
        arrivals = traffic.Arrivals(h.wl, h.m["vocab"], h.seed, rate)
        loop = serve.Loop(h, eng, arrivals, time.perf_counter())
        while time.perf_counter() - loop.t_start < h.wl["warm_s"]:
            loop.step()
        w = serve.window(h, loop, h.seconds)
        t = np.asarray(w["ttft"]) * 1e3
        print(json.dumps({
            "rate_per_s": rate, "requests": w["requests"],
            "finished": len(w["finished"]),
            "tokens_per_s": w["tokens"] / w["window_s"],
            "ttft_ms_p50": float(np.percentile(t, 50)),
            "ttft_ms_p90": float(np.percentile(t, 90)),
            "ttft_ms_p95": float(np.percentile(t, 95)),
            "backlog": w["backlog"], "late_s_max": w["late_s_max"],
            "misses_in_window": w["misses_in_window"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
