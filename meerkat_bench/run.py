"""Run one cell of the benchmark once and print its result line.

    python3 -m meerkat_bench.run --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

The cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration, ``meerkat_bench/configs/<config>.json``, and a traffic mix,
``meerkat_bench/workloads/<cell>.json``; the mix's ``kind`` names the
module that runs it, ``meerkat_bench/kinds/<kind>.py``, and each
per-layer metric is read by ``meerkat_bench/metrics/<metric>.py``.
Everything is found by
name: a new cell, configuration or metric is new files and entries.

Set-up (process start to the first timed operation) makes the weights and
the traffic from ``--seed``, builds the program's objects and warms every
shape the cell uses; the window then runs for ``--seconds``; after it the
program's outputs are compared with the plain reference under
``meerkat_bench/reference``.  ``--trace 1`` reports the per-layer metrics
instead of the end-to-end ones, from a traced part of the window.

It exits non-zero, and prints no result, without a CUDA card (or with fewer
than the cell asks for), when the program cannot be imported, or when JAX
or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_env(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout; keep
    libraries from loading JAX."""
    cache = root / "build" / "bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("REPRO_TORCH_AUTOTUNE_DIR",
                          str(cache / "autotune_empty"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted({n for n in sys.modules
                   if n.split(".", 1)[0] in FORBIDDEN})


def load_bench(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_of(bench: dict, name: str) -> dict:
    for c in bench["workloads"]:
        if c["name"] == name:
            return c
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file(path: Path, name: str):
    """A module from a file whose name may hold dots (a metric)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries this cell reports in this mode."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if cell in m.get("workloads", [cell])]


class Harness:
    """What a kind's module gets: the cell's files, the run's arguments, the
    device, and where it leaves what readers and checks need."""

    def __init__(self, bench_dir: Path, cell: dict, args, device):
        self.wl = read_json(bench_dir / "workloads" / f"{cell['name']}.json")
        self.cfg = read_json(bench_dir / "configs" / f"{cell['config']}.json")
        self.m = self.cfg["model"]
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(int(args.trace))
        self.device = device
        self.control = getattr(args, "control", False)
        self.t_start = T_START
        self.setup_s = None
        self.facts: dict = {}     # what the readers read
        self.checks: list = []    # (name, value, limit)
        self.tracer = None        # trace.DeviceTrace of the traced window
        self.spans = None         # trace.Spans
        self.memory_peak = 0
        self.attempted = 0
        self.failed = 0
        self.e2e: dict = {}       # end-to-end metric values
        self.control_readings: dict = {}

    def reference(self):
        name = self.cfg["reference"]
        return importlib.import_module(f"meerkat_bench.reference.{name}")

    def seeds(self, n: int) -> list:
        """``n`` independent 63-bit seeds derived from the run's seed."""
        import numpy as np
        ss = np.random.SeedSequence(self.seed).spawn(n)
        return [int(s.generate_state(2, np.uint64)[0] >> 1) for s in ss]

    def add_control(self, name: str, nums: dict) -> None:
        """A control's numbers, judged by the limits and the expression
        that judge the program's."""
        limits = self.wl["limits"]
        checks = [(k, v, limits[k]) for k, v in nums.items()]
        self.control_readings[name] = {
            "correct": judge(checks),
            "compared": {k: {"value": v, "limit": lim}
                         for k, v, lim in checks}}

    def set_up_done(self):
        self.setup_s = time.perf_counter() - self.t_start

    def free(self):
        import torch
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def judge(checks) -> bool:
    """``correct``: some number compared, and each within its limit."""
    return bool(checks) and all(v <= lim for _, v, lim in checks)


def device_info(device) -> dict:
    import torch
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def run_cell(args, *, bench_dir: Path = BENCH, root: Path = None,
             device=None) -> dict:
    """Drive one run; returns the result dict (the line printed).  Without
    ``device`` the cell runs on the CUDA card, which must be there."""
    root = Path(root or Path.cwd())
    bench = load_bench(root)
    cell = cell_of(bench, args.workload)
    import torch
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < int(cell["chips"]):
            raise SystemExit(f"cell {cell['name']} needs {cell['chips']} "
                             "CUDA card(s); none or too few are visible")
        device = torch.device("cuda")
    device = torch.device(device)
    # float32 as the configurations state it: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    src = root / "src"
    if src.is_dir() and str(src) not in sys.path:
        sys.path.insert(0, str(src))
    h = Harness(bench_dir, cell, args, device)
    kind = importlib.import_module(f"meerkat_bench.kinds.{h.wl['kind']}")
    kind.run(h)
    f = h.facts
    print(f"phases setup_s={h.setup_s:.2f} window_s={f.get('window_s', 0):.2f}"
          f" check_s={f.get('check_s', 0):.2f} "
          f"total_s={time.perf_counter() - T_START:.2f}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        raise SystemExit("JAX or the JAX package was loaded: "
                         + ", ".join(found))
    metrics = {}
    for m in cell_metrics(bench, cell["name"], h.trace):
        if h.trace:
            mod = load_file(bench_dir / "metrics" / f"{m['name']}.py",
                            f"meerkat_bench_metric_{len(metrics)}")
            v = mod.read(h)
        else:
            v = h.e2e.get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    correct = judge(h.checks)
    dev = device_info(device)
    dev["memory_peak_bytes"] = int(h.memory_peak)
    out = {"correct": correct, "attempted": int(h.attempted),
           "failed": int(h.failed), "metrics": metrics, "device": dev}
    if h.trace and h.tracer is not None:
        dev["busy_s"] = h.tracer.busy_s()
        dev["window_s"] = h.tracer.window_s()
        out["breakdown"] = {"device_ops": h.tracer.top_ops(),
                            "idle_gaps": h.tracer.idle_gaps()}
    if h.control_readings:
        out["control"] = h.control_readings
    out["compared"] = {n: {"value": v, "limit": lim}
                       for n, v, lim in h.checks}
    return out


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0, choices=(0, 1))
    return ap.parse_args(argv)


def report(out: dict) -> None:
    """The compared numbers as the last lines on standard error, then the
    result as the last line on standard output."""
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    cache_env(Path.cwd())
    out = run_cell(args)
    report(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
