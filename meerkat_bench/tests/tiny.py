"""A tiny copy of the benchmark for CPU tests: the folder copied into a
temporary root, with small configurations and workloads beside the real
ones and a BENCHMARK.json naming them, each cell mapped from a real one."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

MODEL = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 16, "d_ff": 128, "vocab": 512, "rope_style": "full",
         "rope_theta": 10000.0, "qkv_bias": True, "tie_embeddings": True,
         "norm_eps": 1e-6}
GLM = dict(MODEL, rope_style="partial", rope_partial_factor=0.5,
           tie_embeddings=False, vocab=300, norm_eps=1e-5)

# tiny cell -> (real cell, tiny config, overrides of the real workload)
CELLS = {
    "tiny-dense.fl": ("qwen2-1.5b.fl_paper", "tiny-dense", {
        "task.seq_len": 32, "batch_size": 4, "clients": 4,
        "train_examples": 64}),
    "tiny-dense.fleet": ("qwen2-1.5b.fl_fleet", "tiny-dense", {
        "task.seq_len": 32, "clients": 8, "train_examples": 128}),
    "tiny-glm.serve": ("chatglm3-6b.serve_chat", "tiny-glm", {
        "rate_per_s": 20.0, "max_slots": 4, "S_max": 128, "bucket": 16,
        "warm_s": 0.5, "trace_at_s": 0.2, "trace_s": 0.5,
        "check_tokens": 30,
        "prompt": {"median": 20, "sigma": 0.9, "min": 4, "max": 64},
        "output": {"median": 12, "sigma": 0.7, "min": 2, "max": 48}}),
}


def _set(d, dotted, v):
    *path, k = dotted.split(".")
    for p in path:
        d = d[p]
    d[k] = v


def make_root(tmp: Path) -> Path:
    """A checkout-like root under ``tmp``: BENCHMARK.json and the copied
    folder with the tiny files.  Returns the root."""
    root = Path(tmp)
    bench_dir = root / "meerkat_bench"
    shutil.copytree(BENCH, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, model in (("tiny-dense", MODEL), ("tiny-glm", GLM)):
        cfg = {"name": name, "source": "test", "reference": "dense_decoder",
               "reduced": [], "model": model}
        (bench_dir / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    real_to_tiny = {real: tiny for tiny, (real, _, _) in CELLS.items()}
    cells = []
    for tiny, (real, cfg, over) in CELLS.items():
        wl = json.loads((bench_dir / "workloads" / f"{real}.json")
                        .read_text())
        for k, v in over.items():
            _set(wl, k, v)
        (bench_dir / "workloads" / f"{tiny}.json").write_text(json.dumps(wl))
        cells.append({"name": tiny, "config": cfg,
                      "traffic": tiny.split(".")[1], "chips": 1, "why": "t"})
    bench["workloads"] = cells
    bench["configs"] = [{"name": n, "source": "test", "reduced": [],
                         "file": f"meerkat_bench/configs/{n}.json",
                         "why": "t"} for n in ("tiny-dense", "tiny-glm")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [real_to_tiny[w] for w in m["workloads"]
                              if w in real_to_tiny]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def run_tiny(root: Path, cell: str, seed: int = 3000000017,
             seconds: float = 1.0, trace: int = 0, control=False,
             device="cpu"):
    """One run of a tiny cell (on the CPU by default): the result dict."""
    from meerkat_bench import run
    args = run.parse(["--workload", cell, "--seed", str(seed),
                      "--seconds", str(seconds), "--trace", str(trace)])
    args.control = control
    return run.run_cell(args, bench_dir=root / "meerkat_bench", root=root,
                        device=device)
