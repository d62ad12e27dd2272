"""The harness finds a cell's configuration, traffic mix and per-layer
metrics by name: copies placed in a temporary copy of the folder, with
entries in BENCHMARK.json and no edit of any code, are found and run."""
import json
import shutil

from meerkat_bench.tests import tiny


def test_copied_config_workload_and_metric_run_by_name(tmp_path):
    root = tiny.make_root(tmp_path)
    bench_dir = root / "meerkat_bench"
    shutil.copy(bench_dir / "configs" / "tiny-dense.json",
                bench_dir / "configs" / "tiny-copy.json")
    shutil.copy(bench_dir / "workloads" / "tiny-dense.fl.json",
                bench_dir / "workloads" / "tiny-copy.fl2.json")
    (bench_dir / "metrics" / "rounds_seen.train.py").write_text(
        "def read(h):\n    return h.facts.get('rounds')\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-copy", "source": "t",
                             "file": "meerkat_bench/configs/tiny-copy.json",
                             "reduced": [], "why": "t"})
    bench["workloads"].append({"name": "tiny-copy.fl2", "config": "tiny-copy",
                               "traffic": "fl2", "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "rounds_seen.train", "unit": "1",
                               "better": "higher", "source":
                               "program_counter", "layer": "server round",
                               "moves": "train_tokens_per_s",
                               "workloads": ["tiny-copy.fl2"]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("tiny-copy.fl2")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = tiny.run_tiny(root, "tiny-copy.fl2", seconds=0.2)
    assert out["correct"]
    assert "train_tokens_per_s" in out["metrics"]
    traced = tiny.run_tiny(root, "tiny-copy.fl2", seconds=0.2, trace=1)
    assert traced["metrics"]["rounds_seen.train"]["value"] >= 1
    # a metric listing other cells is not read here
    assert "prefill_ms.serve" not in traced["metrics"]


def test_every_benchmark_file_is_there():
    from pathlib import Path
    root = Path(__file__).resolve().parents[2]
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (root / c["file"]).is_file()
    for w in bench["workloads"]:
        assert (root / "meerkat_bench" / "workloads"
                / f"{w['name']}.json").is_file()
    for m in bench["per_layer"]:
        assert (root / "meerkat_bench" / "metrics"
                / f"{m['name']}.py").is_file()
