"""On the card (marked ``cuda``; skipped where there is none): the
controls at a size a test run holds, and a tiny cell through the CLI's
whole path.

The controls put the plain reference in the program's place one precision
down (TF32 for the configurations' float32) and, for training, with half
of each batch left out; each must fail at least one of the cell's compared
numbers against the limits in its workload file.  Run with

    python3 -m pytest -q -m cuda meerkat_bench/tests
"""
import json

import pytest
import torch

from meerkat_bench.tests import tiny

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


def _cut(root, cell, config, layers, over):
    """Make ``cell`` in the tiny root run ``config`` at full width with
    ``layers`` layers and the workload overrides ``over``."""
    bench_dir = root / "meerkat_bench"
    cfg = json.loads((bench_dir / "configs" / f"{config}.json").read_text())
    cfg["name"] = f"{config}-l{layers}"
    cfg["model"]["n_layers"] = layers
    tiny_cfg = tiny.CELLS[cell][1]
    (bench_dir / "configs" / f"{tiny_cfg}.json").write_text(json.dumps(cfg))
    real = tiny.CELLS[cell][0]
    wl = json.loads((bench_dir / "workloads" / f"{real}.json").read_text())
    for k, v in over.items():
        tiny._set(wl, k, v)
    (bench_dir / "workloads" / f"{cell}.json").write_text(json.dumps(wl))


def _run(root, cell, **kw):
    from meerkat_bench import run
    args = run.parse(["--workload", cell, "--seed", str(kw.get("seed", 5)),
                      "--seconds", str(kw.get("seconds", 1.0)),
                      "--trace", "0"])
    args.control = True
    return run.run_cell(args, bench_dir=root / "meerkat_bench", root=root,
                        device="cuda")


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_training_controls_fail(card, tmp_path, seed):
    root = tiny.make_root(tmp_path)
    _cut(root, "tiny-dense.fl", "qwen2-1.5b", 2,
         {"clients": 4, "batch_size": 4, "train_examples": 64})
    out = _run(root, "tiny-dense.fl", seed=seed)
    assert out["correct"], out["compared"]
    for name, ctl in out["control"].items():
        assert not ctl["correct"], (name, ctl["compared"])


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_serving_control_fails(card, tmp_path, seed):
    root = tiny.make_root(tmp_path)
    _cut(root, "tiny-glm.serve", "chatglm3-6b", 2,
         {"max_slots": 8, "S_max": 1024, "bucket": 256, "rate_per_s": 4.0,
          "warm_s": 2.0, "check_tokens": 600,
          "prompt": {"median": 192, "sigma": 0.9, "min": 16, "max": 512},
          "output": {"median": 64, "sigma": 0.7, "min": 16, "max": 256}})
    out = _run(root, "tiny-glm.serve", seed=seed, seconds=6.0)
    assert out["correct"], out["compared"]
    assert not out["control"]["tf32"]["correct"], out["control"]


def test_cli_path_on_the_card(card, tmp_path):
    root = tiny.make_root(tmp_path)
    for cell in ("tiny-dense.fl", "tiny-glm.serve"):
        out = tiny.run_tiny(root, cell, seconds=0.5, device=card)
        assert out["correct"] and out["device"]["platform"] == "gpu"
