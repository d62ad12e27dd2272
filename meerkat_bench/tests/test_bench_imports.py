"""The harness stands apart from JAX and the JAX package: no module it
runs imports ``jax``, ``jaxlib`` or ``repro`` (compared by the whole
top-level name, so ``repro_torch`` passes), and a whole CPU run of a cell
leaves none of them in ``sys.modules``."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from meerkat_bench import run

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FILES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def _roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_repro_import(path):
    assert not set(_roots(path)) & set(run.FORBIDDEN), path


def test_top_level_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake_mod", object())
    assert "repro_torch_fake_mod" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake_sub", object())
    assert run.forbidden_modules() == ["repro.fake_sub"]


def test_a_cpu_run_loads_no_jax(tmp_path):
    """A tiny cell run end to end in a fresh interpreter: the harness's
    own check passes and the result line is printed."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from pathlib import Path\n"
        "from meerkat_bench.tests import tiny\n"
        "from meerkat_bench import run\n"
        "root = tiny.make_root(Path(%r))\n"
        "out = tiny.run_tiny(root, 'tiny-dense.fl', seconds=0.2)\n"
        "assert not run.forbidden_modules(), run.forbidden_modules()\n"
        "print(out['correct'])\n") % (str(ROOT), str(ROOT / "src"),
                                     str(tmp_path))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0",
                              "HOME": str(tmp_path)})
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "True"


def test_cli_refuses_without_a_card(tmp_path):
    """Without a CUDA card the command exits non-zero and prints no
    result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run(
        [sys.executable, "-m", "meerkat_bench.run", "--workload",
         "qwen2-1.5b.fl_paper", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_refuses_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    folder, a run exits non-zero and prints no result line."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "meerkat_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run(
        [sys.executable, "-m", "meerkat_bench.run", "--workload",
         "qwen2-1.5b.fl_paper", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert res.returncode != 0
    assert res.stdout.strip() == ""
