"""The port stands alone: no file of ``src/repro_torch``, no
``examples/*_torch.py`` nor ``chip_smoke.py`` imports JAX, the JAX package, or ``msgpack`` and
``ml_dtypes`` (neither is on the card's machine; the checkpoint codec is
the port's own)."""
import ast
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    sorted((ROOT / "examples").glob("*_torch.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "kill_recover_torch.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack", "ml_dtypes")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    roots = set(_imported_roots(path))
    assert not roots & set(FORBIDDEN), (path, sorted(roots & set(FORBIDDEN)))


def test_port_files_found():
    assert (ROOT / "chip_smoke.py").exists()
    assert len(FILES) > 20
