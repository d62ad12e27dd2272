"""``repro_torch.launch.hlo_tools`` (the counterpart of
``repro.launch.hlo_tools``) on the CPU: the op classes of recorded aten
ops, the collective totals of TINY's ZO step on a fake 2x2 group against
``walk.collective_bytes``, the top list's order and bound, the totals
covering it, the CLI's flags against the JAX module's (parsed from the
source, as ``tools/check_docs.py`` parses flags), and its output."""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch_mesh_ranks as R
from repro_torch.analysis import walk
from repro_torch.configs import TINY
from repro_torch.configs.base import MeshConfig
from repro_torch.launch import dryrun, hlo_tools, roofline
from repro_torch.launch.mesh import fake_mesh

ROOT = Path(__file__).resolve().parents[1]


def _flags(path: Path) -> set:
    return set(re.findall(r'add_argument\(\s*"(--[A-Za-z0-9-]+)"',
                          path.read_text()))


@pytest.fixture(scope="module")
def tiny_trace():
    """TINY's ZO step as rank 0 of a fake 2x2 group records it."""
    mc = MeshConfig(data=2, model=2)
    with fake_mesh(mc) as mesh:
        trace, _ = dryrun.trace_step(TINY, R.TEST_SHAPE, mesh, mc, "zo_fl",
                                     dryrun.mask_indices(TINY)[0])
    return trace


def _classes(fn, *args):
    trace = walk.record(fn, args)
    sizes = hlo_tools._storage_bytes(trace)
    return [c for c in (hlo_tools.op_class(r, sizes) for r in trace.records)
            if c is not None]


def test_op_classes_of_aten_ops():
    """Whole-buffer copies are ``copy``; slice reads into a new buffer
    ``dynamic-slice``; writes into a slice ``dynamic-update-slice``;
    views and fresh buffers are not counted."""
    x, idx = torch.randn(8, 16), torch.tensor([1, 3])

    def fn(x, idx):
        a = x.clone()
        b = x.t().contiguous()
        c = x[:4].clone()
        d = torch.index_select(x, 0, idx)
        e = torch.zeros(8, 16)
        e[2:4].copy_(x[:2])
        e.index_put_((idx,), x[:2])
        f = torch.empty(4, 16)
        f.copy_(x[4:8])
        return a, b, c, d, e, f, x.to(torch.float64)

    assert _classes(fn, x, idx) == [
        "copy", "copy", "dynamic-slice", "dynamic-slice",
        "dynamic-update-slice", "dynamic-update-slice", "dynamic-slice",
        "copy"]


def test_collective_totals_equal_walk(tiny_trace):
    """The collective classes of the op totals are
    ``walk.collective_bytes`` of the same trace, and so is
    ``collective_bytes``; the step all-reduces and all-gathers."""
    want = walk.collective_bytes(tiny_trace)
    assert hlo_tools.collective_bytes(tiny_trace) == want
    totals = hlo_tools.op_totals(tiny_trace)
    for kind in hlo_tools.COLLECTIVE_OPS:
        assert totals.get(kind, 0.0) == want[kind], kind
    assert want["all-reduce"] > 0 and want["all-gather"] > 0
    assert hlo_tools.cost_analysis(tiny_trace) == dryrun.counts(tiny_trace)


@pytest.mark.parametrize("top", [1, 5, 15])
def test_top_ops_sorted_bounded_and_covered(tiny_trace, top):
    """At most ``top`` ops, largest first, each of a class the totals hold
    and no larger than its class's total."""
    tops = hlo_tools.top_ops(tiny_trace, top=top)
    assert len(tops) == top
    sizes = [b for b, _, _ in tops]
    assert sizes == sorted(sizes, reverse=True)
    totals = hlo_tools.op_totals(tiny_trace)
    for b, kind, line in tops:
        assert kind in hlo_tools.OPS and b <= totals[kind]
        assert line.startswith("#") and len(line) <= 180
    assert sum(sizes) <= sum(totals.values())


def test_constants_match_jax_and_roofline():
    """JAX's op classes and ring factors; the roofline takes the factors
    from here."""
    from repro.launch import hlo_tools as J
    assert hlo_tools.OPS == J.OPS
    assert hlo_tools.COLLECTIVE_OPS == J.COLLECTIVE_OPS
    assert hlo_tools.COLLECTIVE_FACTOR == J.COLLECTIVE_FACTOR
    assert roofline.COLLECTIVE_FACTOR is hlo_tools.COLLECTIVE_FACTOR


def test_cli_flags_equal_jax_and_output(capsys):
    """The CLI takes exactly the JAX module's flags and prints its two
    blocks: TINY's decode at decode_32k on the fake 16x16 group."""
    assert _flags(ROOT / "src/repro_torch/launch/hlo_tools.py") == \
        _flags(ROOT / "src/repro/launch/hlo_tools.py") == {
            "--arch", "--shape", "--step", "--top", "--depth", "--multi"}
    got = hlo_tools.main(["--arch", "tiny", "--shape", "decode_32k",
                          "--top", "3"])
    out = capsys.readouterr().out
    assert out.startswith("== tiny x decode_32k (decode) depth=1 ==")
    assert "op totals (per-device bytes):" in out and "top 3 ops:" in out
    assert got["step"] == "decode" and len(got["top"]) == 3
    for kind, b in got["totals"].items():
        assert f"  {kind:22s} {b / 1e6:12.1f} MB" in out
