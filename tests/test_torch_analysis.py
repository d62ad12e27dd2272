"""The port's static analyzer (``repro_torch.analysis``) on the CPU: every
rule flags its seeded bad fixture and passes its good twin, the fixtures'
kernel blocks and collectives are the JAX package's numbers, the registry
runs clean, the recorder keeps a kernel as one record and no tensor alive,
and the CLI's exit codes hold."""
import gc
import json
import os
import subprocess
import sys
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from repro.analysis import fixtures as jfixtures
from repro.analysis import registry as jregistry
from repro.analysis import rules as jrules
from repro.analysis.walk import pallas_block_records
from repro.launch.hlo_tools import collective_bytes as hlo_collective_bytes
from repro_torch.analysis import (ALL_RULES, FIXTURES, HOT_PATHS,
                                  check_no_dense_intermediates,
                                  kernel_block_records, liveness,
                                  liveness_peak_bytes, max_square_dims,
                                  record, run_analysis, run_program,
                                  write_report)
from repro_torch.analysis.core import SCHEMA_VERSION, Artifacts
from repro_torch.analysis.registry import programs_by_name
from repro_torch.kernels import ops, plans, ref

REPO = os.path.join(os.path.dirname(__file__), "..")
CPU = torch.device("cpu")
RUNS = ("zo_train_loop", "fl_round", "ckpt_roundtrip", "prefill",
        "decode_burst", "first_order")


def _errors(rows):
    return [f for r in rows for f in r["findings"]
            if f["severity"] == "error"]


def _fixture(name):
    return next(p for kind in ("bad", "good") for fx in FIXTURES.values()
                for p in fx[kind] if p.name == name)


# ------------------------------------------------------ fixture matrix ------
@pytest.mark.parametrize("rule", ALL_RULES, ids=lambda r: r.name)
def test_rule_flags_bad_fixture(rule):
    fx = FIXTURES[rule.name]
    assert fx["bad"], f"{rule.name} has no known-bad fixture"
    for prog in fx["bad"]:
        errs = _errors(run_program(prog, [rule], CPU))
        assert errs, f"{rule.name} missed its bad fixture {prog.name}"


@pytest.mark.parametrize("rule", ALL_RULES, ids=lambda r: r.name)
def test_rule_passes_good_fixture(rule):
    fx = FIXTURES[rule.name]
    assert fx["good"], f"{rule.name} has no known-good fixture"
    for prog in fx["good"]:
        errs = _errors(run_program(prog, [rule], CPU))
        assert not errs, (rule.name, prog.name, errs)


def test_fixtures_mirror_the_jax_package():
    names = {k: sorted(p.name for p in v["bad"] + v["good"])
             for k, v in FIXTURES.items()}
    jnames = {k: sorted(p.name for p in v["bad"] + v["good"])
              for k, v in jfixtures.FIXTURES.items()}
    assert names == jnames
    assert sum(len(v) for v in names.values()) == 15


# ----------------------------------------- the JAX package's numbers -------
@pytest.mark.parametrize("name,block_bytes", [
    ("fixture:memory:bad-vmem", 33_554_432),
    ("fixture:memory:good", 131_072)])
def test_fixture_kernel_blocks_equal_jax(name, block_bytes):
    jbuilt = {"fixture:memory:bad-vmem": jfixtures._memory_bad_vmem,
              "fixture:memory:good": jfixtures._memory_good}[name]()
    jrecs = pallas_block_records(jax.make_jaxpr(jbuilt.fn)(*jbuilt.args))
    assert [r["block_bytes"] for r in jrecs] == [block_bytes]
    built = _fixture(name).build(CPU)
    recs = kernel_block_records(Artifacts(built, CPU).trace())
    assert [r["block_bytes"] for r in recs] == [block_bytes]
    assert recs[0]["name"] == "kernel:fixture_double"
    # the good block fits the H100's per-block limit, the bad one does not
    assert (block_bytes <= plans.H100_SMEM_OPTIN) == (name.endswith("good"))


@pytest.mark.parametrize("kind,hlo", [("bad", jfixtures._HLO_BAD),
                                      ("good", jfixtures._HLO_GOOD)])
def test_comm_fixtures_equal_jax_collective_bytes(kind, hlo):
    built = FIXTURES["comm-budget"][kind][0].build(CPU)
    assert Artifacts(built, CPU).collectives() == hlo_collective_bytes(hlo)


def test_fixture_double_ref_equals_jax_fixture_output():
    x = np.random.default_rng(0).standard_normal((128, 128)).astype(
        np.float32)
    jbuilt = jfixtures._memory_good()
    # the JAX fixture's Pallas kernel (interpret mode) is x * 2
    inner = jax.make_jaxpr(jbuilt.fn)(jnp.asarray(x))
    assert pallas_block_records(inner)
    from jax.experimental import pallas as pl

    def kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 2.0
    jout = np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        interpret=True)(jnp.asarray(x)))
    tx = torch.as_tensor(x)
    np.testing.assert_array_equal(ref.fixture_double_ref(tx).numpy(), jout)
    np.testing.assert_array_equal(ops.fixture_double(tx, 128).numpy(), jout)
    np.testing.assert_array_equal(ops.fixture_double(tx, 32).numpy(), jout)


def test_fixture_double_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        ops.fixture_double(torch.ones(4, 4, dtype=torch.float64), 4)
    with pytest.raises(ValueError):
        ops.fixture_double(torch.ones(16), 4)
    with pytest.raises(ValueError):
        ops.fixture_double(torch.ones(4, 4), 0)


# ------------------------------------------------- standalone predicates ----
def test_dense_predicate_reports_the_jax_offender():
    S = 64
    rng = np.random.default_rng(1)
    q = rng.standard_normal((S, 8)).astype(np.float32)
    jbad = jax.make_jaxpr(lambda a, b: jnp.einsum("sd,td->st", a, b))(q, q)
    joff = jrules.check_no_dense_intermediates(jbad, S)
    assert [o["shape"] for o in joff] == [[S, S]]
    tq = torch.as_tensor(q)
    bad = record(lambda a, b: torch.einsum("sd,td->st", a, b), (tq, tq))
    good = record(lambda a, b: (a * b).sum(-1), (tq, tq))
    off = check_no_dense_intermediates(bad, S)
    assert off and off[-1]["shape"] == [S, S]
    assert all([d for d in o["shape"] if d != 1] == [S, S] for o in off)
    assert not check_no_dense_intermediates(good, S)
    assert max_square_dims(bad, S) >= 2 > max_square_dims(good, S)


def test_liveness_peak_tracks_buffer_size():
    def f(x):
        return torch.outer(x, x).sum()

    small = liveness_peak_bytes(record(f, (torch.ones(128),)))
    big = liveness_peak_bytes(record(f, (torch.ones(1024),)))
    assert big >= 1024 * 1024 * 4        # the [1024, 1024] f32 outer product
    assert big > small


def test_liveness_counts_views_and_in_place_results_zero():
    x = torch.ones(1000)

    def f(x):
        y = x * 2.0              # 4000 B
        y.add_(1.0)              # in place: no new bytes
        return y.view(10, 100).t()  # views: no new bytes

    est = liveness(record(f, (x,)))
    assert est == dict(peak_bytes=8000, input_bytes=4000)


def test_held_liveness_keeps_what_a_name_still_references():
    def f(x):
        y = x * 2.0
        z = y + 1.0          # y's last use, but the name holds it
        w = z * 3.0
        return w.sum()

    est = liveness(record(f, (torch.ones(1000),)))
    # x, y, z and w at once, where freeing at last use alone would have
    # dropped y before w: 12000 B
    assert est == dict(peak_bytes=16004, input_bytes=4000)


def test_collectives_counted_from_the_trace(tmp_path):
    """A call's torch.distributed collectives, as the comm-budget rule
    reads them: bytes by kind (one rank of gloo here)."""
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as fc

    from repro_torch.analysis import collective_bytes
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        def f(x):
            y = fc.all_reduce(x, "sum", dist.group.WORLD)
            z = fc.all_gather_single(x, 0, dist.group.WORLD)
            return y + 1.0, z + 0.0

        trace = record(f, (torch.ones(16),))
    finally:
        dist.destroy_process_group()
    assert not trace.raised
    got = collective_bytes(trace)
    assert got == dict(hlo_collective_bytes(""), **{"all-reduce": 64.0,
                                                    "all-gather": 64.0})


def test_recorder_keeps_no_tensor_alive():
    refs = []

    def f(x):
        y = x * 3.0
        refs.append(weakref.ref(y))
        return y.sum()

    trace = record(f, (torch.ones(4096),))
    gc.collect()
    assert refs and refs[0]() is None
    assert [r.name for r in trace.records][:2] == ["aten.mul.Tensor",
                                                   "aten.sum.default"]


def test_a_kernel_is_one_record_on_the_cpu():
    q = torch.randn(1, 320, 4, 64)
    k = torch.randn(1, 320, 2, 64)
    trace = record(lambda q, k: ops.flash_attention(q, k, k), (q, k))
    kern = [r for r in trace.records if r.kind == "kernel"]
    assert [r.name for r in kern] == ["kernel:flash_attention"]
    assert kern[0].inner > 0                   # the plain version's ops
    assert [o.shape for o in kern[0].outs] == [(1, 320, 4, 64)]
    assert kern[0].launches == plans.flash_attn_fwd(1, 320, 2, 2, 64, False)
    assert not check_no_dense_intermediates(trace, 320)
    # the plain version's [S, S] scores stay inside the record
    assert all(r.kind == "kernel" for r in trace.records)
    assert ops.recorder is None


def test_a_raising_kernel_is_recorded_and_reported():
    def f(x):
        return ops.fixture_double(x.to(torch.float64), 4)

    trace = record(f, (torch.ones(4, 4),))
    assert trace.raised and "ValueError" in trace.raised
    assert trace.records[-1].raised and ops.recorder is None


# ------------------------------------------------------------ plans --------
def test_plans_match_the_launchers_arithmetic():
    # the forward's head_dim-256 instance: 192 KiB (flash_attn.cu's
    # static_assert against 227 KiB); query tiles on the slowest axis
    (l,) = plans.flash_attn_fwd(2, 4208, 4, 2, 256, False)
    assert l.dynamic_smem == 192 * 1024 and l.grid == (4, 2, 132)
    # the scan: 4 warps per 32 channels, two tile buffers of 64 steps
    # (dt, x [4 x (16 x 32 + 8)], B, C [4 x (16 x 16 + 8)]) and A', carry
    (l,) = plans.mamba_scan(4, 512, 16384, 16)
    assert (l.grid, l.threads, l.static_smem, l.dynamic_smem) == \
        ((512, 4, 1), 128, 0, 54_272)
    # decode: one launch, a cluster of min(16, ceil(S / 256)) splits per
    # (KV head, row); at S = 0 one block writes the zeros
    (l,) = plans.flash_decode(2, 0, 8, 4, 64, False)
    assert (l.kernel, l.grid, l.cluster) == ("decode_attn<f32,64,4>",
                                             (1, 8, 2), 1)
    (l,) = plans.flash_decode(8, 2048, 8, 4, 64, False)
    assert (l.grid, l.cluster, l.dynamic_smem) == ((8, 8, 8), 8, 38_528)
    (l,) = plans.flash_decode(2, 4352, 4, 2, 256, False)  # Gemma's global
    assert (l.grid, l.cluster) == ((16, 4, 2), 16)
    assert plans.decode_cluster(4352) == (16, 272)
    assert plans.zo_update(1_235_814_400, False, False, True, False)[0] \
        .grid == (132 * 8, 1, 1)
    assert plans.zo_update(1023, False, False, True, True)[0].grid == \
        (1, 1, 1)  # fused_update: one block per 16,384-element chunk
    assert [x.grid for x in plans.gradip_reduce(1_235_814, True)] == \
        [(1024, 1, 1)]
    # the backward: dQ one block per 64 / G queries (32 / G at head_dim
    # 256), dK/dV one per pair of 32-key tiles
    assert plans.flash_attn_bwd(4, 512, 8, 4, 64, False, False)[0].grid == \
        (32, 8, 4)
    assert plans.flash_attn_bwd(4, 512, 8, 4, 64, False, True)[0].grid == \
        (8, 8, 4)
    assert plans.flash_attn_bwd(1, 4352, 4, 2, 256, False, False)[0].grid \
        == (272, 4, 1)
    assert plans.flash_attn_bwd(1, 4352, 4, 2, 256, False, True)[0].grid \
        == (68, 4, 1)
    assert plans.flash_attn_bwd(1, 4353, 4, 2, 256, True, True)[0].grid \
        == (69, 4, 1)  # 137 key tiles: the middle one's block has one
    # every kernel at the main paths' shapes fits a Hopper block
    for launches in (plans.flash_attn_fwd(16, 512, 8, 4, 64, False),
                     plans.flash_attn_fwd(2, 4208, 4, 2, 256, True),
                     plans.flash_attn_bwd(4, 512, 8, 4, 128, False, False),
                     plans.flash_attn_bwd(4, 512, 8, 4, 128, False, True),
                     plans.flash_decode(2, 4352, 4, 2, 256, False),
                     plans.mamba_scan(4, 512, 16384, 16),
                     plans.fixture_double(128, 128, 128, True)):
        assert all(x.shared_bytes <= plans.H100_SMEM_OPTIN for x in launches)


@pytest.mark.parametrize("dh,bf16,dq_bytes,dkv_bytes", [
    (64, False, 115_200, 115_712), (64, True, 49_664, 74_752),
    (128, False, 213_504, 230_400), (128, True, 82_432, 115_712),
    (256, False, 205_056, 213_504), (256, True, 106_752, 115_200)])
def test_flash_bwd_shared_bytes_fit_a_block(dh, bf16, dq_bytes, dkv_bytes):
    """The backward kernels' dynamic shared memory at every head_dim and
    type (flash_attn_bwd.cu's kDqSmem, kDkvSmem): under the 227 KB opt-in
    limit, the same at any S, B or G; at head_dim 64 in f32 two blocks of
    either kernel (and their 1 KB each) fit an SM's 228 KB, the dK/dV
    ones exactly."""
    (dq,) = plans.flash_attn_bwd(1, 4352, 4, 2, dh, bf16, False)
    (dkv,) = plans.flash_attn_bwd(1, 4352, 4, 2, dh, bf16, True)
    assert (dq.dynamic_smem, dkv.dynamic_smem) == (dq_bytes, dkv_bytes)
    assert max(dq.shared_bytes, dkv.shared_bytes) <= plans.H100_SMEM_OPTIN
    assert plans.flash_attn_bwd(2, 77, 1, 1, dh, bf16, True)[0] \
        .dynamic_smem == dkv_bytes
    if (dh, bf16) == (64, False):
        assert 2 * (dq_bytes + 1024) <= 233_472
        assert 2 * (dkv_bytes + 1024) == 233_472


@pytest.mark.parametrize("S,G,dh", [
    (512, 4, 64),      # the first-order shape (Llama-3.2-1B)
    (512, 8, 128),     # Jamba's attention layer
    (4352, 2, 256),    # Gemma-2 in grad_gemma
    (4353, 2, 256)])   # an odd count of key tiles
def test_flash_bwd_grid_covers_every_tile_once(S, G, dh):
    """dQ's blocks cover the S queries in tiles of flash_bwd_rows / G; the
    dK/dV block x takes key tiles x and n-1-x, which cover the 32-key tiles
    once each (the middle one alone when their count is odd); the same grid
    for bf16, over every KV head and batch row."""
    bq, n_k = plans.flash_bwd_rows(dh) // G, -(-S // plans.FLASH_BWD_BK)
    (dq,) = plans.flash_attn_bwd(2, S, 3, G, dh, False, False)
    (dkv,) = plans.flash_attn_bwd(2, S, 3, G, dh, False, True)
    assert dq.grid[1:] == dkv.grid[1:] == (3, 2)
    assert (dq.grid[0] - 1) * bq < S <= dq.grid[0] * bq
    pairs = [{x, n_k - 1 - x} for x in range(dkv.grid[0])]
    assert sorted(t for pair in pairs for t in pair) == list(range(n_k))
    for dkv_ in (False, True):
        assert plans.flash_attn_bwd(2, S, 3, G, dh, True, dkv_)[0].grid == \
            (dkv if dkv_ else dq).grid


@pytest.mark.parametrize("n,vec,blocks", [
    (0, True, 1), (1, True, 1), (777, False, 4), (777, True, 1),
    (1_235_814, False, 1024), (1_235_814, True, 1024), (300_000, True, 293),
    (10_000_000, True, 1024)])
def test_gradip_plan_is_one_launch_set_by_n_and_alignment(n, vec, blocks):
    """gradip_reduce is one launch (last-block-done) whose grid, and so the
    order of its additions, follows from n and the operands' alignment
    alone: the same for any card (no SM count enters it)."""
    (l,) = plans.gradip_reduce(n, vec)
    assert l.kernel == f"gradip_reduce_kernel<{4 if vec else 1}>"
    assert l.grid == (blocks, 1, 1) and l.threads == 256
    assert (l.static_smem, l.dynamic_smem) == (32, 0)
    assert plans.gradip_reduce(n, vec) == [l]


@pytest.mark.parametrize("offset,cols,v", [(0, 128, 4), (1, 128, 1),
                                           (0, 130, 1)])
def test_fixture_double_records_the_instantiation_it_launches(offset, cols,
                                                              v):
    """The recorded plan names the kernel the launcher takes: 16-byte packs
    only for a 16-byte aligned x with cols % 4 == 0; grid and shared bytes
    the same either way."""
    x = torch.zeros(128 * cols + offset)[offset:].view(128, cols)
    trace = record(lambda x: ops.fixture_double(x, 32), (x,))
    (l,) = [l for r in trace.records if r.kind == "kernel"
            for l in r.launches]
    assert l.kernel == f"fixture_double_kernel<{v}>"
    assert l == plans.fixture_double(128, cols, 32, v == 4)[0]
    assert (l.grid, l.dynamic_smem) == ((4, 1, 1), 2 * 4 * 32 * cols)


def test_on_cpu_reads_flags_and_refuses_mixed_devices():
    a = torch.ones(3)
    assert ops._on_cpu(a) and ops._on_cpu(a, None, a) and ops._on_cpu(None, a)
    for ts in ((a, torch.ones(3, device="meta")), (None,)):
        with pytest.raises(ValueError, match="share one CPU or CUDA"):
            ops._on_cpu(*ts)


# ------------------------------------------------------------ registry ------
def test_registry_covers_the_jax_hot_paths():
    assert [p.name for p in HOT_PATHS] == [p.name for p in
                                           jregistry.HOT_PATHS]
    for p in HOT_PATHS:
        assert p.description and callable(p.build)
    sel = programs_by_name(["prefill", "zo_train_loop"])
    assert [p.name for p in sel] == ["prefill", "zo_train_loop"]
    with pytest.raises(KeyError):
        programs_by_name(["no_such_program"])


@pytest.mark.parametrize("name", [p.name for p in HOT_PATHS])
def test_registry_program_runs_clean_on_the_cpu(name):
    rows = run_program(programs_by_name([name])[0], list(ALL_RULES),
                       CPU)
    assert not _errors(rows), _errors(rows)
    assert not [r for r in rows if r.get("skipped")
                and r["skipped"] != "not applicable"]
    if name == "fl_round_sharded":
        # its comm budget applies, as in the JAX registry, and holds
        comm = next(r for r in rows if r["rule"] == "comm-budget")
        assert "skipped" not in comm and comm["ok"]


def test_not_applicable_rows_equal_the_jax_registry():
    """Over the programs both packages build here: JAX's
    ``fl_round_sharded`` needs 4 devices and skips in this process
    (ROADMAP C20), so it is held by the test above alone.  Each program
    is built once and asked of every rule."""
    def rows(paths, all_rules, *dev):
        out = set()
        for p in paths:
            if p.name in RUNS:
                built = p.build(*dev)
                out |= {(p.name, r.name) for r in all_rules
                        if not r.applicable(built)}
        return out

    assert rows(HOT_PATHS, ALL_RULES, CPU) == rows(jregistry.HOT_PATHS,
                                                   jrules.ALL_RULES)


def test_zo_train_loop_is_one_record_per_kernel_launch():
    built = programs_by_name(["zo_train_loop"])[0].build(CPU)
    trace = Artifacts(built, CPU).trace()
    names = [r.name for r in trace.records if r.kind == "kernel"]
    # 2 steps: one dual perturb, two forwards of 2 layers, one update each
    assert names.count("kernel:zo_dual_perturb_flat") == 2
    assert names.count("kernel:zo_fused_update_flat") == 2
    assert names.count("kernel:flash_attention") == 8
    assert not trace.raised


# ------------------------------------------------------- report schema ------
def test_report_schema_and_write(tmp_path):
    rule = next(r for r in ALL_RULES if r.name == "host-sync")
    progs = FIXTURES["host-sync"]["bad"] + FIXTURES["host-sync"]["good"]
    report = run_analysis(progs, [rule], CPU)
    assert report["schema_version"] == SCHEMA_VERSION
    for key in ("torch_version", "device", "n_devices", "programs", "rules",
                "results", "violations", "ok"):
        assert key in report, key
    assert report["device"] == "cpu" and report["n_devices"] == 1
    assert report["violations"] > 0 and report["ok"] is False
    for row in report["results"]:
        assert {"program", "rule", "ok", "findings"} <= set(row)
    path = write_report(report, str(tmp_path / "sub" / "ANALYSIS.json"))
    assert json.load(open(path)) == json.loads(json.dumps(report))


def test_runner_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """``dev=None`` means the CUDA card, as at every entry point of the
    port: without one the runner raises rather than fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rule = next(r for r in ALL_RULES if r.name == "host-sync")
    prog = FIXTURES["host-sync"]["good"][0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_program(prog, [rule])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_analysis([prog], [rule])
    assert run_program(prog, [rule], "cpu")[0]["ok"]
    built = programs_by_name(["prefill"])[0].build(CPU)
    assert {t.device.type for t in
            [built.args[2]] + list(built.args[1].values())} == {"cpu"}


# ------------------------------------------------------------ CLI ----------
def _cli(*args, cuda_visible=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    if cuda_visible is not None:
        env["CUDA_VISIBLE_DEVICES"] = cuda_visible
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600)


def test_cli_list_exit_zero():
    r = _cli("--list")
    assert r.returncode == 0, r.stderr
    for name in ("zo_train_loop", "dense-materialization", "comm-budget"):
        assert name in r.stdout


def test_cli_fixture_mode_fires_nonzero():
    r = _cli("--fixture", "host-sync", "--device", "cpu")
    assert r.returncode == 1, (r.stdout, r.stderr)
    assert "violation" in r.stdout


def test_cli_unknown_program_is_usage_error():
    r = _cli("--programs", "no_such_program", "--device", "cpu")
    assert r.returncode == 2
    assert "no_such_program" in r.stderr


def test_cli_without_a_card_needs_device_cpu():
    r = _cli("--fixture", "host-sync", cuda_visible="")
    assert r.returncode != 0
    assert "--device cpu" in r.stderr
