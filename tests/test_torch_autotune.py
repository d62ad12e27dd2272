"""The port's ``kernels/autotune`` against the JAX package's
(``tests/test_autotune.py`` on the port, with a stub ``measure``): table
I/O and cached-pick determinism, the lookup helpers, the resolver and
``ops.flash_attention`` wiring, the CLI's ``--require-cached`` and
``--list`` gates, and JAX's keys and degenerate-candidate decisions on the
same inputs.  On the CPU nothing is measured (the kernels run only on the
card): ``measure`` raises."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.kernels import autotune as JAT
from repro_torch.configs import LLAMA32_1B, TINY
from repro_torch.kernels import autotune as AT
from repro_torch.kernels import ops, plans
from repro_torch.models import layers as L

LLAMA = LLAMA32_1B.reduced()  # head_dim 64, G 1: a layout the kernels take


@pytest.fixture(autouse=True)
def _table_dir(monkeypatch, tmp_path):
    d = str(tmp_path / "autotune_torch")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_DIR", d)
    AT.clear_cache()
    yield d
    AT.clear_cache()


def _stub_measure(monkeypatch, route="kernel", bq=64, bk=32):
    calls = []

    def fake(op, S, head_dim, G, **kw):
        calls.append((op, S, head_dim, G))
        return dict(route=route, block_q=bq, block_k=bk,
                    best_kernel_ms=1.0, online_ms=2.0,
                    kernel_ms={f"{bq}x{bk}": 1.0}, reps=1, batch=1,
                    kv_heads=1)

    monkeypatch.setattr(AT, "measure", fake)
    return calls


def test_ensure_writes_then_reuses(monkeypatch, _table_dir):
    calls = _stub_measure(monkeypatch)
    e1, measured1 = AT.ensure("fwd", 256, 64, 1)
    assert measured1 and calls == [("fwd", 256, 64, 1)]
    # the cached entry is authoritative: no re-measure, the same pick
    e2, measured2 = AT.ensure("fwd", 256, 64, 1)
    assert not measured2 and e2 == e1 and len(calls) == 1
    # a fresh process (cache cleared) rereads the same pick from disk
    AT.clear_cache()
    e3, measured3 = AT.ensure("fwd", 256, 64, 1)
    assert not measured3 and e3 == e1 and len(calls) == 1
    # the on-disk table, in its own directory, holds the platform's key
    assert AT.table_path().startswith(_table_dir)
    tab = json.load(open(AT.table_path()))
    assert AT.key_for("fwd", 256, 64, 1) in tab
    _, measured4 = AT.ensure("fwd", 256, 64, 1, force=True)
    assert measured4 and len(calls) == 2


def test_lookup_helpers(monkeypatch):
    """fastest_route is exact per op; best_blocks falls back across ops
    only where the other op's pair is a tiling of the kernel asked for."""
    _stub_measure(monkeypatch, route="online", bq=64, bk=32)
    AT.ensure("fwd", 1024, 64, 1)
    assert AT.fastest_route(1024, 64, 1, op="fwd") == "online"
    assert AT.fastest_route(1024, 64, 1, op="grad") is None  # exact op
    assert AT.fastest_route(999, 64, 1, op="fwd") is None
    assert AT.best_blocks(1024, 64, 1, op="fwd") == (64, 32)
    # (64, 32) at G 1 is the backward's default tiling too
    assert AT.best_blocks(1024, 64, 1, op="grad") == (64, 32)
    assert AT.best_blocks(999, 64, 1) is None
    # a forward pick the backward lacks does not cross over
    _stub_measure(monkeypatch, bq=128, bk=64)
    AT.ensure("fwd", 2048, 64, 1)
    assert AT.best_blocks(2048, 64, 1, op="fwd") == (128, 64)
    assert AT.best_blocks(2048, 64, 1, op="grad") is None
    # the pairs: each kernel's tilings at (head_dim, G), default first
    assert AT.kernel_pairs("fwd", 64, 4) == (
        (16, 32), (16, 64), (32, 32), (32, 64))
    assert AT.kernel_pairs("grad", 128, 4) == ((16, 32), (8, 32))
    assert AT.kernel_pairs("fwd", 256, 48) == ((1, 16), (1, 8))
    assert AT.kernel_pairs("grad", 16, 1) == ()


def test_resolver_consults_table(monkeypatch):
    """'auto' takes the measured-fastest route for a tuned key, in both
    directions and separately per op (forward vs differentiable); other
    keys, and layouts the kernels do not take, keep the port's rule."""
    hd, G, S = LLAMA.resolved_head_dim, LLAMA.n_heads // LLAMA.n_kv_heads, \
        1024
    # untuned: the port's rule takes the kernel, forward and gradient
    assert L.resolve_attn_backend("auto", LLAMA, S=S) == "kernel"
    assert L.resolve_attn_backend("auto", LLAMA, S=S,
                                  differentiable=True) == "kernel"
    # tuned: the forward says online wins, the gradient the kernel
    _stub_measure(monkeypatch, route="online")
    AT.ensure("fwd", S, hd, G)
    _stub_measure(monkeypatch, route="kernel")
    AT.ensure("grad", S, hd, G)
    assert L.resolve_attn_backend("auto", LLAMA, S=S) == "online"
    assert L.resolve_attn_backend("auto", LLAMA, S=S,
                                  differentiable=True) == "kernel"
    # re-tuned the other way, both follow
    _stub_measure(monkeypatch, route="kernel")
    AT.ensure("fwd", S, hd, G, force=True)
    _stub_measure(monkeypatch, route="online")
    AT.ensure("grad", S, hd, G, force=True)
    assert L.resolve_attn_backend("auto", LLAMA, S=S) == "kernel"
    assert L.resolve_attn_backend("auto", LLAMA, S=S,
                                  differentiable=True) == "online"
    # other keys, the small-S and mesh rules and explicit routes stand
    assert L.resolve_attn_backend("auto", LLAMA, S=2048) == "kernel"
    assert L.resolve_attn_backend("auto", LLAMA, S=128) == "dense"
    assert L.resolve_attn_backend("auto", LLAMA, S=S, mesh=True) == "online"
    assert L.resolve_attn_backend("dense", LLAMA, S=S) == "dense"
    # a "kernel" entry never routes a layout the kernels do not take
    _stub_measure(monkeypatch, route="kernel")
    AT.ensure("fwd", S, TINY.resolved_head_dim,
              TINY.n_heads // TINY.n_kv_heads)
    assert L.resolve_attn_backend("auto", TINY, S=S) == "online"


def test_ops_flash_attention_uses_tuned_blocks(monkeypatch):
    """ops.flash_attention launches the table's pick when the caller pins
    nothing (the recorder's plan shows the tiling), the default tiling
    when the key is untuned, and refuses a pair that names no tiling of
    the kernel, on the CPU too."""
    B, S, KV, G, hd = 1, 64, 2, 4, 64
    rng = np.random.default_rng(0)
    q, k, v = (torch.as_tensor(rng.normal(size=(B, S, n, hd)),
                               dtype=torch.float32) for n in (KV * G, KV, KV))
    assert ops.fwd_tiling(S, hd, G) == plans.FLASH_FWD_TILINGS[hd][0]
    seen = []
    real = AT.best_blocks

    def spy(S_, hd_, G_, op="fwd", dirname=None):
        seen.append((S_, hd_, G_, op))
        return (32, 64)

    monkeypatch.setattr(AT, "best_blocks", spy)
    out = ops.flash_attention(q, k, v)
    assert (S, hd, G, "fwd") in seen
    assert ops.fwd_tiling(S, hd, G) == (128, 64)
    (launch,) = ops._flash_plan()(132, q, k, v)
    assert launch.kernel == "flash_fwd<f32,64,128x64>"
    assert launch.threads == 256 and launch.grid == (KV, B, S // 32)
    monkeypatch.setattr(AT, "best_blocks", real)
    want = ops.flash_attention(q, k, v, block_q=32, block_k=64)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    # one of the two pinned: the other from the default tiling
    assert ops.fwd_tiling(S, hd, G, block_k=64) == (64, 64)
    for bq, bk in ((128, 128), (16, 16), (7, 32)):
        with pytest.raises(ValueError, match="names no tiling"):
            ops.flash_attention(q, k, v, block_q=bq, block_k=bk)
    # a head dim the kernel does not take: pinned raises, unpinned is the
    # plain version
    tq = torch.zeros(1, 64, 2, 16)
    ops.flash_attention(tq, tq[:, :, :1], tq[:, :, :1])
    with pytest.raises(ValueError):
        ops.flash_attention(tq, tq[:, :, :1], tq[:, :, :1], block_q=32,
                            block_k=32)


def test_measure_raises_on_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA"):
        AT.measure("fwd", 256, 64, 4, reps=1)
    assert AT.platform_key() == "cpu"


def test_cli_require_cached_gate(monkeypatch, _table_dir, capsys):
    """Two CLI runs over the same keys: the first measures and persists,
    the second is all-cached; --force re-measures and fails the gate;
    --list prints the table."""
    _stub_measure(monkeypatch)
    args = ["--s-list", "256,512", "--head-dim", "64", "--g", "1",
            "--reps", "1", "--ops", "fwd,grad"]
    assert AT.main(args) == 0
    assert AT.main(args + ["--require-cached"]) == 0
    out = capsys.readouterr().out
    assert out.count("[cached]") == 4
    assert AT.main(args + ["--require-cached", "--force"]) == 1
    assert AT.main(["--list"]) == 0
    out = capsys.readouterr().out
    assert "fwd|cpu|S256|hd64|G1" in out and "4 entries" in out
    assert AT.main(["--smoke", "--head-dim", "64", "--g", "4", "--ops",
                    "fwd", "--require-cached"]) == 1  # S 256 at G 4: new


def test_keys_and_candidate_filter_match_jax(monkeypatch):
    """key_for gives the JAX package's key on the same inputs; the
    degenerate-candidate filter keeps the pairs JAX's measure times (its
    timer stubbed, so nothing compiles) and shrinks block_k as it does."""
    for op, S, hd, G in (("fwd", 256, 16, 2), ("grad", 4352, 256, 2)):
        assert AT.key_for(op, S, hd, G, platform="p") == \
            JAT.key_for(op, S, hd, G, platform="p")
    monkeypatch.setattr(JAT, "_time_best", lambda fn, args, reps: 1.0)
    cases = [(64, 2, ((32, 32), (64, 64))), (64, 2, ((64, 64),)),
             (256, 4, ((64, 64), (64, 128), (128, 64))),
             (32, 8, ((16, 16), (8, 64), (16, 16))),
             (128, 1, ((128, 128), (128, 64), (64, 128)))]
    for S, G, cands in cases:
        want = JAT.measure("fwd", S, 8, G, reps=1, candidates=cands)
        got = AT.usable(S, G, cands)
        assert [f"{bq}x{bk}" for bq, bk in got] == list(want["pallas_ms"]), \
            (S, G, cands)
    # against the kernel's own pairs the shrink takes a tiling
    pairs = AT.kernel_pairs("fwd", 256, 2)
    assert AT.usable(8, 2, pairs, pairs) == [(16, 8)]
    assert AT.usable(512, 4, AT.kernel_pairs("fwd", 64, 4)) == list(
        AT.kernel_pairs("fwd", 64, 4))
