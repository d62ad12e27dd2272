"""The port's roofline (``launch/roofline.py``) against the JAX package's:
every FLOPs function for every arch at a few (B, S), ``analyze`` on a
synthetic dry-run record given JAX's hardware table, and the H100 table
that the port itself states."""
import functools
import json

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as j_get_config
from repro.configs.base import HW as J_HW
from repro.launch import roofline as jr
from repro.launch.hlo_tools import COLLECTIVE_FACTOR
from repro.models import init as j_init
from repro.models.init import active_param_count as j_active_param_count
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import roofline as R
from repro_torch.models.init import active_param_count

BS = ((1, 1), (16, 512), (4, 4096))
# JAX's TPU table under the port's key names
J_TABLE = {"peak_flops_bf16": J_HW["peak_flops_bf16"],
           "hbm_bw": J_HW["hbm_bw"], "link_bw": J_HW["ici_bw"]}


@pytest.mark.parametrize("arch", list_archs() + ["llama3.2-1b"])
def test_flops_equal_jax(arch, monkeypatch):
    # JAX's count traces the whole init each call: count once an arch
    monkeypatch.setattr(j_init, "active_param_count",
                        functools.lru_cache(j_active_param_count))
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert active_param_count(cfg) == j_active_param_count(jcfg)
    for B, S in BS:
        assert R.attention_flops(cfg, B, S) == jr.attention_flops(jcfg, B, S)
        assert R.attention_flops(cfg, B, S, causal=False) == \
            jr.attention_flops(jcfg, B, S, causal=False)
        assert R.forward_model_flops(cfg, B, S) == \
            jr.forward_model_flops(jcfg, B, S)
        for step in ("prefill", "forward", "zo_step", "first_order"):
            assert R.step_model_flops(cfg, B, S, step) == \
                jr.step_model_flops(jcfg, B, S, step)
    with pytest.raises(KeyError):
        R.step_model_flops(cfg, 1, 1, "decode")


def _record(step, shape, flops, nbytes, coll):
    return dict(ok=True, arch="qwen3-4b", shape=shape, step=step,
                mesh="single", n_devices=256, n_active_params=4_000_000_000,
                cost=dict(flops=flops, bytes=nbytes), collectives=coll,
                memory=dict(peak_est_bytes=1 << 33))


RECORDS = [
    _record("zo_fl", "train_4k", 3e15, 2e12, {"all-gather": 1e9}),
    _record("zo_dp", "train_4k", 1e12, 5e12, {"all-reduce": 4e6}),
    _record("prefill", "prefill_32k", 2e14, 1e11,
            {"all-gather": 9e12, "all-reduce": -5.0}),
    _record("decode", "decode_32k", 1e11, 4e12, {}),
    _record("first_order", "train_4k", 6e15, 1e12,
            {"reduce-scatter": 1e10, "collective-permute": 1e9}),
]


@pytest.mark.parametrize("rec", RECORDS, ids=lambda r: r["step"])
def test_analyze_equals_jax_given_its_table(rec, monkeypatch):
    got = R.analyze(rec, hw=J_TABLE)
    want = jr.analyze(rec)
    assert {k: v for k, v in got.items() if k != "note"} == \
        {k: v for k, v in want.items() if k != "note"}
    assert got["model_flops_per_dev"] == jr.model_flops_per_device(rec)
    if not (got["dominant"] == "compute" and rec["step"] == "zo_fl"):
        assert got["note"] == want["note"]  # the TPU's MXU named in JAX's
    assert R.analyze(dict(rec, ok=False)) is None


def test_collect_markdown_and_main(tmp_path, capsys):
    for i, rec in enumerate(RECORDS + [dict(RECORDS[0], mesh="multi")]):
        (tmp_path / f"r{i}.json").write_text(json.dumps(rec))
    rows = R.collect(str(tmp_path), "single", hw=J_TABLE)
    jrows = [jr.analyze(r) for r in RECORDS]
    assert len(rows) == len(RECORDS)
    assert R.to_markdown(rows).splitlines()[:2] == \
        jr.to_markdown(jrows).splitlines()[:2]
    for x in (2.5, 0.0123, 4e-5):
        assert R.fmt_s(x) == jr.fmt_s(x)
    R.main(["--dir", str(tmp_path), "--json", str(tmp_path / "o.json")])
    assert "5 rows" in capsys.readouterr().out
    assert len(json.loads((tmp_path / "o.json").read_text())) == 5


def test_h100_table_and_platform_peaks():
    """The H100 SXM data sheet at 700 W, and no TPU number."""
    assert R.HW == {"peak_flops_f32": 67e12, "peak_flops_tf32": 495e12,
                    "peak_flops_bf16": 989e12, "hbm_bw": 3.35e12,
                    "link_bw": 450e9}
    assert R.HW_CARD == "NVIDIA H100 80GB HBM3, 700.00 W"
    # keyed as kernels.autotune.platform_key() names the card; the default
    # is this host's key ("cpu" without a card), as in the JAX package
    assert R.host_peak_flops("nvidia_h100_80gb_hbm3") == 67e12
    assert R.host_peak_flops("cpu") == jr.host_peak_flops("cpu") == 1e11
    from repro_torch.kernels.autotune import platform_key
    assert R.host_peak_flops() == R.host_peak_flops(platform_key())
    with pytest.raises(KeyError, match="tpu_v5_lite"):
        R.host_peak_flops("tpu_v5_lite")
    assert R.COLLECTIVE_FACTOR == COLLECTIVE_FACTOR
    assert R.SHAPE_TOKENS == jr.SHAPE_TOKENS
