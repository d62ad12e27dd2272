"""The port's dry run (``repro_torch.launch.dryrun``) and its inputs on the
CPU, against the JAX package: ``make_ctx`` field for field for every
``ASSIGNED`` arch x shape x mesh (JAX's side in a subprocess,
``tests/jax_mesh_side.py``: importing ``repro.launch.dryrun`` sets
``XLA_FLAGS``); the abstract inputs' shapes and dtypes (``input_specs``,
``abstract_cache``, ``abstract_mask`` and its density); the records'
parameter counts, skipped rows and keys; the depth-1/2 extrapolation
against a full-depth trace; ``roofline.collect`` on the records; the CLI;
``fake_mesh``; and the Mamba stub and the mLSTM's query block
(``ModelCtx.mlstm_block``) against JAX's (C19's tolerance)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

import torch_mesh_ranks as R
from repro.configs import ASSIGNED as J_ASSIGNED
from repro.configs import get_config as j_get_config
from repro.configs import get_shape as j_get_shape
from repro.core.masks import abstract_mask as j_abstract_mask
from repro.models.decode import abstract_cache as j_abstract_cache
from repro.models.init import abstract_params as j_abstract_params
from repro.models.init import active_param_count as j_active
from repro.models.init import param_count as j_count
from repro.models.model import input_specs as j_input_specs
from repro.models.ssm import mamba_forward as j_mamba_forward
from repro.models.xlstm import mlstm_forward as j_mlstm_forward
from repro_torch.configs import ASSIGNED, TINY, get_config, get_shape
from repro_torch.configs.base import MeshConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.masks import abstract_mask
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import mesh as M
from repro_torch.models import ssm, xlstm
from repro_torch.models.decode import abstract_cache
from repro_torch.models.init import abstract_params
from repro_torch.models.model import input_specs
from repro_torch.models.transformer import ModelCtx
from repro_torch.utils.tree import tree_flatten_with_keys

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
# the keys repro/launch/dryrun.py writes (lines 206-261): a skipped row,
# and an ok row with its fit
SKIP_KEYS = {"arch", "shape", "mesh", "step", "ok", "n_params",
             "n_active_params", "n_devices", "skipped"}
OK_KEYS = (SKIP_KEYS - {"skipped"}) | {
    "compile_s", "memory", "cost_full_scan", "collectives_full_scan",
    "fit_points", "cost", "collectives"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
               "peak_est_bytes"}
# C19: the mixers' f32 sums in another order, of the output's max |y|
MIXER_REL = 1e-5
# three periods of TINY's one layer, so the full depth is not a fit point
TINY3 = TINY.replace(name="tiny-3", n_layers=3)


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


def _struct(tree):
    """{path: (shape, dtype)} of a torch or JAX tree of leaves."""
    return {p: (tuple(a.shape), _dtype(a.dtype))
            for p, a in tree_flatten_with_keys(tree)[0]}


@pytest.fixture(scope="module", autouse=True)
def jax_ctx(tmp_path_factory):
    """JAX's side of :func:`test_make_ctx_matches_jax`, started in a
    subprocess before the module's first test; that test, the module's
    last, waits for it."""
    out = str(tmp_path_factory.mktemp("ctx") / "ctx.json")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable,
                             os.path.join(HERE, "jax_mesh_side.py"), "ctx",
                             out], env=env)

    def result():
        assert proc.wait(timeout=600) == 0
        with open(out) as f:
            return json.load(f)
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def tiny_record():
    return dryrun.run_combo(TINY3, R.TEST_SHAPE, False, full=True)


@pytest.mark.parametrize("name", sorted(J_ASSIGNED))
def test_abstract_inputs_match_jax(name):
    """input_specs (bf16, as the dry run lowers), the decode shapes'
    abstract caches, the parameters and the 1e-3 mask with its effective
    density: equal shapes and dtypes."""
    jcfg, cfg = j_get_config(name), get_config(name)
    for shape in SHAPES:
        js, s = j_get_shape(shape), get_shape(shape)
        assert _struct(input_specs(cfg, s)) == \
            _struct(j_input_specs(jcfg, js, dtype=jnp.bfloat16))
        if s.kind == "decode":
            B, S = 2, 64    # the layout, at a size eval_shape takes quickly
            assert _struct(abstract_cache(cfg, B, S)) == \
                _struct(j_abstract_cache(jcfg, B, S))
    ap, jap = abstract_params(cfg), j_abstract_params(jcfg)
    assert _struct(ap) == _struct(jap)
    idx, eff = abstract_mask(ap, 1e-3)
    jidx, jeff = j_abstract_mask(jap, 1e-3)
    assert eff == jeff and _struct(idx) == _struct(jidx)


def test_record_counts_skips_and_keys(tiny_record):
    """Every combination's parameter counts are JAX's and the long-context
    rows JAX skips are skipped (records of those rows are written at
    once); an ok record carries JAX's keys, ``memory`` its five."""
    for name, cfg in ASSIGNED.items():
        jcfg = j_get_config(name)
        assert dryrun.param_count(cfg) == j_count(jcfg)
        assert dryrun.active_param_count(cfg) == j_active(jcfg)
        if not dryrun.applicable(cfg, get_shape("long_500k")):
            rec = dryrun.run_combo(name, "long_500k", False)
            assert set(rec) == SKIP_KEYS and not rec["ok"]
    rec = tiny_record
    assert rec["ok"] and OK_KEYS <= set(rec) and rec["full_depth"]
    assert set(rec["memory"]) == MEMORY_KEYS
    assert rec["n_devices"] == 256 and rec["step"] == "zo_fl"


def test_fit_extrapolation_equals_full_count(tiny_record):
    """Every period adds the same ops: the depth-1/2 points extrapolate
    to the three-period trace's FLOPs and collectives exactly, and to its
    bytes within 1% (each depth draws its own mask, and rank 0's share of
    its coordinates)."""
    rec = tiny_record
    assert rec["fit_exact"]
    ext = rec["fit_extrapolation"]
    assert ext["flops"] == rec["cost"]["flops"] > 0
    assert ext["collectives"] == rec["collectives"]
    assert rec["fit_bytes_rel"] <= 0.01 and rec["cost"]["bytes"] > 0
    assert abs(ext["bytes"] - rec["cost"]["bytes"]) / rec["cost"]["bytes"] \
        == rec["fit_bytes_rel"]
    assert rec["collectives"]["all-reduce"] > 0
    assert rec["fit_points"][2]["flops"] > rec["fit_points"][1]["flops"]


def test_roofline_collects_records(tmp_path, tiny_record):
    """``roofline.collect`` reads the port's records as they are."""
    rec = dict(tiny_record, arch="tiny-3", shape="train_4k")
    (tmp_path / "tiny_train_4k_single.json").write_text(json.dumps(rec))
    rows = roofline.collect(str(tmp_path), "single")
    assert len(rows) == 1 and rows[0]["arch"] == "tiny-3"
    assert rows[0]["hlo_flops_per_dev"] == rec["cost"]["flops"]
    assert "tiny-3" in roofline.to_markdown(rows)


def test_cli_writes_records(tmp_path, capsys):
    """The CLI writes a skipped row and an ok row (TINY's decode at
    decode_32k: 8 rows a rank over a 32,768-position cache) and caches
    them."""
    out = str(tmp_path)
    for shape in ("long_500k", "decode_32k"):
        dryrun.main(["--arch", "tiny", "--shape", shape, "--out", out])
    with open(os.path.join(out, "tiny_long_500k_single.json")) as f:
        assert "skipped" in json.load(f)
    with open(os.path.join(out, "tiny_decode_32k_single.json")) as f:
        rec = json.load(f)
    assert rec["ok"] and rec["cost"]["bytes"] > 0 and "wall_s" in rec
    dryrun.main(["--arch", "tiny", "--shape", "decode_32k", "--out", out])
    assert "[skip]" in capsys.readouterr().out


def test_fake_mesh_is_one_group_at_a_time():
    """fake_mesh leaves no group behind and refuses to nest."""
    mc = MeshConfig(data=2, model=4)
    with M.fake_mesh(mc) as mesh:
        assert mesh.shape == (2, 4) and mesh.mesh_dim_names == mc.axis_names
        with pytest.raises(RuntimeError):
            with M.fake_mesh(mc):
                pass
    assert not torch.distributed.is_initialized()


def _rel(got, want):
    got = np.asarray(got.detach() if hasattr(got, "detach") else got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _layer(name, pos):
    """Period 0's parameters at pattern position ``pos`` of the reduced
    config, from the port's init (numpy)."""
    from repro_torch.models import Model
    params = Model(get_config(name).reduced(), device="cpu").init(seed=0)
    return {k: v[0].numpy() for k, v in params["stack"][pos].items()
            if not isinstance(v, dict)}


def test_mamba_stub_matches_jax():
    """The dry run's traffic stand-in against JAX's ``mode="stub"`` on a
    reduced Jamba Mamba layer."""
    jcfg = j_get_config("jamba-1.5-large-398b").reduced()
    lp = _layer("jamba-1.5-large-398b", "p1")
    x = np.random.default_rng(3).standard_normal(
        (2, 24, jcfg.d_model)).astype(np.float32)
    want = j_mamba_forward(jnp.asarray(x), jax.tree.map(jnp.asarray, lp),
                           jcfg.ssm, mode="stub")
    with torch.no_grad():
        got = ssm.mamba_forward(torch.tensor(x),
                                params_from_numpy(lp, device="cpu"),
                                get_config("jamba-1.5-large-398b").reduced()
                                .ssm, mode="stub")
    assert _rel(got, want) <= MIXER_REL


def test_mlstm_block_from_ctx_matches_jax():
    """``ModelCtx.mlstm_block`` tiles the mLSTM's queries as JAX's
    ``block`` argument does (and as the port's own ``block``)."""
    jcfg = j_get_config("xlstm-350m").reduced()
    lp = _layer("xlstm-350m", "p0")
    x = np.random.default_rng(4).standard_normal(
        (2, 32, jcfg.d_model)).astype(np.float32)
    want = j_mlstm_forward(jnp.asarray(x), jax.tree.map(jnp.asarray, lp),
                           jcfg.xlstm, block=8)
    tp = params_from_numpy(lp, device="cpu")
    xcfg = get_config("xlstm-350m").reduced().xlstm
    with torch.no_grad():
        got = xlstm.mlstm_forward(torch.tensor(x), tp, xcfg,
                                  ctx=ModelCtx(mlstm_block=8))
        own = xlstm.mlstm_forward(torch.tensor(x), tp, xcfg, block=8)
    assert torch.equal(got, own)
    assert _rel(got, want) <= MIXER_REL


def test_make_ctx_matches_jax(jax_ctx):
    """Every field JAX's ``make_ctx`` sets (but the scan unrolls, ROADMAP
    C22), and ``applicable``, for all 80 combinations."""
    jax_ctx = jax_ctx()
    assert len(jax_ctx) == len(ASSIGNED) * len(SHAPES) * 2
    for name, cfg in ASSIGNED.items():
        for shape in SHAPES:
            for mp in (False, True):
                want = dict(jax_ctx[f"{name}|{shape}|{mp}"])
                c = dryrun.make_ctx(cfg, get_shape(shape), None,
                                    M.mesh_config(multi_pod=mp))
                assert dryrun.applicable(cfg, get_shape(shape)) == \
                    want.pop("applicable")
                got = {f: list(v) if isinstance(v, tuple) else v
                       for f, v in ((f, getattr(c, f)) for f in want)}
                assert got == want, (name, shape, mp)
