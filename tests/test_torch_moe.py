"""The MoE FFN in torch against repro's ``moe_dense_ref``: the batch-global
and the per-row (``valid``) dispatch, capacity that binds, the load-balance
loss, and ``jax.lax.top_k``'s order on ties; and against ``chip_smoke``'s
per-token loop, the oracle of its card check."""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.models import moe as JMOE
from repro.models.init import init_params as j_init
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe as MOE

# outputs of the largest entry: the router, expert and combine products
# are f32 sums in other orders (6.8e-7 seen); routing itself is identical,
# so the load-balance loss agrees to f32 rounding (equal here)
MOE_REL = 1e-5
CFG = "jamba-1.5-large-398b"


@pytest.fixture(scope="module")
def layer():
    """The first MoE layer of reduced Jamba (d 256, 4 experts of 256, top
    2), JAX init, and a [3, 24, 256] input."""
    jcfg = j_get_config(CFG).reduced()
    jp = j_init(jax.random.key(1), jcfg)
    lp = jax.tree.map(lambda a: np.asarray(a[0]), jp["stack"]["p1"])
    assert "router" in lp
    x = np.random.default_rng(3).standard_normal((3, 24, 256)).astype(
        np.float32)
    return dict(lp=lp, tp=params_from_numpy(lp, device="cpu"), x=x, jcfg=jcfg,
                tcfg=get_config(CFG + "-reduced"))


def _both(layer, cf, valid):
    jm = dataclasses.replace(layer["jcfg"].moe, capacity_factor=cf)
    tm = dataclasses.replace(layer["tcfg"].moe, capacity_factor=cf)
    jy, jaux = JMOE.moe_dense_ref(
        jnp.asarray(layer["x"]), jax.tree.map(jnp.asarray, layer["lp"]), jm,
        "silu", valid=None if valid is None else jnp.asarray(valid))
    ty, taux = MOE.moe_dense_ref(
        torch.tensor(layer["x"]), layer["tp"], tm, "silu",
        valid=None if valid is None else torch.tensor(valid))
    return (np.asarray(jy), float(jaux)), (ty.numpy(), float(taux)), tm


@pytest.mark.parametrize("valid", [None, "rows", "tokens"])
@pytest.mark.parametrize("cf", [2.0, 1.0])
def test_moe_dense_ref_matches_jax(layer, cf, valid):
    """Both dispatches, with capacity loose (2.0) and binding (1.0), and the
    per-row mask given per row ([B]) or per token ([B, S], right padded)."""
    v = None
    if valid == "rows":
        v = np.array([True, False, True])
    elif valid == "tokens":
        v = np.arange(24)[None, :] < np.array([24, 9, 1])[:, None]
    (jy, jaux), (ty, taux), _ = _both(layer, cf, v)
    assert np.abs(ty - jy).max() <= MOE_REL * np.abs(jy).max()
    assert taux == pytest.approx(jaux, rel=1e-6)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_capacity_binds_at_factor_one(layer):
    """At capacity_factor 1.0 the per-token loop (chip_smoke.moe_loop_ref)
    drops pairs and keeps at most C of each expert's, and moe_dense_ref's
    one-hot dispatch gives its output, within MOE_REL."""
    tm = dataclasses.replace(layer["tcfg"].moe, capacity_factor=1.0)
    x = torch.tensor(layer["x"])
    ry, kept, C = _chip_smoke().moe_loop_ref(torch, x, layer["tp"], tm)
    y, _ = MOE.moe_dense_ref(x, layer["tp"], tm, "silu")
    assert C == 3 * 24 * 2 // 4
    assert max(kept) == C and sum(kept) < 3 * 24 * 2
    assert float((y - ry).abs().max()) <= MOE_REL * float(ry.abs().max())


def test_top_k_ties_take_the_lower_index():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1],
                      [0.3, 0.2, 0.3, 0.2]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    tv, ti = MOE._top_k(torch.tensor(probs), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
