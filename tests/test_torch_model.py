"""The dense decoder in torch against repro's, on parameters converted from
JAX (convert.params_from_numpy): logits and the LM loss on the dense and
the kernel attention routes, and the flat layout of FlatBacking."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.paper_models import LLAMA32_1B as J_LLAMA
from repro.configs.tiny import TINY as J_TINY
from repro.core.dispatch import get_backing as j_get_backing
from repro.core.spaces import DenseSpace as JDense
from repro.models import Model as JModel
from repro.models.transformer import ShardCtx
from repro_torch.configs.paper_models import LLAMA32_1B
from repro_torch.configs.tiny import TINY
from repro_torch.convert import params_from_numpy
from repro_torch.core.dispatch import get_backing
from repro_torch.core.spaces import DenseSpace
from repro_torch.models import Model, ModelCtx, param_count
from repro_torch.models import layers as L

CFGS = {"tiny": (J_TINY, TINY),
        "llama-reduced": (J_LLAMA.reduced(), LLAMA32_1B.reduced())}
# logits of a 2-layer model in f32 on two stacks of CPU kernels (XLA vs
# ATen): summation order and transcendental ulps differ, ~1e-6 observed
ATOL = 1e-4


def _pair(name, route, S):
    jcfg, tcfg = CFGS[name]
    jm = JModel(jcfg, ShardCtx(attn_backend="pallas" if route == "kernel"
                               else "dense"))
    params = jm.init(jax.random.key(3))
    tm = Model(tcfg, ModelCtx(attn_backend=route), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, params))
    toks = np.random.default_rng(S).integers(0, jcfg.vocab, (2, S)
                                             ).astype(np.int32)
    return jm, params, tm, tp, {"tokens": toks}


@pytest.mark.parametrize("route", ["dense", "kernel"])
@pytest.mark.parametrize("name", list(CFGS))
def test_logits_and_loss_match_jax(name, route):
    jm, params, tm, tp, batch = _pair(name, route, S=40)
    jl, _ = jm.forward(params, batch)
    tl, _ = tm.forward(tp, batch)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert float(tm.loss(tp, batch)) == pytest.approx(
        float(jm.loss(params, batch)), abs=ATOL)


@pytest.mark.parametrize("name", list(CFGS))
def test_flat_layout_bit_equal(name):
    _, params, _, tp, _ = _pair(name, "dense", S=8)
    jf = np.asarray(j_get_backing(JDense(params), params).flatten(params))
    backing = get_backing(DenseSpace(tp), tp)
    tf = backing.flatten(tp)
    np.testing.assert_array_equal(tf.numpy(), jf)
    jb = j_get_backing(JDense(params), params)
    assert backing.n_pad == jb.n_pad and backing.n_flat == jb.n_flat
    assert list(backing.offsets) == [int(o) for o in jb.offsets]


def test_unflatten_returns_views():
    _, _, _, tp, _ = _pair("tiny", "dense", S=8)
    backing = get_backing(DenseSpace(tp), tp)
    flat = backing.flatten(tp)
    tree = backing.unflatten(flat)
    leaf = tree["stack"]["p0"]["wq"]
    assert leaf.untyped_storage().data_ptr() == \
        flat.untyped_storage().data_ptr()
    flat.zero_()
    assert torch.all(leaf == 0)


@pytest.mark.parametrize("name", list(CFGS))
def test_param_count_and_init_shapes(name):
    jcfg, tcfg = CFGS[name]
    from repro.models.init import param_count as j_param_count
    assert param_count(tcfg) == j_param_count(jcfg)
    tp = Model(tcfg, device="cpu").init(seed=1)
    jp = JModel(jcfg).abstract_params()
    from repro_torch.utils.tree import tree_leaves
    assert [tuple(t.shape) for t in tree_leaves(tp)] == \
        [tuple(s.shape) for s in jax.tree_util.tree_leaves(jp)]


def test_attn_backend_resolution():
    cfg = LLAMA32_1B
    assert L.resolve_attn_backend("auto", cfg, S=128) == "dense"
    assert L.resolve_attn_backend("auto", cfg, S=512) == "kernel"
    assert L.resolve_attn_backend("auto", cfg, S=512,
                                  differentiable=True) == "dense"
    assert L.resolve_attn_backend("kernel", cfg, S=16) == "kernel"
    assert L.resolve_attn_backend("auto", TINY, S=512) == "dense"  # hd 16
    with pytest.raises(ValueError):
        L.resolve_attn_backend("pallas", cfg)


def test_explicit_kernel_attention_under_autograd_raises():
    _, _, tm, tp, batch = _pair("llama-reduced", "kernel", S=16)
    leaf = tp["stack"]["p0"]["wq"].requires_grad_(True)
    with pytest.raises(NotImplementedError):
        tm.loss(tp, batch)
    leaf.requires_grad_(False)
    with torch.no_grad():
        assert torch.isfinite(tm.loss(tp, batch))
