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
from repro_torch.utils.tree import tree_leaves

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
    tp = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
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
    assert [tuple(t.shape) for t in tree_leaves(tp)] == \
        [tuple(s.shape) for s in jax.tree_util.tree_leaves(jp)]


def test_attn_backend_resolution():
    cfg = LLAMA32_1B
    assert L.resolve_attn_backend("auto", cfg, S=128) == "dense"
    assert L.resolve_attn_backend("auto", cfg, S=512) == "kernel"
    assert L.resolve_attn_backend("auto", cfg, S=512,
                                  differentiable=True) == "kernel"
    assert L.resolve_attn_backend("auto", cfg, S=128,
                                  differentiable=True) == "dense"
    assert L.resolve_attn_backend("kernel", cfg, S=16) == "kernel"
    # head_dim 16, which the kernels do not take: the blockwise online route
    assert L.resolve_attn_backend("auto", TINY, S=512) == "online"
    assert L.resolve_attn_backend("auto", TINY, S=128) == "dense"
    assert L.resolve_attn_backend("online", cfg, S=16) == "online"
    with pytest.raises(ValueError):
        L.resolve_attn_backend("pallas", cfg)


def test_attn_backend_resolution_head_dim_256():
    """The forward and the backward kernels take Gemma-2's head_dim 256:
    auto takes the kernel at and above ATTN_AUTO_MIN_S, under autograd
    too; the backward's 32-row tiles at head_dim 256 take G <= 32."""
    from repro_torch.configs import GEMMA2_2B
    assert GEMMA2_2B.resolved_head_dim == 256
    assert L.resolve_attn_backend("auto", GEMMA2_2B, S=4208) == "kernel"
    assert L.resolve_attn_backend("auto", GEMMA2_2B, S=4208,
                                  differentiable=True) == "kernel"
    assert L.resolve_attn_backend("auto", GEMMA2_2B, S=128) == "dense"
    assert L.resolve_attn_backend("auto", GEMMA2_2B, S=L.ATTN_AUTO_MIN_S,
                                  differentiable=True) == "kernel"
    wide = GEMMA2_2B.replace(n_heads=64, n_kv_heads=1)  # G 64
    assert L.resolve_attn_backend("auto", wide, S=4208) == "kernel"
    assert L.resolve_attn_backend("auto", wide, S=4208,
                                  differentiable=True) == "online"


@pytest.mark.parametrize("grad,route", [(False, "kernel"), (True, "kernel")])
def test_forward_attention_head_dim_256_routes(monkeypatch, grad, route):
    """forward_attention sees whether autograd records: at head_dim 256 a
    forward and a differentiated pass both go to the flash kernels (the
    latter through FlashAttentionFn and its backward kernels); both give
    the dense route's values, and the differentiated pass its gradient."""
    from repro_torch.configs import GEMMA2_2B
    from repro_torch.kernels import ops
    cfg = GEMMA2_2B.replace(n_heads=2, n_kv_heads=1)
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    g = torch.Generator().manual_seed(0)
    S = L.ATTN_AUTO_MIN_S
    q = torch.randn(1, S, 2, 256, generator=g, requires_grad=grad)
    k, v = (torch.randn(1, S, 1, 256, generator=g) for _ in range(2))
    out = L.forward_attention(q, k, v, cfg, ModelCtx(), window=64,
                              lengths=torch.tensor([S - 9]))
    assert (len(calls) == 1) == (route == "kernel")
    want = L.forward_attention(q, k, v, cfg, ModelCtx(attn_backend="dense"),
                               window=64, lengths=torch.tensor([S - 9]))
    torch.testing.assert_close(out, want, atol=1e-5, rtol=0)
    if grad:
        w = torch.randn(out.shape, generator=g)
        (gk,) = torch.autograd.grad((out * w).sum(), q)
        (gd,) = torch.autograd.grad((want * w).sum(), q)
        torch.testing.assert_close(gk, gd, atol=1e-5, rtol=0)


def test_explicit_kernel_attention_under_autograd_matches_dense():
    """The kernel route differentiates (through FlashAttentionFn, whose
    plain versions run on the CPU) and gives the dense route's gradients:
    two f32 orders of the same sums (9.2e-7 of the largest entry seen)."""
    from repro_torch.core.gradip import grad_tree
    _, _, tm, tp, batch = _pair("llama-reduced", "kernel", S=40)
    dense = Model(tm.cfg, ModelCtx(attn_backend="dense"), device="cpu")
    gk = grad_tree(tm.loss, tp, batch)
    gd = grad_tree(dense.loss, tp, batch)
    for a, b in zip(tree_leaves(gk), tree_leaves(gd)):
        tol = 1e-5 * max(1e-3, float(b.abs().max()))
        torch.testing.assert_close(a, b, atol=tol, rtol=0)
