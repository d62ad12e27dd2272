"""The flash-attention backward of the port on the CPU (the wrappers' plain
versions, ``kernels/ref.py``) against torch autograd through the dense
route and against the JAX package's Pallas VJP in interpret mode:

* the plain dQ and dK/dV versions equal autograd through ``gqa_attention``;
* ``FlashAttentionFn`` equals ``jax.vjp`` of ``repro.kernels.ops
  .flash_attention`` over the matrix of ``tests/test_attn_vjp.py``, and at
  Gemma-2's head_dim 256;
* dK/dV vanish past each row's length, and a length-0 row is finite zero;
* the whole TINY model's gradient on the ``kernel`` route equals
  ``jax.grad`` with ``attn_backend="pallas"``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs.tiny import TINY as J_TINY
from repro.kernels import ops as jops
from repro.models import Model as JModel
from repro.models.transformer import ShardCtx
from repro_torch.configs.tiny import TINY
from repro_torch.convert import params_from_numpy
from repro_torch.core.gradip import grad_tree
from repro_torch.kernels import ops, ref
from repro_torch.models import Model, ModelCtx
from repro_torch.models import layers as L
from repro_torch.utils.tree import tree_leaves

# (S, H, KV, softcap, window, lengths-fraction): tests/test_attn_vjp.py's
# matrix of softcap x sliding window x GQA ratio x odd S x per-row lengths
MATRIX = [
    (64, 4, 2, 0.0, 0, None),
    (64, 4, 2, 30.0, 0, None),
    (64, 4, 2, 0.0, 24, None),
    (64, 4, 1, 0.0, 0, None),
    (67, 4, 2, 0.0, 0, None),
    (64, 4, 2, 0.0, 0, 0.5),
    (67, 4, 2, 20.0, 16, 0.75),
]
HD = 16  # TINY's head_dim, as in tests/test_attn_vjp.py


@pytest.fixture(autouse=True)
def _isolated_autotune(monkeypatch, tmp_path):
    """Keep the JAX package's block sizes independent of any committed
    autotune table, as tests/test_attn_vjp.py does."""
    from repro.kernels import autotune
    monkeypatch.setenv("REPRO_AUTOTUNE_DIR", str(tmp_path / "at"))
    autotune.clear_cache()
    yield
    autotune.clear_cache()


def _case(S, H, KV, lfrac, seed=0, hd=HD):
    """q, k, v, lengths and the cotangent as numpy, the cotangent made as in
    tests/test_attn_vjp.py (position-dependent, zero past each length)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(2, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(2, S, KV, hd)).astype(np.float32)
    lengths = np.array([S, S if lfrac is None else max(1, int(S * lfrac))],
                       np.int32)
    w = np.sin(np.arange(q.size, dtype=np.float32).reshape(q.shape) * 1e-3)
    w = np.where(np.arange(S)[None, :, None, None]
                 < lengths[:, None, None, None], w, 0.0).astype(np.float32)
    return q, k, v, lengths, w


def _torch_vjp(q, k, v, lengths, w, window, cap):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = ops.flash_attention(qt, kt, vt, torch.tensor(lengths),
                              window=window, softcap=cap)
    return torch.autograd.grad((out * torch.tensor(w)).sum(), (qt, kt, vt))


@pytest.mark.parametrize("S,H,KV,cap,window,lfrac", MATRIX)
def test_plain_backward_equals_autograd_through_dense(S, H, KV, cap, window,
                                                      lfrac):
    """(a) the plain dQ and dK/dV versions, fed the forward's lse and
    delta, against torch autograd through the dense ``gqa_attention``:
    two f32 orders of the same sums (largest difference seen 8.6e-6)."""
    q, k, v, lengths, w = (torch.tensor(x) for x in _case(S, H, KV, lfrac))
    cfg = TINY.replace(n_heads=H, n_kv_heads=KV, attn_softcap=cap)
    qd, kd, vd = (x.clone().requires_grad_(True) for x in (q, k, v))
    mask = ref.attention_valid(S, lengths, window=window, causal=True)
    out = L.gqa_attention(qd, kd, vd, mask, cfg)
    want = torch.autograd.grad((out * w).sum(), (qd, kd, vd))
    o, lse = ref.flash_attention_ref(q, k, v, lengths, window=window,
                                     softcap=cap, causal=True)
    args = (q, k, v, lengths, lse, ref.flash_attention_delta(o, w, KV), w)
    kw = dict(window=window, softcap=cap, causal=True)
    got = (ref.flash_attn_bwd_dq_ref(*args, **kw),
           *ref.flash_attn_bwd_dkv_ref(*args, **kw))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("S,H,KV,cap,window,lfrac", MATRIX)
def test_flash_fn_matches_pallas_vjp(S, H, KV, cap, window, lfrac):
    """(b) FlashAttentionFn on the CPU against jax.vjp of the Pallas
    kernels (interpret mode): the same numpy inputs and cotangent (largest
    difference seen 6.7e-6)."""
    q, k, v, lengths, w = _case(S, H, KV, lfrac)

    def jfn(q, k, v):
        return jops.flash_attention(q, k, v, jnp.asarray(lengths),
                                    window=window, softcap=cap, block_q=32,
                                    block_k=32, interpret=True)

    _, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(w))
    got = _torch_vjp(q, k, v, lengths, w, window, cap)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0)


def test_dkv_zero_past_lengths_and_empty_row_finite():
    """(c) keys and values at positions >= lengths[b] get exactly zero
    cotangent, and a row with no live key (length 0) gets zero, finite
    gradients everywhere."""
    S, H, KV = 64, 4, 2
    q, k, v, _, w = _case(S, H, KV, None, seed=3)
    Lrow = S // 2
    dq, dk, dv = _torch_vjp(q, k, v, np.array([S, Lrow], np.int32), w, 0,
                            0.0)
    assert float(dk[1, Lrow:].abs().max()) == 0.0
    assert float(dv[1, Lrow:].abs().max()) == 0.0
    assert float(dv[1, :Lrow].abs().max()) > 0.0
    dq, dk, dv = _torch_vjp(q, k, v, np.array([S, 0], np.int32), w, 0, 0.0)
    for g in (dq, dk, dv):
        assert bool(torch.isfinite(g).all())
        assert float(g[1].abs().max()) == 0.0
    assert float(dq[0].abs().max()) > 0.0


def test_flash_attention_dispatch():
    """The Function only while autograd records: a no-grad call is one
    bare forward, and lse is never differentiable."""
    q, k, v, lengths, _ = _case(16, 4, 2, None)
    qt, kt, vt = (torch.tensor(x) for x in (q, k, v))
    assert ops.flash_attention(qt, kt, vt).grad_fn is None
    qt.requires_grad_(True)
    out, lse = ops.flash_attention(qt, kt, vt, return_lse=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    assert not lse.requires_grad
    with torch.no_grad():
        assert ops.flash_attention(qt, kt, vt).grad_fn is None


def test_model_grad_kernel_route_matches_jax_pallas():
    """(d) the whole TINY model at S=320 (the blockwise regime): the port's
    ``kernel`` route under torch autograd against jax.grad through the
    Pallas VJP, at the JAX package's own whole-model bound (rtol 2e-3,
    atol 2e-4); the largest difference seen was 8.4e-9 absolute."""
    S = 320
    jm = JModel(J_TINY, ctx=ShardCtx(attn_backend="pallas"))
    jp = jm.init(jax.random.key(0))
    toks = np.random.default_rng(0).integers(0, J_TINY.vocab, (2, S)
                                             ).astype(np.int32)
    jg = jax.grad(lambda p: jm.loss(p, {"tokens": jnp.asarray(toks)}))(jp)
    tm = Model(TINY, ModelCtx(attn_backend="kernel"), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tg = grad_tree(lambda p, b: tm.loss(p, b), tp, {"tokens": toks})
    for a, b in zip(tree_leaves(tg), jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3,
                                   atol=2e-4)


# Gemma-2's head_dim 256 (the backward kernels' third instance): (S, H, KV,
# softcap, window, lengths-fraction), H 2 over KV 1 (G 2, as in Gemma-2-2b)
MATRIX_256 = [
    (64, 2, 1, 0.0, 0, None),
    (67, 2, 1, 50.0, 24, 0.75),
]


@pytest.mark.parametrize("S,H,KV,cap,window,lfrac", MATRIX_256)
def test_flash_fn_matches_pallas_vjp_head_dim_256(S, H, KV, cap, window,
                                                  lfrac):
    """FlashAttentionFn at head_dim 256 on the CPU against jax.vjp of the
    Pallas kernels (interpret mode), on the same numpy inputs and
    cotangent, at the tolerance of the head_dim-16 matrix above."""
    q, k, v, lengths, w = _case(S, H, KV, lfrac, seed=7, hd=256)

    def jfn(q, k, v):
        return jops.flash_attention(q, k, v, jnp.asarray(lengths),
                                    window=window, softcap=cap, block_q=32,
                                    block_k=32, interpret=True)

    _, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(w))
    got = _torch_vjp(q, k, v, lengths, w, window, cap)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0)
