"""The JAX package's last public names in the port, against JAX on the CPU:
``repro_torch.utils``' flat-vector helpers (bit-equal on a TINY tree
converted both ways, and on a mixed-dtype tree), ``leaf_paths`` and
``leaf_offsets`` (string- and integer-equal), ``TrainConfig`` (fields and
defaults), ``repro_torch.configs``' exports, and
``models.layers.grouped_gqa_attention`` (at the tolerance at which
``tests/test_attention_variants.py`` holds JAX's to ``gqa_attention``,
with and without softcap, and against the port's ``gqa_attention``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

import repro.configs as JCFG
import repro.utils as JU
import repro.utils.tree as JT
import repro_torch.configs as CFG
import repro_torch.utils as U
from repro.configs.tiny import TINY as J_TINY
from repro.models import Model as JModel
from repro.models import layers as JL
from repro_torch.analysis import walk
from repro_torch.configs.tiny import TINY
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers as L
from repro_torch.utils.tree import tree_leaves

# tests/test_attention_variants.py's tolerance for the grouped decode
ATTN_ATOL = 2e-3


@pytest.fixture(scope="module")
def trees():
    jp = JModel(J_TINY).init(jax.random.key(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _mixed():
    rng = np.random.default_rng(0)
    return {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "blocks": [rng.normal(size=(5,)).astype(np.float16),
                       np.arange(6, dtype=np.int32).reshape(2, 3)],
            "a": rng.normal(size=(2, 2)).astype(np.float32)}


def test_flat_helpers_bit_equal_jax(trees):
    jp, tp = trees
    assert U.flat_size(tp) == JT.flat_size(jp)
    vec = U.tree_concat_flat(tp)
    jvec = np.asarray(JT.tree_concat_flat(jp))
    assert vec.dtype == torch.float32
    np.testing.assert_array_equal(vec.numpy(), jvec)
    back = U.tree_from_flat(tp, vec * 3)
    jback = JT.tree_from_flat(jp, jnp.asarray(jvec) * 3)
    for a, b, t in zip(tree_leaves(back), jax.tree_util.tree_leaves(jback),
                       tree_leaves(tp)):
        assert a.dtype == t.dtype and tuple(a.shape) == tuple(t.shape)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    zeros = U.tree_zeros_like_flat(tp)
    assert zeros.dtype == torch.float32 and zeros.device == vec.device
    np.testing.assert_array_equal(zeros.numpy(),
                                  np.asarray(JT.tree_zeros_like_flat(jp)))


def test_mixed_dtype_tree_round_trip():
    """Leaves of f32, f16 and int32 in dicts and a list: the flat vector
    is JAX's bit for bit, and each leaf comes back in its template's
    dtype."""
    tree = _mixed()
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = jax.tree.map(torch.as_tensor, tree)
    vec = U.tree_concat_flat(ttree)
    np.testing.assert_array_equal(vec.numpy(),
                                  np.asarray(JT.tree_concat_flat(jtree)))
    back = U.tree_from_flat(ttree, vec)
    jback = JT.tree_from_flat(jtree, JT.tree_concat_flat(jtree))
    for a, b in zip(tree_leaves(back), jax.tree_util.tree_leaves(jback)):
        assert str(a.dtype).replace("torch.", "") == str(b.dtype)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # numpy leaves as templates too
    for a, t in zip(tree_leaves(U.tree_from_flat(tree, vec)),
                    tree_leaves(tree)):
        assert a.numpy().dtype == t.dtype


@pytest.mark.parametrize("which", ["tiny", "mixed"])
def test_leaf_paths_and_offsets_equal_jax(trees, which):
    if which == "tiny":
        jtree, ttree = trees
    else:
        ttree = _mixed()
        jtree = jax.tree.map(jnp.asarray, ttree)
    assert U.leaf_paths(ttree) == JT.leaf_paths(jtree)
    assert U.leaf_offsets(ttree) == JT.leaf_offsets(jtree)
    if which == "mixed":
        assert U.leaf_paths(ttree) == ["['a']", "['blocks'][0]",
                                       "['blocks'][1]", "['w']"]


def test_utils_export_jax_names():
    for name in ("flat_size", "leaf_paths", "tree_concat_flat",
                 "tree_from_flat", "tree_zeros_like_flat",
                 "max_square_dims"):
        assert callable(getattr(JU, name)) and callable(getattr(U, name))
    assert U.max_square_dims is walk.max_square_dims
    from repro_torch.utils import max_square_dims  # noqa: F401
    with pytest.raises(AttributeError):
        U.no_such_name


def test_train_config_equals_jax():
    from repro.configs.base import TrainConfig as J
    from repro_torch.configs.base import TrainConfig as T
    fields = lambda c: [(f.name, f.type, f.default)
                        for f in dataclasses.fields(c)]
    assert fields(T) == fields(J)
    assert T() == T(**dataclasses.asdict(J()))
    assert CFG.TrainConfig is T


def test_configs_export_jax_names():
    """Every name of ``repro.configs.__all__`` but the TPU table ``HW``
    (the card's peaks are ``launch/roofline.HW``; C24)."""
    for name in set(JCFG.__all__) - {"HW"}:
        assert hasattr(CFG, name), name
    assert not hasattr(CFG, "HW")


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("B,KV,G,W,frac", [(2, 2, 7, 96, 0.3),
                                           (3, 4, 2, 64, 1.0)])
def test_grouped_gqa_attention_matches_jax(B, KV, G, W, frac, softcap):
    H, hd = KV * G, 32
    jcfg = J_TINY.replace(n_heads=H, n_kv_heads=KV, attn_softcap=softcap)
    cfg = TINY.replace(n_heads=H, n_kv_heads=KV, attn_softcap=softcap)
    k1, k2, k3 = jax.random.split(jax.random.key(B * 100 + W), 3)
    q = jax.random.normal(k1, (B, 1, H, hd))
    k = jax.random.normal(k2, (B, W, KV, hd))
    v = jax.random.normal(k3, (B, W, KV, hd))
    cur = max(0, int(W * frac) - 1)
    valid = jnp.arange(W)[None, None, :] <= cur
    want = np.asarray(JL.grouped_gqa_attention(q, k, v, valid, jcfg, None))
    tq, tk, tv, tvalid = (torch.as_tensor(np.array(x))
                          for x in (q, k, v, valid))
    got = L.grouped_gqa_attention(tq, tk, tv, tvalid, cfg)
    assert got.shape == (B, 1, H, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_ATOL)
    oracle = L.gqa_attention(tq, tk, tv, tvalid, cfg)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), atol=ATTN_ATOL)
