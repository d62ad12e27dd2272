"""The masks module of the port against the JAX package's on TINY: the
sparsity baselines (weight magnitude, random, balanced or not) pick the
same indices, and MEERKAT's sensitivity mask at S=320, where both packages
differentiate through their flash kernels, overlaps the JAX mask."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core as JC
import repro_torch.core as TC
from repro.configs.tiny import TINY as J_TINY
from repro.models import Model as JModel
from repro.models.transformer import ShardCtx
from repro_torch.configs.tiny import TINY
from repro_torch.convert import params_from_numpy
from repro_torch.models import Model, ModelCtx
from repro_torch.utils.tree import tree_leaves


@pytest.fixture(scope="module")
def params():
    jp = JModel(J_TINY).init(jax.random.key(0))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _idx_leaves(jspace, tspace):
    return ([np.asarray(i, np.int64)
             for i in jax.tree_util.tree_leaves(jspace.idx_tree)],
            [i.numpy() for i in tree_leaves(tspace.idx_tree)])


def _assert_same_indices(jspace, tspace):
    jl, tl = _idx_leaves(jspace, tspace)
    assert len(jl) == len(tl) and tspace.n == jspace.n
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("density", [1e-3, 2e-2])
def test_magnitude_mask_matches_jax(params, density):
    jp, tp = params
    _assert_same_indices(JC.magnitude_mask(jp, density),
                         TC.magnitude_mask(tp, density))


@pytest.mark.parametrize("balanced", [True, False])
@pytest.mark.parametrize("seed", [0, 7])
def test_random_mask_matches_jax(params, balanced, seed):
    jp, tp = params
    _assert_same_indices(
        JC.random_mask(jp, 1e-2, seed=seed, balanced=balanced),
        TC.random_mask(tp, 1e-2, seed=seed, balanced=balanced))


def test_sensitivity_mask_on_kernel_route_overlaps_jax(params):
    """S=320: the port's kernel route (plain versions of the flash kernels
    on the CPU, recompute backward) against the JAX package's Pallas VJP
    (interpret mode).  Gradients agree to f32 rounding, so only a score tied
    with the top-k threshold to that precision could flip."""
    jp, tp = params
    jm = JModel(J_TINY, ctx=ShardCtx(attn_backend="pallas"))
    tm = Model(TINY, ModelCtx(attn_backend="kernel"), device="cpu")
    rng = np.random.default_rng(2)
    pre = [{"tokens": rng.integers(0, J_TINY.vocab, (2, 320)
                                   ).astype(np.int32)} for _ in range(2)]
    jspace = JC.sensitivity_mask(lambda p, b: jm.loss(p, b), jp, pre, 1e-2)
    tspace = TC.sensitivity_mask(lambda p, b: tm.loss(p, b), tp, pre, 1e-2,
                                 device="cpu")
    assert tspace.n == jspace.n
    off = np.cumsum([0] + [int(np.prod(p.shape))
                           for p in jax.tree_util.tree_leaves(jp)])
    jl, tl = _idx_leaves(jspace, tspace)
    jg = np.concatenate([i + o for i, o in zip(jl, off)])
    tg = np.concatenate([i + o for i, o in zip(tl, off)])
    assert len(np.intersect1d(jg, tg)) / len(jg) >= 0.999
