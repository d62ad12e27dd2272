"""The port's LM loss against the JAX package's with and without
``batch["loss_mask"]``: TINY, B=2, S=16, weights carried across by
``convert.params_from_numpy``; the mean and the per-example form."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from repro.configs.tiny import TINY as J_TINY
from repro.models import Model as JModel
from repro.models.transformer import ShardCtx
from repro_torch.configs.tiny import TINY
from repro_torch.convert import params_from_numpy
from repro_torch.models import Model, ModelCtx

B, S = 2, 16
# two stacks of f32 CPU kernels (XLA vs ATen) summing the same logits in
# other orders: the losses (~6.3) agree to ~1e-6
LOSS_ATOL = 1e-5


def _prefix_mask():
    m = np.zeros((B, S), np.int32)
    m[:, :8] = 1
    return m


def _ragged_mask():
    """Row 0 keeps positions 3..10; row 1 keeps none (the clamp)."""
    m = np.zeros((B, S), np.int32)
    m[0, 3:11] = 1
    return m


MASKS = {"none": None, "prefix8": _prefix_mask, "ragged": _ragged_mask}


@pytest.fixture(scope="module")
def pair():
    jm = JModel(J_TINY, ShardCtx(attn_backend="dense"))
    jp = jm.init(jax.random.key(11))
    tm = Model(TINY, ModelCtx(attn_backend="dense"), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(16).integers(0, J_TINY.vocab, (B, S)
                                              ).astype(np.int32)
    return jm, jp, tm, tp, toks


@pytest.mark.parametrize("per_example", [False, True])
@pytest.mark.parametrize("mask", list(MASKS))
def test_lm_loss_with_loss_mask_matches_jax(pair, mask, per_example):
    jm, jp, tm, tp, toks = pair
    m = None if MASKS[mask] is None else MASKS[mask]()
    jb = {"tokens": jnp.asarray(toks)}
    tb = {"tokens": toks}
    if m is not None:
        jb["loss_mask"] = jnp.asarray(m)
        tb["loss_mask"] = m
    want = np.asarray(jm.loss(jp, jb, per_example=per_example))
    got = tm.loss(tp, tb, per_example=per_example).numpy()
    assert got.shape == want.shape == ((B,) if per_example else ())
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)
    if mask == "ragged" and per_example:
        assert got[1] == 0.0  # no kept position: 0 / max(0, 1)


def test_loss_mask_changes_the_loss(pair):
    """The mask is read: a prefix mask moves each example's loss away from
    the plain mean, and an all-ones mask gives the plain mean."""
    _, _, tm, tp, toks = pair
    plain = tm.loss(tp, {"tokens": toks}, per_example=True)
    masked = tm.loss(tp, {"tokens": toks, "loss_mask": _prefix_mask()},
                     per_example=True)
    ones = tm.loss(tp, {"tokens": toks,
                        "loss_mask": np.ones((B, S), np.int32)},
                   per_example=True)
    assert bool((masked - plain).abs().min() > 1e-4)
    torch.testing.assert_close(ones, plain, rtol=1e-6, atol=0)
