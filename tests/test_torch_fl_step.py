"""``core/fl_step`` of the port against ``repro.core.fl_step`` on TINY: the
T=1 step, the train loop (with and without report masks) and the T>1
round step, on both routes of both packages; and, inside the port, the loop
against the step folded over the batches, bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from repro.configs.tiny import TINY as J_TINY
from repro.core import fl_step as JF
from repro.core import random_mask as j_random_mask
from repro.models import Model as JModel
from repro_torch.configs.tiny import TINY
from repro_torch.convert import params_from_numpy, space_from_numpy
from repro_torch.core import fl_step as TF
from repro_torch.core.quantize import QuantSpec
from repro_torch.core import prng
from repro_torch.models import Model
from repro_torch.models.transformer import lm_loss
from repro_torch.utils.tree import tree_leaves

# Tolerances.  The two packages' forwards agree to a few f32 ulp of the
# loss; at TINY's vocab of 512 the loss is ~6.2, whose ulp is 4.8e-7, and
# g = (l+ - l-) / (2 eps) at eps = 1e-3 scales that by 500: four ulp give
# 1e-3 (6.5e-4 seen by the third step of the loop).
G_ATOL = 2e-3
# parameters move by lr * g * z per step: 1e-2 * 2e-3 * |z| (|z| < 5)
PARAM_ATOL = 1e-4
LOSS_RTOL = 1e-5
EPS, LR, K, B, S, N_STEPS = 1e-3, 1e-2, 2, 2, 16, 3
ROUTES = (("ref", "ref"), ("pallas", "kernel"))


@pytest.fixture(scope="module")
def setup():
    jm = JModel(J_TINY)
    jp = jm.init(jax.random.key(0))
    tm = Model(TINY, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jspace = j_random_mask(jp, density=1e-2, seed=3, balanced=False)
    tspace = space_from_numpy(jax.tree.map(np.asarray, jspace.idx_tree),
                              device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, TINY.vocab, size=(N_STEPS, K * B, S),
                          dtype=np.int32)
    masks = np.array([[1, 0], [0, 0], [1, 1]], np.float32)
    return dict(jm=jm, jp=jp, tm=tm, tp=tp, jspace=jspace, tspace=tspace,
                tokens=tokens, masks=masks)


def _j_loss(jm):
    return lambda p, b: jm.loss(p, b, per_example=True)


def _t_loss(tm):
    return lambda p, b: tm.loss(p, b, per_example=True)


def _close_params(tp, jp, atol=PARAM_ATOL):
    for t, j in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=atol)


def _equal_trees(a, b):
    return all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_lm_loss_per_example_matches_jax(setup):
    s = setup
    batch = {"tokens": s["tokens"][0]}
    jl = np.asarray(s["jm"].loss(s["jp"], {"tokens": jnp.asarray(
        batch["tokens"])}, per_example=True))
    tl = s["tm"].loss(s["tp"], batch, per_example=True)
    assert tl.shape == (K * B,)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=LOSS_RTOL)
    # the mean form is the mean of the per-example form
    mean = lm_loss(s["tp"], {"tokens": torch.as_tensor(batch["tokens"])},
                   TINY)
    np.testing.assert_allclose(float(mean), float(tl.mean()), rtol=1e-6)


@pytest.mark.parametrize("jbe,tbe", ROUTES)
@pytest.mark.parametrize("masked", [False, True])
def test_train_step_matches_jax(setup, jbe, tbe, masked):
    s = setup
    jstep = JF.make_fl_train_step(_j_loss(s["jm"]), s["jspace"], eps=EPS,
                                  lr=LR, n_clients=K, backend=jbe)
    tstep = TF.make_fl_train_step(_t_loss(s["tm"]), s["tspace"], eps=EPS,
                                  lr=LR, n_clients=K, backend=tbe)
    jmask = jnp.asarray(s["masks"][0]) if masked else None
    tmask = torch.as_tensor(s["masks"][0]) if masked else None
    jp2, jg, jmet = jstep(s["jp"], jax.random.key(5),
                          {"tokens": jnp.asarray(s["tokens"][0])}, jmask)
    tp2, tg, tmet = tstep(s["tp"], prng.key(5),
                          {"tokens": torch.as_tensor(s["tokens"][0])}, tmask)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=G_ATOL)
    np.testing.assert_allclose(float(tmet["g"]), float(jmet["g"]),
                               atol=G_ATOL)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=LOSS_RTOL)
    _close_params(tp2, jp2)


@pytest.mark.parametrize("jbe,tbe", ROUTES)
@pytest.mark.parametrize("masked", [False, True])
def test_train_loop_matches_jax(setup, jbe, tbe, masked):
    s = setup
    kw = dict(eps=EPS, lr=LR, n_clients=K, n_steps=N_STEPS)
    jloop = JF.make_fl_train_loop(_j_loss(s["jm"]), s["jspace"], backend=jbe,
                                  **kw)
    tloop = TF.make_fl_train_loop(_t_loss(s["tm"]), s["tspace"], backend=tbe,
                                  **kw)
    jargs = [s["jp"], jax.random.key(7), {"tokens": jnp.asarray(s["tokens"])}]
    targs = [s["tp"], prng.key(7), {"tokens": torch.as_tensor(s["tokens"])}]
    if masked:
        jargs.append(jnp.asarray(s["masks"]))
        targs.append(torch.as_tensor(s["masks"]))
    jp2, jgs, jmet = jloop(*jargs)
    tp2, tgs, tmet = tloop(*targs)
    assert tgs.shape == (N_STEPS, K)
    np.testing.assert_allclose(tgs.numpy(), np.asarray(jgs), atol=G_ATOL)
    np.testing.assert_allclose(float(tmet["g"]), float(jmet["g"]),
                               atol=G_ATOL)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=LOSS_RTOL)
    _close_params(tp2, jp2, atol=N_STEPS * PARAM_ATOL)


@pytest.mark.parametrize("backend", ["ref", "kernel"])
@pytest.mark.parametrize("masked", [False, True])
def test_train_loop_equals_folded_step(setup, backend, masked):
    s = setup
    step = TF.make_fl_train_step(_t_loss(s["tm"]), s["tspace"], eps=EPS,
                                 lr=LR, n_clients=K, backend=backend)
    loop = TF.make_fl_train_loop(_t_loss(s["tm"]), s["tspace"], eps=EPS,
                                 lr=LR, n_clients=K, n_steps=N_STEPS,
                                 backend=backend)
    tokens = torch.as_tensor(s["tokens"])
    masks = torch.as_tensor(s["masks"]) if masked else None
    key = prng.key(11)
    lp, lgs, lmet = loop(s["tp"], key, {"tokens": tokens}, masks)
    p, gs = s["tp"], []
    for i, k in enumerate(prng.split(key, N_STEPS)):
        p, g, met = step(p, k, {"tokens": tokens[i]},
                         None if masks is None else masks[i])
        gs.append(g)
    assert torch.equal(lgs, torch.stack(gs))
    assert torch.equal(lmet["loss"], met["loss"])
    assert _equal_trees(lp, p)


def test_report_mask_excludes_clients(setup):
    s = setup
    step = TF.make_fl_train_step(_t_loss(s["tm"]), s["tspace"], eps=EPS,
                                 lr=LR, n_clients=K, backend="kernel")
    batch = {"tokens": torch.as_tensor(s["tokens"][0])}
    _, g_all, met_all = step(s["tp"], prng.key(3), batch)
    _, _, met_ones = step(s["tp"], prng.key(3), batch, torch.ones(K))
    _, _, met_one = step(s["tp"], prng.key(3), batch,
                         torch.tensor([0.0, 1.0]))
    _, _, met_none = step(s["tp"], prng.key(3), batch, torch.zeros(K))
    assert torch.equal(met_all["g"], met_ones["g"])
    assert torch.equal(met_one["g"], g_all[1])
    assert float(met_none["g"]) == 0.0


@pytest.mark.parametrize("jbe,tbe", ROUTES)
def test_round_step_matches_jax(setup, jbe, tbe):
    s = setup
    T = 2
    jround = JF.make_fl_round_step(lambda p, b: s["jm"].loss(p, b),
                                   s["jspace"], eps=EPS, lr=LR, T=T,
                                   backend=jbe)
    tround = TF.make_fl_round_step(lambda p, b: s["tm"].loss(p, b),
                                   s["tspace"], eps=EPS, lr=LR, T=T,
                                   backend=tbe)
    tokens = s["tokens"][:T].reshape(T, K, B, S).transpose(1, 0, 2, 3)
    jp2, jgs = jround(s["jp"], jax.random.split(jax.random.key(9), T),
                      {"tokens": jnp.asarray(tokens)})
    tp2, tgs = tround(s["tp"], prng.split(prng.key(9), T),
                      {"tokens": torch.as_tensor(np.ascontiguousarray(
                          tokens))})
    assert tgs.shape == (K, T)
    np.testing.assert_allclose(tgs.numpy(), np.asarray(jgs), atol=G_ATOL)
    _close_params(tp2, jp2, atol=T * PARAM_ATOL)


def test_unported_options_raise(setup):
    """Nothing of the loop's options is left unported: the quantizer
    builds, and ``stack_forwards=True`` runs the stacked (w+, w-) forward
    (once raised here), equal to the sequential forwards' loop within the
    loss ulps the vmapped forward may move."""
    s = setup
    kw = dict(eps=EPS, lr=LR, n_clients=K)
    # the uplink quantizer is ported (core/quantize.py): it builds
    TF.make_fl_train_step(_t_loss(s["tm"]), s["tspace"],
                          quantize=QuantSpec(8), **kw)
    args = (s["tp"], prng.key(7), {"tokens": torch.as_tensor(
        s["tokens"][:2])})
    runs = [TF.make_fl_train_loop(_t_loss(s["tm"]), s["tspace"], n_steps=2,
                                  backend="kernel", stack_forwards=st,
                                  **kw)(*args)
            for st in (True, False)]
    (p1, g1, m1), (p0, g0, m0) = runs
    np.testing.assert_allclose(g1.numpy(), g0.numpy(), atol=G_ATOL)
    np.testing.assert_allclose(float(m1["loss"]), float(m0["loss"]),
                               rtol=LOSS_RTOL)
    for a, b in zip(tree_leaves(p1), tree_leaves(p0)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=2 * PARAM_ATOL)
