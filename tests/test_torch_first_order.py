"""The first-order baseline of the port (``repro_torch.optim``,
``repro_torch.train``) against the JAX package's on TINY: optimizer steps
through ``make_train_step``, one ``fedavg_round``, the learning-rate
schedules and ``zo_sgd``, all fed the same numpy inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs.tiny import TINY as J_TINY
from repro.models import Model as JModel
from repro.optim import constant as j_constant
from repro.optim import cosine as j_cosine
from repro.optim import warmup_cosine as j_warmup_cosine
from repro.optim import zo_sgd as j_zo_sgd
from repro.train import fedavg_round as j_fedavg_round
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs.tiny import TINY
from repro_torch.convert import params_from_numpy
from repro_torch.models import Model
from repro_torch.optim import constant, cosine, warmup_cosine, zo_sgd
from repro_torch.train import fedavg_round, make_train_step
from repro_torch.utils.tree import tree_leaves

S = 16
# Tolerances.  The two packages' TINY losses agree to ~1 f32 ulp and their
# gradients to ~1e-6 of the largest entry (two CPU stacks of f32 kernels).
LOSS_ATOL = 1e-5
# SGD moves a parameter by lr * g: the gradient's error times lr (and the
# momentum's sum of three), far below 1e-6.
SGD_ATOL = 1e-6
# Adam's step is lr * m / (sqrt(v) + eps), about lr in size.  Where |g| is
# near eps = 1e-8 the step is lr * g / (|g| + eps), as sensitive as
# lr / eps = 1e5 to g, so a 1e-10 difference in such a gradient moves it by
# 1e-5 (2 of 32768 coordinates of one leaf seen at 1.2e-5 after 3 steps).
# Hence two bounds: every coordinate within 5% of lr = 1e-3, and all but a
# thousandth of them within SGD_ATOL.
ADAM_ATOL = 5e-5
ADAM_SHARE_BEYOND_SGD_ATOL = 1e-3
# schedules: one f32 cos on each side
SCHED_RTOL = 1e-6


@pytest.fixture(scope="module")
def pair():
    jm = JModel(J_TINY)
    jp = jm.init(jax.random.key(0))
    tm = Model(TINY, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, J_TINY.vocab, (3, 4, S)).astype(np.int32)
    return jm, jp, tm, tp, toks


def _assert_params_close(tp, jp, atol):
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol,
                                   rtol=0)


@pytest.mark.parametrize("optimizer,kw,atol", [
    ("sgd", {}, SGD_ATOL),
    ("sgd", {"momentum": 0.9}, SGD_ATOL),
    ("adam", {}, ADAM_ATOL)])
def test_train_step_matches_jax(pair, optimizer, kw, atol):
    jm, jp, tm, tp, toks = pair
    jinit, jstep = j_make_train_step(lambda p, b: jm.loss(p, b), optimizer,
                                     1e-3, **kw)
    tinit, tstep = make_train_step(lambda p, b: tm.loss(p, b), optimizer,
                                   1e-3, device="cpu", **kw)
    js, ts = jinit(jp), tinit(tp)
    for t in range(3):
        batch = {"tokens": toks[t]}
        jp, js, jl = jstep(jp, js, {"tokens": jnp.asarray(toks[t])})
        tp, ts, tl = tstep(tp, ts, batch)
        assert float(tl) == pytest.approx(float(jl), abs=LOSS_ATOL)
    assert int(ts.step) == int(js.step) == 3
    _assert_params_close(tp, jp, atol)
    if optimizer == "adam":
        diff = np.concatenate([
            np.abs(a.numpy() - np.asarray(b)).ravel() for a, b in zip(
                tree_leaves(tp), jax.tree_util.tree_leaves(jp))])
        assert np.mean(diff > SGD_ATOL) <= ADAM_SHARE_BEYOND_SGD_ATOL
    if ts.mu is not None:
        _assert_params_close(ts.mu, js.mu, 1e-5)


def test_fedavg_round_matches_jax(pair):
    """K=3 clients x T=2 local SGD steps, then the average: the JAX package
    vmaps the clients and takes one mean, the port sums them in order."""
    jm, jp, tm, tp, _ = pair
    rng = np.random.default_rng(9)
    toks = rng.integers(0, J_TINY.vocab, (3, 2, 4, S)).astype(np.int32)
    jnew = j_fedavg_round(lambda p, b: jm.loss(p, b), jp,
                          {"tokens": jnp.asarray(toks)}, 1e-2)
    tnew = fedavg_round(lambda p, b: tm.loss(p, b), tp, {"tokens": toks},
                        1e-2, local_steps=2, device="cpu")
    _assert_params_close(tnew, jnew, SGD_ATOL)
    assert any(float((a - b).abs().max()) > 0
               for a, b in zip(tree_leaves(tnew), tree_leaves(tp)))
    with pytest.raises(ValueError, match="local_steps"):
        fedavg_round(lambda p, b: tm.loss(p, b), tp, {"tokens": toks}, 1e-2,
                     local_steps=1, device="cpu")


@pytest.mark.parametrize("name", ["constant", "cosine", "warmup_cosine"])
def test_schedules_match_jax(name):
    jf, tf = {"constant": (j_constant(3e-4), constant(3e-4)),
              "cosine": (j_cosine(3e-4, 40), cosine(3e-4, 40)),
              "warmup_cosine": (j_warmup_cosine(3e-4, 5, 40),
                                warmup_cosine(3e-4, 5, 40))}[name]
    for step in range(0, 46):
        got = tf(step)
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(jf(step)), rel=SCHED_RTOL,
                                           abs=1e-12)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_zo_sgd_matches_jax(momentum):
    rng = np.random.default_rng(int(momentum * 10))
    gzs = rng.standard_normal((3, 257)).astype(np.float32)
    jinit, jupd = j_zo_sgd(1e-2, momentum)
    tinit, tupd = zo_sgd(1e-2, momentum)
    js, ts = jinit(257), tinit(257, device="cpu")
    for gz in gzs:
        ju, js = jupd(jnp.asarray(gz), js)
        tu, ts = tupd(torch.tensor(gz), ts)
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    assert int(ts.step) == 3
