"""The whole slice on TINY, the port against repro: sensitivity mask,
pre-training gradient, VP calibration and three rounds of four Dirichlet
clients, with T in {1, 2}, on the kernel routes of both packages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core as JC
import repro_torch.core as TC
from repro.configs.base import FLConfig as JFL
from repro.configs.tiny import TINY as J_TINY
from repro.data.synthetic import make_task_fns as j_task_fns
from repro.models import Model as JModel
from repro_torch.configs.base import FLConfig
from repro_torch.configs.tiny import TINY
from repro_torch.convert import params_from_numpy, space_from_numpy
from repro_torch.data import (TaskSpec, dirichlet_partition, make_task_fns,
                              pretrain_batches, sample_dataset, subset)
from repro_torch.models import Model
from repro_torch.utils.tree import tree_leaves

# Tolerances.  The two packages' forwards agree to about one f32 ulp of the
# loss (~2.4e-7 at loss ~2); g = (l+ - l-) / (2 eps) with eps = 1e-3 scales
# that by 500, so a per-step scalar may move by a few 1e-4 (1.2e-4 seen).
G_ATOL = 5e-4
# parameters move by lr * g * z per step: ~5e-2 * 1e-4 * |z| (1.8e-5 seen)
PARAM_ATOL = 1e-4
# GradIP = g * <gp, z>: the scalar's error times |<gp, z>| (4.4e-5 seen)
GRADIP_ATOL = 2e-4
ROUNDS = 3


def _flat(tree_leaves_):
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in tree_leaves_])


@pytest.fixture(scope="module")
def setup():
    spec = TaskSpec(seq_len=16)
    jm = JModel(J_TINY)
    jp = jm.init(jax.random.key(0))
    tm = Model(TINY, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    pre = pretrain_batches(spec, n_batches=4, batch_size=16)
    jspace = JC.sensitivity_mask(lambda p, b: jm.loss(p, b), jp, pre,
                                 density=1e-2)
    tspace = TC.sensitivity_mask(lambda p, b: tm.loss(p, b), tp, pre,
                                 density=1e-2, device="cpu")
    train = sample_dataset(spec, 512, seed=1)
    parts = dirichlet_partition(train["label"], n_clients=4, alpha=0.5)
    return dict(spec=spec, jm=jm, jp=jp, tm=tm, tp=tp, pre=pre,
                jspace=jspace, tspace=tspace, train=train, parts=parts)


def _global_idx(idx_leaves, param_leaves):
    off = np.cumsum([0] + [int(np.prod(p.shape)) for p in param_leaves])
    return np.concatenate([np.asarray(i, np.int64) + o
                           for i, o in zip(idx_leaves, off[:-1])])


def test_sensitivity_mask_overlaps_jax(setup):
    j = _global_idx(jax.tree_util.tree_leaves(setup["jspace"].idx_tree),
                    jax.tree_util.tree_leaves(setup["jp"]))
    t = _global_idx([x.numpy() for x in tree_leaves(setup["tspace"].idx_tree)],
                    tree_leaves(setup["tp"]))
    assert setup["tspace"].n == setup["jspace"].n
    assert len(np.intersect1d(j, t)) / len(j) >= 0.999


@pytest.mark.parametrize("T", [1, 2])
def test_rounds_match_jax(setup, T):
    s = setup
    kw = dict(n_clients=4, local_steps=T, lr=5e-2, eps=1e-3, density=1e-2,
              vp_init_steps=2, vp_later_steps=2, vp_sigma_relative=True)
    jfl = JFL(zo_backend="pallas", **kw)
    tfl = FLConfig(zo_backend="kernel", **kw)
    # the port runs on JAX's mask, so both packages walk the same coords
    tspace = space_from_numpy(jax.tree.map(np.asarray, s["jspace"].idx_tree),
                              device="cpu")
    jloss, _, jeval = j_task_fns(s["jm"], s["spec"])
    tloss, _, teval = make_task_fns(s["tm"], s["spec"])
    jsrv = JC.FederatedZO(jloss, s["jp"], s["jspace"], jfl,
                          [JC.Client(k, subset(s["train"], p), 16)
                           for k, p in enumerate(s["parts"])], eval_fn=jeval)
    tsrv = TC.FederatedZO(tloss, s["tp"], tspace, tfl,
                          [TC.Client(k, subset(s["train"], p), 16)
                           for k, p in enumerate(s["parts"])], eval_fn=teval,
                          device="cpu")
    pre = s["pre"][:2]
    jgp = JC.pretrain_gradient_vec(lambda p, b: s["jm"].loss(p, b), s["jp"],
                                   s["jspace"], pre)
    tgp = TC.pretrain_gradient_vec(lambda p, b: s["tm"].loss(p, b), s["tp"],
                                   tspace, pre)
    np.testing.assert_allclose(tgp.numpy(), np.asarray(jgp), atol=1e-6)

    jres, jflag, jtraj = jsrv.calibrate_vp(jgp, T_cali=4)
    tres, tflag, ttraj = tsrv.calibrate_vp(tgp, T_cali=4)
    assert tflag == jflag
    for a, b in zip(jtraj, ttraj):
        np.testing.assert_allclose(b, a, atol=GRADIP_ATOL, rtol=1e-3)
    for _ in range(ROUNDS):
        jg = jsrv.run_round(gp_vec=jgp)
        tg = tsrv.run_round(gp_vec=tgp)
        assert sorted(tg) == sorted(jg)
        for c in jg:
            assert tg[c].shape == np.asarray(jg[c]).shape
            np.testing.assert_allclose(tg[c], np.asarray(jg[c]), atol=G_ATOL,
                                       rtol=0)
    np.testing.assert_allclose(
        _flat(tree_leaves(tsrv.params)),
        _flat(jax.tree_util.tree_leaves(jsrv.params)), atol=PARAM_ATOL,
        rtol=0)
    for c in jsrv.gradip_log:
        for a, b in zip(jsrv.gradip_log[c], tsrv.gradip_log[c]):
            np.testing.assert_allclose(b, np.asarray(a), atol=GRADIP_ATOL,
                                       rtol=1e-3)
    assert tsrv.comm.up_bytes == jsrv.comm.up_bytes
    assert tsrv.comm.down_bytes == jsrv.comm.down_bytes


@pytest.mark.parametrize("T", [1, 2])
def test_client_delta_matches_server_replay(setup, T):
    """The port's own client trajectory (flat kernel route: -lr*g applied
    through the fused update) against the server's reconstruct_delta of its
    scalars (lr * (g * z) on the sparse vector): two rounding orders of the
    same product, so rtol 1e-6 (and, where T > 1 steps cancel, 1e-6 of
    the largest entry) rather than bit-equality."""
    s = setup
    tloss, _, _ = make_task_fns(s["tm"], s["spec"])
    space = s["tspace"]
    run = TC.make_local_run(tloss, space, eps=1e-3, lr=5e-2, backend="kernel")
    keys = TC.round_keys(0, 2, T)
    data = subset(s["train"], s["parts"][0])
    batches = {k: torch.as_tensor(v[:T * 16].reshape(T, 16, *v.shape[1:]))
               for k, v in data.items()}
    delta, gs = run(s["tp"], keys, batches, torch.zeros(space.n))
    rec = TC.reconstruct_delta(space, keys, gs.numpy(), 5e-2)
    np.testing.assert_allclose(delta.numpy(), rec.numpy(), rtol=1e-6,
                               atol=1e-6 * float(delta.abs().max()))
