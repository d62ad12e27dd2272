"""The hybrid family (Jamba: attention, Mamba and MoE layers) in torch
against repro: the parameter tree, the forward, its MoE loss and the LM
loss on both Mamba routes, the MEERKAT-VP slice on a two-layer hybrid
cut, and the size of the configuration the card trains."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core as JC
import repro_torch.core as TC
from repro.configs import get_config as j_get_config
from repro.configs.base import FLConfig as JFL
from repro.data.synthetic import make_task_fns as j_task_fns
from repro.models import Model as JModel
from repro.models.init import param_count as j_param_count
from repro.models.transformer import ShardCtx
from repro_torch.configs import FLConfig, get_config
from repro_torch.configs.jamba_1_5_large_398b import SLICE_CUT
from repro_torch.convert import params_from_numpy, space_from_numpy
from repro_torch.data import (TaskSpec, dirichlet_partition, make_task_fns,
                              pretrain_batches, sample_dataset, subset)
from repro_torch.models import Model, ModelCtx, param_count
from repro_torch.utils.tree import tree_leaves

CFG = "jamba-1.5-large-398b"
# logits of one reduced period (8 layers) in f32 on two stacks of CPU
# kernels, of the largest logit: the scan's and the projections' sums in
# other orders (6.9e-7 seen)
LOGIT_REL = 1e-5
# the slice, as tests/test_torch_slice.py: per-step scalars are loss
# differences over 2 eps = 2e-3, so a loss's f32 ulps grow 500-fold
G_ATOL = 5e-4
PARAM_ATOL = 1e-4
GRADIP_ATOL = 2e-4


def _period(get):
    """One period of reduced Jamba: attention + 7 Mamba layers, MoE on
    every other, d 256, 4 experts."""
    return get(CFG).reduced().replace(n_layers=8)


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _period(j_get_config), _period(get_config)
    jp = JModel(jcfg).init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 40)
                                             ).astype(np.int32)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, batch={"tokens": toks})


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                        f"{prefix}/{k}")]
    return [prefix]


def test_reduced_config_matches_jax():
    j, t = j_get_config(CFG).reduced(), get_config(CFG + "-reduced")
    assert (t.n_layers, t.d_model, t.ssm.d_state, t.moe.n_experts) == \
        (16, 256, 8, 4)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab", "rope_style", "norm_eps", "layer_pattern"):
        assert getattr(t, f) == getattr(j, f), f
    assert vars(t.ssm) == vars(j.ssm) and vars(t.moe) == vars(j.moe)


def test_init_leaves_match_jax(pair):
    """Names, shapes and order of the port's own init equal JAX's, so
    FlatBacking offsets agree; the deterministic leaves equal JAX's."""
    tinit = Model(pair["tcfg"], device="cpu").init(seed=0)
    assert _paths(tinit) == _paths(pair["jp"])
    assert [tuple(t.shape) for t in tree_leaves(tinit)] == \
        [tuple(a.shape) for a in jax.tree_util.tree_leaves(pair["jp"])]
    for k in ("A_log", "D", "conv_b", "dt_bias"):
        np.testing.assert_allclose(tinit["stack"]["p1"][k].numpy(),
                                   np.asarray(pair["jp"]["stack"]["p1"][k]),
                                   rtol=1e-6)
    assert param_count(pair["tcfg"]) == j_param_count(pair["jcfg"])


def test_card_cut_param_count():
    assert SLICE_CUT.layer_pattern == (("attn", "dense"),) + \
        (("mamba", "dense"),) * 3 and SLICE_CUT.moe is None
    j = j_get_config(CFG).replace(n_layers=4,
                                  layer_pattern=SLICE_CUT.layer_pattern,
                                  moe=None)
    assert param_count(SLICE_CUT) == j_param_count(j) == 4_901_724_160


@pytest.mark.parametrize("mode", ["kernel", "scan"])
def test_forward_aux_and_loss_match_jax(pair, mode):
    jm = JModel(pair["jcfg"], ShardCtx(mamba_mode=mode))
    tm = Model(pair["tcfg"], ModelCtx(mamba_mode=mode), device="cpu")
    jl, jaux = jm.forward(pair["jp"], pair["batch"])
    with torch.no_grad():
        tl, taux = tm.forward(pair["tp"], pair["batch"])
        tloss = float(tm.loss(pair["tp"], pair["batch"]))
        tper = tm.loss(pair["tp"], pair["batch"], per_example=True)
    jl = np.asarray(jl)
    assert np.abs(tl.numpy() - jl).max() <= LOGIT_REL * np.abs(jl).max()
    assert float(jaux) > 0 and float(taux) == pytest.approx(float(jaux),
                                                            rel=1e-6)
    assert tloss == pytest.approx(float(jm.loss(pair["jp"], pair["batch"])),
                                  rel=1e-6)
    # the per-client losses of core/fl_step: [B], the aux term in each
    jper = np.asarray(jm.loss(pair["jp"], pair["batch"], per_example=True))
    assert tper.shape == (2,)
    np.testing.assert_allclose(tper.numpy(), jper, rtol=1e-6)


def test_slice_matches_jax():
    """MEERKAT-VP on a two-layer hybrid cut of reduced Jamba (attention +
    dense FFN, Mamba + MoE; the JAX package compiles a whole period's
    gradient and ZO step for ~50 s): the sensitivity mask, the pre-training
    gradient (autograd: the port's and JAX's scan routes), VP calibration
    and one round of four Dirichlet clients on the tree route, as at full
    size on the card (ZO forwards: the port's kernel route)."""
    cut = dict(n_layers=2, layer_pattern=(("attn", "dense"),
                                          ("mamba", "moe")))
    jcfg = j_get_config(CFG).reduced().replace(**cut)
    spec = TaskSpec(seq_len=16)
    jm = JModel(jcfg)
    tm = Model(get_config(CFG + "-reduced").replace(**cut), device="cpu")
    jp = jm.init(jax.random.key(2))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    pre = pretrain_batches(spec, n_batches=2, batch_size=8)
    jspace = JC.sensitivity_mask(lambda p, b: jm.loss(p, b), jp, pre,
                                 density=1e-2)
    tspace = TC.sensitivity_mask(lambda p, b: tm.loss(p, b), tp, pre,
                                 density=1e-2, device="cpu")
    off = np.cumsum([0] + [a.size for a in jax.tree_util.tree_leaves(jp)])
    jidx = np.concatenate([np.asarray(i) + o for i, o in zip(
        jax.tree_util.tree_leaves(jspace.idx_tree), off)])
    tidx = np.concatenate([i.numpy() + o for i, o in zip(
        tree_leaves(tspace.idx_tree), off)])
    assert tspace.n == jspace.n
    assert len(np.intersect1d(jidx, tidx)) / len(jidx) >= 0.999

    kw = dict(n_clients=4, local_steps=1, lr=5e-2, eps=1e-3, density=1e-2,
              vp_init_steps=1, vp_later_steps=1, vp_sigma_relative=True)
    space = space_from_numpy(jax.tree.map(np.asarray, jspace.idx_tree),
                             device="cpu")
    train = sample_dataset(spec, 256, seed=1)
    parts = dirichlet_partition(train["label"], n_clients=4, alpha=0.5)
    jloss, _, jeval = j_task_fns(jm, spec)
    tloss, _, teval = make_task_fns(tm, spec)
    jsrv = JC.FederatedZO(jloss, jp, jspace, JFL(zo_backend="ref", **kw),
                          [JC.Client(k, subset(train, p), 8)
                           for k, p in enumerate(parts)], eval_fn=jeval)
    tsrv = TC.FederatedZO(tloss, tp, space, FLConfig(zo_backend="ref", **kw),
                          [TC.Client(k, subset(train, p), 8)
                           for k, p in enumerate(parts)], eval_fn=teval,
                          device="cpu")
    jgp = JC.pretrain_gradient_vec(lambda p, b: jm.loss(p, b), jp, jspace,
                                   pre)
    tgp = TC.pretrain_gradient_vec(lambda p, b: tm.loss(p, b), tp, space,
                                   pre)
    np.testing.assert_allclose(tgp.numpy(), np.asarray(jgp), atol=1e-6,
                               rtol=1e-4)
    _, jflag, jtraj = jsrv.calibrate_vp(jgp, T_cali=2)
    _, tflag, ttraj = tsrv.calibrate_vp(tgp, T_cali=2)
    assert tflag == jflag
    for a, b in zip(jtraj, ttraj):
        np.testing.assert_allclose(b, a, atol=GRADIP_ATOL, rtol=1e-3)
    jg, tg = jsrv.run_round(gp_vec=jgp), tsrv.run_round(gp_vec=tgp)
    assert sorted(tg) == sorted(jg)
    for c in jg:
        np.testing.assert_allclose(tg[c], np.asarray(jg[c]), atol=G_ATOL,
                                   rtol=0)
    flat = lambda leaves: np.concatenate(
        [np.asarray(x, np.float32).ravel() for x in leaves])
    np.testing.assert_allclose(flat(tree_leaves(tsrv.params)),
                               flat(jax.tree_util.tree_leaves(jsrv.params)),
                               atol=PARAM_ATOL, rtol=0)
    assert tsrv.comm.up_bytes == jsrv.comm.up_bytes


def test_global_topk_past_one_chunk(monkeypatch):
    """The card's mask ranks 4.9 B scores, past what one torch.topk takes on
    CUDA: the chunked top-k picks the same coordinates as one top-k."""
    from repro_torch.core import masks
    g = torch.Generator().manual_seed(0)
    scores = {"a": torch.rand(3, 700, generator=g),
              "b": torch.rand(1111, generator=g)}
    want = masks._global_topk_indices(scores, 0.05)
    monkeypatch.setattr(masks, "TOPK_CHUNK", 256)
    got = masks._global_topk_indices(scores, 0.05)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)
