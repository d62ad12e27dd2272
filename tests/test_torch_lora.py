"""LoRA-FedZO and random early stopping, the port against repro on the CPU:
the LoRA adapters in the forward (TINY_LORA, adapters non-zero), the
``LoRASpace`` layout and its flat backing, a LoRA-FedZO run of
``FederatedZO`` against the JAX server's, ``early_stop_random``'s flags,
and ``launch.train --method lora``.  Parameters cross through
``convert.params_from_numpy``; inputs come from numpy seeds."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core as JC
import repro_torch.core as TC
from repro.configs.base import FLConfig as JFL
from repro.configs.tiny import TINY_LORA as J_TINY_LORA
from repro.core.dispatch import get_backing as j_get_backing
from repro.data.synthetic import make_task_fns as j_task_fns
from repro.models import Model as JModel
from repro_torch.configs import TINY, TINY_LORA
from repro_torch.configs.base import FLConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.dispatch import get_backing
from repro_torch.data import (TaskSpec, dirichlet_partition, make_task_fns,
                              sample_dataset, subset)
from repro_torch.models import Model
from repro_torch.utils.tree import tree_flatten_with_keys, tree_leaves

# logits of a 2-layer model in f32 on two stacks of CPU kernels (XLA vs
# ATen), as tests/test_torch_model.py
ATOL = 1e-4
# Table 1's LoRA rate (benchmarks/table1_noniid.py)
LR = 2e-2


def _jax_params(seed=3, adapters=False):
    """TINY_LORA parameters from JAX's init; with ``adapters`` the B factors
    (zero at init) get numpy normals, so the adapters act on q and v."""
    jp = JModel(J_TINY_LORA).init(jax.random.key(seed))
    npp = jax.tree.map(np.asarray, jp)
    if adapters:
        rng = np.random.default_rng(seed)
        for name in ("lora_qb", "lora_vb"):
            leaf = npp["stack"]["p0"][name]
            npp["stack"]["p0"][name] = (
                0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)
    return npp


def test_lora_forward_and_loss_match_jax():
    """The adapter term s * ((x qa) qb) on q and v, with non-zero B
    factors: logits and LM loss within ATOL of JAX's."""
    npp = _jax_params(adapters=True)
    jm = JModel(J_TINY_LORA)
    jp = jax.tree.map(jax.numpy.asarray, npp)
    tm = Model(TINY_LORA, device="cpu")
    tp = params_from_numpy(npp, device="cpu")
    batch = {"tokens": np.random.default_rng(0).integers(
        0, TINY.vocab, (2, 24)).astype(np.int32)}
    jl, _ = jm.forward(jp, batch)
    tl, _ = tm.forward(tp, batch)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert float(tm.loss(tp, batch)) == pytest.approx(
        float(jm.loss(jp, batch)), abs=ATOL)
    # the adapters matter: without them the logits move by far more
    base = {k: v for k, v in npp["stack"]["p0"].items()
            if not k.startswith("lora_")}
    tb = params_from_numpy(dict(npp, stack={"p0": base}), device="cpu")
    assert float((Model(TINY, device="cpu").forward(tb, batch)[0]
                  - tl).abs().max()) > 100 * ATOL


def test_fresh_adapters_leave_the_loss_bit_equal():
    """lora_qb and lora_vb start at zero, so the adapter term is an exact
    zero: the LoRA model's loss equals the base model's bit for bit."""
    tm = Model(TINY_LORA, device="cpu")
    tp = tm.init(seed=1)
    base = {k: v for k, v in tp["stack"]["p0"].items()
            if not k.startswith("lora_")}
    tb = dict(tp, stack={"p0": base})
    batch = {"tokens": np.random.default_rng(1).integers(
        0, TINY.vocab, (2, 16)).astype(np.int32)}
    a = tm.loss(tp, batch)
    b = Model(TINY, device="cpu").loss(tb, batch)
    assert torch.equal(a, b)


def test_lora_init_paths_and_shapes_match_jax():
    tp = Model(TINY_LORA, device="cpu").init(seed=0)
    jp = JModel(J_TINY_LORA).abstract_params()
    jpaths = [(jax.tree_util.keystr(p), tuple(l.shape))
              for p, l in jax.tree_util.tree_flatten_with_path(jp)[0]]
    tpaths = [(p, tuple(l.shape)) for p, l in tree_flatten_with_keys(tp)[0]]
    assert tpaths == jpaths
    assert not tp["stack"]["p0"]["lora_qb"].any()
    assert not tp["stack"]["p0"]["lora_vb"].any()


def test_lora_space_layout_matches_jax():
    """LoRASpace's n and offsets, and its flat backing's global index,
    equal JAX's ``get_backing`` layout (the adapters of a layer sort before
    its norm, wk, wo, wq, wv)."""
    npp = _jax_params()
    jp = jax.tree.map(jax.numpy.asarray, npp)
    tp = params_from_numpy(npp, device="cpu")
    js, ts = JC.LoRASpace(jp), TC.LoRASpace(tp)
    assert ts.n == js.n == 2 * 2 * (64 * 4) + 2 * (4 * 64 + 4 * 32)
    assert list(ts.offsets) == [int(o) for o in js.offsets]
    assert ts.identity_layout() is False
    jb, tb = j_get_backing(js, jp), get_backing(ts, tp)
    assert (tb.n_flat, tb.n_pad) == (jb.n_flat, jb.n_pad)
    assert not tb.identity
    np.testing.assert_array_equal(tb.global_index.numpy(),
                                  np.asarray(jb.global_index))
    # slice and add touch the adapters only
    v = torch.arange(ts.n, dtype=torch.float32)
    moved = ts.add(tp, v)
    for (path, a), b in zip(tree_flatten_with_keys(moved)[0],
                            tree_leaves(tp)):
        assert ("lora_" in path) != (a is b)
    np.testing.assert_array_equal(ts.slice(moved).numpy(),
                                  ts.slice(tp).numpy() + v.numpy())
    with pytest.raises(ValueError, match="lora"):
        TC.LoRASpace(Model(TINY, device="cpu").init(seed=0))


def _servers(n_clients=4, T=2, seed=0):
    spec = TaskSpec(seq_len=16)
    npp = _jax_params(seed=seed)
    jm, tm = JModel(J_TINY_LORA), Model(TINY_LORA, device="cpu")
    jp = jax.tree.map(jax.numpy.asarray, npp)
    tp = params_from_numpy(npp, device="cpu")
    train = sample_dataset(spec, 256, seed=1)
    parts = dirichlet_partition(train["label"], n_clients=n_clients,
                                alpha=0.5)
    kw = dict(n_clients=n_clients, local_steps=T, lr=LR, eps=1e-3,
              mask_kind="lora", seed=seed)
    jloss, _, _ = j_task_fns(jm, spec)
    tloss, _, _ = make_task_fns(tm, spec)
    jsrv = JC.FederatedZO(jloss, jp, JC.LoRASpace(jp), JFL(zo_backend="ref",
                                                           **kw),
                          [JC.Client(k, subset(train, p), 16)
                           for k, p in enumerate(parts)])
    tsrv = TC.FederatedZO(tloss, tp, TC.LoRASpace(tp),
                          FLConfig(zo_backend="kernel", **kw),
                          [TC.Client(k, subset(train, p), 16)
                           for k, p in enumerate(parts)], device="cpu")
    return jsrv, tsrv, tp


def test_lora_fedzo_rounds_match_jax():
    """Two T=2 rounds of four Dirichlet clients on TINY_LORA, the mask-free
    set-up of benchmarks/common.py: the JAX server on its tree route, the
    port's on the flat kernel route (the plain versions on the CPU).  The
    scalars agree to the forwards' ulp times 1/(2 eps) (as
    tests/test_torch_slice.py), the parameters within 1e-5, every base
    weight bit-equal to its start, and the byte counts equal."""
    jsrv, tsrv, tp = _servers()
    start = {p: t.clone() for p, t in tree_flatten_with_keys(tp)[0]}
    for _ in range(2):
        jg = jsrv.run_round()
        tg = tsrv.run_round()
        assert sorted(tg) == sorted(jg)
        for c in jg:
            np.testing.assert_allclose(tg[c], np.asarray(jg[c]), atol=5e-4,
                                       rtol=0)
    moved = set()
    for (path, a), b in zip(tree_flatten_with_keys(tsrv.params)[0],
                            jax.tree_util.tree_leaves(jsrv.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0, err_msg=path)
        if not torch.equal(a, start[path]):
            moved.add(path)
    assert moved == {p for p in start if "lora_" in p}
    # T=2 is not high-frequency: the downlink is the adapters' refresh
    assert tsrv.comm.down_bytes == jsrv.comm.down_bytes == \
        2 * 4 * 4 * tsrv.space.n
    assert tsrv.comm.up_bytes == jsrv.comm.up_bytes == 2 * 4 * 2 * 4


@pytest.mark.parametrize("seed", [0, 7])
def test_early_stop_random_flags_match_jax(seed):
    """The random-selection baseline draws the JAX package's clients for
    every n, and a flagged client takes one local step, the others T."""
    jsrv, tsrv, _ = _servers(n_clients=4)
    for n in (1, 2, 3):
        jsrv.early_stop_random(n, seed=seed)
        tsrv.early_stop_random(n, seed=seed)
        assert tsrv.early_stopped == jsrv.early_stopped
        assert len(tsrv.early_stopped) == n
    if seed == 7:
        tsrv.early_stop_random(2, seed=seed)
        gs = tsrv.run_round()
        assert {c: len(g) for c, g in gs.items()} == {
            c: 1 if c in tsrv.early_stopped else 2 for c in range(4)}
        assert tsrv.comm.up_bytes == 4 * (2 * 1 + 2 * 2)


def test_train_cli_lora_moves_only_the_adapters(monkeypatch):
    """``train.main --method lora`` builds LoRASpace (rank 4, as the config
    has none) and runs: after its rounds only ``lora_*`` leaves moved."""
    from repro_torch.launch import train
    seen = {}

    class Spy(TC.FederatedZO):
        def __init__(self, loss_fn, params, space, *a, **kw):
            seen["p0"] = {p: t.clone() for p, t in
                          tree_flatten_with_keys(params)[0]}
            seen["space"] = space
            super().__init__(loss_fn, params, space, *a, **kw)
            seen["server"] = self

    monkeypatch.setattr(train, "FederatedZO", Spy)
    train.main(["--device", "cpu", "--method", "lora", "--rounds", "2",
                "--T", "2", "--clients", "4", "--eval-every", "0"])
    assert isinstance(seen["space"], TC.LoRASpace)
    srv = seen["server"]
    assert srv.round == 2
    moved = {p for p, t in tree_flatten_with_keys(srv.params)[0]
             if not torch.equal(t, seen["p0"][p])}
    assert moved and all("lora_" in p for p in moved)
    assert seen["p0"]["['stack']['p0']['lora_qa']"].shape[-1] == 4
