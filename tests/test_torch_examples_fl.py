"""The federated examples on the port against their JAX examples, in CI's
smoke sizes and on the same seeds: ``examples/quickstart_torch.py``
(``--rounds 8``) and ``examples/train_e2e_torch.py``, each fed the JAX
example's initial weights on the CPU."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core as JC
import repro.data.synthetic as JS
import torch_examples as X
from repro_torch.checkpoint.io import load_pytree
from repro_torch.utils.tree import tree_leaves


@pytest.fixture(autouse=True)
def two_threads():
    # more only contend under the driver's parallel workers
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_quickstart_matches_jax(monkeypatch):
    """Mask, T=1 rounds and evaluations: the same mask, the final
    parameters at the slice's tolerance, every accuracy within one
    example's answer, 4 bytes a client a step uploaded."""
    rounds = 8
    g = X.run_jax(monkeypatch, "quickstart", ["--rounds", str(rounds)])
    out = X.run_port("quickstart", ["--rounds", str(rounds)],
                     params=jax.tree.map(np.asarray, g["params"]))
    jsrv = g["server"]
    assert out["mask_n"] == g["space"].n
    assert X.mask_overlap(g["space"], g["params"], out["space"],
                          out["params"]) >= X.MASK_OVERLAP_MIN
    np.testing.assert_allclose(
        X.flat(tree_leaves(out["params"])),
        X.flat(jax.tree_util.tree_leaves(jsrv.params)), atol=X.PARAM_ATOL,
        rtol=0)
    assert abs(out["acc_before"] - float(g["m0"]["acc"])) <= X.ACC_ATOL
    assert abs(out["acc_after"] - float(g["m"]["acc"])) <= X.ACC_ATOL
    assert [h["round"] for h in out["history"]] == \
        [h["round"] for h in jsrv.history]
    for a, b in zip(out["history"], jsrv.history):
        assert abs(a["acc"] - b["acc"]) <= X.ACC_ATOL
    assert out["up_bytes"] == jsrv.comm.up_bytes == 4 * 8 * rounds


def test_train_e2e_matches_jax(monkeypatch, tmp_path):
    """Mask and VP calibration, T=2 rounds, the checkpoint and the final
    evaluation from it: the same flags and accuracies, the final parameters
    at the slice's tolerance, the port's checkpoint read back bit-equal.
    Two clients (one Dirichlet, one single-label) of batch 4, one round:
    the VP calibration's 100 steps a client are the cost, whatever the
    rounds."""
    argv = ["--rounds", "1", "--T", "2", "--clients", "2", "--batch", "4"]
    made = {}

    class Recorded(JC.FederatedZO):
        def __init__(self, loss, params, *a, **kw):
            made["params"], made["server"] = params, self
            super().__init__(loss, params, *a, **kw)

    accs = []
    make_task_fns = JS.make_task_fns

    def task_fns(*a, **kw):
        loss, per_example, evaluate = make_task_fns(*a, **kw)

        def recorded(p, b):
            m = evaluate(p, b)
            accs.append(float(m["acc"]))
            return m
        return loss, per_example, recorded

    monkeypatch.setattr(JC, "FederatedZO", Recorded)
    monkeypatch.setattr(JS, "make_task_fns", task_fns)
    X.run_jax(monkeypatch, "train_e2e",
              argv + ["--ckpt", str(tmp_path / "jax.msgpack")])
    ckpt = str(tmp_path / "torch.msgpack")
    out = X.run_port("train_e2e", argv + ["--ckpt", ckpt],
                     params=jax.tree.map(np.asarray, made["params"]))
    jsrv = made["server"]
    assert out["flagged"] == sorted(jsrv.early_stopped)
    # before, the round's evaluation, the final one from the checkpoint
    got = [out["acc_before"]] + [h["acc"] for h in out["history"]] + \
        [out["acc_final"]]
    assert len(got) == len(accs)
    np.testing.assert_allclose(got, accs, atol=X.ACC_ATOL, rtol=0)
    np.testing.assert_allclose(
        X.flat(tree_leaves(out["params"])),
        X.flat(jax.tree_util.tree_leaves(jsrv.params)), atol=X.PARAM_ATOL,
        rtol=0)
    assert os.path.exists(ckpt)
    back = load_pytree(ckpt, out["params"])
    for a, b in zip(tree_leaves(back), tree_leaves(out["params"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert out["up_bytes"] == jsrv.comm.up_bytes
    assert out["down_bytes"] == jsrv.comm.down_bytes
