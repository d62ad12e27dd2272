"""The VP, serving and mesh examples on the port against the JAX package,
in CI's smoke sizes and on the same seeds: ``examples/vpcs_demo_torch.py``
(``--steps 60``), ``examples/serve_batch_torch.py`` (``--archs
pixtral-12b --requests 3``) and ``examples/mesh_round_torch.py`` on a 2x2
mesh of gloo ranks (the JAX mesh example does not run under jax 0.9,
ROADMAP C1, so its unsharded round is the oracle), each fed the JAX
side's initial weights on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core as JC
import repro_torch.core as TC
import torch_examples as X
from repro.configs.base import FLConfig as JFL
from repro.configs.tiny import TINY as J_TINY
from repro.data.corpus import pretrain_batches as j_pretrain_batches
from repro.data.partition import dirichlet_partition as j_dirichlet
from repro.data.partition import subset as j_subset
from repro.data.synthetic import TaskSpec as JTaskSpec
from repro.data.synthetic import make_task_fns as j_task_fns
from repro.data.synthetic import sample_dataset as j_sample_dataset
from repro.models import Model as JModel
from repro_torch.utils.tree import tree_leaves


@pytest.fixture(autouse=True)
def two_threads():
    # more only contend under the driver's parallel workers
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_vpcs_demo_matches_jax(monkeypatch):
    """The mask and pre-training gradient, the server's GradIP of the
    JAX clients' uploads at the slice's GradIP tolerance over all 60
    steps, each client's first scalar within the slice's scalar tolerance,
    and the same clients flagged.  Past the first steps the two clients'
    own scalars separate further (C4's rounding of the update, times
    1/(2 eps) = 500 in the next scalar, compounded at lr 5e-2; ROADMAP
    C24), so their own trajectories are compared through the flags."""
    uploads, flags = [], []
    trajectory, analyze = JC.gradip_trajectory, JC.analyze_trajectory

    def recorded_trajectory(space, keys, gs, gp):
        out = trajectory(space, keys, gs, gp)
        uploads.append((np.asarray(jax.random.key_data(keys)),
                        np.asarray(gs), np.asarray(out[0])))
        return out

    def recorded_analyze(ips, fl):
        r = analyze(ips, fl)
        flags.append(bool(r.flagged))
        return r

    monkeypatch.setattr(JC, "gradip_trajectory", recorded_trajectory)
    monkeypatch.setattr(JC, "analyze_trajectory", recorded_analyze)
    g = X.run_jax(monkeypatch, "vpcs_demo", ["--steps", "60"])
    out = X.run_port("vpcs_demo", ["--steps", "60"],
                     params=jax.tree.map(np.asarray, g["params"]))
    assert X.mask_overlap(g["space"], g["params"], out["space"],
                          g["params"]) == 1.0
    np.testing.assert_allclose(out["gp"].numpy(), np.asarray(g["gp"]),
                               atol=1e-6)
    assert len(uploads) == len(out["scalars"]) == 6
    for (keys, gs, ips), mine in zip(uploads, out["scalars"]):
        np.testing.assert_array_equal(out["keys"].numpy(), keys)
        got = TC.gradip_trajectory(out["space"], out["keys"], gs,
                                   out["gp"])[0].numpy()
        np.testing.assert_allclose(got, ips, atol=X.GRADIP_ATOL,
                                   rtol=X.GRADIP_RTOL)
        np.testing.assert_allclose(mine[0], gs[0], atol=X.G_ATOL, rtol=0)
    assert [r.flagged for r in out["results"]] == flags
    assert out["flagged"] == [c for c, f in enumerate(flags) if f]


def test_serve_batch_matches_jax(monkeypatch):
    """Reduced Pixtral behind the continuous-batching engine: the same
    prompts, the same generated tokens, decode steps and cache keys."""
    g = X.run_jax(monkeypatch, "serve_batch",
                  ["--archs", "pixtral-12b", "--requests", "3"])
    out = X.run_port("serve_batch", ["--archs", "pixtral-12b", "--requests",
                                     "3"],
                     params={"pixtral-12b": jax.tree.map(np.asarray,
                                                         g["params"])})
    got = out["pixtral-12b"]
    assert [o.tolist() for o in got["outs"]] == \
        [np.asarray(o).tolist() for o in g["outs"]]
    s = g["engine"].stats
    for k in ("decode_steps", "compile_misses", "compile_hits"):
        assert got["stats"][k] == s[k], k


def _jax_unsharded(params, rounds: int, T: int):
    """The JAX mesh example's single-device reference, step for step."""
    spec = JTaskSpec()
    model = JModel(J_TINY)
    loss, _, _ = j_task_fns(model, spec)
    lm = lambda p, b: model.loss(p, b)
    pre = j_pretrain_batches(spec, n_batches=4, batch_size=16)
    space = JC.sensitivity_mask(lm, params, pre, density=1e-2)
    gp = JC.pretrain_gradient_vec(lm, params, space, pre)
    train = j_sample_dataset(spec, 1024, seed=1)
    parts = j_dirichlet(train["label"], 4, alpha=0.5, seed=0)
    clients = [JC.Client(k, j_subset(train, p), 16)
               for k, p in enumerate(parts)]
    fl = JFL(n_clients=4, local_steps=T, lr=5e-2, eps=1e-3, zo_backend="ref")
    srv = JC.FederatedZO(loss, params, space, fl, clients)
    for _ in range(rounds):
        srv.run_round(gp_vec=gp)
    return srv, space


def test_mesh_round_matches_unsharded_and_jax():
    """On a 2x2 mesh of four gloo ranks the aggregate and every GradIP
    trajectory are bit-equal to the port's unsharded round and the bytes
    mesh-invariant; that unsharded round is held to JAX's at the slice's
    tolerances (the same mask, parameters, GradIP and bytes)."""
    rounds, T = 2, 2
    params = JModel(J_TINY).init(jax.random.key(0))
    out = X.run_port("mesh_round", ["--mesh", "2x2", "--rounds", str(rounds),
                                    "--T", str(T)],
                     params=jax.tree.map(np.asarray, params))
    assert out["bit_params"] and out["bit_gradip"] and out["up_equal"]
    assert out["sharded"]["n_devices"] == 4
    jsrv, jspace = _jax_unsharded(params, rounds, T)
    ref = out["ref"]
    assert X.mask_overlap(jspace, params, out["space"], ref.params) == 1.0
    np.testing.assert_allclose(
        X.flat(tree_leaves(ref.params)),
        X.flat(jax.tree_util.tree_leaves(jsrv.params)), atol=X.PARAM_ATOL,
        rtol=0)
    for c in jsrv.gradip_log:
        for a, b in zip(jsrv.gradip_log[c], ref.gradip_log[c]):
            np.testing.assert_allclose(b, np.asarray(a), atol=X.GRADIP_ATOL,
                                       rtol=X.GRADIP_RTOL)
    assert ref.comm.up_bytes == jsrv.comm.up_bytes == 4 * T * 4 * rounds
    assert ref.comm.down_bytes == jsrv.comm.down_bytes
