"""The sharded federated round (``sharding/fl.FLShardPlan``, ``FederatedZO
(plan=)``, ``fl_step``'s ``constrain_params``) on the CPU: one spawn of 4
gloo ranks a module (``launch.mesh.spawn``) runs every scenario on a
``2x2`` mesh under ``fsdp`` and ``replicate``, and this process runs them
on a one-rank ``1x1`` mesh.  Held, as ``tools/fl_mesh_parity.py`` holds the
JAX package's: parameters and GradIP bit-equal to the port's unsharded
round, VPCS flags and ``CommLog`` equal, the ``make_fl_train_loop`` route
within its tolerance; then a sampled int8 fleet round, a round with drops
and stragglers, and checkpoint reshape both ways, bit for bit; and the
unsharded round against the JAX package's (ROADMAP C18's tolerance)."""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

import repro.core as JC
import torch_mesh_ranks as R
from repro.configs.base import FLConfig as JFL
from repro.configs.tiny import TINY as J_TINY
from repro.data.synthetic import TaskSpec as JTaskSpec
from repro.data.synthetic import make_task_fns as j_task_fns
from repro.models import Model as JModel
from repro_torch.launch import mesh as M
from repro_torch.sharding.fl import FLShardPlan

# tools/fl_mesh_parity.py's tolerance for the train-loop route (its scalar
# aggregation is ordered differently there; here the rows are split)
LOOP_PARAM_ATOL, LOOP_G_ATOL = 2e-5, 2e-4
# the unsharded port against JAX (tests/test_torch_fault.py, ROADMAP C18)
PARAM_ATOL = 1e-4
CASES = [(m, r) for m in ("2x2", "1x1") for r in R.RULES]
IDS = [f"{m}-{r}" for m, r in CASES]


def _jax_plain(b):
    """The JAX package's unsharded server on the plain scenario: the same
    parameters, mask and clients, two rounds."""
    jloss, _, _ = j_task_fns(JModel(J_TINY), JTaskSpec())
    cs = [JC.Client(k, {n: v[p] for n, v in b["train"].items()}, 4)
          for k, p in enumerate(b["parts4"])]
    srv = JC.FederatedZO(jloss, jax.tree.map(jnp.asarray, b["params"]),
                         JC.MaskedSpace(jax.tree.map(jnp.asarray, b["idx"])),
                         JFL(**R.PLAIN), cs)
    for _ in range(2):
        srv.run_round()
    return dict(params=R.flat(srv.params), ptrs=[c.ptr for c in cs],
                comm=(srv.comm.up_bytes, srv.comm.down_bytes))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    bundle = R.make_bundle(str(tmp_path_factory.mktemp("mesh_ckpt")))
    with ThreadPoolExecutor(1) as pool:
        # the 4 ranks run while this process runs JAX's round and the 1x1
        # mesh
        ranks = pool.submit(M.spawn, R.scenarios, 4, "cpu", bundle, "2x2")
        jax_plain = _jax_plain(bundle)
        threads = torch.get_num_threads()
        try:
            with M.process_group("cpu") as dev:
                one = R.scenarios(dev, bundle, "1x1", unsharded=False)
        finally:
            torch.set_num_threads(threads)
        ranks = ranks.result()
    # every process computes the unsharded round's bits alike (one thread)
    one["unsharded"] = ranks[0]["unsharded"]
    return dict(bundle=bundle, ranks=ranks, jax_plain=jax_plain,
                results={"2x2": ranks[0], "1x1": one})


def _same(a, b) -> bool:
    """Deep equality of the scenarios' results, arrays bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and \
            np.array_equal(a, b)
    return a == b


def test_every_rank_holds_the_same_server(world):
    for r in world["ranks"][1:]:
        assert _same(r, world["ranks"][0])
    # FLShardPlan.broadcast gave every rank rank 0's leaves and shapes
    b = world["ranks"][3]["broadcast"]
    assert np.array_equal(b["a"], np.zeros(3, np.float32))
    assert np.array_equal(b["b"][0], np.zeros(1, np.int64))


@pytest.mark.parametrize("mesh,rule", CASES, ids=IDS)
def test_round_bit_equal_to_unsharded(world, mesh, rule):
    """The JAX tool's checks on VP calibration and 2 rounds of T=3 (and on
    the plain scenario's 2 rounds)."""
    res = world["results"][mesh]
    for case in ("vp", "plain"):
        want, got = res["unsharded"][case], res[rule][case]
        assert np.array_equal(want["params"], got["params"])
        assert _same(want["gradip"], got["gradip"])
        assert want["flags"] == got["flags"]
        assert want["comm"] == got["comm"]
        assert want["ptrs"] == got["ptrs"]


@pytest.mark.parametrize("mesh,rule", CASES, ids=IDS)
def test_fleet_round_bit_equal_to_unsharded(world, mesh, rule):
    """A cohort of 4 of 8 (ClientSampler), the int8 uplink, GradIP."""
    res = world["results"][mesh]
    assert _same(res["unsharded"]["fleet"], res[rule]["fleet"])
    assert res[rule]["fleet"]["info"]["n_unsampled"] == 4


@pytest.mark.parametrize("mesh,rule", CASES, ids=IDS)
def test_fault_rounds_bit_equal_to_unsharded(world, mesh, rule):
    """Drops and stragglers over 3 rounds, GradIP gaps included."""
    res = world["results"][mesh]
    want = res["unsharded"]["faults"]
    assert _same(want, res[rule]["faults"])
    assert sum(g is None for v in want["gradip"].values() for g in v)


@pytest.mark.parametrize("mesh,rule", CASES, ids=IDS)
def test_train_loop_route_within_tolerance(world, mesh, rule):
    res = world["results"][mesh]
    want, got = res["unsharded"]["loop"], res[rule]["loop"]
    np.testing.assert_allclose(got["params"], want["params"],
                               atol=LOOP_PARAM_ATOL, rtol=0)
    np.testing.assert_allclose(got["gs"], want["gs"], atol=LOOP_G_ATOL,
                               rtol=0)
    assert got["gs"].shape == (R.LOOP_STEPS, 4)
    assert not np.array_equal(want["params"],
                              R.flat(world["bundle"]["params"]))


@pytest.mark.parametrize("mesh,rule", CASES, ids=IDS)
def test_checkpoint_reshape_both_ways(world, mesh, rule):
    """A mesh server's checkpoint is the unsharded server's byte for byte;
    restored into the other kind of server, each runs the next round to
    the same parameters bit for bit."""
    res = world["results"][mesh][rule]
    to_u, to_m = res["to_unsharded"], res["to_mesh"]
    assert to_u["blob"] == to_m["blob"]
    assert np.array_equal(to_u["params"], to_m["params"])
    assert np.array_equal(to_u["twin"], to_u["params"])
    assert np.array_equal(to_m["twin"], to_m["params"])


def test_unsharded_round_matches_jax(world):
    """The JAX package's unsharded server against the port's on the plain
    scenario's two rounds (the same parameters, mask and data): bytes and
    pointers equal, parameters within PARAM_ATOL."""
    want = world["jax_plain"]
    got = world["results"]["2x2"]["unsharded"]["plain"]
    assert want["comm"] == got["comm"] and want["ptrs"] == got["ptrs"]
    np.testing.assert_allclose(got["params"], want["params"],
                               atol=PARAM_ATOL, rtol=0)
    assert not np.array_equal(want["params"],
                              R.flat(world["bundle"]["params"]))


def test_tp_rule_raises():
    """``rule="tp"`` computes (it raised until the port had
    tensor-parallel compute, ROADMAP A item 8): on a one-rank ``1x1``
    group the plan's compute view is the Megatron shards, its forward is
    the unsharded forward bit for bit, and its ``constrain_params``
    re-places the shards (the train CLI's ``--mesh-rule tp``:
    ``test_torch_checkpoint.py``)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.configs.tiny import TINY
    from repro_torch.models import Model
    from repro_torch.sharding.fl import make_fl_plan
    with M.process_group("cpu"):
        plan = make_fl_plan(spec="1x1", rule="tp")
        model = Model(TINY, device="cpu")
        params = model.init(seed=0)
        view = plan.compute_view(plan.place_params(params))
        leaf = view["stack"]["p0"]["wq"]
        assert isinstance(leaf, DTensor) and leaf.device_mesh.ndim == 1
        batch = {"tokens": torch.arange(32).reshape(2, 16) % TINY.vocab}
        want, _ = model.forward(params, batch)
        got, _ = model.forward(view, batch)
        assert torch.equal(got.full_tensor(), want)
        rest = plan.constrain_params_fn()(view)
        assert torch.equal(plan.full(rest)["embed"], params["embed"])
