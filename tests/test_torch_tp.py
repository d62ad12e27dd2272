"""Tensor-parallel compute (``rule="tp"``, ``sharding/fl.py``) on the CPU:
one spawn of 4 gloo ranks a module (``launch.mesh.spawn``; the rank side is
``tests/torch_mesh_ranks.tp_scenarios``) runs every scenario on a ``2x2``
mesh, and this process runs them on a one-rank ``1x1`` mesh.  Held: the tp
round (on the ``ref`` route, and on the kernel route with the flat kernels
on each rank's shards) and train loop to the port's unsharded ones (bit for
bit on ``1x1``, at the JAX tool's tolerance on ``2x2``, ROADMAP C21) and to
JAX's unsharded round; TINY's prefill and decode on tp shards (and the B=1 ``seq_shard``
decode) to the unsharded port at 1e-4 of the forward's max |logit|;
``moe_sharded`` to JAX's ``moe_sharded`` on a 2x2 host mesh, at a
capacity that drops tokens too (the JAX side runs in one subprocess,
``tests/jax_mesh_side.py``); and the dry run's record of a TINY step on a fake group to what rank
0 of the real group records."""
import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_mesh_ranks as R
from repro_torch.launch import mesh as M

# the JAX tool's tolerance for a round whose contractions split (C21)
PARAM_ATOL, G_ATOL = 2e-5, 2e-4
# prefill and decode logits against the unsharded port, of max |logit|
SERVE_REL = 1e-4
# moe_sharded against JAX's: the same f32 ops, summed in other orders
MOE_ATOL = 1e-5
HERE = os.path.dirname(os.path.abspath(__file__))


def _jax_side(b, tmp):
    """Start the JAX package's side in a subprocess: its unsharded server
    on the tp round's scenarios (``TP_PLAIN``, ``TP_KERNEL``'s T=2 on its
    ``ref`` route), and its moe_sharded (and moe_dense_ref); returns a
    callable that waits for it and gives its outputs."""
    src, dst = os.path.join(tmp, "jax_in.pkl"), os.path.join(tmp, "jax.pkl")
    keys = ("params", "idx", "train", "parts4", "moe")
    fls = [R.TP_PLAIN, dict(R.TP_KERNEL, zo_backend="ref")]
    with open(src, "wb") as f:
        pickle.dump(dict({k: b[k] for k in keys}, fls=fls), f)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable,
                             os.path.join(HERE, "jax_mesh_side.py"), "tp",
                             src, dst], env=env)

    def result():
        assert proc.wait(timeout=600) == 0
        with open(dst, "rb") as f:
            return pickle.load(f)
    return result


def _fake_counts():
    """The dry run's TINY step recorded on rank 0 of a fake 2x2 group."""
    from repro_torch.configs.tiny import TINY
    from repro_torch.launch import dryrun
    mc = M.parse_mesh_spec("2x2")
    with M.fake_mesh(mc) as mesh:
        trace, _ = dryrun.trace_step(TINY, R.TEST_SHAPE, mesh, mc,
                                     "zo_fl", dryrun.mask_indices(TINY)[0])
        return dict(dryrun.counts(trace), memory=dryrun._memory(trace))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp"))
    bundle = R.make_tp_bundle(tmp)
    jax_side = _jax_side(bundle, tmp)
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(M.spawn, R.tp_scenarios, 4, "cpu", bundle, "2x2")
        threads = torch.get_num_threads()
        try:
            with M.process_group("cpu") as dev:
                one = R.tp_scenarios(dev, bundle, "1x1", unsharded=True)
        finally:
            torch.set_num_threads(threads)
        fake = _fake_counts()
        ranks = ranks.result()
    j = jax_side()
    return dict(ranks=ranks, one=one, jax_plain=j["plain"], jax_moe=j,
                fake=fake, init=R.flat(bundle["params"]))


def test_tp_round_bit_equal_on_1x1(world):
    """One model rank splits nothing: the tp round and loop are the
    unsharded ones bit for bit."""
    one = world["one"]
    for k in ("plain", "kernel"):
        assert np.array_equal(one[k]["params"], one["unsharded"][k]["params"])
    for k in ("params", "gs"):
        assert np.array_equal(one["loop"][k], one["unsharded"]["loop"][k])
    assert one["plain"]["gradip"].keys() == \
        one["unsharded"]["plain"]["gradip"].keys()


def _held_to_unsharded(world, route):
    r0 = world["ranks"][0]
    for r in world["ranks"][1:]:
        assert np.array_equal(r[route]["params"], r0[route]["params"])
    u = world["one"]["unsharded"]
    np.testing.assert_allclose(r0[route]["params"], u[route]["params"],
                               atol=PARAM_ATOL, rtol=0)
    assert r0[route]["ptrs"] == u[route]["ptrs"]
    assert r0[route]["comm"] == u[route]["comm"]
    assert not np.array_equal(r0[route]["params"], world["init"])


def _held_to_jax(world, route):
    want = world["jax_plain"][("plain", "kernel").index(route)]
    got = world["ranks"][0][route]
    assert want["comm"] == got["comm"] and want["ptrs"] == got["ptrs"]
    np.testing.assert_allclose(got["params"], want["params"],
                               atol=PARAM_ATOL, rtol=0)


def test_tp_round_on_2x2_matches_unsharded(world):
    """Row-parallel contractions reorder sums: the round and the loop stay
    within C21's tolerance of the unsharded port, every rank ends with the
    same parameters, and pointers and bytes are equal."""
    _held_to_unsharded(world, "plain")
    r0, u = world["ranks"][0], world["one"]["unsharded"]
    np.testing.assert_allclose(r0["loop"]["params"], u["loop"]["params"],
                               atol=PARAM_ATOL, rtol=0)
    np.testing.assert_allclose(r0["loop"]["gs"], u["loop"]["gs"],
                               atol=G_ATOL, rtol=0)


def test_tp_kernel_round_on_2x2_matches_unsharded(world):
    """The kernel route at T=2 (the flat kernels on each rank's shards,
    the [n] delta carried across the steps) against the unsharded port's
    kernel route."""
    _held_to_unsharded(world, "kernel")


def test_tp_round_matches_jax(world):
    """The 2x2 tp round against the JAX package's unsharded round."""
    _held_to_jax(world, "plain")


def test_tp_kernel_round_matches_jax(world):
    """The 2x2 tp round on the kernel route at T=2 against the JAX
    package's unsharded round at T=2."""
    _held_to_jax(world, "kernel")


@pytest.mark.parametrize("kind", ["serve", "serve_seq"])
def test_tp_prefill_and_decode(world, kind):
    """Prefill and 3 decode steps on tp shards (``serve_seq``: B=1, the
    cache's sequence split over 'data', the parameters on the whole mesh)
    against the unsharded port; bit-equal on 1x1."""
    one = world["one"][kind]
    assert np.array_equal(one["tp"], one["unsharded"])
    for r in world["ranks"]:
        s = r[kind]
        assert np.abs(s["tp"] - s["unsharded"]).max() <= SERVE_REL * s["scale"]


def test_moe_sharded_matches_jax(world):
    """Each rank's rows of y and the batch-mean aux against JAX's
    moe_sharded on a 2x2 host mesh, at capacity 2.0 and at 0.5, where
    tokens drop (the two outputs differ)."""
    j = world["jax_moe"]
    cfs = R.MOE["cfs"]
    for i in range(len(cfs)):
        y = np.zeros_like(j[f"y{i}"])
        for r in world["ranks"]:
            start, yr, aux = r["moe"][i]
            y[start:start + yr.shape[0]] = yr
            np.testing.assert_allclose(aux, j[f"aux{i}"], atol=MOE_ATOL)
        np.testing.assert_allclose(y, j[f"y{i}"], atol=MOE_ATOL, rtol=0)
        # one model rank: the whole batch through the same dispatch
        _, y1, aux1 = world["one"]["moe"][i]
        np.testing.assert_allclose(y1, j[f"dense{i}"], atol=MOE_ATOL, rtol=0)
    assert not np.allclose(j["y0"], j["y1"], atol=1e-3)


def test_fake_group_record_equals_real_rank(world):
    """The dry run's counts of a TINY ZO step on a fake 2x2 group equal
    rank 0's of the real gloo group: FLOPs, bytes, collective bytes and
    the liveness estimate."""
    fake, real = world["fake"], world["ranks"][0]["trace"]
    assert fake["flops"] == real["flops"] > 0
    assert fake["bytes"] == real["bytes"] > 0
    assert fake["coll"] == real["coll"]
    assert fake["coll"]["all-reduce"] > 0 and fake["coll"]["all-gather"] > 0
    assert fake["memory"] == real["memory"]
