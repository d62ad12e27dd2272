"""Fleet-scale rounds of the port (``core/sampling``, the quantized uplink,
their composition with faults and checkpoints) against the JAX package's:
sampler cohorts and state bit for bit, sampled int8 rounds with faults on
TINY against JAX's ``FederatedZO``, exact replay from the wire, the
billed bytes, ``fl_step`` under a ``QuantSpec``, and resume bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

import repro.core as JC
import repro_torch.core as TC
from repro.configs.base import FLConfig as JFL
from repro.configs.tiny import TINY as J_TINY
from repro.core import fl_step as JF
from repro.core import quantize as JQ
from repro.core.sampling import ClientSampler as JSampler
from repro.data.synthetic import make_task_fns as j_task_fns
from repro.fault import FaultPlan as JFaultPlan
from repro.models import Model as JModel
from repro_torch.checkpoint.state import server_state_sizes
from repro_torch.configs.base import FLConfig
from repro_torch.configs.tiny import TINY
from repro_torch.convert import params_from_numpy, space_from_numpy
from repro_torch.core import fl_step as TF
from repro_torch.core import prng
from repro_torch.core.gradip import gradip_matrix
from repro_torch.core.quantize import IntCodec, QuantSpec, wire_nbytes
from repro_torch.core.sampling import ClientSampler
from repro_torch.data import TaskSpec, make_task_fns, sample_dataset
from repro_torch.fault import FaultPlan
from repro_torch.models import Model
from repro_torch.utils.tree import tree_leaves
from test_torch_fault import PARAM_ATOL, grid_steps_apart

SPEC = TaskSpec(vocab=min(TINY.vocab, 512))
# fl_step's per-client scalars at TINY's full vocab (test_torch_fl_step.py's
# bound: a few ulp of a loss of ~6.2, times 1 / (2 eps))
G_ATOL = 2e-3


# -- ClientSampler ------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("K,frac,seed", [(16, 0.5, 0), (20, 0.25, 3),
                                         (7, 0.3, 11)])
def test_sampler_cohorts_equal_jax(weighted, K, frac, seed):
    w = (np.random.default_rng(seed).integers(1, 50, size=K).tolist()
         if weighted else None)
    t = ClientSampler(range(K), frac=frac, weights=w, seed=seed)
    j = JSampler(range(K), frac=frac, weights=w, seed=seed)
    assert (t.m, t.weighted) == (j.m, j.weighted)
    for r in range(20):
        assert t.cohort(r) == j.cohort(r)
        if r in (0, 9, 19):
            assert t.state_dict() == j.state_dict()


def test_sampler_state_roundtrip_and_checks():
    ref = ClientSampler(range(32), frac=0.25, seed=9)
    draws = [ref.cohort(r) for r in range(10)]
    src = ClientSampler(range(32), frac=0.25, seed=9)
    for r in range(4):
        src.cohort(r)
    fresh = ClientSampler(range(32), frac=0.25, seed=9)
    fresh.load_state(src.state_dict())
    assert [fresh.cohort(r) for r in range(4, 10)] == draws[4:]
    with pytest.raises(ValueError, match="mismatch"):
        ClientSampler(range(16), frac=0.5, seed=9).load_state(
            src.state_dict())
    with pytest.raises(ValueError, match="out-of-order"):
        fresh.cohort(3)
    with pytest.raises(ValueError, match="positive"):
        ClientSampler(range(4), m=3, weights=[1, 0, 0, 0])
    with pytest.raises(ValueError, match="need frac or m"):
        ClientSampler(range(4))


# -- sampled, quantized, faulty rounds against JAX ----------------------------

@pytest.fixture(scope="module")
def pair():
    jm = JModel(J_TINY)
    jp = jm.init(jax.random.key(0))
    tm = Model(TINY, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jspace = JC.random_mask(jp, density=1e-2, seed=0, balanced=False)
    tspace = space_from_numpy(jax.tree.map(np.asarray, jspace.idx_tree),
                              device="cpu")
    jloss, jper, _ = j_task_fns(jm, SPEC)
    tloss, tper, _ = make_task_fns(tm, SPEC)
    gp = np.random.default_rng(0).normal(size=jspace.n).astype(np.float32)
    return dict(jm=jm, jp=jp, tm=tm, tp=tp, jspace=jspace, tspace=tspace,
                jloss=jloss, tloss=tloss, jper=jper, tper=tper, gp=gp)


def _servers(s, K, backend, quantize, frac=0.5):
    kw = dict(n_clients=K, local_steps=2, batch_size=2, sample_frac=frac,
              quantize=quantize, lr=5e-2)
    data = [sample_dataset(SPEC, 8, seed=i) for i in range(K)]
    js = JC.FederatedZO(s["jloss"], s["jp"], s["jspace"],
                        JFL(zo_backend=backend[0], **kw),
                        [JC.Client(i, d, 2) for i, d in enumerate(data)])
    ts = TC.FederatedZO(s["tloss"], s["tp"], s["tspace"],
                        FLConfig(zo_backend=backend[1], **kw),
                        [TC.Client(i, d, 2) for i, d in enumerate(data)],
                        device="cpu")
    return js, ts


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in tree_leaves(tree)])


@pytest.mark.parametrize("backend,quantize", [
    (("ref", "ref"), "int8"), (("pallas", "kernel"), "int4-nearest")],
    ids=["ref-int8", "kernel-int4-nearest"])
def test_sampled_quantized_faulty_rounds_match_jax(pair, backend, quantize):
    """Six rounds, a cohort of 3 of 6, faults, GradIP every round: equal
    cohorts, drops, lates, arrivals, ``last_round_info``, CommLog bytes and
    gap positions; decoded uploads bit-equal but where C18 moves a few;
    parameters within PARAM_ATOL."""
    s = pair
    K, R = 6, 6
    js, ts = _servers(s, K, backend, quantize)
    plan = dict(drop_rate=0.2, late_rate=0.3, max_staleness=2, seed=5)
    jfp, tfp = JFaultPlan(K, R, **plan), FaultPlan(K, R, **plan)
    bits = int(quantize[3])
    n_steps = n_scalars = n_unsampled = 0
    for r in range(R):
        jg = js.run_round(gp_vec=jnp.asarray(s["gp"]),
                          faults=jfp.round_faults(r))
        tg = ts.run_round(gp_vec=torch.from_numpy(s["gp"]),
                          faults=tfp.round_faults(r))
        a, b = js.last_round_info, ts.last_round_info
        assert {k: v for k, v in a.items() if k != "arrived"} == \
            {k: v for k, v in b.items() if k != "arrived"}
        assert [x[:2] for x in a["arrived"]] == [x[:2] for x in b["arrived"]]
        for x, y in zip(a["arrived"], b["arrived"]):
            n_steps += grid_steps_apart(x[2], y[2], bits)
        assert sorted(jg) == sorted(tg)
        for c in jg:
            n_steps += grid_steps_apart(jg[c], tg[c], bits)
            n_scalars += tg[c].size
        assert (js.comm.up_bytes, js.comm.down_bytes) == \
            (ts.comm.up_bytes, ts.comm.down_bytes)
        n_unsampled += b["n_unsampled"]
    assert n_unsampled == R * (K - ts.sampler.m)
    assert n_steps <= 1 + n_scalars // 10
    assert ts.sampler.state_dict() == js.sampler.state_dict()
    assert [c.ptr for c in ts.clients] == [c.ptr for c in js.clients]
    for c in range(K):
        assert [e is None for e in js.gradip_log[c]] == \
            [e is None for e in ts.gradip_log[c]]
        mat, present = gradip_matrix(ts.gradip_log[c], T=2)
        assert mat.shape == (R, 2) and present.sum() < R
        assert np.isnan(mat[~present]).all()
    np.testing.assert_allclose(
        _flat(ts.params),
        np.concatenate([np.asarray(x).ravel()
                        for x in jax.tree_util.tree_leaves(js.params)]),
        atol=PARAM_ATOL, rtol=0)


def test_exact_replay_and_billing(pair):
    """A prompt client applies the on-grid scalars the server decodes, bit
    for bit; its own delta matches the wire replay at rtol 1e-6 (two
    rounding orders of the same update, as in test_torch_slice); each
    upload of T=2 int8 scalars is billed 4 bytes."""
    s = pair
    srv = TC.FederatedZO(
        s["tloss"], s["tp"], s["tspace"],
        FLConfig(n_clients=4, local_steps=2, batch_size=2, lr=5e-2,
                 quantize="int8", zo_backend="kernel"),
        [TC.Client(i, sample_dataset(SPEC, 8, seed=i), 2) for i in range(4)],
        device="cpu")
    run = TC.make_local_run(s["tloss"], s["tspace"], 1e-3, 5e-2,
                            backend="kernel", quantize=QuantSpec(8))
    keys = TC.round_keys(srv.fl.seed, 0, 2)
    c0 = srv.clients[0]
    batches = {k: torch.as_tensor(v) for k, v in
               c0.next_batches(2).items()}
    c0.ptr = 0
    delta, applied = run(s["tp"], keys, batches, torch.zeros(s["tspace"].n))
    gs = srv.run_round()
    assert np.array_equal(applied.numpy().view(np.int32),
                          gs[0].view(np.int32))
    wire = srv.codec.encode(gs[0])
    assert wire.nbytes == wire_nbytes(2, 8) == 4
    assert srv.comm.up_bytes == 4 * 4  # against 4 * 8 raw f32
    rec = TC.reconstruct_from_wire(s["tspace"], keys, wire, srv.codec, 5e-2)
    scale = float(rec.abs().max())
    assert torch.allclose(delta, rec, rtol=1e-6, atol=1e-6 * scale)


def _within_a_step(want, got, bits: int = 8):
    want = np.asarray(want, np.float32)
    step = np.ldexp(np.float32(1), JQ.pow2_exponent(np.abs(want), bits))
    assert (np.abs(want - got) <= G_ATOL + step).all(), (want, got)


def test_fl_step_quantized_matches_jax(pair):
    """``make_fl_train_step`` and ``make_fl_train_loop`` with QuantSpec(8)
    against the JAX package's: per-client scalars on the wire grid, within
    test_torch_fl_step's G_ATOL of JAX's plus one grid step (the scalars
    before rounding already differ by up to G_ATOL there, several grid
    steps of a small scalar); the loop equals the folded step bit for bit;
    parameters within PARAM_ATOL."""
    s = pair
    K_, B_, N = 2, 2, 3
    toks = np.random.default_rng(0).integers(0, TINY.vocab,
                                             size=(N, K_ * B_, 16),
                                             dtype=np.int32)
    kw = dict(eps=1e-3, lr=1e-2, n_clients=K_)
    jstep = JF.make_fl_train_step(lambda p, b: s["jm"].loss(
        p, b, per_example=True), s["jspace"], quantize=JQ.QuantSpec(8), **kw)
    tper = lambda p, b: s["tm"].loss(p, b, per_example=True)  # noqa: E731
    tstep = TF.make_fl_train_step(tper, s["tspace"], quantize=QuantSpec(8),
                                  **kw)
    jp2, jg, _ = jstep(s["jp"], jax.random.key(5),
                       {"tokens": jnp.asarray(toks[0])})
    tp2, tg, _ = tstep(s["tp"], prng.key(5),
                       {"tokens": torch.as_tensor(toks[0])})
    _within_a_step(jg, tg.numpy())
    codec = IntCodec(8)
    assert np.array_equal(codec.decode(codec.encode(tg.numpy())),
                          tg.numpy())
    np.testing.assert_allclose(_flat(tp2), np.concatenate(
        [np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(jp2)]),
        atol=PARAM_ATOL, rtol=0)

    jloop = JF.make_fl_train_loop(lambda p, b: s["jm"].loss(
        p, b, per_example=True), s["jspace"], n_steps=N,
        quantize=JQ.QuantSpec(8), **kw)
    tloop = TF.make_fl_train_loop(tper, s["tspace"], n_steps=N,
                                  quantize=QuantSpec(8), **kw)
    jpl, jgl, _ = jloop(s["jp"], jax.random.key(7),
                        {"tokens": jnp.asarray(toks)})
    tpl, tgl, _ = tloop(s["tp"], prng.key(7),
                        {"tokens": torch.as_tensor(toks)})
    _within_a_step(jgl, tgl.numpy())
    assert np.array_equal(codec.decode(codec.encode(tgl.numpy())),
                          tgl.numpy())
    np.testing.assert_allclose(_flat(tpl), np.concatenate(
        [np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(jpl)]),
        atol=N * PARAM_ATOL, rtol=0)
    # the loop is the step folded over the batches, bit for bit
    p, keys = s["tp"], prng.split(prng.key(7), N)
    for i in range(N):
        p, g_i, _ = tstep(p, keys[i], {"tokens": torch.as_tensor(toks[i])})
        assert torch.equal(g_i, tgl[i])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p),
                                                 tree_leaves(tpl)))


# -- the port on its own: resume, state size ----------------------------------

@pytest.fixture(scope="module")
def prob():
    model = Model(TINY, device="cpu")
    params = model.init(seed=0)
    loss, _, _ = make_task_fns(model, SPEC)
    space = TC.random_mask(params, density=1e-2, seed=0, balanced=False)
    return dict(params=params, loss=loss, space=space,
                gp=torch.full((space.n,), 0.01))


def mk_server(prob, n_clients=6, frac=0.5, quantize="int8"):
    fl = FLConfig(n_clients=n_clients, local_steps=2, batch_size=2,
                  zo_backend="ref", sample_frac=frac, quantize=quantize)
    clients = [TC.Client(i, sample_dataset(SPEC, 8, seed=i), 2)
               for i in range(n_clients)]
    return TC.FederatedZO(prob["loss"], prob["params"], prob["space"], fl,
                          clients, device="cpu")


def test_sampled_quantized_resume_bitexact(prob, tmp_path):
    """Save at round 2 of a sampled int8 run, restore into a fresh server,
    continue: bit-identical to the uninterrupted run, the sampler's
    re-drawn cohorts included."""
    path = str(tmp_path / "ckpt.msgpack")
    ref = mk_server(prob)
    cohorts = []
    for _ in range(5):
        ref.run_round(gp_vec=prob["gp"])
        cohorts.append(ref.last_round_info["cohort"])
    donor = mk_server(prob)
    for _ in range(2):
        donor.run_round(gp_vec=prob["gp"])
    donor.save_checkpoint(path)
    fresh = mk_server(prob)
    meta = fresh.load_checkpoint(path)
    assert meta["round"] == 2 and meta["sampler"] is not None
    resumed = []
    for _ in range(3):
        fresh.run_round(gp_vec=prob["gp"])
        resumed.append(fresh.last_round_info["cohort"])
    assert resumed == cohorts[2:]
    assert np.array_equal(_flat(ref.params), _flat(fresh.params))
    assert (ref.comm.up_bytes, ref.comm.down_bytes) == \
        (fresh.comm.up_bytes, fresh.comm.down_bytes)
    assert [c.ptr for c in ref.clients] == [c.ptr for c in fresh.clients]
    for cid in ref.gradip_log:
        for u, v in zip(ref.gradip_log[cid], fresh.gradip_log[cid]):
            assert (u is None) == (v is None)
            assert u is None or np.array_equal(u, v)
    assert fresh.sampler.state_dict() == ref.sampler.state_dict()


def test_server_state_o1_in_fleet_size(prob):
    small = mk_server(prob, n_clients=4)
    big = mk_server(prob, n_clients=32)
    for _ in range(2):
        small.run_round(gp_vec=prob["gp"])
        big.run_round(gp_vec=prob["gp"])
    a, b = server_state_sizes(small), server_state_sizes(big)
    assert a["model_state_bytes"] == b["model_state_bytes"]
    assert b["per_client_state_bytes"] / b["n_clients"] < 1024
