"""The failure model of the port (``repro_torch.fault`` and
``FederatedZO.run_round(faults=)``) against the JAX package's: the same
FaultPlan schedules and cohort restriction, the wire replay, survivor-count
aggregation and the GradIP gap matrix bit for bit, fault rounds on TINY
against JAX's ``FederatedZO``, and the port's own fault semantics (dropout
parity, bit-exact straggler replay, fault-aware CommLog, GradIP gaps)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

import repro.core as JC
import repro.core.virtual_path as JVP
import repro_torch.core as TC
import repro_torch.core.virtual_path as TVP
from repro.configs.base import FLConfig as JFL
from repro.configs.tiny import TINY as J_TINY
from repro.core import quantize as JQ
from repro.core.gradip import gradip_matrix as j_gradip_matrix
from repro.data.synthetic import make_task_fns as j_task_fns
from repro.fault import FaultPlan as JFaultPlan
from repro.fault import RoundFaults as JRoundFaults
from repro.models import Model as JModel
from repro_torch.configs.base import FLConfig
from repro_torch.configs.tiny import TINY
from repro_torch.convert import params_from_numpy, space_from_numpy
from repro_torch.core import quantize as TQ
from repro_torch.core.gradip import gradip_matrix
from repro_torch.data import TaskSpec, make_task_fns, sample_dataset
from repro_torch.fault import NO_FAULTS, FaultPlan, RoundFaults
from repro_torch.models import Model
from repro_torch.utils.tree import tree_leaves

SPEC = TaskSpec(vocab=min(TINY.vocab, 512))
# parameters after a few rounds (tests/test_torch_slice.py's bound)
PARAM_ATOL = 1e-4


# the per-step scalars of the two packages before rounding, at this vocab
# (tests/test_torch_slice.py's bound: an ulp of the loss times 1 / (2 eps))
G_ATOL = 5e-4


def grid_steps_apart(want, got, bits: int = 8) -> int:
    """How many decoded scalars differ from the JAX package's.  Each that
    does lies within G_ATOL plus one grid step 2^e of it (ROADMAP C18: the
    two packages' f32 forwards differ by an ulp of the loss, which can
    carry a scalar across a rounding boundary of the wire grid; a small
    scalar's step is below G_ATOL, so by more than one step)."""
    want = np.asarray(want, np.float32).ravel()
    got = np.asarray(got, np.float32).ravel()
    step = np.ldexp(np.float32(1), JQ.pow2_exponent(np.abs(want), bits))
    assert (np.abs(want - got) <= G_ATOL + step).all(), (want, got)
    return int((want != got).sum())


# -- FaultPlan ----------------------------------------------------------------

PLANS = [dict(n_clients=6, rounds=8, drop_rate=0.2, late_rate=0.3,
              max_staleness=2, seed=5),
         dict(n_clients=16, rounds=4, drop_rate=0.2, late_rate=0.2,
              max_staleness=2, seed=0, kill_rounds=(2,)),
         dict(n_clients=3, rounds=5, drop_rate=0.0, late_rate=0.5,
              max_staleness=3, seed=7),
         dict(n_clients=40, rounds=3, drop_rate=0.5, late_rate=0.5,
              max_staleness=1, seed=123, kill_rounds=(1, 9))]


@pytest.mark.parametrize("kw", PLANS, ids=lambda kw: f"K{kw['n_clients']}"
                         f"_s{kw['seed']}")
def test_fault_plan_schedule_equals_jax(kw):
    tp, jp = FaultPlan(**kw), JFaultPlan(**kw)
    assert tp.summary() == jp.summary()
    for r in range(kw["rounds"] + 10):
        a, b = tp.round_faults(r), jp.round_faults(r)
        assert (a.drops, dict(a.late), a.kill, a.empty) == \
            (b.drops, dict(b.late), b.kill, b.empty)
        assert tp.kill_at(r) == jp.kill_at(r)
        for cohort in ([0, 2, 3], range(kw["n_clients"]), []):
            ra, rb = a.restrict(cohort), b.restrict(cohort)
            assert (ra.drops, dict(ra.late), ra.kill) == \
                (rb.drops, dict(rb.late), rb.kill)


def test_fault_plan_validation_and_empty():
    for bad in (dict(drop_rate=0.7, late_rate=0.5),
                dict(drop_rate=-0.1), dict(max_staleness=0)):
        with pytest.raises(ValueError):
            FaultPlan(4, 4, **bad)
        with pytest.raises(ValueError):
            JFaultPlan(4, 4, **bad)
    with pytest.raises(ValueError):
        FaultPlan(0, 4)
    assert NO_FAULTS.empty and RoundFaults().empty
    assert not RoundFaults(drops=frozenset({1})).empty
    assert not RoundFaults(late={2: 1}).empty
    assert not RoundFaults(kill=True).empty
    rf = RoundFaults(drops=frozenset({1, 4}), late={2: 1, 5: 2}, kill=True)
    jrf = JRoundFaults(drops=frozenset({1, 4}), late={2: 1, 5: 2}, kill=True)
    r, jr = rf.restrict({1, 2, 3}), jrf.restrict({1, 2, 3})
    assert (r.drops, r.late, r.kill) == (jr.drops, jr.late, jr.kill)


# -- wire replay, aggregation, GradIP gaps: bit for bit -----------------------

class _GivenZ:
    """A space whose z for key i is row i of a fixed matrix, the same for
    both packages: the port's normals sit within 3 ulp of JAX's (ROADMAP
    A2), so this holds the replay arithmetic itself to the bit."""

    def __init__(self, Z, lib):
        self.Z, self.lib, self.n = Z, lib, Z.shape[1]
        self.device = torch.device("cpu")

    def sample_z(self, k):
        if self.lib == "jax":
            return jnp.asarray(self.Z)[k]
        return torch.from_numpy(self.Z)[int(k)]


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("T", [1, 2, 6])
def test_reconstruct_from_wire_bitexact(bits, T):
    rng = np.random.default_rng(bits * 10 + T)
    Z = rng.normal(size=(T, 5000)).astype(np.float32)
    for trial in range(4):
        g = (rng.normal(size=T) * 10.0 ** rng.uniform(-3, 2)).astype(
            np.float32)
        jc, tc = JQ.IntCodec(bits), TQ.IntCodec(bits)
        jw, tw = jc.encode(g), tc.encode(g)
        assert jw.tobytes() == tw.tobytes()
        keys = np.arange(T)
        want = np.asarray(JVP.reconstruct_from_wire(
            _GivenZ(Z, "jax"), jnp.asarray(keys), jw, jc, 0.05))
        got = TVP.reconstruct_from_wire(_GivenZ(Z, "torch"),
                                        torch.from_numpy(keys), tw, tc, 0.05)
        assert np.array_equal(got.numpy().view(np.int32),
                              want.view(np.int32))


def test_reconstruct_from_wire_is_the_decoded_replay():
    """On a real masked space: the wire replay equals the port's replay of
    the decoded scalars bit for bit, and JAX's within the normals' ulps."""
    jp = JModel(J_TINY).init(jax.random.key(0))
    jspace = JC.random_mask(jp, density=1e-2, seed=0, balanced=False)
    tspace = space_from_numpy(jax.tree.map(np.asarray, jspace.idx_tree),
                              device="cpu")
    g = np.array([0.37, -1.9, 12.5], np.float32)
    codec = TQ.IntCodec(8)
    wire = codec.encode(g)
    keys = TC.round_keys(0, 3, 3)
    got = TVP.reconstruct_from_wire(tspace, keys, wire, codec, 5e-2)
    assert torch.equal(got, TVP.reconstruct_delta(tspace, keys,
                                                  codec.decode(wire), 5e-2))
    want = JVP.reconstruct_from_wire(jspace, JC.round_keys(0, 3, 3),
                                     JQ.IntCodec(8).encode(g),
                                     JQ.IntCodec(8), 5e-2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6 * float(np.abs(want).max()))
    vecs = TVP.reconstruct_grad_vecs(tspace, keys, codec.decode(wire))
    assert vecs.shape == (3, tspace.n)
    np.testing.assert_allclose(
        vecs.numpy(), np.asarray(JVP.reconstruct_grad_vecs(
            jspace, JC.round_keys(0, 3, 3), jnp.asarray(codec.decode(wire)))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("K", [1, 2, 5, 9])
def test_aggregate_n_reporting_bitexact(K):
    rng = np.random.default_rng(K)
    D = rng.normal(size=(K, 3000)).astype(np.float32)
    for n in (None, K, K + 3):
        want = np.asarray(JVP.aggregate(jnp.asarray(D), n))
        got = TVP.aggregate(torch.from_numpy(D), n).numpy()
        assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_aggregate_refuses_empty():
    deltas = torch.tensor([[2.0, 4.0], [4.0, 8.0]])
    np.testing.assert_array_equal(TVP.aggregate(deltas).numpy(), [3.0, 6.0])
    np.testing.assert_array_equal(TVP.aggregate(deltas, 4).numpy(),
                                  [1.5, 3.0])
    with pytest.raises(ValueError):
        TVP.aggregate(deltas, 0)
    with pytest.raises(ValueError):
        TVP.aggregate(torch.zeros((0, 2)))


@pytest.mark.parametrize("entries,T", [
    ([np.array([1.0, 2.0], np.float32), None, np.array([3.0], np.float32)],
     None),
    ([None, None], 3),
    ([np.array([0.5, -0.5, 2.0], np.float32), None], 4),
    ([np.float32([7.0])], None)])
def test_gradip_matrix_equals_jax(entries, T):
    mat, present = gradip_matrix(entries, T)
    jmat, jpresent = j_gradip_matrix(entries, T)
    assert mat.dtype == jmat.dtype and mat.shape == jmat.shape
    assert np.array_equal(mat, jmat, equal_nan=True)
    assert np.array_equal(present, jpresent)
    with pytest.raises(ValueError):
        gradip_matrix([None, None])


# -- the port's fault semantics -----------------------------------------------

@pytest.fixture(scope="module")
def prob():
    model = Model(TINY, device="cpu")
    params = model.init(seed=0)
    loss, per_example, _ = make_task_fns(model, SPEC)
    space = TC.random_mask(params, density=1e-2, seed=0, balanced=False)
    return dict(params=params, loss=loss, per_example=per_example,
                space=space, gp=torch.full((space.n,), 0.01))


def mk_server(prob, n_clients=3, T=2, momentum=0.0):
    fl = FLConfig(n_clients=n_clients, local_steps=T, batch_size=2,
                  server_momentum=momentum)
    clients = [TC.Client(i, sample_dataset(SPEC, 8, seed=i), 2)
               for i in range(n_clients)]
    return TC.FederatedZO(prob["loss"], prob["params"], prob["space"], fl,
                          clients, device="cpu")


def flat(tree):
    return torch.cat([x.reshape(-1) for x in tree_leaves(tree)])


def test_dropout_survivor_parity(prob):
    """A round with client 2 offline equals, bit for bit, the round of a
    fleet that never had client 2."""
    full = mk_server(prob, n_clients=3)
    full.run_round(gp_vec=prob["gp"], faults=RoundFaults(drops=frozenset({2})))
    survivors = mk_server(prob, n_clients=2)
    survivors.run_round(gp_vec=prob["gp"])
    assert torch.equal(flat(full.params), flat(survivors.params))
    assert full.clients[2].ptr == 0
    assert full.gradip_log[2] == [None]
    assert full.last_round_info["n_reporting"] == 2
    assert full.last_round_info["drops"] == [2]


def test_dropout_comm_counts_survivors_only(prob):
    T = 2
    srv = mk_server(prob, n_clients=3, T=T)
    srv.run_round(faults=RoundFaults(drops=frozenset({0})))
    assert srv.comm.up_bytes == 2 * 4 * T
    assert srv.comm.down_bytes == 2 * srv._down_bytes(T)


def test_zero_survivor_round_is_noop_update(prob):
    srv = mk_server(prob, n_clients=3)
    p0 = flat(srv.params)
    srv.run_round(faults=RoundFaults(drops=frozenset({0, 1, 2})))
    assert torch.equal(p0, flat(srv.params))
    assert srv.round == 1 and srv.comm.up_bytes == 0
    assert srv.last_round_info["n_reporting"] == 0
    assert [c.ptr for c in srv.clients] == [0, 0, 0]


def test_straggler_upload_is_bitexact_and_gap_filled(prob):
    twin = mk_server(prob, n_clients=3)
    gs0 = twin.run_round(gp_vec=prob["gp"])
    srv = mk_server(prob, n_clients=3)
    reported = srv.run_round(gp_vec=prob["gp"],
                             faults=RoundFaults(late={1: 1}))
    assert 1 not in reported
    assert srv.gradip_log[1] == [None]
    assert len(srv._pending) == 1
    assert np.array_equal(srv._pending[0]["gs"], gs0[1])
    assert srv.clients[1].ptr == twin.clients[1].ptr
    srv.run_round(gp_vec=prob["gp"])
    assert srv._pending == []
    assert np.array_equal(srv.gradip_log[1][0], twin.gradip_log[1][0])
    assert srv.last_round_info["arrived"][0][:2] == (1, 0)


def test_straggler_comm_bytes_settle_and_staleness_bound(prob):
    clean = mk_server(prob, n_clients=3)
    clean.run_round()
    clean.run_round()
    srv = mk_server(prob, n_clients=3)
    srv.run_round(faults=RoundFaults(late={0: 1, 2: 1}))
    assert srv.comm.up_bytes == 4 * 2  # only client 1's scalars so far
    srv.run_round()
    assert (srv.comm.up_bytes, srv.comm.down_bytes) == \
        (clean.comm.up_bytes, clean.comm.down_bytes)
    late = mk_server(prob, n_clients=3)
    late.run_round(faults=RoundFaults(late={1: 2}))
    late.run_round()
    assert len(late._pending) == 1  # not due yet
    late.run_round()
    assert late._pending == []


def test_mixed_T_groups_with_faults(prob):
    srv = mk_server(prob, n_clients=4)
    srv.early_stopped = {1, 3}
    srv.run_round(gp_vec=prob["gp"],
                  faults=RoundFaults(drops=frozenset({3}), late={0: 1}))
    assert srv.gradip_log[3] == [None]
    assert len(srv._pending) == 1 and srv._pending[0]["cid"] == 0
    assert srv._pending[0]["gs"].shape == (2,)
    assert srv.last_round_info["n_reporting"] == 2
    srv.run_round(gp_vec=prob["gp"])
    assert all(srv.gradip_log[c][0] is not None for c in (0, 1, 2))


def test_kill_event_calls_kill_now(prob, monkeypatch):
    """``kill`` goes through ``fault.plan.kill_now`` mid-round, after the
    clients ran and before the update applies."""
    from repro_torch.fault import plan as fault_plan

    class Killed(Exception):
        pass

    def fake_kill():
        raise Killed

    monkeypatch.setattr(fault_plan, "kill_now", fake_kill)
    srv = mk_server(prob, n_clients=3)
    p0 = flat(srv.params)
    with pytest.raises(Killed):
        srv.run_round(faults=RoundFaults(kill=True))
    assert torch.equal(p0, flat(srv.params)) and srv.round == 0
    assert all(c.ptr > 0 for c in srv.clients)


# -- fault rounds against JAX's FederatedZO -----------------------------------

def test_fault_rounds_match_jax():
    """Four full-fleet int8 rounds under one FaultPlan (drops and
    stragglers landing later), GradIP logged: the same reports, arrivals,
    gaps and bytes, decoded uploads bit-equal but where C18 moves one
    (one of this test's scalars, by one grid step), parameters within
    PARAM_ATOL."""
    jm = JModel(J_TINY)
    jp = jm.init(jax.random.key(0))
    tm = Model(TINY, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jspace = JC.random_mask(jp, density=1e-2, seed=0, balanced=False)
    tspace = space_from_numpy(jax.tree.map(np.asarray, jspace.idx_tree),
                              device="cpu")
    jloss, _, _ = j_task_fns(jm, SPEC)
    tloss, _, _ = make_task_fns(tm, SPEC)
    K, R = 4, 4
    kw = dict(n_clients=K, local_steps=2, batch_size=2, lr=5e-2,
              zo_backend="ref", quantize="int8")
    data = [sample_dataset(SPEC, 8, seed=i) for i in range(K)]
    js = JC.FederatedZO(jloss, jp, jspace, JFL(**kw),
                        [JC.Client(i, d, 2) for i, d in enumerate(data)])
    ts = TC.FederatedZO(tloss, tp, tspace, FLConfig(**kw),
                        [TC.Client(i, d, 2) for i, d in enumerate(data)],
                        device="cpu")
    plan = dict(drop_rate=0.25, late_rate=0.3, max_staleness=2, seed=5)
    jfp, tfp = JFaultPlan(K, R, **plan), FaultPlan(K, R, **plan)
    gp = np.random.default_rng(0).normal(size=jspace.n).astype(np.float32)
    n_steps = n_scalars = 0
    for r in range(R):
        jg = js.run_round(gp_vec=jnp.asarray(gp), faults=jfp.round_faults(r))
        tg = ts.run_round(gp_vec=torch.from_numpy(gp),
                          faults=tfp.round_faults(r))
        a, b = js.last_round_info, ts.last_round_info
        assert {k: v for k, v in a.items() if k != "arrived"} == \
            {k: v for k, v in b.items() if k != "arrived"}
        assert [x[:2] for x in a["arrived"]] == [x[:2] for x in b["arrived"]]
        for x, y in zip(a["arrived"], b["arrived"]):
            n_steps += grid_steps_apart(x[2], y[2])
        assert sorted(jg) == sorted(tg)
        for c in jg:
            n_steps += grid_steps_apart(jg[c], tg[c])
            n_scalars += tg[c].size
        assert (js.comm.up_bytes, js.comm.down_bytes) == \
            (ts.comm.up_bytes, ts.comm.down_bytes)
    assert sum(len(rf.drops) + len(rf.late) for rf in
               (tfp.round_faults(r) for r in range(R))) > 0
    assert n_steps <= 1 + n_scalars // 10  # the rest bit-equal
    for c in range(K):
        assert [e is None for e in js.gradip_log[c]] == \
            [e is None for e in ts.gradip_log[c]]
    np.testing.assert_allclose(
        flat(ts.params).numpy(),
        np.concatenate([np.asarray(x).ravel()
                        for x in jax.tree_util.tree_leaves(js.params)]),
        atol=PARAM_ATOL, rtol=0)
