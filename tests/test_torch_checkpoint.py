"""Checkpoints of the port (``repro_torch.checkpoint``) against the JAX
package's: the port's own MessagePack codec writes what ``msgpack.packb``
writes and reads what ``msgpack.unpackb`` reads; ``save_pytree`` files are
byte-identical to the JAX package's; a server snapshot written by either
package loads into the other, which saves it again byte for byte; every
corruption raises ``CheckpointError``; resume inside the port is bit-exact
(in process, through fault rounds and a kill, and across processes through
the train CLI)."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
msgpack = pytest.importorskip("msgpack")

import jax.numpy as jnp

import repro.core as JC
import repro_torch.core as TC
from repro.checkpoint import io as JIO
from repro.configs.base import FLConfig as JFL
from repro.configs.tiny import TINY as J_TINY
from repro.data.synthetic import make_task_fns as j_task_fns
from repro.fault import FaultPlan as JFaultPlan
from repro.models import Model as JModel
from repro_torch.checkpoint import _msgpack as M
from repro_torch.checkpoint.io import (FORMAT_VERSION, CheckpointError,
                                       load_manifest, load_pytree,
                                       save_pytree)
from repro_torch.checkpoint.state import FINAL_NAME, LATEST_NAME
from repro_torch.configs.base import FLConfig
from repro_torch.configs.tiny import TINY
from repro_torch.convert import params_from_numpy, space_from_numpy
from repro_torch.data import TaskSpec, make_task_fns, sample_dataset
from repro_torch.fault import FaultPlan, RoundFaults
from repro_torch.models import Model
from repro_torch.utils.tree import tree_leaves

REPO = os.path.join(os.path.dirname(__file__), "..")
SPEC = TaskSpec(vocab=min(TINY.vocab, 512))


# -- the codec ----------------------------------------------------------------

OBJS = [None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
        2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
        -2 ** 31, -2 ** 31 - 1, -2 ** 63, 1.5, -0.0, 1e300, float("inf"),
        "", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 65535,
        "f" * 65536, "é∑", b"", b"x" * 255, b"y" * 256, b"z" * 65536,
        bytearray(b"ab"), [], list(range(15)), list(range(16)),
        list(range(65536)), (1, "2"), {}, {str(i): i for i in range(15)},
        {str(i): [i] for i in range(16)}, {str(i): i for i in range(70000)},
        {1: 2, None: 3, "k": {"n": [None, 0.25]}}]


@pytest.mark.parametrize("obj", OBJS, ids=lambda o: repr(o)[:24])
def test_codec_writes_and_reads_what_msgpack_does(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    assert M.packb(obj) == want
    assert M.unpackb(want) == msgpack.unpackb(want, raw=False,
                                              strict_map_key=False)


def test_codec_reads_the_other_forms_and_refuses_bad_buffers():
    assert M.unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5
    ext = M.unpackb(msgpack.packb(msgpack.ExtType(5, b"abc")))
    assert (ext.code, ext.data) == (5, b"abc")
    view = M.unpackb(msgpack.packb(b"xyz"), zero_copy=True)
    assert isinstance(view, memoryview) and bytes(view) == b"xyz"
    blob = msgpack.packb({"a": [1, 2, b"q" * 300]})
    for bad in (blob[:-1], blob[:5], blob + b"\x00", b"\xc1", b"",
                msgpack.packb({"k": 1})[:-1], b"\xa2\xff\xfe"):
        with pytest.raises(M.UnpackError):
            M.unpackb(bad)
    with pytest.raises(M.UnpackError):  # an unhashable map key
        M.unpackb(b"\x81\x91\x01\x02")
    with pytest.raises(TypeError):
        M.packb(np.int64(3))
    with pytest.raises(OverflowError):
        M.packb(2 ** 64)


# -- save_pytree byte for byte ------------------------------------------------

def _mixed_trees():
    """A tree of f32, int32 and bf16 leaves, keys '2' and '10', lists,
    a 0-d leaf, a transposed leaf and one of 80 kB (bin 32); and a meta
    with str 16 strings and nested lists."""
    rng = np.random.default_rng(0)
    big = rng.normal(size=20000).astype(np.float32)
    w = rng.normal(size=(3, 4)).astype(np.float32)
    bf = rng.normal(size=(5,)).astype(np.float32)
    np_tree = {"w": w, "10": [np.arange(3, dtype=np.int32),
                              np.float32([1.5])], "2": big,
               "inner": {"n": np.asarray(7, np.int32)}, "t": w.T}
    jtree = jax.tree.map(jnp.asarray, np_tree)
    jtree["inner"]["b"] = jnp.asarray(bf).astype(jnp.bfloat16)
    ttree = jax.tree.map(torch.from_numpy, np_tree)
    ttree["t"] = torch.from_numpy(w).T
    ttree["inner"]["b"] = torch.from_numpy(bf).to(torch.bfloat16)
    meta = {"round": 3, "tag": "x" * 300, "f": 0.1, "l": [1, None, -5],
            "d": {"b": True, "10": "y" * 70000}}
    return jtree, ttree, meta


def test_save_pytree_files_identical(tmp_path):
    jtree, ttree, meta = _mixed_trees()
    JIO.save_pytree(str(tmp_path / "j"), jtree, meta)
    save_pytree(str(tmp_path / "t"), ttree, meta)
    a = (tmp_path / "j").read_bytes()
    assert a == (tmp_path / "t").read_bytes()
    assert b"\xc6" in a  # a bin 32 leaf
    # each package reads the other's file to the same values
    jmeta, jleaves = JIO.load_manifest(str(tmp_path / "t"))
    tmeta, tleaves = load_manifest(str(tmp_path / "j"))
    assert jmeta == tmeta == meta
    assert sorted(jleaves) == sorted(tleaves)
    for k, v in tleaves.items():
        want = np.asarray(jleaves[k])
        if v.dtype == torch.bfloat16:
            assert np.array_equal(v.view(torch.int16).numpy(),
                                  want.view(np.int16))
        else:
            assert np.array_equal(v.numpy(), want)
    out = load_pytree(str(tmp_path / "j"), ttree)
    for a_, b_ in zip(tree_leaves(ttree), tree_leaves(out)):
        assert a_.dtype == b_.dtype and torch.equal(a_, b_)


# -- server snapshots across the two packages ---------------------------------

@pytest.fixture(scope="module")
def pair():
    jm = JModel(J_TINY)
    jp = jm.init(jax.random.key(0))
    tm = Model(TINY, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jspace = JC.random_mask(jp, density=1e-2, seed=0, balanced=False)
    tspace = space_from_numpy(jax.tree.map(np.asarray, jspace.idx_tree),
                              device="cpu")
    jloss, _, _ = j_task_fns(jm, SPEC)
    tloss, _, _ = make_task_fns(tm, SPEC)
    return dict(jp=jp, tp=tp, jspace=jspace, tspace=tspace, jloss=jloss,
                tloss=tloss,
                gp=np.random.default_rng(0).normal(
                    size=jspace.n).astype(np.float32))


def _pair_servers(s, K=6):
    kw = dict(n_clients=K, local_steps=2, batch_size=2, sample_frac=0.5,
              quantize="int8", lr=5e-2, server_momentum=0.5,
              zo_backend="ref")
    data = [sample_dataset(SPEC, 8, seed=i) for i in range(K)]
    js = JC.FederatedZO(s["jloss"], s["jp"], s["jspace"], JFL(**kw),
                        [JC.Client(i, d, 2) for i, d in enumerate(data)])
    ts = TC.FederatedZO(s["tloss"], s["tp"], s["tspace"], FLConfig(**kw),
                        [TC.Client(i, d, 2) for i, d in enumerate(data)],
                        device="cpu")
    return js, ts


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_server_snapshot_crosses_packages_byte_for_byte(pair, tmp_path,
                                                        writer):
    """Two faulty sampled int8 rounds with GradIP and server momentum; the
    writer's snapshot loads into the other package's fresh server, which
    saves it again: the same bytes, stragglers in flight included."""
    s = pair
    js, ts = _pair_servers(s)
    K = len(ts.clients)
    plan = dict(drop_rate=0.2, late_rate=0.3, max_staleness=2, seed=5)
    src, dst = (ts, js) if writer == "torch" else (js, ts)
    fp = (FaultPlan if writer == "torch" else JFaultPlan)(K, 4, **plan)
    gp = (torch.from_numpy(s["gp"]) if writer == "torch"
          else jnp.asarray(s["gp"]))
    for r in range(2):
        src.run_round(gp_vec=gp, faults=fp.round_faults(r))
    assert src._pending, "a straggler must be in flight at the snapshot"
    first, second = str(tmp_path / "a.msgpack"), str(tmp_path / "b.msgpack")
    src.save_checkpoint(first)
    meta = dst.load_checkpoint(first)
    assert meta["round"] == 2 and dst.round == 2
    dst.save_checkpoint(second)
    assert open(first, "rb").read() == open(second, "rb").read()
    assert len(dst._pending) == len(src._pending)
    assert dst.sampler.state_dict() == src.sampler.state_dict()


# -- corruption: always CheckpointError ---------------------------------------

def _tree():
    return {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "inner": {"b": torch.ones(5, dtype=torch.bfloat16),
                      "n": torch.tensor(7, dtype=torch.int32)}}


def test_roundtrip_bitexact_meta_and_writable(tmp_path):
    path = str(tmp_path / "ckpt.msgpack")
    save_pytree(path, _tree(), metadata={"round": 3, "tag": "x"})
    meta, leaves = load_manifest(path)
    assert meta == {"round": 3, "tag": "x"}
    assert set(leaves) == {"['w']", "['inner']['b']", "['inner']['n']"}
    out = load_pytree(path, _tree())
    for a, b in zip(tree_leaves(_tree()), tree_leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    leaves["['w']"][0] = 1.0  # owned memory, not a view of the file


def test_corrupt_leaf_byte_fails_crc(tmp_path):
    path = str(tmp_path / "ckpt.msgpack")
    marker = np.full((64,), 0x5A5A5A5A, np.uint32)
    tree = {"w": marker, "ok": np.arange(3, dtype=np.int64)}
    save_pytree(path, tree)
    blob = bytearray(open(path, "rb").read())
    i = blob.find(marker.tobytes())
    assert i > 0
    blob[i + 17] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    with pytest.raises(CheckpointError, match="CRC32"):
        load_manifest(path)
    with pytest.raises(CheckpointError, match="CRC32"):
        load_pytree(path, tree)


@pytest.mark.parametrize("cut", [0.5, 0.99, 0.0])
def test_truncated_file(tmp_path, cut):
    path = str(tmp_path / "ckpt.msgpack")
    save_pytree(path, _tree())
    blob = open(path, "rb").read()
    open(path, "wb").write(blob[: int(len(blob) * cut)])
    with pytest.raises(CheckpointError, match="truncated or corrupt"):
        load_manifest(path)


def test_missing_file_version_and_manifest(tmp_path):
    with pytest.raises(CheckpointError, match="cannot read"):
        load_manifest(str(tmp_path / "nope.msgpack"))
    old = str(tmp_path / "old.msgpack")
    open(old, "wb").write(msgpack.packb(
        {"version": FORMAT_VERSION - 1, "meta": {}, "leaves": {}},
        use_bin_type=True))
    with pytest.raises(CheckpointError, match="format version"):
        load_manifest(old)
    junk = str(tmp_path / "junk.msgpack")
    open(junk, "wb").write(msgpack.packb([1, 2, 3]))
    with pytest.raises(CheckpointError, match="not a checkpoint"):
        load_manifest(junk)
    bad = str(tmp_path / "bad.msgpack")
    open(bad, "wb").write(msgpack.packb(
        {"version": FORMAT_VERSION, "meta": {},
         "leaves": {"['w']": {"dtype": "float32", "shape": [3],
                              "crc32": 0, "data": b""}}},
        use_bin_type=True))
    with pytest.raises(CheckpointError):
        load_manifest(bad)


def test_missing_leaf_and_shape_mismatch(tmp_path):
    path = str(tmp_path / "ckpt.msgpack")
    save_pytree(path, {"w": torch.zeros(2, 2)})
    with pytest.raises(CheckpointError, match="missing leaf"):
        load_pytree(path, {"w": torch.zeros(2, 2), "extra": torch.zeros(1)})
    with pytest.raises(CheckpointError, match="shape mismatch"):
        load_pytree(path, {"w": torch.zeros(4)})


def test_atomic_write_leaves_no_tmp(tmp_path):
    path = str(tmp_path / "ckpt.msgpack")
    save_pytree(path, _tree())
    save_pytree(path, _tree())
    assert os.listdir(tmp_path) == ["ckpt.msgpack"]


# -- resume inside the port ---------------------------------------------------

@pytest.fixture(scope="module")
def prob():
    model = Model(TINY, device="cpu")
    params = model.init(seed=0)
    loss, _, evaluate = make_task_fns(model, SPEC)
    space = TC.random_mask(params, density=1e-2, seed=0, balanced=False)
    return dict(params=params, loss=loss, evaluate=evaluate, space=space,
                gp=torch.full((space.n,), 0.01))


def mk_server(prob, momentum=0.5, n_clients=3, T=2):
    fl = FLConfig(n_clients=n_clients, local_steps=T, batch_size=2,
                  server_momentum=momentum, zo_backend="ref")
    clients = [TC.Client(i, sample_dataset(SPEC, 8, seed=i), 2)
               for i in range(n_clients)]
    return TC.FederatedZO(prob["loss"], prob["params"], prob["space"], fl,
                          clients, eval_fn=prob["evaluate"], device="cpu")


def assert_servers_equal(a, b):
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)
    assert (a.comm.up_bytes, a.comm.down_bytes) == \
        (b.comm.up_bytes, b.comm.down_bytes)
    assert a.round == b.round
    assert [c.ptr for c in a.clients] == [c.ptr for c in b.clients]
    assert a.early_stopped == b.early_stopped
    assert a.history == b.history
    for cid in a.gradip_log:
        ea, eb = a.gradip_log[cid], b.gradip_log[cid]
        assert len(ea) == len(eb)
        for u, v in zip(ea, eb):
            assert (u is None) == (v is None)
            assert u is None or np.array_equal(u, v)
    if a.velocity is None:
        assert b.velocity is None
    else:
        assert torch.equal(a.velocity, b.velocity)


def run_rounds(srv, n, prob, fault_plan=None):
    for _ in range(n):
        faults = (fault_plan.round_faults(srv.round)
                  if fault_plan is not None else None)
        srv.run_round(gp_vec=prob["gp"], faults=faults)


def test_resume_bitexact(prob, tmp_path):
    path = str(tmp_path / "ckpt.msgpack")
    ref = mk_server(prob)
    run_rounds(ref, 4, prob)
    donor = mk_server(prob)
    run_rounds(donor, 2, prob)
    donor.save_checkpoint(path)
    fresh = mk_server(prob)
    assert fresh.load_checkpoint(path)["round"] == 2
    run_rounds(fresh, 2, prob)
    assert_servers_equal(ref, fresh)


def test_resume_through_fault_rounds(prob, tmp_path):
    path = str(tmp_path / "ckpt.msgpack")
    plan = dict(drop_rate=0.2, late_rate=0.3, max_staleness=2, seed=5)
    ref = mk_server(prob, momentum=0.0)
    run_rounds(ref, 6, prob, FaultPlan(3, 6, **plan))
    donor = mk_server(prob, momentum=0.0)
    run_rounds(donor, 3, prob, FaultPlan(3, 6, **plan))
    donor.save_checkpoint(path)
    fresh = mk_server(prob, momentum=0.0)
    fresh.load_checkpoint(path)
    assert len(fresh._pending) == len(donor._pending)
    for p, q in zip(fresh._pending, donor._pending):
        assert (p["arrive"], p["cid"], p["src_round"], p["gip_idx"]) == \
            (q["arrive"], q["cid"], q["src_round"], q["gip_idx"])
        assert np.array_equal(p["gs"], q["gs"])
    run_rounds(fresh, 3, prob, FaultPlan(3, 6, **plan))
    assert_servers_equal(ref, fresh)


def test_kill_then_resume_from_latest(prob, tmp_path, monkeypatch):
    """``run`` with a checkpoint every round and a kill in round 2 (through
    a monkeypatched ``kill_now``): a fresh server restores ``ckpt_latest``
    and finishes bit-equal to the uninterrupted run, history included."""
    from repro_torch.fault import plan as fault_plan

    class Killed(Exception):
        pass

    def fake_kill():
        raise Killed

    monkeypatch.setattr(fault_plan, "kill_now", fake_kill)
    batch = sample_dataset(SPEC, 16, seed=9)
    plan = dict(drop_rate=0.2, late_rate=0.3, max_staleness=2, seed=1)
    ref = mk_server(prob)
    ref.run(4, eval_every=1, eval_batch=batch, gp_vec=prob["gp"],
            fault_plan=FaultPlan(3, 4, **plan))
    victim = mk_server(prob)
    d = str(tmp_path)
    with pytest.raises(Killed):
        victim.run(4, eval_every=1, eval_batch=batch, gp_vec=prob["gp"],
                   fault_plan=FaultPlan(3, 4, kill_rounds=(2,), **plan),
                   checkpoint_dir=d, checkpoint_every=1)
    assert victim.round == 2
    fresh = mk_server(prob)
    fresh.load_checkpoint(os.path.join(d, LATEST_NAME))
    fresh.run(2, eval_every=1, eval_batch=batch, gp_vec=prob["gp"],
              fault_plan=FaultPlan(3, 4, **plan))
    assert_servers_equal(ref, fresh)
    assert len(ref.history) == 4


def test_early_stop_flags_survive_resume(prob, tmp_path):
    path = str(tmp_path / "ckpt.msgpack")
    ref = mk_server(prob)
    ref.early_stopped = {1}
    run_rounds(ref, 3, prob)
    donor = mk_server(prob)
    donor.early_stopped = {1}
    run_rounds(donor, 1, prob)
    donor.save_checkpoint(path)
    fresh = mk_server(prob)
    fresh.load_checkpoint(path)
    assert fresh.early_stopped == {1}
    run_rounds(fresh, 2, prob)
    assert_servers_equal(ref, fresh)


def test_config_mismatch_refused(prob, tmp_path):
    path = str(tmp_path / "ckpt.msgpack")
    donor = mk_server(prob, T=2)
    donor.run_round(faults=RoundFaults())
    donor.save_checkpoint(path)
    with pytest.raises(CheckpointError, match="config mismatch"):
        mk_server(prob, T=3).load_checkpoint(path)
    with pytest.raises(CheckpointError, match="config mismatch"):
        mk_server(prob, n_clients=2).load_checkpoint(path)


# -- across processes: the train CLI killed and resumed -----------------------

def _drill_tool():
    """``tools/kill_recover_torch.py`` as a module (``tools`` is no
    package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "kill_recover_torch", os.path.join(REPO, "tools",
                                           "kill_recover_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_cli_kill_and_resume_bitexact(tmp_path):
    """The train CLI killed by SIGKILL mid-round 2 and resumed, through
    ``tools/kill_recover_torch.py``'s three runs: the victim dies by
    SIGKILL before a final checkpoint, the recovery resumes at round 2,
    and its final checkpoint equals the uninterrupted run's byte for
    byte."""
    KR = _drill_tool()
    a = KR.parser().parse_args([
        "--device", "cpu", "--method", "meerkat", "--rounds", "4", "--T",
        "2", "--clients", "4", "--batch", "4", "--eval-every", "2",
        "--sample-frac", "0.5", "--quantize", "int8", "--kill-at", "2"])
    checks = KR.drill(a, str(tmp_path), extra=(
        "--drop-rate", "0.2", "--late-rate", "0.3", "--fault-seed", "5"),
        timeout=300)
    assert checks["ref_completed"] and checks["recovery_completed"], checks
    assert checks["victim_sigkilled"], checks
    assert checks["victim_left_no_final"], checks
    assert checks["resumed_from_kill_round"], checks
    assert checks["files_bytes_equal"], checks
    assert KR.passed(checks), checks


def test_kill_recover_tool_flags_are_jax_plus_device():
    """The drill's flags are ``tools/kill_recover.py``'s plus ``--device``
    (read from both sources' argparse calls; nothing is run)."""
    import re

    def flags(name):
        src = open(os.path.join(REPO, "tools", name)).read()
        return set(re.findall(r'add_argument\(\s*"(--[A-Za-z0-9-]+)"', src))

    assert flags("kill_recover_torch.py") == \
        flags("kill_recover.py") | {"--device"}
    assert {a.option_strings[0] for a in _drill_tool().parser()._actions
            if a.option_strings[0] != "-h"} == \
        flags("kill_recover.py") | {"--device"}


def test_train_cli_mesh_and_tp_write_the_unsharded_checkpoint(tmp_path):
    """``--mesh`` runs (2 gloo ranks) and writes the unsharded run's final
    checkpoint byte for byte; so does its ``tp`` rule on a one-rank
    ``1x1`` mesh (tensor-parallel compute, ROADMAP A item 8).  The runs in
    this process take one thread, as each spawned rank does: more only
    contend with the suite's other workers."""
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train
    args = ["--device", "cpu", "--rounds", "2", "--T", "2", "--clients",
            "4", "--batch", "4", "--eval-every", "1", "--drop-rate", "0.2",
            "--late-rate", "0.3", "--fault-seed", "5", "--sample-frac",
            "0.5", "--quantize", "int8", "--checkpoint-dir"]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train.main(args + [str(tmp_path / "one")])
        train.main(args + [str(tmp_path / "mesh"), "--mesh", "1x2"])
        a = (tmp_path / "one" / FINAL_NAME).read_bytes()
        assert a == (tmp_path / "mesh" / FINAL_NAME).read_bytes()
        with M.process_group("cpu"):    # this process, the one rank of 1x1
            train.main(args + [str(tmp_path / "tp"), "--mesh", "1x1",
                               "--mesh-rule", "tp"])
        assert a == (tmp_path / "tp" / FINAL_NAME).read_bytes()
    finally:
        torch.set_num_threads(n)
