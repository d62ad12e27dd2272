"""Hybrid and MoE serving, the port against repro on the CPU: the one-token
Mamba recurrence, right-padded prefill and decode of reduced Jamba
(attention without positions, Mamba caches, MoE), Phi-3.5-MoE and Kimi-K2
(shared experts) with every cache leaf against JAX's, inactive rows left
bit-equal, padded batches against single requests, the continuous engine
against JAX's, and per-row MoE capacity at decode.  Parameters cross
through ``convert.params_from_numpy``; inputs come from numpy seeds."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.models import Model as JModel
from repro.models import ssm as JSSM
from repro.models.transformer import ShardCtx
from repro.serving import ContinuousBatchingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import Model, ModelCtx
from repro_torch.models import ssm as SSM
from repro_torch.serving import ContinuousBatchingEngine, generate
from repro_torch.utils.tree import tree_map

# whole-model logits in f32 on two stacks of CPU kernels (XLA vs ATen), as
# tests/test_torch_model.py
ATOL = 1e-4
# a cache leaf against JAX's, of the leaf's largest entry: the states come
# out of sums taken in other orders (the selective scan serially here, as an
# associative scan there)
CACHE_REL = 1e-5
# one Mamba decode step: a few f32 products and sums apart
STEP_RTOL = 1e-5

JAMBA = "jamba-1.5-large-398b"
# reduced Jamba cut to one of each of its layer kinds, two periods: the
# JAX package compiles each scan body once, and a whole 8-layer period
# takes it tens of seconds
JAMBA_CUT = dict(n_layers=4, layer_pattern=(("attn", "dense"),
                                            ("mamba", "moe")))
NAMES = [JAMBA, "phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"]


def _cfgs(name, capacity_factor=None):
    """JAX's reduced config and the port's (Jamba cut to JAMBA_CUT), at
    ``capacity_factor`` when one is given."""
    j, t = j_get_config(name).reduced(), get_config(name + "-reduced")
    if name == JAMBA:
        j, t = j.replace(**JAMBA_CUT), t.replace(**JAMBA_CUT)
    if capacity_factor is not None:
        j, t = (c.replace(moe=dataclasses.replace(
            c.moe, capacity_factor=capacity_factor)) for c in (j, t))
    return j, t


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """These models are small and run chains of small ops (the sLSTM one
    position at a time): past two, torch's intra-op threads only contend,
    with each other and with the other test processes, so the module runs
    on two and gives the count back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _models(name, capacity_factor=None):
    """(JAX model, the port's model) of ``name``'s reduced config."""
    jcfg, tcfg = _cfgs(name, capacity_factor)
    return (JModel(jcfg, ShardCtx(attn_backend="dense", decode_backend="ref")),
            Model(tcfg, ModelCtx(decode_backend="kernel"), device="cpu"))


@functools.lru_cache(maxsize=None)
def _pair(name, seed=0):
    """(JAX model, its parameters, the port's model, the same parameters
    converted); the tests only read them."""
    jm, tm = _models(name)
    jp = jax.jit(jm.init)(jax.random.key(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _jitted(jm):
    """JAX's forward, loss, prefill and decode step, jitted: eager calls
    compile op by op, several times slower on the CPU."""
    return (jax.jit(jm.forward), jax.jit(jm.loss),
            jax.jit(jm.prefill, static_argnames="S_max"),
            jax.jit(jm.decode_step))


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flat_leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def _assert_cache_close(tc, jc, rel=CACHE_REL):
    """Positions equal; every leaf of every family within ``rel`` of its
    largest entry."""
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    got = dict(_flat_leaves(tc["stack"]))
    want = _flat_leaves(jax.tree.map(np.asarray, jc["stack"]))
    assert sorted(got) == [k for k, _ in want]
    for key, w in want:
        g = got[key]
        assert tuple(g.shape) == w.shape and str(g.dtype)[6:] == str(w.dtype), key
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=rel * max(float(np.abs(w).max()),
                                                  1e-30), err_msg=key)


def test_mamba_decode_matches_jax():
    """mamba_decode against JAX's on one reduced Jamba Mamba layer: a
    random conv buffer and state, three tokens in a row; out, buffer and
    state within STEP_RTOL of their largest entries."""
    jm, jp, _, _ = _pair(JAMBA)
    jcfg, tcfg = _cfgs(JAMBA)
    lp_np = jax.tree.map(lambda a: np.asarray(a)[0], jp["stack"]["p1"])
    lp = params_from_numpy(lp_np, device="cpu")
    rng = np.random.default_rng(3)
    E, N, K = 2 * jcfg.d_model, jcfg.ssm.d_state, jcfg.ssm.d_conv
    buf = rng.standard_normal((3, K - 1, E)).astype(np.float32)
    st = rng.standard_normal((3, E, N)).astype(np.float32)
    jbuf, jst, tbuf, tst = jnp.asarray(buf), jnp.asarray(st), \
        torch.tensor(buf), torch.tensor(st)
    j_decode = jax.jit(lambda x, p, b, s: JSSM.mamba_decode(x, p, jcfg.ssm,
                                                            b, s))
    for step in range(3):
        x1 = rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
        jo, jbuf, jst = j_decode(jnp.asarray(x1), lp_np, jbuf, jst)
        to, tbuf, tst = SSM.mamba_decode(torch.tensor(x1), lp, tcfg.ssm,
                                         tbuf, tst)
        for g, w in ((to, jo), (tbuf, jbuf), (tst, jst)):
            w = np.asarray(w)
            np.testing.assert_allclose(
                g.numpy(), w, rtol=0, atol=STEP_RTOL * float(np.abs(w).max()),
                err_msg=f"step {step}")


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_match_jax(name):
    """A right-padded prefill (rows of 1, 13 and the full 24 tokens), then
    two decode steps, the second with the middle row inactive: logits
    within ATOL, every cache leaf (k, v, conv, state) within CACHE_REL of
    JAX's; in the port the inactive row's every leaf and position stay
    bit-equal through the step."""
    jm, jp, tm, tp = _pair(name)
    S, S_max = 24, 32
    lens = np.array([1, 13, S], np.int32)
    toks = np.zeros((3, S), np.int32)
    for i, p in enumerate(_prompts(jm.cfg.vocab, lens, seed=1)):
        toks[i, :len(p)] = p
    _, _, j_prefill, j_decode = _jitted(jm)
    jl, jc = j_prefill(jp, {"tokens": jnp.asarray(toks)}, S_max=S_max,
                       lengths=jnp.asarray(lens))
    tl, tc = tm.prefill(tp, {"tokens": toks}, S_max=S_max, lengths=lens)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    _assert_cache_close(tc, jc)
    for active in (None, np.array([True, False, True])):
        nxt = np.asarray(jnp.argmax(jl, -1), np.int32)
        before = tree_map(torch.clone, tc)
        jl, jc = j_decode(jp, jnp.asarray(nxt), jc,
                          active=None if active is None
                          else jnp.asarray(active))
        tl, tc = tm.decode_step(tp, nxt, tc, active=active)
        live = slice(None) if active is None else active
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   atol=ATOL, rtol=0)
        _assert_cache_close(tc, jc)
        if active is not None:
            for (key, a), (_, b) in zip(_flat_leaves(before),
                                        _flat_leaves(tc)):
                row = (lambda t: t[1]) if key == "/pos" else \
                    (lambda t: t[:, 1])  # leaves are [n_periods, B, ...]
                assert torch.equal(row(a), row(b)), key


@pytest.mark.parametrize("name", NAMES)
def test_padded_batch_matches_single(name):
    """JAX test_continuous_batching.py::test_padded_batch_matches_single on
    the port: a right-padded batch (prompts of 3, 29 and 1 tokens) gives
    each request's greedy tokens generated alone."""
    _, _, tm, tp = _pair(name)
    prompts = _prompts(tm.cfg.vocab, [3, 29, 1], seed=2)
    S_pad, new = 32, 4
    singles = [generate(tm, tp, {"tokens": p[None]}, new,
                        S_max=S_pad + new)[0] for p in prompts]
    toks = np.zeros((3, S_pad), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    gen = generate(tm, tp, {"tokens": toks}, new, S_max=S_pad + new,
                   lengths=np.asarray([len(p) for p in prompts], np.int32))
    for i, want in enumerate(singles):
        assert torch.equal(gen[i], want), f"{name} row {i}"


@pytest.mark.parametrize("name", NAMES)
def test_continuous_engine_matches_jax(name):
    """Three requests through two slots (the third admitted mid-decode,
    the last burst tailed): the port's engine gives the JAX engine's tokens
    in the same number of decode steps, and the final cache, retired rows
    included, matches JAX's."""
    jm, jp, tm, tp = _pair(name)
    prompts = _prompts(tm.cfg.vocab, [5, 11, 3], seed=4)
    news = [2, 3, 2]
    kw = dict(max_slots=2, S_max=24, bucket=16)
    jeng = JEngine(jm, jp, decode_backend="ref", attn_backend="dense", **kw)
    teng = ContinuousBatchingEngine(tm, tp, **kw)
    for eng in (jeng, teng):
        for p, m in zip(prompts, news):
            eng.submit(p, max_new_tokens=m)
    jouts, touts = jeng.run(), teng.run()
    for a, b in zip(jouts, touts):
        np.testing.assert_array_equal(b, a)
    assert teng.stats["decode_steps"] == jeng.stats["decode_steps"]
    _assert_cache_close(teng.cache, jeng.cache)


def _dispatch_drops(cfg, tp, toks, lens, period):
    """Whether the MoE layer of ``period`` routes the padded batch's real
    tokens differently per row (the pad mask) than batch-globally (no
    mask): at a binding capacity the two drop different pairs, with room
    for every pair they agree."""
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    h = T.embed_input(tp, {"tokens": torch.tensor(toks)}, cfg)
    lp = tree_map(lambda a: a[0], tp["stack"])[period]
    valid = torch.tensor(np.arange(toks.shape[1])[None] < lens[:, None])
    y_row, _ = MOE.moe_dense_ref(h, lp, cfg.moe, cfg.act, valid=valid)
    y_all, _ = MOE.moe_dense_ref(h, lp, cfg.moe, cfg.act)
    return not torch.allclose(y_row[valid], y_all[valid])


def test_moe_capacity_bound_parity():
    """JAX test_continuous_batching.py::test_moe_capacity_bound_parity on
    the port, on reduced Jamba cut to JAMBA_CUT: at capacity_factor 1.0
    expert capacity binds, and a padded batch of a long and a short prompt
    still gives each one's tokens generated alone, in prefill and in
    batched decode.  The same padded prefill and two decode steps (the
    second with the short row inactive) match JAX's at that capacity:
    logits within ATOL, every cache leaf within CACHE_REL.  The check has
    teeth: the batch-global dispatch (no mask) of the same padded prompts
    routes differently, so pairs are dropped."""
    _, jp, _, tp = _pair(JAMBA)  # the capacity leaves the parameters as
    jm, tm = _models(JAMBA, capacity_factor=1.0)  # they are
    prompts = _prompts(tm.cfg.vocab, [3, 29], seed=0)
    singles = [generate(tm, tp, {"tokens": p[None]}, 4, S_max=40)[0]
               for p in prompts]
    toks = np.zeros((2, 32), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lens = np.asarray([3, 29], np.int32)
    gen = generate(tm, tp, {"tokens": toks}, 4, S_max=40, lengths=lens)
    for i, want in enumerate(singles):
        assert torch.equal(gen[i], want), f"row {i}"

    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    h = T.embed_input(tp, {"tokens": torch.tensor(toks)}, tm.cfg)
    lp = tree_map(lambda a: a[0], tp["stack"])["p1"]
    valid = torch.tensor(np.arange(32)[None] < lens[:, None])
    y_row, _ = MOE.moe_dense_ref(h, lp, tm.cfg.moe, tm.cfg.act, valid=valid)
    y_all, _ = MOE.moe_dense_ref(h, lp, tm.cfg.moe, tm.cfg.act)
    assert not torch.allclose(y_row[valid], y_all[valid])

    _, _, j_prefill, j_decode = _jitted(jm)
    jl, jc = j_prefill(jp, {"tokens": jnp.asarray(toks)}, S_max=40,
                       lengths=jnp.asarray(lens))
    tl, tc = tm.prefill(tp, {"tokens": toks}, S_max=40, lengths=lens)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    _assert_cache_close(tc, jc)
    # an all-True mask, not None, for the first step: one JAX compile
    for active in (np.array([True, True]), np.array([False, True])):
        nxt = np.asarray(jnp.argmax(jl, -1), np.int32)
        jl, jc = j_decode(jp, jnp.asarray(nxt), jc,
                          active=jnp.asarray(active))
        tl, tc = tm.decode_step(tp, nxt, tc, active=active)
        np.testing.assert_allclose(tl.numpy()[active],
                                   np.asarray(jl)[active], atol=ATOL, rtol=0)
        _assert_cache_close(tc, jc)


def test_mamba_prefill_routes_agree():
    """The prefill's Mamba state on the kernel route (the selective-scan
    kernel's plain version here, with dt zeroed past each row's length)
    against the scan route: conv buffers equal, states within CACHE_REL,
    for rows of length 1, ragged and the full bucket."""
    jcfg, tcfg = _cfgs(JAMBA)
    tp = Model(tcfg, device="cpu").init(seed=5)
    toks = np.random.default_rng(5).integers(0, tcfg.vocab, (3, 40)).astype(
        np.int32)
    lens = np.array([1, 17, 40], np.int32)
    caches = [Model(tcfg, ModelCtx(mamba_mode=mode), device="cpu").prefill(
        tp, {"tokens": toks}, S_max=48, lengths=lens)[1]
        for mode in ("kernel", "scan")]
    conv, state = ([c["stack"]["p1"][k] for c in caches]
                   for k in ("conv", "state"))
    # the first period's buffers hold the same inputs on both routes; the
    # second's come out of the first period's scan
    assert torch.equal(conv[0][0], conv[1][0])
    for a, b in (conv, state):
        assert float((a - b).abs().max()) <= CACHE_REL * float(b.abs().max())
    assert float(state[1][:, 0].abs().max()) > 0  # the length-1 row moved
