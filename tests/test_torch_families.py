"""The xLSTM, Whisper and Pixtral families, the port against repro on the
CPU: configs, init, forward and LM loss, the block-tiled mLSTM, prefill and
decode with every cache leaf (mLSTM C/n/m, sLSTM c/n/h/m, Whisper's
cross-attention k/v, Pixtral's patch prefix), inactive rows bit-equal,
padded batches against single requests, the continuous engine against
JAX's, one sparse ZO step, and the serve CLI.  Parameters cross through
``convert.params_from_numpy``; inputs (tokens, audio frames, patches) come
from numpy seeds."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

import repro.core as JC
import repro_torch.core as TC
from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.models import Model as JModel
from repro.models import xlstm as JXL
from repro.models.transformer import ShardCtx
from repro.serving import ContinuousBatchingEngine as JEngine
from repro_torch.configs import REGISTRY, get_config, list_archs
from repro_torch.configs import base as TB
from repro_torch.convert import params_from_numpy
from repro_torch.core import prng
from repro_torch.models import Model, ModelCtx, concrete_inputs
from repro_torch.models import xlstm as XL
from repro_torch.serving import ContinuousBatchingEngine, generate
from repro_torch.utils.tree import tree_flatten_with_keys, tree_map

# whole-model logits in f32 on two stacks of CPU kernels (XLA vs ATen), as
# tests/test_torch_model.py
ATOL = 1e-4
# a cache leaf against JAX's, of the leaf's largest entry
CACHE_REL = 1e-5
# one mLSTM block in f32: the same products summed in other orders
BLOCK_RTOL = 1e-5
# a ZO step's scalar: a loss difference over 2 eps = 2e-3, so each f32 ulp
# of a loss near 6.2 (4.8e-7) is 2.4e-4 of g; 8 such ulps (the xLSTM's
# recurrences sum in other orders through 16 layers)
G_ATOL = 2e-3

NAMES = ["xlstm-350m", "whisper-small", "pixtral-12b"]
_NESTED = {"moe": TB.MoEConfig, "ssm": TB.SSMConfig, "xlstm": TB.XLSTMConfig,
           "encoder": TB.EncoderConfig}


def _port_cfg(jcfg):
    """A JAX ModelConfig as the port's, field by field."""
    kw = {}
    for f in dataclasses.fields(jcfg):
        v = getattr(jcfg, f.name)
        if f.name in _NESTED and v is not None:
            v = _NESTED[f.name](**dataclasses.asdict(v))
        kw[f.name] = v
    return TB.ModelConfig(**kw)


# reduced xLSTM cut to one mLSTM and one sLSTM layer a period, two
# periods: the JAX package compiles each scan body anew per eager call, and
# the 7:1 period of eight layers takes it seconds each time
XLSTM_CUT = dict(n_layers=4, layer_pattern=(("mlstm", "none"),
                                            ("slstm", "none")))


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


@functools.lru_cache(maxsize=None)
def _pair(name, seed=0):
    """(JAX model, its parameters, the port's model, the same parameters
    converted); the tests only read them."""
    jcfg, tcfg = j_get_config(name + "-reduced"), get_config(name + "-reduced")
    if name == "xlstm-350m":
        jcfg, tcfg = jcfg.replace(**XLSTM_CUT), tcfg.replace(**XLSTM_CUT)
    jm = JModel(jcfg, ShardCtx(attn_backend="dense", decode_backend="ref"))
    jp = jax.jit(jm.init)(jax.random.key(seed))
    tm = Model(tcfg, ModelCtx(decode_backend="kernel"), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _jitted(jm):
    """JAX's forward, loss, prefill and decode step, jitted: eager calls
    compile op by op, several times slower on the CPU."""
    return (jax.jit(jm.forward), jax.jit(jm.loss),
            jax.jit(jm.prefill, static_argnames="S_max"),
            jax.jit(jm.decode_step))


def _batch(cfg, B, S, seed):
    """Tokens and the frontend stub's embeddings, from numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "audio_stub":
        out["audio_embeds"] = rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision_stub":
        out["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def _flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flat_leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def _assert_cache_close(tc, jc, rel=CACHE_REL):
    """Positions equal; every leaf within ``rel`` of its largest entry, the
    mLSTM's and sLSTM's ``m`` within ``rel`` of max(1, its largest entry):
    ``m`` is a log-space stabiliser, the states are scaled by exp(m), so an
    absolute error in m is a relative error of the state, and m comes out
    of sums of order 1 that cancel to a few hundredths."""
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    got = dict(_flat_leaves(tc["stack"]))
    want = _flat_leaves(jax.tree.map(np.asarray, jc["stack"]))
    assert sorted(got) == [k for k, _ in want]
    for key, w in want:
        g = got[key].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, key
        scale = float(np.abs(w).max())
        if key.endswith("/m"):
            scale = max(scale, 1.0)
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * scale,
                                   err_msg=key)


def test_configs_are_copies_of_jax():
    assert list_archs() == j_list_archs()
    for name in NAMES:
        assert REGISTRY[name] == _port_cfg(j_get_config(name)), name
        red = get_config(name + "-reduced")
        assert red == _port_cfg(j_get_config(name + "-reduced")), name
    assert get_config("pixtral-12b-reduced").n_patches == 8
    assert get_config("whisper-small-reduced").encoder.n_frames == 16


@pytest.mark.parametrize("name", NAMES)
def test_init_matches_jax_layout(name):
    """The port's own init has JAX's leaf paths and shapes (mLSTM/sLSTM
    leaves, no FFN where the pattern says none, the decoder's cross
    sub-tree and the encoder tree) and its constant leaves."""
    jm, jp, tm, tp = _pair(name)
    own = tm.init(seed=0)
    assert [(p, tuple(t.shape)) for p, t in tree_flatten_with_keys(own)[0]] \
        == [(jax.tree_util.keystr(p), tuple(l.shape)) for p, l in
            jax.tree_util.tree_flatten_with_path(jp)[0]]
    consts = {"xlstm-350m": [("p0", "b_f"), ("p0", "b_i"), ("p0", "gn_scale"),
                             ("p1", "b_gates")],
              "whisper-small": [("p0", "bias")],
              "pixtral-12b": []}[name]
    for p, leaf in consts:
        if leaf == "bias":
            want, got = jp["stack"][p]["cross"]["norm"]["bias"], \
                own["stack"][p]["cross"]["norm"]["bias"]
        else:
            want, got = jp["stack"][p][leaf], own["stack"][p][leaf]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", NAMES)
def test_forward_and_loss_match_jax(name):
    """Logits (Pixtral's over the tokens only) within ATOL and the LM loss
    on JAX's parameters."""
    jm, jp, tm, tp = _pair(name)
    batch = _batch(jm.cfg, 2, 20, seed=1)
    j_forward, j_loss, _, _ = _jitted(jm)
    jl, _ = j_forward(jp, batch)
    tl, _ = tm.forward(tp, batch)
    assert tuple(tl.shape) == (2, 20, jm.cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert float(tm.loss(tp, batch)) == pytest.approx(
        float(j_loss(jp, batch)), abs=ATOL)


@pytest.mark.parametrize("block", [0, 8])
def test_mlstm_matches_jax(block):
    """mlstm_forward whole and tiled in query blocks of 8 (S = 24), with
    its final state under a ragged ``valid``, against JAX's; and the tiled
    output against the whole one."""
    jm, jp, tm, tp = _pair("xlstm-350m")
    xc = jm.cfg.xlstm
    lp_np = jax.tree.map(lambda a: np.asarray(a)[0], jp["stack"]["p0"])
    lp = params_from_numpy(lp_np, device="cpu")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 24, jm.cfg.d_model)).astype(np.float32)
    valid = np.arange(24)[None] < np.array([[24], [11]])
    jy, jst = jax.jit(lambda x, p, v: JXL.mlstm_forward(
        x, p, xc, block=block, return_state=True, valid=v))(
            jnp.asarray(x), lp_np, jnp.asarray(valid))
    ty, tst = XL.mlstm_forward(torch.tensor(x), lp, tm.cfg.xlstm, block=block,
                               return_state=True, valid=torch.tensor(valid))
    for g, w in ((ty, jy),) + tuple(zip(tst, jst)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=BLOCK_RTOL * float(np.abs(w).max()))
    whole = XL.mlstm_forward(torch.tensor(x), lp, tm.cfg.xlstm)
    np.testing.assert_allclose(
        XL.mlstm_forward(torch.tensor(x), lp, tm.cfg.xlstm, block=block
                         ).numpy(), whole.numpy(), rtol=0,
        atol=BLOCK_RTOL * float(whole.abs().max()))


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_match_jax(name):
    """A right-padded prefill (rows of 1, 9 and the full 16 tokens; Pixtral
    behind its 8 patches, Whisper against 16 frames), then two decode
    steps, the second with the middle row inactive: logits within ATOL,
    every cache leaf within CACHE_REL of JAX's; in the port the inactive
    row's every leaf and position stay bit-equal through the step."""
    jm, jp, tm, tp = _pair(name)
    S = 16
    extra = jm.cfg.n_patches if jm.cfg.frontend == "vision_stub" else 0
    S_max = S + extra + 4
    lens = np.array([1, 9, S], np.int32)
    batch = _batch(jm.cfg, 3, S, seed=3)
    for i, n in enumerate(lens):
        batch["tokens"][i, n:] = 0
    _, _, j_prefill, j_decode = _jitted(jm)
    jl, jc = j_prefill(jp, jax.tree.map(jnp.asarray, batch), S_max=S_max,
                       lengths=jnp.asarray(lens))
    tl, tc = tm.prefill(tp, batch, S_max=S_max, lengths=lens)
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
def test_prefill_decode_matches_forward(name):
    """JAX tests/test_serve.py::test_prefill_decode_matches_forward on the
    port: prefill S-1 tokens and decode the last; both reproduce the
    training forward's last two logits (the frontend embeddings from
    ``concrete_inputs``)."""
    tm = Model(get_config(name + "-reduced"), device="cpu")
    tp = tm.init(seed=0)
    S = 12
    batch = concrete_inputs(tm.cfg, 2, S, device="cpu")
    full, _ = tm.forward(tp, batch)
    pre = dict(batch, tokens=batch["tokens"][:, :S - 1])
    extra = tm.cfg.n_patches if tm.cfg.frontend == "vision_stub" else 0
    lp, cache = tm.prefill(tp, pre, S_max=S + 4 + extra)
    pos = cache["pos"].clone()
    ld, cache = tm.decode_step(tp, batch["tokens"][:, S - 1], cache)
    torch.testing.assert_close(lp, full[:, S - 2], atol=ATOL, rtol=0)
    torch.testing.assert_close(ld, full[:, S - 1], atol=ATOL, rtol=0)
    assert torch.equal(cache["pos"], pos + 1)


@pytest.mark.parametrize("name", NAMES)
def test_padded_batch_matches_single(name):
    """A right-padded batch (prompts of 3, 21 and 1 tokens, zero frontend
    stubs as the engines give) gives each request's greedy tokens
    generated alone."""
    _, _, tm, tp = _pair(name)
    from repro_torch.serving.engine import _frontend_stub
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, tm.cfg.vocab, n).astype(np.int32)
               for n in (3, 21, 1)]
    S_pad, new = 24, 4
    singles = [generate(tm, tp, {"tokens": p[None],
                                 **_frontend_stub(tm.cfg, 1, "cpu")}, new)[0]
               for p in prompts]
    toks = np.zeros((3, S_pad), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    gen = generate(tm, tp, {"tokens": toks, **_frontend_stub(tm.cfg, 3,
                                                             "cpu")}, new,
                   lengths=np.asarray([len(p) for p in prompts], np.int32))
    for i, want in enumerate(singles):
        assert torch.equal(gen[i], want), f"{name} row {i}"


@pytest.mark.parametrize("name", NAMES)
def test_continuous_engine_matches_jax(name):
    """Three requests through two slots, the third admitted mid-decode,
    the last burst tailed: the port's engine gives the JAX engine's tokens
    in the same number of decode steps, and its final cache matches."""
    jm, jp, tm, tp = _pair(name)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tm.cfg.vocab, n).astype(np.int32)
               for n in (5, 11, 3)]
    news = [2, 3, 2]
    kw = dict(max_slots=2, S_max=32, bucket=16)
    jeng = JEngine(jm, jp, decode_backend="ref", attn_backend="dense", **kw)
    teng = ContinuousBatchingEngine(tm, tp, **kw)
    for eng in (jeng, teng):
        for p, m in zip(prompts, news):
            eng.submit(p, max_new_tokens=m)
    # the submit budget: S_max less the patch prefix and the new tokens
    probe = ContinuousBatchingEngine(tm, tp, **kw)
    room = 32 - (tm.cfg.n_patches if name == "pixtral-12b" else 0) - 1
    probe.submit(np.zeros(room, np.int32), max_new_tokens=1)
    with pytest.raises(ValueError):
        probe.submit(np.zeros(room + 1, np.int32), max_new_tokens=1)
    for a, b in zip(jeng.run(), teng.run()):
        np.testing.assert_array_equal(b, a)
    assert teng.stats["decode_steps"] == jeng.stats["decode_steps"]
    _assert_cache_close(teng.cache, jeng.cache)


@pytest.mark.parametrize("name", NAMES)
def test_zo_local_step_matches_jax(name):
    """JAX tests/test_models_smoke.py::test_zo_step_runs on the port: one
    sparse ZO step (random mask, density 1e-3, the same key) against
    JAX's: the same coordinates, the projected gradient within G_ATOL, the
    delta within lr * G_ATOL * |z|."""
    from repro.core.zo import local_step as j_local_step
    jm, jp, tm, tp = _pair(name, seed=1)
    batch = _batch(jm.cfg, 2, 8, seed=6)
    jspace = JC.random_mask(jp, density=1e-3, seed=0)
    tspace = TC.random_mask(tp, density=1e-3, seed=0)
    assert tspace.n == jspace.n
    jd, jg = jax.jit(lambda p, d, k, b: j_local_step(
        jm.loss, p, jspace, d, k, 1e-3, 1e-2, b))(
            jp, jnp.zeros((jspace.n,), jnp.float32), jax.random.key(2),
            jax.tree.map(jnp.asarray, batch))
    td, tg = TC.local_step(lambda p, b: tm.loss(p, b), tp, tspace,
                           torch.zeros(tspace.n), prng.key(2), 1e-3, 1e-2,
                           {k: torch.as_tensor(v) for k, v in batch.items()})
    assert float(tg) == pytest.approx(float(jg), abs=G_ATOL)
    # delta = -lr g z: the scalars' gap times |z|, z a few ulps apart
    lr, jd = 1e-2, np.asarray(jd)
    z_max = float(np.abs(jd).max()) / (lr * abs(float(jg)))
    np.testing.assert_allclose(td.numpy(), jd, rtol=0, atol=lr * z_max * (
        G_ATOL + 1e-5 * abs(float(jg))))


@pytest.mark.parametrize("arch", ["xlstm-350m", "whisper-small",
                                  "pixtral-12b", "jamba-1.5-large-398b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_serve_cli_serves_every_family(arch, capsys):
    """``launch.serve --arch`` serves the reduced hybrid, MoE, xLSTM,
    Whisper and Pixtral configs; the continuous engine and the naive one
    give the same tokens."""
    from repro_torch.launch import serve
    outs = []
    for engine in ("continuous", "naive"):
        serve.main(["--device", "cpu", "--arch", arch, "--engine", engine,
                    "--requests", "2", "--max-new", "3"])
        outs.append([ln for ln in capsys.readouterr().out.splitlines()
                     if ln.startswith("req ")])
    assert len(outs[0]) == 2 and outs[0] == outs[1]


@pytest.mark.parametrize("arch", ["whisper-small", "pixtral-12b"])
def test_train_cli_fails_where_jax_fails(arch):
    """``launch.train --arch`` on Whisper and Pixtral: their frontend
    embeddings are not in the synthetic task's batches, and the CLI fails
    with the JAX CLI's KeyError."""
    from repro_torch.launch import train
    with pytest.raises(KeyError, match="embeds"):
        train.main(["--device", "cpu", "--arch", arch, "--rounds", "1",
                    "--T", "1", "--clients", "2", "--method", "random"])
