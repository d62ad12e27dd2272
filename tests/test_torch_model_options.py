"""The dense-decoder options and the configs that need them, the port
against repro on the CPU: qk-norm (qwen3), partial RoPE with QKV bias
(chatglm3), LayerNorm and MoE (phi-3.5-MoE), shared experts (kimi-k2),
softcaps and windows (gemma2-27b), QKV bias (qwen2-7b) and the plain GELU
MLP; the ``online`` attention route and the q-block-chunked dense route.
Parameters cross through ``convert.params_from_numpy``; inputs come from
numpy seeds."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.configs.tiny import TINY as J_TINY
from repro.models import Model as JModel
from repro.models import layers as JL
from repro.models.transformer import ShardCtx
from repro_torch.configs import REGISTRY, get_config, list_archs
from repro_torch.configs import base as TB
from repro_torch.configs.tiny import TINY
from repro_torch.convert import params_from_numpy
from repro_torch.models import Model, ModelCtx
from repro_torch.models import layers as L
from repro_torch.utils.tree import tree_flatten_with_keys

# logits of a 2-layer model in f32 on two stacks of CPU kernels (XLA vs
# ATen), as tests/test_torch_model.py
ATOL = 1e-4
# one attention call in f32: summation orders differ (tests/test_torch_decode)
ATTN_TOL = 1e-5
# a decode cache's k/v leaves against JAX's, relative to the leaf's largest
# entry (the second layer's keys come out of the first layer's attention)
CACHE_REL = 1e-5

NAMES = ["qwen3-4b", "chatglm3-6b", "phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b",
         "gemma2-27b", "qwen2-7b"]
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


def test_configs_are_copies_of_jax():
    for name in NAMES:
        assert REGISTRY[name] == _port_cfg(j_get_config(name)), name
        assert get_config(name + "-reduced") == _port_cfg(
            j_get_config(name + "-reduced"))
    assert set(NAMES) <= set(list_archs())


def _pair(jcfg, tcfg, seed=0, route="dense", q_block=0, decode="ref"):
    jm = JModel(jcfg, ShardCtx(attn_backend=route, attn_q_block=q_block,
                               decode_backend=decode))
    jp = jm.init(jax.random.key(seed))
    tm = Model(tcfg, ModelCtx(attn_backend=route, attn_q_block=q_block,
                              decode_backend="kernel"), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _tokens(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("name", NAMES)
def test_reduced_init_and_loss_match_jax(name):
    """The port's own init has JAX's leaf paths and shapes (q_norm/k_norm,
    LayerNorm's bias, shared experts, no w3 where the MLP is plain), and on
    JAX's parameters the logits and LM loss (MoE aux term included) agree
    on the dense route."""
    jcfg = j_get_config(name + "-reduced")
    tcfg = get_config(name + "-reduced")
    jm, jp, tm, tp = _pair(jcfg, tcfg)
    own = tm.init(seed=0)
    assert [(p, tuple(t.shape)) for p, t in tree_flatten_with_keys(own)[0]] \
        == [(jax.tree_util.keystr(p), tuple(l.shape)) for p, l in
            jax.tree_util.tree_flatten_with_path(jp)[0]]
    if tcfg.norm == "layernorm":
        assert torch.all(own["final_norm"]["scale"] == 1)
        assert not own["final_norm"]["bias"].any()
    batch = {"tokens": _tokens(jcfg.vocab, 2, 40, seed=1)}
    jl, _ = jm.forward(jp, batch)
    tl, _ = tm.forward(tp, batch)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert float(tm.loss(tp, batch)) == pytest.approx(
        float(jm.loss(jp, batch)), abs=ATOL)


def test_gelu_plain_matches_jax():
    """The plain (non-gated) GELU MLP has no w3; forward and loss agree."""
    jm, jp, tm, tp = _pair(J_TINY.replace(act="gelu_plain"),
                           TINY.replace(act="gelu_plain"))
    assert "w3" not in tp["stack"]["p0"]
    assert "w3" not in tm.init(seed=0)["stack"]["p0"]
    batch = {"tokens": _tokens(TINY.vocab, 2, 24, seed=2)}
    np.testing.assert_allclose(tm.forward(tp, batch)[0].numpy(),
                               np.asarray(jm.forward(jp, batch)[0]),
                               atol=ATOL, rtol=0)
    assert float(tm.loss(tp, batch)) == pytest.approx(
        float(jm.loss(jp, batch)), abs=ATOL)


@pytest.mark.parametrize("name", ["qwen3-4b", "chatglm3-6b"])
def test_prefill_and_decode_match_jax(name):
    """qk-norm and partial RoPE at serving: k goes into the cache normed
    and rotated.  A right-padded prefill, then 4 greedy decode steps (the
    port on its decode kernel's route, JAX on its jnp one): logits within
    ATOL, every cache leaf within CACHE_REL of its largest entry."""
    jm, jp, tm, tp = _pair(j_get_config(name + "-reduced"),
                           get_config(name + "-reduced"))
    S, S_max = 20, 32
    lens = np.array([S, 11], np.int32)
    toks = _tokens(jm.cfg.vocab, 2, S, seed=3)
    toks[1, lens[1]:] = 0
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, S_max=S_max,
                        lengths=jnp.asarray(lens))
    tl, tc = tm.prefill(tp, {"tokens": toks}, S_max=S_max, lengths=lens)
    for step in range(5):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0, err_msg=f"step {step}")
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        for p in jc["stack"]:
            for leaf in ("k", "v"):
                want = np.asarray(jc["stack"][p][leaf])
                np.testing.assert_allclose(
                    tc["stack"][p][leaf].numpy(), want, rtol=0,
                    atol=CACHE_REL * float(np.abs(want).max()),
                    err_msg=f"step {step} {p}/{leaf}")
        if step == 4:
            break
        nxt = np.asarray(jnp.argmax(jl, -1), np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc)
        tl, tc = tm.decode_step(tp, nxt, tc)


def test_partial_rope_rotates_the_leading_dims_only():
    """ChatGLM's partial RoPE against JAX's: the frequencies over the
    rotated dims (not head_dim), the odd remainder and the tail unchanged."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 3, 20)).astype(np.float32)
    pos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    for partial in (1.0, 0.5, 0.35):
        want = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                        10_000.0, partial))
        got = L.apply_rope(torch.tensor(x), torch.tensor(pos), 10_000.0,
                           partial).numpy()
        np.testing.assert_allclose(got, want, atol=ATTN_TOL, rtol=0)
        rot = int(20 * partial) - int(20 * partial) % 2
        np.testing.assert_array_equal(got[..., rot:], x[..., rot:])


def _attn_inputs(B, S, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    return q, k, v


# (S, window, softcap, lengths): S off every block multiple, with per-row
# lengths, a window and a softcap
ONLINE_CASES = [(77, 0, 0.0, None), (77, 24, 30.0, (77, 40)),
                (50, 16, 0.0, (13, 50))]


@pytest.mark.parametrize("S,window,cap,lens", ONLINE_CASES)
def test_online_attention_matches_jax(S, window, cap, lens, monkeypatch):
    """online_gqa_attention against JAX's (q tile 16, key block 32: padded
    to 96) within ATTN_TOL, and through forward_attention's online route
    (``attn_q_block`` 16, ``ONLINE_KV_BLOCK`` set to 32)."""
    q, k, v = _attn_inputs(2, S, 4, 2, 16, seed=S + window)
    jcfg, tcfg = J_TINY.replace(attn_softcap=cap), TINY.replace(
        attn_softcap=cap)
    L_np = None if lens is None else np.asarray(lens, np.int32)
    want = np.asarray(JL.online_gqa_attention(
        *map(jnp.asarray, (q, k, v)), jcfg, window=window, q_block=16,
        kv_block=32, lengths=None if L_np is None else jnp.asarray(L_np)))
    tq, tk, tv = map(torch.tensor, (q, k, v))
    tl = None if L_np is None else torch.tensor(L_np)
    got = L.online_gqa_attention(tq, tk, tv, tcfg, window=window, q_block=16,
                                 kv_block=32, lengths=tl)
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_TOL, rtol=0)
    monkeypatch.setattr(L, "ONLINE_KV_BLOCK", 32)
    routed = L.forward_attention(tq, tk, tv, tcfg,
                                 ModelCtx(attn_backend="online",
                                          attn_q_block=16),
                                 window=window, lengths=tl)
    assert torch.equal(routed, got)


@pytest.mark.parametrize("S,window,cap,lens", [(77, 24, 30.0, (77, 70)),
                                                (50, 16, 0.0, (50, 37))])
def test_online_attention_gradient_matches_dense(S, window, cap, lens,
                                                 monkeypatch):
    """The online route under autograd against the dense route's gradient
    (q, k and v) within ATOL.  Every query row keeps a key in its window:
    on a row with none the routes differ by design, in the JAX package
    too (the dense softmax averages the masked keys, online gives 0)."""
    q, k, v = _attn_inputs(2, S, 4, 2, 16, seed=S)
    w = torch.tensor(np.random.default_rng(S).standard_normal(
        (2, S, 4, 16)).astype(np.float32))
    cfg = TINY.replace(attn_softcap=cap)
    lengths = None if lens is None else torch.tensor(lens)
    monkeypatch.setattr(L, "ONLINE_KV_BLOCK", 32)
    grads = []
    for route in ("online", "dense"):
        ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        ctx = ModelCtx(attn_backend=route,
                       attn_q_block=16 if route == "online" else 0)
        out = L.forward_attention(*ts, cfg, ctx, window=window,
                                  lengths=lengths)
        grads.append(torch.autograd.grad((out * w).sum(), ts))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("window,lens", [(0, None), (24, (64, 29))])
def test_blocked_attention_matches_jax(window, lens):
    """The q-block-chunked dense route (blocks of 16 over S = 64) against
    JAX's within ATTN_TOL, and against the unchunked route."""
    q, k, v = _attn_inputs(2, 64, 4, 2, 16, seed=window)
    kv_mask = None
    if lens is not None:
        kv_mask = (np.arange(64)[None, :] < np.asarray(lens)[:, None])[
            :, None, :]
    want = np.asarray(JL.blocked_gqa_attention(
        *map(jnp.asarray, (q, k, v)), J_TINY, None, window=window,
        q_block=16, kv_mask=None if kv_mask is None else jnp.asarray(kv_mask)))
    tm = None if kv_mask is None else torch.tensor(kv_mask)
    tq, tk, tv = map(torch.tensor, (q, k, v))
    got = L.blocked_gqa_attention(tq, tk, tv, TINY, window=window,
                                  q_block=16, kv_mask=tm)
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_TOL, rtol=0)
    whole = L.blocked_gqa_attention(tq, tk, tv, TINY, window=window,
                                    q_block=0, kv_mask=tm)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=ATTN_TOL,
                               rtol=0)


@pytest.mark.parametrize("route,q_block", [("dense", 8), ("online", 0)])
def test_model_routes_match_jax(route, q_block):
    """The whole model on the chunked dense route (``attn_q_block`` 8 over
    S = 40, through _mixer_fwd's chunked path) and on the online route,
    against JAX's same routes: logits within ATOL."""
    jm, jp, tm, tp = _pair(j_get_config("chatglm3-6b-reduced"),
                           get_config("chatglm3-6b-reduced"), route=route,
                           q_block=q_block)
    batch = {"tokens": _tokens(jm.cfg.vocab, 2, 40, seed=5)}
    np.testing.assert_allclose(tm.forward(tp, batch)[0].numpy(),
                               np.asarray(jm.forward(jp, batch)[0]),
                               atol=ATOL, rtol=0)


def test_serve_cli_takes_the_new_configs(capsys):
    """``launch.serve --arch`` serves the reduced qk-norm and partial-RoPE
    configs; the continuous engine and the naive one give the same
    tokens."""
    from repro_torch.launch import serve
    for arch in ("qwen3-4b", "chatglm3-6b"):
        outs = []
        for engine in ("continuous", "naive"):
            serve.main(["--device", "cpu", "--arch", arch, "--engine", engine,
                        "--requests", "2", "--max-new", "3"])
            outs.append([ln for ln in capsys.readouterr().out.splitlines()
                         if ln.startswith("req ")])
        assert len(outs[0]) == 2 and outs[0] == outs[1]
