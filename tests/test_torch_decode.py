"""The port's decode path against the JAX package's, on the CPU: the
flash-decode plain version and wrapper against the Pallas kernel (interpret
mode) and its jnp reference; ``decode_self_attention`` on both routes,
global and rolling; ``prefill`` and ``decode_step`` against ``forward`` and
against JAX's, caches included.  Inputs come from numpy seeds; parameters
and caches cross through ``convert``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs.paper_models import GEMMA2_2B as J_GEMMA
from repro.configs.paper_models import LLAMA32_1B as J_LLAMA
from repro.configs.paper_models import QWEN2_1_5B as J_QWEN
from repro.configs.tiny import TINY as J_TINY
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import Model as JModel
from repro.models import decode as JD
from repro.models import layers as JL
from repro.models.transformer import ShardCtx
from repro_torch.configs import get_config
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.kernels import ops, plans, ref
from repro_torch.models import Model, ModelCtx
from repro_torch.models import decode as D
from repro_torch.models import layers as L

# f32 on two stacks of CPU kernels (XLA vs ATen): summation order and
# transcendental ulps differ; 1e-5 relative holds for one attention call
RTOL = 1e-5
# whole-model logits of a 2-layer model: as tests/test_torch_model.py
ATOL = 1e-4

# (G, dh) of the paper's models' decode layouts and a G=1 layout
LAYOUTS = [(4, 64), (6, 128), (2, 256), (1, 64)]
# (S, lengths, softcap): ragged lengths with 1 and S, and gemma's softcap
VARIANTS = [(40, (40, 1, 17), 0.0), (77, (5, 77, 64), 50.0)]

CFGS = {"tiny": (J_TINY, "tiny"),
        "llama-reduced": (J_LLAMA.reduced(), "llama3.2-1b-reduced"),
        "qwen2-reduced": (J_QWEN.reduced(), "qwen2-1.5b-reduced"),
        "gemma2-reduced": (J_GEMMA.reduced(), "gemma2-2b-reduced")}


def _decode_inputs(B, S, KV, G, dh, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV, G, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("S,lengths,softcap", VARIANTS)
@pytest.mark.parametrize("G,dh", LAYOUTS)
def test_flash_decode_matches_jax(G, dh, S, lengths, softcap):
    q, k, v = _decode_inputs(len(lengths), S, 2, G, dh, seed=G * dh + S)
    L_np = np.asarray(lengths, np.int32)
    want_kernel = np.asarray(jops.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(L_np),
        softcap=softcap, interpret=True))
    want_ref = np.asarray(jref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(L_np),
        softcap=softcap))
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    got_plain = ref.decode_attention_ref(tq, tk, tv, torch.tensor(L_np),
                                         softcap).numpy()
    got_op = ops.flash_decode(tq, tk, tv, torch.tensor(L_np),
                              softcap=softcap).numpy()
    scale = np.abs(want_ref).max()
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got_plain, want, rtol=RTOL,
                                   atol=RTOL * scale)
    np.testing.assert_array_equal(got_op, got_plain)


def test_flash_decode_scalar_length_and_bf16():
    q, k, v = _decode_inputs(2, 33, 2, 4, 64, seed=7)
    want = np.asarray(jref.decode_attention_ref(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), 20).astype(jnp.float32))
    tq, tk, tv = (torch.tensor(a).to(torch.bfloat16) for a in (q, k, v))
    got = ops.flash_decode(tq, tk, tv, 20)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    # both round one f32 result to bf16: at most one bf16 ulp apart
    np.testing.assert_allclose(got.float().numpy(), want, rtol=8e-3,
                               atol=8e-3)


def test_flash_decode_length_zero_row_is_zero():
    """The port's own rule: a row with no live key is zeros (the JAX
    package averages V over the padded capacity there), and the other rows
    are untouched by it."""
    q, k, v = _decode_inputs(2, 24, 2, 2, 64, seed=3)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    out = ops.flash_decode(tq, tk, tv, torch.tensor([0, 24]))
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    alone = ops.flash_decode(tq[1:], tk[1:], tv[1:], 24)
    np.testing.assert_allclose(out[1].numpy(), alone[0].numpy(), rtol=RTOL,
                               atol=RTOL)


def _decode_in_cluster_order(q, k, v, lengths, softcap):
    """flash_decode in ``csrc/decode_attn.cu``'s order, in f32 torch ops:
    the cache cut into ``plans.decode_cluster(S)`` splits of ``chunk``
    positions (the blocks of one cluster); each split walks its live keys
    in tiles of 2048 // dh with the online softmax (running max, sum and
    unnormalised accumulator); the first block combines the live splits in
    split order; a row of length 0 is zeros."""
    B, KV, G, dh = q.shape
    S = k.shape[1]
    _, chunk = plans.decode_cluster(S)
    bk = 2048 // dh
    out = torch.zeros(B, KV, G, dh)
    for b in range(B):
        L = min(max(int(lengths[b]), 0), S)
        parts = []
        for k_begin in range(0, L, chunk):
            k_end = min(k_begin + chunk, L)
            m = torch.full((KV, G), -1e30)
            l = torch.zeros(KV, G)
            acc = torch.zeros(KV, G, dh)
            for k0 in range(k_begin, k_end, bk):
                kt, vt = k[b, k0:min(k0 + bk, k_end)], v[b, k0:min(k0 + bk,
                                                                    k_end)]
                s = torch.einsum("hgd,nhd->hgn", q[b], kt) * dh ** -0.5
                if softcap:
                    s = torch.tanh(s / softcap) * softcap
                m_new = torch.maximum(m, s.amax(-1))
                p = torch.exp(s - m_new[..., None])
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum("hgn,nhd->hgd",
                                                            p, vt)
                m = m_new
            parts.append((m, l, acc))
        if parts:
            M = torch.stack([m for m, _, _ in parts]).amax(0)
            num, den = torch.zeros(KV, G, dh), torch.zeros(KV, G)
            for m, l, acc in parts:
                w = torch.exp(m - M)
                den = den + l * w
                num = num + acc * w[..., None]
            out[b] = num / den[..., None]
    return out


# (S, lengths): 2 splits of 150 (lengths ending inside the first and the
# last); 3 of 234; 16 of 272 (Gemma-2's global cache, a full cluster)
@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("S,lengths", [(300, (0, 1, 151, 300)),
                                       (700, (700, 233, 0, 469)),
                                       (4352, (4352, 4333, 1, 0))])
def test_cluster_split_order_matches_pallas(S, lengths, softcap):
    """The decode kernel's order (``_decode_in_cluster_order``: the cluster
    split and the first block's combine) against the Pallas kernel
    (interpret mode) on every row with a live key, and zeros on a row of
    length 0 (the port's rule)."""
    G, dh = (4, 64) if S < 4000 else (2, 256)
    q, k, v = _decode_inputs(len(lengths), S, 2, G, dh, seed=S)
    L_np = np.asarray(lengths, np.int32)
    want = np.asarray(jops.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(L_np),
        softcap=softcap, interpret=True))
    got = _decode_in_cluster_order(*(torch.tensor(a) for a in (q, k, v)),
                                   lengths, softcap).numpy()
    live = L_np > 0
    np.testing.assert_allclose(got[live], want[live], rtol=RTOL,
                               atol=RTOL * np.abs(want[live]).max())
    assert not got[~live].any()
    assert plans.decode_cluster(S)[0] == {300: 2, 700: 3, 4352: 16}[S]


def test_lengths_pass_through_or_one_op():
    """The kernels' lengths: an int32 contiguous [B] tensor on the
    operands' device passes through untouched (the kernels clamp); other
    forms become [B] int32, host integers clamped to [0, S]."""
    q = torch.zeros(3, 2, 4, 64)
    L32 = torch.tensor([5, 0, 9], dtype=torch.int32)
    assert ops._lengths(L32, 3, 8, q) is L32
    for raw, want in ((None, [8, 8, 8]), (5, [5, 5, 5]), (-3, [0, 0, 0]),
                      (12, [8, 8, 8]), (torch.tensor(4), [4, 4, 4]),
                      (torch.tensor([1, 20, -2]), [1, 20, -2]),
                      (torch.tensor([[6]]), [6, 6, 6]), ([1, 2, 3], [1, 2, 3]),
                      (np.int64(7), [7, 7, 7]), (L32[::1].clone()[None],
                                                 [5, 0, 9])):
        got = ops._lengths(raw, 3, 8, q)
        assert got.dtype == torch.int32 and got.shape == (3,)
        assert got.tolist() == want


@pytest.mark.parametrize("length", [torch.tensor([40, -2, 77]), 100, -1,
                                    torch.tensor(55, dtype=torch.int64)])
def test_flash_decode_lengths_outside_the_cache_on_cpu(length):
    """int64, scalar, negative and > S lengths on the CPU route give the
    output of the lengths clamped to [0, S] (a row of length <= 0 is
    zeros), as before the kernels took the clamp over."""
    q, k, v = _decode_inputs(3, 40, 2, 4, 64, seed=11)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    clamped = torch.as_tensor(length).reshape(-1).expand(3).clamp(0, 40)
    got = ops.flash_decode(tq, tk, tv, length)
    assert torch.equal(got, ops.flash_decode(tq, tk, tv, clamped))
    assert torch.equal(got, ref.decode_attention_ref(tq, tk, tv, clamped))
    # the flash forward's lengths past S mask nothing, as S does
    qf, kf = torch.tensor(q[:2].reshape(2, 1, 8, 64)), \
        torch.tensor(k[:2, :1])
    assert torch.equal(ops.flash_attention(qf, kf, kf, 9),
                       ops.flash_attention(qf, kf, kf, None))


def test_flash_decode_rejects_bad_shapes():
    q = torch.zeros(2, 2, 4, 64)
    k = torch.zeros(2, 16, 2, 32)
    with pytest.raises(ValueError):
        ops.flash_decode(q, k, k, 16)


def test_decode_backend_resolution():
    cfg = get_config("llama3.2-1b")
    assert L.resolve_decode_backend("auto", cfg) == "kernel"
    assert L.resolve_decode_backend(None, cfg) == "kernel"
    assert L.resolve_decode_backend("ref", cfg) == "ref"
    assert L.resolve_decode_backend("auto", get_config("gemma2-2b")) \
        == "kernel"
    odd = cfg.replace(head_dim=96)
    assert L.resolve_decode_backend("auto", odd) == "ref"
    with pytest.raises(ValueError):
        L.resolve_decode_backend("pallas", cfg)


def _layer(jcfg, seed):
    """(JAX layer params, port layer params) of period 0, layer p0."""
    params = JModel(jcfg).init(jax.random.key(seed))
    lp = jax.tree.map(lambda a: np.asarray(a[0]), params["stack"]["p0"])
    return jax.tree.map(jnp.asarray, lp), params_from_numpy(lp, device="cpu")


@pytest.mark.parametrize("route", ["kernel", "ref"])
@pytest.mark.parametrize("local", [False, True])
def test_decode_self_attention_matches_jax(route, local):
    """One decode step of one layer from a filled cache, rows at their own
    positions (a rolling cache wrapped past W for the local layer): the
    output and the updated cache against JAX's on the same route."""
    jcfg = J_GEMMA.reduced()  # softcap, window 32, head_dim 64, G 2
    tcfg = get_config("gemma2-2b-reduced")
    jlp, tlp = _layer(jcfg, 1)
    B, W = 3, 32 if local else 48
    rng = np.random.default_rng(11)
    x1 = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((B, W, jcfg.n_kv_heads, 64)).astype(np.float32)
    cv = rng.standard_normal((B, W, jcfg.n_kv_heads, 64)).astype(np.float32)
    pos = np.array([0, 13, 45] if local else [0, 13, 47], np.int32)
    jctx = ShardCtx(decode_backend="pallas" if route == "kernel" else "ref")
    jout, jk, jv = JL.decode_self_attention(
        jnp.asarray(x1), jlp, jcfg, jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(pos), local=local, ctx=jctx)
    tk, tv = torch.tensor(ck), torch.tensor(cv)
    tout, tk2, tv2 = L.decode_self_attention(
        torch.tensor(x1), tlp, tcfg, tk, tv, torch.tensor(pos), local=local,
        ctx=ModelCtx(decode_backend=route))
    assert tk2 is tk and tv2 is tv  # updated in place
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=RTOL,
                               atol=RTOL * float(np.abs(jout).max()))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-6)


def test_decode_self_attention_inactive_rows_keep_cache():
    jcfg = J_TINY
    _, tlp = _layer(jcfg, 2)
    rng = np.random.default_rng(5)
    ck = torch.tensor(rng.standard_normal((2, 16, 2, 16)).astype(np.float32))
    cv = ck.clone() + 1
    before = ck.clone(), cv.clone()
    x1 = torch.tensor(rng.standard_normal((2, 1, 64)).astype(np.float32))
    L.decode_self_attention(x1, tlp, get_config("tiny"), ck, cv,
                            torch.tensor([3, 7]), local=False,
                            active=torch.tensor([False, True]))
    assert torch.equal(ck[0], before[0][0]) and torch.equal(cv[0],
                                                            before[1][0])
    assert not torch.equal(ck[1], before[0][1])


def _models(name, route="dense", decode="ref"):
    jcfg, tname = CFGS[name]
    jm = JModel(jcfg, ShardCtx(attn_backend="pallas" if route == "kernel"
                               else "dense",
                               decode_backend="pallas" if decode == "kernel"
                               else "ref"))
    params = jm.init(jax.random.key(0))
    tm = Model(get_config(tname), ModelCtx(attn_backend=route,
                                           decode_backend=decode),
               device="cpu")
    return jm, params, tm, params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")


@pytest.mark.parametrize("name", list(CFGS))
def test_prefill_decode_matches_forward(name):
    """JAX test_serve.py::test_prefill_decode_matches_forward, on the port:
    prefill of S-1 tokens and one decode step reproduce the training
    forward's logits, on both decode routes."""
    _, _, tm, tp = _models(name)
    S = 40  # past the reduced gemma's window of 32: a rolling local cache
    toks = np.random.default_rng(0).integers(
        0, tm.cfg.vocab, (2, S)).astype(np.int32)
    full, _ = tm.forward(tp, {"tokens": toks})
    for decode in ("kernel", "ref"):
        tm.ctx = ModelCtx(decode_backend=decode)
        lp, cache = tm.prefill(tp, {"tokens": toks[:, :S - 1]}, S_max=S + 4)
        pos = cache["pos"].clone()
        ld, cache2 = tm.decode_step(tp, toks[:, S - 1], cache)
        np.testing.assert_allclose(lp.numpy(), full[:, S - 2].numpy(),
                                   atol=2e-4)
        np.testing.assert_allclose(ld.numpy(), full[:, S - 1].numpy(),
                                   atol=2e-4)
        assert torch.equal(cache2["pos"], pos + 1)


@pytest.mark.parametrize("route", ["dense", "kernel"])
@pytest.mark.parametrize("name", list(CFGS))
def test_prefill_and_decode_match_jax(name, route):
    """Right-padded prefill with per-row lengths (rows longer than the
    reduced gemma's local window included), then two decode steps, the
    second with an inactive row: logits and every cache leaf against JAX's.
    The kernel route runs at S = 288, past the auto threshold."""
    jm, params, tm, tp = _models(name, route=route, decode="kernel")
    S = 288 if route == "kernel" else 48
    lens = np.array([S, 5, S - 9], np.int32)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jm.cfg.vocab, (3, S)).astype(np.int32)
    for i, n in enumerate(lens):
        toks[i, n:] = 0
    S_max = S + 8
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)}, S_max=S_max,
                        lengths=jnp.asarray(lens))
    tl, tc = tm.prefill(tp, {"tokens": toks}, S_max=S_max, lengths=lens)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    _assert_cache_close(tc, jc)
    nxt = np.asarray(jnp.argmax(jl, -1), np.int32)
    for active in (None, np.array([True, False, True])):
        jl, jc = jm.decode_step(params, jnp.asarray(nxt), jc,
                                active=None if active is None
                                else jnp.asarray(active))
        tl, tc = tm.decode_step(tp, nxt, tc, active=active)
        live = slice(None) if active is None else active
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   atol=ATOL)
        _assert_cache_close(tc, jc)
        nxt = np.asarray(jnp.argmax(jl, -1), np.int32)


def _assert_cache_close(tc, jc, rel=1e-4):
    """Positions equal; every k/v leaf within ``rel`` of its largest entry
    (keys and values of the second layer come out of the first layer's
    attention, summed in another order on each side: up to 1.3e-5 of the
    largest entry seen on the kernel route at S = 288)."""
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for p in jc["stack"]:
        for leaf in ("k", "v"):
            want = np.asarray(jc["stack"][p][leaf])
            np.testing.assert_allclose(
                tc["stack"][p][leaf].numpy(), want, rtol=0,
                atol=rel * float(np.abs(want).max()), err_msg=f"{p}/{leaf}")


def test_decode_from_a_jax_cache():
    """cache_from_numpy: both packages decode one step from the same JAX
    cache and agree."""
    jm, params, tm, tp = _models("gemma2-reduced", decode="kernel")
    toks = np.random.default_rng(2).integers(0, jm.cfg.vocab, (2, 37))
    _, jc = jm.prefill(params, {"tokens": jnp.asarray(toks, jnp.int32)},
                       S_max=44)
    tc = cache_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    nxt = np.array([3, 9], np.int32)
    jl, jc2 = jm.decode_step(params, jnp.asarray(nxt), jc)
    tl, tc2 = tm.decode_step(tp, nxt, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    _assert_cache_close(tc2, jc2)


def test_fill_attn_cache_rolling_matches_jax():
    rng = np.random.default_rng(4)
    k = rng.standard_normal((3, 20, 2, 8)).astype(np.float32)
    v = rng.standard_normal((3, 20, 2, 8)).astype(np.float32)
    lens = np.array([20, 3, 13], np.int32)
    for W, lengths in ((8, lens), (8, None), (24, lens)):
        jk, jv = JD._fill_attn_cache(jnp.asarray(k), jnp.asarray(v), W,
                                     None if lengths is None
                                     else jnp.asarray(lengths))
        dk, dv = torch.zeros(3, W, 2, 8), torch.zeros(3, W, 2, 8)
        D._fill_attn_cache(dk, dv, torch.tensor(k), torch.tensor(v),
                           None if lengths is None else torch.tensor(lengths))
        np.testing.assert_array_equal(dk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(dv.numpy(), np.asarray(jv))


def test_init_cache_layout_matches_jax():
    jcfg, tname = CFGS["gemma2-reduced"]
    jc = JD.init_cache(jcfg, 3, 40, dtype=jnp.float32)
    tc = D.init_cache(get_config(tname), 3, 40, dtype=torch.float32,
                      device="cpu")
    _assert_cache_close(tc, jc, rel=0)
    assert tc["pos"].dtype == torch.int32


def test_other_cache_families_raise():
    """Every family of the JAX package has its cache (a Mamba layer's
    conv buffer and state, as JAX's); a mixer no family has raises, as in
    the JAX package."""
    from repro.configs import get_config as j_get_config
    name = "jamba-1.5-large-398b-reduced"
    cfg = get_config(name)
    jc = JD.init_cache(j_get_config(name), 1, 8, dtype=jnp.float32)
    tc = D.init_cache(cfg, 1, 8, dtype=torch.float32, device="cpu")
    for leaf in ("conv", "state"):
        np.testing.assert_array_equal(tc["stack"]["p1"][leaf].numpy(),
                                      np.asarray(jc["stack"]["p1"][leaf]))
    with pytest.raises(ValueError):
        D.init_cache(cfg.replace(layer_pattern=(("rwkv", "dense"),)), 1, 8,
                     device="cpu")
