"""The port's serving engines against the JAX package's, on the CPU:
right-padded batches against single requests, the continuous-batching and
naive engines' tokens and decode-step counts against JAX's engines on the
same prompts (a tailed burst's final cache included), temperature sampling
(gumbel bits and sampled tokens), submit validation and the CLI."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs.paper_models import GEMMA2_2B as J_GEMMA
from repro.configs.paper_models import LLAMA32_1B as J_LLAMA
from repro.configs.paper_models import QWEN2_1_5B as J_QWEN
from repro.configs.tiny import TINY as J_TINY
from repro.models import Model as JModel
from repro.serving import ContinuousBatchingEngine as JEngine
from repro.serving import ServeEngine as JServe
from repro_torch.configs import GEMMA2_2B, LLAMA32_1B, TINY, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import prng
from repro_torch.models import Model
from repro_torch.serving import (ContinuousBatchingEngine, ServeEngine,
                                 generate)

CFGS = {"tiny": (J_TINY, "tiny"),
        "llama-reduced": (J_LLAMA.reduced(), "llama3.2-1b-reduced"),
        "qwen2-reduced": (J_QWEN.reduced(), "qwen2-1.5b-reduced"),
        "gemma2-reduced": (J_GEMMA.reduced(), "gemma2-2b-reduced")}


def _pair(name, seed=0):
    jcfg, tname = CFGS[name]
    jm = JModel(jcfg)
    params = jm.init(jax.random.key(seed))
    tm = Model(get_config(tname), device="cpu")
    return jm, params, tm, params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("name", list(CFGS))
def test_padded_batch_matches_single(name):
    """JAX test_continuous_batching.py::test_padded_batch_matches_single on
    the port: a mixed-length right-padded batch gives each request's tokens
    generated alone (prompts past the reduced gemma's window of 32)."""
    _, _, tm, tp = _pair(name)
    lens = [3, 37, 5]
    prompts = _prompts(tm.cfg.vocab, lens, 0)
    S_pad, new = 40, 4
    singles = [generate(tm, tp, {"tokens": p[None]}, new,
                        S_max=S_pad + new)[0] for p in prompts]
    toks = np.zeros((len(lens), S_pad), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    gen = generate(tm, tp, {"tokens": toks}, new, S_max=S_pad + new,
                   lengths=np.asarray(lens, np.int32))
    for i, want in enumerate(singles):
        assert torch.equal(gen[i], want), f"{name} row {i}"


@pytest.mark.parametrize("name", list(CFGS))
def test_continuous_engine_matches_jax(name):
    """More requests than slots, mixed lengths and budgets: the port's
    engine gives the JAX engine's tokens with the same number of decode
    steps; the last burst is tailed (slots retire mid-burst), and the final
    cache, retired rows included, matches JAX's."""
    jm, params, tm, tp = _pair(name)
    lens = [5, 11, 3, 14, 8, 2]
    news = [4, 7, 3, 5, 6, 4]
    prompts = _prompts(tm.cfg.vocab, lens, 1)
    kw = dict(max_slots=3, S_max=48, bucket=8)
    jeng = JEngine(jm, params, decode_backend="ref", **kw)
    teng = ContinuousBatchingEngine(tm, tp, **kw)
    for eng in (jeng, teng):
        for p, m in zip(prompts, news):
            eng.submit(p, max_new_tokens=m)
    jout, tout = jeng.run(), teng.run()
    assert len(tout) == len(lens)
    for i, (a, b) in enumerate(zip(tout, jout)):
        np.testing.assert_array_equal(a, b, err_msg=f"{name} req {i}")
        assert len(a) == news[i]
    assert teng.stats["decode_steps"] == jeng.stats["decode_steps"]
    assert teng.stats["decode_steps"] < 2 * max(news)
    assert teng.stats["completed"] == len(lens)
    # the compile cache counts JAX's keys: one per wave and per burst
    for k in ("compile_hits", "compile_misses"):
        assert teng.stats[k] == jeng.stats[k], k
    np.testing.assert_array_equal(teng.cache["pos"].numpy(),
                                  np.asarray(jeng.cache["pos"]))
    # 1e-6 of each leaf's largest entry for the 2-layer models (2.7e-7 to
    # 7.0e-7 seen); the reduced gemma's 4 layers reach 1.14e-6, so 2e-6
    rel = 2e-6 if name == "gemma2-reduced" else 1e-6
    for p in jeng.cache["stack"]:
        for leaf in ("k", "v"):
            want = np.asarray(jeng.cache["stack"][p][leaf])
            np.testing.assert_allclose(
                teng.cache["stack"][p][leaf].numpy(), want, rtol=0,
                atol=rel * float(np.abs(want).max()),
                err_msg=f"{name} {p}/{leaf}")


def test_engine_routes_agree():
    """decode_backend kernel and ref, and attn_backend kernel and dense,
    give the same tokens (gemma2: softcap, local/global caches)."""
    _, _, tm, tp = _pair("gemma2-reduced")
    prompts = _prompts(tm.cfg.vocab, (4, 39, 6), 5)
    outs = {}
    for dec, att in (("kernel", "kernel"), ("ref", "dense")):
        eng = ContinuousBatchingEngine(tm, tp, max_slots=2, S_max=56,
                                       bucket=8, decode_backend=dec,
                                       attn_backend=att)
        for p in prompts:
            eng.submit(p, max_new_tokens=5)
        outs[dec] = eng.run()
    for a, b in zip(outs["kernel"], outs["ref"]):
        np.testing.assert_array_equal(a, b)


def test_engine_second_pass_is_all_hits():
    """The same requests again on a drained engine take the same waves and
    bursts: every key hits the compile cache, and the tokens repeat."""
    tm = Model(TINY, device="cpu")
    eng = ContinuousBatchingEngine(tm, tm.init(0), max_slots=2, S_max=40,
                                   bucket=8)
    prompts = _prompts(TINY.vocab, (5, 12, 3), 8)
    outs = []
    for _ in range(2):
        for p, m in zip(prompts, (3, 6, 4)):
            eng.submit(p, max_new_tokens=m)
        outs.append(eng.run())
        if len(outs) == 1:
            first = dict(eng.stats)
    assert eng.stats["compile_misses"] == first["compile_misses"] > 0
    assert eng.stats["compile_hits"] == 2 * first["compile_hits"] + \
        first["compile_misses"]
    assert eng.compile_cache.n_entries == first["compile_misses"]
    assert not eng.graphs and eng.capture_s == {"prefill": 0.0,
                                                "decode": 0.0}
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        ContinuousBatchingEngine(tm, tm.init(0), graphs=True)


def test_naive_engine_matches_jax():
    jm, params, tm, tp = _pair("qwen2-reduced")
    prompts = _prompts(tm.cfg.vocab, (5, 8, 3, 6), 4)
    news = (4, 2, 3, 4)
    jeng, teng = JServe(jm, params, max_batch=3, bucket=8), \
        ServeEngine(tm, tp, max_batch=3, bucket=8)
    for eng in (jeng, teng):
        for p, m in zip(prompts, news):
            eng.submit(p, max_new_tokens=m)
    jout, tout = jeng.flush(), teng.flush()
    for i, (a, b) in enumerate(zip(tout, jout)):
        np.testing.assert_array_equal(a, b, err_msg=f"req {i}")
        assert len(a) == news[i]


def test_submit_validation():
    eng = ContinuousBatchingEngine(Model(TINY, device="cpu"),
                                   Model(TINY, device="cpu").init(0),
                                   max_slots=2, S_max=32)
    with pytest.raises(ValueError):
        eng.submit(np.arange(4, dtype=np.int32), max_new_tokens=0)
    with pytest.raises(ValueError):
        eng.submit(np.arange(40, dtype=np.int32), max_new_tokens=8)
    with pytest.raises(ValueError):
        ContinuousBatchingEngine(Model(TINY, device="cpu"),
                                 Model(TINY, device="cpu").init(0),
                                 decode_backend="pallas")


def test_gumbel_within_4_ulp_of_jax():
    """The uniforms are bit-equal; each of the two logs may land one ulp
    from XLA's.  -log(t) turns the inner log's one ulp of t into an
    absolute error of ~2^-23 (one ulp of 1) however small the result, so the
    bound is 4 ulp of max(|g|, 1)."""
    for seed in (0, 7, 2**31 + 5):
        want = np.asarray(jax.random.gumbel(jax.random.key(seed), (3, 4000)))
        got = prng.gumbel(prng.key(seed), (3, 4000)).numpy()
        ulp = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
        assert np.all(np.abs(got - want) <= 4 * ulp), seed
        u = prng.uniform(prng.key(seed), 12000, np.finfo(np.float32).tiny)
        np.testing.assert_array_equal(u.numpy(), np.asarray(jax.random.uniform(
            jax.random.key(seed), (12000,),
            minval=np.finfo(np.float32).tiny)))


def test_categorical_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 512)).astype(np.float32) * 2
    for seed in range(8):
        k = jax.random.split(jax.random.key(seed))[1]
        want = np.asarray(jax.random.categorical(k, jnp.asarray(logits)))
        tk = prng.split(prng.key(seed))[1]
        got = prng.categorical(tk, torch.tensor(logits)).numpy()
        np.testing.assert_array_equal(got, want)


def test_sampled_engine_and_generate_match_jax():
    """temperature > 0: the key ladder (one split per burst, one per step)
    and the Gumbel-max draws give JAX's tokens."""
    jm, params, tm, tp = _pair("tiny")
    prompts = _prompts(TINY.vocab, (5, 9, 3), 6)
    kw = dict(max_slots=2, S_max=32, bucket=8, temperature=0.8, seed=3)
    jeng = JEngine(jm, params, decode_backend="ref", **kw)
    teng = ContinuousBatchingEngine(tm, tp, **kw)
    for eng in (jeng, teng):
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
    for a, b in zip(teng.run(), jeng.run()):
        np.testing.assert_array_equal(a, b)
    for k in ("compile_hits", "compile_misses"):
        assert teng.stats[k] == jeng.stats[k], k
    from repro.serving import generate as jgenerate
    toks = np.stack([p[:3] for p in prompts])
    want = jgenerate(jm, params, {"tokens": jnp.asarray(toks)}, 5,
                     temperature=1.3, key=jax.random.key(4))
    got = generate(tm, tp, {"tokens": toks}, 5, temperature=1.3,
                   key=prng.key(4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_get_config_and_serve_cli(capsys):
    assert get_config("tiny") is TINY
    assert get_config("llama3.2-1b") is LLAMA32_1B
    assert get_config("gemma2-2b-reduced") == GEMMA2_2B.reduced()
    with pytest.raises(KeyError):
        get_config("mamba-7b")
    from repro_torch.launch import serve
    for extra in ([], ["--engine", "naive"], ["--backend", "ref"]):
        serve.main(["--device", "cpu", "--arch", "tiny", "--requests", "3",
                    "--max-new", "4", *extra])
    out = capsys.readouterr().out.splitlines()
    lines = [ln for ln in out if ln.startswith("req ")]
    assert len(lines) == 9
    # the continuous engine's summary counts its compile-cache misses
    assert sum("compiles=" in ln for ln in out) == 2
    # all three routes print the same tokens per request
    assert lines[:3] == lines[3:6] == lines[6:]
