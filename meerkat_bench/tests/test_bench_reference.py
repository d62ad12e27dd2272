"""The plain reference held to ``repro_torch`` on the CPU at reduced sizes:
the decoder's hidden states, losses and served logits (Qwen2's full RoPE
and tied embeddings, ChatGLM3's half-head RoPE and untied head, both with
QKV bias and two KV groups), the frozen seed ladder and int8 codec, the
mask, and whole federated rounds with and without the sampler and the
codec."""
import numpy as np
import pytest
import torch

from meerkat_bench import weights
from meerkat_bench.reference import codec, dense_decoder, meerkat, prng
from meerkat_bench.tests import tiny
from meerkat_bench.traffic import fl as fl_traffic

MODELS = {"qwen2": tiny.MODEL, "chatglm3": tiny.GLM}


def _program(m):
    from repro_torch.configs import ModelConfig
    from repro_torch.models import Model
    return Model(ModelConfig(name="t", family="dense", **m), device="cpu")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_weights_fit_the_program_tree(name):
    from repro_torch.models.init import abstract_params
    from repro_torch.utils.tree import tree_flatten_with_keys
    m = MODELS[name]
    w = weights.make(m, 5, "cpu")
    ours = [(p, tuple(t.shape)) for p, t in tree_flatten_with_keys(w)[0]]
    want = [(p, tuple(t.shape)) for p, t in tree_flatten_with_keys(
        abstract_params(_program(m).cfg))[0]]
    assert ours == want
    assert weights.n_params(m) == _program(m).n_params


@pytest.mark.parametrize("name", sorted(MODELS))
def test_lm_loss_and_logits_match_the_program(name):
    m = MODELS[name]
    w = weights.make(m, 11, "cpu")
    model = _program(m)
    toks = torch.randint(0, m["vocab"], (2, 40), generator=torch.Generator()
                         .manual_seed(0))
    got = model.loss(w, {"tokens": toks})
    want = dense_decoder.lm_loss(w, m, toks)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    lg, _ = model.forward(w, {"tokens": toks})
    ref = dense_decoder.served_logits(w, m, toks[1], 7, block=16)
    torch.testing.assert_close(lg[1, 7:], ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_task_loss_matches_the_program(name):
    from repro_torch.data import TaskSpec, make_task_fns
    m = MODELS[name]
    w = weights.make(m, 2, "cpu")
    task = {"vocab": 256, "n_classes": 4, "seq_len": 24, "topic_tokens": 8,
            "noise": 0.25, "class_vocab_seed": 0}
    batch = fl_traffic.sample(task, 6, seed=9)
    loss, _, _ = make_task_fns(_program(m), TaskSpec(vocab=256,
                                                     seq_len=24))
    got, want = loss(w, batch), dense_decoder.task_loss(w, m, batch, 4)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


def test_served_tokens_are_the_references_argmax():
    """The engine's greedy tokens on the CPU: the reference's gap is 0."""
    from repro_torch.serving.engine import ContinuousBatchingEngine
    m = tiny.GLM
    w = weights.make(m, 4, "cpu")
    eng = ContinuousBatchingEngine(_program(m), w, max_slots=2, S_max=64,
                                   bucket=16)
    prompt = np.arange(5, 30, dtype=np.int32)
    eng.submit(prompt, 12)
    out = eng.run()[0]
    seq = torch.as_tensor(np.concatenate([prompt, out[:-1]]))
    lg = dense_decoder.served_logits(w, m, seq, len(prompt) - 1)
    assert torch.equal(lg.argmax(-1), torch.as_tensor(out, dtype=torch.long))


def test_seed_ladder_is_the_programs_bit_for_bit():
    from repro_torch.core import prng as P
    from repro_torch.core.seeds import round_keys
    for seed, r, T in ((0, 0, 1), (2**31 - 1, 7, 3), (12345, -1, 4)):
        a = meerkat.round_keys(seed, r, T)
        b = round_keys(seed, r, T)
        assert torch.equal(a, b)
        for k in a:
            assert torch.equal(prng.normal(k, 1000), P.normal(k, 1000))
            assert torch.equal(prng.uniform(k, 100), P.uniform(k, 100))


def test_int8_codec_is_the_programs():
    from repro_torch.core.quantize import (QUANT_FOLD, IntCodec,
                                           quantize_roundtrip)
    rng = np.random.default_rng(0)
    g = (rng.standard_normal(64) * 10.0 ** rng.integers(-6, 3, 64)) \
        .astype(np.float32)
    g[:3] = [0.0, 1e-30, -3.0]
    key = prng.key(77)
    for x in g:
        xt = torch.tensor([x])
        want = quantize_roundtrip(xt, prng.fold_in(key, QUANT_FOLD), 8)
        assert torch.equal(codec.roundtrip(xt, key, 8)[0], want)
    c = IntCodec(8)
    assert np.array_equal(codec.wire_nearest(g), c.decode(c.encode(g)))
    assert codec.QUANT_FOLD == QUANT_FOLD


def test_mask_matches_the_programs_sensitivity_mask():
    from repro_torch.core import sensitivity_mask
    from repro_torch.utils.tree import tree_leaves
    m = tiny.MODEL
    w = weights.make(m, 8, "cpu")
    task = {"vocab": 512, "n_classes": 4, "seq_len": 32, "topic_tokens": 24,
            "noise": 0.25, "class_vocab_seed": 0}
    pre = fl_traffic.pretrain(task, 2, 2, seed=3)
    model = _program(m)
    space = sensitivity_mask(lambda p, b: model.loss(p, b), w, pre,
                             density=0.01, device="cpu")
    sq, _ = meerkat.sensitivity(w, m, pre, dense_decoder.lm_loss)
    own = meerkat.topk_mask(sq, 0.01)
    sizes = [t.numel() for t in tree_leaves(w)]
    idx = [i for i in tree_leaves(space.idx_tree)]
    assert meerkat.mask_miss(idx, own, sizes) <= 1e-3
    assert sum(i.numel() for i in own) == space.n


def test_cohorts_are_the_samplers():
    from repro_torch.core import ClientSampler
    s = ClientSampler(list(range(64)), frac=0.25, seed=99)
    ours = meerkat.cohorts(64, 0.25, 99)
    for r in range(5):
        assert list(s.cohort(r)) == next(ours)


@pytest.mark.parametrize("cell", ["tiny-dense.fl", "tiny-dense.fleet"])
def test_reference_rounds_match_the_program(tmp_path, cell):
    """Whole rounds on the CPU (GradIP and all clients; the sampler and the
    int8 codec): every compared number far under its limit."""
    root = tiny.make_root(tmp_path)
    out = tiny.run_tiny(root, cell, seconds=0.2)
    assert out["correct"], out["compared"]
    for name, c in out["compared"].items():
        assert c["value"] <= 1e-5, (name, c)
