"""The train burst's stacked (w+, w-) forward (``core/fl_step.py``,
``stack_forwards``) against the JAX package's ``jax.vmap`` route, and the
vmap rules of the two kernel wrappers a forward reaches (``kernels/ops.py``:
the flash forward and the selective scan), on the CPU at TINY and reduced
sizes.  Parameters cross through ``convert.params_from_numpy``; tokens and
frontend embeddings come from numpy seeds."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.configs.tiny import TINY as J_TINY
from repro.core import fl_step as JF
from repro.core import random_mask as j_random_mask
from repro.core.dispatch import get_backing as j_get_backing
from repro.models import Model as JModel
from repro.models.transformer import ShardCtx
from repro_torch.configs import get_config
from repro_torch.configs.tiny import TINY
from repro_torch.convert import params_from_numpy, space_from_numpy
from repro_torch.core import fl_step as TF
from repro_torch.core import prng
from repro_torch.core.dispatch import get_backing
from repro_torch.kernels import ops
from repro_torch.models import Model, ModelCtx
from repro_torch.utils.tree import tree_leaves, tree_map

# tests/test_torch_fl_step.py's tolerances: the scalars g = (l+ - l-) / 2
# eps scale a loss ulp (4.8e-7 at TINY's ~6.2) by 500; parameters move by
# lr * g * z a step
G_ATOL = 2e-3
PARAM_ATOL = 1e-4
LOSS_RTOL = 1e-5
EPS, LR, K, B, S, N_STEPS = 1e-3, 1e-2, 2, 2, 16, 3
ROUTES = (("ref", "ref"), ("pallas", "kernel"))
# one family's vmapped loss pair against its two losses in sequence: the
# same ops at twice the batch, whose CPU GEMMs may block the rows otherwise
# (1.6e-7 of the loss seen at S = 256)
PAIR_RTOL = 1e-6
# the hybrid's loop against JAX's: tests/test_torch_hybrid.py's slice bound
HYBRID_G_ATOL = 5e-4
# reduced Jamba cut to one (attention, dense) and one (Mamba, MoE) layer
JAMBA_CUT = dict(n_layers=2, layer_pattern=(("attn", "dense"),
                                            ("mamba", "moe")))
XLSTM_CUT = dict(n_layers=2, layer_pattern=(("mlstm", "none"),
                                            ("slstm", "none")))
FAMILIES = ("llama3.2-1b", "phi3.5-moe-42b-a6.6b", "jamba-1.5-large-398b",
            "xlstm-350m", "whisper-small", "pixtral-12b")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small models and chains of small ops: past two, torch's intra-op
    threads only contend with each other and with the suite's other
    workers, so the module runs on two and gives the count back after."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jm = JModel(J_TINY)
    jp = jm.init(jax.random.key(0))
    tm = Model(TINY, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jspace = j_random_mask(jp, density=1e-2, seed=3, balanced=False)
    tspace = space_from_numpy(jax.tree.map(np.asarray, jspace.idx_tree),
                              device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, TINY.vocab, size=(N_STEPS, K * B, S),
                          dtype=np.int32)
    masks = np.array([[1, 0], [0, 0], [1, 1]], np.float32)
    return dict(jm=jm, jp=jp, tm=tm, tp=tp, jspace=jspace, tspace=tspace,
                tokens=tokens, masks=masks)


def _close_params(tp, jp, atol):
    for t, j in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=atol)


# ------------------------------------------------------------ the pick ----
class _Backing:
    def __init__(self, n_flat):
        self.n_flat = n_flat


def test_auto_pick_equals_jax(setup):
    """The constant, and the pick at sizes around it and at TINY's flat
    size (both packages' backings), equal the JAX package's rule
    (``backing.n_flat <= STACK_FORWARDS_MAX_PARAMS`` where None)."""
    assert TF.STACK_FORWARDS_MAX_PARAMS == JF.STACK_FORWARDS_MAX_PARAMS
    for n in (1, 2 ** 20 - 1, 2 ** 20, 2 ** 20 + 1, 1_235_814_400):
        b = _Backing(n)
        assert TF.stacks_forwards(None, b) == \
            (n <= JF.STACK_FORWARDS_MAX_PARAMS)
        assert TF.stacks_forwards(True, b) and not \
            TF.stacks_forwards(False, b)
    tb = get_backing(setup["tspace"], setup["tp"])
    jb = j_get_backing(setup["jspace"], setup["jp"])
    assert tb.n_flat == jb.n_flat
    assert TF.stacks_forwards(None, tb) == \
        (jb.n_flat <= JF.STACK_FORWARDS_MAX_PARAMS) is True


# ------------------------------------------------- the loop against JAX ----
@pytest.mark.parametrize("stack", [True, None])
@pytest.mark.parametrize("jbe,tbe", ROUTES)
@pytest.mark.parametrize("masked", [False, True])
def test_stacked_loop_matches_jax(setup, stack, jbe, tbe, masked):
    """``make_fl_train_loop`` with ``stack_forwards`` True and None against
    JAX's loop with the same flag: on the kernel route both stack (TINY is
    under the constant), on the ref route neither does."""
    s = setup
    kw = dict(eps=EPS, lr=LR, n_clients=K, n_steps=N_STEPS,
              stack_forwards=stack)
    jloop = JF.make_fl_train_loop(lambda p, b: s["jm"].loss(
        p, b, per_example=True), s["jspace"], backend=jbe, **kw)
    tloop = TF.make_fl_train_loop(lambda p, b: s["tm"].loss(
        p, b, per_example=True), s["tspace"], backend=tbe, **kw)
    jargs = [s["jp"], jax.random.key(7), {"tokens": jnp.asarray(s["tokens"])}]
    targs = [s["tp"], prng.key(7), {"tokens": torch.as_tensor(s["tokens"])}]
    if masked:
        jargs.append(jnp.asarray(s["masks"]))
        targs.append(torch.as_tensor(s["masks"]))
    jp2, jgs, jmet = jloop(*jargs)
    tp2, tgs, tmet = tloop(*targs)
    assert tgs.shape == (N_STEPS, K)
    np.testing.assert_allclose(tgs.numpy(), np.asarray(jgs), atol=G_ATOL)
    np.testing.assert_allclose(float(tmet["g"]), float(jmet["g"]),
                               atol=G_ATOL)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=LOSS_RTOL)
    _close_params(tp2, jp2, N_STEPS * PARAM_ATOL)


def test_stacked_step_runs_one_dual_perturb_into_the_pair(setup,
                                                           monkeypatch):
    """The stacked body writes w+ and w- into the two rows of one [2,
    n_pad] buffer (``out=``) and runs one vmapped forward: the loss sees a
    stacked tree, never two calls."""
    s = setup
    seen, outs = [], []
    real = TF.zo_dual_perturb_flat

    def spy(*a, **k):
        outs.append(k.get("out"))
        return real(*a, **k)

    def loss(p, b):
        seen.append(torch._C._functorch.is_batchedtensor(p["embed"]))
        return s["tm"].loss(p, b, per_example=True)

    monkeypatch.setattr(TF, "zo_dual_perturb_flat", spy)
    loop = TF.make_fl_train_loop(loss, s["tspace"], eps=EPS, lr=LR,
                                 n_clients=K, n_steps=2, backend="kernel")
    loop(s["tp"], prng.key(7), {"tokens": torch.as_tensor(s["tokens"][:2])})
    assert seen == [True, True]
    n_pad = get_backing(s["tspace"], s["tp"]).n_pad
    assert [tuple(o.shape) for o in outs] == [(2, n_pad)] * 2


def test_tp_route_raises_on_stacking(setup):
    """DTensor parameters (``rule="tp"``) cannot run a forward under
    ``torch.func.vmap``: stacking raises ValueError naming the route
    (ROADMAP C9), on a one-rank 1x1 mesh; the sequential forwards run."""
    from repro_torch.launch import mesh as M
    from repro_torch.sharding.fl import make_fl_plan
    s = setup
    with M.process_group("cpu"):
        plan = make_fl_plan(spec="1x1", rule="tp")
        batches = {"tokens": torch.as_tensor(s["tokens"][:1])}
        for stack in (True, None):
            loop = TF.make_fl_train_loop(
                lambda p, b: s["tm"].loss(p, b, per_example=True),
                s["tspace"], eps=EPS, lr=LR, n_clients=K, n_steps=1,
                stack_forwards=stack,
                constrain_params=plan.constrain_params_fn())
            with pytest.raises(ValueError, match="tensor-parallel"):
                loop(plan.place_params(s["tp"]), prng.key(7), batches)
        loop = TF.make_fl_train_loop(
            lambda p, b: s["tm"].loss(p, b, per_example=True), s["tspace"],
            eps=EPS, lr=LR, n_clients=K, n_steps=1, stack_forwards=False,
            constrain_params=plan.constrain_params_fn())
        _, gs, _ = loop(plan.place_params(s["tp"]), prng.key(7), batches)
        assert torch.isfinite(gs).all()


# ------------------------------------------------------ the vmap rules ----
def test_dual_perturb_out_writes_the_pair():
    rng = np.random.default_rng(3)
    w, z = (torch.as_tensor(rng.standard_normal(2048).astype(np.float32))
            for _ in range(2))
    out = torch.empty(2, 2048)
    assert ops.zo_dual_perturb_flat(w, z, None, 1e-3, out=out) is out
    plus, minus = ops.zo_dual_perturb_flat(w, z, None, 1e-3)
    assert torch.equal(out[0], plus) and torch.equal(out[1], minus)
    with pytest.raises(ValueError, match="out"):
        ops.zo_dual_perturb_flat(w, z, None, 1e-3, out=torch.empty(2048))


@pytest.mark.parametrize("case", ["plain", "ragged_window_softcap",
                                  "k_v_unmapped"])
def test_flash_rule_bit_equal_per_member(case):
    """Row 3's rule: vmapped over a stacked axis, the plain version
    (through the rule's folded call) equals one call per member, O and lse
    bit for bit."""
    rng = np.random.default_rng(5)
    n, Bq, Sq, H, KV, hd = 2, 3, 40, 4, 2, 64

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32))

    q, k, v = t(n, Bq, Sq, H, hd), t(n, Bq, Sq, KV, hd), t(n, Bq, Sq, KV, hd)
    kw, L, dims = {}, None, (0, 0, 0)
    if case == "ragged_window_softcap":
        kw, L = dict(window=16, softcap=30.0), torch.tensor([40, 7, 1])
    if case == "k_v_unmapped":
        k, v, dims = k[0], v[0], (0, None, None)
    got = torch.func.vmap(lambda q, k, v: ops.flash_attention(
        q, k, v, L, return_lse=True, **kw), in_dims=dims)(q, k, v)
    for i in range(n):
        ki, vi = (k, v) if dims[1] is None else (k[i], v[i])
        o, lse = ops.flash_attention(q[i], ki, vi, L, return_lse=True, **kw)
        assert torch.equal(got[0][i], o) and torch.equal(got[1][i], lse)


@pytest.mark.parametrize("a_mapped", [True, False])
def test_mamba_rule_bit_equal_per_member(a_mapped):
    """Row 8's rule: dt, B, C, x fold into the batch, and a mapped A
    becomes the kernel's per-member A ([n, E, N]); the plain version equals
    one call per member, y and h_last bit for bit."""
    rng = np.random.default_rng(6)
    n, Bsz, Sq, E, N = 2, 3, 37, 48, 16

    def t(*shape, scale=1.0):
        return torch.as_tensor((scale * rng.standard_normal(shape)).astype(
            np.float32))

    dt = torch.nn.functional.softplus(t(n, Bsz, Sq, E))
    Bi, Ci, x = t(n, Bsz, Sq, N), t(n, Bsz, Sq, N), t(n, Bsz, Sq, E)
    A = -torch.exp(t(n, E, N, scale=0.5))
    dims = (0, 0, 0, 0, 0 if a_mapped else None)
    A_in = A if a_mapped else A[0]
    y, h = torch.func.vmap(ops.mamba_scan, in_dims=dims)(dt, Bi, Ci, x, A_in)
    for i in range(n):
        yi, hi = ops.mamba_scan(dt[i], Bi[i], Ci[i], x[i],
                                A[i] if a_mapped else A[0])
        assert torch.equal(y[i], yi) and torch.equal(h[i], hi)
    # the kernel's per-member A, called directly: rows 0-2 take A[0]
    fold = [u.reshape(n * Bsz, *u.shape[2:]) for u in (dt, Bi, Ci, x)]
    yf, _ = ops.mamba_scan(*fold, A)
    assert torch.equal(yf[:Bsz], ops.mamba_scan(dt[0], Bi[0], Ci[0], x[0],
                                                A[0])[0])


def _no_rule_calls():
    w = torch.ones(2, 1024)
    q = torch.ones(2, 1, 4, 2, 64)
    k = torch.ones(2, 1, 16, 1, 64)
    lse = torch.zeros(2, 1, 1, 16, 2)
    qs = torch.ones(2, 1, 16, 2, 64)
    ks = torch.ones(2, 1, 16, 1, 64)
    return {
        "zo_dual_perturb_flat": (lambda w: ops.zo_dual_perturb_flat(
            w, w, None, 1e-3), (w,)),
        "zo_fused_update_flat": (lambda w: ops.zo_fused_update_flat(
            w, w, None, 1e-3), (w,)),
        "gradip_flat": (lambda w: ops.gradip_flat(w, w, 1.0), (w,)),
        "flash_attention_bwd_dq": (lambda q, k, l: ops.flash_attention_bwd_dq(
            q, k, k, None, l, l, q), (qs, ks, lse)),
        "flash_attention_bwd_dkv": (lambda q, k, l:
                                    ops.flash_attention_bwd_dkv(
                                        q, k, k, None, l, l, q),
                                    (qs, ks, lse)),
        "flash_decode": (lambda q, k: ops.flash_decode(
            q[:, 0].transpose(0, 1)[None][:, :1], k, k, 16), (q, k)),
        "fixture_double": (lambda x: ops.fixture_double(x, 8),
                           (torch.ones(2, 16, 16),)),
    }


@pytest.mark.parametrize("name", sorted(_no_rule_calls()))
def test_wrapper_without_rule_raises_under_vmap(name):
    """Every wrapper but rows 3 and 8 raises under ``torch.func.vmap``,
    naming its kernel: nothing runs its plain version on batched tensors."""
    fn, args = _no_rule_calls()[name]
    with pytest.raises(RuntimeError, match=f"kernel {name} has no vmap "
                                           f"rule"):
        torch.func.vmap(fn)(*args)


# ---------------------------------------------------- every family ----
def _batch(cfg, rows, seq, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (rows, seq)).astype(
        np.int32)}
    if cfg.frontend == "audio_stub":
        out["audio_embeds"] = rng.standard_normal(
            (rows, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision_stub":
        out["patch_embeds"] = rng.standard_normal(
            (rows, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def _family_cfg(get, name):
    cfg = get(name + "-reduced")
    if name == "jamba-1.5-large-398b":
        cfg = cfg.replace(**JAMBA_CUT)
    if name == "xlstm-350m":
        cfg = cfg.replace(**XLSTM_CUT)
    return cfg


@pytest.mark.parametrize("name", FAMILIES)
def test_family_pair_loss_equals_sequential(name):
    """Each family the train loop takes (dense GQA, MoE, the Mamba hybrid
    on the kernel route, xLSTM, Whisper, Pixtral), reduced: the vmapped
    per-example loss of a stacked (w+, w-) pair equals its two losses in
    sequence within PAIR_RTOL.  The attention runs on the kernel route
    (the flash forward's rule: on the CPU its plain version)."""
    cfg = _family_cfg(get_config, name)
    m = Model(cfg, ModelCtx(attn_backend="kernel", mamba_mode="kernel"),
              device="cpu")
    p = m.init(seed=0)
    g = torch.Generator().manual_seed(1)
    z = tree_map(lambda t: torch.randn(t.shape, generator=g), p)
    wp = tree_map(lambda t, d: t + 1e-3 * d, p, z)
    wm = tree_map(lambda t, d: t - 1e-3 * d, p, z)
    b = {k: torch.as_tensor(v) for k, v in _batch(cfg, 2, 16, 2).items()}
    with torch.no_grad():
        both = torch.func.vmap(lambda w, bt: m.loss(w, bt, per_example=True),
                               in_dims=(0, None))(
            tree_map(lambda a, c: torch.stack([a, c]), wp, wm), b)
        for i, w in enumerate((wp, wm)):
            want = m.loss(w, b, per_example=True)
            np.testing.assert_allclose(both[i].numpy(), want.numpy(),
                                       rtol=PAIR_RTOL, atol=0)


def test_hybrid_stacked_loop_matches_jax():
    """The Mamba hybrid's stacked train loop (reduced Jamba cut to an
    (attention, dense) and a (Mamba, MoE) layer, the selective scan's
    rule; stacked by request, as its flat size is over the constant)
    against JAX's ``jax.vmap`` loop on the same parameters."""
    jcfg = _family_cfg(j_get_config, "jamba-1.5-large-398b")
    tcfg = _family_cfg(get_config, "jamba-1.5-large-398b")
    jm = JModel(jcfg, ShardCtx(mamba_mode="kernel"))
    tm = Model(tcfg, ModelCtx(mamba_mode="kernel"), device="cpu")
    jp = jax.jit(jm.init)(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jspace = j_random_mask(jp, density=1e-2, seed=3, balanced=False)
    tspace = space_from_numpy(jax.tree.map(np.asarray, jspace.idx_tree),
                              device="cpu")
    toks = np.random.default_rng(4).integers(0, tcfg.vocab, (2, K * B, S)
                                             ).astype(np.int32)
    kw = dict(eps=EPS, lr=LR, n_clients=K, n_steps=2, stack_forwards=True)
    jloop = JF.make_fl_train_loop(lambda p, b: jm.loss(
        p, b, per_example=True), jspace, backend="pallas", **kw)
    tloop = TF.make_fl_train_loop(lambda p, b: tm.loss(
        p, b, per_example=True), tspace, backend="kernel", **kw)
    jp2, jgs, jmet = jax.jit(jloop)(jp, jax.random.key(7),
                                    {"tokens": jnp.asarray(toks)})
    tp2, tgs, tmet = tloop(tp, prng.key(7), {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(tgs.numpy(), np.asarray(jgs),
                               atol=HYBRID_G_ATOL)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=LOSS_RTOL)
    _close_params(tp2, jp2, 2 * PARAM_ATOL)
