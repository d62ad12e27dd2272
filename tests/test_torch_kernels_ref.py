"""Each kernel's plain PyTorch version (kernels/ref.py, what the wrappers
run on the CPU) against its JAX Pallas kernel in interpret mode, over the
variant grid the CUDA kernels take."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref

SIZES = [1024, 40_000]
DTYPES = ["f32", "bf16"]


def _flat_inputs(n, dtype, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(n).astype(np.float32)
    z = rng.standard_normal(n).astype(np.float32)
    m = (rng.random(n) < 0.3).astype(np.float32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    return (jnp.asarray(w, jdt), jnp.asarray(z), jnp.asarray(m),
            torch.tensor(w).to(tdt), torch.tensor(z), torch.tensor(m))


def _assert_matches(jax_out, torch_out, prod, dtype, masked):
    """Bit-exact, except the pre-masked f32 variant: XLA on the CPU
    contracts its `w + s*z` into one fused multiply-add (one rounding),
    where the TPU kernel's body, the plain version and the CUDA kernel
    round the product first (two roundings).  The two then differ by at
    most one rounding of the product plus one of the sum: an ulp of each
    (many ulp of the result where w + s*z cancels to near zero)."""
    a = np.asarray(jax_out.astype(jnp.float32))
    b = torch_out.float().numpy()
    if dtype == "bf16" or masked:
        np.testing.assert_array_equal(a, b)
        return
    bound = np.spacing(np.abs(prod)) + np.spacing(np.abs(b))
    assert np.all(np.abs(a - b) <= bound)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_dual_perturb_ref_matches_pallas(n, dtype, masked):
    jw, jz, jm, tw, tz, tm = _flat_inputs(n, dtype, n)
    jp, jn = jops.zo_dual_perturb_flat(jw, jz, jm if masked else None, 1e-3)
    tp, tn = ops.zo_dual_perturb_flat(tw, tz, tm if masked else None, 1e-3)
    prod = np.float32(1e-3) * tz.numpy()
    for j, t in ((jp, tp), (jn, tn)):
        assert t.dtype == tw.dtype
        _assert_matches(j, t, prod, dtype, masked)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
def test_fused_update_ref_matches_pallas(n, dtype, masked):
    jw, jz, jm, tw, tz, tm = _flat_inputs(n, dtype, n + 1)
    ju = jops.zo_fused_update_flat(jw, jz, jm if masked else None, -0.05)
    tu = ops.zo_fused_update_flat(tw, tz, tm if masked else None, -0.05)
    _assert_matches(ju, tu, np.float32(-0.05) * tz.numpy(), dtype, masked)


def test_fused_update_tensor_scale_equals_float_scale():
    _, _, _, tw, tz, _ = _flat_inputs(4096, "f32", 3)
    g = torch.tensor(0.7312, dtype=torch.float32)
    a = ops.zo_fused_update_flat(tw, tz, None, -0.05 * g)
    b = ops.zo_fused_update_flat(tw, tz, None, float(-0.05 * g))
    assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1024, 40_000, 262_144])
def test_gradip_ref_matches_pallas(n):
    rng = np.random.default_rng(n)
    gp = rng.standard_normal(n).astype(np.float32)
    z = rng.standard_normal(n).astype(np.float32)
    want = float(jops.gradip_flat(jnp.asarray(gp), jnp.asarray(z), 1.7))
    got = float(ops.gradip_flat(torch.tensor(gp), torch.tensor(z), 1.7))
    # f32 sums over n terms in another order
    assert got == pytest.approx(want, rel=1e-5, abs=1e-5 * np.sqrt(n))


def _attn_inputs(B, S, KV, G, dh, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, KV * G, dh)).astype(dtype)
    k = rng.standard_normal((B, S, KV, dh)).astype(dtype)
    v = rng.standard_normal((B, S, KV, dh)).astype(dtype)
    return q, k, v


def _jax_fwd_lse(q, k, v, L, *, block, window, softcap):
    """O and lse from the Pallas forward (interpret mode), padding S up to
    a block multiple as ops.flash_attention does."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    pad = (-S) % block
    padw = ((0, 0), (0, pad), (0, 0), (0, 0))
    qp, kp, vp = (np.pad(x, padw) for x in (q, k, v))
    Sp = S + pad
    qg = jnp.asarray(qp).reshape(B, Sp, KV, G, dh).transpose(0, 2, 1, 3, 4)
    kg = jnp.asarray(kp).transpose(0, 2, 1, 3)
    vg = jnp.asarray(vp).transpose(0, 2, 1, 3)
    st = jfa.Static(block_q=block, block_k=block, window=window,
                    softcap=softcap, causal=True, interpret=True)
    o, lse = jfa._fwd_call(st, qg, kg, vg, jnp.asarray(L, jnp.int32))
    o = np.asarray(o).transpose(0, 2, 1, 3, 4).reshape(B, Sp, H, dh)
    return o[:, :S], np.asarray(lse)[:, :, :S]


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("S,window,softcap,ragged_len", [
    (64, 0, 0.0, False),     # block multiple, plain causal
    (72, 0, 0.0, True),      # S not a block multiple, per-row lengths
    (64, 16, 0.0, False),    # sliding window
    (80, 24, 30.0, True),    # window + softcap + lengths, ragged S
])
def test_flash_ref_matches_pallas(G, dh, S, window, softcap, ragged_len):
    B, KV = 2, 2
    q, k, v = _attn_inputs(B, S, KV, G, dh, seed=S + G + dh)
    L = np.array([S, S - 19] if ragged_len else [S, S], np.int32)
    jo, jlse = _jax_fwd_lse(q, k, v, L, block=32, window=window,
                            softcap=softcap)
    to, tlse = ops.flash_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(L),
        window=window, softcap=softcap, return_lse=True)
    np.testing.assert_allclose(to.numpy(), jo, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tlse.numpy(), jlse, atol=1e-5, rtol=0)


def test_flash_ref_matches_ops_wrapper_bf16():
    """bf16 operands: f32 accumulation, O cast to bf16 on both sides."""
    q, k, v = _attn_inputs(1, 48, 2, 4, 64, seed=5)
    want = jops.flash_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        jnp.asarray([40], jnp.int32), block_q=32, block_k=32)
    got = ops.flash_attention(
        *(torch.tensor(x).to(torch.bfloat16) for x in (q, k, v)),
        torch.tensor([40]))
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of an f32 result: a bf16 ulp at |O| <= ~2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2)


def test_flash_fully_masked_row_is_zero():
    q, k, v = _attn_inputs(1, 16, 1, 2, 64, seed=9)
    out, lse = ref.flash_attention_ref(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        torch.tensor([0]), window=0, softcap=0.0, causal=True)
    assert torch.all(out == 0)
    assert torch.all(lse < -1e29)
