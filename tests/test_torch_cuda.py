"""The CUDA kernels against their plain versions on the card (small shapes
and every variant).  Marked ``cuda``: skipped where there is no card; run
them on a GPU machine with ``python -m pytest -q -m cuda tests/``."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _flat(n, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(n, generator=g, device=dev).to(dtype)
    z = torch.randn(n, generator=g, device=dev)
    m = (torch.rand(n, generator=g, device=dev) < 0.3).float()
    return w, z, m


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 1023, 4096, 1_000_003])
def test_elementwise_kernels_bit_equal_plain(dev, n, dtype, masked):
    w, z, m = _flat(n, dtype, dev, n)
    mm = m if masked else None
    before = ops.launches()
    p, q = ops.zo_dual_perturb_flat(w, z, mm, 1e-3)
    rp, rq = ref.dual_perturb_ref(w, z, mm, 1e-3)
    assert torch.equal(p, rp) and torch.equal(q, rq)
    s = torch.tensor(-0.05, device=dev) * 0.731
    u = ops.zo_fused_update_flat(w, z, mm, s)
    assert torch.equal(u, ref.fused_update_ref(w, z, mm, s))
    after = ops.launches()
    assert after["zo_dual_perturb_flat"] == before["zo_dual_perturb_flat"] + 1
    assert after["zo_fused_update_flat"] == before["zo_fused_update_flat"] + 1


def test_elementwise_kernels_unaligned_views(dev):
    w, z, _ = _flat(4099, torch.float32, dev, 7)
    p, _ = ops.zo_dual_perturb_flat(w[1:], z[1:], None, 1e-3)
    rp, _ = ref.dual_perturb_ref(w[1:], z[1:], None, 1e-3)
    assert torch.equal(p, rp)


@pytest.mark.parametrize("n", [1, 777, 1_235_814, 10_000_000])
def test_gradip_kernel_matches_plain(dev, n):
    gp, z, _ = _flat(n, torch.float32, dev, n + 1)
    got = ops.gradip_flat(gp, z, 1.7)
    want = ref.gradip_reduce_ref(gp, z, 1.7)
    scale = 1.7 * float((gp * z).abs().sum())
    assert abs(float(got) - float(want)) <= 1e-5 * scale
    assert float(ops.gradip_flat(gp, z, 1.7)) == float(got)  # deterministic


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,dh", [(1, 64), (4, 64), (4, 128), (1, 128),
                                  (6, 64)])
@pytest.mark.parametrize("S,window,softcap,lengths", [
    (128, 0, 0.0, None), (200, 0, 0.0, (200, 77)), (256, 48, 0.0, None),
    (130, 32, 30.0, (130, 1)), (64, 0, 0.0, (0, 64))])
def test_flash_kernel_matches_plain(dev, dtype, G, dh, S, window, softcap,
                                    lengths):
    B, KV = 2, 2
    g = torch.Generator(device=dev).manual_seed(S * G + dh)
    q = torch.randn(B, S, KV * G, dh, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, KV, dh, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, KV, dh, generator=g, device=dev).to(dtype)
    L = None if lengths is None else torch.tensor(lengths, device=dev)
    o, lse = ops.flash_attention(q, k, v, L, window=window, softcap=softcap,
                                 return_lse=True)
    Lr = torch.full((B,), S, device=dev) if L is None else L
    ro, rlse = ref.flash_attention_ref(q, k, v, Lr, window=window,
                                       softcap=softcap, causal=True)
    # f32: two summation orders over <= S keys; bf16: one bf16 rounding of
    # the same f32 result, i.e. a bf16 ulp at |O| < 4
    atol = 1e-4 if dtype == torch.float32 else 1.6e-2
    torch.testing.assert_close(o.float(), ro.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)
