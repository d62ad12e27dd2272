"""The CUDA kernels against their plain versions on the card (small shapes
and every variant).  Marked ``cuda``: skipped where there is no card; run
them on a GPU machine with ``python -m pytest -q -m cuda tests/``."""
import ctypes

import pytest

torch = pytest.importorskip("torch")

import chip_smoke
from repro_torch.kernels import ops, plans, ref

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


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edge", [-1, 0, 1])
def test_fused_update_bit_equal_at_chunk_edges(dev, edge, dtype, masked):
    """fused_update's blocks each take one chunk (plans.zo_update_chunk):
    bit-equal to the plain version one element below, at and above a chunk
    and two, packed and on views one element off the packs' alignment."""
    from repro_torch.kernels import plans
    for vec in (True, False):
        n = plans.zo_update_chunk(vec) * (1 if vec else 2) + edge
        w, z, m = _flat(n + 1, dtype, dev, n)
        if not vec:  # off the 16-byte (8 for bf16 w) packs: the scalar path
            w, z, m = w[1:], z[1:], m[1:]
        else:
            w, z, m = w[:n], z[:n], m[:n]
        mm = m if masked else None
        s = torch.tensor(-0.05, device=dev) * 0.731
        before = ops.zo_fused_update_flat.launches
        u = ops.zo_fused_update_flat(w, z, mm, s)
        assert ops.zo_fused_update_flat.launches == before + 1
        assert torch.equal(u, ref.fused_update_ref(w, z, mm, s))


@pytest.mark.parametrize("n", [1, 777, 1_235_814, 10_000_000])
def test_gradip_kernel_matches_plain(dev, n):
    gp, z, _ = _flat(n, torch.float32, dev, n + 1)
    before = ops.gradip_flat.launches
    got = ops.gradip_flat(gp, z, 1.7)
    assert got.shape == () and got.dtype == torch.float32
    assert ops.gradip_flat.launches == before + 1
    want = ref.gradip_reduce_ref(gp, z, 1.7)
    scale = 1.7 * float((gp * z).abs().sum())
    assert abs(float(got) - float(want)) <= 1e-5 * scale
    # deterministic: bit-equal over repeats, and over calls from two streams
    # at once (each stream has its own scratch and ticket)
    for _ in range(3):
        assert torch.equal(ops.gradip_flat(gp, z, 1.7), got)
    main = torch.cuda.current_stream(dev)
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    outs = []
    for s in streams:
        s.wait_stream(main)
    for _ in range(4):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(ops.gradip_flat(gp, z, 1.7))
    for s in streams:
        main.wait_stream(s)
    torch.cuda.synchronize()
    assert all(torch.equal(o, got) for o in outs)
    assert ops.gradip_flat.launches == before + 4 + len(outs)


def test_gradip_refuses_graph_capture(dev):
    """A graph would replay one stream's scratch and ticket on any stream:
    capture is refused with nothing launched, before a stream has its
    scratch and after, and the next eager call is right."""
    gp, z, _ = _flat(4096, torch.float32, dev, 5)
    want = ops.gradip_flat(gp, z, 1.7)
    refusals = chip_smoke.gradip_capture_refusals(torch, ops, gp, z)
    assert len(refusals) == 2
    assert all(r is not None and "captur" in r for r in refusals)
    assert torch.equal(ops.gradip_flat(gp, z, 1.7), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,dh", [(1, 64), (4, 64), (4, 128), (1, 128),
                                  (6, 64), (2, 256), (1, 256)])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,dh", [(8, 128), (64, 64), (64, 256), (3, 256)])
@pytest.mark.parametrize("S,window,softcap,lengths", [
    (200, 0, 0.0, (200, 77)), (130, 32, 30.0, (130, 1))])
def test_flash_kernel_matches_plain_at_wide_groups(dev, dtype, G, dh, S,
                                                   window, softcap, lengths):
    """The forward at Jamba's G 8 and head_dim 128, at G 64 (one query of
    64 heads a block) and at head_dim 256 with G 64 and an odd G: within
    the tolerances above of the plain version, and two calls bit-equal
    (one block owns each output row)."""
    B, KV = 2, 1
    g = torch.Generator(device=dev).manual_seed(S * G + dh)
    q = torch.randn(B, S, KV * G, dh, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, KV, dh, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, KV, dh, generator=g, device=dev).to(dtype)
    L = torch.tensor(lengths, device=dev)
    kw = dict(window=window, softcap=softcap, return_lse=True)
    before = ops.flash_attention.launches
    o, lse = ops.flash_attention(q, k, v, L, **kw)
    ro, rlse = ref.flash_attention_ref(q, k, v, L, window=window,
                                       softcap=softcap, causal=True)
    atol = 1e-4 if dtype == torch.float32 else 1.6e-2
    torch.testing.assert_close(o.float(), ro.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)
    o2, lse2 = ops.flash_attention(q, k, v, L, **kw)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert ops.flash_attention.launches == before + 2


FWD_TILINGS = [(dh, t) for dh, ts in plans.FLASH_FWD_TILINGS.items()
               for t in ts]
BWD_TILINGS = [(dh, t) for dh, ts in plans.FLASH_BWD_TILINGS.items()
               for t in ts]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,tiling", FWD_TILINGS)
def test_flash_fwd_every_tiling_matches_plain(dev, dtype, dh, tiling):
    """Each forward tiling, pinned through (block_q, block_k): O and lse
    within the plain version's tolerances over ragged lengths, a window
    with softcap, and an S past a tile edge; two calls bit-equal; its probe
    walks plans.flash_fwd_tiles' key tiles for that tiling, and the
    library's plan query gives plans.flash_attn_fwd's launch."""
    from repro_torch.kernels import build
    G = 2 if dh == 256 else 4
    bq, bk = plans.tiling_blocks(tiling, G)
    bf16 = dtype == torch.bfloat16
    for S, window, softcap, lengths in ((200, 0, 0.0, (200, 77)),
                                        (130, 32, 30.0, (130, 1)),
                                        (513, 0, 0.0, (513, 513))):
        g = torch.Generator(device=dev).manual_seed(S + dh)
        q = torch.randn(2, S, 2 * G, dh, generator=g, device=dev).to(dtype)
        k = torch.randn(2, S, 2, dh, generator=g, device=dev).to(dtype)
        v = torch.randn(2, S, 2, dh, generator=g, device=dev).to(dtype)
        L = torch.tensor(lengths, device=dev, dtype=torch.int32)
        kw = dict(window=window, softcap=softcap)
        o, lse = ops.flash_attention(q, k, v, L, block_q=bq, block_k=bk,
                                     return_lse=True, **kw)
        ro, rlse = ref.flash_attention_ref(q, k, v, L, causal=True, **kw)
        atol = 1e-4 if dtype == torch.float32 else 1.6e-2
        torch.testing.assert_close(o.float(), ro.float(), atol=atol, rtol=0)
        torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)
        o2, lse2 = ops.flash_attention(q, k, v, L, block_q=bq, block_k=bk,
                                       return_lse=True, **kw)
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        res, rec = ops.flash_attention_fwd_probe(q, k, v, L, tiling=tiling,
                                                 **kw)
        assert all(torch.equal(a, b) for a, b in zip(res, (o, lse)))
        assert rec[:, 0].tolist() == plans.flash_fwd_tiles(
            2, S, 2, G, dh, lengths=lengths, window=window, tiling=tiling)
        got = plans.query(build.load(), plans.flash_attn_fwd, B=2, S=S,
                          KVH=2, G=G, dh=dh, bf16=bf16, tiling=tiling)
        want = plans.flash_attn_fwd(2, S, 2, G, dh, bf16, tiling)
        assert [l.numbers() for l in got] == [l.numbers() for l in want]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh,tiling", BWD_TILINGS)
def test_flash_bwd_every_tiling_matches_plain(dev, dtype, dh, tiling):
    """Each backward tiling, dQ and dK/dV, against the plain versions
    within 1e-4 of the largest entry (bf16 operands: the same bound, f32
    outputs), two calls bit-equal; the probe's dK/dV blocks walk tiles
    that sum the same for each pair under causal masking."""
    G = 2
    kw = dict(window=0, softcap=0.0, causal=True)
    for S, lengths, window, softcap in ((256, None, 0, 0.0),
                                        (130, (130, 1), 32, 30.0)):
        args = _bwd_inputs(dev, dtype, 2, S, 2, G, dh, lengths, window,
                           softcap, S + dh)
        kw = dict(window=window, softcap=softcap, causal=True)
        got = (ops.flash_attention_bwd_dq(*args, tiling=tiling, **kw),
               *ops.flash_attention_bwd_dkv(*args, tiling=tiling, **kw))
        want = (ref.flash_attn_bwd_dq_ref(*args, **kw),
                *ref.flash_attn_bwd_dkv_ref(*args, **kw))
        for a, b in zip(got, want):
            scale = max(1.0, float(b.abs().max()))
            assert float((a - b).abs().max()) / scale <= 1e-4
        again = (ops.flash_attention_bwd_dq(*args, tiling=tiling, **kw),
                 *ops.flash_attention_bwd_dkv(*args, tiling=tiling, **kw))
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    args = _bwd_inputs(dev, torch.float32, 1, 512, 2, G, dh, None, 0, 0.0,
                       dh)
    kw = dict(window=0, softcap=0.0, causal=True)
    _, rec = ops.flash_attention_bwd_probe(*args, dkv=True, tiling=tiling,
                                           **kw)
    tiles = rec[:, 0].double()
    assert float(tiles.max()) <= 1.2 * float(tiles.mean())


def _fwd_smem_state(dh, bf16):
    """(dynamic shared bytes granted to one forward instantiation on this
    device, cudaFuncSetAttribute calls of the forward's launches so far)."""
    from repro_torch.kernels import build
    out = (ctypes.c_longlong * 2)()
    assert build.load().flash_attn_fwd_smem_state(
        dh, int(bf16), *plans.FLASH_FWD_TILINGS[dh][0], out) == 0
    return out[0], out[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 128, 256])
def test_flash_fwd_sets_the_smem_attribute_once(dev, dh, dtype):
    """The forward's launcher asks for its shared memory through the
    per-device high-water mark (common.cuh): after a launch the mark holds
    the plan's bytes, and launches at other shapes (the same bytes) make no
    cudaFuncSetAttribute call."""
    from repro_torch.kernels import plans
    bf16 = dtype == torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(dh)

    def call(B, S, KV, G):
        q = torch.randn(B, S, KV * G, dh, generator=g, device=dev).to(dtype)
        k = torch.randn(B, S, KV, dh, generator=g, device=dev).to(dtype)
        ops.flash_attention(q, k, k)

    call(1, 96, 1, 2)
    torch.cuda.synchronize()
    (plan,) = plans.flash_attn_fwd(1, 96, 1, 2, dh, bf16)
    granted, sets = _fwd_smem_state(dh, bf16)
    assert granted == plan.dynamic_smem
    for B, S, G in ((2, 64, 1), (2, 300, 2), (1, 700, 4)):
        call(B, S, 2, G)
    torch.cuda.synchronize()
    assert _fwd_smem_state(dh, bf16)[1] == sets


@pytest.mark.parametrize("dh", [64, 256])
def test_flash_fwd_probe_records_blocks_and_one_pass_misses(dev, dh):
    """flash_attention_fwd_probe launches the wrapped kernel (bit-equal
    outputs, no launch counted), and each block records the key tiles it
    walked: plans.flash_fwd_tiles' counts, never more than a block launched
    before it under causal masking; its one-pass TF32 control misses the
    1e-4 that the 3xTF32 split keeps."""
    from repro_torch.kernels import plans
    S, G = 512, 4 if dh == 64 else 2
    g = torch.Generator(device=dev).manual_seed(dh)
    q = torch.randn(2, S, 2 * G, dh, generator=g, device=dev)
    k = torch.randn(2, S, 2, dh, generator=g, device=dev)
    v = torch.randn(2, S, 2, dh, generator=g, device=dev)
    L = torch.tensor([S, S], device=dev)
    got = ops.flash_attention(q, k, v, L, return_lse=True)
    want = ref.flash_attention_ref(q, k, v, L, window=0, softcap=0.0,
                                   causal=True)
    before = ops.launches()
    res, rec = ops.flash_attention_fwd_probe(q, k, v, L)
    assert ops.launches() == before
    assert all(torch.equal(a, b) for a, b in zip(res, got))
    tiles = rec[:, 0]
    assert tiles.tolist() == plans.flash_fwd_tiles(2, S, 2, G, dh)
    assert (tiles[1:] <= tiles[:-1]).all() and (rec[:, 1] > 0).all()
    (o1, l1), _ = ops.flash_attention_fwd_probe(q, k, v, L, one_pass=True)
    miss = max(float((o1 - want[0]).abs().max()),
               float((l1 - want[1]).abs().max()))
    assert miss > 1e-4


def _bwd_inputs(dev, dtype, B, S, KV, G, dh, lengths, window, softcap, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, S, KV * G, dh, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, KV, dh, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, KV, dh, generator=g, device=dev).to(dtype)
    do = torch.randn(q.shape, generator=g, device=dev).to(dtype)
    L = torch.tensor(lengths or (S,) * B, device=dev, dtype=torch.int32)
    o, lse = ref.flash_attention_ref(q, k, v, L, window=window,
                                     softcap=softcap, causal=True)
    return q, k, v, L, lse, ref.flash_attention_delta(o, do, KV), do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,dh", [(1, 64), (4, 64), (4, 128), (1, 128),
                                  (6, 64), (1, 256), (2, 256)])
@pytest.mark.parametrize("S,window,softcap,lengths", [
    (128, 0, 0.0, None), (200, 0, 0.0, (200, 77)), (256, 48, 0.0, None),
    (130, 32, 30.0, (130, 1)), (64, 0, 0.0, (0, 64))])
def test_flash_bwd_kernels_match_plain(dev, dtype, G, dh, S, window, softcap,
                                       lengths):
    args = _bwd_inputs(dev, dtype, 2, S, 2, G, dh, lengths, window, softcap,
                       S * G + dh)
    kw = dict(window=window, softcap=softcap, causal=True)
    before = ops.launches()
    got = (ops.flash_attention_bwd_dq(*args, **kw),
           *ops.flash_attention_bwd_dkv(*args, **kw))
    want = (ref.flash_attn_bwd_dq_ref(*args, **kw),
            *ref.flash_attn_bwd_dkv_ref(*args, **kw))
    # both compute in f32 from the same widened operands, summing up to
    # S*G terms in another order: 1e-4 of the largest entry (or of 1)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        tol = 1e-4 * max(1.0, float(b.abs().max()))
        torch.testing.assert_close(a, b, atol=tol, rtol=0)
    again = (ops.flash_attention_bwd_dq(*args, **kw),
             *ops.flash_attention_bwd_dkv(*args, **kw))
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics
    after = ops.launches()
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert after[name] == before[name] + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_autograd_on_card_matches_dense(dev, dtype):
    """torch.autograd through ops.flash_attention on the card runs the
    forward and both backward kernels and gives the dense route's
    gradients."""
    from repro_torch.configs import TINY
    from repro_torch.models import layers as L
    B, S, KV, G, dh = 2, 300, 2, 4, 64
    cfg = TINY.replace(n_heads=KV * G, n_kv_heads=KV, d_model=KV * G * dh)
    g = torch.Generator(device=dev).manual_seed(11)
    q, k, v = (torch.randn(B, S, n, dh, generator=g, device=dev)
               .to(dtype).requires_grad_(True) for n in (KV * G, KV, KV))
    w = torch.randn(B, S, KV * G, dh, generator=g, device=dev)
    before = ops.launches()
    gk = torch.autograd.grad((ops.flash_attention(q, k, v).float() * w)
                             .sum(), (q, k, v))
    after = ops.launches()
    for name in ("flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert after[name] == before[name] + 1
    mask = L.causal_mask(S, device=dev)
    gd = torch.autograd.grad((L.gqa_attention(q, k, v, mask, cfg).float()
                              * w).sum(), (q, k, v))
    # f32: two summation orders, 1e-4 of the largest entry.  bf16: the
    # kernel route takes delta = rowsum(dO * O) from the bf16-rounded O, as
    # the JAX package's VJP does, where the dense route's autograd uses its
    # f32 probabilities; that rounding (2^-9 relative in O) moves ds, and
    # the gradients agree to ~0.2% of the largest entry (0.22% seen): 1%
    frac = 1e-4 if dtype == torch.float32 else 1e-2
    for a, b in zip(gk, gd):
        assert a.dtype == dtype
        torch.testing.assert_close(
            a.float(), b.float(), rtol=0,
            atol=frac * max(1.0, float(b.float().abs().max())))


# (G, dh) of the paper's models' decode layouts and a G=1 layout
DECODE_LAYOUTS = [(4, 64), (6, 128), (2, 256), (1, 64)]


@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("G,dh", DECODE_LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_matches_plain(dev, dtype, G, dh, softcap):
    """Ragged lengths with 1, S and a length past one split, and a row of
    length 0 (zeros, the port's rule); two calls bit-equal; one launch per
    call."""
    B, S, KV = 5, 700, 2
    g = torch.Generator(device=dev).manual_seed(G * dh)
    q = torch.randn(B, KV, G, dh, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(B, S, KV, dh, generator=g, device=dev).to(dtype)
            for _ in range(2))
    L = torch.tensor([S, 1, 300, 0, 513], device=dev, dtype=torch.int32)
    before = ops.launches()["flash_decode"]
    out = ops.flash_decode(q, k, v, L, softcap=softcap)
    want = ref.decode_attention_ref(q, k, v, L, softcap)
    assert out.dtype == dtype and out.shape == q.shape
    # f32: splits merged in another order than one softmax, 1e-5 of the
    # largest entry; bf16: one bf16 rounding of the same f32 result
    frac = 1e-5 if dtype == torch.float32 else 8e-3
    scale = float(want.float().abs().max())
    assert float((out.float() - want.float()).abs().max()) <= frac * scale
    assert torch.equal(out[3], torch.zeros_like(out[3]))
    assert torch.equal(ops.flash_decode(q, k, v, L, softcap=softcap), out)
    assert ops.launches()["flash_decode"] == before + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,lengths", [(4096, (4096, 132)),
                                       (4352, (4232, 132))])
def test_flash_decode_matches_plain_at_gemma_shapes(dev, dtype, S, lengths):
    """Gemma-2-2b's decode: q [2, 4, 2, 256], softcap 50, a full rolling
    cache of 4096 slots and a 4352-position global cache; two calls
    bit-equal."""
    g = torch.Generator(device=dev).manual_seed(S)
    q = torch.randn(2, 4, 2, 256, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(2, S, 4, 256, generator=g, device=dev).to(dtype)
            for _ in range(2))
    L = torch.tensor(lengths, device=dev, dtype=torch.int32)
    out = ops.flash_decode(q, k, v, L, softcap=50.0)
    want = ref.decode_attention_ref(q, k, v, L, 50.0)
    frac = 1e-5 if dtype == torch.float32 else 8e-3
    scale = float(want.float().abs().max())
    assert float((out.float() - want.float()).abs().max()) <= frac * scale
    assert torch.equal(ops.flash_decode(q, k, v, L, softcap=50.0), out)


def test_flash_backward_rejects_unsupported_head_dim(dev):
    """The backward kernels take head_dim 64, 128 and 256, and at 256 G <=
    32 (their 32-row query tiles); the wrappers raise before a launch
    on anything else."""
    before = ops.launches()
    for dh, H in ((96, 2), (256, 33)):
        q = torch.zeros(1, 64, H, dh, device=dev)
        k = torch.zeros(1, 64, 1, dh, device=dev)
        lse = torch.zeros(1, 1, 64, H, device=dev)
        with pytest.raises(ValueError):
            ops.flash_attention_bwd_dq(q, k, k, None, lse, lse, q)
        with pytest.raises(ValueError):
            ops.flash_attention_bwd_dkv(q, k, k, None, lse, lse, q)
    assert ops.launches() == before


def _bwd_smem_state(dkv, dh, bf16):
    """(dynamic shared bytes granted to one backward instantiation on this
    device, cudaFuncSetAttribute calls of the backward's launches so
    far)."""
    from repro_torch.kernels import build
    out = (ctypes.c_longlong * 2)()
    assert build.load().flash_attn_bwd_smem_state(
        int(dkv), dh, int(bf16), *plans.FLASH_BWD_TILINGS[dh][0], out) == 0
    return out[0], out[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 128, 256])
def test_flash_bwd_sets_the_smem_attribute_once(dev, dh, dtype):
    """The backward launchers ask for their shared memory through the
    per-device high-water mark (common.cuh): after a launch the mark holds
    the plan's bytes, and launches at other shapes (the same bytes) make
    no cudaFuncSetAttribute call."""
    from repro_torch.kernels import plans
    bf16 = dtype == torch.bfloat16
    kw = dict(window=0, softcap=0.0, causal=True)
    args = _bwd_inputs(dev, dtype, 1, 96, 1, 2, dh, None, 0, 0.0, dh)
    ops.flash_attention_bwd_dq(*args, **kw)
    ops.flash_attention_bwd_dkv(*args, **kw)
    torch.cuda.synchronize()
    for dkv in (False, True):
        (plan,) = plans.flash_attn_bwd(1, 96, 1, 2, dh, bf16, dkv)
        assert _bwd_smem_state(dkv, dh, bf16)[0] == plan.dynamic_smem
    sets = _bwd_smem_state(False, dh, bf16)[1]
    for S, G in ((64, 1), (300, 2), (700, 4)):
        a = _bwd_inputs(dev, dtype, 2, S, 2, G, dh, None, 0, 0.0, S)
        ops.flash_attention_bwd_dq(*a, **kw)
        ops.flash_attention_bwd_dkv(*a, **kw)
    torch.cuda.synchronize()
    assert _bwd_smem_state(True, dh, bf16)[1] == sets


@pytest.mark.parametrize("dh", [64, 256])
def test_flash_bwd_probe_records_blocks_and_one_pass_misses(dev, dh):
    """flash_attention_bwd_probe launches the wrapped kernels (bit-equal
    outputs, no launch counted) and each block records the tiles it
    walked: dK/dV's paired key tiles walk the same count under causal
    masking, dQ's blocks fewer as they launch; its one-pass TF32 control
    misses the 1e-4 that the 3xTF32 split keeps."""
    S, G = 512, 4 if dh == 64 else 2
    args = _bwd_inputs(dev, torch.float32, 1, S, 2, G, dh, None, 0, 0.0, dh)
    kw = dict(window=0, softcap=0.0, causal=True)
    got = (ops.flash_attention_bwd_dq(*args, **kw),
           *ops.flash_attention_bwd_dkv(*args, **kw))
    want = (ref.flash_attn_bwd_dq_ref(*args, **kw),
            *ref.flash_attn_bwd_dkv_ref(*args, **kw))
    before = ops.launches()
    dq, rec_q = ops.flash_attention_bwd_probe(*args, dkv=False, **kw)
    (dk, dv), rec_kv = ops.flash_attention_bwd_probe(*args, dkv=True, **kw)
    assert ops.launches() == before
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), got))
    tiles_kv = rec_kv[:, 0].reshape(2, -1)  # (KV head, pair)
    assert (tiles_kv == tiles_kv[0, 0]).all() and (rec_kv[:, 1] > 0).all()
    tiles_q = rec_q[:, 0].reshape(2, -1)
    assert (tiles_q[:, 1:] <= tiles_q[:, :-1]).all()
    assert int(tiles_q[0, 0]) == S // 32 and int(tiles_q[0, -1]) == 1
    one = (ops.flash_attention_bwd_probe(*args, dkv=False, one_pass=True,
                                         **kw)[0],
           *ops.flash_attention_bwd_probe(*args, dkv=True, one_pass=True,
                                          **kw)[0])
    miss = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
               for a, b in zip(one, want))
    assert miss > 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,G,dh", [(200, 4, 64), (2048, 4, 64),
                                    (4096, 2, 256), (4352, 2, 256),
                                    (3000, 8, 128), (700, 16, 256)])
def test_flash_decode_cluster_edges(dev, dtype, S, G, dh):
    """Clusters of 1 (S 200), 8 (2048), 16 (4096, and Gemma-2's 4352 in
    chunks of 272), 12 (3000) and 3 (700, with the largest group and head
    dim): rows whose live length ends inside the first split, just past
    it, inside the last split, at S, at 1 and at 0; one launch a call,
    two calls bit-equal."""
    from repro_torch.kernels import plans
    cs, chunk = plans.decode_cluster(S)
    assert cs == {200: 1, 2048: 8, 4096: 16, 4352: 16, 3000: 12, 700: 3}[S]
    lens = (S, 1, max(chunk - 5, 1), min(chunk + 1, S),
            max(S - chunk // 2, 1), 0)
    g = torch.Generator(device=dev).manual_seed(S)
    q = torch.randn(len(lens), 2, G, dh, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(len(lens), S, 2, dh, generator=g, device=dev)
            .to(dtype) for _ in range(2))
    L = torch.tensor(lens, device=dev, dtype=torch.int32)
    before = ops.flash_decode.launches
    out = ops.flash_decode(q, k, v, L, softcap=50.0)
    assert ops.flash_decode.launches == before + 1
    want = ref.decode_attention_ref(q, k, v, L, 50.0)
    frac = 1e-5 if dtype == torch.float32 else 8e-3
    scale = float(want.float().abs().max())
    assert float((out.float() - want.float()).abs().max()) <= frac * scale
    assert torch.equal(out[-1], torch.zeros_like(out[-1]))
    assert torch.equal(ops.flash_decode(q, k, v, L, softcap=50.0), out)


def _decode_smem_state(dh, bf16, G):
    """(dynamic shared bytes granted to the decode kernel of head_dim dh
    and group size G on this device, cudaFuncSetAttribute calls of decode
    launches)."""
    from repro_torch.kernels import build
    out = (ctypes.c_longlong * 2)()
    assert build.load().flash_decode_smem_state(dh, int(bf16), G, out) == 0
    return out[0], out[1]


def test_flash_decode_steady_calls_set_no_attribute(dev):
    """The first launch of an instantiation grants its shared memory and
    the non-portable cluster sizes; 100 steady calls ask the runtime for
    nothing more."""
    from repro_torch.kernels import plans
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(8, 8, 4, 64, generator=g, device=dev)
    k, v = (torch.randn(8, 2048, 8, 64, generator=g, device=dev)
            for _ in range(2))
    L = torch.full((8,), 2048, device=dev, dtype=torch.int32)
    ops.flash_decode(q, k, v, L)
    torch.cuda.synchronize()
    granted, sets = _decode_smem_state(64, False, 4)
    (plan,) = plans.flash_decode(8, 2048, 8, 4, 64, False)
    assert granted >= plan.dynamic_smem and sets >= 2
    for _ in range(100):
        ops.flash_decode(q, k, v, L)
    torch.cuda.synchronize()
    assert _decode_smem_state(64, False, 4) == (granted, sets)


def test_flash_decode_captured_in_a_cuda_graph(dev):
    """No scratch and no per-stream state: one call captured in a CUDA
    graph and replayed equals the eager call."""
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(4, 2, 4, 64, generator=g, device=dev)
    k, v = (torch.randn(4, 700, 2, 64, generator=g, device=dev)
            for _ in range(2))
    L = torch.tensor([700, 1, 300, 0], device=dev, dtype=torch.int32)
    assert torch.equal(chip_smoke.decode_graph_replay(torch, ops, q, k, v,
                                                      L),
                       ops.flash_decode(q, k, v, L))


def test_flash_decode_reads_only_the_live_prefix(dev):
    """Cache positions at or past a row's length never reach the result:
    NaNs there leave it finite and equal."""
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(2, 8, 4, 64, generator=g, device=dev)
    k, v = (torch.randn(2, 2048, 8, 64, generator=g, device=dev)
            for _ in range(2))
    L = torch.tensor([300, 1], device=dev, dtype=torch.int32)
    out = ops.flash_decode(q, k, v, L)
    k[0, 300:], v[0, 300:], k[1, 1:], v[1, 1:] = (float("nan"),) * 4
    assert torch.equal(ops.flash_decode(q, k, v, L), out)


def test_serve_engine_kernel_route_matches_ref_on_card(dev):
    """One engine run on a reduced model on the card: the decode kernel
    route gives the plain route's tokens, and flash_decode runs once per
    layer and decode step."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import ContinuousBatchingEngine
    cfg = get_config("gemma2-2b-reduced")
    model = Model(cfg, device=dev)
    params = model.init(seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in (4, 39, 6, 300)]
    outs = {}
    for route in ("kernel", "ref"):
        eng = ContinuousBatchingEngine(model, params, max_slots=2, S_max=320,
                                       bucket=8, decode_backend=route)
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        before = ops.launches()["flash_decode"]
        outs[route] = eng.run()
        n = ops.launches()["flash_decode"] - before
        assert n == (cfg.n_layers * eng.stats["decode_steps"]
                     if route == "kernel" else 0)
    for a, b in zip(outs["kernel"], outs["ref"]):
        np.testing.assert_array_equal(a, b)


def test_flash_decode_rejects_a_misaligned_cache(dev):
    q = torch.zeros(1, 2, 4, 64, device=dev)
    k = torch.zeros(1 + 16 * 2 * 64, device=dev)[1:].view(1, 16, 2, 64)
    with pytest.raises(ValueError):
        ops.flash_decode(q, k, k, 16)


def _mamba_args(dev, B, S, E, N, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, E, generator=g, device=dev)) * 0.1
    Bi, Ci = (torch.randn(B, S, N, generator=g, device=dev) for _ in range(2))
    x = torch.randn(B, S, E, generator=g, device=dev)
    A = -torch.exp(torch.randn(E, N, generator=g, device=dev))
    return dt, Bi, Ci, x, A


# (B, S, E, N): one step; ragged S and E (129: the 4-byte copies); S 2048:
# 16 tiles of 128 steps, each entered from the last one's carry
@pytest.mark.parametrize("B,S,E,N", [(1, 1, 128, 16), (3, 37, 200, 16),
                                     (2, 300, 256, 8), (2, 64, 129, 8),
                                     (1, 513, 1024, 16), (1, 2048, 256, 16),
                                     (2, 2048, 129, 8), (1, 2047, 37, 16)])
def test_mamba_scan_matches_plain(dev, B, S, E, N):
    """y and h_last within 1e-5 of the largest entry (f32 sums of the same
    terms, fused on the card), and two calls bit-equal."""
    args = _mamba_args(dev, B, S, E, N, B * 7 + S)
    before = ops.launches()["mamba_scan"]
    y, h = ops.mamba_scan(*args)
    ry, rh = ref.mamba_scan_ref(*args)
    assert ops.launches()["mamba_scan"] == before + 1
    for got, want in ((y, ry), (h, rh)):
        assert float((got - want).abs().max()) <= \
            1e-5 * float(want.abs().max())
    y2, h2 = ops.mamba_scan(*args)
    assert torch.equal(y, y2) and torch.equal(h, h2)


def test_mamba_scan_off_the_16_byte_copies(dev):
    """Operands off a 16-byte boundary (E % 4 == 0): the 4-byte copies,
    equal to the aligned call bit for bit."""
    args = _mamba_args(dev, 2, 300, 256, 16, 3)
    want = ops.mamba_scan(*args)
    moved = []
    for t in args:
        buf = torch.empty(t.numel() + 1, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        moved.append(view)
    assert moved[0].data_ptr() % 16
    got = ops.mamba_scan(*moved)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_mamba_scan_rejects_what_the_kernel_does_not_take(dev):
    dt, Bi, Ci, x, A = _mamba_args(dev, 1, 8, 128, 16, 0)
    with pytest.raises(ValueError):
        ops.mamba_scan(dt.double(), Bi, Ci, x, A)
    with pytest.raises(ValueError):
        ops.mamba_scan(torch.rand(1, 8, 256, device=dev)[..., :128], Bi, Ci,
                       x, A)  # the right shape, not contiguous
    with pytest.raises(ValueError):
        ops.mamba_scan(dt, Bi[..., :4].contiguous(), Ci[..., :4].contiguous(),
                       x, A[:, :4].contiguous())  # N = 4
    with pytest.raises(RuntimeError):
        ops.mamba_scan(dt.requires_grad_(True), Bi, Ci, x, A)


def _fixture_smem_state():
    """(dynamic shared bytes granted to the 16-byte kernel on this device,
    cudaFuncSetAttribute calls made so far) of fixture_double's launcher."""
    from repro_torch.kernels import build
    out = (ctypes.c_longlong * 3)()
    assert build.load().fixture_double_smem_state(out) == 0
    return out[1], out[2]


def test_fixture_double_matches_plain_and_refuses_one_big_block(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(128, 128, generator=g, device=dev)
    want = ref.fixture_double_ref(x)
    # blocks of 32 rows, then 128 (the high-water mark rises), then 50 and
    # 1 (it is reused: no cudaFuncSetAttribute)
    for block_rows in (32, 128, 50, 1):
        granted0, sets0 = _fixture_smem_state()
        need = 2 * 4 * block_rows * 128
        assert torch.equal(ops.fixture_double(x, block_rows), want)
        assert _fixture_smem_state() == (max(granted0, need),
                                         sets0 + (need > granted0))
    granted, sets = _fixture_smem_state()
    assert granted >= 2 * 4 * 128 * 128
    before = ops.fixture_double.launches
    with pytest.raises(RuntimeError, match="fixture_double"):
        ops.fixture_double(torch.ones(2048, 2048, device=dev), 2048)
    assert ops.fixture_double.launches == before
    # asked once and refused: the mark stays where the runtime left it
    assert _fixture_smem_state() == (granted, sets + 1)
    # the refused size leaves no error behind for the next launch
    assert torch.equal(ops.fixture_double(x, 128), want)
    assert _fixture_smem_state() == (granted, sets + 1)
    torch.cuda.synchronize()


@pytest.mark.parametrize("layout", ["cols130", "unaligned"])
def test_fixture_double_scalar_path(dev, layout):
    """The scalar kernel: cols not a multiple of 4, or x not 16-byte
    aligned; bit-equal in one block and in ragged blocks."""
    g = torch.Generator(device=dev).manual_seed(4)
    if layout == "cols130":
        x = torch.randn(96, 130, generator=g, device=dev)
    else:
        x = torch.randn(1 + 96 * 128, generator=g, device=dev)[1:].view(
            96, 128)
    for block_rows in (96, 50, 7):
        assert torch.equal(ops.fixture_double(x, block_rows), x * 2.0)
    torch.cuda.synchronize()


# every kernel at the registry's and the smoke's earlier phases' shapes
# (chip_smoke.plan_cases; Llama-3.2-1B's flat vector and mask size)
_PLAN_CASES = chip_smoke.plan_cases(1_235_814_400, 1_235_814)


@pytest.mark.parametrize("case", range(len(_PLAN_CASES)))
def test_plans_equal_the_library_query(dev, case):
    from repro_torch.kernels import build
    from repro_torch.kernels import plans as P
    fn, shape = _PLAN_CASES[case]
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    extra = {"n_sms": n_sms} if fn is P.zo_update else {}
    want = [l.numbers() for l in fn(**shape, **extra)]
    got = [l.numbers() for l in P.query(build.load(), fn, **shape)]
    assert want == got


GRAPH_CASES = [("llama3.2-1b-reduced", 0.0), ("llama3.2-1b-reduced", 0.9),
               ("gemma2-2b-reduced", 0.0), ("jamba-1.5-large-398b-reduced",
                                            0.0),
               ("xlstm-350m-reduced", 0.0), ("whisper-small-reduced", 0.0),
               ("pixtral-12b-reduced", 0.0)]


@pytest.mark.parametrize("name,temperature", GRAPH_CASES)
def test_engine_graphs_match_eager(dev, name, temperature):
    """The continuous engine with its compile cache as CUDA graphs against
    the same engine run eagerly, on a reduced model of each family: the
    same tokens and cache leaves bit for bit, over a first pass (misses:
    eager calls, then captures) and a second pass of the same requests
    (all hits: replays); the kernels' launch counts those of the eager
    run in each pass; and one burst replayed from the cache bit-equal to
    the same burst run eagerly from the same state."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import ContinuousBatchingEngine
    from repro_torch.utils.tree import tree_leaves
    cfg = get_config(name)
    model = Model(cfg, device=dev)
    params = model.init(seed=0)
    rng = np.random.default_rng(1)
    extra = cfg.n_patches if cfg.frontend == "vision_stub" else 0
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in (5, 300, 3, 17, 40)]
    news = (6, 9, 4, 12, 7)
    kw = dict(max_slots=3, S_max=336 + extra, bucket=16,
              temperature=temperature, seed=1)
    eager = ContinuousBatchingEngine(model, params, graphs=False, **kw)
    graphed = ContinuousBatchingEngine(model, params, **kw)
    assert graphed.graphs and not eager.graphs
    for n_pass in range(2):
        counts = []
        outs = []
        for eng in (eager, graphed):
            for p, m in zip(prompts, news):
                eng.submit(p, max_new_tokens=m)
            before = ops.launches()
            outs.append(eng.run())
            after = ops.launches()
            counts.append({k: after[k] - before[k] for k in after})
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a, b)
        assert counts[0] == counts[1], n_pass
        for a, b in zip(tree_leaves(eager.cache), tree_leaves(graphed.cache)):
            assert torch.equal(a, b), n_pass
        assert torch.equal(eager.last_logits, graphed.last_logits)
        if n_pass == 0:
            misses = graphed.stats["compile_misses"]
    assert graphed.stats["compile_misses"] == misses
    assert graphed.stats["compile_hits"] == eager.stats["compile_hits"]
    if chip_smoke.n_mixers(cfg, "attn", "local_attn"):
        assert counts[1]["flash_decode"] > 0
    same = chip_smoke.replay_matches_eager(torch, graphed)
    assert same and all(same.values()), same
