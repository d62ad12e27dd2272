"""Launch plans of the two kernels redesigned for Hopper (``kernels/plans.py``
against the arithmetic of ``csrc/flash_attn.cu`` and ``csrc/zo_update.cu``),
on the CPU.  ``chip_smoke.check_plans`` and ``tests/test_torch_cuda.py``
hold the same plans against the library's own ``*_plan`` queries on the
card."""
import pytest

from repro_torch.kernels import plans

# every (head_dim, G) the forward takes: G <= 64 score rows of a block
FWD_GROUPS = (1, 2, 3, 4, 6, 8, 16, 32, 64)


def test_forward_grid_launches_the_heaviest_query_tiles_first():
    """At the slice's shape (Llama-3.2-1B, 16 x 512, G 4, head_dim 64) one
    block per (KV head, row, 16-query tile): 8 x 16 x 32 blocks of 128
    threads; under causal masking the key tiles each walks never grow in
    launch order, from all 16 of the last query tile down to 1."""
    (l,) = plans.flash_attn_fwd(16, 512, 8, 4, 64, False)
    assert (l.kernel, l.grid, l.threads) == (
        "flash_fwd<f32,64,64x32>", (8, 16, 32), 128)
    tiles = plans.flash_fwd_tiles(16, 512, 8, 4, 64)
    assert len(tiles) == 8 * 16 * 32
    assert all(a >= b for a, b in zip(tiles, tiles[1:]))
    assert tiles[:128] == [16] * 128 and tiles[-128:] == [1] * 128
    # the query tile on the slowest axis: block i takes tile 31 - i // 128
    assert tiles[128 * 5] == 16 - 5 // 2
    # a 64-key window keeps at most 3 key tiles of 32 for 16 queries; the
    # row of length 100 walks none once the window has left its keys
    cut = plans.flash_fwd_tiles(2, 512, 1, 4, 64, lengths=(512, 100),
                                window=64)
    assert max(cut) == 3 and min(cut[0::2]) >= 1
    assert cut[1::2][:20] == [0] * 20 and cut[-1] == 1


@pytest.mark.parametrize("dh", [64, 128, 256])
@pytest.mark.parametrize("bf16", [False, True])
def test_forward_shared_memory_fits_a_block_at_every_group(dh, bf16):
    """q (f32: hi bits and a lo plane) and double-buffered k and v tiles:
    the same bytes at every G the kernel takes, under the 232,448 a Hopper
    block may opt into; in f32 three blocks an SM at head_dim 64, two at
    128."""
    bytes_ = {plans.flash_attn_fwd(2, 300, 2, G, dh, bf16)[0].dynamic_smem
              for G in FWD_GROUPS}
    (smem,) = bytes_
    assert smem <= plans.H100_SMEM_OPTIN
    bk, size = plans.flash_fwd_bk(dh), 2 if bf16 else 4
    assert bk == (32 if dh == 64 else 16)
    assert smem == (2 if bf16 else 8) * 64 * dh + 4 * bk * dh * size
    per_sm = {64: 3, 128: 2, 256: 1}[dh]
    assert per_sm * (smem + 1024) <= 233_472


@pytest.mark.parametrize("G", FWD_GROUPS)
def test_forward_grid_covers_every_query_once(G):
    """64 / G queries a block (the group's heads folded), every S: the
    query tiles cover S once; the grid holds no more blocks than that."""
    for S in (1, 63, 64, 65, 4208):
        (l,) = plans.flash_attn_fwd(3, S, 2, G, 128, False)
        bq = 64 // G
        assert l.grid[:2] == (2, 3)
        assert (l.grid[2] - 1) * bq < S <= l.grid[2] * bq
    assert plans.flash_attn_fwd(0, 64, 2, G, 64, False) == []


FWD_TILINGS = [(dh, t) for dh, ts in plans.FLASH_FWD_TILINGS.items()
               for t in ts]
BWD_TILINGS = [(dh, t) for dh, ts in plans.FLASH_BWD_TILINGS.items()
               for t in ts]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("dh,tiling", FWD_TILINGS)
def test_forward_tiling_grid_and_shared_memory(dh, tiling, bf16):
    """Each forward tiling (R rows, BK keys): R / 16 warps a block, one
    block per (KV head, row, R // G queries), q (f32: hi and lo planes) and
    double-buffered BK-key k and v tiles under the 232,448 bytes a block
    may opt into; the same query tiles the probe's record walks; G past R
    refused."""
    R, bk = tiling
    size = 2 if bf16 else 4
    for G in (1, 2, 4, R):
        (l,) = plans.flash_attn_fwd(3, 4208, 2, G, dh, bf16, tiling)
        assert l.threads == 2 * R and l.grid == (2, 3, -(-4208 // (R // G)))
        assert l.dynamic_smem == (2 if bf16 else 8) * R * dh \
            + 4 * bk * dh * size
        assert l.dynamic_smem <= plans.H100_SMEM_OPTIN
        assert l.kernel == f"flash_fwd<{'bf16' if bf16 else 'f32'},{dh}," \
            f"{R}x{bk}>"
        tiles = plans.flash_fwd_tiles(1, 300, 1, G, dh, tiling=tiling)
        assert len(tiles) == -(-300 // (R // G))
        assert tiles[0] == -(-300 // bk) and tiles[-1] == -(-(R // G) // bk)
    with pytest.raises(ValueError):
        plans.flash_attn_fwd(1, 64, 1, R + 1, dh, bf16, tiling)
    assert plans.flash_tiling(dh, 2, R // 2, bk) == tiling


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("dh,tiling", BWD_TILINGS)
def test_backward_tiling_grid_and_shared_memory(dh, tiling, bf16):
    """Each backward tiling (R rows, 32 keys): dQ one block per R // G
    queries, dK/dV one per pair of key tiles whatever R; both under the
    opt-in limit, the smaller R in less shared memory."""
    R, bk = tiling
    assert bk == plans.FLASH_BWD_BK
    for G in (1, 2, R):
        dq, = plans.flash_attn_bwd(1, 4352, 4, G, dh, bf16, False, tiling)
        dkv, = plans.flash_attn_bwd(1, 4352, 4, G, dh, bf16, True, tiling)
        assert dq.grid == (-(-4352 // (R // G)), 4, 1)
        assert dkv.grid == ((4352 // bk + 1) // 2, 4, 1) == (68, 4, 1)
        assert max(dq.shared_bytes, dkv.shared_bytes) \
            <= plans.H100_SMEM_OPTIN
        default = plans.flash_attn_bwd(1, 4352, 4, G, dh, bf16, True)[0]
        if tiling != plans.FLASH_BWD_TILINGS[dh][0]:
            assert dkv.dynamic_smem < default.dynamic_smem
    with pytest.raises(ValueError):
        plans.flash_attn_bwd(1, 64, 1, R + 1, dh, bf16, False, tiling)


def test_tilings_are_the_kernels_and_unknown_ones_raise():
    """At least two forward tilings at each head_dim and two backward ones
    at 64 and 128; the defaults are the tilings the kernels had before
    (64 rows; 32 keys at head_dim 64, 16 at 128 and 256; the backward's 64
    rows, 32 at 256); a pair that names none raises."""
    assert all(len(ts) >= 2 for ts in plans.FLASH_FWD_TILINGS.values())
    assert all(len(plans.FLASH_BWD_TILINGS[dh]) >= 2 for dh in (64, 128))
    assert [ts[0] for ts in plans.FLASH_FWD_TILINGS.values()] == [
        (64, 32), (64, 16), (64, 16)]
    assert [plans.flash_bwd_rows(dh) for dh in (64, 128, 256)] == [64, 64,
                                                                   32]
    assert plans.tiling_blocks((128, 32), 4) == (32, 32)
    for dh, G, bq, bk in ((64, 4, 16, 16), (128, 4, 64, 16), (16, 1, 64, 32),
                          (256, 48, 2, 16)):
        with pytest.raises(ValueError, match="names no tiling"):
            plans.flash_tiling(dh, G, bq, bk)
    with pytest.raises(ValueError):
        plans.flash_tiling(64, 4, 16, 64, bwd=True)


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("bf16", [False, True])
def test_fused_update_is_one_block_per_chunk(vec, bf16):
    """fused_update: 256 threads x 16 packs (of 4 elements when every
    operand is aligned) a block, one block per chunk and at least one;
    below, at and above one chunk, and at the slice's flat vector."""
    ch = plans.zo_update_chunk(vec)
    assert ch == 256 * 16 * (4 if vec else 1)
    v = 4 if vec else 1  # the last block takes the n % 4 past the packs
    for n, blocks in ((1, 1), (3, 1), (ch - 1, 1), (ch, 1),
                      (ch + 1, 1 if vec else 2), (ch + v, 2), (2 * ch, 2),
                      (2 * ch + 3, 2 if vec else 3)):
        (l,) = plans.zo_update(n, bf16, False, vec, True)
        assert (l.grid, l.threads, l.dynamic_smem) == ((blocks, 1, 1), 256,
                                                       0)
    if vec:
        (l,) = plans.zo_update(1_235_814_400, bf16, False, vec, True)
        assert l.grid == (75_429, 1, 1)  # 1,235,814,400 / 16,384, rounded up


def test_dual_perturb_plan_is_unchanged():
    """dual_perturb keeps its grid-stride launch: at most 8 blocks an SM."""
    (l,) = plans.zo_update(1_235_814_400, False, False, True, False)
    assert l.grid == (132 * 8, 1, 1) and l.kernel.startswith("dual_perturb")
    assert plans.zo_update(1023, False, True, False, False)[0].grid == \
        (4, 1, 1)
