"""Launch plans of the port's CUDA kernels: for given shapes, the grid,
threads per block and shared bytes of each launch a wrapper makes.

Each function repeats the arithmetic of its launcher in ``csrc/*.cu`` (the
``LaunchPlan`` each launcher builds and its ``*_plan`` entry point reports),
so the static analyzer (``analysis/``) can hold every kernel record's
shared bytes against a block's limit on the CPU as on the card, and
``chip_smoke.py`` holds these plans against the library's own answer
(:func:`query`: ``cudaFuncGetAttributes`` for the static bytes, and the
dynamic bytes, grid and cluster the launcher passes).  Pure arithmetic on
shapes: nothing here allocates a tensor or needs a card.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

# NVIDIA H100 SXM (the hopper-kernels guide's table): 132 SMs, 227 KB of
# shared memory a block may opt in to.  On the card both are read from the
# device; these stand in for it on the CPU.
H100_SMS = 132
H100_SMEM_OPTIN = 232_448


@dataclass(frozen=True)
class Launch:
    """One kernel launch: ``grid`` (x, y, z), ``threads`` per block, the
    kernel's static shared bytes, the dynamic shared bytes passed and the
    blocks of a thread-block cluster along grid x (1: no cluster)."""
    kernel: str
    grid: tuple
    threads: int
    static_smem: int
    dynamic_smem: int
    cluster: int = 1

    @property
    def shared_bytes(self) -> int:
        return self.static_smem + self.dynamic_smem

    def numbers(self) -> tuple:
        return (*self.grid, self.threads, self.static_smem, self.dynamic_smem,
                self.cluster)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ------------------------------------------------------------ zo_update.cu --
ZO_THREADS, ZO_BLOCKS_PER_SM, ZO_UNROLL = 256, 8, 16


def zo_update_chunk(vec: bool) -> int:
    """Elements of one ``fused_update`` block: 256 threads x 16 packs of 4
    (``vec``) or 1 element."""
    return ZO_THREADS * ZO_UNROLL * (4 if vec else 1)


def zo_update(n: int, bf16: bool, has_m: bool, vec: bool, update: bool,
              n_sms: int = H100_SMS):
    """``zo_dual_perturb`` (update False): one grid-stride launch of at most
    8 blocks per SM.  ``zo_fused_update``: one block per chunk of
    :func:`zo_update_chunk` elements, at least one (the last also takes the
    n % 4 elements past the packs).  Packs of 4 when every operand is
    aligned (``vec``)."""
    if n <= 0:
        return []
    v = 4 if vec else 1
    if update:
        blocks = max(1, _cdiv(n // v, ZO_THREADS * ZO_UNROLL))
    else:
        blocks = _cdiv(n // v + n % v, ZO_THREADS)
        blocks = max(1, min(blocks, n_sms * ZO_BLOCKS_PER_SM))
    name = "fused_update_kernel" if update else "dual_perturb_kernel"
    return [Launch(f"{name}<{'bf16' if bf16 else 'f32'},{int(has_m)},{v}>",
                   (blocks, 1, 1), ZO_THREADS, 0, 0)]


# --------------------------------------------------------------- gradip.cu --
GRADIP_THREADS, GRADIP_MAX_PARTIALS = 256, 1024


def gradip_reduce(n: int, vec: bool):
    """One launch: a block per 256 packs (of 4 when ``vec``) up to 1024
    blocks, each with one f32 per warp of shared memory; the last block
    to finish sums the partials (last-block-done)."""
    v = 4 if vec else 1
    blocks = max(1, min(_cdiv(n // v + n % v, GRADIP_THREADS),
                        GRADIP_MAX_PARTIALS))
    return [Launch(f"gradip_reduce_kernel<{v}>", (blocks, 1, 1),
                   GRADIP_THREADS, 4 * (GRADIP_THREADS // 32), 0)]


# ------------------------------------------------------------ flash_attn.cu --
# The forward's tilings per head_dim, as csrc/flash_attn.cu's TilingsOf
# lists them: (score rows R = BQ x G, a block of R / 16 warps; keys per
# tile BK), the default first.  A call launches block_q = R // G queries
# by block_k = BK keys a tile.  Only tilings that spill no registers
# beyond their head_dim's default (ptxas, sm_90a) are kept: (32, 16) at
# head_dim 256 spilled 152 bytes.
FLASH_FWD_TILINGS = {64: ((64, 32), (64, 64), (128, 32), (128, 64)),
                     128: ((64, 16), (64, 32), (128, 16), (128, 32)),
                     256: ((64, 16), (64, 8), (32, 8))}
FLASH_ROWS, FLASH_THREADS = 64, 128  # the default tilings' rows, threads


def flash_fwd_bk(dh: int) -> int:
    """Keys per tile of the forward's default tiling: 32 at head_dim 64,
    else 16."""
    return FLASH_FWD_TILINGS[dh][0][1]


def flash_tilings(dh: int, G: int, bwd: bool = False) -> tuple:
    """The forward's (or with ``bwd`` the backward's) tilings (R, BK) at
    head_dim ``dh`` that take G heads a group (G <= R), default first."""
    table = FLASH_BWD_TILINGS if bwd else FLASH_FWD_TILINGS
    return tuple(t for t in table.get(dh, ()) if G <= t[0])


def tiling_blocks(tiling, G: int) -> tuple:
    """(block_q, block_k) a tiling (R, BK) launches at G: R // G queries
    by BK keys a tile."""
    return tiling[0] // G, tiling[1]


def flash_tiling(dh: int, G: int, block_q: int, block_k: int,
                 bwd: bool = False) -> tuple:
    """The tiling (R, BK) of the forward (or the backward) kernel at head
    dim ``dh`` and G that launches (``block_q``, ``block_k``); ValueError
    where the kernel has none (nothing falls back to a default)."""
    for t in flash_tilings(dh, G, bwd):
        if tiling_blocks(t, G) == (block_q, block_k):
            return t
    names = [tiling_blocks(t, G) for t in flash_tilings(dh, G, bwd)]
    raise ValueError(
        f"(block_q, block_k) = ({block_q}, {block_k}) names no tiling of "
        f"the flash {'backward' if bwd else 'forward'} at head_dim {dh}, "
        f"G {G}: it takes {names}")


def resolve_tiling(dh: int, G: int, tiling, bwd: bool = False) -> tuple:
    """``tiling``, or the default where it is None; ValueError for one the
    kernel does not have at (dh, G)."""
    if tiling is None:
        return (FLASH_BWD_TILINGS if bwd else FLASH_FWD_TILINGS)[dh][0]
    if tuple(tiling) not in flash_tilings(dh, G, bwd):
        raise ValueError(f"{tuple(tiling)} is no tiling of the flash "
                         f"{'backward' if bwd else 'forward'} at head_dim "
                         f"{dh}, G {G}")
    return tuple(tiling)


def _tname(bf16: bool, dh: int, tiling) -> str:
    return f"{'bf16' if bf16 else 'f32'},{dh},{tiling[0]}x{tiling[1]}"


def flash_attn_fwd(B: int, S: int, KVH: int, G: int, dh: int, bf16: bool,
                   tiling=None):
    """One block of R / 16 warps per (KV head, row, query tile of R / G
    queries), the query tiles on the grid's slowest axis from the last to
    the first (heaviest first under causal masking); q (f32: its hi bits
    and a lo plane) and double-buffered k and v tiles of BK keys in the
    operand type.  ``tiling`` (R, BK): None is the head_dim's default."""
    R, bk = resolve_tiling(dh, G, tiling)
    if B == 0 or S == 0:
        return []
    bq = R // G
    if bf16:
        smem = 2 * (R * dh + 4 * bk * dh)
    else:
        smem = 8 * R * dh + 16 * bk * dh
    return [Launch(f"flash_fwd<{_tname(bf16, dh, (R, bk))}>",
                   (KVH, B, _cdiv(S, bq)), 2 * R, 0, smem)]


def flash_fwd_tiles(B: int, S: int, KVH: int, G: int, dh: int, *,
                    lengths=None, window: int = 0, causal: bool = True,
                    tiling=None):
    """The key tiles each forward block walks, in launch order (the grid of
    :func:`flash_attn_fwd`, blockIdx.x fastest): those the TPU kernel's
    pruning predicate (``_block_needed``) keeps for the block's query tile.
    ``lengths`` per row (None: S).  ``flash_attention_fwd_probe`` reads the
    same counts back from the card."""
    R, bk = resolve_tiling(dh, G, tiling)
    bq = R // G
    n_q, n_k = _cdiv(S, bq), _cdiv(S, bk)
    out = []
    for z in range(n_q):
        q0 = (n_q - 1 - z) * bq
        for b in range(B):
            L = S if lengths is None else min(lengths[b], S)
            walked = sum(1 for t in range(n_k)
                         if t * bk < L
                         and (not causal or t * bk <= q0 + bq - 1)
                         and (not window or t * bk + bk - 1 > q0 - window))
            out += [walked] * KVH
    return out


# ------------------------------------------------------- flash_attn_bwd.cu --
FLASH_BWD_BK, FLASH_BWD_THREADS = 32, 256  # keys per tile of both kernels
# The backward's tilings per head_dim, as csrc/flash_attn_bwd.cu's
# TilingsOf lists them: (score rows R of a query tile, keys per tile), the
# default first; both kernels of a call take the same one.
FLASH_BWD_TILINGS = {64: ((64, 32), (32, 32)), 128: ((64, 32), (32, 32)),
                     256: ((32, 32),)}


def flash_bwd_rows(dh: int) -> int:
    """Score rows (BQ queries x G heads folded) of the default backward
    tiling's query tile: 64, or 32 at head_dim 256; G may not exceed
    them."""
    return FLASH_BWD_TILINGS[dh][0][0]


def flash_attn_bwd(B: int, S: int, KVH: int, G: int, dh: int, bf16: bool,
                   dkv: bool, tiling=None):
    """dQ: one block per (R / G queries, KV head, row), heaviest first;
    q and dO tiles, double-buffered k and v tiles (operand type), the ds
    tile as TF32 hi and lo and two row statistics (f32).  dK/dV: one block
    per (pair of 32-key tiles t and n-1-t, KV head, row); k and v tiles,
    double-buffered q and dO tiles (operand type), the p^T and ds^T tiles
    as hi and lo and double-buffered statistics (f32).  In f32 dQ at
    head_dim <= 128, and dK/dV at 128, also hold the lo planes of their k
    and v tiles.  ``tiling`` (R, 32): None is the head_dim's default."""
    rows, bk = resolve_tiling(dh, G, tiling, bwd=True)
    if B == 0 or S == 0:
        return []
    ts = 2 if bf16 else 4
    t = _tname(bf16, dh, (rows, bk))
    if dkv:  # f32 key tiles split once (their lo planes) at head_dim 128
        pre = not bf16 and dh == 128
        smem = (ts * (2 * bk * dh + 4 * rows * dh)
                + 4 * (4 * bk * rows + 4 * rows) + pre * 4 * 2 * bk * dh)
        return [Launch(f"flash_bwd_dkv<{t}>",
                       (_cdiv(_cdiv(S, bk), 2), KVH, B), FLASH_BWD_THREADS,
                       0, smem)]
    pre = not bf16 and dh <= 128  # ... and at 64 in dQ
    smem = (ts * (2 * rows * dh + 4 * bk * dh) + 4 * (2 * rows * bk + 2 * rows)
            + pre * 4 * 4 * bk * dh)
    return [Launch(f"flash_bwd_dq<{t}>",
                   (_cdiv(S, rows // G), KVH, B), FLASH_BWD_THREADS, 0, smem)]


# ---------------------------------------------------------- decode_attn.cu --
DECODE_THREADS, DECODE_MAX_CLUSTER, DECODE_SPLIT_KEYS = 128, 16, 256
DECODE_STAGES = 2  # K/V tiles in flight or in use


def decode_cluster(S: int) -> tuple:
    """(cluster size, chunk) of the decode launch over an S-position cache:
    min(16, ceil(S / 256)) splits of ceil(S / cluster) positions (S = 0:
    one block, chunk 1)."""
    if S <= 0:
        return 1, 1
    cs = min(DECODE_MAX_CLUSTER, _cdiv(S, DECODE_SPLIT_KEYS))
    return cs, _cdiv(S, cs)


def flash_decode(B: int, S: int, KVH: int, G: int, dh: int, bf16: bool):
    """One launch: a cluster of :func:`decode_cluster` blocks (the splits)
    per KV head and row, the first block combining them; an instantiation
    for groups of up to 4 heads and one for up to 16.  Each block holds q
    (rows padded by 4 floats), four warps' partial scores, the
    probabilities and three statistics per head, then ``DECODE_STAGES``
    stages of K and V tiles of 2048 / dh keys (rows padded by 4 elements)
    in the operand type, which the end of a split reuses for its key
    groups' partial outputs (min(4, 512 / dh) x G x dh f32)."""
    if B == 0 or KVH == 0:
        return []
    cs, _ = decode_cluster(S)
    bk = 2048 // dh
    head = G * (dh + 4) + 4 * G * bk + G * (bk + 1) + 3 * G
    kv = (2 if bf16 else 4) * 2 * DECODE_STAGES * bk * (dh + 4)
    red = 4 * min(4, 512 // dh) * G * dh
    smem = 4 * _cdiv(head, 4) * 4 + max(kv, red)
    gb = 4 if G <= 4 else 16
    return [Launch(f"decode_attn<{'bf16' if bf16 else 'f32'},{dh},{gb}>",
                   (cs, KVH, B), DECODE_THREADS, 0, smem, cs)]


# ----------------------------------------------------------- mamba_scan.cu --
MAMBA_THREADS, MAMBA_SEG, MAMBA_STEPS = 128, 4, 16
MAMBA_CHANNELS = MAMBA_THREADS // MAMBA_SEG


def mamba_scan(B: int, S: int, E: int, N: int):
    """One block of 4 warps per 32 channels of a row (4 lanes a channel),
    walking S in tiles of 4 segments x 16 steps; two tile buffers (dt and
    x as [segment][16 x 32 channels], B and C as [segment][16 x N], each
    segment padded by 32 / 4 floats), then A' and the carry [32][N]."""
    if B == 0 or E == 0:
        return []
    pad = 32 // MAMBA_SEG
    x_seg = MAMBA_STEPS * MAMBA_CHANNELS + pad
    bc_seg = MAMBA_STEPS * N + pad
    buf = 2 * MAMBA_SEG * (x_seg + bc_seg)
    smem = 4 * (2 * buf + 2 * MAMBA_CHANNELS * N)
    return [Launch(f"mamba_scan_kernel<{N}>",
                   (_cdiv(E, MAMBA_CHANNELS), B, 1), MAMBA_THREADS, 0, smem)]


# ------------------------------------------------------- fixture_double.cu --
FIXTURE_THREADS = 256


def fixture_double(rows: int, cols: int, block_rows: int, aligned: bool):
    """One block per ``block_rows`` rows; its input and output tiles in
    dynamic shared memory, as the Pallas block held both refs in VMEM.
    16-byte packs where ``cols % 4 == 0`` and both operands are 16-byte
    ``aligned``, the same grid and bytes either way."""
    v = 4 if aligned and cols % 4 == 0 else 1
    return [Launch(f"fixture_double_kernel<{v}>",
                   (_cdiv(rows, block_rows), 1, 1), FIXTURE_THREADS, 0,
                   2 * 4 * block_rows * cols)]


# ------------------------------------------------------------ the queries --
_QUERIES = {
    zo_update: lambda lib, out, n, bf16, has_m, vec, update: (
        lib.zo_update_plan(int(update), n, int(bf16), int(has_m), int(vec),
                           out)),
    gradip_reduce: lambda lib, out, n, vec: lib.gradip_reduce_plan(
        n, int(vec), out),
    flash_attn_fwd: lambda lib, out, B, S, KVH, G, dh, bf16, tiling=None: (
        lib.flash_attn_fwd_plan(B, S, KVH, G, dh, int(bf16),
                                *resolve_tiling(dh, G, tiling), out)),
    flash_attn_bwd: lambda lib, out, B, S, KVH, G, dh, bf16, dkv,
    tiling=None: lib.flash_attn_bwd_plan(
        int(dkv), B, S, KVH, G, dh, int(bf16),
        *resolve_tiling(dh, G, tiling, bwd=True), out),
    flash_decode: lambda lib, out, B, S, KVH, G, dh, bf16: (
        lib.flash_decode_plan(B, S, KVH, G, dh, int(bf16), out)),
    mamba_scan: lambda lib, out, B, S, E, N: lib.mamba_scan_plan(
        B, S, E, N, out),
    fixture_double: lambda lib, out, rows, cols, block_rows, aligned: (
        lib.fixture_double_plan(rows, cols, block_rows, int(aligned), out)),
}
MAX_LAUNCHES = 1
PLAN_VALUES = 7  # common.cuh kPlanValues: Launch.numbers() without the name


def query(lib, plan_fn, **shape) -> list:
    """The launches the loaded library reports for ``plan_fn`` at ``shape``
    (its ``*_plan`` entry point), as :class:`Launch` records named as
    ``plan_fn`` names them; ``shape`` as ``plan_fn`` takes it, without
    ``n_sms`` (the library reads the device's)."""
    out = (ctypes.c_longlong * (1 + PLAN_VALUES * MAX_LAUNCHES))()
    rc = _QUERIES[plan_fn](lib, out, **shape)
    if rc:
        raise RuntimeError(f"{plan_fn.__name__}_plan: CUDA error {rc} "
                           f"({lib.repro_cuda_error_string(rc).decode()})")
    names = [l.kernel for l in plan_fn(**shape)]
    at = [1 + PLAN_VALUES * i for i in range(out[0])]
    return [Launch(names[i] if i < len(names) else "?",
                   tuple(out[a:a + 3]), *out[a + 3:a + PLAN_VALUES])
            for i, a in enumerate(at)]
