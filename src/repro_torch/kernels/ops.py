"""Wrappers around the port's CUDA kernels (``repro.kernels.ops``).

Each wrapper takes the same arguments as its counterpart in the JAX
package.  For tensors on the CPU it runs the kernel's plain version
(``ref.py``); for CUDA tensors it checks device, dtype, shape and
contiguity, allocates its outputs with ``torch.empty``, launches the kernel
on the current stream, raises if the launch was refused, and adds one to its
``launches`` count.  Nothing else touches the counts, and nothing falls
back.  The two backward wrappers have no public counterpart there (the JAX
package calls its ``_bwd_*_call`` inside its ``custom_vjp``); they take the
model layout, and :class:`FlashAttentionFn` chains them as that VJP does.

The TPU wrappers padded flat vectors to (R, 128) tiles, transposed
attention operands into the grouped layout and padded decode caches to a
block multiple; the CUDA kernels mask their own ragged edges and read the
model layout, so none of these steps is needed here.

While the static analyzer records a program (``analysis/walk.py`` sets
:data:`recorder`), each wrapper call becomes one kernel record: the ops it
runs inside (the plain version on the CPU, the output allocations on the
card) go under that record, with the launch plan of its shapes
(``plans.py``).  With no recorder active a call costs one ``is None`` test
more.

Under ``torch.func.vmap`` (the train burst's stacked (w+, w-) forward,
``core/fl_step.py``) two wrappers have a vmap rule, on the card and on the
CPU alike: :func:`flash_attention` and :func:`mamba_scan` fold the mapped
axis into their batch axis and make one call at the folded shape, which is
the launch that is counted and recorded.  Every other wrapper raises when
a ``torch.func`` transform hands it its tensors: nothing reaches a
``data_ptr()`` batched, and nothing runs a plain version instead.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build, plans, ref

KERNEL_HEAD_DIMS = (64, 128, 256)  # the flash forward
BWD_HEAD_DIMS = (64, 128, 256)     # the flash backward
DECODE_HEAD_DIMS = (64, 128, 256)
DECODE_MAX_G = 16
MAMBA_STATE_DIMS = (8, 16)  # the selective scan's d_state instances
_FLOATS = (torch.float32, torch.bfloat16)


recorder = None  # the analyzer's active Recorder (analysis/walk.py), or None


def _transformed(args, kwargs) -> bool:
    """Whether a ``torch.func`` transform (vmap, grad) wraps a tensor of
    the call; one flag read while no transform is active."""
    if not torch._C._are_functorch_transforms_active():
        return False
    wrapped = torch._C._functorch.is_functorch_wrapped_tensor
    return any(isinstance(t, torch.Tensor) and wrapped(t)
               for t in (*args, *kwargs.values()))


def _recorded(plan_of, vmap_rule: bool = False):
    """Decorate a wrapper so that an active :data:`recorder` takes the call
    as one kernel record; ``plan_of(n_sms, *args, **kwargs)`` gives its
    launches (``plans.Launch``) from the call's arguments.  A call on a
    ``torch.func`` transform's tensors raises unless the wrapper has a
    ``vmap_rule``; with one, it is not recorded, as the rule's folded call
    is."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _transformed(args, kwargs):
                if not vmap_rule:
                    raise RuntimeError(
                        f"kernel {fn.__name__} has no vmap rule: it cannot "
                        f"run under torch.func transforms")
                return fn(*args, **kwargs)
            rec = recorder
            if rec is None:
                return fn(*args, **kwargs)
            return rec.kernel(fn.__name__, plan_of, fn, args, kwargs)
        return wrapper
    return deco


def _fold(t, in_dim, n: int):
    """A vmap rule's operand with its mapped axis ``in_dim`` (None: not
    mapped, broadcast) folded into its leading axis: [n * B, ...]; a free
    reshape where the mapped axis leads a contiguous tensor."""
    t = t.expand(n, *t.shape) if in_dim is None else t.movedim(in_dim, 0)
    return t.reshape(n * t.shape[1], *t.shape[2:])


def _aligned(t, nbytes: int) -> bool:
    return t is None or t.data_ptr() % nbytes == 0


def _zo_plan(update: bool):
    def plan(n_sms, w_flat, z_flat, m_flat, _scalar):
        bf16 = w_flat.dtype == torch.bfloat16
        vec = (_aligned(w_flat, 8 if bf16 else 16) and _aligned(z_flat, 16)
               and _aligned(m_flat, 16))
        return plans.zo_update(w_flat.numel(), bf16, m_flat is not None, vec,
                               update, n_sms)
    return plan


def _flash_plan(dkv=None):
    """The forward's plan (``dkv`` None) or the dQ / dK-dV backward's, at
    the tiling the call launches (:func:`fwd_tiling`; the backward
    wrappers' ``tiling``)."""
    def plan(n_sms, q, k, v, *_, block_q=None, block_k=None, tiling=None,
             **__):
        B, S, H, dh = q.shape
        KV = k.shape[2]
        bf16 = q.dtype == torch.bfloat16
        if dkv is None:
            tiling = fwd_tiling(S, dh, H // KV, block_q, block_k)
            if tiling is None:  # a layout the kernel does not take
                return []
            return plans.flash_attn_fwd(B, S, KV, H // KV, dh, bf16, tiling)
        return plans.flash_attn_bwd(B, S, KV, H // KV, dh, bf16, dkv, tiling)
    return plan


def fwd_tiling(S: int, hd: int, G: int, block_q=None, block_k=None):
    """The forward tiling (R, BK) a :func:`flash_attention` call launches:
    the pinned (``block_q``, ``block_k``); where the call pins nothing (or
    one of the two, the other then from the pick) the ``kernels.autotune``
    table's pick for (S, hd, G), else the head_dim's default tiling (what
    the kernel launched before it had a choice).  ValueError for a pair
    that names no tiling of the kernel; None where nothing is pinned and
    the default tiling does not take the layout (its head_dim or G)."""
    if block_q is None or block_k is None:
        from repro_torch.kernels import autotune
        pick = autotune.best_blocks(S, hd, G, op="fwd")
        if pick is None:
            tilings = plans.FLASH_FWD_TILINGS.get(hd)
            if not tilings or G > tilings[0][0]:
                if block_q is None and block_k is None:
                    return None
                raise ValueError(f"the flash forward has no tiling at "
                                 f"head_dim {hd}, G {G}")
            pick = plans.tiling_blocks(tilings[0], G)
        block_q = pick[0] if block_q is None else block_q
        block_k = pick[1] if block_k is None else block_k
    return plans.flash_tiling(hd, G, int(block_q), int(block_k))


def grad_tiling(S: int, hd: int, G: int):
    """The backward tiling (R, BK) of a differentiable call: the
    ``kernels.autotune`` table's ``grad`` pick for (S, hd, G), else the
    head_dim's default; None where the default does not take the layout."""
    from repro_torch.kernels import autotune
    pick = autotune.best_blocks(S, hd, G, op="grad")
    if pick is not None:
        return plans.flash_tiling(hd, G, *pick, bwd=True)
    tilings = plans.FLASH_BWD_TILINGS.get(hd)
    return tilings[0] if tilings and G <= tilings[0][0] else None


def _on_cpu(*ts) -> bool:
    """True for operands all on the CPU, False for operands all on one CUDA
    device; raises otherwise.  Reads each tensor's flags and device index
    (-1 on the CPU) and builds no device objects; skips None by identity
    (``None in (tensor, ...)`` calls ``Tensor.__eq__``, tens of us)."""
    index = None
    for t in ts:
        if t is None:
            continue
        i = t.get_device()
        if index is None:
            index = i
        if i != index or not (t.is_cuda if i >= 0 else t.is_cpu):
            break
    else:
        if index is not None:
            return index < 0
    raise ValueError(f"operands must share one CPU or CUDA device, got "
                     f"{[str(t.device) for t in ts if t is not None]}")


def _check_flat(w, z, m):
    n = w.shape[0]
    if w.dim() != 1 or w.dtype not in _FLOATS:
        raise ValueError(f"w must be a flat f32/bf16 vector, got "
                         f"{tuple(w.shape)} {w.dtype}")
    for name, t in (("z", z), ("m", m)):
        if t is None:
            continue
        if t.shape != (n,) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 [{n}], got "
                             f"{tuple(t.shape)} {t.dtype}")
    for t in (w, z, m):
        if t is not None and not t.is_contiguous():
            raise ValueError("flat operands must be contiguous")


def _scalar_on(x, device) -> torch.Tensor:
    """A one-element f32 device tensor holding x (a float or a 0-d tensor),
    read by the kernel through its pointer: no host sync.  A float is
    filled on the device; copying a host scalar there would sync the
    stream."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).reshape(1)
    return torch.full((1,), x, dtype=torch.float32, device=device)


def _stream(t) -> int:
    """The raw handle of the current stream on CUDA tensor ``t``'s device.
    ``torch._C._cuda_getCurrentRawStream`` (what PyTorch's own Triton
    launcher calls) returns it without building a ``torch.cuda.Stream``
    object, as ``torch.cuda.current_stream(dev).cuda_stream`` does: ~0.1
    against ~3 us a call on an H100 machine's host (PERF.md)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _ptr(t):
    return None if t is None else t.data_ptr()


def _zo_dual_plan(n_sms, w_flat, z_flat, m_flat, eps, *, out=None):
    return _zo_plan(update=False)(n_sms, w_flat, z_flat, m_flat, eps)


@_recorded(_zo_dual_plan)
def zo_dual_perturb_flat(w_flat, z_flat, m_flat, eps, *, out=None):
    """(w + eps*z*m, w - eps*z*m) over flat [N] vectors; ``m_flat=None``
    means z is already zero off the sparse coordinates.  ``out``, a
    contiguous [2, N] tensor of w's dtype, takes w+ and w- as its two rows
    (the stacked forward's pair, with no copy); it is returned then."""
    if out is not None and (out.shape != (2, *w_flat.shape)
                            or out.dtype != w_flat.dtype
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous [2, {w_flat.shape[0]}] "
                         f"{w_flat.dtype} tensor, got {tuple(out.shape)} "
                         f"{out.dtype}")
    if _on_cpu(w_flat, z_flat, m_flat, out):
        plus, minus = ref.dual_perturb_ref(w_flat, z_flat, m_flat, eps)
        if out is None:
            return plus, minus
        out[0].copy_(plus)
        out[1].copy_(minus)
        return out
    _check_flat(w_flat, z_flat, m_flat)
    lib = build.load()
    eps_t = _scalar_on(eps, w_flat.device)
    if out is None:
        plus = torch.empty_like(w_flat)
        minus = torch.empty_like(w_flat)
    else:
        plus, minus = out[0], out[1]
    rc = lib.zo_dual_perturb(
        w_flat.data_ptr(), z_flat.data_ptr(), _ptr(m_flat), eps_t.data_ptr(),
        plus.data_ptr(), minus.data_ptr(), w_flat.numel(),
        int(w_flat.dtype == torch.bfloat16), _stream(w_flat))
    build.check(lib, rc, "zo_dual_perturb")
    zo_dual_perturb_flat.launches += 1
    return (plus, minus) if out is None else out


@_recorded(_zo_plan(update=True))
def zo_fused_update_flat(w_flat, z_flat, m_flat, scale):
    """w + scale*z*m over flat [N] vectors (scale = -lr*g, a float or a 0-d
    tensor); ``m_flat=None``: pre-masked z."""
    if _on_cpu(w_flat, z_flat, m_flat):
        return ref.fused_update_ref(w_flat, z_flat, m_flat, scale)
    _check_flat(w_flat, z_flat, m_flat)
    lib = build.load()
    s_t = _scalar_on(scale, w_flat.device)
    out = torch.empty_like(w_flat)
    rc = lib.zo_fused_update(
        w_flat.data_ptr(), z_flat.data_ptr(), _ptr(m_flat), s_t.data_ptr(),
        out.data_ptr(), w_flat.numel(), int(w_flat.dtype == torch.bfloat16),
        _stream(w_flat))
    build.check(lib, rc, "zo_fused_update")
    zo_fused_update_flat.launches += 1
    return out


@_recorded(lambda n_sms, gp_flat, z_flat, g: plans.gradip_reduce(
    gp_flat.numel(), _aligned(gp_flat, 16) and _aligned(z_flat, 16)))
def gradip_flat(gp_flat, z_flat, g):
    """GradIP = g * <gp, z> (f32) over flat sparse-coordinate vectors;
    ``g`` is a host float.  Returns a 0-d f32 tensor on gp's device."""
    if _on_cpu(gp_flat, z_flat):
        return ref.gradip_reduce_ref(gp_flat, z_flat, g)
    n = gp_flat.numel()
    if (gp_flat.dim() != 1 or z_flat.dim() != 1 or z_flat.numel() != n
            or gp_flat.dtype != torch.float32 or z_flat.dtype != torch.float32
            or not (gp_flat.is_contiguous() and z_flat.is_contiguous())):
        raise ValueError("gradip operands must be contiguous f32 [n]")
    lib = build.load()
    stream = _stream(gp_flat)
    key = (gp_flat.get_device(), stream)
    scratch = _gradip_scratch.get(key) or _new_gradip_scratch(key)
    out = torch.empty_like(scratch[1])
    rc = lib.gradip_reduce(gp_flat.data_ptr(), z_flat.data_ptr(), float(g),
                           scratch[0], out.data_ptr(), n, stream)
    build.check(lib, rc, "gradip_reduce")
    gradip_flat.launches += 1
    return out


# (device index, raw stream) -> (pointer, 0-d f32 tensor): gradip_reduce's
# scratch on that stream, the partial sums and the ticket of its
# last-block-done reduction (gradip.cu), zeroed once; each call leaves the
# ticket at 0 for the next on the stream, and two streams never share one.
# The 0-d tensor, a view of the scratch, is what each call's output is
# made like (``empty_like`` parses no device or dtype).  Eager launches
# only: a graph replayed on another stream would share the capture
# stream's ticket, so the launcher refuses a capturing stream, and no
# scratch is made under capture (its zeroing would not run).
_gradip_scratch = {}


def _new_gradip_scratch(key) -> tuple:
    with torch.cuda.device(key[0]):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("gradip_flat cannot be captured in a CUDA "
                               "graph: its scratch is per stream")
    words = plans.GRADIP_MAX_PARTIALS + 1  # the partials, then the ticket
    scratch = torch.zeros(words + 1, dtype=torch.float32,
                          device=torch.device("cuda", key[0]))
    _gradip_scratch[key] = entry = (scratch.data_ptr(), scratch[words])
    return entry


def _lengths(lengths, B: int, S: int, like) -> torch.Tensor:
    """Per-row lengths as the kernels take them: [B] int32 on ``like``'s
    device.  The kernels clamp each to [0, S] themselves (the plain
    versions mask the same keys), so an int32 contiguous [B] tensor there
    passes through untouched, and anything else costs one op: a fill for
    None or a host integer, or one copy that casts and broadcasts."""
    if lengths is None:
        lengths = S
    if isinstance(lengths, torch.Tensor):
        if (lengths.dtype is torch.int32 and lengths.dim() == 1
                and lengths.shape[0] == B and lengths.is_contiguous()
                and lengths.get_device() == like.get_device()):
            return lengths
    elif isinstance(lengths, int):
        return torch.full((B,), min(max(lengths, 0), S), dtype=torch.int32,
                          device=like.device)
    else:
        lengths = torch.as_tensor(lengths)
    out = torch.empty(B, dtype=torch.int32, device=like.device)
    return out.copy_(lengths.reshape(-1).expand(B))


def _attn_dims(q, k, v):
    """(B, S, KV, G, hd) of model-layout GQA operands."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if H % KV or k.shape != (B, S, KV, hd) or v.shape != k.shape:
        raise ValueError(f"bad GQA shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    return B, S, KV, H // KV, hd


def _check_attn_kernel(q, k, v, G, hd, *, dims=KERNEL_HEAD_DIMS, max_g=64,
                       do=None, rows=(), row_shape=()):
    """What the flash kernels take: q, k, v (and dO) in one of f32/bf16,
    a head_dim in ``dims`` (the forward's, or the backward's
    ``BWD_HEAD_DIMS``), G <= ``max_g``, and f32 per-row statistics."""
    if q.dtype not in _FLOATS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share f32 or bf16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if do is not None and (do.dtype != q.dtype or do.shape != q.shape):
        raise ValueError(f"dO must match q, got {tuple(do.shape)} {do.dtype}")
    for t in rows:
        if t.dtype != torch.float32 or tuple(t.shape) != row_shape:
            raise ValueError(f"lse/delta must be f32 {row_shape}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if hd not in dims or G > max_g:
        raise ValueError(f"the flash kernel takes head_dim in {dims} and "
                         f"G <= {max_g}, got {hd}, {G}")


def _flash_fwd(q, k, v, L, window, softcap, causal, tiling):
    """(O, lse) of the forward: the kernel at ``tiling`` on CUDA, its plain
    version on the CPU.  ``L`` is the [B] int32 lengths tensor."""
    if _on_cpu(q, k, v):
        return ref.flash_attention_ref(q, k, v, L, window=window,
                                       softcap=softcap, causal=causal)
    out, lse, _ = _fwd_launch(q, k, v, L, window, softcap, causal, tiling)
    flash_attention.launches += 1
    return out, lse


def _aligned16(t):
    """t, or where its data is off a 16-byte boundary a copy in fresh
    memory (the caching allocator's blocks are aligned)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _fwd_launch(q, k, v, L, window, softcap, causal, tiling, *,
                one_pass=False, blocks=None):
    """Launch the forward kernel at ``tiling`` (R, BK) on CUDA q, k, v
    (checked, contiguous; an operand off the 16-byte alignment the
    kernel's copies read is copied into fresh memory first): (O, lse, the
    probe's ``blocks`` record).  ``blocks`` None is the wrapped launch; a
    [blocks, 2] int64 tensor makes it a probe launch
    (``flash_attn_fwd_probe``)."""
    B, S, KV, G, hd = _attn_dims(q, k, v)
    _check_attn_kernel(q, k, v, G, hd)
    rows, bk = plans.resolve_tiling(hd, G, tiling)
    q, k, v = (_aligned16(t.contiguous()) for t in (q, k, v))
    lib = build.load()
    out = torch.empty_like(q)
    lse = torch.empty((B, KV, S, G), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), L.data_ptr(),
            out.data_ptr(), lse.data_ptr(), B, S, KV, G, hd, int(window),
            float(softcap), int(bool(causal)), float(hd ** -0.5),
            int(q.dtype == torch.bfloat16), rows, bk)
    if blocks is None:
        rc = lib.flash_attn_fwd(*args, _stream(q))
        build.check(lib, rc, "flash_attn_fwd")
    else:
        rc = lib.flash_attn_fwd_probe(int(one_pass), *args, blocks.data_ptr(),
                                      _stream(q))
        build.check(lib, rc, "flash_attn_fwd_probe")
    return out, lse, blocks


def flash_attention_fwd_probe(q, k, v, lengths=None, *,
                              one_pass: bool = False, window: int = 0,
                              softcap: float = 0.0, causal: bool = True,
                              tiling=None):
    """A measurement launch of the forward kernel at ``tiling`` (R, BK;
    None: the head_dim's default) on CUDA operands of
    :func:`flash_attention`, outside the wrapped path (no launch is
    counted): ((O, lse), a [blocks, 2] int64 record of the key tiles each
    block walked and the SM clocks it took, in launch order).
    ``one_pass`` (f32, head_dim 64 or 256, the default tiling) runs both
    products as one TF32 pass: the precision control of the kernel's
    3xTF32 split."""
    B, S, KV, G, hd = _attn_dims(q, k, v)
    L = _lengths(lengths, B, S, q)
    plan = plans.flash_attn_fwd(B, S, KV, G, hd, q.dtype == torch.bfloat16,
                                tiling)
    n_blocks = 0
    if plan:
        n_blocks = plan[0].grid[0] * plan[0].grid[1] * plan[0].grid[2]
    blocks = torch.zeros((n_blocks, 2), dtype=torch.int64, device=q.device)
    out, lse, blocks = _fwd_launch(q, k, v, L, window, softcap, causal,
                                   tiling, one_pass=one_pass, blocks=blocks)
    return (out, lse), blocks


def _bwd_operands(q, k, v, do, lse, delta, B, S, KV, G, hd, tiling):
    """The backward kernels' operands, checked (``BWD_HEAD_DIMS``, G <=
    the rows of ``tiling``, None: the default) and contiguous, and the
    tiling (R, BK).  The kernels read q, k, v and dO in 16-byte chunks and
    refuse a pointer off that alignment."""
    rows = plans.flash_bwd_rows(hd) if hd in BWD_HEAD_DIMS else 0
    if tiling is not None:
        rows = tiling[0]
    _check_attn_kernel(q, k, v, G, hd, dims=BWD_HEAD_DIMS, max_g=rows,
                       do=do, rows=(lse, delta), row_shape=(B, KV, S, G))
    tiling = plans.resolve_tiling(hd, G, tiling, bwd=True)
    return tuple(t.contiguous() for t in (q, k, v, do, lse, delta)), tiling


@_recorded(_flash_plan(dkv=False))
def flash_attention_bwd_dq(q, k, v, lengths, lse, delta, do, *,
                           window: int = 0, softcap: float = 0.0,
                           causal: bool = True, tiling=None):
    """dQ [B, S, H, hd] f32 of the flash attention, recomputed from the
    forward's ``lse`` and ``delta = rowsum(dO * O)`` (both [B, KV, S, G]
    f32); q, dO [B, S, H, hd] and k, v [B, S, KV, hd] in one of f32/bf16.
    ``tiling`` (R, BK) one of ``plans.FLASH_BWD_TILINGS[hd]``; None: the
    default."""
    B, S, KV, G, hd = _attn_dims(q, k, v)
    L = _lengths(lengths, B, S, q)
    if _on_cpu(q, k, v, lse, delta, do):
        return ref.flash_attn_bwd_dq_ref(q, k, v, L, lse, delta, do,
                                         window=window, softcap=softcap,
                                         causal=causal)
    (q, k, v, do, lse, delta), tiling = _bwd_operands(
        q, k, v, do, lse, delta, B, S, KV, G, hd, tiling)
    lib = build.load()
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    rc = lib.flash_attn_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        L.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, S,
        KV, G, hd, int(window), float(softcap), int(bool(causal)),
        float(hd ** -0.5), int(q.dtype == torch.bfloat16), *tiling,
        _stream(q))
    build.check(lib, rc, "flash_attn_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


@_recorded(_flash_plan(dkv=True))
def flash_attention_bwd_dkv(q, k, v, lengths, lse, delta, do, *,
                            window: int = 0, softcap: float = 0.0,
                            causal: bool = True, tiling=None):
    """(dK, dV), each [B, S, KV, hd] f32; arguments as
    :func:`flash_attention_bwd_dq`."""
    B, S, KV, G, hd = _attn_dims(q, k, v)
    L = _lengths(lengths, B, S, q)
    if _on_cpu(q, k, v, lse, delta, do):
        return ref.flash_attn_bwd_dkv_ref(q, k, v, L, lse, delta, do,
                                          window=window, softcap=softcap,
                                          causal=causal)
    (q, k, v, do, lse, delta), tiling = _bwd_operands(
        q, k, v, do, lse, delta, B, S, KV, G, hd, tiling)
    lib = build.load()
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    rc = lib.flash_attn_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        L.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, S, KV, G, hd, int(window), float(softcap),
        int(bool(causal)), float(hd ** -0.5), int(q.dtype == torch.bfloat16),
        *tiling, _stream(q))
    build.check(lib, rc, "flash_attn_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd_probe(q, k, v, lengths, lse, delta, do, *,
                              dkv: bool, one_pass: bool = False,
                              window: int = 0, softcap: float = 0.0,
                              causal: bool = True, tiling=None):
    """A measurement launch of the dQ (``dkv`` False) or dK/dV kernel on
    CUDA operands of :func:`flash_attention_bwd_dq`, outside the wrapped
    path (no launch is counted): (its outputs, a [blocks, 2] int64 record of
    the key or query tiles each block walked and the SM clocks it took, in
    launch order), at ``tiling`` (None: the default).  ``one_pass`` (f32,
    head_dim 64 or 256, the default tiling) runs every product as one TF32
    pass: the precision control of the kernels' 3xTF32 split."""
    B, S, KV, G, hd = _attn_dims(q, k, v)
    L = _lengths(lengths, B, S, q)
    (q, k, v, do, lse, delta), tiling = _bwd_operands(
        q, k, v, do, lse, delta, B, S, KV, G, hd, tiling)
    bf16 = q.dtype == torch.bfloat16
    (launch,) = plans.flash_attn_bwd(B, S, KV, G, hd, bf16, dkv, tiling)
    n_blocks = launch.grid[0] * launch.grid[1] * launch.grid[2]
    blocks = torch.zeros((n_blocks, 2), dtype=torch.int64, device=q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    if dkv:
        out = (torch.empty(k.shape, **f32), torch.empty(v.shape, **f32))
        ptrs = (0, out[0].data_ptr(), out[1].data_ptr())
    else:
        out = torch.empty(q.shape, **f32)
        ptrs = (out.data_ptr(), 0, 0)
    lib = build.load()
    rc = lib.flash_attn_bwd_probe(
        int(dkv), int(one_pass), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), L.data_ptr(), lse.data_ptr(), delta.data_ptr(), *ptrs,
        B, S, KV, G, hd, int(window), float(softcap), int(bool(causal)),
        float(hd ** -0.5), int(bf16), *tiling, blocks.data_ptr(), _stream(q))
    build.check(lib, rc, "flash_attn_bwd_probe")
    return out, blocks


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention (the JAX package's ``custom_vjp``):
    the forward kernel saves only O and the per-row logsumexp, and the
    backward runs the dQ and dK/dV recompute kernels, so no [S, S] tensor
    outlives a tile.  ``tiling`` is the forward's (R, BK), ``bwd_tiling``
    the backward's (both kernels take it).  Returns (O, lse); lse is not
    differentiable.

    Its vmap rule folds the mapped axis into B (``[n, B, S, ...]`` to
    ``[n * B, S, ...]``, the lengths repeated per member) and makes one
    :func:`flash_attention` call there: one launch for the n members, each
    row computed as alone, so bit-equal to a launch per member."""

    @staticmethod
    def forward(q, k, v, L, window, softcap, causal, tiling, bwd_tiling):
        return _flash_fwd(q, k, v, L, window, softcap, causal, tiling)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, L, window, softcap, causal, _, bwd_tiling = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, L, out, lse)
        ctx.attn = dict(window=window, softcap=softcap, causal=causal,
                        tiling=bwd_tiling)
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, do, _):
        q, k, v, L, out, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        # rowsum(dO * O): O(S*dh) work outside the kernels, as in the JAX
        # package, so both passes read it as a [B, KV, S, G] stream
        delta = ref.flash_attention_delta(out, do, k.shape[2])
        dq = flash_attention_bwd_dq(q, k, v, L, lse, delta, do, **ctx.attn)
        dk, dv = flash_attention_bwd_dkv(q, k, v, L, lse, delta, do,
                                         **ctx.attn)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None, None)

    @staticmethod
    def vmap(info, in_dims, q, k, v, L, window, softcap, causal, tiling,
             bwd_tiling):
        n = info.batch_size
        qf, kf, vf, Lf = (_fold(t, d, n)
                          for t, d in zip((q, k, v, L), in_dims))
        G = qf.shape[2] // kf.shape[2]
        bq, bk = (None, None) if tiling is None else \
            plans.tiling_blocks(tiling, G)
        out, lse = flash_attention(qf, kf, vf, Lf, window=window,
                                   softcap=softcap, causal=causal,
                                   return_lse=True, block_q=bq, block_k=bk)
        return (out.unflatten(0, (n, -1)), lse.unflatten(0, (n, -1))), (0, 0)


@_recorded(_flash_plan(), vmap_rule=True)
def flash_attention(q, k, v, lengths=None, *, window: int = 0,
                    softcap: float = 0.0, causal: bool = True,
                    return_lse: bool = False, block_q=None, block_k=None):
    """GQA flash attention in the model layout: q [B, S, H, hd]; k, v
    [B, S, KV, hd] -> O [B, S, H, hd] (head h in group h // G), and with
    ``return_lse`` also the per-row logsumexp [B, KV, S, G] f32.

    ``lengths`` ([B] or a scalar; None = S) masks right-padded keys.  The
    softmax semantics are those of ``repro.kernels.flash_attention``:
    causal, optional sliding ``window``, tanh ``softcap`` before the mask,
    f32 accumulation, O in q's dtype.

    ``block_q`` (queries) and ``block_k`` (keys) a tile pick the forward's
    tiling, as in the JAX package: where the call pins neither, the
    ``kernels.autotune`` table's measured pick for (S, head_dim, G), else
    the head_dim's default tiling; a pair that names no tiling of the
    kernel (``plans.FLASH_FWD_TILINGS``: block_q = rows // G) raises
    ``ValueError``, on the CPU too (where the plain version runs whatever
    the tiling).

    While autograd records through q, k or v, or under ``torch.func.vmap``
    (:class:`FlashAttentionFn`'s vmap rule), the call goes through
    :class:`FlashAttentionFn`, whose backward runs the recompute kernels at
    the table's ``grad`` pick (else the default backward tiling);
    otherwise it is one forward launch."""
    B, S, KV, G, hd = _attn_dims(q, k, v)
    L = _lengths(lengths, B, S, q)
    tiling = fwd_tiling(S, hd, G, block_q, block_k)
    args = (q, k, v, L, int(window), float(softcap), bool(causal), tiling)
    if (torch._C._are_functorch_transforms_active()
            or (torch.is_grad_enabled()
                and any(t.requires_grad for t in (q, k, v)))):
        out, lse = FlashAttentionFn.apply(*args, grad_tiling(S, hd, G))
    else:
        out, lse = _flash_fwd(*args)
    return (out, lse) if return_lse else out


@_recorded(lambda n_sms, q, k, v, length, softcap=0.0: plans.flash_decode(
    q.shape[0], k.shape[1], q.shape[1], q.shape[2], q.shape[3],
    q.dtype == torch.bfloat16))
def flash_decode(q, k, v, length, softcap: float = 0.0):
    """One-token GQA decode attention (``repro.kernels.ops.flash_decode``):
    q [B, KVH, G, dh] (the query grouped per KV head); k, v [B, S, KVH, dh]
    (the cache in the model layout); ``length`` a scalar or per-row [B]
    (each row's live cache prefix, clamped to S).  Returns [B, KVH, G, dh]
    in q's dtype; a row of length 0 gets zeros.

    On CUDA it launches ``csrc/decode_attn.cu`` once (a cluster of splits
    per KV head and row, combined in the launch) on contiguous operands as
    they come from the model; it copies nothing and pads nothing, and
    allocates only the output.  Nothing is kept per stream, so a call can
    be captured in a CUDA graph."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_decode takes q [B, KVH, G, dh] and k, v "
                         f"[B, S, KVH, dh], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    B, KV, G, dh = q.shape
    S = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, KV, dh) \
            or v.shape != k.shape:
        raise ValueError(f"bad decode shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if _on_cpu(q, k, v):
        return ref.decode_attention_ref(q, k, v, length, softcap)
    if q.dtype not in _FLOATS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share f32 or bf16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if dh not in DECODE_HEAD_DIMS or not 1 <= G <= DECODE_MAX_G:
        raise ValueError(f"the decode kernel takes head_dim in "
                         f"{DECODE_HEAD_DIMS} and G <= {DECODE_MAX_G}, got "
                         f"{dh}, {G}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_decode operands must be contiguous")
    align = 4 * k.element_size()
    if k.data_ptr() % align or v.data_ptr() % align:
        raise ValueError("flash_decode reads the cache in 4-element vectors: "
                         "k and v must be aligned to 4 elements")
    L = _lengths(length, B, S, q)
    lib = build.load()
    out = torch.empty_like(q)
    rc = lib.flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), L.data_ptr(),
        out.data_ptr(), B, S, KV, G, dh, float(softcap), dh ** -0.5,
        int(q.dtype is torch.bfloat16), _stream(q))
    build.check(lib, rc, "flash_decode")
    flash_decode.launches += 1
    return out


class MambaScanFn(torch.autograd.Function):
    """:func:`mamba_scan` as a function with a vmap rule (no backward, as
    the kernel has none): the mapped axis folds into B, dt, B, C and x to
    ``[n * B, S, ...]``, and a mapped A (a member's -exp(A_log), which the
    stacked forward always maps) becomes the kernel's per-member A
    ``[n, E, N]``, each serving its member's B rows.  One
    :func:`mamba_scan` call, one launch for the n members, each row
    computed as alone, so bit-equal to a launch per member."""

    @staticmethod
    def forward(dt, B_in, C_in, x, A):
        return _mamba_scan(dt, B_in, C_in, x, A)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass  # no backward: mamba_scan raises under autograd first

    @staticmethod
    def vmap(info, in_dims, dt, B_in, C_in, x, A):
        n = info.batch_size
        dtf, Bf, Cf, xf = (_fold(t, d, n) for t, d in
                           zip((dt, B_in, C_in, x), in_dims))
        if in_dims[4] is not None:
            A = A.movedim(in_dims[4], 0).contiguous()  # [n, E, N]
        y, h = mamba_scan(dtf, Bf, Cf, xf, A)
        return (y.unflatten(0, (n, -1)), h.unflatten(0, (n, -1))), (0, 0)


@_recorded(lambda n_sms, dt, B_in, C_in, x, A: plans.mamba_scan(
    *dt.shape, B_in.shape[-1]), vmap_rule=True)
def mamba_scan(dt, B_in, C_in, x, A):
    """Mamba-1 selective scan (``repro.kernels.ops.mamba_scan_op``): dt, x
    [B, S, E] (dt after softplus); B_in, C_in [B, S, N]; A [E, N], or [G,
    E, N] with G dividing B (each run of B / G rows its own A: the stacked
    forward's folded call).  Returns (y [B, S, E] f32, h_last [B, E, N]
    f32), ``h_t = exp(dt_t * A) h_{t-1} + (dt_t * x_t) B_t`` and ``y_t =
    <h_t, C_t>`` from h = 0.

    The JAX kernel has no VJP, and neither has this one: it raises while
    autograd records through any operand (the model's ``scan`` route is the
    differentiable one).  On CUDA it launches ``csrc/mamba_scan.cu`` on
    contiguous f32 operands with N in ``MAMBA_STATE_DIMS``; any B, S and E
    (the TPU wrapper needed S and E divisible by its blocks).  Under
    ``torch.func.vmap`` it goes through :class:`MambaScanFn`'s rule."""
    if dt.dim() != 3 or B_in.dim() != 3:
        raise ValueError(f"mamba_scan takes dt [B, S, E] and B_in [B, S, N], "
                         f"got {tuple(dt.shape)}, {tuple(B_in.shape)}")
    Bsz, S, E = dt.shape
    N = B_in.shape[-1]
    if (x.shape != dt.shape or B_in.shape != (Bsz, S, N)
            or C_in.shape != B_in.shape or A.shape[-2:] != (E, N)
            or A.dim() not in (2, 3)
            or (A.dim() == 3 and (A.shape[0] < 1 or Bsz % A.shape[0]))):
        raise ValueError(
            f"bad selective-scan shapes dt {tuple(dt.shape)}, B "
            f"{tuple(B_in.shape)}, C {tuple(C_in.shape)}, x "
            f"{tuple(x.shape)}, A {tuple(A.shape)}")
    ts = (dt, B_in, C_in, x, A)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError("mamba_scan has no backward: run the model's "
                           "'scan' route under autograd")
    if torch._C._are_functorch_transforms_active():
        return MambaScanFn.apply(*ts)
    return _mamba_scan(*ts)


def _mamba_scan(dt, B_in, C_in, x, A):
    """The checked :func:`mamba_scan` call: the kernel on CUDA, its plain
    version on the CPU."""
    if _on_cpu(dt, B_in, C_in, x, A):
        return ref.mamba_scan_ref(dt, B_in, C_in, x, A)
    ts = (dt, B_in, C_in, x, A)
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError(f"mamba_scan takes f32 operands, got "
                         f"{[str(t.dtype) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("mamba_scan operands must be contiguous")
    Bsz, S, E = dt.shape
    N = B_in.shape[-1]
    if N not in MAMBA_STATE_DIMS or S < 1:
        raise ValueError(f"the selective-scan kernel takes N in "
                         f"{MAMBA_STATE_DIMS} and S >= 1, got N={N}, S={S}")
    a_rows = Bsz // A.shape[0] if A.dim() == 3 else Bsz
    lib = build.load()
    y = torch.empty_like(dt)
    h_last = torch.empty((Bsz, E, N), dtype=torch.float32, device=dt.device)
    rc = lib.mamba_scan(dt.data_ptr(), B_in.data_ptr(), C_in.data_ptr(),
                        x.data_ptr(), A.data_ptr(), y.data_ptr(),
                        h_last.data_ptr(), Bsz, S, E, N, max(a_rows, 1),
                        _stream(dt))
    build.check(lib, rc, "mamba_scan")
    mamba_scan.launches += 1
    return y, h_last


@_recorded(lambda n_sms, x, block_rows: plans.fixture_double(
    *x.shape, block_rows, _aligned(x, 16)))  # y: from the caching allocator
def fixture_double(x, block_rows: int):
    """x * 2 for x [rows, cols] f32, ``block_rows`` rows a block: the
    static analyzer's memory-ceiling fixture (``repro.analysis.fixtures``
    ``_memory_bad_vmem`` / ``_memory_good``).  Each block stages its input
    and output tiles in shared memory, 2 * block_rows * cols * 4 bytes; a
    size past the card's per-block limit is refused by the runtime, and
    the wrapper raises (nothing falls back)."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"fixture_double takes f32 [rows, cols], got "
                         f"{tuple(x.shape)} {x.dtype}")
    if block_rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    if _on_cpu(x):
        return ref.fixture_double_ref(x)
    if not x.is_contiguous():
        raise ValueError("fixture_double takes a contiguous x")
    lib = build.load()
    out = torch.empty_like(x)
    rows, cols = x.shape
    rc = lib.fixture_double(x.data_ptr(), out.data_ptr(), rows, cols,
                            int(block_rows), _stream(x))
    build.check(lib, rc, "fixture_double")
    fixture_double.launches += 1
    return out


KERNEL_WRAPPERS = (zo_dual_perturb_flat, zo_fused_update_flat, gradip_flat,
                   flash_attention, flash_attention_bwd_dq,
                   flash_attention_bwd_dkv, flash_decode, mamba_scan,
                   fixture_double)


def reset_launches() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launches() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


reset_launches()
