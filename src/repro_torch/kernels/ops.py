"""Wrappers around the port's CUDA kernels (``repro.kernels.ops``).

Each wrapper takes the same arguments as its counterpart in the JAX
package.  For tensors on the CPU it runs the kernel's plain version
(``ref.py``); for CUDA tensors it checks device, dtype, shape and
contiguity, allocates its outputs with ``torch.empty``, launches the kernel
on the current stream, raises if the launch was refused, and adds one to its
``launches`` count.  Nothing else touches the counts, and nothing falls
back.

The TPU wrappers padded flat vectors to (R, 128) tiles and transposed
attention operands into the grouped layout; the CUDA kernels mask their own
ragged edges and read the model layout, so neither step is needed here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

KERNEL_HEAD_DIMS = (64, 128)
_FLOATS = (torch.float32, torch.bfloat16)
_GRADIP_SCRATCH = 1024  # partial sums of the first pass (gradip.cu)


def _on_cpu(*ts) -> bool:
    devs = {t.device.type for t in ts if t is not None}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or len({t.device for t in ts if t is not None}) > 1:
        raise ValueError(f"operands must share one CPU or CUDA device, got "
                         f"{[str(t.device) for t in ts if t is not None]}")
    return False


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
    read by the kernel through its pointer: no host sync."""
    return torch.as_tensor(x, dtype=torch.float32, device=device).reshape(1)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def zo_dual_perturb_flat(w_flat, z_flat, m_flat, eps):
    """(w + eps*z*m, w - eps*z*m) over flat [N] vectors; ``m_flat=None``
    means z is already zero off the sparse coordinates."""
    if _on_cpu(w_flat, z_flat, m_flat):
        return ref.dual_perturb_ref(w_flat, z_flat, m_flat, eps)
    _check_flat(w_flat, z_flat, m_flat)
    lib = build.load()
    eps_t = _scalar_on(eps, w_flat.device)
    plus = torch.empty_like(w_flat)
    minus = torch.empty_like(w_flat)
    rc = lib.zo_dual_perturb(
        w_flat.data_ptr(), z_flat.data_ptr(), _ptr(m_flat), eps_t.data_ptr(),
        plus.data_ptr(), minus.data_ptr(), w_flat.numel(),
        int(w_flat.dtype == torch.bfloat16), _stream(w_flat.device))
    build.check(lib, rc, "zo_dual_perturb")
    zo_dual_perturb_flat.launches += 1
    return plus, minus


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
        _stream(w_flat.device))
    build.check(lib, rc, "zo_fused_update")
    zo_fused_update_flat.launches += 1
    return out


def gradip_flat(gp_flat, z_flat, g):
    """GradIP = g * <gp, z> (f32) over flat sparse-coordinate vectors;
    ``g`` is a host float.  Returns a 0-d f32 tensor on gp's device."""
    if _on_cpu(gp_flat, z_flat):
        return ref.gradip_reduce_ref(gp_flat, z_flat, g)
    n = gp_flat.shape[0]
    for t in (gp_flat, z_flat):
        if t.dim() != 1 or t.shape[0] != n or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("gradip operands must be contiguous f32 [n]")
    lib = build.load()
    scratch = torch.empty(_GRADIP_SCRATCH, dtype=torch.float32,
                          device=gp_flat.device)
    out = torch.empty(1, dtype=torch.float32, device=gp_flat.device)
    rc = lib.gradip_reduce(gp_flat.data_ptr(), z_flat.data_ptr(), float(g),
                           scratch.data_ptr(), out.data_ptr(), n,
                           _stream(gp_flat.device))
    build.check(lib, rc, "gradip_reduce")
    gradip_flat.launches += 1
    return out[0]


def _lengths(lengths, B: int, S: int, device) -> torch.Tensor:
    if lengths is None:
        return torch.full((B,), S, dtype=torch.int32, device=device)
    L = torch.as_tensor(lengths, device=device).to(torch.int32).reshape(-1)
    return torch.clamp(L.expand(B), max=S).contiguous()


def flash_attention(q, k, v, lengths=None, *, window: int = 0,
                    softcap: float = 0.0, causal: bool = True,
                    return_lse: bool = False):
    """GQA flash-attention forward in the model layout: q [B, S, H, hd];
    k, v [B, S, KV, hd] -> O [B, S, H, hd] (head h in group h // G), and
    with ``return_lse`` also the per-row logsumexp [B, KV, S, G] f32.

    ``lengths`` ([B] or a scalar; None = S) masks right-padded keys.  The
    softmax semantics are those of ``repro.kernels.flash_attention``:
    causal, optional sliding ``window``, tanh ``softcap`` before the mask,
    f32 accumulation, O in q's dtype."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if H % KV or k.shape != (B, S, KV, hd) or v.shape != k.shape:
        raise ValueError(f"bad GQA shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    G = H // KV
    L = _lengths(lengths, B, S, q.device)
    if _on_cpu(q, k, v):
        out, lse = ref.flash_attention_ref(q, k, v, L, window=window,
                                           softcap=softcap, causal=causal)
        return (out, lse) if return_lse else out
    if q.dtype not in _FLOATS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share f32 or bf16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in KERNEL_HEAD_DIMS or G > 64:
        raise ValueError(f"the flash kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS} and G <= 64, got {hd}, {G}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    lib = build.load()
    out = torch.empty_like(q)
    lse = torch.empty((B, KV, S, G), dtype=torch.float32, device=q.device)
    rc = lib.flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), L.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, S, KV, G, hd, int(window),
        float(softcap), int(bool(causal)), float(hd ** -0.5),
        int(q.dtype == torch.bfloat16), _stream(q.device))
    build.check(lib, rc, "flash_attn_fwd")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


KERNEL_WRAPPERS = (zo_dual_perturb_flat, zo_fused_update_flat, gradip_flat,
                   flash_attention)


def reset_launches() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launches() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


reset_launches()
