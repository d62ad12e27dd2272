"""Share (%) of its bound that the flash-attention forward kernel
(``csrc/flash_attn.cu``) reaches in the traced round: each launch's causal
QK^T and PV over the cell's q [B, S, H, hd] against 989 TFLOP/s, or its
q, k, v and o bytes against 3.35 TB/s, whichever is longer, over the
profiled device time."""
from meerkat_bench import flops
from meerkat_bench.metrics._common import peaks, share, traced


def read(h):
    t, p = traced(h), peaks(h)
    if t is None or p is None:
        return None
    s, n = t.kernel_s(lambda name: "flash_fwd" in name)
    if not n:
        return None
    D, H, KV, hd, _, _, _ = flops.dims(h.m)
    ops, nbytes = flops.flash_fwd_work(h.facts["batch"], h.facts["seq_len"],
                                       H, KV, hd)
    return share(n * flops.bound_s(ops, nbytes, p), s)
