"""Share (%) of its byte bound that the decode-attention kernel
(``csrc/decode_attn.cu``) reaches in the traced part of the window: the
k and v cache rows each live slot's step needs (its positions so far, every
layer), q and o, against 3.35 TB/s, over the kernel's profiled time."""
from meerkat_bench.metrics._common import peaks, share, traced


def read(h):
    t, p = traced(h), peaks(h)
    work = h.facts.get("traced")
    if t is None or p is None or not work or not work["decode_bytes"]:
        return None
    s, n = t.kernel_s(lambda name: "decode_attn" in name)
    if not n:
        return None
    return share(work["decode_bytes"] / p["bytes"], s)
