"""Share (%) of the card's peak (989 TFLOP/s) that the traced round's
needed FLOPs reach over its length: two forwards a client step, the
unembedding only for the verbalizer columns at SEP (``flops.py``)."""
from meerkat_bench import flops
from meerkat_bench.metrics._common import peaks, share, traced


def read(h):
    t, p, f = traced(h), peaks(h), h.facts
    if t is None or p is None or not f.get("traced_clients"):
        return None
    need = f["traced_clients"] * f["local_steps"] * flops.zo_step_flops(
        h.m, f["batch"], f["seq_len"], f["n_classes"])
    return share(need / t.window_s(), p["flops"])
