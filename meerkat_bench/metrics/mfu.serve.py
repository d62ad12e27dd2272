"""Share (%) of the card's peak (989 TFLOP/s) that the serving steps reach
while the device is busy, in the traced part of the window: each admitted
prompt's prefill with the logits of its last position only, and each
decode step whose logits yield a served token (``flops.py``), over the
device's busy seconds.  The cell's load is fixed, so a share over the
window would only restate the load; over the busy time it moves with the
program's speed."""
from meerkat_bench.metrics._common import peaks, share, traced


def read(h):
    t, p = traced(h), peaks(h)
    work = h.facts.get("traced")
    if t is None or p is None or not work or not work["flops"]:
        return None
    return share(work["flops"] / t.busy_s(), p["flops"])
