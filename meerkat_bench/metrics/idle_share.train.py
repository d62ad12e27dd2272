"""Share (%) of the traced round with no kernel running on the device."""
from meerkat_bench.metrics._common import traced


def read(h):
    t = traced(h)
    return None if t is None else 100.0 * (1 - t.busy_s() / t.window_s())
