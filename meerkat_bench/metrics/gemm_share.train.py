"""Share (%) of the traced round's device busy time spent in cuBLAS GEMM
kernels, by kernel name: the model forward's matmuls."""
from meerkat_bench.metrics._common import GEMM, share, traced


def read(h):
    t = traced(h)
    if t is None:
        return None
    s, n = t.kernel_s(lambda name: bool(GEMM.search(name)))
    return share(s, t.busy_s()) if n else None
