"""Share (%) of their byte bound that the flat ZO kernels reach in the
traced round (``csrc/zo_update.cu``: the dual perturb reads w and z and
writes w+ and w-, the fused update reads delta and z and writes delta', at
``n_pad`` f32 elements), over their profiled device time."""
from meerkat_bench import flops
from meerkat_bench.metrics._common import peaks, share, traced


def read(h):
    t, p = traced(h), peaks(h)
    if t is None or p is None:
        return None
    dual_b, upd_b = flops.zo_update_bytes(h.facts["n_pad"])
    s1, n1 = t.kernel_s(lambda n: "dual_perturb_kernel" in n)
    s2, n2 = t.kernel_s(lambda n: "fused_update_kernel" in n)
    if not (n1 or n2):
        return None
    need = (n1 * flops.bound_s(0, dual_b, p) + n2 * flops.bound_s(0, upd_b, p))
    return share(need, s1 + s2)
