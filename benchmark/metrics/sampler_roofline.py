"""The sampler kernel's share of its roofline, in %: the operations the
window's shots need (Philox words and lookups a shot) at the float32 peak,
over the device time of the kernels named ``sampler_kernel``."""

from benchmark.metrics import _counts


def read(run):
    t = run.trace
    if t is None:
        return None
    device_s = sum(s for name, _, s, _ in t.kernels
                   if "sampler_kernel" in name)
    ops = _counts.sampler_ops(run.window.work["cliques"]) \
        * run.window.work["shots"]
    return _counts.roofline_percent(_counts.bound_seconds(ops=ops), device_s)
