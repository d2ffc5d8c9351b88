"""Kernel B1's share of its roofline: the least time of its launches in the
profiled frames (``rooflines.b1_bound_s`` of each launch's shape) over
their device time in the profiler's trace."""

from portbench import rooflines

LAYER = "ops/hamming"
UNIT = "%"
MOVES = "frames_per_s"
KERNEL = "hamming_kernel"


def read(rec):
    if rec.trace is None:
        return None
    kernels = rec.trace.kernels_named(KERNEL)
    if not kernels or len(kernels) != len(rec.b1_shapes):
        return None
    bound = sum(rooflines.b1_bound_s(n, m) for n, m in rec.b1_shapes)
    return 100.0 * bound / sum(k.seconds for k in kernels)
