"""Kernel B2's share of its roofline: the least time of its launches in the
profiled frames (``rooflines.b2_bound_s`` of each launch's shape and of
the pairs its window admits) over their device time in the profiler's
trace."""

from portbench import rooflines

LAYER = "ops/windowed_match"
UNIT = "%"
MOVES = "frames_per_s"
KERNEL = "windowed_match_kernel"


def read(rec):
    if rec.trace is None:
        return None
    kernels = rec.trace.kernels_named(KERNEL)
    if not kernels or len(kernels) != len(rec.b2_launches):
        return None
    bound = sum(rooflines.b2_bound_s(c["b"], c["n"], c["m"], c["admitted"], rec.rates)
                for c in rec.b2_launches)
    return 100.0 * bound / sum(k.seconds for k in kernels)
