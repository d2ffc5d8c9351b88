"""CUDA runtime launch calls (``cudaLaunchKernel``, ``cudaLaunchKernelExC``,
``cuLaunchKernel``) in the profiled frames that start inside the program's
SfT spans (``tracking.sft``, on the trace's clock: ``profiling.timeline()``),
per profiled frame; a launch call made inside another (``cuLaunchKernel``
inside ``cudaLaunchKernel``) counts once."""

import bisect

from portbench.metrics.sft_idle_pct import SPAN, program_spans

LAYER = "tracking/sft"
UNIT = "count"
MOVES = "frames_per_s"
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")  # and their suffixed forms


def read(rec):
    if rec.trace is None or not rec.frames:
        return None
    spans = sorted((s.t0_ns, s.t1_ns) for s in program_spans() if s.name == SPAN)
    if not spans:
        return None
    starts = [s for s, _ in spans]
    n, end = 0, 0
    for a in rec.trace.host:  # in order of start
        if not a.name.startswith(LAUNCH_CALLS) or a.start_ns < end:
            continue  # not a launch, or a launch call inside the one before
        end = a.end_ns
        i = bisect.bisect_right(starts, a.start_ns) - 1
        n += i >= 0 and a.start_ns < spans[i][1]
    return n / rec.frames
