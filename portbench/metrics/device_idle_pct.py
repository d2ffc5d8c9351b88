"""The device's idle share of a frame: 100 minus the device's busy seconds
per profiled frame (the union of its activities' intervals) over the host
seconds a frame takes in the window's frames after the profiled ones (the
profiler's callbacks slow the host, not the device)."""

import statistics

from portbench import trace

LAYER = "device"
UNIT = "%"
MOVES = "frames_per_s"


def read(rec):
    if rec.trace is None or not rec.frames or not rec.frame_s_after or not rec.trace.device:
        return None
    busy = trace.busy_s(rec.trace) / rec.frames
    return 100.0 * (1.0 - busy / statistics.fmean(rec.frame_s_after))
