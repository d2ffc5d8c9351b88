"""Kernel launches on the device in the profiled frames, per frame."""

LAYER = "device"
UNIT = "count"
MOVES = "frames_per_s"


def read(rec):
    if rec.trace is None or not rec.frames:
        return None
    return len(rec.trace.kernels) / rec.frames
