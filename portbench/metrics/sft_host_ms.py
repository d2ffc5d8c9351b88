"""Host milliseconds of a frame's SfT solve: the program's ``tracking.sft``
span (around the solve in ``tracker._track_frame``), mean over the
window's frames after the profiled ones."""

LAYER = "tracking/sft"
UNIT = "ms"
MOVES = "frames_per_s"


def read(rec):
    st = rec.stages.get("tracking.sft")
    return st["mean_ms"] if st and st["count"] else None
