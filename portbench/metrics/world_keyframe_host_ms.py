"""Host milliseconds of a keyframe at world N: the program's
``keyframe.legacy`` span (the host-orchestrated chain on rank 0, with its
three host reads and, after a template swap, the re-anchor), mean over the
keyframes of the window's frames after the profiled ones."""

LAYER = "mapping/legacy"
UNIT = "ms"
MOVES = "frames_per_s"


def read(rec):
    st = rec.stages.get("keyframe.legacy")
    return st["mean_ms"] if st and st["count"] else None
