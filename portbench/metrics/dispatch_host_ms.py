"""Host milliseconds of a frame's dispatch (``System._track``'s
``frame.dispatch`` stage: the frame's launches, before any validation),
mean over the window's frames after the profiled ones; the program's own
stage timer, on in the traced run only."""

LAYER = "system"
UNIT = "ms"
MOVES = "frames_per_s"


def read(rec):
    st = rec.stages.get("frame.dispatch")
    return st["mean_ms"] if st and st["count"] else None
