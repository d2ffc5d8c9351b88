"""Host milliseconds of the rigid mode's local bundle adjustment: the
program's ``rigid.local_ba`` span (``RigidSystem._local_ba``), mean over
the calls in the window's frames after the profiled ones."""

LAYER = "rigid/ba"
UNIT = "ms"
MOVES = "frame_ms_p95"


def read(rec):
    st = rec.stages.get("rigid.local_ba")
    return st["mean_ms"] if st and st["count"] else None
