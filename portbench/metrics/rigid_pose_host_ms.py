"""Host milliseconds of the rigid frame's pose LM: the program's
``rigid.pose`` span (``RigidSystem._pose_solve``), mean over the window's
frames after the profiled ones."""

LAYER = "tracking/pose_opt"
UNIT = "ms"
MOVES = "frames_per_s"


def read(rec):
    st = rec.stages.get("rigid.pose")
    return st["mean_ms"] if st and st["count"] else None
