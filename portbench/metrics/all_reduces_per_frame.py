"""All-reduce calls of a world's sharded solvers a frame on rank 0: the
program's counter ``parallel.all_reduce`` (fed by
``parallel.sharded.Group.all_reduce``), over the window's frames after the
profiled ones (the flush at the end included), per frame."""

LAYER = "parallel/sharded"
UNIT = "count"
MOVES = "frames_per_s"


def read(rec):
    st = rec.stages.get("parallel.all_reduce")
    if not st or not st["count"] or not rec.frame_s_after:
        return None
    # frame_s_after leaves out the window's last frame, which carries the flush
    return st["count"] / (len(rec.frame_s_after) + 1)
