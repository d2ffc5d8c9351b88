"""Host milliseconds of a sharded SfT on rank 0 of a world: the program's
``parallel.sft`` span (around ``tracker.sft_track_sharded``: the frame's
solve, and the legacy chain's re-anchor after a template swap), mean over
the window's frames after the profiled ones.  Rank 0 waits in it for the
other ranks at every all-reduce."""

LAYER = "parallel/sharded"
UNIT = "ms"
MOVES = "frames_per_s"


def read(rec):
    st = rec.stages.get("parallel.sft")
    return st["mean_ms"] if st and st["count"] else None
