"""Device milliseconds of NCCL's kernels (their names hold ``nccl``) on rank
0's card in the profiled frames, per frame: how long the ranks spend
meeting.  An NCCL kernel runs from the moment its card reaches the
collective until every rank has, and has moved its data, so the wait for
the slowest rank is in it."""

LAYER = "parallel/sharded"
UNIT = "ms"
MOVES = "frames_per_s"


def read(rec):
    if rec.trace is None or not rec.frames:
        return None
    nccl = [a for a in rec.trace.kernels if "nccl" in a.name.lower()]
    if not nccl:
        return None
    return 1e3 * sum(a.seconds for a in nccl) / rec.frames
