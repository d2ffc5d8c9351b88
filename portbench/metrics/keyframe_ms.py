"""Device milliseconds of a keyframe step, from CUDA events at
``keyframe_step``'s stage marks (``System._kf_mark``), median over the
window's keyframe steps."""

import statistics

LAYER = "mapping/mapper"
UNIT = "ms"
MOVES = "frames_per_s"


def read(rec):
    steps = [s["keyframe_ms"] for s in rec.keyframe_steps if len(s) > 1]
    return statistics.median(steps) if steps else None
