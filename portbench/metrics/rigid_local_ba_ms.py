"""Milliseconds of the rigid mode's local bundle adjustment
(``RigidSystem._local_ba``) between CUDA events around each call in the
window, median."""

import statistics

LAYER = "rigid/ba"
UNIT = "ms"
MOVES = "frame_ms_p95"
SPANS = [("rigid_local_ba", "defslam_tpu_torch.rigid.system", "RigidSystem._local_ba")]


def read(rec):
    ms = rec.spans.get("rigid_local_ba")
    return statistics.median(ms) if ms else None
