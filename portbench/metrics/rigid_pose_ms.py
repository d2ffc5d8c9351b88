"""Milliseconds of the rigid frame's pose LM (``pose_opt.solve_pose``)
between CUDA events around each call in the window, median."""

import statistics

LAYER = "tracking/pose_opt"
UNIT = "ms"
MOVES = "frames_per_s"
SPANS = [("rigid_pose", "defslam_tpu_torch.tracking.pose_opt", "solve_pose")]


def read(rec):
    ms = rec.spans.get("rigid_pose")
    return statistics.median(ms) if ms else None
