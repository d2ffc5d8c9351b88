"""95th percentile of the host time of a frame, ms, over the traced run's
frames after the profiled ones (the window's last, which carries the
flush, left out).  ``frame_ms_p95``'s quantity, read per layer in a cell
whose runs spread too widely for its end-to-end bound; the profiler's
callbacks stay on after its session, so these frames run slower than an
untraced run's."""

import numpy as np

LAYER = "system"
UNIT = "ms"
MOVES = "frames_per_s"


def read(rec):
    if not rec.frame_s_after:
        return None
    return float(np.percentile(np.asarray(rec.frame_s_after) * 1e3, 95))
