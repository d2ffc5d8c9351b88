"""Host milliseconds of feature extraction: the program's
``frontend.extract`` span (inside ``frontend.extract_features``, which
the deformable and rigid frames share), mean over the window's frames
after the profiled ones."""

LAYER = "frontend"
UNIT = "ms"
MOVES = "frames_per_s"


def read(rec):
    st = rec.stages.get("frontend.extract")
    return st["mean_ms"] if st and st["count"] else None
