"""Host milliseconds of a keyframe step's dispatch: the program's
``keyframe.dispatch`` span, or its two halves ``keyframe.dispatch_a`` and
``keyframe.dispatch_b`` where the chain is split, in all over the steps
begun in the window's frames after the profiled ones."""

LAYER = "mapping/mapper"
UNIT = "ms"
MOVES = "frames_per_s"


def read(rec):
    spans = [rec.stages.get(f"keyframe.{n}") for n in ("dispatch", "dispatch_a", "dispatch_b")]
    steps = sum(st["count"] for st in spans[:2] if st)
    if not steps:
        return None
    return 1e3 * sum(st["total_s"] for st in spans if st) / steps
