"""Host milliseconds a frame spends blocked on the device: the program's
``host.wait`` spans (``utils.Readback.get``'s wait, the keyframe step's
gate and verdict reads), summed over the window's frames after the
profiled ones (the flush at the end included), per frame."""

LAYER = "system"
UNIT = "ms"
MOVES = "frames_per_s"


def read(rec):
    st = rec.stages.get("host.wait")
    if not st or not st["count"] or not rec.frame_s_after:
        return None
    # frame_s_after leaves out the window's last frame, which carries the flush
    return 1e3 * st["total_s"] / (len(rec.frame_s_after) + 1)
