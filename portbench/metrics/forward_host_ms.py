"""Host milliseconds a frame that rank 0 of a world spends sending its
calls to the workers: the program's ``parallel.forward`` spans (the
pickling and gloo broadcast in ``parallel.driver.forwarding``, with the
frame's copy to the host), summed over the window's frames after the
profiled ones (the flush at the end included), per frame.  The broadcast
ends when every worker has taken the call, so a worker still busy with
the frame before holds rank 0 in it."""

LAYER = "parallel/driver"
UNIT = "ms"
MOVES = "frames_per_s"


def read(rec):
    st = rec.stages.get("parallel.forward")
    if not st or not st["count"] or not rec.frame_s_after:
        return None
    # frame_s_after leaves out the window's last frame, which carries the flush
    return 1e3 * st["total_s"] / (len(rec.frame_s_after) + 1)
