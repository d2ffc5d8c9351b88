"""Device milliseconds of ``frontend.extract_features`` (pyramid, FAST,
ORB) on the window's last frame, between CUDA events, median of 10 runs
after the window."""

LAYER = "frontend"
UNIT = "ms"
MOVES = "frames_per_s"


def replay(ctx):
    prog, img, cfg = ctx["prog"], ctx["img"], ctx["cfg"]
    return {"extract_ms": ctx["cuda_ms"](lambda: prog.frontend.extract_features(img, cfg))}


def read(rec):
    return rec.replays.get("extract_ms")
