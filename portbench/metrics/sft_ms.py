"""Device milliseconds of ``tracker.sft_track`` (the SfT's LM), between
CUDA events, on the window's final state and last frame (its motion-model
prediction, features and matches), median of 5 runs after the window."""

LAYER = "tracking/sft"
UNIT = "ms"
MOVES = "frames_per_s"


def replay(ctx):
    s, prog, img, cfg = ctx["system"], ctx["prog"], ctx["img"], ctx["cfg"]
    tr = prog.tracker
    pred = tr.motion_model_prediction(s.pose, s.prev_pose)
    feats = prog.frontend.extract_features(img, cfg)
    matches = tr.match_points_to_frame(s.points, pred, s.K, feats, cfg)
    return {"sft_ms": ctx["cuda_ms"](
        lambda: tr.sft_track(s.points, matches, feats, s.template, pred, s.K, cfg), reps=5)}


def read(rec):
    return rec.replays.get("sft_ms")
