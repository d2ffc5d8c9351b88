"""Coordinate-descent ("twiddle") hyperparameter autotuner.

Port of ``defslam_tpu/tools/autotune.py``, in the role of the reference's
``scripts/Twiddle.py``: tunes {Schwarp.Regularizer, LocalMapping.Bending,
LocalMapping.chiLimit} by coordinate descent.  The objective is the mean
per-frame GT RMSE (x1000, in mm like Twiddle.py's ``df*1000``) minus an
inlier-fraction bonus, plus 1000 per LOST frame.  Instead of templating YAML
files and launching a binary per evaluation, each evaluation runs the
port's System in-process on a sequence (synthetic by default, or any
(frames, depths) pair), on ``device`` (CUDA unless told otherwise).

    python -m defslam_tpu_torch.tools.autotune --iters 6 [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np


def evaluate(cfg, frames, depths, device=None) -> float:
    """One objective evaluation: track the sequence with depth-map ground
    truth (``track_monocular_ct``); 1e9 when no frame was evaluated."""
    from defslam_tpu_torch.system import System

    sys_ = System(dataclasses.replace(cfg, save_results=True), device=device)
    for t in range(len(frames)):
        sys_.track_monocular_ct(frames[t], depths[t], float(t))
    sys_.flush()
    rows = sys_._gt_eval.rows if sys_._gt_eval is not None else []
    if not rows:
        return 1e9
    rmse_mm = 1000.0 * float(np.mean([r[1] for r in rows]))
    ok = [m for m in sys_._metrics if m["state"] == "OK"]
    inlier_frac = (float(np.mean([m["inliers"] / max(m["matches"], 1) for m in ok[1:]]))
                   if len(ok) > 1 else 0.0)
    lost_penalty = 1e3 * sum(m["state"] == "LOST" for m in sys_._metrics)
    return rmse_mm - 10.0 * inlier_frac + lost_penalty


def twiddle(base_cfg, frames, depths, n_iter: int = 6, verbose: bool = True, device=None):
    """Classic twiddle over (schwarp_regularizer, bending, chi_limit).
    Returns (best parameters, best objective, history of (parameters,
    best objective))."""
    names = ["schwarp_regularizer", "bending", "chi_limit"]
    p = np.array([base_cfg.mapping.schwarp_regularizer, base_cfg.mapping.bending,
                  base_cfg.mapping.chi_limit])
    dp = 0.5 * p

    def cfg_with(vals):
        mapping = dataclasses.replace(base_cfg.mapping, schwarp_regularizer=float(vals[0]),
                                      bending=float(vals[1]), chi_limit=float(vals[2]))
        return dataclasses.replace(base_cfg, mapping=mapping)

    def score(vals):
        return evaluate(cfg_with(vals), frames, depths, device=device)

    best = score(p)
    history = [(dict(zip(names, p.tolist())), best)]
    for it in range(n_iter):
        for i in range(len(p)):
            p[i] += dp[i]
            err = score(p)
            if err < best:
                best = err
                dp[i] *= 1.1
            else:
                p[i] -= 2 * dp[i]
                if p[i] <= 0:
                    p[i] += dp[i]
                    dp[i] *= 0.5
                    continue
                err = score(p)
                if err < best:
                    best = err
                    dp[i] *= 1.1
                else:
                    p[i] += dp[i]
                    dp[i] *= 0.9
            history.append((dict(zip(names, p.tolist())), best))
            if verbose:
                print(f"iter {it} param {names[i]}: best {best:.3f} at "
                      f"{dict(zip(names, np.round(p, 4).tolist()))}")
    return dict(zip(names, p.tolist())), best, history


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--frames", type=int, default=14)
    ap.add_argument("--midscale", action="store_true",
                    help="tune on the 320x240 re-templating fixture instead of the "
                         "160x120 smoke fixture")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    from defslam_tpu_torch.config import (CapacityConfig, Config, MappingConfig, OrbConfig,
                                          SfTConfig, TrackingConfig)
    from defslam_tpu_torch.io.synthetic import make_sequence

    if args.midscale:
        seq = make_sequence(n_frames=max(args.frames, 16), height=240, width=320,
                            max_amp=0.07, seed=7)
        cfg = Config(
            camera=seq.camera,
            orb=OrbConfig(n_features=500, n_levels=4, max_keypoints=640),
            sft=SfTConfig(lm_iterations=25),
            tracking=TrackingConfig(keyframe_period=5),
            capacity=CapacityConfig(max_map_points=2048, max_keyframes=8),
            mapping=MappingConfig(points_to_template=60, chi_limit=0.2),
        )
    else:
        seq = make_sequence(n_frames=args.frames, height=120, width=160, max_amp=0.06)
        cfg = Config(
            camera=seq.camera,
            orb=OrbConfig(n_features=300, n_levels=3, max_keypoints=384),
            sft=SfTConfig(lm_iterations=20),
            tracking=TrackingConfig(keyframe_period=5),
            capacity=CapacityConfig(max_map_points=1024, max_keyframes=8),
        )
    before = evaluate(cfg, seq.frames, seq.depths, device=args.device)
    params, best, history = twiddle(cfg, seq.frames, seq.depths, n_iter=args.iters,
                                    device=args.device)
    print(json.dumps({"objective_before": before, "best_objective": best,
                      "params": params, "n_evaluations": len(history)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
