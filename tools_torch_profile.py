"""Where a tracked frame's and a keyframe step's time goes on the card, for
the PyTorch port.

    python3 tools_torch_profile.py [--frames 3] [--keyframe]

Tracks the first frames of the same sequence as chip_smoke.py (the JAX
package's full-size bench render, default Config, localization mode) on
CUDA, then profiles ``--frames`` more tracked frames with torch.profiler
and prints: the frames' wall time, the device busy share (sum of kernel
time over wall time; one stream, so kernels do not overlap), the number of
kernel launches per frame, the top kernels by device time, and the LM's
time per iteration (a 50 + 10 iteration solve timed against a 1 + 5 one).
Writes the same numbers to ``chiprun_out/profile_frame.json``.

With ``--keyframe`` it profiles one ``mapper.keyframe_step`` instead: the
system tracks up to the first keyframe's frame with keyframes on, that
frame is tracked and committed by hand, and the step runs twice on copies
of that state, once timed by the host clock (ending in a synchronize) and
once under torch.profiler.  Prints the step's wall time, its device busy
time and share, its kernel launches and its top kernels, and writes them to
``chiprun_out/profile_keyframe.json``.  Needs a CUDA card; imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from defslam_tpu_torch.config import Config, SfTConfig
from defslam_tpu_torch.io.synthetic import make_sequence
from defslam_tpu_torch.mapping import mapper
from defslam_tpu_torch.ops import cuda_build
from defslam_tpu_torch.system import System
from defslam_tpu_torch.tracking import tracker
from defslam_tpu_torch.frontend import extract_features

WARM_FRAMES = 8


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _sft_ms(sys_: System, img, cfg: Config, reps: int = 5) -> float:
    pred = tracker.motion_model_prediction(sys_.pose, sys_.prev_pose)
    feats = extract_features(img, cfg)
    matches = tracker.match_points_to_frame(sys_.points, pred, sys_.K, feats, cfg)
    times = []
    for _ in range(reps + 1):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        tracker.sft_track(sys_.points, matches, feats, sys_.template, pred, sys_.K, cfg)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times[1:])[reps // 2]


def _device_kernels(prof):
    """The profiler's averaged events that ran on the device."""
    kernels = [e for e in prof.key_averages() if _device_us(e) > 0 and e.device_type is not None
               and "cuda" in str(e.device_type).lower()]
    if not kernels:  # older layouts: take every averaged event with device time
        kernels = [e for e in prof.key_averages() if _device_us(e) > 0]
    return kernels


def _clone(obj):
    if torch.is_tensor(obj):
        return obj.detach().clone()
    return type(obj)(*(_clone(v) for v in obj))


def profile_keyframe(seq, cfg: Config, smi: str) -> dict:
    """One keyframe step from the state just before the first keyframe."""
    period = cfg.tracking.keyframe_period
    sys_ = System(cfg)
    for t in range(period):
        sys_.track_monocular(seq.frames[t], timestamp=float(t))
    img = torch.as_tensor(seq.frames[period], device=sys_.device)
    feats, matches, res, new_points, _ = tracker.track_frame(
        img, sys_.points, sys_.pose, sys_.prev_pose, sys_.template, sys_.K, cfg)
    tmpl = sys_.template._replace(nodes=res.nodes)

    def step():
        return mapper.keyframe_step(
            _clone(sys_.kfs), _clone(new_points), tmpl, res.T, feats, matches.kp_of_point,
            res.inlier, sys_.K, sys_.dom, sys_.bend_warp, sys_.bend_sfn, sys_.template_ref_kf,
            sys_.kf_counter, sys_.frame_id + 1, cfg)

    step()  # warm: library handles, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    diag = step()[4]
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _device_kernels(prof)
    busy_us = sum(_device_us(e) for e in kernels)
    top = sorted(kernels, key=_device_us, reverse=True)[:15]
    return {
        "nvidia_smi": smi,
        "accepted": bool(diag.accepted), "n_pairs": int(diag.n_pairs),
        "keyframe_wall_ms": wall_ms,
        "keyframe_wall_ms_profiled": prof_wall_ms,
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share_profiled": busy_us / 1e3 / prof_wall_ms,
        "device_busy_share_of_unprofiled_wall": busy_us / 1e3 / wall_ms,
        "kernel_launches": sum(int(e.count) for e in kernels),
        "top_kernels": [
            {"name": e.key[:120], "device_ms": _device_us(e) / 1e3, "calls": int(e.count)}
            for e in top
        ],
        # the port's hand-written kernels, wherever they rank
        "own_kernels": [
            {"name": e.key[:120], "device_ms": _device_us(e) / 1e3, "calls": int(e.count)}
            for e in kernels if "hamming_kernel" in e.key or "windowed_match_kernel" in e.key
        ],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--keyframe", action="store_true",
                    help="profile one keyframe step instead of tracked frames")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tools_torch_profile: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cuda_build.build()
    n = WARM_FRAMES + args.frames
    seq = make_sequence(n_frames=24, height=480, width=640, max_amp=0.08,
                        camera_motion=0.35, rotation_deg=20, deform_modes=3,
                        brightness_drift=0.1)
    cfg = Config(camera=seq.camera)
    if args.keyframe:
        out = profile_keyframe(seq, cfg, smi)
        print(json.dumps(out), flush=True)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "profile_keyframe.json"), "w") as f:
            json.dump(out, f, indent=1)
        return 0
    sys_ = System(cfg)
    for t in range(WARM_FRAMES):
        sys_.track_monocular(seq.frames[t], timestamp=float(t))
        if t == 0:
            sys_.activate_localization_mode()
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for t in range(WARM_FRAMES, n):
            sys_.track_monocular(seq.frames[t], timestamp=float(t))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = _device_kernels(prof)
    busy_us = sum(_device_us(e) for e in kernels)
    launches = sum(int(e.count) for e in kernels)
    top = sorted(kernels, key=_device_us, reverse=True)[:15]

    img = torch.as_tensor(seq.frames[n - 1], device=sys_.device)
    full_ms = _sft_ms(sys_, img, cfg)
    short_cfg = Config(camera=seq.camera, sft=SfTConfig(lm_iterations=1))
    short_ms = _sft_ms(sys_, img, short_cfg)
    out = {
        "nvidia_smi": smi,
        "frames": args.frames,
        "frame_wall_ms": wall_s * 1e3 / args.frames,
        "device_busy_ms_per_frame": busy_us / 1e3 / args.frames,
        "device_busy_share": busy_us / 1e6 / wall_s,
        "kernel_launches_per_frame": launches / args.frames,
        "sft_ms_50_plus_10_iters": full_ms,
        "sft_ms_1_plus_5_iters": short_ms,
        "lm_ms_per_iteration": (full_ms - short_ms) / 54.0,
        "top_kernels": [
            {"name": e.key[:120], "device_ms_per_frame": _device_us(e) / 1e3 / args.frames,
             "calls_per_frame": e.count / args.frames} for e in top
        ],
    }
    print(json.dumps(out), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile_frame.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
