"""Where a tracked frame's and a keyframe step's time goes on the card, for
the PyTorch port.

    python3 tools_torch_profile.py [--frames 3] [--keyframe | --relocalize | --pipelined |
                                    --parallel]

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

With ``--relocalize`` it profiles one ``pose_opt.relocalize`` at full
width: frame 0 of the 12-frame render of the same motion initializes, and
frame 1's features are relocalized against the 24 keyframe slots (the
call the relocalization slice of chip_smoke.py makes).  Prints the call's
wall time, device busy time and share, launches and top kernels, and
writes them to ``chiprun_out/profile_relocalize.json``.

These three run the synchronous protocol (``tracking.pipelined=False``).
With ``--pipelined`` it runs the JAX package's bench configuration
(chip_smoke.py's pipelined slice: depth 2, split keyframe dispatch) on the
bench render uploaded to the card, and profiles ``--frames`` pipelined
non-keyframe frames, then one split keyframe (the keyframe frame, which
dispatches half A, and the next, which dispatches half B) through to a
``flush``.  Per region: wall time, device busy time and share, kernel
launches; per dispatch: its host time and its host waits on the card
(``profiling.host_waits``).  Writes ``chiprun_out/profile_pipelined.json``.

With ``--parallel`` it builds the SfT problem of a tracked frame (the
default Config after ``WARM_FRAMES`` frames, 1536 observations) and
profiles ``sft.solve`` on it against ``parallel.sharded.sft_solve_sharded``
at world 1 over NCCL: per solve the wall time, device busy time and share,
launches, top kernels and the top operators by host (self CPU) time; then
the host ms of 5 rounds of the two solves and of the sharded one with its
all-reduces taken out.
Writes ``chiprun_out/profile_parallel.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from defslam_tpu_torch import profiling
from defslam_tpu_torch.config import (
    CapacityConfig, Config, OrbConfig, SfTConfig, TrackingConfig,
)
from defslam_tpu_torch.io.synthetic import make_sequence
from defslam_tpu_torch.mapping import mapper
from defslam_tpu_torch.ops import cuda_build
from defslam_tpu_torch.system import System
from defslam_tpu_torch.tracking import pose_opt, tracker
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

    out, kernels = _profiled(step, smi)
    diag = step()[4]
    own = [e for e in kernels if "hamming_kernel" in e.key or "windowed_match_kernel" in e.key]
    return {
        **out, "accepted": bool(diag.accepted), "n_pairs": int(diag.n_pairs),
        # the port's hand-written kernels, wherever they rank
        "own_kernels": [{"name": e.key[:120], "device_ms": _device_us(e) / 1e3,
                         "calls": int(e.count)} for e in own],
    }


def _profiled(fn, smi: str):
    """Host-clock wall time of ``fn`` (after a warm call, ending in a
    synchronize), then one more call under torch.profiler: device busy
    time and share, launches, top kernels, top operators by host time.  Returns (that dict, the
    profiler's device kernels)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _device_kernels(prof)
    busy_us = sum(_device_us(e) for e in kernels)
    top = sorted(kernels, key=_device_us, reverse=True)[:15]
    return {
        "nvidia_smi": smi, "wall_ms": wall_ms, "wall_ms_profiled": prof_wall_ms,
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share_profiled": busy_us / 1e3 / prof_wall_ms,
        "device_busy_share_of_unprofiled_wall": busy_us / 1e3 / wall_ms,
        "kernel_launches": sum(int(e.count) for e in kernels),
        "top_kernels": [{"name": e.key[:120], "device_ms": _device_us(e) / 1e3,
                         "calls": int(e.count)} for e in top],
        "top_host_ops": _host_ops(prof),
    }, kernels


def profile_parallel(seq, cfg: Config, smi: str) -> dict:
    """``sft.solve`` against the world-1 sharded solve on one frame's SfT
    problem (see the module's docstring)."""
    from defslam_tpu_torch import parallel
    from defslam_tpu_torch.config import ParallelConfig
    from defslam_tpu_torch.parallel import sharded
    from defslam_tpu_torch.template import mesh as meshmod
    from defslam_tpu_torch.tracking import sft

    sys_ = System(cfg)
    for t in range(WARM_FRAMES):
        sys_.track_monocular(seq.frames[t], timestamp=float(t))
        if t == 0:
            sys_.activate_localization_mode()
    img = torch.as_tensor(seq.frames[WARM_FRAMES], device=sys_.device)
    pred = tracker.motion_model_prediction(sys_.pose, sys_.prev_pose)
    feats = extract_features(img, cfg)
    matches = tracker.match_points_to_frame(sys_.points, pred, sys_.K, feats, cfg)
    data, _, _ = tracker._sft_data_from_matches(sys_.points, matches, feats, sys_.template, pred,
                                                sys_.K, cfg)
    topo = meshmod.grid_topology(cfg.mesh.nodes_u, cfg.mesh.nodes_v)
    pcfg = Config(parallel=ParallelConfig(enabled=True))
    parallel.init_distributed(pcfg, sys_.device, timeout=120)
    try:
        group = sharded.make_group(1)
        out = {}
        for name, fn in (("single", lambda: sft.solve(data, topo, cfg)),
                         ("sharded", lambda: sharded.sft_solve_sharded(group, data, cfg))):
            out[name] = _profiled(fn, smi)[0]
        # host ms, median of 5, in turns: the single solve, the sharded one,
        # and the sharded one with its all-reduces replaced by nothing (a
        # world-1 all-reduce is the identity): what the collectives cost
        hollow = sharded.Group()
        hollow.all_reduce = lambda t: t
        runs = {"single": [], "sharded": [], "sharded_no_collectives": []}
        fns = {"single": lambda: sft.solve(data, topo, cfg),
               "sharded": lambda: sharded.sft_solve_sharded(group, data, cfg),
               "sharded_no_collectives": lambda: sharded.sft_solve_sharded(hollow, data, cfg)}
        for _ in range(5):
            for name, fn in fns.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                runs[name].append((time.perf_counter() - t0) * 1e3)
        out["wall_ms_in_turns"] = runs
    finally:
        parallel.shutdown()
    out["observations"] = int(data.obs_uv.shape[0])
    return out


def _host_ops(prof, n: int = 15) -> list[dict]:
    """The operators with the most host (self CPU) time."""
    evts = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)[:n]
    return [{"name": e.key[:80], "self_cpu_ms": e.self_cpu_time_total / 1e3,
             "calls": int(e.count)} for e in evts]


def profile_pipelined(seq, frames: int, smi: str) -> dict:
    """Pipelined frames and one split keyframe (see the module's docstring)."""
    period = 10
    cfg = Config(camera=seq.camera,
                 orb=OrbConfig(n_features=1200, n_levels=6, max_keypoints=1536),
                 sft=SfTConfig(lm_iterations=50),
                 tracking=TrackingConfig(keyframe_period=period, pipeline_depth=2,
                                         split_keyframe_dispatch=True),
                 capacity=CapacityConfig(max_map_points=4096, max_keyframes=16))
    imgs = [torch.as_tensor(f.astype("uint8"), device="cuda") for f in seq.frames]
    sys_ = System(cfg)
    first = 2 * period - frames  # the profiled plain frames end right before keyframe 2
    for t in range(first):
        sys_.track_monocular(imgs[t], timestamp=float(t))
    sys_.flush()
    torch.cuda.synchronize()

    def region(ts):
        rows = []
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t_all = time.perf_counter()
            for t in ts:
                t0 = time.perf_counter()
                with profiling.host_waits() as w:
                    sys_.track_monocular(imgs[t], timestamp=float(t))
                rows.append({"frame": t, "host_ms": (time.perf_counter() - t0) * 1e3,
                             "host_waits": sum(w.values()), "where": dict(w)})
            sys_.flush()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t_all) * 1e3
        kernels = _device_kernels(prof)
        busy_ms = sum(_device_us(e) for e in kernels) / 1e3
        return {"dispatches": rows, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                "device_busy_share": busy_ms / wall_ms,
                "kernel_launches": sum(int(e.count) for e in kernels)}

    plain = region(range(first, 2 * period))
    split_kf = region(range(2 * period, 2 * period + 2))
    return {"nvidia_smi": smi, "frames": frames, "plain_frames": plain,
            "split_keyframe": split_kf,
            "states": [m["state"] for m in sys_._metrics],
            "template": [m["template"] for m in sys_._metrics]}


def profile_relocalize(smi: str) -> dict:
    """One relocalization at full width (see the module's docstring)."""
    seq = make_sequence(n_frames=12, height=480, width=640, max_amp=0.08, camera_motion=0.35,
                        rotation_deg=20, deform_modes=3, brightness_drift=0.1)
    cfg = Config(camera=seq.camera, tracking=TrackingConfig(pipelined=False))
    sys_ = System(cfg)
    sys_.track_monocular(seq.frames[0], timestamp=0.0)
    feats = extract_features(torch.as_tensor(seq.frames[1], device=sys_.device), cfg)

    def call():
        return pose_opt.relocalize(feats, sys_.kfs, sys_.points, sys_.K, cfg)

    out, _ = _profiled(call, smi)
    ok, _, n = call()
    out.update(ok=bool(ok), n_inliers=int(n))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--keyframe", action="store_true",
                    help="profile one keyframe step instead of tracked frames")
    ap.add_argument("--relocalize", action="store_true",
                    help="profile one relocalization instead of tracked frames")
    ap.add_argument("--pipelined", action="store_true",
                    help="profile pipelined frames and a split keyframe (bench configuration)")
    ap.add_argument("--parallel", action="store_true",
                    help="profile a frame's SfT solve, single-device against sharded at world 1")
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
    cfg = Config(camera=seq.camera, tracking=TrackingConfig(pipelined=False))
    if args.pipelined:
        out = profile_pipelined(seq, args.frames, smi)
        print(json.dumps(out), flush=True)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "profile_pipelined.json"), "w") as f:
            json.dump(out, f, indent=1)
        return 0
    if args.parallel:
        out = profile_parallel(seq, cfg, smi)
        print(json.dumps(out), flush=True)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "profile_parallel.json"), "w") as f:
            json.dump(out, f, indent=1)
        return 0
    if args.relocalize:
        out = profile_relocalize(smi)
        print(json.dumps(out), flush=True)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", "profile_relocalize.json"), "w") as f:
            json.dump(out, f, indent=1)
        return 0
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
    short_cfg = Config(camera=seq.camera, sft=SfTConfig(lm_iterations=1),
                       tracking=TrackingConfig(pipelined=False))
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
