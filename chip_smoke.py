"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py             # every phase
    python3 chip_smoke.py --kernels   # phases 1-3 only (no ``ok`` line)

Phases, in order; any failure exits non-zero and prints no result line:

1. a CUDA card is present; print its name and power limit (nvidia-smi);
2. build every kernel of the port from the sources in this checkout;
3. hold each kernel against its plain PyTorch version on the card at the
   main paths' shapes and at ragged and edge shapes (both kernels are
   integer: exact) and time the kernel, the plain version and a PyTorch
   library route with CUDA events: per single call (``kernel_ms``), per
   call of 20 back to back (``burst_ms``), per launch of a captured CUDA
   graph of 20 launches on pre-allocated outputs (``device_ms``: the host
   taken out), and the wrapper's host time per call (``host_us``); the
   bounds use the instruction rates the card reports;
4. run the tracking slice at full width (the default Config, 640x480,
   8 levels, 1200 features): System on the card, frame 0 initializes, then
   localization mode for frames 1..11; every frame must track, the Hamming
   kernel must have launched during that run, and the run must agree with
   the same frames tracked by System(device="cpu") within the stated
   tolerance;
5. run the mapping slice at full width: the same Config on all 24 frames,
   NOT in localization mode, so frames 10 and 20 insert keyframes and run
   ``mapper.keyframe_step``; every frame must track, every keyframe must
   find a covisible pair, at least one template swap must be accepted, the
   windowed-match kernel must launch exactly twice per keyframe step, and
   the run must agree with System(device="cpu") on the same frames;
6. take the state just before the first keyframe, run ``keyframe_step`` on
   it on the card and on the CPU, and compare the results;
7. print a ``timing`` line, one ``{"kernels": [...]}`` line, then the last
   line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.  A copy of the numbers goes
to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from defslam_tpu_torch.config import Config
from defslam_tpu_torch.io.synthetic import make_sequence
from defslam_tpu_torch.frontend import extract_features
from defslam_tpu_torch.mapping import mapper
from defslam_tpu_torch.ops import cuda_build, hamming, matching, windowed_match
from defslam_tpu_torch.system import System, TrackingState
from defslam_tpu_torch.tracking import tracker

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
INT8_TENSOR_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core rate (no 1-bit rate is published)
N_FRAMES = 12  # tracking slice; the mapping slice runs all 2 * N_FRAMES
HAMMING_SHAPES = [(2048, 1536), (200, 333), (256, 128), (1, 1),
                  (2049, 1537), (17, 9), (5, 4), (64, 1535)]


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, each between two
    CUDA events, after ``warmup`` runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cuda_burst_ms(fn, launches: int = 20, reps: int = 5) -> float:
    """Median milliseconds per call over ``reps`` bursts of ``launches``
    back-to-back calls between two CUDA events: the device's time per
    launch once the gap the host leaves between calls is hidden."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def cuda_graph_ms(launch, launches: int = 20, reps: int = 5) -> float:
    """Median milliseconds per launch over ``reps`` replays of a captured
    CUDA graph that holds ``launches`` calls of ``launch`` (a wrapper call
    on pre-allocated outputs), each replay between two CUDA events: the
    device's time per launch with the host taken out.  The outputs are not
    flushed from the 50 MB L2 between launches (the largest, B1's 12.6 MB
    matrix, fits it): the real callers read them straight back."""
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call of ``fn``: the host clock over ``calls``
    calls made without a synchronise (one follows the last)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def card_rates() -> dict:
    """The card's instruction rates, from what it reports: one instruction
    is one operation.  32-bit float and integer instructions per second =
    SMs x 128 lanes x the SM clock; ``__popc`` results per second = SMs x
    16 x the SM clock (the throughput table of NVIDIA's CUDA C manual for
    compute capability 9.0)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    return {"sms": sms, "sm_clock_mhz": mhz,
            "instr_per_s": sms * 128 * mhz * 1e6, "popc_per_s": sms * 16 * mhz * 1e6}


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 words -> (N, 256) float 0/1 bits (for the library
    yardstick only)."""
    shifts = torch.arange(32, device=desc.device, dtype=torch.int64)
    words = desc.to(torch.int64) & 0xFFFFFFFF
    return ((words[:, :, None] >> shifts) & 1).reshape(desc.shape[0], 256).float()


def _words(rng, shape, dev) -> torch.Tensor:
    """Random 32-bit descriptor words as int32 (sign bit set in half)."""
    return torch.as_tensor(rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32),
                           device=dev)


def hamming_cases(dev) -> dict:
    """name -> (desc_a, desc_b): the tracking path's shape first, then
    ragged shapes (a row stride that is no multiple of 16 bytes, N or M
    under one tile, one element), and ``signbit``: every word 0x80000000 or
    0xFFFFFFFF, which a signed shift or compare would get wrong."""
    rng = np.random.default_rng(0)
    cases = {f"{n}x{m}": (_words(rng, (n, 8), dev), _words(rng, (m, 8), dev))
             for n, m in HAMMING_SHAPES}
    pick = np.array([-2**31, -1], dtype=np.int32)
    cases["signbit"] = tuple(torch.as_tensor(pick[rng.integers(0, 2, (k, 8))], device=dev)
                             for k in (200, 333))
    return cases


def check_hamming(dev, rates: dict) -> dict:
    """Kernel vs plain in every case (exact), timings at the path shape."""
    worst = 0
    cases = hamming_cases(dev)
    for name, (a, b) in cases.items():
        out = hamming.hamming_matrix(a, b)
        torch.cuda.synchronize()
        ref = hamming.hamming_matrix_plain(a, b)
        err = int((out - ref).abs().max())
        exact = bool(torch.equal(out, ref))
        print(f"hamming_matrix {name}: exact={exact} max_abs_err={err}", flush=True)
        if not exact:
            raise SystemExit(f"hamming_matrix differs from its plain version in case {name}")
        worst = max(worst, err)
    n, m = HAMMING_SHAPES[0]
    a, b = cases[f"{n}x{m}"]
    ua, ub = unpack_bits(a), unpack_bits(b)
    kernel_ms = cuda_ms(lambda: hamming.hamming_matrix(a, b))
    burst_ms = cuda_burst_ms(lambda: hamming.hamming_matrix(a, b))
    out = torch.empty((n, m), dtype=torch.int32, device=dev)
    device_ms = cuda_graph_ms(lambda: hamming.hamming_matrix(a, b, out=out))
    if not torch.equal(out, hamming.hamming_matrix_plain(a, b)):
        raise SystemExit("hamming_matrix: the graph's launches left a wrong result")
    call_us = host_us(lambda: hamming.hamming_matrix(a, b))
    plain_ms = cuda_ms(lambda: hamming.hamming_matrix_plain(a, b))
    library_ms = cuda_ms(lambda: torch.cdist(ua, ub, p=0))
    lib = torch.cdist(ua, ub, p=0)
    if not torch.equal(lib.round().int(), hamming.hamming_matrix(a, b)):
        raise SystemExit("torch.cdist(p=0) yardstick disagrees with the kernel")
    # the bound: the least time of the card for this function.  Bytes: both
    # inputs read once, the output written once.  Operations: the 256-bit
    # AND + popcount product of every pair on the tensor cores, at the int8
    # rate (the lowest-precision rate the data sheet gives).  Beside it the
    # floor of any XOR + __popc design: 8 popcounts per output.
    n_bytes = 4 * (8 * n + 8 * m + n * m)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * 256 * n * m / INT8_TENSOR_OPS_PER_S * 1e3
    return {
        "name": "hamming_matrix",
        "route": "cuda",
        "source": "defslam_tpu_torch/ops/csrc/hamming.cu",
        "replaces": "defslam_tpu/ops/pallas_kernels.py:55",
        "shape": [n, m],
        "exact": True,
        "max_abs_err": worst,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "burst_ms": burst_ms,
        "device_ms": device_ms,
        "host_us": call_us,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "popc_floor_ms": 8 * n * m / rates["popc_per_s"] * 1e3,
    }


def _match_inputs(rng, b, n, m, dev, lo=(-1.0, -1.0), hi=(1.0, 1.0), p_valid=0.8):
    def desc(k):
        return torch.as_tensor(rng.integers(-2**31, 2**31, (b, k, 8)).astype(np.int32), device=dev)

    def xy(k):
        return torch.as_tensor(rng.uniform(lo, hi, (b, k, 2)).astype(np.float32), device=dev)

    def valid(k):
        return torch.as_tensor(rng.uniform(size=(b, k)) < p_valid, device=dev)

    return [desc(n), desc(m), xy(n), xy(m), valid(n), valid(m)]


def windowed_cases(cfg: Config, dev) -> dict:
    """name -> (inputs, radius).  ``path`` is the mapping path's shape
    (max_warp_pairs x max_keypoints^2) with positions spread over the
    camera's retina and the densification radius; the others are ragged and
    edge shapes: one element, nothing inside the window, dead rows and
    pairs, minima tied across the lane groups and warps that share a row's
    columns, NaN positions in rows and columns (``nan``), more columns than
    one staged chunk holds (``wide``), a radius that admits every pair
    (``dense``: the compaction saturated, the kernel's worst case), the
    path's shape with only pair 0 alive, as at the first keyframe
    (``deadpairs``), and rows in a cluster of columns beside sparse rows, so
    that within one warp some rows admit more columns than a queue holds
    and others few (``overflow``)."""
    rng = np.random.default_rng(11)
    cam = cfg.camera
    lo = (-cam.cx / cam.fx, -cam.cy / cam.fy)
    hi = ((cam.width - cam.cx) / cam.fx, (cam.height - cam.cy) / cam.fy)
    k = cfg.orb.max_keypoints
    cases = {
        "path": (_match_inputs(rng, cfg.capacity.max_warp_pairs, k, k, dev, lo, hi, 0.78),
                 2.0 * cfg.tracking.projection_window / cam.fx),
        "ragged": (_match_inputs(rng, 3, 150, 200, dev), 0.35),
        "one": (_match_inputs(rng, 1, 1, 1, dev, p_valid=1.0), 5.0),
        "outside": (_match_inputs(rng, 2, 70, 90, dev), 0.0),
    }
    dead = _match_inputs(rng, 4, 100, 300, dev)
    dead[4][1] = False
    dead[5][2] = False
    dead[4][0, :40] = False
    cases["dead"] = (dead, 0.5)
    ties = _match_inputs(rng, 2, 64, 700, dev, p_valid=1.0)
    ties[1][:] = ties[1][:, :1].clone()  # one descriptor in every column: all minima tie
    ties[1][0, 300:] ^= 1
    cases["ties"] = (ties, 5.0)
    nan = _match_inputs(rng, 2, 120, 260, dev)
    nan[2][0, ::7, 0] = float("nan")
    nan[2][1, 3::11, 1] = float("nan")
    nan[3][0, 5::9, 1] = float("nan")
    nan[3][1, ::13, 0] = float("nan")
    cases["nan"] = (nan, 0.6)
    cases["wide"] = (_match_inputs(rng, 2, 40, 6000, dev), 0.3)
    cases["dense"] = (_match_inputs(rng, 2, k, k, dev, lo, hi, 0.78), 10.0)
    deadpairs = _match_inputs(rng, cfg.capacity.max_warp_pairs, k, k, dev, lo, hi, 0.78)
    deadpairs[4][1:] = False
    deadpairs[5][1:] = False
    cases["deadpairs"] = (deadpairs, cases["path"][1])
    overflow = _match_inputs(rng, 3, 90, 500, dev)
    overflow[2][:, :45] *= 0.1  # rows 0..44 and columns 0..249 in one cluster
    overflow[3][:, :250] *= 0.1
    cases["overflow"] = (overflow, 0.25)
    return cases


def windowed_out(b: int, n: int, dev):
    """Pre-allocated outputs for ``windowed_match(..., out=)``."""
    return (torch.empty((2, b, n), dtype=torch.int32, device=dev),
            torch.empty((b, n), dtype=torch.int64, device=dev))


def windowed_library(da, db, xa, xb, va, vb, radius, invalid):
    """The library route to the same function, per pair: unpacked bits
    through ``torch.cdist(p=0)``, the mask, and ``torch.topk``.  A yardstick
    only; the port never calls it."""
    best, second = [], []
    for k in range(da.shape[0]):
        d = torch.cdist(unpack_bits(da[k]), unpack_bits(db[k]), p=0)
        win = (xa[k][:, None, :] - xb[k][None, :, :]).abs().amax(dim=-1) <= radius
        d = torch.where(va[k][:, None] & vb[k][None, :] & win, d, float(invalid))
        top = torch.topk(d, min(2, d.shape[1]), dim=1, largest=False).values
        best.append(top[:, 0])
        second.append(top[:, -1] if d.shape[1] > 1 else torch.full_like(top[:, 0], invalid))
    return torch.stack(best), torch.stack(second)


def check_windowed_match(cfg: Config, dev, rates: dict) -> dict:
    """Kernel vs plain at every case (exact on best, idx and second),
    timings and the bound at the path's shape."""
    inv = matching.INVALID
    worst = 0
    cases = windowed_cases(cfg, dev)
    for name, (args, radius) in cases.items():
        before = cuda_build.LAUNCHES["windowed_match"]
        out = windowed_match.windowed_match(*args, radius, inv)
        torch.cuda.synchronize()
        if cuda_build.LAUNCHES["windowed_match"] != before + 1:
            raise SystemExit("windowed_match did not launch its kernel on a CUDA tensor")
        ref = windowed_match.windowed_match_plain(*args, radius, inv)
        errs = [int((o.long() - r.long()).abs().max()) for o, r in zip(out, ref)]
        exact = all(o.dtype == r.dtype and torch.equal(o, r) for o, r in zip(out, ref))
        shape = [args[0].shape[0], args[0].shape[1], args[1].shape[1]]
        print(f"windowed_match {name} {shape}: exact={exact} max_abs_err(best,idx,second)={errs}",
              flush=True)
        if not exact:
            raise SystemExit(f"windowed_match differs from its plain version in case {name}")
        worst = max(worst, *errs)

    def device_ms(name):
        args, radius = cases[name]
        pre = windowed_out(args[0].shape[0], args[0].shape[1], dev)
        ms = cuda_graph_ms(lambda: windowed_match.windowed_match(*args, radius, inv, out=pre))
        got = windowed_match.windowed_match(*args, radius, inv, out=pre)
        ref = windowed_match.windowed_match_plain(*args, radius, inv)
        if not all(torch.equal(o, r) for o, r in zip(got, ref)):
            raise SystemExit(f"windowed_match: wrong result on pre-allocated outputs ({name})")
        return ms

    args, radius = cases["path"]
    da, db, xa, xb, va, vb = args
    b, n, m = da.shape[0], da.shape[1], db.shape[1]
    kernel_ms = cuda_ms(lambda: windowed_match.windowed_match(*args, radius, inv))
    burst_ms = cuda_burst_ms(lambda: windowed_match.windowed_match(*args, radius, inv))
    device = {name: device_ms(name) for name in ("path", "dense", "deadpairs")}
    print("windowed_match device_ms", json.dumps(device), flush=True)
    call_us = host_us(lambda: windowed_match.windowed_match(*args, radius, inv))
    plain_ms = cuda_ms(lambda: windowed_match.windowed_match_plain(*args, radius, inv), reps=5)
    library_ms = cuda_ms(lambda: windowed_library(*args, radius, inv), reps=5)
    lib_best, lib_second = windowed_library(*args, radius, inv)
    best, _, second = windowed_match.windowed_match(*args, radius, inv)
    if not (torch.equal(lib_best.int(), best) and torch.equal(lib_second.int(), second)):
        raise SystemExit("the library yardstick disagrees with the windowed_match kernel")
    # the bound, from this run's data, one instruction one operation, and
    # only what the function needs: validity is a property of a row and of a
    # column, not of a pair, so a (row, column) pair costs the window test
    # alone, 2 subtractions and 2 compares of magnitudes, at the card's
    # instruction rate; a pair the window admits costs 8 x (xor, add) and a
    # 4-instruction update of the running top-2 at that rate and 8
    # popcounts at the __popc rate
    win = (xa[:, :, None, :] - xb[:, None, :, :]).abs().amax(dim=-1) <= radius
    admitted = win & va[:, :, None] & vb[:, None, :]
    n_admitted = int(admitted.sum())
    n_bytes = sum(t.numel() * t.element_size() for t in args) + (4 + 8 + 4) * b * n
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ((4 * b * n * m + 20 * n_admitted) / rates["instr_per_s"]
             + 8 * n_admitted / rates["popc_per_s"]) * 1e3
    return {
        "name": "windowed_match",
        "route": "cuda",
        "source": "defslam_tpu_torch/ops/csrc/windowed_match.cu",
        "replaces": "defslam_tpu/ops/pallas_kernels.py:157",
        "shape": [b, n, m],
        "admitted_pairs": n_admitted,
        "max_admitted_per_row": int(admitted.sum(dim=2).max()),
        "exact": True,
        "max_abs_err": worst,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "burst_ms": burst_ms,
        "device_ms": device["path"],
        "device_ms_dense": device["dense"],
        "device_ms_deadpairs": device["deadpairs"],
        "host_us": call_us,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def rot_trans_gap(Ta: np.ndarray, Tb: np.ndarray) -> tuple[float, float]:
    """(rotation angle of Ra Rb^T in rad, translation distance)."""
    R = Ta[:3, :3].astype(np.float64) @ Tb[:3, :3].T.astype(np.float64)
    s = 0.5 * np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    rot = math.atan2(s, 0.5 * (np.trace(R) - 1.0))
    return rot, float(np.linalg.norm(Ta[:3, 3].astype(np.float64) - Tb[:3, 3]))


def run_slice(frames, cfg: Config, device, perturb: float = 0.0, timed: bool = False,
              localization: bool = True, kf_mark=None):
    """Track the frames: frame 0 initializes, then localization mode, or
    with ``localization=False`` keyframes and mapping.  ``perturb`` scales
    the template nodes by (1 + N(0, perturb)) right after the
    initialization (a probe of the solve's own sensitivity)."""
    sys_ = System(cfg, device=device)
    sys_._kf_mark = kf_mark
    sys_.map_diags = []
    frame_s = []
    for t, frame in enumerate(frames):
        t0 = time.perf_counter()
        sys_.track_monocular(frame, timestamp=float(t))
        if timed:
            torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
        if sys_._metrics[-1]["keyframe"] and t > 0:
            sys_.map_diags.append(dict(frame=t, **sys_.last_map_diag._asdict()))
        if t == 0:
            if localization:
                sys_.activate_localization_mode()
            if perturb:
                rng = np.random.default_rng(1)
                noise = torch.as_tensor(rng.normal(0.0, perturb, (cfg.mesh.n_nodes, 3)),
                                        dtype=torch.float32, device=sys_.device)
                sys_.template = sys_.template._replace(
                    nodes=sys_.template.nodes * (1.0 + noise))
    return sys_, frame_s


def stage_times(sys_: System, frame) -> dict:
    """CUDA-event medians of the three stages of a tracked frame, replayed
    on the system's final state with the last frame."""
    cfg = sys_.cfg
    img = torch.as_tensor(frame, device=sys_.device)
    pred = tracker.motion_model_prediction(sys_.pose, sys_.prev_pose)
    feats = extract_features(img, cfg)
    matches = tracker.match_points_to_frame(sys_.points, pred, sys_.K, feats, cfg)
    return {
        "extract_ms": cuda_ms(lambda: extract_features(img, cfg), reps=10),
        "match_ms": cuda_ms(lambda: tracker.match_points_to_frame(
            sys_.points, pred, sys_.K, feats, cfg), reps=10),
        "sft_ms": cuda_ms(lambda: tracker.sft_track(
            sys_.points, matches, feats, sys_.template, pred, sys_.K, cfg), reps=5),
    }


def compare_runs(gpu: System, cpu: System, probe: System | None) -> list[dict]:
    """Per-frame comparison of the card's run with the CPU's: tracking
    states, keyframe and template flags equal, inlier counts within 2% (or
    1), and, where a ``probe`` run is given, the pose.  A frame's
    pose gap passes at <= 1e-3 (rad and world units), or within 3x the gap
    that a 1e-7 relative perturbation of the template opens between two
    CPU runs at that frame: the solve on a nearly flat template is that
    sensitive (the curvature term's Jacobian direction is rounding noise
    there), in the JAX package as in the port."""
    rows = []
    for i, (mg, mc) in enumerate(zip(gpu._metrics, cpu._metrics)):
        Tg = gpu.trajectory[i][1]
        Tc = cpu.trajectory[i][1]
        rot, trans = rot_trans_gap(Tg, Tc)
        rot_p = trans_p = None
        ok_pose = True
        if probe is not None:
            rot_p, trans_p = rot_trans_gap(probe.trajectory[i][1], Tc)
            ok_pose = (rot <= max(1e-3, 3 * rot_p)) and (trans <= max(1e-3, 3 * trans_p))
        ok_inl = abs(mg["inliers"] - mc["inliers"]) <= max(1, 0.02 * mc["inliers"])
        ok_flags = all(mg[k] == mc[k] for k in ("state", "keyframe", "template"))
        row = dict(frame=i, state=[mg["state"], mc["state"]],
                   keyframe=[mg["keyframe"], mc["keyframe"]],
                   template=[mg["template"], mc["template"]],
                   matches=[mg["matches"], mc["matches"]],
                   inliers=[mg["inliers"], mc["inliers"]],
                   rot_gap=rot, trans_gap=trans, probe_rot_gap=rot_p,
                   probe_trans_gap=trans_p, ok=bool(ok_pose and ok_inl and ok_flags))
        print("frame", json.dumps(row), flush=True)
        rows.append(row)
    return rows


class StageMarks:
    """The ``mark`` callback of ``keyframe_step``: a CUDA event (or a host
    time on the CPU) at every stage boundary, and the tensors handed over."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks: list[tuple[str, object]] = []
        self.tensors: dict[str, torch.Tensor] = {}

    def __call__(self, name: str, **tensors):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        else:
            ev = time.perf_counter()
        self.marks.append((name, ev))
        self.tensors.update({k: v.clone() for k, v in tensors.items()})

    def steps_ms(self) -> list[dict]:
        """Per keyframe step: milliseconds of each stage (the time between
        its mark and the one before) and their sum ``keyframe_ms``."""
        if self.cuda:
            torch.cuda.synchronize()
        steps, prev = [], None
        for name, ev in self.marks:
            if name == "start":
                steps.append({})
            else:
                dt = prev.elapsed_time(ev) if self.cuda else (ev - prev) * 1e3
                steps[-1][name + "_ms"] = dt
            prev = ev
        for st in steps:
            st["keyframe_ms"] = sum(st.values())
        return steps


def mapping_slice(frames, cfg: Config, dev):
    """The mapping slice on the card: all frames, keyframes on.  Returns
    (system, frame seconds, kernel launches of the run, per-step stage ms).
    Fails unless every frame tracks, every keyframe step finds a covisible
    pair, a template swap is accepted, and the kernels launched as the path
    says they must."""
    marks = StageMarks(dev)
    cuda_build.LAUNCHES.clear()
    gpu, frame_s = run_slice(frames, cfg, dev, timed=True, localization=False, kf_mark=marks)
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    states = [m["state"] for m in gpu._metrics]
    kf_frames = [m["frame"] for m in gpu._metrics if m["keyframe"]]
    for d in gpu.map_diags:
        print("mapping_diag", json.dumps(d), flush=True)
    print("mapping states", states, "keyframes", kf_frames, "launches", launches, flush=True)
    if any(s != TrackingState.OK.name for s in states):
        raise SystemExit(f"mapping slice: not every frame tracked: {states}")
    period = cfg.tracking.keyframe_period
    expect = [0] + list(range(period, len(frames), period))
    if kf_frames != expect:
        raise SystemExit(f"mapping slice: keyframes at {kf_frames}, expected {expect}")
    if any(d["n_pairs"] < 1 for d in gpu.map_diags):
        raise SystemExit("mapping slice: a keyframe step found no covisible pair")
    n_swaps = sum(d["accepted"] for d in gpu.map_diags)
    if n_swaps < 1:
        raise SystemExit("mapping slice: no template swap was accepted")
    n_steps = len(gpu.map_diags)
    if launches.get("windowed_match", 0) != 2 * n_steps:
        raise SystemExit(f"windowed_match launched {launches.get('windowed_match', 0)} times "
                         f"in {n_steps} keyframe steps (2 each expected)")
    if launches.get("hamming_matrix", 0) < len(frames) - 1 + n_swaps:
        raise SystemExit(f"hamming_matrix launched {launches.get('hamming_matrix', 0)} times for "
                         f"{len(frames) - 1} tracked frames and {n_swaps} re-anchors")
    return gpu, frame_s, launches, marks.steps_ms()


def to_device(obj, device):
    """A copy of a tensor, or of a NamedTuple of tensors, on ``device``."""
    if torch.is_tensor(obj):
        return obj.detach().clone().to(device)
    return type(obj)(*(to_device(v, device) for v in obj))


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest absolute difference relative to max(1, largest |b|)."""
    a, b = a.double().cpu(), b.double().cpu()
    if a.numel() == 0:
        return 0.0
    return float((a - b).abs().max() / max(1.0, float(b.abs().max())))


def keyframe_card_vs_cpu(frames, cfg: Config, dev, tol: float = 5e-3) -> dict:
    """``keyframe_step`` on the card and on the CPU from one state: the
    card tracks up to the first keyframe's frame, that frame is tracked and
    committed by hand, and both devices run the step on copies.  Integer
    tables, counts and verdicts must be equal; the float results (accepted
    scale, normals, SfN control depths, template nodes, pose) within
    ``tol`` of their largest magnitude: the same float32 operations in
    another order, through a Cholesky, an SVD and the SfT solve."""
    period = cfg.tracking.keyframe_period
    s = System(cfg, device=dev)
    for t in range(period):
        s.track_monocular(frames[t], timestamp=float(t))
    img = torch.as_tensor(np.asarray(frames[period]), device=s.device)
    feats, matches, res, new_points, _ = tracker.track_frame(
        img, s.points, s.pose, s.prev_pose, s.template, s.K, cfg)
    state = dict(kfs=s.kfs, points=new_points, tmpl=s.template._replace(nodes=res.nodes),
                 pose=res.T, feats=feats, kp_of_point=matches.kp_of_point, inlier=res.inlier,
                 K=s.K, dom=s.dom, bend_warp=s.bend_warp, bend_sfn=s.bend_sfn)
    out = {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        marks = StageMarks(device)
        args = {k: to_device(v, device) for k, v in state.items()}
        kfs, points, tmpl, pose, diag = mapper.keyframe_step(
            **args, tmpl_ref_kf=s.template_ref_kf, kf_counter=s.kf_counter,
            frame_id=s.frame_id + 1, cfg=cfg, mark=marks)
        out[name] = dict(kfs=kfs, points=points, tmpl=tmpl, pose=pose, diag=diag,
                         best=marks.tensors["best"], stages=marks.steps_ms()[0])
    g, c = out["card"], out["cpu"]
    equal = {
        "densify_best": torch.equal(g["best"].cpu(), c["best"]),
        "point_id": torch.equal(g["kfs"].point_id.cpu(), c["kfs"].point_id),
        "n_obs": torch.equal(g["points"].n_obs.cpu(), c["points"].n_obs),
        "points_valid": torch.equal(g["points"].valid.cpu(), c["points"].valid),
        "norm_valid": torch.equal(g["kfs"].norm_valid.cpu(), c["kfs"].norm_valid),
    }
    diag = {}
    for f in mapper.MappingDiag._fields:
        vg, vc = getattr(g["diag"], f).item(), getattr(c["diag"], f).item()
        diag[f] = [vg, vc]
        if f != "reg_scale":
            equal["diag." + f] = vg == vc
    nv = c["kfs"].norm_valid
    gaps = {
        "reg_scale": abs(diag["reg_scale"][0] - diag["reg_scale"][1]) / diag["reg_scale"][1],
        "norm_k": _gap(g["kfs"].norm_k.cpu()[nv], c["kfs"].norm_k[nv]),
        "surf_ctrl": _gap(g["kfs"].surf_ctrl, c["kfs"].surf_ctrl),
        "template_nodes": _gap(g["tmpl"].nodes, c["tmpl"].nodes),
        "pose": _gap(g["pose"], c["pose"]),
    }
    # the card's step here is the process's first: its stage times include
    # the one-time set-up of the linear-algebra libraries and of torch.func
    row = dict(equal=equal, gaps=gaps, tol=tol, diag=diag,
               n_densified=int((c["best"] >= 0).sum()), first_step_stages_ms=g["stages"])
    print("keyframe_card_vs_cpu", json.dumps(row), flush=True)
    if not all(equal.values()):
        raise SystemExit("keyframe_step: integer results differ between the card and the CPU: "
                         + ", ".join(k for k, v in equal.items() if not v))
    if not all(v <= tol for v in gaps.values()):
        raise SystemExit(f"keyframe_step: float results differ by more than {tol}: {gaps}")
    return row


def main(kernels_only: bool = False) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    report = cuda_build.build()
    build_s = time.perf_counter() - t0
    for name, r in report.items():
        print(f"build {name}: {r['seconds']:.2f} s\n{r['log'].strip()}", flush=True)
    print(f"build total: {build_s:.2f} s", flush=True)

    # the JAX package's full-size bench regime (bench.py: 24 frames of
    # handheld 6-DoF motion).  The tracking slice tracks its first 12
    # frames; a 12-frame render of the same motion moves twice as far per
    # frame, and frame 1 then gets 24 matches and 2 inliers in both
    # packages, which only relocalization (a later slice) recovers.  The
    # mapping slice runs all 24.
    seq = make_sequence(n_frames=2 * N_FRAMES, height=480, width=640, max_amp=0.08,
                        camera_motion=0.35, rotation_deg=20, deform_modes=3,
                        brightness_drift=0.1)
    cfg = Config(camera=seq.camera)

    rates = card_rates()
    print("card_rates", json.dumps(rates), flush=True)
    kern_h = check_hamming(dev, rates)
    kern_w = check_windowed_match(cfg, dev, rates)
    if kernels_only:
        print(smi, flush=True)
        print(json.dumps({"kernels": [kern_h, kern_w]}), flush=True)
        return 0

    # ---- tracking slice
    frames = seq.frames[:N_FRAMES]
    # warm the card (allocator, library handles) outside the counted run
    run_slice(frames[:2], cfg, dev)
    torch.cuda.synchronize()

    cuda_build.LAUNCHES.clear()
    gpu, frame_s = run_slice(frames, cfg, dev, timed=True)
    torch.cuda.synchronize()
    launches_t = dict(cuda_build.LAUNCHES)
    states = [m["state"] for m in gpu._metrics]
    print("tracking states", states, "launches", launches_t, flush=True)
    if any(s != TrackingState.OK.name for s in states):
        raise SystemExit(f"not every frame tracked: {states}")
    if launches_t.get("hamming_matrix", 0) < N_FRAMES - 1:
        raise SystemExit(f"hamming_matrix launched {launches_t.get('hamming_matrix', 0)} times "
                         f"for {N_FRAMES - 1} tracked frames")
    tracked_s = frame_s[1:]
    timing = {
        "frame_p50_ms": statistics.median(tracked_s) * 1e3,
        "frame_max_ms": max(tracked_s) * 1e3,
        "init_ms": frame_s[0] * 1e3,
        **stage_times(gpu, frames[-1]),
    }

    # ---- one keyframe step, the card against the CPU (it also warms the
    # mapping chain's libraries outside the timed and counted run)
    torch.set_num_threads(max(1, os.cpu_count() or 1))
    kf_row = keyframe_card_vs_cpu(seq.frames, cfg, dev)

    # ---- mapping slice
    gpu_map, map_frame_s, launches_m, steps = mapping_slice(seq.frames, cfg, dev)
    plain_s = [map_frame_s[m["frame"]] for m in gpu_map._metrics[1:] if not m["keyframe"]]
    kf_s = [map_frame_s[m["frame"]] for m in gpu_map._metrics[1:] if m["keyframe"]]
    timing.update({
        "keyframe_ms": [st["keyframe_ms"] for st in steps],
        "keyframe_stages_ms": steps,
        "first_keyframe_ms_with_library_setup": kf_row["first_step_stages_ms"]["keyframe_ms"],
        "mapping_frame_p50_ms": statistics.median(plain_s) * 1e3,
        "mapping_keyframe_frame_ms": [x * 1e3 for x in kf_s],
    })
    print("timing", json.dumps(timing), flush=True)

    kern_h["launches_by_path"] = {"tracking": launches_t.get("hamming_matrix", 0),
                                  "mapping": launches_m.get("hamming_matrix", 0)}
    kern_w["launches_by_path"] = {"tracking": launches_t.get("windowed_match", 0),
                                  "mapping": launches_m.get("windowed_match", 0)}
    for k in (kern_h, kern_w):
        k["launches"] = sum(k["launches_by_path"].values())

    # ---- the card's runs against the CPU's
    cpu, _ = run_slice(frames, cfg, "cpu")
    probe, _ = run_slice(frames, cfg, "cpu", perturb=1e-7)
    rows = compare_runs(gpu, cpu, probe)
    if not all(r["ok"] for r in rows):
        raise SystemExit("tracking slice: the card's run disagrees with the CPU run")
    cpu_map, _ = run_slice(seq.frames, cfg, "cpu", localization=False)
    map_rows = compare_runs(gpu_map, cpu_map, None)
    if not all(r["ok"] for r in map_rows):
        raise SystemExit("mapping slice: the card's run disagrees with the CPU run")

    for run in (gpu, gpu_map):
        pose = run.trajectory[-1][1]
        if not np.isfinite(pose).all() or pose.shape != (4, 4):
            raise SystemExit("final pose is not a finite 4x4 matrix")

    kernels = [kern_h, kern_w]
    out = {"nvidia_smi": smi, "build_s": build_s, "kernels": kernels, "timing": timing,
           "frames": rows, "mapping_frames": map_rows, "mapping_diags": gpu_map.map_diags,
           "keyframe_card_vs_cpu": kf_row}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(kernels_only="--kernels" in sys.argv[1:]))
