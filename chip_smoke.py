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
7. the relocalization slice: the 12-frame render of the same motion at
   full width, localization mode after frame 0; every frame must track,
   ``pose_opt.relocalize`` must succeed at least once and launch B1 once
   per call, and states and relocalization outcomes (ok, inliers within
   2%) must equal the CPU's;
8. the occlusion run: the 24-frame render with frames 13-14 blanked,
   keyframes on, through ``track_monocular_ct`` with the metrics files on;
   frames 13-14 must go LOST, frame 15 come back through a successful
   relocalization without a re-initialization, the GT files be written,
   and the states equal the CPU's through frame 16.  It runs twice on the
   card (is the card repeatable?), then once more with ``save_state``
   after frame 12 and ``load_state`` into a fresh System: the resumed
   run's files must equal the uninterrupted run's, bit for bit where the
   card repeated itself, else within the gap between its two runs;
9. ``stereo_depth_ncc`` at full width on the card against the CPU (no
   kernel): ``ok`` equal, depth within 1e-4 relative;
10. the pipelined slice: the JAX package's bench configuration
   (``bench.py``: 640x480, 1200 features, 6 levels, 1536 keypoints, 50 LM
   iterations, 4096 map points, 16 keyframe slots, a keyframe every 10
   frames, pipeline depth 2) on the 24-frame bench render uploaded as
   uint8 tensors on the card: 12 warm-up frames, a ``flush``, 12 measured
   frames, in three modes: synchronous, pipelined with the fused keyframe
   step, pipelined with the split one (the bench's).  Every frame must
   track, the split run must swap the template and launch both kernels;
   in one more split run, untimed, the non-keyframe dispatches must run
   under ``torch.cuda.set_sync_debug_mode("error")`` and the keyframe
   dispatches make at most two host waits (the branch reads) besides the
   Sim(3) alignment's (``torch.linalg.svd`` reads its convergence info on
   the host, twice a call, two calls, just before the registration's
   verdict is read);
   the fused pipelined run must give the synchronous run's metrics rows,
   its trajectory within 1e-6; the split run's ATE must stay within
   max(2x, +0.02) of the fused run's.  Then two rollbacks at full width: a blank frame at a keyframe
   slot must end as the synchronous run, and a blank frame right after a
   split keyframe must be recovered with the stores consistent;
11. print a ``timing`` line, one ``{"kernels": [...]}`` line, then the last
   line ``{"ok": true, "device": {...}}``.

Every phase before the pipelined slice runs the synchronous protocol
(``tracking.pipelined=False``), so its numbers compare with earlier runs.

Imports nothing of JAX or of the JAX package.  A copy of the numbers goes
to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from defslam_tpu_torch import profiling
from defslam_tpu_torch.config import CapacityConfig, Config, OrbConfig, SfTConfig, TrackingConfig
from defslam_tpu_torch.io.synthetic import _gaussian_blur, make_sequence
from defslam_tpu_torch.frontend import extract_features
from defslam_tpu_torch.groundtruth import gt as gtmod
from defslam_tpu_torch.mapping import mapper
from defslam_tpu_torch.ops import cuda_build, hamming, matching, windowed_match
from defslam_tpu_torch.system import System, TrackingState
from defslam_tpu_torch.tracking import pose_opt, tracker

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
INT8_TENSOR_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core rate (no 1-bit rate is published)
N_FRAMES = 12  # tracking slice; the mapping slice runs all 2 * N_FRAMES
HAMMING_SHAPES = [(2048, 1536), (200, 333), (256, 128), (1, 1),
                  (2049, 1537), (17, 9), (5, 4), (64, 1535)]
RELOC_SHAPE = (1536, 24 * 1536)  # relocalization: the frame against all 24 keyframe slots
BENCH_MOTION = dict(height=480, width=640, max_amp=0.08, camera_motion=0.35, rotation_deg=20,
                    deform_modes=3, brightness_drift=0.1)
PIPE_WARM = 12  # the pipelined slice: bench.py's 12 warm-up frames, then 12 measured
# the Sim(3) alignment's file (torch.linalg.svd reads its convergence info
# on the host); a keyframe dispatch's waits there are counted apart
SVD_SITE = os.path.join("defslam_tpu_torch", "geometry", "se3.py") + ":"
OCCLUSION = (13, 14)
CHECKPOINT_AFTER = 12  # the split run saves after this frame
RESULT_FILES = ("Matches.txt", "StatusTracking.txt", "MapPointUsage.txt", "Trajectory.txt",
                "ErrorGTs0.txt", "ScaleVariation.txt")


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


def hamming_at_relocalization(dev) -> dict:
    """B1 at relocalization's shape, (1536, 8) x (36864, 8): exact against
    the plain version; ``device_ms`` (graph of 20 launches; the 226 MB
    output cannot stay in the L2), ``host_us``, the plain and library
    times, and the bound (bytes: each input read once, the output written
    once; operations: the 256-bit product of every pair at the int8
    tensor rate)."""
    rng = np.random.default_rng(24)
    n, m = RELOC_SHAPE
    a, b = _words(rng, (n, 8), dev), _words(rng, (m, 8), dev)
    out = torch.empty((n, m), dtype=torch.int32, device=dev)
    device_ms = cuda_graph_ms(lambda: hamming.hamming_matrix(a, b, out=out))
    ref = hamming.hamming_matrix_plain(a, b)
    if not torch.equal(out, ref):
        raise SystemExit("hamming_matrix differs from its plain version at the relocalization shape")
    err = int((out - ref).abs().max())
    del ref
    plain_ms = cuda_ms(lambda: hamming.hamming_matrix_plain(a, b), reps=3, warmup=1)
    ua, ub = unpack_bits(a), unpack_bits(b)
    library_ms = cuda_ms(lambda: torch.cdist(ua, ub, p=0), reps=5, warmup=1)
    t_bytes = 4 * (8 * n + 8 * m + n * m) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * 256 * n * m / INT8_TENSOR_OPS_PER_S * 1e3
    row = {"shape": [n, m], "max_abs_err": err, "device_ms": device_ms,
           "kernel_ms": cuda_ms(lambda: hamming.hamming_matrix(a, b), reps=10),
           "host_us": host_us(lambda: hamming.hamming_matrix(a, b, out=out)),
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print("hamming_matrix at the relocalization shape", json.dumps(row), flush=True)
    return row


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


class RelocProbe:
    """While active, wraps ``pose_opt.relocalize`` (which ``System`` calls
    through the module): per call the outcome, the B1 launches inside it
    and its time between CUDA events (host clock on the CPU).  Reading the
    outcome is a host read the System makes right after anyway."""

    def __init__(self):
        self.calls: list[dict] = []

    def __enter__(self):
        self._real = pose_opt.relocalize

        def probe(feats, kfs, points, K, cfg):
            cuda = feats.xy.is_cuda
            before = cuda_build.LAUNCHES["hamming_matrix"]
            if cuda:
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
            t0 = time.perf_counter()
            ok, T, n = self._real(feats, kfs, points, K, cfg)
            if cuda:
                b.record()
                b.synchronize()
            self.calls.append(dict(
                ok=bool(ok), n_inliers=int(n),
                b1_launches=cuda_build.LAUNCHES["hamming_matrix"] - before,
                ms=a.elapsed_time(b) if cuda else (time.perf_counter() - t0) * 1e3))
            return ok, T, n

        pose_opt.relocalize = probe
        return self

    def __exit__(self, *exc):
        pose_opt.relocalize = self._real


def run_frames(sys_: System, frames, depths=None, first: int = 0, localize_after=None,
               probe: RelocProbe | None = None, timed: bool = False):
    """Track ``frames`` (through ``track_monocular_ct`` where ``depths`` are
    given), timestamps from ``first``.  Returns per-frame seconds and, per
    frame, the relocalization calls it made."""
    frame_s, relocs = [], []
    for i, frame in enumerate(frames):
        t = first + i
        n0 = len(probe.calls) if probe else 0
        t0 = time.perf_counter()
        if depths is None:
            sys_.track_monocular(frame, timestamp=float(t))
        else:
            sys_.track_monocular_ct(frame, depths[i], timestamp=float(t))
        if timed:
            torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
        relocs.append([dict(frame=t, **c) for c in probe.calls[n0:]] if probe else [])
        if localize_after is not None and t == localize_after:
            sys_.activate_localization_mode()
    return frame_s, relocs


def _close(a: int, b: int) -> bool:
    """Inlier counts within 2% (or 1)."""
    return abs(a - b) <= max(1, 0.02 * b)


def compare_rows(gpu: System, cpu: System, relocs_g, relocs_c, upto: int | None = None):
    """Per frame through ``upto``: tracking state, keyframe and template
    flags equal, and the frame's relocalization calls alike (ok equal,
    inliers within 2% or 1).  The frames' own inlier counts are reported
    (``inlier_gap``, relative), not held: after a relocalization the SfT's
    sensitivity (the 1e-7 probe of the tracking slice) moves them by a few
    percent on either device."""
    n = len(cpu._metrics) if upto is None else upto + 1
    rows = []
    for i in range(n):
        mg, mc = gpu._metrics[i], cpu._metrics[i]
        rg = [(c["ok"], c["n_inliers"]) for c in relocs_g[i]]
        rc = [(c["ok"], c["n_inliers"]) for c in relocs_c[i]]
        ok_reloc = len(rg) == len(rc) and all(a[0] == b[0] and _close(a[1], b[1])
                                              for a, b in zip(rg, rc))
        ok = all(mg[k] == mc[k] for k in ("state", "keyframe", "template")) and ok_reloc
        row = dict(frame=i, state=[mg["state"], mc["state"]], inliers=[mg["inliers"], mc["inliers"]],
                   matches=[mg["matches"], mc["matches"]], reloc=[rg, rc],
                   inlier_gap=abs(mg["inliers"] - mc["inliers"]) / max(1, mc["inliers"]),
                   ok=bool(ok))
        print("frame", json.dumps(row), flush=True)
        rows.append(row)
    return rows


def relocalization_slice(cfg: Config, dev) -> dict:
    """The 12-frame render of the bench motion, localization mode after
    frame 0, on the card (counts cleared just before, read just after) and
    on the CPU.  Fails unless every frame tracks, a relocalization succeeds,
    each relocalization launched B1 once, and the card's run equals the
    CPU's in states and relocalization outcomes."""
    seq = make_sequence(n_frames=N_FRAMES, **BENCH_MOTION)
    gpu = System(cfg, device=dev)
    cuda_build.LAUNCHES.clear()
    with RelocProbe() as probe:
        frame_s, relocs = run_frames(gpu, seq.frames, localize_after=0, probe=probe, timed=True)
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    states = [m["state"] for m in gpu._metrics]
    print("relocalization states", states, "relocalize", json.dumps(probe.calls),
          "launches", launches, flush=True)
    if any(st != TrackingState.OK.name for st in states):
        raise SystemExit(f"relocalization slice: not every frame tracked: {states}")
    if not any(c["ok"] for c in probe.calls):
        raise SystemExit("relocalization slice: no relocalization succeeded")
    if any(c["b1_launches"] != 1 for c in probe.calls):
        raise SystemExit("relocalization slice: a relocalize call did not launch B1 exactly once")
    # the steady-state time of one relocalization at full width (24 slots)
    feats = extract_features(torch.as_tensor(seq.frames[1], device=dev), cfg)
    reloc_ms = cuda_ms(lambda: pose_opt.relocalize(feats, gpu.kfs, gpu.points, gpu.K, cfg),
                       reps=5, warmup=1)
    cpu = System(cfg, device="cpu")
    with RelocProbe() as probe_c:
        _, relocs_c = run_frames(cpu, seq.frames, localize_after=0, probe=probe_c)
    rows = compare_rows(gpu, cpu, relocs, relocs_c)
    if not all(r["ok"] for r in rows):
        raise SystemExit("relocalization slice: the card's run disagrees with the CPU run")
    reloc_frames = [i for i, r in enumerate(relocs) if any(c["ok"] for c in r)]
    return {"launches": launches, "calls": probe.calls, "rows": rows,
            "relocalize_ms": reloc_ms,
            "relocalize_call_ms": [c["ms"] for c in probe.calls],
            "relocalized_frame_ms": [frame_s[i] * 1e3 for i in reloc_frames],
            "frame_p50_ms": statistics.median(frame_s[1:]) * 1e3, "gpu": gpu}


def _tokens(path: str) -> list[list[str]]:
    with open(path) as f:
        return [r.split() for r in f.read().splitlines()]


def files_gap(dir_a: str, dir_b: str) -> dict:
    """Per result file: rows equal in number, the largest absolute gap of
    the numeric columns and the count of differing words (states)."""
    out = {}
    for name in RESULT_FILES:
        a, b = _tokens(os.path.join(dir_a, name)), _tokens(os.path.join(dir_b, name))
        gap, words = 0.0, 0
        for ra, rb in zip(a, b):
            for x, y in zip(ra, rb):
                try:
                    gap = max(gap, abs(float(x) - float(y)))
                except ValueError:
                    words += x != y
        out[name] = {"rows": [len(a), len(b)], "gap": gap, "words": words,
                     "equal": open(os.path.join(dir_a, name)).read()
                     == open(os.path.join(dir_b, name)).read()}
    return out


def occlusion_run(cfg: Config, seq, dev, outdir: str, save_after: int | None = None,
                  probe: RelocProbe | None = None):
    """The occlusion render on the card through ``track_monocular_ct`` with
    the metrics files on, written to ``outdir``.  With ``save_after``: ``save_state``
    after that frame, then a fresh System on ``dev`` loads the checkpoint
    and runs the rest.  Returns (system, frame seconds, relocalization
    calls per frame, save and load ms)."""
    run_cfg = dataclasses.replace(cfg, save_results=True, output_dir=outdir)
    n = len(seq.frames)
    cut = n if save_after is None else save_after + 1
    s = System(run_cfg, device=dev)
    frame_s, relocs = run_frames(s, seq.frames[:cut], seq.depths[:cut], probe=probe, timed=True)
    io_ms = {}
    if save_after is not None:
        ckpt = os.path.join(outdir, "checkpoint.npz")
        t0 = time.perf_counter()
        s.save_state(ckpt)
        io_ms["save_state_ms"] = (time.perf_counter() - t0) * 1e3
        s = System(run_cfg, device=dev)
        t0 = time.perf_counter()
        s.load_state(ckpt)
        torch.cuda.synchronize()
        io_ms["load_state_ms"] = (time.perf_counter() - t0) * 1e3
        more_s, more = run_frames(s, seq.frames[cut:], seq.depths[cut:], first=cut, probe=probe,
                                  timed=True)
        frame_s, relocs = frame_s + more_s, relocs + more
    s.write_metrics()
    return s, frame_s, relocs, io_ms


def occlusion_phase(cfg: Config, dev) -> dict:
    """Phase 8 (see the module's docstring)."""
    seq = make_sequence(n_frames=2 * N_FRAMES, occlusion=OCCLUSION, **BENCH_MOTION)
    root = os.path.join("chiprun_out", "occlusion")
    shutil.rmtree(root, ignore_errors=True)
    dirs = {k: os.path.join(root, k) for k in ("full", "repeat", "resumed")}
    cuda_build.LAUNCHES.clear()
    with RelocProbe() as probe:
        gpu, frame_s, relocs, _ = occlusion_run(cfg, seq, dev, dirs["full"], probe=probe)
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    states = [m["state"] for m in gpu._metrics]
    print("occlusion states", states, "relocalize", json.dumps(relocs[OCCLUSION[0]:]),
          "launches", launches, flush=True)
    after = OCCLUSION[1] + 1
    if states[OCCLUSION[0]:after] != ["LOST"] * (after - OCCLUSION[0]):
        raise SystemExit(f"occlusion run: frames {OCCLUSION} are not LOST: {states}")
    if states[after] != "OK" or not any(c["ok"] for c in relocs[after]):
        raise SystemExit(f"occlusion run: frame {after} was not recovered by relocalization")
    reinit = [m["frame"] for m in gpu._metrics[1:] if m["state"] == "OK" and m["matches"] == 0]
    if reinit or int(gpu.kfs.valid.sum()) < 2:
        raise SystemExit(f"occlusion run: the map was re-initialized (frames {reinit})")
    iso = [f for f in os.listdir(dirs["full"]) if f.startswith("ErrorAngIso")]
    missing = [f for f in ("ErrorGTs0.txt", "ScaleVariation.txt") if
               not os.path.exists(os.path.join(dirs["full"], f))]
    if missing or not iso:
        raise SystemExit(f"occlusion run: GT files missing ({missing}, ErrorAngIso: {iso})")
    gt_rows = len(gpu._gt_eval.rows)

    # repeatability of the card, then the resumed run
    occlusion_run(cfg, seq, dev, dirs["repeat"])
    resumed, _, _, io_ms = occlusion_run(cfg, seq, dev, dirs["resumed"],
                                         save_after=CHECKPOINT_AFTER)
    repeat = files_gap(dirs["full"], dirs["repeat"])
    resume = files_gap(dirs["full"], dirs["resumed"])
    repeatable = all(v["equal"] for v in repeat.values())
    print("occlusion repeat", json.dumps(repeat), "resume", json.dumps(resume), flush=True)
    for name in RESULT_FILES:
        r, q = resume[name], repeat[name]
        ok = r["equal"] if repeatable else (
            r["rows"][0] == r["rows"][1] and r["gap"] <= 3 * q["gap"] and r["words"] <= q["words"])
        if not ok:
            raise SystemExit(f"resumed run: {name} differs from the uninterrupted run "
                             f"(repeatable card: {repeatable}): {r} against {q}")

    # the CPU's run through frame OCCLUSION[1] + 2
    upto = after + 1
    cpu = System(cfg, device="cpu")
    with RelocProbe() as probe_c:
        _, relocs_c = run_frames(cpu, seq.frames[:upto + 1], probe=probe_c)
    rows = compare_rows(gpu, cpu, relocs, relocs_c, upto=upto)
    if not all(r["ok"] for r in rows):
        raise SystemExit("occlusion run: the card's run disagrees with the CPU run")

    # one GT evaluation at full width (a fresh evaluator: the run's rows stay)
    ev = gtmod.GroundTruthEvaluator(cfg)
    depth = seq.depths[-1]
    gt_ms = cuda_ms(lambda: ev.evaluate_depth(gpu, depth, 0.0), reps=5, warmup=1)
    return {"launches": launches, "states": states, "relocs": relocs[OCCLUSION[0]:after + 1],
            "repeatable": repeatable, "repeat": repeat, "resume": resume, "rows": rows,
            "gt_rows": gt_rows, "angle_files": sorted(iso),
            "relocalized_frame_ms": frame_s[after] * 1e3,
            "lost_frame_ms": [frame_s[i] * 1e3 for i in range(OCCLUSION[0], after)],
            "gt_eval_ms": gt_ms, **io_ms}


def stereo_check(cfg: Config, seq, dev, tol: float = 1e-4) -> dict:
    """``stereo_depth_ncc`` at full width, the card against the CPU: a
    frame of the render blurred, the right image that frame shifted 9 px
    (the depth planted is 54 / 9), 4096 points (the map's capacity)."""
    rng = np.random.default_rng(9)
    img = _gaussian_blur(np.asarray(seq.frames[0], np.float32), 1.5)
    img_r = np.roll(img, -9, axis=1)
    h, w = img.shape
    n = cfg.capacity.max_map_points
    uv = np.stack([rng.uniform(0, w - 1, n), rng.uniform(0, h - 1, n)], 1).astype(np.float32)
    mask = rng.uniform(size=n) < 0.9
    out = {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        args = [torch.as_tensor(x, device=device) for x in (img, img_r, uv, mask)]
        out[name] = gtmod.stereo_depth_ncc(*args, 54.0, cfg)
    args = [torch.as_tensor(x, device=dev) for x in (img, img_r, uv, mask)]
    ms = cuda_ms(lambda: gtmod.stereo_depth_ncc(*args, 54.0, cfg), reps=5)
    (dg, okg), (dc, okc) = out["card"], out["cpu"]
    ok_equal = torch.equal(okg.cpu(), okc)
    rel = float(((dg.cpu() - dc).abs() / dc.abs().clamp(min=1e-6)).max())
    row = {"n": n, "ok_equal": ok_equal, "n_ok": int(okc.sum()), "depth_rel_gap": rel, "ms": ms,
           "median_depth_ok": float(dc[okc].median())}
    print("stereo_card_vs_cpu", json.dumps(row), flush=True)
    if not ok_equal or rel > tol:
        raise SystemExit(f"stereo_depth_ncc: the card disagrees with the CPU: {row}")
    return row


def pipelined_config(camera, **tracking) -> Config:
    """The JAX package's measured configuration (bench.py:60-90)."""
    return Config(camera=camera,
                  orb=OrbConfig(n_features=1200, n_levels=6, max_keypoints=1536),
                  sft=SfTConfig(lm_iterations=50),
                  tracking=TrackingConfig(keyframe_period=10, pipeline_depth=2, **tracking),
                  capacity=CapacityConfig(max_map_points=4096, max_keyframes=16))


def pipelined_run(frames, cfg: Config, dev, check_waits: bool = False):
    """bench.py's protocol: ``PIPE_WARM`` frames, a ``flush``, then the rest
    measured by the host clock per ``track_monocular`` call, the final
    ``flush`` added to the last frame.  With ``check_waits`` every measured
    dispatch runs under ``profiling.host_waits``: mode "error" where it
    dispatches no keyframe work, else "warn" with its waits counted (and
    "warn" for the first, which may meet first-use set-up).  Returns
    (system, measured frame ms, whether each dispatched keyframe work,
    the waits counted)."""
    s = System(cfg, device=dev)
    for t in range(PIPE_WARM):
        s.track_monocular(frames[t], timestamp=float(t))
    s.flush()
    torch.cuda.synchronize()
    frame_ms, kf_work, waits = [], [], []
    for t in range(PIPE_WARM, len(frames)):
        work = (s.frames_since_kf + 1 >= cfg.tracking.keyframe_period
                or s._pending_kf_b is not None)
        mode = "warn" if work or t == PIPE_WARM else "error"
        t0 = time.perf_counter()
        if check_waits:
            with profiling.host_waits(mode) as w:
                s.track_monocular(frames[t], timestamp=float(t))
        else:
            s.track_monocular(frames[t], timestamp=float(t))
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        kf_work.append(work)
        if check_waits:
            waits.append(dict(frame=t, mode=mode, keyframe_work=work, waits=sum(w.values()),
                              where=dict(w)))
    t0 = time.perf_counter()
    s.flush()
    torch.cuda.synchronize()
    frame_ms[-1] += (time.perf_counter() - t0) * 1e3
    return s, frame_ms, kf_work, waits


def _frame_stats(s: System, frame_ms, kf_work) -> dict:
    ms = sorted(frame_ms)
    return {"frame_p50_ms": statistics.median(ms),
            "frame_p95_ms": float(np.percentile(ms, 95)), "frame_max_ms": ms[-1],
            "keyframe_frame_ms": [x for x, w in zip(frame_ms, kf_work) if w],
            "fps": len(ms) / (sum(ms) / 1e3), "rollbacks": s.n_rollbacks,
            "template_swaps": sum(m["template"] for m in s._metrics[1:])}


def _same_rows(a: System, b: System, tol: float = 1e-6) -> tuple[bool, float]:
    """Metrics rows equal and the largest trajectory gap (within ``tol``)."""
    gap = max((float(np.abs(np.asarray(x[1]) - np.asarray(y[1])).max())
               for x, y in zip(a.trajectory, b.trajectory)), default=0.0)
    same = (a._metrics == b._metrics and len(a.trajectory) == len(b.trajectory)
            and all(x[0] == y[0] for x, y in zip(a.trajectory, b.trajectory)))
    return same and gap <= tol, gap


def pipelined_slice(dev) -> dict:
    """Phase 10 (see the module's docstring)."""
    seq = make_sequence(n_frames=2 * N_FRAMES, **BENCH_MOTION)
    frames = [torch.as_tensor(f.astype(np.uint8), device=dev) for f in seq.frames]
    torch.cuda.synchronize()
    modes = {"synchronous": dict(pipelined=False), "pipelined_fused": {},
             "pipelined_split": dict(split_keyframe_dispatch=True)}
    runs, stats, launches = {}, {}, {}
    for name, tracking in modes.items():
        split = name == "pipelined_split"
        if split:
            cuda_build.LAUNCHES.clear()
        s, frame_ms, kf_work, _ = pipelined_run(frames, pipelined_config(seq.camera, **tracking),
                                                dev)
        if split:
            launches = dict(cuda_build.LAUNCHES)
        runs[name] = s
        stats[name] = {**_frame_stats(s, frame_ms, kf_work),
                       "ate": gtmod.ate_rmse_trajectory(s.trajectory, seq.poses)}
        print("pipelined", name, json.dumps(stats[name]),
              "states", [m["state"] for m in s._metrics], flush=True)
    # the host-wait checks on a run of their own, so the timed runs above
    # carry no instrumentation
    *_, waits = pipelined_run(frames, pipelined_config(seq.camera, **modes["pipelined_split"]),
                              dev, check_waits=True)
    print("pipelined host_waits", json.dumps(waits), "launches", launches, flush=True)
    for name, s in runs.items():
        if any(m["state"] != TrackingState.OK.name for m in s._metrics):
            raise SystemExit(f"pipelined slice ({name}): not every frame tracked")
    if stats["pipelined_split"]["template_swaps"] < 1:
        raise SystemExit("pipelined slice: the split run swapped no template")
    if launches.get("hamming_matrix", 0) < 1 or launches.get("windowed_match", 0) < 1:
        raise SystemExit(f"pipelined slice: a kernel did not launch: {launches}")
    for w in waits:
        svd = sum(n for where, n in w["where"].items() if where.startswith(SVD_SITE))
        if w["keyframe_work"] and (w["waits"] - svd > 2 or svd > 4):
            raise SystemExit(f"pipelined slice: a keyframe dispatch waited on the card more "
                             f"than the branch reads and the SVD's: {w}")
    same, gap = _same_rows(runs["synchronous"], runs["pipelined_fused"])
    if not same:
        raise SystemExit(f"pipelined slice: the pipelined run's rows differ from the "
                         f"synchronous run's (trajectory gap {gap})")
    ate_f, ate_s = stats["pipelined_fused"]["ate"], stats["pipelined_split"]["ate"]
    if not ate_s < max(2.0 * ate_f, ate_f + 0.02):
        raise SystemExit(f"pipelined slice: split ATE {ate_s} against fused {ate_f}")
    return {"stats": stats, "host_waits": waits, "launches": launches,
            "pipelined_vs_synchronous_gap": gap, "rollbacks": pipelined_rollbacks(seq, frames, dev)}


def pipelined_rollbacks(seq, frames, dev) -> dict:
    """A blank frame at the keyframe slot (frame 10): the pipelined run must
    roll the optimistic keyframe back and end as the synchronous run.  A
    blank frame right after a split keyframe (frame 11, between the
    halves): the run must recover, with the stores consistent."""
    blank = lambda fs, at: [torch.full_like(f, 128) if t == at else f  # noqa: E731
                            for t, f in enumerate(fs)]
    period = 10
    out = {}
    at_kf = blank(frames[:period + 1], period)
    runs = {}
    for name, tracking in (("synchronous", dict(pipelined=False)), ("pipelined", {})):
        s = System(pipelined_config(seq.camera, **tracking), device=dev)
        for t, f in enumerate(at_kf):
            s.track_monocular(f, timestamp=float(t))
        s.flush()
        runs[name] = s
    a, b = runs["synchronous"], runs["pipelined"]
    same, gap = _same_rows(a, b)
    same = same and all(getattr(a, k) == getattr(b, k) for k in ("kf_counter", "template_ref_kf"))
    same = same and int(a.kfs.valid.sum()) == int(b.kfs.valid.sum())
    same = same and len(a.template_history) == len(b.template_history)
    out["at_keyframe"] = {"equal": same, "gap": gap, "rollbacks": b.n_rollbacks,
                          "states": [m["state"] for m in b._metrics]}
    if not same or b.n_rollbacks < 1 or b._metrics[period]["state"] == "OK":
        raise SystemExit(f"pipelined rollback at the keyframe slot: {out['at_keyframe']}")
    after = blank(frames[:period + 5], period + 1)
    s = System(pipelined_config(seq.camera, split_keyframe_dispatch=True), device=dev)
    for t, f in enumerate(after):
        s.track_monocular(f, timestamp=float(t))
    s.flush()
    pid = s.kfs.point_id
    bound = pid[pid >= 0]
    states = [m["state"] for m in s._metrics]
    consistent = bool((bound < s.points.capacity).all()) and float(
        s.points.valid[bound].float().mean()) > 0.5
    out["after_split_keyframe"] = {"states": states, "rollbacks": s.n_rollbacks,
                                   "consistent": consistent}
    print("pipelined rollbacks", json.dumps(out), flush=True)
    if (states[period + 1] == "OK" or states[-1] != "OK" or not consistent
            or s.n_rollbacks < 1):
        raise SystemExit(f"pipelined rollback after a split keyframe: {out}")
    return out


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
    phase_s: dict[str, float] = {}  # wall seconds of each phase, in order
    t_last = t0

    def phase_done(name: str) -> None:
        nonlocal t_last
        now = time.perf_counter()
        phase_s[name] = now - t_last
        t_last = now

    report = cuda_build.build()
    build_s = time.perf_counter() - t0
    for name, r in report.items():
        print(f"build {name}: {r['seconds']:.2f} s\n{r['log'].strip()}", flush=True)
    print(f"build total: {build_s:.2f} s", flush=True)

    # the JAX package's full-size bench regime (bench.py: 24 frames of
    # handheld 6-DoF motion).  The tracking slice tracks its first 12
    # frames; the mapping slice runs all 24.  The relocalization slice runs
    # a 12-frame render of the same motion, which moves twice as far per
    # frame: frame 1 then gets 24 matches and 2 inliers in both packages,
    # and only relocalization recovers it.
    seq = make_sequence(n_frames=2 * N_FRAMES, **BENCH_MOTION)
    cfg = Config(camera=seq.camera, tracking=TrackingConfig(pipelined=False))

    rates = card_rates()
    print("card_rates", json.dumps(rates), flush=True)
    phase_done("build")
    kern_h = check_hamming(dev, rates)
    kern_h["relocalization_shape"] = hamming_at_relocalization(dev)
    kern_w = check_windowed_match(cfg, dev, rates)
    phase_done("kernels")
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

    phase_done("tracking_slice")
    # ---- one keyframe step, the card against the CPU (it also warms the
    # mapping chain's libraries outside the timed and counted run)
    torch.set_num_threads(max(1, os.cpu_count() or 1))
    kf_row = keyframe_card_vs_cpu(seq.frames, cfg, dev)

    phase_done("keyframe_card_vs_cpu")
    # ---- mapping slice
    gpu_map, map_frame_s, launches_m, steps = mapping_slice(seq.frames, cfg, dev)
    phase_done("mapping_slice")
    plain_s = [map_frame_s[m["frame"]] for m in gpu_map._metrics[1:] if not m["keyframe"]]
    kf_s = [map_frame_s[m["frame"]] for m in gpu_map._metrics[1:] if m["keyframe"]]
    timing.update({
        "keyframe_ms": [st["keyframe_ms"] for st in steps],
        "keyframe_stages_ms": steps,
        "first_keyframe_ms_with_library_setup": kf_row["first_step_stages_ms"]["keyframe_ms"],
        "mapping_frame_p50_ms": statistics.median(plain_s) * 1e3,
        "mapping_keyframe_frame_ms": [x * 1e3 for x in kf_s],
    })

    # ---- relocalization slice, occlusion run with GT and checkpoint, stereo GT
    reloc = relocalization_slice(cfg, dev)
    phase_done("relocalization_slice")
    occl = occlusion_phase(cfg, dev)
    phase_done("occlusion_gt_checkpoint")
    stereo = stereo_check(cfg, seq, dev)
    phase_done("stereo_gt")
    pipe = pipelined_slice(dev)
    phase_done("pipelined_slice")
    timing.update({
        "relocalize_ms": reloc["relocalize_ms"],
        "relocalize_call_ms": reloc["relocalize_call_ms"],
        "relocalized_frame_ms": reloc["relocalized_frame_ms"] + [occl["relocalized_frame_ms"]],
        "lost_frame_ms": occl["lost_frame_ms"],
        "relocalization_frame_p50_ms": reloc["frame_p50_ms"],
        "gt_eval_ms": occl["gt_eval_ms"],
        "save_state_ms": occl["save_state_ms"],
        "load_state_ms": occl["load_state_ms"],
        "stereo_ncc_ms": stereo["ms"],
        "pipelined": pipe["stats"],
    })
    print("timing", json.dumps(timing), flush=True)

    paths = {"tracking": launches_t, "mapping": launches_m,
             "relocalization": reloc["launches"], "occlusion_gt": occl["launches"],
             "pipelined": pipe["launches"]}
    for k, name in ((kern_h, "hamming_matrix"), (kern_w, "windowed_match")):
        k["launches_by_path"] = {p: counts.get(name, 0) for p, counts in paths.items()}
        k["launches"] = sum(k["launches_by_path"].values())
    kern_h["launches_inside_relocalize"] = sum(
        c["b1_launches"] for c in reloc["calls"]) + sum(
        c["b1_launches"] for r in occl["relocs"] for c in r)

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
    phase_done("tracking_and_mapping_on_cpu")
    print("phase_s", json.dumps(phase_s), flush=True)

    for run in (gpu, gpu_map):
        pose = run.trajectory[-1][1]
        if not np.isfinite(pose).all() or pose.shape != (4, 4):
            raise SystemExit("final pose is not a finite 4x4 matrix")

    kernels = [kern_h, kern_w]
    reloc.pop("gpu")
    out = {"nvidia_smi": smi, "build_s": build_s, "kernels": kernels, "timing": timing,
           "frames": rows, "mapping_frames": map_rows, "mapping_diags": gpu_map.map_diags,
           "keyframe_card_vs_cpu": kf_row, "relocalization": reloc, "occlusion": occl,
           "stereo_card_vs_cpu": stereo, "pipelined": pipe, "phase_s": phase_s}
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
