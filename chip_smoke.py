"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py             # every phase
    python3 chip_smoke.py --kernels   # phases 1-3 only, B1 at every shape (no ``ok`` line)
    python3 chip_smoke.py --rigid     # phases 1-3 for B1, then phase 12 (no ``ok`` line)
    python3 chip_smoke.py --parallel  # phases 1-3, then phase 13 (no ``ok`` line)
    python3 chip_smoke.py --longhaul  # phases 1-3 for both kernels, then phase 14 (no ``ok`` line)
    python3 chip_smoke.py --multicard # phases 1-3, then phase 15 on 4 cards (no ``ok`` line)

A phase run alone writes ``chiprun_out/chip_smoke_<phase>.json``.

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
11. the apps: the 24-frame bench render with a right view (baseline 0.05)
   written as a DefSLAMGT-layout PNG dataset (``tools.make_synth_dataset``)
   with the default Config's ORB settings, and ``cli.main(["stereo", ...])``
   on the card in the default pipelined protocol, its readers decoding the
   PNGs with the port's codec on their threads; the launches are counted
   over that run.  Every frame must track, a keyframe swap the template,
   B1 launch on every tracked frame and B2 twice per keyframe step, and the
   six result files must equal those of the same decoded frames fed from
   memory through ``System.track_monocular_gt`` (bit for bit, or, where the
   card does not repeat itself, within the gap between two in-memory runs).
   The stereo app again on the same frames re-encoded with costlier row
   filters (left images as ``cv2.imwrite`` writes them where OpenCV is
   installed, else Paeth; right images Paeth): its result files must equal
   the first app run's under the same rule.  Then one frame's decode alone
   in each encoding, and a Sub-filtered frame's unfiltering step through
   both of the reader's paths.  The stereo app once more on frames 16-23 with a LEFT./RIGHT. calibration,
   so that the readers remap: every frame must track.  Then the mono and ct
   apps on the first 12 frames: from an MJPG video that OpenCV writes where
   OpenCV is installed (the decode then runs on the card's host), else from
   the rendered frames in ``load_video``'s place; ct reads depth text files.
   It prints the readers' decode and remap ms, the prefetch wait and the
   app's frame p50 beside the in-memory run's, and whether video decode ran;
12. the rigid ORB-SLAM2 mode (``rigid.system.RigidSystem``) at full width
   (the default Config, a keyframe every 4 frames) on 24 frames of a static
   render (camera_motion 0.5, seed 3): it must initialize within the first
   8 frames, track every later frame, keep at least 3 keyframes and grow
   the map past its initial points, and B1 must launch at (4096, 1536)
   (every map point against the frame) on every tracked frame; the launches
   are counted over that run.  The card runs it twice (does it repeat
   itself?), the CPU on its first 12 frames, once as it is and once with
   the map perturbed by 1e-7 after the initialization (the probe): states and
   the initialization frame equal, point and keyframe counts within 2%,
   poses within max(1e-3, 3x the probe's gap).  Then ``close_loop`` and
   ``fuse_and_global_ba`` on a pre-loop world at full capacity (24 slots x
   1536 keypoints, 4096 points) on the card and on the CPU: the same
   candidate, the reprojection error at least halved, poses within 1e-3.
   Then
   ``cli.main(["mono", yaml, video, "--orbslam"])`` on 12 frames of an MJPG
   video (where OpenCV is installed) must write ``Trajectory.txt``.
   It prints the rigid frame p50 / max, initialization, local BA,
   ``close_loop`` and global BA ms (CUDA events);
13. the multi-device path (``parallel.enabled``, ``torch.distributed``):
   ``System`` at world 1 over NCCL on the 24 full-width frames of the
   mapping slice's config (keyframes 10 and 20 through the legacy chain),
   twice; every frame must track, B2 launch twice per keyframe and B1 on
   every frame and re-anchor (the launches are counted over the first
   run), the two runs be bit-equal, and no frame without a keyframe make
   a host wait (``profiling.host_waits("error")``, second run).  Against
   the mapping slice's single-device run: states, keyframe and template
   flags equal, matches and inliers within max(1, 2%), the pose within
   max(2e-2, 3x the gap a 1e-7 template perturbation opens in the
   single-device run on the card, frames 0-10), the counts and the pose
   through the first keyframe frame only: after a template swap the legacy
   chain keeps another map, in the JAX package too (ROADMAP C).  The same
   parallel run on the CPU over
   gloo (12 frames, keyframe 10) under ``compare_runs``'s rules.  Then
   the sharded solvers at world 1 (NCCL) and at world 2, two worker
   processes sharing the card over gloo with CUDA tensors (NCCL puts no
   two ranks on one device): the last frame's SfT problem (1536
   observations, 100 nodes), keyframe 10's 8 warp pairs and its normal
   problem over 4096 points, and a 16x16 template with 512 observations
   (the Schur partition); the ranks bit-equal, world 2 within 1e-4 of
   world 1 (pose, nodes, warps; Schur nodes 2e-4; the frame's SfT within
   max(1e-4, 3x the gap a 1e-7 perturbation of its start opens), 99% of
   the inlier gate, normals within 3e-3 where the covariance gate keeps
   them.  It
   prints the parallel frame p50 / max, the keyframe frames' ms, their
   chain's and the chain-plus-re-anchor's CUDA-event ms, all-reduce calls
   and bytes per frame, and the SfT's host ms at world 1 and 2.  Last,
   the synth app (``cli synth``, 12 frames at 320x240, the default Config,
   ``parallel.enabled``, ``n_devices`` 1) through ``parallel.launch`` at
   world 1 over NCCL: its rank-0 result files must equal those of the
   same app run in this process, byte for byte.  Every collective has a
   180 s timeout;
14. the JAX package's long-haul run at full scale (tests/test_stress_longhaul.py
   with DEFSLAM_STRESS_FULL=1, BASELINE.md:137): 240 frames of a 640x480
   render (handheld 6-DoF motion over 0.9 world units, three deformation
   modes, brightness drift, frames 117-121 blank, seed 9), 1200 features, 4
   levels, 1536 keypoints, 4096 points, 50 LM iterations, a keyframe every
   10 frames into 12 slots, the default protocol (pipelined, depth 2,
   fused keyframes).  The render runs in pieces on worker processes
   started before the build and is gathered after it (``phase_s``'s
   ``longhaul_render_wait``), so that it overlaps the build only; a System
   of its own takes 12 warm-up frames first.  It fails if an occluded frame tracks, if the run
   has not recovered within 3 frames of the scene's return or loses a
   frame after that, on fewer than 12 evictions or 3 template swaps, a
   template anchored at frame <= 80, a last third of inliers at or under
   0.3x the first third's, fewer B1 launches than tracked frames, no B1
   launch at 1536x18432 inside a relocalization, B2 launched other than
   twice per keyframe step, or device memory after frame 240 more than
   32 MB over its value after frame 48.  It prints ATE and the final
   median depth error beside the JAX package's full-scale gates on its TPU
   (< 0.20, < 0.10; not gated here), frame p50 / p95 / max over frames
   24-48 and 216-240, the keyframe, LOST and recovered frames' ms,
   ``relocalize_ms`` at 12 slots, rollbacks, host RSS and
   ``max_memory_allocated``;
15. only with ``--multicard``, which needs 4 cards: the multi-device
   System at world 4 over NCCL, one rank per card.  It prints each card's
   name and power limit and ``nvidia-smi topo -m``; holds B1 and B2
   against their plain versions on cards 1-3 at phase 3's cases (card 0
   is phase 3's); runs the tracking slice on ``cuda:3`` with ``cuda:0``
   current, bit-equal to ``cuda:0``'s.  World 1 in this process (phase 13's
   run on the 24 frames, its 1e-7 probe, the sharded solvers on the run's
   inputs) is the reference.  One launch of 4 ranks (``parallel.launch``,
   ``parallel.n_devices`` 0: every card) runs the System on the 24 frames
   twice per rank: the ranks and the two runs bit-equal; each rank's B1 on
   every frame and re-anchor and B2 twice per keyframe; no host wait on a
   frame without a keyframe; held to world 1 (states, keyframe and
   template flags equal, matches and inliers within max(1, 2%), the pose
   within max(2e-2, 3x the probe's gap) on every frame); the sharded
   solvers within phase 13's world-2 limits of world 1 (the Schur problem
   at 4 u-rows a rank).  The ranks then run the synth app as a world of 4,
   and ``cli synth`` started alone with ``n_devices`` 0 spans the 4 cards
   and must write the same files (the app's process is rank 0 of the
   world its System makes).  Then the world a System makes in this process
   (``parallel.driver``): ``System(cfg)`` with ``n_devices`` 0, this
   process rank 0 on ``cuda:0`` and its workers on ``cuda:1-3`` (each
   reports its card), on the 24 frames twice (``reset`` between): the
   ranks bit-equal (their digests), the runs bit-equal, rank 0 bit-equal to
   rank 0 of the launch, B1 and B2 launched on every rank as there
   (every rank's counts set to 0 before the run and read after it), no
   host wait on rank 0 on a frame without a keyframe.  The ``mono`` app at
   world 4 reading an MJPG video of the 24 frames on rank 0 alone, with a
   ``--tune`` file written at frame 12: its files equal those of an
   in-process world-4 System given the decoded frames and
   ``apply_tuning``.  Times, not gated: the parallel frame p50 / max,
   keyframe frames, all-reduces per frame, the SfT's host ms and one
   all-reduce alone at its buffer's size, at world 4 and world 1, each
   also with ``TORCH_NCCL_AVOID_RECORD_STREAMS=1`` (for those runs only),
   on frames 0-11 after a warm-up; the in-process world's frame p50
   against the launch's, its start, the host us of a forwarded call, and
   a 640x480 float32 frame handed from rank 0 to the ranks of the launch
   pickled on a gloo group (the driver's way) and as a gloo header plus
   an NCCL broadcast of rank 0's device copy (host us, delivery us, bit
   for bit).  Last, the worker on ``cuda:2`` killed 1 s into a run: rank
   0 raises ``RuntimeError`` naming rank 2 within the collective timeout
   plus a few seconds, no worker is left, no group is up, and a new
   System comes up on the four cards and tracks;
16. print a ``timing`` line, one ``{"kernels": [...]}`` line, then the last
   line ``{"ok": true, "device": {...}}``.

Every phase before the pipelined slice runs the synchronous protocol
(``tracking.pipelined=False``), so its numbers compare with earlier runs.

Imports nothing of JAX or of the JAX package.  A copy of the numbers goes
to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import json
import math
import multiprocessing
import os
import pickle
import re
import shutil
import signal
import statistics
import struct
import subprocess
import sys
import threading
import time
import zlib
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from defslam_tpu_torch import cli, parallel, profiling
from defslam_tpu_torch.config import (CapacityConfig, Config, MappingConfig, MeshConfig,
                                      OrbConfig, ParallelConfig, SfTConfig, TrackingConfig)
from defslam_tpu_torch.io.synthetic import SyntheticSequence, _gaussian_blur, make_sequence
from defslam_tpu_torch.frontend import extract_features
from defslam_tpu_torch.geometry import camera as cam
from defslam_tpu_torch.groundtruth import gt as gtmod
from defslam_tpu_torch.mapping import mapper
from defslam_tpu_torch.mapping import normals as nrm
from defslam_tpu_torch.mapstore import state as store
from defslam_tpu_torch.ops import cuda_build, hamming, matching, windowed_match
from defslam_tpu_torch.parallel import launch, sharded
from defslam_tpu_torch.rigid import loop_closing as rigid_loop
from defslam_tpu_torch.rigid import triangulation as rigid_tri
from defslam_tpu_torch.rigid.system import RigidSystem
from defslam_tpu_torch.system import System, TrackingState
from defslam_tpu_torch.template import mesh as meshmod
from defslam_tpu_torch.tracking import pose_opt, sft, tracker

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
INT8_TENSOR_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core rate (no 1-bit rate is published)
N_FRAMES = 12  # tracking slice; the mapping slice runs all 2 * N_FRAMES
HAMMING_SHAPES = [(2048, 1536), (200, 333), (256, 128), (1, 1),
                  (2049, 1537), (17, 9), (5, 4), (64, 1535), (4096, 1536)]
RELOC_SHAPE = (1536, 24 * 1536)  # relocalization: the frame against all 24 keyframe slots
RIGID_SHAPE = (4096, 1536)  # rigid tracking and fusion: every map point against a frame
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
    # a capture stream of the current card: ``torch.cuda.graph``'s default
    # one is made once, on the card current then, and a capture there
    # holds no launch made on another card
    with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
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
    ua, ub = hamming.unpack_bits(a), hamming.unpack_bits(b)
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


def hamming_at_shape(dev, shape, seed: int, what: str) -> dict:
    """B1 at one path's shape (N, 8) x (M, 8): exact against the plain
    version; ``device_ms`` (graph of 20 launches), ``host_us``, the plain
    and library times, and the bound (bytes: each input read once, the
    output written once; operations: the 256-bit product of every pair at
    the int8 tensor rate)."""
    rng = np.random.default_rng(seed)
    n, m = shape
    a, b = _words(rng, (n, 8), dev), _words(rng, (m, 8), dev)
    out = torch.empty((n, m), dtype=torch.int32, device=dev)
    device_ms = cuda_graph_ms(lambda: hamming.hamming_matrix(a, b, out=out))
    ref = hamming.hamming_matrix_plain(a, b)
    if not torch.equal(out, ref):
        raise SystemExit(f"hamming_matrix differs from its plain version at the {what} shape")
    err = int((out - ref).abs().max())
    del ref
    plain_ms = cuda_ms(lambda: hamming.hamming_matrix_plain(a, b), reps=3, warmup=1)
    ua, ub = hamming.unpack_bits(a), hamming.unpack_bits(b)
    library_ms = cuda_ms(lambda: torch.cdist(ua, ub, p=0), reps=5, warmup=1)
    t_bytes = 4 * (8 * n + 8 * m + n * m) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * 256 * n * m / INT8_TENSOR_OPS_PER_S * 1e3
    row = {"shape": [n, m], "max_abs_err": err, "device_ms": device_ms,
           "kernel_ms": cuda_ms(lambda: hamming.hamming_matrix(a, b), reps=10),
           "host_us": host_us(lambda: hamming.hamming_matrix(a, b, out=out)),
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print(f"hamming_matrix at the {what} shape", json.dumps(row), flush=True)
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
        d = torch.cdist(hamming.unpack_bits(da[k]), hamming.unpack_bits(db[k]), p=0)
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

    def __init__(self, shapes: B1Shapes | None = None):
        self.calls: list[dict] = []
        self.shapes = shapes  # with one, each call also lists its B1 shapes

    def __enter__(self):
        self._real = pose_opt.relocalize

        def probe(feats, kfs, points, K, cfg):
            cuda = feats.xy.is_cuda
            before = cuda_build.LAUNCHES["hamming_matrix"]
            n0 = len(self.shapes.shapes) if self.shapes else 0
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
                ms=a.elapsed_time(b) if cuda else (time.perf_counter() - t0) * 1e3,
                **({"b1_shapes": self.shapes.shapes[n0:]} if self.shapes else {})))
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


def pipelined_slice(seq, dev) -> dict:
    """Phase 10 (see the module's docstring), on the 24-frame bench render."""
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


APPS_BASELINE = 0.05
APPS_VIDEO_FRAMES = 12  # the mono and ct apps' runs
APPS_CALIBRATED_START = 16  # the calibrated stereo run: frames 16-23


class AppProbe:
    """While active, records the app's readers (``prefetch.FramePipeline``,
    which ``cli`` builds through the module) and the start and end of each
    ``System.track_monocular_gt`` call on the host clock."""

    def __enter__(self):
        from defslam_tpu_torch.io import prefetch

        self.pipes, self.calls = [], []
        self._prefetch, self._pipe, self._gt = prefetch, prefetch.FramePipeline, System.track_monocular_gt
        probe = self

        class Pipe(self._pipe):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                probe.pipes.append(self)

        def track_gt(sys_, *args, **kwargs):
            t0 = time.perf_counter()
            out = probe._gt(sys_, *args, **kwargs)
            probe.calls.append((t0, time.perf_counter()))
            return out

        prefetch.FramePipeline = Pipe
        System.track_monocular_gt = track_gt
        return self

    def __exit__(self, *exc):
        self._prefetch.FramePipeline = self._pipe
        System.track_monocular_gt = self._gt

    def frame_ms(self) -> list[float]:
        """Per tracked frame (the first initializes): the app loop's wall
        time from one call's start to the next (the readers' wait, the
        call, the progress line); the last frame's is its call."""
        starts = [a for a, _ in self.calls] + [self.calls[-1][1]]
        return [(b - a) * 1e3 for a, b in zip(starts[1:-1], starts[2:])]

    def reader_stats(self) -> dict:
        """Decode and remap ms per image (p50, max; decode also per side),
        the seconds the loop waited for each frame's pair (p50, max), and
        each frame's (left, right) decode and remap ms and wait."""
        st = [x for p in self.pipes for x in p.stats]
        left, right = self.pipes
        wait = [a + b for a, b in zip(left.wait_s, right.wait_s)]

        def p50_max(v):
            return {"p50": statistics.median(v), "max": max(v)} if v else None

        by_index = [{x["index"]: x for x in p.stats} for p in self.pipes]
        per_frame = [{"frame": i, "wait_s": w,
                      **{k: [side[i][k] for side in by_index] for k in ("decode_ms", "remap_ms")}}
                     for i, w in enumerate(wait)]
        return {"decode_ms": p50_max([x["decode_ms"] for x in st]),
                "decode_ms_left_right": [p50_max([x["decode_ms"] for x in p.stats])
                                         for p in self.pipes],
                "remap_ms": p50_max([x["remap_ms"] for x in st]),
                "prefetch_wait_s": p50_max(wait), "images": len(st), "per_frame": per_frame}


def _calibration_yaml(settings: str, cam, path: str) -> str:
    """The dataset's settings plus a LEFT./RIGHT. stereo calibration (the
    reference's opencv-matrix keys): the camera's K, a mild lens distortion
    and a 0.1 degree rectifying rotation per side."""
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]])
    text = open(settings).read()
    for side, ang, D in (("LEFT", 0.1, [0.01, -0.005, 0.0005, -0.0005, 0.0]),
                         ("RIGHT", -0.1, [-0.008, 0.004, -0.0004, 0.0004])):
        c, s_ = math.cos(math.radians(ang)), math.sin(math.radians(ang))
        mats = {"K": K, "D": np.array([D]), "R": np.array([[c, 0, s_], [0, 1, 0], [-s_, 0, c]]),
                "P": np.hstack([K, np.zeros((3, 1))])}
        for name, m in mats.items():
            data = ", ".join(repr(float(v)) for v in m.ravel())
            text += (f"{side}.{name}: !!opencv-matrix\n   rows: {m.shape[0]}\n"
                     f"   cols: {m.shape[1]}\n   dt: d\n   data: [ {data} ]\n")
    with open(path, "w") as f:
        f.write(text)
    return path


def _app_rows(outdir: str) -> list[list[str]]:
    return _tokens(os.path.join(outdir, "Matches.txt"))


def _check_same_files(what: str, other: str, gap: dict, repeat: dict | None) -> None:
    """Each result file equal bit for bit, or, where two in-memory runs on
    the card differ (``repeat``), within their gap."""
    for name in RESULT_FILES:
        g = gap[name]
        ok = g["equal"] or (repeat is not None and not repeat[name]["equal"]
                            and g["rows"][0] == g["rows"][1] and g["gap"] <= repeat[name]["gap"]
                            and g["words"] <= repeat[name]["words"])
        if not ok:
            raise SystemExit(f"apps: {what}'s {name} differs from {other}'s "
                             f"({g}; two in-memory runs: {repeat and repeat[name]})")


def png_row_filters(path: str) -> dict:
    """How many rows of the (grey) PNG at ``path`` use each filter type."""
    from defslam_tpu_torch.io import png

    with open(path, "rb") as fh:
        chunks = list(png._chunks(fh.read()))
    w, h = struct.unpack(">II", dict(chunks)[b"IHDR"][:8])
    raw = zlib.decompress(b"".join(p for k, p in chunks if k == b"IDAT"))
    kinds, counts = np.unique(np.frombuffer(raw, np.uint8).reshape(h, w + 1)[:, 0],
                              return_counts=True)
    return {int(k): int(c) for k, c in zip(kinds, counts)}


def decode_alone(path: str, workdir: str, has_cv2: bool, reps: int = 5) -> dict:
    """Median ms of ``png.read_png`` on this thread for the frame at
    ``path`` re-encoded in each way, and of the unfiltering step alone for
    a Sub-filtered copy through ``png._unfilter`` and through
    ``png._unfilter_diagonal``."""
    from defslam_tpu_torch.io import png

    os.makedirs(workdir, exist_ok=True)
    img = png.read_png(path)
    h, w = img.shape
    files = {"filter_none": path}
    for name, ftype in (("filter_sub", 1), ("filter_paeth", 4)):
        files[name] = os.path.join(workdir, f"{name}.png")
        png.write_png(files[name], img, filter_type=ftype)
    if has_cv2:
        import cv2

        files["cv2_imwrite"] = os.path.join(workdir, "cv2_imwrite.png")
        cv2.imwrite(files["cv2_imwrite"], img)

    def median_ms(fn) -> float:
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
            if not np.array_equal(out.reshape(h, w), img):
                raise SystemExit("apps: a timed PNG decode disagrees with the frame")
        return statistics.median(times)

    out = {name: median_ms(lambda p=p: png.read_png(p)) for name, p in files.items()}
    raw = np.empty((h, w + 1), np.uint8)
    raw[:, 0] = 1
    raw[:, 1:] = png._filter_rows(img, 1)
    out["unfilter_sub_whole_image"] = median_ms(lambda: png._unfilter(raw.ravel(), h, w, 1))
    out["unfilter_sub_diagonal"] = median_ms(
        lambda: png._unfilter_diagonal(raw[:, 1:, None], raw[:, 0]))
    shutil.rmtree(workdir)
    return out


def apps_phase(seq, dev) -> dict:
    """Phase 11 (see the module's docstring), on ``seq``: the 24-frame
    bench render with its right view."""
    from defslam_tpu_torch.io import datasets, png
    from defslam_tpu_torch.tools import make_synth_dataset

    root = os.path.join("chiprun_out", "apps")
    shutil.rmtree(root, ignore_errors=True)
    data = os.path.join(root, "seq")
    t0 = time.perf_counter()
    settings = make_synth_dataset.write_dataset(data, seq, APPS_BASELINE)
    write_s = time.perf_counter() - t0
    # the default Config's ORB settings; the results under <root>/app
    text = open(settings).read()
    text = text.replace("ORBextractor.nFeatures: 600", "ORBextractor.nFeatures: 1200")
    text = text.replace("ORBextractor.nLevels: 4", "ORBextractor.nLevels: 8")
    text = text.replace(f"File.outputdir: {os.path.join(data, 'out')}",
                        f"File.outputdir: {os.path.join(root, 'app')}")
    with open(settings, "w") as f:
        f.write(text)
    cfg = Config.from_yaml(settings)
    assert (cfg.orb.n_features, cfg.orb.scale_factor, cfg.orb.n_levels) == (1200, 1.2, 8)
    args = ["stereo", settings, data, "--start", "0", "--baseline", str(APPS_BASELINE)]

    # ---- the stereo app, counted
    torch.cuda.synchronize()
    cuda_build.LAUNCHES.clear()
    with AppProbe() as app:
        rc = cli.main(args)
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    print(flush=True)
    out_app = os.path.join(root, "app")
    rows = _app_rows(out_app) if rc == 0 else []
    n = len(seq.frames)
    missing = [f for f in RESULT_FILES if not os.path.exists(os.path.join(out_app, f))]
    n_kf = sum(r[3] == "1" for r in rows[1:])
    n_swaps = sum(r[4] == "1" for r in rows[1:])
    print("apps stereo rc", rc, "states", [r[-1] for r in rows], "keyframes", n_kf,
          "swaps", n_swaps, "launches", launches, flush=True)
    if rc != 0 or missing:
        raise SystemExit(f"apps: the stereo app returned {rc}, result files missing: {missing}")
    if len(rows) != n or any(r[-1] != TrackingState.OK.name for r in rows):
        raise SystemExit(f"apps: not every frame of the stereo app tracked: {rows}")
    if n_swaps < 1:
        raise SystemExit("apps: no keyframe of the stereo app swapped the template")
    if launches.get("hamming_matrix", 0) < n - 1 + n_swaps:
        raise SystemExit(f"apps: hamming_matrix launched {launches.get('hamming_matrix', 0)} "
                         f"times for {n - 1} tracked frames and {n_swaps} re-anchors")
    if launches.get("windowed_match", 0) != 2 * n_kf:
        raise SystemExit(f"apps: windowed_match launched {launches.get('windowed_match', 0)} "
                         f"times in {n_kf} keyframe steps (2 each expected)")
    reader = app.reader_stats()
    app_frame_ms = app.frame_ms()
    # ---- the same decoded frames from memory, through the System
    lp, rp, ts = datasets.stereo_pair_paths(data)
    pairs = [(png.read_png(a).astype(np.float32), png.read_png(b).astype(np.float32), t)
             for a, b, t in zip(lp, rp, ts)]

    def in_memory(outdir: str) -> list[float]:
        s = System(dataclasses.replace(cfg, output_dir=outdir), device=dev)
        call_ms = []
        for left, right, t in pairs:
            t0 = time.perf_counter()
            s.track_monocular_gt(left, right, t, baseline=APPS_BASELINE)
            call_ms.append((time.perf_counter() - t0) * 1e3)
        s.write_metrics()
        return call_ms[1:]

    mem_ms = in_memory(os.path.join(root, "memory"))
    gap = files_gap(out_app, os.path.join(root, "memory"))
    repeat = None

    def in_memory_repeat() -> dict:
        """The gap between two in-memory runs on the card (run once, when a
        comparison first finds a difference)."""
        nonlocal repeat
        if repeat is None:
            in_memory(os.path.join(root, "memory_repeat"))
            repeat = files_gap(os.path.join(root, "memory"), os.path.join(root, "memory_repeat"))
        return repeat

    if not all(v["equal"] for v in gap.values()):
        in_memory_repeat()
    print("apps stereo vs in-memory", json.dumps(gap), "repeat", json.dumps(repeat), flush=True)
    _check_same_files("the stereo app", "the in-memory run", gap, repeat)

    # ---- the stereo app on the same frames re-encoded with row filters that
    # cost the reader more: left images as cv2.imwrite writes them (where
    # OpenCV is installed, else Paeth), right images Paeth on every row
    import importlib.util

    has_cv2 = importlib.util.find_spec("cv2") is not None
    filtered, t0 = os.path.join(root, "seq_filtered"), time.perf_counter()
    shutil.copytree(data, filtered)
    for side, paths in enumerate((lp, rp)):
        for path in paths:
            dst = os.path.join(filtered, os.path.basename(path))
            img = png.read_png(path)
            if side == 0 and has_cv2:
                import cv2

                cv2.imwrite(dst, img)
            else:
                png.write_png(dst, img, filter_type=4)
            if not np.array_equal(png.read_png(dst), img):
                raise SystemExit(f"apps: {dst} does not decode to the frame it was written from")
    filtered_write_s = time.perf_counter() - t0
    left_filters = png_row_filters(os.path.join(filtered, os.path.basename(lp[0])))
    with open(settings) as f:
        text = f.read().replace(f"File.outputdir: {os.path.join(root, 'app')}",
                                f"File.outputdir: {os.path.join(root, 'filtered')}")
    filtered_yaml = os.path.join(root, "filtered.yaml")
    with open(filtered_yaml, "w") as f:
        f.write(text)
    with AppProbe() as app_f:
        rc_f = cli.main(["stereo", filtered_yaml, filtered, "--start", "0",
                         "--baseline", str(APPS_BASELINE)])
    print(flush=True)
    if rc_f != 0:
        raise SystemExit(f"apps: the stereo app on the re-encoded frames returned {rc_f}")
    gap_f = files_gap(out_app, os.path.join(root, "filtered"))
    if not all(v["equal"] for v in gap_f.values()):
        in_memory_repeat()
    print("apps re-encoded (left filters", left_filters, ") vs the first app run",
          json.dumps(gap_f), "repeat", json.dumps(repeat), flush=True)
    _check_same_files("the stereo app on re-encoded frames", "the first app run", gap_f, repeat)
    reader_f = app_f.reader_stats()
    filtered_frame_ms = app_f.frame_ms()
    shutil.rmtree(filtered)

    # one frame's decode alone on this thread, as written (filter None), as
    # cv2.imwrite writes it, and with Sub or Paeth on every row; and Sub's
    # unfiltering step alone through the whole-image path and the
    # anti-diagonal one
    decode_alone_ms = decode_alone(lp[0], os.path.join(root, "decode"), has_cv2)
    reader["decode_alone_ms"] = decode_alone_ms
    print("apps decode alone", json.dumps(decode_alone_ms), flush=True)

    # ---- the stereo app with a stereo calibration: the readers remap
    calib = _calibration_yaml(settings, cfg.camera, os.path.join(root, "calibrated.yaml"))
    with open(calib) as f:
        text = f.read().replace(f"File.outputdir: {os.path.join(root, 'app')}",
                                f"File.outputdir: {os.path.join(root, 'calibrated')}")
    with open(calib, "w") as f:
        f.write(text)
    with AppProbe() as app_c:
        rc_c = cli.main(["stereo", calib, data, "--start", str(APPS_CALIBRATED_START),
                         "--baseline", str(APPS_BASELINE)])
    print(flush=True)
    rows_c = _app_rows(os.path.join(root, "calibrated"))
    reader_c = app_c.reader_stats()
    print("apps calibrated rc", rc_c, "states", [r[-1] for r in rows_c], "reader",
          json.dumps(reader_c), flush=True)
    if (rc_c != 0 or len(rows_c) != n - APPS_CALIBRATED_START
            or any(r[-1] != TrackingState.OK.name for r in rows_c)):
        raise SystemExit(f"apps: the calibrated stereo run did not track every frame: {rows_c}")
    if not reader_c["remap_ms"] or reader_c["remap_ms"]["p50"] <= 0.0:
        raise SystemExit("apps: the calibrated run's readers did not remap")

    # ---- mono and ct: a real video where OpenCV is installed, else the
    # rendered frames through load_video's place
    frames = [np.clip(f, 0, 255).astype(np.uint8) for f in seq.frames[:APPS_VIDEO_FRAMES]]
    video = os.path.join(root, "seq.avi")
    depth_dir = os.path.join(root, "depth")
    os.makedirs(depth_dir)
    for t in range(APPS_VIDEO_FRAMES):
        np.savetxt(os.path.join(depth_dir, f"heartDepthMap_{t}.txt"), seq.depths[t], fmt="%.5f")
    real_load_video = datasets.load_video
    decoded = None
    if has_cv2:
        import cv2

        h, w = frames[0].shape
        vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 7.0, (w, h), isColor=False)
        for f in frames:
            vw.write(f)
        vw.release()
        decoded = len(list(datasets.load_video(video)))
    else:
        def rendered(_src):
            for t, f in enumerate(frames):
                yield f.astype(np.float32), t / 7.0

        datasets.load_video = rendered
    video_rows = {}
    for mode, extra in (("mono", [video]), ("ct", [video, depth_dir])):
        with open(settings) as f:
            text = f.read().replace(f"File.outputdir: {os.path.join(root, 'app')}",
                                    f"File.outputdir: {os.path.join(root, mode)}")
        mode_yaml = os.path.join(root, f"{mode}.yaml")
        with open(mode_yaml, "w") as f:
            f.write(text)
        cuda_build.LAUNCHES.clear()
        rc_v = cli.main([mode, mode_yaml] + extra)
        torch.cuda.synchronize()
        print(flush=True)
        video_rows[mode] = _app_rows(os.path.join(root, mode))
        b1 = cuda_build.LAUNCHES["hamming_matrix"]
        print(f"apps {mode} rc", rc_v, "states", [r[-1] for r in video_rows[mode]],
              "launches", dict(cuda_build.LAUNCHES), flush=True)
        if (rc_v != 0 or len(video_rows[mode]) != APPS_VIDEO_FRAMES
                or any(r[-1] != TrackingState.OK.name for r in video_rows[mode])
                or b1 < APPS_VIDEO_FRAMES - 1):
            raise SystemExit(f"apps: the {mode} app did not track every frame through B1")
    datasets.load_video = real_load_video
    if has_cv2 and decoded != APPS_VIDEO_FRAMES:
        raise SystemExit(f"apps: the video decoded to {decoded} frames, not {APPS_VIDEO_FRAMES}")
    ct_gt = os.path.join(root, "ct", "ErrorGTs0.txt")
    if not os.path.exists(ct_gt) or len(_tokens(ct_gt)) != APPS_VIDEO_FRAMES:
        raise SystemExit("apps: the ct app wrote no ground-truth row per frame")
    # the inputs are large: keep the results only
    for d in (data, depth_dir):
        shutil.rmtree(d)
    if os.path.exists(video):
        os.remove(video)
    out = {"launches": launches, "rows": rows, "swaps": n_swaps, "keyframes": n_kf,
           "files_vs_in_memory": gap, "in_memory_repeat": repeat,
           "reader": reader, "reader_calibrated": reader_c,
           "reencoded": {"left_row_filters": left_filters,
                         "left_writer": "cv2.imwrite" if has_cv2 else "png paeth",
                         "right_writer": "png paeth", "write_s": filtered_write_s,
                         "files_vs_first_app": gap_f, "reader": reader_f,
                         "app_frame_p50_ms": statistics.median(filtered_frame_ms),
                         "app_frame_max_ms": max(filtered_frame_ms)},
           "app_frame_p50_ms": statistics.median(app_frame_ms),
           "app_frame_max_ms": max(app_frame_ms),
           "in_memory_frame_p50_ms": statistics.median(mem_ms),
           "in_memory_frame_max_ms": max(mem_ms),
           "dataset_write_s": write_s, "cv2": has_cv2,
           "video_decode_verified_on_gpu": bool(has_cv2 and decoded == APPS_VIDEO_FRAMES),
           "mono_states": [r[-1] for r in video_rows["mono"]],
           "ct_states": [r[-1] for r in video_rows["ct"]]}
    print("apps", json.dumps({k: v for k, v in out.items() if k not in ("rows",)}), flush=True)
    print(json.dumps({"video_decode_verified_on_gpu": out["video_decode_verified_on_gpu"]}),
          flush=True)
    return out


# ---------------------------------------------------------------- rigid mode

RIGID_MOTION = dict(height=480, width=640, max_amp=0.0, camera_motion=0.5, seed=3)
RIGID_FRAMES = 24
RIGID_VIDEO_FRAMES = 12  # the mono --orbslam app's run
RIGID_PROBE = 1e-7
# the CPU run's and the probe's depth: half the run, to keep the phase's time
RIGID_PROBE_FRAMES = 12


class CudaSpans:
    """CUDA events around every call of some functions or methods (wrapped
    in place until :meth:`restore`): milliseconds per call by label."""

    def __init__(self):
        self.calls: dict[str, list] = {}
        self._undo = []

    def wrap(self, owner, name: str, label: str) -> None:
        orig = getattr(owner, name)

        def timed(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(*a, **k)
            end.record()
            self.calls.setdefault(label, []).append((start, end))
            return out

        setattr(owner, name, timed)
        self._undo.append((owner, name, orig))

    def restore(self) -> None:
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo = []

    def ms(self) -> dict[str, list[float]]:
        torch.cuda.synchronize()
        return {k: [a.elapsed_time(b) for a, b in v] for k, v in self.calls.items()}


class B1Shapes:
    """Record the shape of every Hamming matrix the rigid path asks for
    (wrapping the wrapper's name in the modules that call it)."""

    def __init__(self):
        self.shapes: list[tuple[int, int]] = []
        self._undo = []
        for mod in (matching, rigid_loop, pose_opt):
            orig = mod.hamming_matrix

            def rec(a, b, out=None, _orig=orig):
                self.shapes.append((a.shape[0], b.shape[0]))
                return _orig(a, b, out=out)

            mod.hamming_matrix = rec
            self._undo.append((mod, orig))

    def restore(self) -> None:
        for mod, orig in self._undo:
            mod.hamming_matrix = orig


def rigid_run(frames, cfg: Config, device, perturb: float = 0.0, shapes: B1Shapes | None = None):
    """Track the frames with RigidSystem.  ``perturb`` scales the map
    points by (1 + N(0, perturb)) right after the initialization (a probe
    of the run's own sensitivity).  Returns (system, rows, frame_ms, the
    B1 shapes of each frame)."""
    s = RigidSystem(cfg, device=device)
    rows, frame_ms, frame_shapes = [], [], []
    for t, f in enumerate(frames):
        n0 = len(shapes.shapes) if shapes else 0
        t0 = time.perf_counter()
        pose = s.track_monocular(f, float(t))
        if s.device.type == "cuda":
            torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        frame_shapes.append(shapes.shapes[n0:] if shapes else [])
        if perturb and pose is not None and not any(r["pose"] is not None for r in rows):
            noise = torch.as_tensor(np.random.default_rng(1).normal(0.0, perturb, s.points.xyz.shape),
                                    dtype=torch.float32, device=s.device)
            s.points = s.points._replace(xyz=s.points.xyz * (1.0 + noise))
        rows.append({"state": s.state.name, "pose": pose, "points": int(s.points.valid.sum()),
                     "keyframes": int(s.kfs.valid.sum()), "loops": s.loops_closed})
    return s, rows, frame_ms, frame_shapes


def rigid_loop_world(cfg: Config, device, n_pts: int = 1536, drift_step: float = 0.04, seed: int = 5):
    """tests/test_rigid_system.py's pre-loop state at full capacity:
    keyframes sweeping right and back near the start, the stored poses
    drifted (pose 0 exact), keyframe 0 observing the true points and the
    last keyframe DUPLICATE points triangulated from its drifted pose with
    keyframe 0's descriptors; the keyframes between are pose nodes with
    junk descriptors.  ``n_pts`` points each (keyframe slots x keypoints x
    points: the Config's capacities).  Returns (kfs, points, T_true, X)."""
    rng = np.random.default_rng(seed)
    n_kf = cfg.capacity.max_keyframes
    k_cap, p_cap = cfg.orb.max_keypoints, cfg.capacity.max_map_points
    K = cfg.camera.K.astype(np.float64)
    X = np.stack([rng.uniform(-0.8, 0.8, n_pts), rng.uniform(-0.6, 0.6, n_pts),
                  rng.uniform(2.5, 3.5, n_pts)], axis=1).astype(np.float32)
    desc = rng.integers(-2**31, 2**31, (n_pts, 8), dtype=np.int64).astype(np.int32)
    xs = np.concatenate([np.linspace(0, 1.0, n_kf // 2), np.linspace(1.0, 0.05, n_kf - n_kf // 2)])
    T_true = np.tile(np.eye(4, dtype=np.float32), (n_kf, 1, 1))
    T_true[:, 0, 3] = -xs
    T_drift = T_true.copy()
    acc = np.zeros(3, np.float32)
    for k in range(1, n_kf):
        acc = acc + rng.normal(0, drift_step, 3).astype(np.float32)
        T_drift[k, :3, 3] += acc

    def project(Xc):
        return np.stack([K[0, 0] * Xc[:, 0] / Xc[:, 2] + K[0, 2],
                         K[1, 1] * Xc[:, 1] / Xc[:, 2] + K[1, 2]], -1).astype(np.float32)

    xy = np.zeros((n_kf, k_cap, 2), np.float32)
    dsc = np.zeros((n_kf, k_cap, 8), np.int32)
    kpv = np.zeros((n_kf, k_cap), bool)
    pid = np.full((n_kf, k_cap), -1, np.int64)
    xy[0, :n_pts] = project(X @ T_true[0, :3, :3].T + T_true[0, :3, 3])
    dsc[0, :n_pts] = desc
    kpv[0, :n_pts] = True
    pid[0, :n_pts] = np.arange(n_pts)
    for k in range(1, n_kf - 1):
        dsc[k, :n_pts] = rng.integers(-2**31, 2**31, (n_pts, 8), dtype=np.int64).astype(np.int32)
        kpv[k, :n_pts] = True
    x_cam = X @ T_true[-1, :3, :3].T + T_true[-1, :3, 3]
    Rd, td = T_drift[-1, :3, :3], T_drift[-1, :3, 3]
    X_dup = ((x_cam - td) @ Rd).astype(np.float32)  # T_drift^-1 applied to the true view
    xy[-1, :n_pts] = project(x_cam)
    dsc[-1, :n_pts] = desc
    kpv[-1, :n_pts] = True
    pid[-1, :n_pts] = n_pts + np.arange(n_pts)
    xyz = np.zeros((p_cap, 3), np.float32)
    xyz[:n_pts], xyz[n_pts:2 * n_pts] = X, X_dup
    pdesc = np.zeros((p_cap, 8), np.int32)
    pdesc[:n_pts] = pdesc[n_pts:2 * n_pts] = desc
    pvalid = np.zeros(p_cap, bool)
    pvalid[:2 * n_pts] = True
    ref_kf = np.full(p_cap, -1, np.int64)
    ref_kf[:n_pts], ref_kf[n_pts:2 * n_pts] = 0, n_kf - 1
    put = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    kfs = store.empty_keyframes(cfg, device)._replace(
        pose=put(T_drift), xy=put(xy), desc=put(dsc), kp_valid=put(kpv), point_id=put(pid),
        frame_id=put(np.arange(n_kf, dtype=np.int64) * 10), valid=put(np.ones(n_kf, bool)))
    points = store.empty_points(cfg, device)._replace(
        xyz=put(xyz), desc=put(pdesc), valid=put(pvalid), ref_kf=put(ref_kf),
        n_obs=put(pvalid.astype(np.int32)))
    return kfs, points, T_true, X


def mean_reproj(kfs, points, K: np.ndarray, slots) -> float:
    """Mean pixel reprojection error of the slots' bound observations."""
    errs = []
    pid_all, xyz = kfs.point_id.cpu().numpy(), points.xyz.cpu().numpy()
    for s in slots:
        pid = pid_all[s]
        sel = (pid >= 0) & kfs.kp_valid[s].cpu().numpy()
        T = kfs.pose[s].cpu().numpy()
        pc = xyz[pid[sel]] @ T[:3, :3].T + T[:3, 3]
        uv = np.stack([K[0, 0] * pc[:, 0] / pc[:, 2] + K[0, 2], K[1, 1] * pc[:, 1] / pc[:, 2] + K[1, 2]], -1)
        errs.append(np.linalg.norm(uv - kfs.xy[s].cpu().numpy()[sel], axis=1))
    return float(np.mean(np.concatenate(errs)))


def rigid_loop_phase(cfg: Config, dev) -> dict:
    """``close_loop`` and ``fuse_and_global_ba`` on the full-capacity
    pre-loop world, on the card and on the CPU: the same candidate, the
    reprojection error at least halved by the fusion and global BA, poses
    within 1e-3 of the CPU's (the tolerance tests/test_torch_rigid_system.py
    holds the port to the JAX package by)."""
    slot = cfg.capacity.max_keyframes - 1
    K = cfg.camera.K.astype(np.float64)
    out = {}
    for device in (dev, "cpu"):
        kfs, points, T_true, X = rigid_loop_world(cfg, device)
        Kt = torch.as_tensor(cfg.camera.K, device=device)
        sig2 = rigid_tri.level_sigma2(cfg.orb.n_levels, cfg.orb.scale_factor, device)
        spans = CudaSpans() if device == dev else None
        if spans:
            cuda_build.LAUNCHES.clear()
            spans.wrap(rigid_loop, "global_ba", "global_ba")
        t0 = time.perf_counter()
        closed, kfs_g, pts_g, cand = rigid_loop.close_loop(kfs, points, slot, Kt, cfg)
        if spans:
            torch.cuda.synchronize()
        close_s = time.perf_counter() - t0
        if not closed:
            raise SystemExit(f"rigid loop: close_loop did not close on {device}")
        err_graph = mean_reproj(kfs_g, pts_g, K, (0, slot))
        t0 = time.perf_counter()
        kfs_f, pts_f, n_fused = rigid_loop.fuse_and_global_ba(kfs_g, pts_g, slot, cand, Kt, sig2, cfg)
        if spans:
            torch.cuda.synchronize()
        fuse_s = time.perf_counter() - t0
        err_fused = mean_reproj(kfs_f, pts_f, K, (0, slot))
        row = {"cand": cand, "n_fused": n_fused, "points_after": int(pts_f.valid.sum()),
               "reproj_graph_px": err_graph, "reproj_fused_px": err_fused,
               "close_loop_wall_ms": close_s * 1e3, "fuse_and_global_ba_wall_ms": fuse_s * 1e3,
               "pose_drift_before": float(np.linalg.norm(kfs.pose[slot, :3, 3].cpu().numpy()
                                                         - T_true[slot, :3, 3])),
               "pose_drift_after": float(np.linalg.norm(kfs_f.pose[slot, :3, 3].cpu().numpy()
                                                        - T_true[slot, :3, 3]))}
        if spans:
            spans.restore()
            row["global_ba_ms"] = spans.ms()["global_ba"]
            row["launches"] = dict(cuda_build.LAUNCHES)
        if not err_fused < 0.5 * err_graph:
            raise SystemExit(f"rigid loop on {device}: reprojection {err_graph} -> {err_fused}")
        out["card" if device == dev else "cpu"] = row
        out["poses_" + ("card" if device == dev else "cpu")] = kfs_f.pose.cpu().numpy()
    g, c = out["card"], out["cpu"]
    gap = float(np.abs(out.pop("poses_card") - out.pop("poses_cpu")).max())
    out["pose_gap_card_vs_cpu"] = gap
    print("rigid loop", json.dumps(out), flush=True)
    if g["cand"] != c["cand"] or g["cand"] != 0:
        raise SystemExit(f"rigid loop: candidates {g['cand']} (card) and {c['cand']} (CPU)")
    if gap > 1e-3:
        raise SystemExit(f"rigid loop: the card's poses are {gap} from the CPU's")
    return out


def rigid_cli(root: str, seq) -> dict:
    """``cli.main(["mono", yaml, video, "--orbslam"])`` on the first 12
    frames of the rigid render, from an MJPG video that OpenCV writes where
    it is installed (else the frames through ``load_video``'s place)."""
    import importlib.util

    from defslam_tpu_torch.io import datasets

    frames = [np.clip(f, 0, 255).astype(np.uint8) for f in seq.frames[:RIGID_VIDEO_FRAMES]]
    os.makedirs(root, exist_ok=True)
    video = os.path.join(root, "rigid.avi")
    c = seq.camera
    yaml = os.path.join(root, "rigid.yaml")
    with open(yaml, "w") as f:
        f.write(f"Camera.fx: {c.fx}\nCamera.fy: {c.fy}\nCamera.cx: {c.cx}\nCamera.cy: {c.cy}\n"
                f"Camera.width: {c.width}\nCamera.height: {c.height}\n"
                f"File.outputdir: {os.path.join(root, 'out')}\n")
    real = datasets.load_video
    has_cv2 = importlib.util.find_spec("cv2") is not None
    if has_cv2:
        import cv2

        vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 7.0, (c.width, c.height),
                             isColor=False)
        for f in frames:
            vw.write(f)
        vw.release()
    else:
        datasets.load_video = lambda _src: ((f.astype(np.float32), t / 7.0) for t, f in enumerate(frames))
    cuda_build.LAUNCHES.clear()
    try:
        rc = cli.main(["mono", yaml, video, "--orbslam"])
    finally:
        datasets.load_video = real
    torch.cuda.synchronize()
    rows = _tokens(os.path.join(root, "out", "Trajectory.txt"))
    out = {"rc": rc, "trajectory_rows": len(rows), "video": has_cv2,
           "launches": dict(cuda_build.LAUNCHES)}
    print("\nrigid cli", json.dumps(out), flush=True)
    if rc != 0 or len(rows) < RIGID_VIDEO_FRAMES - 2 or any(len(r) != 17 for r in rows):
        raise SystemExit(f"rigid cli: mono --orbslam wrote {len(rows)} trajectory rows")
    if os.path.exists(video):
        os.remove(video)
    return out


def rigid_phase(dev) -> dict:
    """Phase 12: the rigid ORB-SLAM2 mode at full width (the default
    Config, a keyframe every 4 frames) on 24 frames of a static render
    (camera_motion 0.5: the JAX package's RigidSystem initializes at frame
    1 and tracks all 24 frames on the CPU), the card against the CPU and a
    1e-7-perturbed CPU probe; then the loop closer at full capacity, then
    ``mono --orbslam``."""
    seq = make_sequence(n_frames=RIGID_FRAMES, **RIGID_MOTION)
    cfg = Config(camera=seq.camera, tracking=TrackingConfig(keyframe_period=4))
    frames = seq.frames
    # warm the card's libraries (cuSOLVER, the LM's jvp) outside the counted
    # run: the initialization's BA and a tracked frame
    rigid_run(frames[:3], cfg, dev)
    shapes = B1Shapes()
    spans = CudaSpans()
    spans.wrap(RigidSystem, "_try_initialize", "initialize")
    spans.wrap(RigidSystem, "_local_ba", "local_ba")
    spans.wrap(rigid_loop, "close_loop", "close_loop")
    cuda_build.LAUNCHES.clear()
    try:
        gpu, rows, frame_ms, frame_shapes = rigid_run(frames, cfg, dev, shapes=shapes)
        torch.cuda.synchronize()
    finally:
        shapes.restore()
        spans.restore()
    launches = dict(cuda_build.LAUNCHES)
    span_ms = spans.ms()
    states = [r["state"] for r in rows]
    first = next((t for t, r in enumerate(rows) if r["pose"] is not None), None)
    init_points = rows[first]["points"] if first is not None else 0
    print("rigid states", states, "points", [r["points"] for r in rows],
          "keyframes", [r["keyframes"] for r in rows], "launches", launches, flush=True)
    if first is None or first > 7:
        raise SystemExit(f"rigid: not initialized within the first 8 frames: {states}")
    if any(s != "OK" for s in states[first:]):
        raise SystemExit(f"rigid: not every frame after the initialization tracked: {states}")
    if rows[-1]["keyframes"] < 3 or rows[-1]["points"] <= init_points:
        raise SystemExit(f"rigid: the map did not grow: {rows[-1]}")
    missing = [t for t in range(first + 1, len(frames)) if tuple(RIGID_SHAPE) not in frame_shapes[t]]
    if missing:
        raise SystemExit(f"rigid: no B1 launch at {RIGID_SHAPE} in frames {missing}")

    # ---- does the card repeat itself?  Then the CPU's run and the probe
    _, rep_rows, _, _ = rigid_run(frames, cfg, dev)
    repeat_gap = max((float(np.abs(a["pose"] - b["pose"]).max()) for a, b in zip(rows, rep_rows)
                      if a["pose"] is not None and b["pose"] is not None), default=0.0)
    repeats = (repeat_gap == 0.0 and [(r["state"], r["points"], r["keyframes"]) for r in rows]
               == [(r["state"], r["points"], r["keyframes"]) for r in rep_rows])
    print("rigid: the card repeats its run bit for bit:", repeats, "gap", repeat_gap, flush=True)
    _, cpu_rows, cpu_ms, _ = rigid_run(frames[:RIGID_PROBE_FRAMES], cfg, "cpu")
    _, probe_rows, _, _ = rigid_run(frames[:RIGID_PROBE_FRAMES], cfg, "cpu", perturb=RIGID_PROBE)
    gaps, probe_gaps = [], []
    for t, (g, c) in enumerate(zip(rows, cpu_rows)):
        p = probe_rows[t] if t < len(probe_rows) else {"pose": None}
        if g["state"] != c["state"] or (g["pose"] is None) != (c["pose"] is None):
            raise SystemExit(f"rigid: card and CPU states differ: {states} / "
                             f"{[r['state'] for r in cpu_rows]}")
        for k in ("points", "keyframes"):
            if abs(g[k] - c[k]) > 0.02 * c[k]:
                raise SystemExit(f"rigid: {k} {g[k]} on the card, {c[k]} on the CPU")
        if g["pose"] is not None:
            gaps.append(float(np.abs(g["pose"] - c["pose"]).max()))
            if p["pose"] is not None:
                probe_gaps.append(float(np.abs(p["pose"] - c["pose"]).max()))
    tol = max(1e-3, 3 * max(probe_gaps))
    print("rigid card vs cpu: pose gaps", gaps, "probe gaps", probe_gaps, "tol", tol, flush=True)
    if max(gaps) > tol:
        raise SystemExit(f"rigid: the card's trajectory is {max(gaps)} from the CPU's (tol {tol})")
    tracked = frame_ms[first + 1:]
    out = {
        "init_frame": first, "states": states, "points": [r["points"] for r in rows],
        "keyframes": [r["keyframes"] for r in rows], "loops_closed": gpu.loops_closed,
        "launches": launches, "b1_shapes_per_frame": [sorted(set(s)) for s in frame_shapes],
        "frame_ms": frame_ms, "frame_p50_ms": statistics.median(tracked),
        "frame_max_ms": max(tracked), "init_ms": span_ms["initialize"][-1],
        "local_ba_ms": span_ms["local_ba"], "close_loop_ms": span_ms.get("close_loop", []),
        "cpu_frame_ms": cpu_ms, "pose_gap_card_vs_cpu": gaps, "probe_gap": probe_gaps,
        "pose_tolerance": tol, "card_repeats_bit_for_bit": repeats, "card_repeat_gap": repeat_gap,
        "cpu_points": [r["points"] for r in cpu_rows], "cpu_keyframes": [r["keyframes"] for r in cpu_rows],
    }
    out["loop"] = rigid_loop_phase(cfg, dev)
    out["cli"] = rigid_cli(os.path.join("chiprun_out", "rigid_cli"), seq)
    print("rigid", json.dumps({k: v for k, v in out.items() if k not in ("b1_shapes_per_frame",)}),
          flush=True)
    return out


PAR_TIMEOUT_S = 180  # every collective of the parallel phase, and its worker processes
PAR_CPU_FRAMES = 12  # the parallel run on the CPU: frames 0-11, keyframe 10
PAR_PROBE = 1e-7
SCHUR_MESH = (16, 16)  # the Schur partition engages at world 2 (8 u-rows a rank)
SCHUR_OBS = 512


class ShardProbe:
    """Keeps the inputs of the sharded solvers as a parallel run calls them
    (wrapped in place until :meth:`restore`): the first keyframe's warp
    batch and normal problem, and the last frame solve's ``SfTData``."""

    def __init__(self):
        self.sft = self.warps = self.normals = None
        self._orig = {n: getattr(sharded, n) for n in
                      ("sft_solve_sharded", "sharded_warp_fits", "sharded_normal_solves")}

        def sft_solve(group, data, cfg, num_iters=None, reg_temp=None):
            if reg_temp is None:  # a frame's solve, not a re-anchor
                self.sft = data
            return self._orig["sft_solve_sharded"](group, data, cfg, num_iters, reg_temp)

        def warps(group, batch, dom, bending, cfg):
            self.warps = self.warps or (batch, dom, bending)
            return self._orig["sharded_warp_fits"](group, batch, dom, bending, cfg)

        def normals(group, obs, k_init, num_iters=30):
            self.normals = self.normals or (obs, k_init, num_iters)
            return self._orig["sharded_normal_solves"](group, obs, k_init, num_iters)

        sharded.sft_solve_sharded = sft_solve
        sharded.sharded_warp_fits = warps
        sharded.sharded_normal_solves = normals

    def restore(self) -> None:
        for n, f in self._orig.items():
            setattr(sharded, n, f)


def parallel_run(frames, cfg: Config, device, check_waits: bool = False, perturb: float = 0.0,
                 keep_group: bool = False, system: System | None = None):
    """``System`` with ``parallel.enabled`` (world 1, or a rank of the
    launch this process belongs to; the group brought up first with the
    phase's collective timeout; or ``system``, a System already built) on
    the frames, keyframes on.  Per frame:
    host ms (synchronized on the card), all-reduce calls and bytes; per
    keyframe frame the CUDA-event ms from the chain's start to the frame's
    end (chain and re-anchor) and of the chain alone.  With
    ``check_waits`` every frame but the first two runs under
    ``profiling.host_waits``: "error" for a frame without a keyframe, else
    "warn" with its waits counted.  ``perturb`` scales the template nodes
    by (1 + N(0, perturb)) after frame 0 (the probe); ``keep_group``
    leaves the process group up.  Returns (system, per-frame rows)."""
    device = torch.device(device)
    if system is None:
        parallel.init_distributed(cfg, device, timeout=PAR_TIMEOUT_S)
        s = System(cfg, device=device)
    else:
        s = system
    cuda = device.type == "cuda"
    starts = []
    chain = CudaSpans() if cuda else None
    if cuda:
        orig = s._insert_keyframe

        def insert(*a, **k):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            starts.append(ev)
            return orig(*a, **k)

        s._insert_keyframe = insert
        chain.wrap(s, "_insert_keyframe_legacy", "chain")
    rows = []
    try:
        for t, frame in enumerate(frames):
            kf = t > 0 and s.frames_since_kf + 1 >= cfg.tracking.keyframe_period
            calls, nbytes = s.group.n_all_reduce, s.group.all_reduce_bytes
            mode = "warn" if kf or t < 2 else "error"
            t0 = time.perf_counter()
            if check_waits and cuda:
                with profiling.host_waits(mode) as w:
                    s.track_monocular(frame, timestamp=float(t))
            else:
                w = {}
                s.track_monocular(frame, timestamp=float(t))
            if t == 0 and perturb:
                noise = np.random.default_rng(1).normal(0.0, perturb, (cfg.mesh.n_nodes, 3))
                s.template = s.template._replace(nodes=s.template.nodes * (1.0 + torch.as_tensor(
                    noise, dtype=torch.float32, device=s.device)))
            end = None
            if cuda:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                torch.cuda.synchronize()
            rows.append(dict(frame=t, keyframe=kf, ms=(time.perf_counter() - t0) * 1e3,
                             all_reduce_calls=s.group.n_all_reduce - calls,
                             all_reduce_bytes=s.group.all_reduce_bytes - nbytes,
                             wait_mode=mode if check_waits and cuda else None,
                             waits=sum(w.values()), where=dict(w),
                             kf_end=end if kf else None))
        s.flush()
    finally:
        if not keep_group:
            s.shutdown()
        if chain:
            chain.restore()
    if cuda:
        spans = chain.ms().get("chain", [])
        kf_rows = [r for r in rows if r["keyframe"]]
        for r, a, ms in zip(kf_rows, starts, spans):
            r["keyframe_ms"] = a.elapsed_time(r["kf_end"])
            r["chain_ms"] = ms
    for r in rows:
        r.pop("kf_end")
    return s, rows


def pose_gap(a: System, b: System, t: int) -> float:
    return float(np.abs(np.asarray(a.trajectory[t][1]) - np.asarray(b.trajectory[t][1])).max())


def same_run(a: System, b: System) -> bool:
    """Equal metrics rows and trajectories, bit for bit."""
    return a._metrics == b._metrics and len(a.trajectory) == len(b.trajectory) and all(
        np.array_equal(np.asarray(x[1]), np.asarray(y[1])) and x[0] == y[0]
        for x, y in zip(a.trajectory, b.trajectory))


def schur_problem(dev) -> sft.SfTData:
    """tests/test_parallel.py's large-template problem: a 16x16 plane
    template, 512 embedded points seen from the identity with 0.8 px noise
    (seed 7)."""
    nu, nv = SCHUR_MESH
    topo = meshmod.grid_topology(nu, nv)
    dom = torch.tensor([-0.4, 0.4, -0.3, 0.3], device=dev)
    K = torch.tensor([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]], device=dev)
    nodes = meshmod.grid_nodes_from_surface(
        lambda u, v: torch.stack([u, v, torch.ones_like(u)], dim=-1), dom, topo)
    rng = np.random.default_rng(7)
    n = SCHUR_OBS
    uvp = torch.as_tensor(np.stack([rng.uniform(-0.38, 0.38, n), rng.uniform(-0.28, 0.28, n)], 1),
                          dtype=torch.float32, device=dev)
    facet, bary, _ = meshmod.embed_uv(uvp, dom, topo)
    obs = cam.project(K, meshmod.facet_positions(nodes, topo, facet, bary)) + torch.as_tensor(
        rng.normal(0, 0.8, (n, 2)), dtype=torch.float32, device=dev)
    return sft.data_from_template(
        meshmod.make_template(nodes, topo), K, torch.eye(4, device=dev), obs_uv=obs,
        obs_face=facet, obs_bary=bary, obs_invsigma2=torch.ones(n, device=dev),
        obs_mask=torch.ones(n, dtype=torch.bool, device=dev), n_kp=float(n))


def shard_problems(group, inputs: dict, dev) -> dict:
    """The four sharded solvers on ``group`` at the main path's shapes (the
    saved frame solve, keyframe 10's warps and normals, the 16x16 Schur
    problem); numpy results and the SfT's host ms (a warm call first)."""
    cfg = Config()
    t = {k: torch.as_tensor(v, device=dev) for k, v in inputs.items()}
    data = sft.SfTData(**{f: t["sft_" + f] for f in sft.SfTData._fields})
    out = {}
    sync = torch.cuda.synchronize if torch.device(dev).type == "cuda" else (lambda: None)
    sharded.sft_solve_sharded(group, data, cfg)
    sync()
    calls, nbytes = group.n_all_reduce, group.all_reduce_bytes
    t0 = time.perf_counter()
    r = sharded.sft_solve_sharded(group, data, cfg)
    sync()
    out["sft_ms"] = np.asarray((time.perf_counter() - t0) * 1e3)
    out["sft_all_reduce_calls"] = np.asarray(group.n_all_reduce - calls)
    out["sft_all_reduce_bytes"] = np.asarray(group.all_reduce_bytes - nbytes)
    out.update({f"sft_{k}": v.cpu().numpy() for k, v in r._asdict().items()})
    batch = mapper.WarpBatch(*(t["warp_" + f] for f in mapper.WarpBatch._fields))
    dps, ctrl = sharded.sharded_warp_fits(group, batch, t["warp_dom"], t["warp_bend"], cfg)
    out.update({f"warps_{k}": v.cpu().numpy() for k, v in dps._asdict().items()})
    out["warps_ctrl"] = ctrl.cpu().numpy()
    obs = nrm.PairObs(*(t["obs_" + f] for f in nrm.PairObs._fields))
    r = sharded.sharded_normal_solves(group, obs, t["obs_k0"], cfg.mapping.normal_lm_iterations)
    out.update({f"normals_{k}": v.cpu().numpy() for k, v in r._asdict().items()})
    scfg = Config(sft=SfTConfig(lm_iterations=12),
                  mesh=MeshConfig(nodes_u=SCHUR_MESH[0], nodes_v=SCHUR_MESH[1]))
    r = sharded.sft_solve_sharded(group, schur_problem(dev), scfg)
    out.update({f"schur_{k}": v.cpu().numpy() for k, v in r._asdict().items()})
    return out


def sharding_overhead(group, data: sft.SfTData, dev) -> dict:
    """What the world-1 sharded SfT costs over ``sft.solve`` on the same
    frame problem, and one all-reduce of the LM's block buffer (92,143
    float32) on its own: host ms of each solve (a warm call first, then the
    median of 3), and per all-reduce the host us of 125 calls in a row and
    the CUDA-event us per call of those 125."""
    cfg = Config()
    topo = meshmod.grid_topology(cfg.mesh.nodes_u, cfg.mesh.nodes_v)

    def host_ms(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    return {"sft_single_ms": host_ms(lambda: sft.solve(data, topo, cfg)),
            "sft_sharded_ms": host_ms(lambda: sharded.sft_solve_sharded(group, data, cfg)),
            **all_reduce_alone(group, dev)}


BACKLOG_CYCLES = 10_000_000  # ~5 ms of a sleep kernel at the H100's ~1.98 GHz


def all_reduce_alone(group, dev) -> dict:
    """One all-reduce of the sharded LM's block buffer (92,143 float32) on
    its own, 125 in a row on the card: host us and CUDA-event us per call;
    and the host us of one call, and of an elementwise op, issued behind
    ~5 ms of queued device work (not counted in the group's all-reduces)."""
    buf = torch.zeros(36 + 1800 + 90000 + 6 + 300 + 1, device=dev)
    calls, nbytes = group.n_all_reduce, group.all_reduce_bytes
    group.all_reduce(buf)
    torch.cuda.synchronize(dev)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    for _ in range(125):
        group.all_reduce(buf)
    b.record()
    host_us = (time.perf_counter() - t0) / 125 * 1e6
    b.synchronize()
    # does the host wait for the stream? one call behind ~5 ms of queued
    # device work (a sleep kernel), against an elementwise op behind the same
    behind = {}
    for name, op in (("all_reduce", lambda: group.all_reduce(buf)), ("add", lambda: buf.add_(0))):
        torch.cuda._sleep(BACKLOG_CYCLES)
        t1 = time.perf_counter()
        op()
        behind[f"{name}_host_us_behind_backlog"] = (time.perf_counter() - t1) * 1e6
        torch.cuda.synchronize(dev)
    group.n_all_reduce, group.all_reduce_bytes = calls, nbytes
    return {"all_reduce_host_us": host_us, "all_reduce_device_us": a.elapsed_time(b) / 125 * 1e3,
            **behind}


def parallel_worker(rank: int, rdv: str, inputs_path: str, outdir: str, device: str) -> int:
    """A rank of the two that share the card over gloo (NCCL does not put
    two ranks on one device): ``chip_smoke.py --parallel-worker rank
    rendezvous inputs.npz outdir device``."""
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{rdv}", world_size=2, rank=rank,
        timeout=datetime.timedelta(seconds=PAR_TIMEOUT_S))
    try:
        with np.load(inputs_path) as f:
            inputs = dict(f)
        out = shard_problems(sharded.make_group(2), inputs, torch.device(device))
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    finally:
        parallel.shutdown()
    return 0


def shard_inputs(shards: ShardProbe) -> dict:
    """The sharded solvers' inputs that a parallel run handed them, as numpy."""
    inputs = {f"sft_{f}": getattr(shards.sft, f).cpu().numpy() for f in sft.SfTData._fields}
    batch, dom, bend = shards.warps
    inputs.update({f"warp_{f}": getattr(batch, f).cpu().numpy() for f in mapper.WarpBatch._fields})
    inputs.update(warp_dom=dom.cpu().numpy(), warp_bend=bend.cpu().numpy())
    obs, k0, _ = shards.normals
    inputs.update({f"obs_{f}": getattr(obs, f).cpu().numpy() for f in nrm.PairObs._fields})
    inputs["obs_k0"] = k0.cpu().numpy()
    return inputs


def world1_shards(pcfg: Config, inputs: dict, dev) -> tuple[dict, dict, dict]:
    """The sharded solvers at world 1 over NCCL on ``dev``; the gap a 1e-7
    perturbation of the frame solve's start opens (the frame solve's own
    sensitivity: nodes0 scaled by (1 + N(0, 1e-7))); and
    ``sharding_overhead``."""
    parallel.init_distributed(pcfg, dev, timeout=PAR_TIMEOUT_S)
    try:
        group = sharded.make_group(1)
        w1 = shard_problems(group, inputs, dev)
        data = sft.SfTData(**{f: torch.as_tensor(inputs["sft_" + f], device=dev)
                              for f in sft.SfTData._fields})
        noise = torch.as_tensor(np.random.default_rng(1).normal(0.0, PAR_PROBE, data.nodes0.shape),
                                dtype=torch.float32, device=dev)
        probe_res = sharded.sft_solve_sharded(group, data._replace(
            nodes0=data.nodes0 * (1.0 + noise)), Config())
        overhead = sharding_overhead(group, data, dev) if torch.device(dev).type == "cuda" else {}
    finally:
        parallel.shutdown()
    sft_probe = {"T": float(np.abs(probe_res.T.cpu().numpy() - w1["sft_T"]).max()),
                 "nodes": float(np.abs(probe_res.nodes.cpu().numpy() - w1["sft_nodes"]).max())}
    return w1, sft_probe, overhead


def held_to_world1(r: dict, w1: dict, sft_probe: dict, cfg: Config, what: str):
    """The sharded solvers of a larger world (``r``) against world 1's:
    the JAX package's tolerances (tests/test_parallel.py); the frame's SfT,
    a real problem where a reduction order moves the solution along its
    flat directions, within 3x its own 1e-7 probe where that is larger.
    Returns (gaps, limits); raises beyond them."""
    nres = nrm.NormalResult(*(torch.as_tensor(w1[f"normals_{k}"]) for k in nrm.NormalResult._fields))
    gate = mapper.normal_reliability_gate(nres, cfg.regularizer.reliability).numpy()
    gaps = {
        "sft_T": float(np.abs(r["sft_T"] - w1["sft_T"]).max()),
        "sft_nodes": float(np.abs(r["sft_nodes"] - w1["sft_nodes"]).max()),
        "sft_inlier_equal": float((r["sft_inlier"] == w1["sft_inlier"]).mean()),
        "schur_T": float(np.abs(r["schur_T"] - w1["schur_T"]).max()),
        "schur_nodes": float(np.abs(r["schur_nodes"] - w1["schur_nodes"]).max()),
        "warps_warped": float(np.abs(r["warps_warped"] - w1["warps_warped"]).max()),
        "normals_k_gated": float(np.abs(r["normals_k"] - w1["normals_k"])[gate].max()),
        "normals_gate_equal": bool((mapper.normal_reliability_gate(nrm.NormalResult(*(
            torch.as_tensor(r[f"normals_{k}"]) for k in nrm.NormalResult._fields)),
            cfg.regularizer.reliability).numpy() == gate).all()),
    }
    print(what, "vs world 1", json.dumps(gaps), "the frame SfT's 1e-7 probe",
          json.dumps(sft_probe), flush=True)
    limits = {"sft_T": max(1e-4, 3 * sft_probe["T"]), "sft_nodes": max(1e-4, 3 * sft_probe["nodes"]),
              "schur_T": 1e-4, "schur_nodes": 2e-4, "warps_warped": 1e-4, "normals_k_gated": 3e-3}
    if (any(gaps[k] > v for k, v in limits.items()) or gaps["sft_inlier_equal"] < 0.99
            or not gaps["normals_gate_equal"]):
        raise SystemExit(f"{what} disagrees with world 1 beyond {limits}")
    return gaps, limits


def parallel_phase(seq, cfg: Config, dev, single=None) -> dict:
    """Phase 13: the multi-device path (``parallel.enabled``), see the module
    docstring.  ``single`` is the mapping slice's single-device run on the
    same frames and config and its frame seconds (run here when not
    given)."""
    out = {}
    pcfg = dataclasses.replace(cfg, parallel=ParallelConfig(enabled=True))
    frames = seq.frames
    single, single_s = single or run_slice(frames, cfg, dev, timed=True, localization=False)
    period = cfg.tracking.keyframe_period
    # the probe is read through the first keyframe frame only (see below)
    probe, _ = run_slice(frames[:period + 1], cfg, dev, localization=False, perturb=PAR_PROBE)

    # ---- NCCL world 1 at full width, twice; the launches of the first run
    shards = ShardProbe()
    cuda_build.LAUNCHES.clear()
    try:
        par, rows = parallel_run(frames, pcfg, dev)
        torch.cuda.synchronize()
    finally:
        shards.restore()
    launches = dict(cuda_build.LAUNCHES)
    par2, rows2 = parallel_run(frames, pcfg, dev, check_waits=True)
    states = [m["state"] for m in par._metrics]
    kf_frames = [m["frame"] for m in par._metrics if m["keyframe"]]
    swaps = [m["template"] for m in par._metrics[1:] if m["keyframe"]]
    print("parallel states", states, "keyframes", kf_frames, "swaps", swaps, "launches", launches,
          flush=True)
    if any(s != TrackingState.OK.name for s in states):
        raise SystemExit(f"parallel: not every frame tracked: {states}")
    if kf_frames != [0] + list(range(period, len(frames), period)):
        raise SystemExit(f"parallel: keyframes at {kf_frames}")
    n_kf = len(kf_frames) - 1
    if launches.get("windowed_match", 0) != 2 * n_kf:
        raise SystemExit(f"parallel: windowed_match launched {launches.get('windowed_match', 0)} "
                         f"times for {n_kf} keyframes (2 each)")
    if launches.get("hamming_matrix", 0) < len(frames) - 1 + sum(swaps):
        raise SystemExit(f"parallel: hamming_matrix launched {launches.get('hamming_matrix', 0)} "
                         f"times for {len(frames) - 1} frames and {sum(swaps)} re-anchors")
    repeats = same_run(par, par2)
    print("parallel: the card repeats its run bit for bit:", repeats, flush=True)
    if not repeats:
        raise SystemExit("parallel: two runs on the card differ")
    waits = [dict(frame=r["frame"], mode=r["wait_mode"], waits=r["waits"], where=r["where"])
             for r in rows2 if r["wait_mode"]]
    print("parallel host waits", json.dumps(waits), flush=True)
    if any(w["waits"] for w in waits if w["mode"] == "error"):
        raise SystemExit("parallel: a frame dispatch without a keyframe waited for the host")

    # ---- against the single-device run: flags on every frame; counts and
    # pose through the first keyframe frame.  After a template swap the
    # legacy chain's map is another map, in the JAX package as here: its
    # culling sees the keyframe counter after the increment and drops the
    # first keyframe's points with <= 2 observations (ROADMAP C)
    cmp = []
    for t, (mp, ms) in enumerate(zip(par._metrics, single._metrics)):
        gap = pose_gap(par, single, t)
        pgap = pose_gap(probe, single, t) if t <= period else None
        ok = all(mp[k] == ms[k] for k in ("state", "keyframe", "template"))
        if t <= period:
            ok = ok and gap <= max(2e-2, 3 * pgap) and all(
                abs(mp[k] - ms[k]) <= max(1, 0.02 * ms[k]) for k in ("matches", "inliers"))
        cmp.append(dict(frame=t, matches=[mp["matches"], ms["matches"]],
                        inliers=[mp["inliers"], ms["inliers"]], template=[mp["template"],
                        ms["template"]], pose_gap=gap, probe_gap=pgap, ok=ok))
    print("parallel vs single", json.dumps(cmp), flush=True)
    if not all(c["ok"] for c in cmp):
        raise SystemExit("parallel: the run disagrees with the single-device run")

    # ---- the same parallel run on the CPU over gloo
    cpu, cpu_rows = parallel_run(frames[:PAR_CPU_FRAMES], pcfg, "cpu")
    cpu_cmp = compare_runs(par, cpu, None)
    if not all(r["ok"] for r in cpu_cmp):
        raise SystemExit("parallel: the card's run disagrees with the CPU's")

    # ---- the sharded solvers at world 1 (NCCL) and world 2 (two ranks over gloo)
    inputs = shard_inputs(shards)
    w1, sft_probe, overhead = world1_shards(pcfg, inputs, dev)
    work = os.path.join("chiprun_out", "parallel_world2")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-worker",
                               str(r), os.path.join(os.path.abspath(work), "rdv"),
                               os.path.join(work, "inputs.npz"), work, str(dev)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=2 * PAR_TIMEOUT_S)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            raise SystemExit(f"parallel: a world-2 rank failed:\n{log[-4000:]}")
    w2 = [dict(np.load(os.path.join(work, f"rank{r}.npz"))) for r in (0, 1)]
    timing_keys = ("sft_ms",)
    unequal = [k for k in w2[0] if k not in timing_keys and not np.array_equal(w2[0][k], w2[1][k])]
    if unequal:
        raise SystemExit(f"parallel: the two ranks differ in {unequal}")
    r = w2[0]
    shard_gaps, limits = held_to_world1(r, w1, sft_probe, cfg, "parallel: world 2")

    out["cli_world1"] = cli_world1(os.path.join("chiprun_out", "parallel_cli"))

    plain = [r for r in rows[1:] if not r["keyframe"]]
    single_plain = [single_s[m["frame"]] * 1e3 for m in single._metrics[1:] if not m["keyframe"]]
    out.update({
        "single_frame_p50_ms": statistics.median(single_plain),
        "single_keyframe_frame_ms": [single_s[m["frame"]] * 1e3 for m in single._metrics[1:]
                                     if m["keyframe"]],
        "states": states, "swaps": swaps, "launches": launches, "card_repeats_bit_for_bit": repeats,
        "host_waits": waits, "vs_single": cmp, "cpu_frames": cpu_cmp,
        "frame_ms": [r["ms"] for r in rows], "frame_p50_ms": statistics.median(
            r["ms"] for r in plain), "frame_max_ms": max(r["ms"] for r in rows[1:]),
        "keyframe_frame_ms": [r["ms"] for r in rows if r["keyframe"]],
        "keyframe_ms": [r.get("keyframe_ms") for r in rows if r["keyframe"]],
        "keyframe_chain_ms": [r.get("chain_ms") for r in rows if r["keyframe"]],
        "all_reduce_calls_per_frame": statistics.median(r["all_reduce_calls"] for r in plain),
        "all_reduce_bytes_per_frame": statistics.median(r["all_reduce_bytes"] for r in plain),
        "all_reduce_per_keyframe_frame": [(r["all_reduce_calls"], r["all_reduce_bytes"])
                                          for r in rows if r["keyframe"]],
        "cpu_frame_ms": [r["ms"] for r in cpu_rows],
        "sft_world1_ms": float(w1["sft_ms"]), "sft_world2_ms": [float(x["sft_ms"]) for x in w2],
        "sft_all_reduce": {"world1": [int(w1["sft_all_reduce_calls"]),
                                      int(w1["sft_all_reduce_bytes"])],
                           "world2": [int(r["sft_all_reduce_calls"]),
                                      int(r["sft_all_reduce_bytes"])]},
        "sft_observations": int(inputs["sft_obs_mask"].shape[0]),
        "world2_vs_world1": shard_gaps, "world2_limits": limits, "sft_probe_gap": sft_probe,
        "sharding_overhead": overhead,
    })
    print("parallel", json.dumps({k: v for k, v in out.items()
                                  if k not in ("vs_single", "cpu_frames")}), flush=True)
    return out


CLI_FRAMES = 12  # the synth app's parallel runs (320x240, the default Config: a keyframe at 10)
APP_FILES = ("Matches.txt", "StatusTracking.txt", "MapPointUsage.txt", "Trajectory.txt",
             "trajectory.txt", "template.obj")


def cli_yaml(work: str, n_devices: int) -> str:
    """Settings for the synth app: the default Config with
    ``parallel.enabled`` and ``n_devices``."""
    path = os.path.join(work, f"parallel_n{n_devices}.yaml")
    with open(path, "w") as f:
        f.write(f"parallel:\n  enabled: true\n  n_devices: {n_devices}\n")
    return path


def synth_argv(yaml: str, out: str, frames: int = CLI_FRAMES) -> list[str]:
    return ["synth", "--frames", str(frames), "--config", yaml, "--out", out]


def differing_files(dir_a: str, dir_b: str) -> list[str]:
    """The app result files that are not equal byte for byte (or missing)."""
    def read(d, n):
        p = os.path.join(d, n)
        return open(p, "rb").read() if os.path.exists(p) else None
    return [n for n in APP_FILES if read(dir_a, n) is None or read(dir_a, n) != read(dir_b, n)]


def cli_world1(work: str) -> dict:
    """Phase 13's launcher step: ``cli synth`` with ``parallel.enabled``
    (``n_devices`` 1) through ``parallel.launch`` at world 1 over NCCL; its
    rank-0 files must equal those of the same app run in this process."""
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    yaml = cli_yaml(work, 1)
    here, there = os.path.join(work, "in_process"), os.path.join(work, "launched")
    t0 = time.perf_counter()
    if cli.main(synth_argv(yaml, here)) != 0:
        raise SystemExit("parallel: the in-process synth app failed")
    t1 = time.perf_counter()
    rc = launch.launch([sys.executable, "-m", "defslam_tpu_torch.cli", *synth_argv(yaml, there)],
                       1, "cuda", timeout=2 * PAR_TIMEOUT_S)
    t2 = time.perf_counter()
    print(flush=True)
    if rc != 0:
        raise SystemExit(f"parallel: the launched synth app exited {rc}")
    differ = differing_files(here, there)
    out = {"in_process_s": t1 - t0, "launched_s": t2 - t1, "differing_files": differ}
    print("parallel cli world 1", json.dumps(out), flush=True)
    if differ:
        raise SystemExit(f"parallel: the launched app's {differ} differ from the in-process run's")
    return out


MULTI_WORLD = 4  # phase 15: one rank per card
MULTI_TIMING_FRAMES = 12  # the timing launches' runs: frames 0-11, a keyframe at 10
AVOID_RECORD_STREAMS = {"TORCH_NCCL_AVOID_RECORD_STREAMS": "1"}


def timing_summary(rows: list[dict], group, inputs: dict, dev) -> dict:
    """A parallel run's times (host ms; not gated): frame p50 and max over
    the frames after the first, keyframe frames, all-reduces per frame
    without a keyframe; on the card one all-reduce alone and the frame
    SfT's host ms with and without its all-reduces, on ``group``."""
    plain = [r for r in rows[1:] if not r["keyframe"]]
    out = {"frame_p50_ms": statistics.median(r["ms"] for r in plain),
           "frame_max_ms": max(r["ms"] for r in rows[1:]),
           "keyframe_frame_ms": [r["ms"] for r in rows if r["keyframe"]],
           "keyframe_ms": [r.get("keyframe_ms") for r in rows if r["keyframe"]],
           "all_reduce_calls_per_frame": statistics.median(r["all_reduce_calls"] for r in plain),
           "all_reduce_bytes_per_frame": statistics.median(r["all_reduce_bytes"] for r in plain)}
    if torch.device(dev).type == "cuda":
        out.update(all_reduce_alone(group, dev))
        out.update(sft_all_reduce_cost(group, inputs, dev))
    return out


def multicard_rank(work: str, mode: str) -> int:
    """A rank of phase 15's launches (``chip_smoke.py --multicard-rank work
    mode``), on its card: ``full``: the parallel System on the phase's
    frames twice (the kernels' launches counted over the first, host waits
    checked in the second); ``timing``: the first ``MULTI_TIMING_FRAMES``
    frames once.  Then, timed, those first frames again, the sharded
    solvers on world 1's inputs, one all-reduce alone and the frame
    solve's all-reduce cost; in ``full`` mode last ``cli.main`` of the
    synth app as this rank.  Writes ``rank<r>.npz`` and ``rank<r>.json``
    to ``work``."""
    with open(os.path.join(work, "job.pkl"), "rb") as f:
        job = pickle.load(f)
    pcfg, dev = job["cfg"], torch.device(job["device"])
    parallel.init_distributed(pcfg, dev, timeout=PAR_TIMEOUT_S)
    rank = torch.distributed.get_rank()
    frames = job["frames"] if mode == "full" else job["frames"][:MULTI_TIMING_FRAMES]
    cuda_build.LAUNCHES.clear()  # the first run pays the process's set-up; a later one is timed
    s, rows = parallel_run(frames, pcfg, dev, keep_group=True)
    out = {"rank": rank, "world": s.group.size, "device": str(s.device),
           "launches": dict(cuda_build.LAUNCHES), "metrics": s._metrics}
    arrays = {"traj": np.stack([np.asarray(T) for _, T in s.trajectory]),
              "ts": np.array([t for t, _ in s.trajectory])}
    if mode == "full":
        s2, rows2 = parallel_run(frames, pcfg, dev, check_waits=s.device.type == "cuda",
                                 keep_group=True)
        out["repeats"] = same_run(s, s2)
        out["waits"] = [dict(frame=r["frame"], mode=r["wait_mode"], waits=r["waits"],
                             where=r["where"]) for r in rows2 if r["wait_mode"]]
    if mode == "full" and s.device.type == "cuda":
        out["transport"] = frame_transport(np.asarray(job["frames"][0]), s.device)
    _, timed = parallel_run(frames[:MULTI_TIMING_FRAMES], pcfg, dev, keep_group=True)
    group = sharded.make_group(0)
    shards = shard_problems(group, job["inputs"], s.device)
    out["timing"] = timing_summary(timed, group, job["inputs"], s.device)
    arrays.update({k: v for k, v in shards.items() if k != "sft_ms"})
    np.savez(os.path.join(work, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f, default=str)
    if mode == "full":  # the synth app as a rank of this world; it ends the group
        return cli.main(synth_argv(job["yaml"], os.path.join(work, "cli_ranks"),
                                   job["cli_frames"]) + ["--device", job["device"]])
    parallel.shutdown()
    return 0


TRANSPORT_REPS = 30


def frame_transport(frame: np.ndarray, dev) -> dict:
    """Two ways for rank 0 to hand a frame to the other ranks, on every
    rank of a launched world (each holds the frame, to check what it
    received): the pickled frame in one broadcast on a gloo group (what
    ``parallel.driver`` sends), and a pickled header on that group then an
    NCCL broadcast of rank 0's device copy (uploaded from pinned memory).
    Per frame, medians over ``TRANSPORT_REPS`` after a barrier: the host
    us until the call returns on this rank, and for NCCL also until the
    frame is on the card (synchronized); whether every frame arrived bit
    for bit.  The frame is float32, as ``load_video`` and the render
    give it."""
    dist = torch.distributed
    calls = dist.new_group(backend="gloo")
    rank = dist.get_rank()
    frame = np.ascontiguousarray(frame, dtype=np.float32)
    times = collections.defaultdict(list)
    exact = {"gloo_pickle": True, "nccl_device": True}
    for _ in range(TRANSPORT_REPS):
        dist.barrier(group=calls)
        t0 = time.perf_counter()
        box = [frame if rank == 0 else None]
        dist.broadcast_object_list(box, src=0, group=calls)
        times["gloo_pickle_us"].append((time.perf_counter() - t0) * 1e6)
        exact["gloo_pickle"] &= bool(np.array_equal(box[0], frame))
        dist.barrier(group=calls)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        head = [frame.shape if rank == 0 else None]
        dist.broadcast_object_list(head, src=0, group=calls)
        if rank == 0:
            t = torch.from_numpy(frame).pin_memory().to(dev, non_blocking=True)
        else:
            t = torch.empty(head[0], dtype=torch.float32, device=dev)
        dist.broadcast(t, src=0)
        times["nccl_host_us"].append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize(dev)
        times["nccl_delivered_us"].append((time.perf_counter() - t0) * 1e6)
        exact["nccl_device"] &= bool(np.array_equal(t.cpu().numpy(), frame))
    out = {k: statistics.median(v) for k, v in times.items()}
    out.update({"bytes": frame.nbytes, "shape": list(frame.shape), "bit_exact": exact})
    dist.destroy_process_group(calls)
    return out


def nccl_transport(logdir: str) -> dict:
    """What NCCL's init logs (``NCCL_DEBUG=INFO``) say it connects the
    ranks through: the count of each ``via <transport>`` of its channels,
    and its lines on NVLink SHARP (NVLS) and the NVLink topology."""
    via, lines = collections.Counter(), []
    for name in sorted(os.listdir(logdir)):
        with open(os.path.join(logdir, name), errors="replace") as f:
            for line in f:
                via.update(re.findall(r" via (\S+)", line))
                if re.search(r"NVLS|NVLink|nvlink|NVL ", line) and len(lines) < 12:
                    lines.append(line.strip()[-200:])
    return {"via": dict(via), "lines": lines}


def sft_all_reduce_cost(group, inputs: dict, dev) -> dict:
    """The frame solve's host ms (median of 3, warm) on ``group`` as it
    runs, and with ``dist.all_reduce`` a no-op (the same LM iterations on
    the card, which takes no early exit): what its all-reduces cost inside
    the LM."""
    data = sft.SfTData(**{f: torch.as_tensor(inputs["sft_" + f], device=dev)
                          for f in sft.SfTData._fields})

    def host_ms():
        sharded.sft_solve_sharded(group, data, Config())
        torch.cuda.synchronize(dev)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            sharded.sft_solve_sharded(group, data, Config())
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    calls = group.n_all_reduce
    out = {"sft_host_ms": host_ms()}
    per_solve = (group.n_all_reduce - calls) // 4
    real = torch.distributed.all_reduce
    torch.distributed.all_reduce = lambda t, *a, **k: None
    try:
        out["sft_no_all_reduce_host_ms"] = host_ms()
    finally:
        torch.distributed.all_reduce = real
    out["all_reduces_per_solve"] = per_solve
    out["in_lm_us_per_all_reduce"] = (out["sft_host_ms"] - out["sft_no_all_reduce_host_ms"]
                                      ) / max(per_solve, 1) * 1e3
    return out


def launch_ranks(work: str, job: dict, mode: str, env: dict | None = None) -> list[dict]:
    """``multicard_rank`` on a launch of ``MULTI_WORLD`` ranks (the job's
    device: a card each, or the CPU over gloo); each rank's json, with its
    npz under ``arrays``."""
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    with open(os.path.join(work, "job.pkl"), "wb") as f:
        pickle.dump(job, f)
    rc = launch.launch([sys.executable, os.path.abspath(__file__), "--multicard-rank", work, mode],
                       MULTI_WORLD, job["device"], timeout=4 * PAR_TIMEOUT_S, env=env)
    os.remove(os.path.join(work, "job.pkl"))  # the frames (29 MB): keep the outputs small
    print(flush=True)
    if rc != 0:
        raise SystemExit(f"multicard: the {mode} launch exited {rc}")
    ranks = []
    for r in range(MULTI_WORLD):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
        ranks[-1]["arrays"] = dict(np.load(os.path.join(work, f"rank{r}.npz")))
    return ranks


def ranks_bit_equal(ranks: list[dict], what: str) -> None:
    """Every rank's rows, trajectory and solver results equal rank 0's."""
    for r in ranks[1:]:
        a, b = r["arrays"], ranks[0]["arrays"]
        unequal = [k for k in b if not np.array_equal(a[k], b[k])]
        if r["metrics"] != ranks[0]["metrics"] or unequal:
            raise SystemExit(f"{what}: rank {r['rank']} differs from rank 0 "
                             f"(metrics equal: {r['metrics'] == ranks[0]['metrics']}, {unequal})")


def world_held(ranks_run: dict, ref: System, probe: System) -> list[dict]:
    """A world-4 run (rank 0's metrics and trajectory) against world 1 on
    the legacy chain: states, keyframe and template flags equal, inliers
    within max(1, 2%) (``compare_runs``), matches too, and the pose within
    max(2e-2, 3x the gap of the world-1 run's 1e-7 probe) on every frame."""
    rows = []
    for t, (mp, ms) in enumerate(zip(ranks_run["metrics"], ref._metrics)):
        gap = float(np.abs(ranks_run["arrays"]["traj"][t] - np.asarray(ref.trajectory[t][1])).max())
        pgap = pose_gap(probe, ref, t)
        ok = (all(mp[k] == ms[k] for k in ("state", "keyframe", "template"))
              and all(abs(mp[k] - ms[k]) <= max(1, 0.02 * ms[k]) for k in ("matches", "inliers"))
              and gap <= max(2e-2, 3 * pgap))
        rows.append(dict(frame=t, matches=[mp["matches"], ms["matches"]],
                         inliers=[mp["inliers"], ms["inliers"]], template=[mp["template"],
                         ms["template"]], pose_gap=gap, probe_gap=pgap, ok=ok))
    if len(rows) != len(ref._metrics):
        raise SystemExit(f"multicard: {len(rows)} frames against world 1's {len(ref._metrics)}")
    return rows


def launches_and_waits_held(ranks: list[dict], n_frames: int, swaps: int, n_kf: int,
                             what: str) -> None:
    """B1 on every frame and re-anchor and B2 twice per keyframe, on every
    rank (phase 13's counts), and no host wait on a frame without a
    keyframe."""
    for r in ranks:
        la = r["launches"]
        if la.get("windowed_match", 0) != 2 * n_kf or la.get("hamming_matrix", 0) < (
                n_frames - 1 + swaps):
            raise SystemExit(f"{what}: rank {r['rank']} launched {la} for {n_frames} frames, "
                             f"{n_kf} keyframes and {swaps} re-anchors")
        if any(w["waits"] for w in r.get("waits", []) if w["mode"] == "error"):
            raise SystemExit(f"{what}: rank {r['rank']} waited on a frame without a keyframe")


def multicard_phase(seq, cfg: Config, dev, rates: dict | None = None) -> dict:
    """Phase 15 (``--multicard``): the multi-device System at world 4 over
    NCCL, one rank per card, started by one launch; see the module
    docstring.  ``dev`` is card 0 (or the CPU for a rehearsal over gloo,
    without the kernel and card checks)."""
    dev = torch.device(dev)
    cuda = dev.type == "cuda"
    if cuda and torch.cuda.device_count() < MULTI_WORLD:
        raise SystemExit(f"multicard: needs {MULTI_WORLD} CUDA cards, "
                         f"{torch.cuda.device_count()} visible")
    root = os.path.abspath(os.path.join("chiprun_out", "multicard"))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out = {}
    frames = seq.frames
    period = cfg.tracking.keyframe_period
    n_kf = (len(frames) - 1) // period
    if cuda:
        # ---- 6 (printed first). the cards and what joins them
        out["cards"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()
        for key, cmd in (("topology", ["nvidia-smi", "topo", "-m"]),
                         ("nvlink", ["nvidia-smi", "nvlink", "-s"])):
            r = subprocess.run(cmd, capture_output=True, text=True)
            out[key] = (r.stdout + r.stderr).strip()
        out["peer_access"] = [[k == j or torch.cuda.can_device_access_peer(k, j)
                               for j in range(MULTI_WORLD)] for k in range(MULTI_WORLD)]
        print("multicard cards", json.dumps(out["cards"]), "\n" + out["topology"] + "\n"
              + out["nvlink"][:1500] + "\npeer access", out["peer_access"], flush=True)
        # ---- 1. B1 and B2 against their plain versions on cards 1-3 (card 0: phase 3)
        cards = [torch.device("cuda", k) for k in range(MULTI_WORLD)]
        out["kernels_by_card"] = {}
        for card in cards[1:]:
            with torch.cuda.device(card):
                kh, kw = check_hamming(card, rates), check_windowed_match(cfg, card, rates)
            out["kernels_by_card"][str(card)] = {
                k["name"]: {"max_abs_err": k["max_abs_err"], "device_ms": k.get("device_ms")}
                for k in (kh, kw)}
        print("multicard kernels by card", json.dumps(out["kernels_by_card"]), flush=True)
        # ---- 2. the tracking slice on the last card, card 0 current
        a, _ = run_slice(frames[:N_FRAMES], cfg, cards[0])
        before = cuda_build.LAUNCHES.get("hamming_matrix", 0)
        b, _ = run_slice(frames[:N_FRAMES], cfg, cards[-1])
        torch.cuda.synchronize(cards[-1])
        out["last_card"] = {"device": str(b.device), "current": torch.cuda.current_device(),
                            "b1_launches": cuda_build.LAUNCHES.get("hamming_matrix", 0) - before,
                            "bit_equal": same_run(a, b)}
        print("multicard tracking slice on the last card", json.dumps(out["last_card"]),
              flush=True)
        if not out["last_card"]["bit_equal"] or b.pose.device != cards[-1]:
            raise SystemExit(f"multicard: the tracking slice on {cards[-1]} differs from cuda:0's")
        if out["last_card"]["b1_launches"] < N_FRAMES - 1:
            raise SystemExit("multicard: B1 did not launch on every frame on the last card")

    # ---- world 1 in this process: the reference, its probe, the solvers' inputs
    pcfg1 = dataclasses.replace(cfg, parallel=ParallelConfig(enabled=True, n_devices=1))
    shards = ShardProbe()
    try:
        ref, _ = parallel_run(frames, pcfg1, dev)
    finally:
        shards.restore()
    probe, _ = parallel_run(frames, pcfg1, dev, perturb=PAR_PROBE)
    inputs = shard_inputs(shards)
    w1, sft_probe, _ = world1_shards(pcfg1, inputs, dev)

    # ---- 3 and 4. world 4, one launch: the System twice, the solvers, the app
    workdir = os.path.join(root, "world4")
    pcfg = dataclasses.replace(cfg, parallel=ParallelConfig(enabled=True, n_devices=0))
    job = {"cfg": pcfg, "device": dev.type, "frames": np.asarray(frames), "inputs": inputs,
           # n_devices 0: every card (on the CPU a world of 1, so 4 there)
           "yaml": cli_yaml(root, 0 if cuda else MULTI_WORLD), "cli_frames": CLI_FRAMES}
    t0 = time.perf_counter()
    nccl_log = os.path.join(root, "nccl_debug")
    os.makedirs(nccl_log)
    ranks = launch_ranks(workdir, job, "full", env={
        "NCCL_DEBUG": "INFO", "NCCL_DEBUG_SUBSYS": "INIT,GRAPH",
        "NCCL_DEBUG_FILE": os.path.join(nccl_log, "rank.%p.log")})
    out["world4_launch_s"] = time.perf_counter() - t0
    out["nccl_transport"] = nccl_transport(nccl_log)
    print("multicard NCCL transport", json.dumps(out["nccl_transport"]), flush=True)
    devices = [r["device"] for r in ranks]
    print("multicard world 4 devices", devices, "launches", [r["launches"] for r in ranks],
          flush=True)
    if any(r["world"] != MULTI_WORLD for r in ranks) or (
            cuda and devices != [f"cuda:{k}" for k in range(MULTI_WORLD)]):
        raise SystemExit(f"multicard: the ranks ran on {devices}")
    ranks_bit_equal(ranks, "multicard world 4")
    if not all(r["repeats"] for r in ranks):
        raise SystemExit("multicard: a rank's two runs differ")
    swaps = sum(m["template"] for m in ref._metrics[1:] if m["keyframe"])
    if cuda:
        launches_and_waits_held(ranks, len(frames), swaps, n_kf, "multicard world 4")
    held = world_held(ranks[0], ref, probe)
    print("multicard world 4 vs world 1", json.dumps(held), flush=True)
    if not all(h["ok"] for h in held):
        raise SystemExit("multicard: world 4 disagrees with world 1")
    shard_gaps, limits = held_to_world1(ranks[0]["arrays"], w1, sft_probe, cfg,
                                        "multicard: world 4's solvers")
    out.update({"ranks_devices": devices, "launches_by_rank": [r["launches"] for r in ranks],
                "host_waits_rank0": ranks[0].get("waits"), "vs_world1": held,
                "solvers_vs_world1": shard_gaps, "solver_limits": limits})

    # ---- the synth app at world 4 (n_devices 0: every card) against the
    # same app run by the ranks above
    app_out = os.path.join(root, "cli_launched")
    t0 = time.perf_counter()
    app = subprocess.Popen([sys.executable, "-m", "defslam_tpu_torch.cli",
                            *synth_argv(job["yaml"], app_out, job["cli_frames"]),
                            "--device", dev.type], cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        rc = app.wait(timeout=4 * PAR_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        app.terminate()  # the app's launcher stops its ranks
        rc = app.wait()
    out["cli_s"] = time.perf_counter() - t0
    print(flush=True)
    differ = differing_files(os.path.join(workdir, "cli_ranks"), app_out)
    out["cli_differing_files"] = differ
    print("multicard cli world 4: exit", rc, "files differing from the ranks' run", differ,
          flush=True)
    if rc != 0 or differ:
        raise SystemExit(f"multicard: the synth app at world 4 exited {rc}, files {differ}")

    # ---- 6, 7. the world a System makes in this process (parallel.driver)
    out["driven"] = driven_world(frames, cfg, dev, ranks[0], n_kf, swaps)
    out["driven_app"] = driven_app(seq, dev, root)

    # ---- 5. times at world 4 and world 1, without and with
    # TORCH_NCCL_AVOID_RECORD_STREAMS=1 (set for these runs only)
    timing = {"world4": ranks[0]["timing"]}
    group_args = (pcfg1, inputs, dev)
    timing["world1"] = world1_timing(frames[:MULTI_TIMING_FRAMES], *group_args)
    os.environ.update(AVOID_RECORD_STREAMS)
    try:
        timing["world1_avoid_record_streams"] = world1_timing(frames[:MULTI_TIMING_FRAMES],
                                                              *group_args)
    finally:
        for k in AVOID_RECORD_STREAMS:
            os.environ.pop(k)
    timed = launch_ranks(os.path.join(root, "world4_avoid_record_streams"), job, "timing",
                         env=AVOID_RECORD_STREAMS)
    timing["world4_avoid_record_streams"] = timed[0]["timing"]
    timing["driven"] = out["driven"]["timing"]
    timing["transport"] = ranks[0].get("transport")
    out["timing"] = timing
    out["launches"] = out["driven"]["launches_by_rank"][0]
    print("multicard timing", json.dumps(timing), flush=True)
    # ---- 8 (last: it kills a rank). failure on the cards
    out["driven_failure"] = driven_failure(frames, cfg, dev)
    return out


def driven_config(cfg: Config, dev) -> Config:
    """``cfg`` at world 4 made by the System itself: ``n_devices`` 0 (every
    card), or 4 on the CPU (a rehearsal, where 0 means 1)."""
    n = 0 if torch.device(dev).type == "cuda" else MULTI_WORLD
    return dataclasses.replace(cfg, parallel=ParallelConfig(enabled=True, n_devices=n))


def driven_devices(s: System, dev) -> list[str]:
    """The ranks' devices of a driven System; raises unless they are
    ``cuda:0-3`` (or the CPU's)."""
    want = ([f"cuda:{k}" for k in range(MULTI_WORLD)] if torch.device(dev).type == "cuda"
            else ["cpu"] * MULTI_WORLD)
    if s._driver is None or s._driver.devices != want:
        raise SystemExit(f"multicard driven: the ranks are on "
                         f"{None if s._driver is None else s._driver.devices}, not {want}")
    return s._driver.devices


def _json(obj):
    return json.loads(json.dumps(obj, default=str))


def driven_world(frames, cfg: Config, dev, launched: dict, n_kf: int, swaps: int) -> dict:
    """Phase 15's library System at world 4: ``System(cfg)`` with
    ``n_devices`` 0 in this process, which becomes rank 0 on ``cuda:0`` and
    starts ranks 1-3 on ``cuda:1-3`` (``parallel.driver``).  The 24 frames
    twice (``reset`` between), every rank's kernel counts set to 0 before
    each run and read after it; the second run's frames without a keyframe
    under ``host_waits("error")`` on rank 0.  The ranks bit-equal (their
    digests), the runs bit-equal, rank 0 bit-equal to rank 0 of the
    launched world 4 (``launched``), B1 and B2 launched on every rank as
    there.  Times, as the launch's timed run takes them (frames 0-11, the
    p50 over frames 1-11 without a keyframe), at this process's torch
    threads and at the launch's share of the cores, each with the host us
    of a forwarded call that does nothing else
    (``deactivate_localization_mode``)."""
    from defslam_tpu_torch.parallel import driver

    pcfg = driven_config(cfg, dev)
    t0 = time.perf_counter()
    s = System(pcfg, device=torch.device(dev).type)
    out = {"start_s": time.perf_counter() - t0, "devices": driven_devices(s, dev)}
    print("multicard driven world 4: devices", out["devices"], "start s", out["start_s"],
          flush=True)
    runs = []
    try:
        for k in range(2):
            if k:
                s.reset()
            s._driver.gather(s, profiling.kernel_launches, True)
            n0 = len(s._metrics)
            _, rows = parallel_run(frames, pcfg, dev, check_waits=k == 1, keep_group=True,
                                   system=s)
            runs.append({"metrics": _json(s._metrics[n0:]),
                         "traj": np.stack([np.asarray(T) for _, T in s.trajectory]),
                         "rows": rows, "launches": s._driver.gather(s, profiling.kernel_launches),
                         "digests": s._driver.gather(s, driver.state_digest)})
        # timed as the launch's ranks are (frames 0-11, no host-wait
        # checks), at this process's torch threads and at the launch's
        # share of the cores; a forwarded call that does nothing else
        threads = torch.get_num_threads()
        timing = {}
        # (on the CPU the ranks' results, and so their collectives, depend on
        # the thread count: the workers took rank 0's at the start)
        share = max(1, (os.cpu_count() or 1) // MULTI_WORLD)
        for n in (threads, share) if torch.device(dev).type == "cuda" else (threads,):
            torch.set_num_threads(n)
            s.reset()
            _, rows = parallel_run(frames[:MULTI_TIMING_FRAMES], pcfg, dev, keep_group=True,
                                   system=s)
            t1 = time.perf_counter()
            for _ in range(FORWARD_CALLS):
                s.deactivate_localization_mode()
            timing[f"threads_{n}"] = {
                "frame_p50_ms": statistics.median(r["ms"] for r in rows[1:] if not r["keyframe"]),
                "frame_max_ms": max(r["ms"] for r in rows[1:]),
                "forward_us": (time.perf_counter() - t1) / FORWARD_CALLS * 1e6}
        torch.set_num_threads(threads)
    finally:
        s.shutdown()
    waits = [dict(frame=r["frame"], mode=r["wait_mode"], waits=r["waits"], where=r["where"])
             for r in runs[1]["rows"] if r["wait_mode"]]
    out.update({
        "ranks_bit_equal": [len(set(r["digests"])) == 1 for r in runs],
        "runs_bit_equal": runs[0]["metrics"] == runs[1]["metrics"] and bool(
            np.array_equal(runs[0]["traj"], runs[1]["traj"])),
        "launched_rank0_bit_equal": runs[0]["metrics"] == launched["metrics"] and bool(
            np.array_equal(runs[0]["traj"], launched["arrays"]["traj"])),
        "launches_by_rank": runs[0]["launches"], "host_waits_rank0": waits,
        "timing": {**timing, "launched_frame_p50_ms": launched["timing"]["frame_p50_ms"],
                   "start_s": out["start_s"]}})
    print("multicard driven world 4", json.dumps({k: out[k] for k in (
        "ranks_bit_equal", "runs_bit_equal", "launched_rank0_bit_equal", "launches_by_rank",
        "timing")}), flush=True)
    if not all(out["ranks_bit_equal"]) or not out["runs_bit_equal"]:
        raise SystemExit("multicard driven: the ranks or the two runs differ")
    if not out["launched_rank0_bit_equal"]:
        raise SystemExit("multicard driven: rank 0 differs from rank 0 of the launched world 4")
    if torch.device(dev).type == "cuda":
        launches_and_waits_held(
            [{"rank": r, "launches": la, "waits": waits if r == 0 else []}
             for r, la in enumerate(runs[0]["launches"])], len(frames), swaps, n_kf,
            "multicard driven world 4")
    return out


FORWARD_CALLS = 200
DRIVEN_TUNE_AT = 12  # the mono app's tuning file appears at this frame
DRIVEN_TUNING = "sft.lm_iterations: 40\n"


def driven_app(seq, dev, root: str) -> dict:
    """Phase 15's ``mono`` app at world 4: ``cli.main`` in this process
    (rank 0, the one that reads) on an MJPG video of the 24 frames that
    OpenCV writes (where it is installed; else the rendered frames in
    ``load_video``'s place), with ``--tune`` on a file that the reader
    writes before frame ``DRIVEN_TUNE_AT``.  Its files must equal, byte for
    byte, those of an in-process world-4 System given the decoded frames,
    the app's flushes and ``apply_tuning`` after that frame."""
    from defslam_tpu_torch.config import load_raw_yaml
    from defslam_tpu_torch.io import datasets
    from defslam_tpu_torch.viewer import export

    work = os.path.join(root, "driven_app")
    os.makedirs(work)
    frames = [np.clip(f, 0, 255).astype(np.uint8) for f in seq.frames]
    video = os.path.join(work, "seq.avi")
    real = datasets.load_video
    try:
        import cv2

        h, w = frames[0].shape
        vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 7.0, (w, h), isColor=False)
        for f in frames:
            vw.write(f)
        vw.release()
        decoded = list(real(video))
    except ImportError:
        decoded = [(f.astype(np.float32), t / 7.0) for t, f in enumerate(frames)]
    tune = os.path.join(work, "tune.yaml")

    def reader(_src):
        for t, item in enumerate(decoded):
            if t == DRIVEN_TUNE_AT:
                with open(tune, "w") as f:
                    f.write(DRIVEN_TUNING)
            yield item

    def settings(name: str) -> str:
        c = seq.camera
        path = os.path.join(work, f"{name}.yaml")
        n = 0 if torch.device(dev).type == "cuda" else MULTI_WORLD
        with open(path, "w") as f:
            f.write(f"camera:\n  fx: {c.fx}\n  fy: {c.fy}\n  cx: {c.cx}\n  cy: {c.cy}\n"
                    f"  width: {c.width}\n  height: {c.height}\n"
                    f"parallel:\n  enabled: true\n  n_devices: {n}\n"
                    f"output_dir: {os.path.join(work, name)}\n")
        return path

    t0 = time.perf_counter()
    datasets.load_video = reader
    try:
        rc = cli.main(["mono", settings("app"), video, "--tune", tune, "--device", dev.type])
    finally:
        datasets.load_video = real
    out = {"app_s": time.perf_counter() - t0, "frames": len(decoded),
           "video_decoded": video if os.path.exists(video) else None}
    print(flush=True)
    cfg = Config.from_yaml(settings("ref"))
    s = System(cfg, device=dev.type)
    try:
        driven_devices(s, dev)
        for t, (img, ts) in enumerate(decoded):
            s.track_monocular(img, ts)
            cli._progress(s, interactive=True, show=False)
            if t == DRIVEN_TUNE_AT:
                s.apply_tuning(load_raw_yaml(tune))
        s.write_metrics()
        export.snapshot(s, cfg.output_dir)
    finally:
        s.shutdown()
    out["states"] = [r[-1] for r in _app_rows(os.path.join(work, "app"))]
    out["differing_files"] = differing_files(os.path.join(work, "app"), cfg.output_dir)
    print("multicard driven mono app: exit", rc, json.dumps(out), flush=True)
    if rc != 0 or out["differing_files"] or len(out["states"]) != len(decoded):
        raise SystemExit(f"multicard driven: the mono app exited {rc}, files "
                         f"{out['differing_files']}, {len(out['states'])} rows")
    return out


DRIVEN_KILLED = 2  # the rank whose worker phase 15 kills


def process_alive(pid: int) -> bool:
    """Whether process ``pid`` runs (a zombie does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] not in ("Z", "X")
    except FileNotFoundError:
        return False


def driven_failure(frames, cfg: Config, dev) -> dict:
    """Phase 15's failure check: a driven world 4 tracks frames, and its
    worker on ``cuda:2`` is killed 1 s into them; rank 0 must raise
    ``RuntimeError`` naming rank 2 within the collective timeout plus a
    few seconds, no worker process may be left nor the group up, and a
    new System must then come up on the four cards and track."""
    from defslam_tpu_torch.parallel import driver

    pcfg = driven_config(cfg, dev)
    s = System(pcfg, device=torch.device(dev).type)
    driven_devices(s, dev)
    pids = s._driver.pids
    killer = threading.Timer(1.0, os.kill, (pids[DRIVEN_KILLED], signal.SIGKILL))
    out = {"raised": None}
    t0 = time.monotonic()
    killer.start()
    try:
        for t, frame in enumerate(frames):
            s.track_monocular(frame, float(t))
        s.flush()
    except RuntimeError as e:
        out.update(raised=str(e), raise_s=time.monotonic() - t0)
    killer.join()
    time.sleep(0.5)
    out["left"] = [p for p in pids.values() if process_alive(p)]
    out["group_up"] = torch.distributed.is_initialized()
    s2 = System(pcfg, device=torch.device(dev).type)
    try:
        out["new_devices"] = driven_devices(s2, dev)
        for t, frame in enumerate(frames[:3]):
            s2.track_monocular(frame, float(t))
        s2.flush()
        out["new_states"] = [m["state"] for m in s2._metrics]
        out["new_ranks_bit_equal"] = len(set(s2._driver.gather(s2, driver.state_digest))) == 1
    finally:
        s2.shutdown()
    print("multicard driven failure", json.dumps(out), flush=True)
    bound = driver.COLLECTIVE_TIMEOUT_S + driver.EXIT_WAIT_S
    if (out["raised"] is None or f"rank {DRIVEN_KILLED} exited" not in out["raised"]
            or out["raise_s"] > bound or out["left"] or out["group_up"]
            or out["new_states"] != ["OK"] * 3 or not out["new_ranks_bit_equal"]):
        raise SystemExit(f"multicard driven: the failure check failed: {out}")
    return out


def world1_timing(frames, pcfg1: Config, inputs: dict, dev) -> dict:
    """``timing_summary`` of a world-1 run in this process."""
    _, rows = parallel_run(frames, pcfg1, dev, keep_group=True)
    try:
        return timing_summary(rows, sharded.make_group(1), inputs, dev)
    finally:
        parallel.shutdown()


LONGHAUL_RENDER = dict(n_frames=240, height=480, width=640, max_amp=0.07, camera_motion=0.9,
                       seed=9, occlusion=(117, 121), rotation_deg=16, deform_modes=3,
                       brightness_drift=0.1)
LONGHAUL_SLOTS = 12
LONGHAUL_SHAPE = (1536, LONGHAUL_SLOTS * 1536)  # relocalization against the full 12-slot store
LONGHAUL_WARM = 12  # warm-up frames (a keyframe at 10) on a System of their own
LONGHAUL_WINDOWS = ((24, 48), (216, 240))  # frame-time windows [a, b)
LONGHAUL_MEM_AT = (48, 240)  # device memory read after these frames ...
LONGHAUL_MEM_GROWTH = 32 * 2**20  # ... and allowed to grow by at most this
# the JAX package's full-scale gates, met on its TPU (BASELINE.md:137);
# printed beside the card's numbers, not gated here
LONGHAUL_TPU_GATES = {"ate": 0.20, "median_depth_error": 0.10}


def longhaul_config(camera) -> Config:
    """tests/test_stress_longhaul.py at full scale (DEFSLAM_STRESS_FULL=1,
    BASELINE.md:137): 1200 features, 4 levels, 1536 keypoints, 4096
    points, 50 LM iterations, a keyframe every 10 frames, 12 keyframe
    slots; the default protocol (pipelined, depth 2, fused keyframes)."""
    return Config(camera=camera,
                  orb=OrbConfig(n_features=1200, n_levels=4, max_keypoints=1536),
                  sft=SfTConfig(lm_iterations=50), tracking=TrackingConfig(keyframe_period=10),
                  capacity=CapacityConfig(max_map_points=4096, max_keyframes=LONGHAUL_SLOTS),
                  mapping=MappingConfig(points_to_template=70, chi_limit=0.5))


def start_longhaul_render() -> tuple[ProcessPoolExecutor, list]:
    """The long-haul render (~0.9 s a 640x480 frame in numpy) in pieces of
    8 frames on spawned worker processes (the caller holds a CUDA context),
    started before the build so that the render overlaps it and nothing
    else."""
    pool = ProcessPoolExecutor(max(1, min(5, (os.cpu_count() or 2) - 3)),
                               mp_context=multiprocessing.get_context("spawn"))
    n = LONGHAUL_RENDER["n_frames"]
    return pool, [pool.submit(make_sequence, start=a, stop=min(a + 8, n), **LONGHAUL_RENDER)
                  for a in range(0, n, 8)]


def gather_longhaul_render(pool: ProcessPoolExecutor, parts: list) -> SyntheticSequence:
    """The pieces as one sequence, bit-equal to one ``make_sequence`` call."""
    parts = [p.result() for p in parts]
    pool.shutdown()
    return dataclasses.replace(parts[0], **{
        k: np.concatenate([getattr(p, k) for p in parts])
        for k in ("frames", "depths", "poses", "amps", "mode_amps")})


def _window_stats(frame_ms, a: int, b: int) -> dict:
    w = frame_ms[a:b]
    return {"frames": [a, b], "p50_ms": statistics.median(w),
            "p95_ms": float(np.percentile(w, 95)), "max_ms": max(w)}


def _host_rss_mb() -> float:
    with open("/proc/self/status") as f:
        kb = next(int(line.split()[1]) for line in f if line.startswith("VmRSS:"))
    return kb / 1024.0


def longhaul_phase(seq: SyntheticSequence, dev) -> dict:
    """Phase 14: the JAX package's long-haul run at full scale under the
    default protocol, see the module's docstring."""
    n = len(seq.frames)
    occ = LONGHAUL_RENDER["occlusion"]
    cfg = longhaul_config(seq.camera)
    warm = System(cfg, device=dev)
    for t in range(LONGHAUL_WARM):
        warm.track_monocular(seq.frames[t], timestamp=float(t))
    warm.flush()
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    s = System(cfg, device=dev)
    steps = []
    real_step = mapper.keyframe_step

    def counted_step(*a, **k):
        steps.append(s.frame_id)
        return real_step(*a, **k)

    frame_ms, relocs, mem = [], [], {}
    shapes = B1Shapes()
    mapper.keyframe_step = counted_step
    cuda_build.LAUNCHES.clear()
    try:
        with RelocProbe(shapes) as probe:
            for t in range(n):
                n0 = len(probe.calls)
                t0 = time.perf_counter()
                s.track_monocular(seq.frames[t], timestamp=float(t))
                frame_ms.append((time.perf_counter() - t0) * 1e3)
                relocs.append(probe.calls[n0:])
                if t + 1 in LONGHAUL_MEM_AT:
                    mem[t + 1] = {"allocated": torch.cuda.memory_allocated(),
                                  "reserved": torch.cuda.memory_reserved(),
                                  "host_rss_mb": _host_rss_mb()}
            t0 = time.perf_counter()
            s.flush()
            torch.cuda.synchronize()
            frame_ms[-1] += (time.perf_counter() - t0) * 1e3
            # a relocalization's replay of the last frame comes in the flush
            relocs[-1] = relocs[-1] + probe.calls[sum(len(r) for r in relocs):]
    finally:
        mapper.keyframe_step = real_step
        shapes.restore()
    launches = dict(cuda_build.LAUNCHES)

    m = s._metrics
    states = [r["state"] for r in m]
    by_t = {int(r["t"]): r for r in m}
    ok = [r for r in m if r["state"] == "OK" and r["inliers"] > 0]
    first_third = statistics.median([r["inliers"] for r in ok[: len(ok) // 3]])
    last_third = statistics.median([r["inliers"] for r in ok[-len(ok) // 3:]])
    n_kf = sum(1 for r in m if r["keyframe"])
    swaps = sum(1 for r in m[1:] if r["template"])
    fids = s.kfs.frame_id.cpu().numpy()
    anchor = int(fids[s.template_ref_kf])
    recovered = next((t for t in range(occ[1] + 1, n) if by_t[t]["state"] == "OK"), None)
    tracked = sum(1 for r in m[1:] if r["state"] == "OK")
    reloc_calls = [c for r in relocs for c in r]
    reloc_shapes = sorted({tuple(sh) for c in reloc_calls for sh in c["b1_shapes"]})
    ate = gtmod.ate_rmse_trajectory(s.trajectory, seq.poses)
    depth_err, depth_n = gtmod.system_depth_error(s, seq.depths[n - 1])
    feats = extract_features(torch.as_tensor(seq.frames[occ[1] + 1], device=dev), cfg)
    reloc_ms = cuda_ms(lambda: pose_opt.relocalize(feats, s.kfs, s.points, s.K, cfg),
                       reps=5, warmup=1)
    kf_frames = [r["frame"] for r in m[1:] if r["keyframe"]]
    lost = [t for t in range(n) if by_t[t]["state"] != "OK"]
    reloc_ok = [t for t, r in enumerate(relocs) if any(c["ok"] for c in r)]
    out = {
        "states_not_ok": lost, "recovered_at": recovered, "rollbacks": s.n_rollbacks,
        "keyframes": n_kf, "evictions": n_kf - LONGHAUL_SLOTS, "keyframe_frames": kf_frames,
        "keyframe_steps": len(steps), "template_swaps": swaps, "anchor_frame": anchor,
        "inliers_first_third": first_third, "inliers_last_third": last_third,
        "tracked_frames": tracked, "launches": launches,
        "relocalize_calls": len(reloc_calls), "relocalized_ok_frames": reloc_ok,
        "relocalize_b1_shapes": [list(x) for x in reloc_shapes],
        "relocalize_call_ms": [c["ms"] for c in reloc_calls],
        "relocalize_ms": reloc_ms, "ate": ate, "median_depth_error": depth_err,
        "depth_points": depth_n, "tpu_gates_met_by_the_jax_package": LONGHAUL_TPU_GATES,
        "windows": [_window_stats(frame_ms, a, b) for a, b in LONGHAUL_WINDOWS],
        "keyframe_frame_ms": [frame_ms[t] for t in kf_frames],
        "lost_frame_ms": [frame_ms[t] for t in range(occ[0], occ[1] + 1)],
        "relocalized_frame_ms": [frame_ms[t] for t in reloc_ok],
        "recovered_frame_ms": frame_ms[recovered] if recovered is not None else None,
        "memory": mem,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "host_rss_mb": _host_rss_mb(), "frame_ms": frame_ms,
    }
    print("longhaul", json.dumps({k: v for k, v in out.items() if k != "frame_ms"}), flush=True)
    print(f"longhaul accuracy: ATE {ate} (the JAX package met < {LONGHAUL_TPU_GATES['ate']} on "
          f"its TPU), median depth error {depth_err} (< {LONGHAUL_TPU_GATES['median_depth_error']} "
          f"on its TPU); not gated here", flush=True)

    if any(by_t[t]["state"] == "OK" for t in range(occ[0], occ[1] + 1)):
        raise SystemExit(f"longhaul: an occluded frame tracked: {states[occ[0]:occ[1] + 1]}")
    if recovered is None or recovered > occ[1] + 3:
        raise SystemExit(f"longhaul: no recovery within 3 frames of the scene's return "
                         f"(recovered at {recovered})")
    if any(t > recovered for t in lost):
        raise SystemExit(f"longhaul: frames lost after the recovery: {lost}")
    if n_kf - LONGHAUL_SLOTS < 12 or int(s.kfs.valid.sum()) != LONGHAUL_SLOTS:
        raise SystemExit(f"longhaul: {n_kf} keyframes in {LONGHAUL_SLOTS} slots: fewer than "
                         f"12 evictions")
    if swaps < 3:
        raise SystemExit(f"longhaul: {swaps} template swaps (fewer than 3)")
    if anchor <= n // 3:
        raise SystemExit(f"longhaul: the template is anchored at frame {anchor} (<= {n // 3})")
    if not last_third > 0.3 * first_third:
        raise SystemExit(f"longhaul: inliers decayed {first_third} -> {last_third}")
    if launches.get("hamming_matrix", 0) < tracked:
        raise SystemExit(f"longhaul: hamming_matrix launched {launches.get('hamming_matrix', 0)} "
                         f"times for {tracked} tracked frames")
    if list(LONGHAUL_SHAPE) not in out["relocalize_b1_shapes"]:
        raise SystemExit(f"longhaul: no B1 launch at {LONGHAUL_SHAPE} in relocalization "
                         f"({out['relocalize_b1_shapes']})")
    if launches.get("windowed_match", 0) != 2 * len(steps):
        raise SystemExit(f"longhaul: windowed_match launched {launches.get('windowed_match', 0)} "
                         f"times for {len(steps)} keyframe steps (2 each)")
    growth = mem[LONGHAUL_MEM_AT[1]]["allocated"] - mem[LONGHAUL_MEM_AT[0]]["allocated"]
    if growth > LONGHAUL_MEM_GROWTH:
        raise SystemExit(f"longhaul: device memory grew by {growth} B from frame "
                         f"{LONGHAUL_MEM_AT[0]} to {LONGHAUL_MEM_AT[1]}")
    for T in (s.trajectory[-1][1], s.pose.cpu().numpy()):
        if not np.isfinite(T).all() or T.shape != (4, 4):
            raise SystemExit("longhaul: the final pose is not a finite 4x4 matrix")
    return out


def main(mode: str = "full") -> int:
    """``mode``: "full", "kernels", or a phase of ``ALONE``."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    render = start_longhaul_render() if mode in ("full", "longhaul") else None
    try:
        return run(mode, render)
    finally:
        if render is not None:
            render[0].shutdown(cancel_futures=True)


# B1's shapes beyond check_hamming's, checked and timed against the plain
# version: key in the kernels line -> (shape, seed, what calls B1 there)
B1_SHAPES = {"relocalization_shape": (RELOC_SHAPE, 24, "relocalization"),
             "rigid_shape": (RIGID_SHAPE, 25, "rigid tracking"),
             "longhaul_shape": (LONGHAUL_SHAPE, 26, "long-haul relocalization")}
# the phases that run alone after the kernel checks: flag -> (the phase,
# called with the bench render, its Config, the device and the long-haul
# render; B1's extra shapes; whether B2 is checked)
ALONE = {"rigid": (lambda seq, cfg, dev, lh, rates: rigid_phase(dev), ("rigid_shape",), False),
         "parallel": (lambda seq, cfg, dev, lh, rates: parallel_phase(seq, cfg, dev), (), True),
         "longhaul": (lambda seq, cfg, dev, lh, rates: longhaul_phase(lh, dev), ("longhaul_shape",),
                      True),
         "multicard": (lambda seq, cfg, dev, lh, rates: multicard_phase(seq, cfg, dev, rates), (),
                       True)}


def run(mode: str, render) -> int:
    """The phases (see the module's docstring); ``render`` is the long-haul
    phase's render under way."""
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
    # and only relocalization recovers it.  One render serves every phase
    # of this motion; its right view (the left frames are the same with
    # or without it) is the apps phase's stereo dataset.
    seq = make_sequence(n_frames=2 * N_FRAMES, baseline=APPS_BASELINE, **BENCH_MOTION)
    cfg = Config(camera=seq.camera, tracking=TrackingConfig(pipelined=False))

    rates = card_rates()
    print("card_rates", json.dumps(rates), flush=True)
    phase_done("build")
    longhaul_seq = None
    if render is not None:
        longhaul_seq = gather_longhaul_render(*render)
        phase_done("longhaul_render_wait")

    kern_h = check_hamming(dev, rates)
    for key in ALONE[mode][1] if mode in ALONE else B1_SHAPES:
        kern_h[key] = hamming_at_shape(dev, *B1_SHAPES[key])
    kernels = [kern_h]
    if mode not in ALONE or ALONE[mode][2]:
        kernels.append(check_windowed_match(cfg, dev, rates))
    phase_done("kernels")
    if mode == "kernels":
        print(smi, flush=True)
        print(json.dumps({"kernels": kernels}), flush=True)
        return 0
    if mode in ALONE:
        torch.set_num_threads(max(1, os.cpu_count() or 1))
        out = ALONE[mode][0](seq, cfg, dev, longhaul_seq, rates)
        phase_done(mode)
        for k in kernels:
            k["launches_by_path"] = {mode: out["launches"].get(k["name"], 0)}
            k["launches"] = k["launches_by_path"][mode]
        print("phase_s", json.dumps(phase_s), flush=True)
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", f"chip_smoke_{mode}.json"), "w") as f:
            json.dump({"nvidia_smi": smi, "kernels": kernels, mode: out, "phase_s": phase_s}, f,
                      indent=1, default=str)
        print(smi, flush=True)
        print(json.dumps({"kernels": kernels}), flush=True)
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
    pipe = pipelined_slice(seq, dev)
    phase_done("pipelined_slice")
    apps = apps_phase(seq, dev)
    phase_done("apps")
    rigid = rigid_phase(dev)
    phase_done("rigid")
    par = parallel_phase(seq, cfg, dev, single=(gpu_map, map_frame_s))
    phase_done("parallel")
    longhaul = longhaul_phase(longhaul_seq, dev)
    phase_done("longhaul")
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
        "apps": {k: apps[k] for k in ("reader", "reader_calibrated", "app_frame_p50_ms",
                                      "app_frame_max_ms", "in_memory_frame_p50_ms",
                                      "in_memory_frame_max_ms")},
        "rigid": {**{k: rigid[k] for k in ("frame_p50_ms", "frame_max_ms", "init_ms",
                                           "local_ba_ms", "close_loop_ms")},
                  "loop_close_loop_wall_ms": rigid["loop"]["card"]["close_loop_wall_ms"],
                  "loop_global_ba_ms": rigid["loop"]["card"]["global_ba_ms"]},
        "parallel": {k: par[k] for k in (
            "frame_p50_ms", "frame_max_ms", "single_frame_p50_ms", "single_keyframe_frame_ms", "keyframe_frame_ms", "keyframe_ms",
            "keyframe_chain_ms", "sft_world1_ms", "sft_world2_ms", "all_reduce_calls_per_frame",
            "all_reduce_bytes_per_frame")},
        "longhaul": {k: longhaul[k] for k in (
            "windows", "keyframe_frame_ms", "lost_frame_ms", "relocalized_frame_ms",
            "recovered_frame_ms", "relocalize_ms", "rollbacks", "host_rss_mb",
            "max_memory_allocated", "memory", "ate", "median_depth_error")},
    })
    print("timing", json.dumps(timing), flush=True)

    paths = {"tracking": launches_t, "mapping": launches_m,
             "relocalization": reloc["launches"], "occlusion_gt": occl["launches"],
             "pipelined": pipe["launches"], "apps": apps["launches"], "rigid": rigid["launches"],
             "rigid_loop": rigid["loop"]["card"]["launches"], "rigid_cli": rigid["cli"]["launches"],
             "parallel": par["launches"], "longhaul": longhaul["launches"]}
    for k in kernels:
        k["launches_by_path"] = {p: counts.get(k["name"], 0) for p, counts in paths.items()}
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

    reloc.pop("gpu")
    out = {"nvidia_smi": smi, "build_s": build_s, "kernels": kernels, "timing": timing,
           "frames": rows, "mapping_frames": map_rows, "mapping_diags": gpu_map.map_diags,
           "keyframe_card_vs_cpu": kf_row, "relocalization": reloc, "occlusion": occl,
           "stereo_card_vs_cpu": stereo, "pipelined": pipe, "apps": apps, "rigid": rigid,
           "parallel": par, "longhaul": longhaul, "phase_s": phase_s}
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
    if sys.argv[1:2] == ["--parallel-worker"]:
        sys.exit(parallel_worker(int(sys.argv[2]), *sys.argv[3:7]))
    if sys.argv[1:2] == ["--multicard-rank"]:
        sys.exit(multicard_rank(*sys.argv[2:4]))
    flags = [a[2:] for a in sys.argv[1:] if a[2:] in ("kernels", *ALONE)]
    sys.exit(main(flags[0] if flags else "full"))
