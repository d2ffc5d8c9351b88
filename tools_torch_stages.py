"""Repeat the stage times that the port's two kernels feed, to show their
spread within one process on one card.

    python3 tools_torch_stages.py [--repeats 3] [--label NAME]

Run it from the root of the tree to be measured (it imports that tree's
``chip_smoke`` and package).  To compare two trees, copy this file into
each and run them back to back on one card, in the order a, b, b, a.

Per repeat: the 24-frame mapping slice of ``chip_smoke.py`` (two keyframe
steps; ``densify_ms`` and ``keyframe_ms`` of each from CUDA events at the
stage marks), ``match_ms`` (CUDA events around ``match_points_to_frame`` on
the slice's final state, median of 10) and the host microseconds per call of
both kernel wrappers at the paths' shapes (200 calls, no synchronise).  One
unrecorded slice runs first, so that the one-time library set-up of a
process's first keyframe step is in no repeat; it also records the
arguments of its two calls of ``mapper.densify_matches`` (the only code of
the densify stage that reaches a kernel of the port), and every repeat
replays each call 50 times between CUDA events (``densify_matches_ms``,
medians).  Prints one JSON line per repeat and a last line with the minimum,
median and maximum of each figure.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

import chip_smoke
from defslam_tpu_torch.config import Config
from defslam_tpu_torch.io.synthetic import make_sequence
from defslam_tpu_torch.mapping import mapper
from defslam_tpu_torch.ops import hamming, matching, windowed_match


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call of ``fn``, no synchronise between calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--label", default="")
    opts = ap.parse_args()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    seq = make_sequence(n_frames=2 * chip_smoke.N_FRAMES, height=480, width=640, max_amp=0.08,
                        camera_motion=0.35, rotation_deg=20, deform_modes=3,
                        brightness_drift=0.1)
    cfg = Config(camera=seq.camera)
    rng = np.random.default_rng(0)
    a, b = (torch.as_tensor(rng.integers(-2**31, 2**31, (k, 8)).astype(np.int32), device=dev)
            for k in (2048, 1536))
    args, radius = chip_smoke.windowed_cases(cfg, dev)["path"]

    # the unrecorded slice: pays the libraries' set-up, keeps densify's inputs
    densify, calls = mapper.densify_matches, []

    def recording(*densify_args):
        calls.append(densify_args)
        return densify(*densify_args)

    mapper.densify_matches = recording
    chip_smoke.mapping_slice(seq.frames, cfg, dev)
    mapper.densify_matches = densify
    rows = []
    for rep in range(opts.repeats):
        gpu, _, _, steps = chip_smoke.mapping_slice(seq.frames, cfg, dev)
        row = {
            "label": opts.label, "repeat": rep,
            "match_ms": chip_smoke.stage_times(gpu, seq.frames[-1])["match_ms"],
            "densify_ms": [st["densify_ms"] for st in steps],
            "densify_matches_ms": [chip_smoke.cuda_ms(lambda c=c: densify(*c), reps=50)
                                   for c in calls],
            "keyframe_ms": [st["keyframe_ms"] for st in steps],
            "hamming_host_us": host_us(lambda: hamming.hamming_matrix(a, b)),
            "windowed_host_us": host_us(lambda: windowed_match.windowed_match(
                *args, radius, matching.INVALID)),
        }
        print("stages", json.dumps(row), flush=True)
        rows.append(row)

    def spread(values):
        return [min(values), statistics.median(values), max(values)]

    n_steps = len(rows[0]["densify_ms"])
    summary = {
        "label": opts.label, "nvidia_smi": smi, "repeats": opts.repeats,
        "min_median_max": {
            "match_ms": spread([r["match_ms"] for r in rows]),
            "densify_ms": [spread([r["densify_ms"][k] for r in rows]) for k in range(n_steps)],
            "densify_matches_ms": [spread([r["densify_matches_ms"][k] for r in rows])
                                   for k in range(n_steps)],
            "keyframe_ms": [spread([r["keyframe_ms"][k] for r in rows]) for k in range(n_steps)],
            "hamming_host_us": spread([r["hamming_host_us"] for r in rows]),
            "windowed_host_us": spread([r["windowed_host_us"] for r in rows]),
        },
    }
    print("stages_summary", json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
