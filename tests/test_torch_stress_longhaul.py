"""The JAX package's long-haul stress run (tests/test_stress_longhaul.py)
on the PyTorch port, on the CPU, at that file's CPU scale: 240 frames at
320x240 (handheld 6-DoF motion over 0.9 world units, three deformation
modes, brightness drift, frames 117-121 blank, seed 9), 600 features, 4
levels, 768 keypoints, 2048 points, 25 LM iterations, a keyframe every 10
frames into a 12-slot store (24 keyframes: 12 evictions), the default
pipelined protocol.  Only the port runs here.

The three structural tests keep the JAX file's gates.  The other two hold
the port to the JAX package's own run on this seed, measured on the CPU by

    JAX_PLATFORMS=cpu python tools_torch_longhaul.py \
        --runs jax,probe:1,probe:2,probe:3,probe:4,port:4 \
        --reference tests/data/longhaul_jax_window.json

against four 1e-7 probes of it (the template after frame 0 scaled by
1 + N(0, 1e-7), numpy seeds 1-4), the repo's measure of the
ill-conditioned SfT's own sensitivity (ROADMAP C):

- frame by frame before frame 70, the first frame where a probe's row
  parts from the JAX run's (the window file): states, keyframe and
  template flags, the slot each keyframe takes and the store's frame ids
  and valid flags equal, and the pose within 3x the median of the four
  probes' gaps to the JAX pose at that frame;
- at the end, ATE and the median depth error within 3x the smallest of the
  four probes' moves of the JAX run's numbers, and the depth error under
  the JAX file's own 0.08 gate.  The JAX file's 0.15 ATE gate is not used:
  the JAX package misses it (0.1536, ROADMAP C).

The last third's inliers and the count of template swaps are not held to
the JAX run: the probes move them by 159.5 / 35.0 / 13.5 / 162.5 and
10 / 0 / 0 / 11, so 3x the smallest move fails any run that parts from the
JAX run's swap sequence (the JAX probes of seeds 1 and 4 fail it too),
and 3x a larger one cannot fail.  Their JAX file gates stay in the
structural tests.

torch runs on 4 threads here (set in the fixture, restored after): the
port's run is deterministic for a thread count and moves with it as the
JAX run moves with a probe.  Measured by the same tool (``port:1`` /
``port:2`` / ``port:4``): ATE 0.1986 / 0.2001 / 0.1741, median depth
error 0.0330 / 0.0364 / 0.0353, last-third inliers 123.5 / 76.0 / 83.5
against first thirds 257.0 / 253.5 / 255.0, template swaps 21 / 17 / 19.
On 2 threads the port parts from the JAX rows at frame 60, whose template
swap the JAX run's registration rejects and the port's accepts, ten frames
before the first probe parts; it then misses the inlier gate of
test_matches_stay_healthy by 0.05 (76.0 against 76.05), as the JAX probes
of seeds 1 and 4 miss it by 58 and 63.  On 1 and 4 threads the port holds
every row of the window.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from defslam_tpu_torch.config import (CapacityConfig, Config, MappingConfig, OrbConfig,
                                      SfTConfig, TrackingConfig)
from defslam_tpu_torch.groundtruth import gt
from defslam_tpu_torch.io.synthetic import make_sequence
from defslam_tpu_torch.system import System

N_FRAMES = 240
OCCLUSION = (117, 121)  # 5 fully blank frames mid-sequence
THREADS = 4
# tools_torch_longhaul.py (module docstring): the JAX package's run on this
# seed, and the same run with its template perturbed by 1e-7 (numpy seeds 1-4)
JAX_RUN = dict(ate=0.15355830246237953, median_depth_error=0.03980799188887656)
JAX_PROBES = [dict(ate=0.24938299270571357, median_depth_error=0.12669945779233768),
              dict(ate=0.20917168182856272, median_depth_error=0.049859823799328545),
              dict(ate=0.18372954671552552, median_depth_error=0.06886111762630245),
              dict(ate=0.2224280411548884, median_depth_error=0.0888040495260037)]
WINDOW = os.path.join(os.path.dirname(__file__), "data", "longhaul_jax_window.json")


def _within_probes(name: str, value: float) -> None:
    bound = 3 * min(abs(p[name] - JAX_RUN[name]) for p in JAX_PROBES)
    assert abs(value - JAX_RUN[name]) <= bound, (name, value, JAX_RUN[name], bound)


@pytest.fixture(scope="module")
def stress_run():
    seq = make_sequence(
        n_frames=N_FRAMES, height=240, width=320, max_amp=0.07,
        camera_motion=0.9, seed=9, occlusion=OCCLUSION,
        rotation_deg=16, deform_modes=3, brightness_drift=0.1,
    )
    cfg = Config(
        camera=seq.camera,
        orb=OrbConfig(n_features=600, n_levels=4, max_keypoints=768),
        sft=SfTConfig(lm_iterations=25),
        tracking=TrackingConfig(keyframe_period=10),
        capacity=CapacityConfig(max_map_points=2048, max_keyframes=12),
        mapping=MappingConfig(points_to_template=70, chi_limit=0.5),
    )
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    kf_fid, kf_valid = [], []  # the store after each call
    try:
        sys_ = System(cfg, device="cpu")
        for t in range(N_FRAMES):
            sys_.track_monocular(seq.frames[t], timestamp=float(t))
            kf_fid.append(sys_.kfs.frame_id.tolist())
            kf_valid.append(sys_.kfs.valid.tolist())
        sys_.flush()
        depth_err, n_points = gt.system_depth_error(sys_, seq.depths[N_FRAMES - 1])
    finally:
        torch.set_num_threads(threads)
    return SimpleNamespace(system=sys_, seq=seq, depth_err=depth_err, n_points=n_points,
                           kf_fid=kf_fid, kf_valid=kf_valid)


def _thirds(metrics):
    ok = [m for m in metrics if m["state"] == "OK" and m["inliers"] > 0]
    return (np.median([m["inliers"] for m in ok[: len(ok) // 3]]),
            np.median([m["inliers"] for m in ok[-len(ok) // 3:]]))


def test_occlusion_recovered_without_reset(stress_run):
    """The 5 blank frames go LOST; every frame after the occlusion window
    clears tracks OK again within 3 frames, and the map survives
    (relocalization, not re-initialization)."""
    sys_ = stress_run.system
    by_t = {m["t"]: m for m in sys_._metrics}
    for t in range(OCCLUSION[0], OCCLUSION[1] + 1):
        assert by_t[float(t)]["state"] != "OK", f"frame {t} tracked a blank"
    recovered = next((t for t in range(OCCLUSION[1] + 1, N_FRAMES)
                      if by_t[float(t)]["state"] == "OK"), None)
    assert recovered is not None and recovered <= OCCLUSION[1] + 3, (
        f"no recovery until {recovered}")
    lost_after = [t for t in range(recovered, N_FRAMES) if by_t[float(t)]["state"] != "OK"]
    assert not lost_after, f"non-recovered LOST frames: {lost_after}"
    assert bool(sys_.kfs.valid.all())  # the store is full
    # no re-initialization: only frame 0's row has no tracked matches
    assert [m["t"] for m in sys_._metrics if m["state"] == "OK" and m["matches"] == 0] == [0.0]


def test_eviction_churn_and_retemplating(stress_run):
    sys_ = stress_run.system
    n_kf_created = sum(1 for m in sys_._metrics if m["keyframe"])
    cap = sys_.cfg.capacity.max_keyframes
    assert n_kf_created - cap >= 3, (
        f"{n_kf_created} keyframes never overflowed the {cap}-slot store 3x")
    n_templates = sum(1 for m in sys_._metrics if m["template"])
    assert n_templates >= 3, f"re-templating fired only {n_templates}x"
    # the active template anchors to a late keyframe (viewpoint moved on)
    assert sys_.template_ref_kf >= 0
    anchor_fid = int(sys_.kfs.frame_id[sys_.template_ref_kf])
    assert anchor_fid > N_FRAMES // 3


def test_first_frames_match_reference(stress_run):
    """Before frame 70, where a 1e-7 probe of the JAX run first parts from
    it: states, flags, the slot each keyframe takes and the store equal the
    JAX run's, and the pose is within 3x the median probe gap (module
    docstring)."""
    with open(WINDOW) as f:
        rows = json.load(f)["rows"]
    assert len(rows) == 70
    sys_ = stress_run.system
    poses = dict(sys_.trajectory)
    for r in rows:
        t = r["t"]
        m = sys_._metrics[t]
        n = len(r["kf_fid"])
        prev = ((stress_run.kf_fid[t - 1], stress_run.kf_valid[t - 1]) if t
                else ([-1] * n, [False] * n))
        now = (stress_run.kf_fid[t], stress_run.kf_valid[t])
        slot = next((i for i in range(n) if (now[0][i], now[1][i]) != (prev[0][i], prev[1][i])),
                    -1)
        got = (m["state"], bool(m["keyframe"]), bool(m["template"]), slot, *now)
        want = (r["state"], r["keyframe"], r["template"], r["slot"], r["kf_fid"], r["kf_valid"])
        assert got == want, (t, got, want)
        gap = float(np.abs(np.asarray(poses[float(t)]) - np.asarray(r["pose"])).max())
        assert gap <= r["pose_bound"], (t, gap, r["pose_bound"])


def test_final_accuracy_matches_reference(stress_run):
    """ATE and the final median depth error, each within 3x the smallest of
    the four 1e-7 probes' moves of the JAX package's run on this seed; the
    depth error also under the JAX file's own gate."""
    run = stress_run
    assert run.n_points >= 50
    _within_probes("ate", gt.ate_rmse_trajectory(run.system.trajectory, run.seq.poses))
    _within_probes("median_depth_error", run.depth_err)
    assert run.depth_err < 0.08, f"median depth error {run.depth_err:.3f}"


def test_matches_stay_healthy(stress_run):
    """Inlier counts must not decay over the run (map maintenance works:
    densification and re-templating keep the tracked set populated)."""
    first_third, last_third = _thirds(stress_run.system._metrics)
    assert last_third > 0.3 * first_third, f"inliers decayed {first_third} -> {last_third}"
