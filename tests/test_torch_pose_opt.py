"""Pose-only optimization and relocalization of the PyTorch port against
the JAX package (``tracking/pose_opt.py``), on the CPU, where the port's
Hamming matrix is the plain version of kernel B1.

Tolerances and why:

- ``solve_pose`` on the same seeded points, observations and gross
  outliers: T within 1e-4 (float32 LM over 40 iterations from the same
  start, the same Jacobian through ``se3_exp``), inlier masks equal.
- ``relocalize`` from the reference's own state (``convert.
  state_from_numpy``): vote counts, per-slot matches and candidate slots
  exactly (integer Hamming distances and the same tie rules), ok equal,
  ``n_inliers`` within 1 and T within 1e-3 (a chi2 gate at the margin can
  flip one point between the float32 solves).
- The System runs (the garbage-frame interruption of
  ``tests/test_relocalize.py``, and a pose knocked off so that only
  relocalization can recover the next frame): per-frame tracking states
  and keyframe flags equal, match counts within 1, inlier counts within 2
  (the free-run tolerances of ``tests/test_torch_system.py``).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from defslam_tpu.config import CapacityConfig, Config, OrbConfig, SfTConfig, TrackingConfig
from defslam_tpu.frontend import extract_features as jextract
from defslam_tpu.geometry import camera as jcam
from defslam_tpu.geometry import se3 as jse3
from defslam_tpu.io.synthetic import make_sequence
from defslam_tpu.mapstore.state import KeyframeStore, PointStore
from defslam_tpu.ops import matching as jmatching
from defslam_tpu.system import System as JaxSystem
from defslam_tpu.tracking import pose_opt as jpose
from defslam_tpu_torch.config import Config as TConfig
from defslam_tpu_torch.convert import config_from_dict, state_from_numpy, to_numpy_dict
from defslam_tpu_torch.ops.fast import stable_topk
from defslam_tpu_torch.system import System, TrackingState
from defslam_tpu_torch.tracking import pose_opt

torch.set_num_threads(2)

K_NP = np.array([[400.0, 0, 160.0], [0, 400.0, 120.0], [0, 0, 1.0]], np.float32)


def test_solve_pose_matches_reference():
    rng = np.random.default_rng(0)
    pts = (rng.uniform(-0.5, 0.5, (120, 3)) + [0, 0, 2.0]).astype(np.float32)
    T_true = jse3.se3_exp(jnp.asarray([0.1, -0.05, 0.08, 0.04, -0.06, 0.02]))
    obs = np.asarray(jcam.project(jnp.asarray(K_NP), jse3.transform(T_true, jnp.asarray(pts))))
    obs = (obs + rng.normal(0, 0.4, obs.shape)).astype(np.float32)
    obs[:15] += 40.0  # gross outliers
    isg = rng.uniform(0.5, 1.0, 120).astype(np.float32)
    mask = rng.uniform(size=120) < 0.95
    ref = jpose.solve_pose(jnp.asarray(K_NP), jnp.eye(4), jnp.asarray(pts), jnp.asarray(obs),
                           jnp.asarray(isg), jnp.asarray(mask), Config())
    got = pose_opt.solve_pose(torch.tensor(K_NP), torch.eye(4), torch.tensor(pts),
                              torch.tensor(obs), torch.tensor(isg), torch.tensor(mask), TConfig())
    assert got.T.dtype == torch.float32
    assert np.abs(got.T.numpy() - np.asarray(ref.T)).max() <= 1e-4
    np.testing.assert_array_equal(got.inlier.numpy(), np.asarray(ref.inlier))
    assert int(got.n_inliers) == int(ref.n_inliers) > 90
    assert not got.inlier[:15].any()


def test_solve_pose_lanes_are_independent():
    """The batched form: each lane equals its own unbatched solve (to the
    rounding of batched reductions), and a lane with no observations keeps
    its start pose."""
    rng = np.random.default_rng(3)
    pts = torch.tensor((rng.uniform(-0.5, 0.5, (2, 80, 3)) + [0, 0, 2.0]).astype(np.float32))
    T_true = jse3.se3_exp(jnp.asarray([0.05, 0.02, -0.04, 0.03, 0.01, -0.02]))
    obs = np.asarray(jcam.project(jnp.asarray(K_NP), jse3.transform(T_true, jnp.asarray(pts[0]))))
    obs = torch.tensor((obs + rng.normal(0, 0.3, obs.shape)).astype(np.float32))
    isg = torch.ones(80)
    mask = torch.ones((2, 80), dtype=torch.bool)
    mask[1] = False
    T0 = torch.eye(4).repeat(2, 1, 1)
    T0[1, :3, 3] = torch.tensor([0.1, 0.2, 0.3])
    cfg = TConfig()
    both = pose_opt.solve_pose(torch.tensor(K_NP), T0, pts, obs, isg, mask, cfg)
    one = pose_opt.solve_pose(torch.tensor(K_NP), T0[0], pts[0], obs, isg, mask[0], cfg)
    assert torch.allclose(both.T[0], one.T, atol=1e-5)
    assert torch.equal(both.inlier[0], one.inlier)
    assert torch.equal(both.T[1], T0[1]) and int(both.n_inliers[1]) == 0


def _cfg(cam):
    # the configuration of tests/test_relocalize.py
    return Config(
        camera=cam,
        orb=OrbConfig(n_features=400, n_levels=3, max_keypoints=512),
        sft=SfTConfig(lm_iterations=20),
        tracking=TrackingConfig(keyframe_period=4),
        capacity=CapacityConfig(max_map_points=1024, max_keyframes=8),
    )


@pytest.fixture(scope="module")
def mapped():
    """The JAX package's state after 8 frames (keyframes at 0 and 4), as
    numpy arrays, with the sequence and both configs."""
    seq = make_sequence(n_frames=14, height=120, width=160, max_amp=0.05)
    cfg = _cfg(seq.camera)
    js = JaxSystem(cfg)
    for t in range(8):
        js.track_monocular(seq.frames[t], float(t))
    js.flush()
    state = to_numpy_dict(kfs=js.kfs, points=js.points)
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    # the port's runs here use the synchronous protocol: rows read right after each call
    tcfg = dataclasses.replace(tcfg, tracking=dataclasses.replace(tcfg.tracking, pipelined=False))
    return seq, cfg, tcfg, js, state


def _reference_votes(feats, kfs, cfg):
    """The JAX package's per-slot scoring, as ``relocalize`` computes it."""
    def score(slot):
        d = jmatching.masked_hamming(feats.desc, kfs.desc[slot], feats.valid,
                                     kfs.kp_valid[slot] & (kfs.point_id[slot] >= 0))
        m = jmatching.best_match(d, max_dist=cfg.tracking.match_th_low, nn_ratio=0.75,
                                 mutual=True)
        return jnp.sum((m.idx >= 0) & kfs.valid[slot]), m.idx

    votes, idx = jax.lax.map(score, jnp.arange(kfs.valid.shape[0]))
    return np.asarray(votes), np.asarray(idx).T


def _relocalize_both(seq, cfg, tcfg, kfs_np, points_np, frame):
    jf = jextract(jnp.asarray(frame), cfg)
    jkfs = KeyframeStore(**{f: jnp.asarray(kfs_np[f"kfs.{f}"]) for f in KeyframeStore._fields})
    jpts = PointStore(**{f: jnp.asarray(points_np[f"points.{f}"]) for f in PointStore._fields})
    ref = jpose.relocalize(jf, jkfs, jpts, jnp.asarray(cfg.camera.K), cfg)
    ref_votes, ref_idx = _reference_votes(jf, jkfs, cfg)
    ms = state_from_numpy({**to_numpy_dict(feats=jf), **kfs_np, **points_np}, "cpu")
    K = torch.as_tensor(tcfg.camera.K)
    votes, idx = pose_opt.keyframe_votes(ms.feats, ms.kfs, tcfg)
    got = pose_opt.relocalize(ms.feats, ms.kfs, ms.points, K, tcfg)
    return ref, ref_votes, ref_idx, got, votes.numpy(), idx.numpy()


def _assert_relocalizations_agree(ref, ref_votes, ref_idx, got, votes, idx):
    np.testing.assert_array_equal(votes, ref_votes)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_array_equal(stable_topk(torch.as_tensor(votes), 5)[1].numpy(),
                                  np.asarray(jax.lax.top_k(jnp.asarray(ref_votes), 5)[1]))
    ok_r, T_r, n_r = ref
    ok_t, T_t, n_t = got
    assert bool(ok_t) == bool(ok_r)
    assert abs(int(n_t) - int(n_r)) <= 1, (int(n_t), int(n_r))
    assert np.abs(T_t.numpy() - np.asarray(T_r)).max() <= 1e-3


def test_relocalize_matches_reference(mapped):
    seq, cfg, tcfg, _, state = mapped
    kfs_np = {k: v for k, v in state.items() if k.startswith("kfs.")}
    pts_np = {k: v for k, v in state.items() if k.startswith("points.")}
    out = _relocalize_both(seq, cfg, tcfg, kfs_np, pts_np, seq.frames[10])
    _assert_relocalizations_agree(*out)
    ref, ref_votes = out[0], out[1]
    assert bool(ref[0]) and int(ref[2]) >= 100  # a real recovery, not a vacuous one
    assert (ref_votes[:2] > 0).all() and (ref_votes[2:] == 0).all()


def test_relocalize_vote_tie(mapped):
    """Slot 5 holds a copy of slot 1: the two tie on votes, and the
    candidate order (equal votes in slot order) and the chosen lane (the
    first with the most inliers) must follow the reference's rules."""
    seq, cfg, tcfg, _, state = mapped
    kfs_np = {k: np.array(v) for k, v in state.items() if k.startswith("kfs.")}
    for k in kfs_np:
        kfs_np[k][5] = kfs_np[k][1]
    pts_np = {k: v for k, v in state.items() if k.startswith("points.")}
    out = _relocalize_both(seq, cfg, tcfg, kfs_np, pts_np, seq.frames[9])
    votes = out[4]
    assert votes[5] == votes[1] > 0
    _assert_relocalizations_agree(*out)


def _run_states(s, frames, flush=False):
    for f, ts in frames:
        s.track_monocular(f, ts)
    if flush:
        s.flush()
    return s._metrics


def _assert_runs_agree(ref_rows, port_rows):
    assert len(ref_rows) == len(port_rows)
    for mj, mt in zip(ref_rows, port_rows):
        assert mt["state"] == mj["state"] and mt["keyframe"] == mj["keyframe"], (mj, mt)
        assert abs(mt["matches"] - mj["matches"]) <= 1, (mj, mt)
        assert abs(mt["inliers"] - mj["inliers"]) <= 2, (mj, mt)


def test_relocalization_after_interruption_matches_reference(mapped):
    """``tests/test_relocalize.py``'s run in both packages: 8 frames, a
    frame of noise (LOST, without a map reset), then the sequence again."""
    seq, cfg, tcfg, _, _ = mapped
    garbage = np.random.default_rng(1).uniform(0, 255, seq.frames[0].shape).astype(np.float32)
    frames = ([(seq.frames[t], float(t)) for t in range(8)]
              + [(garbage, 99.0), (seq.frames[8], 100.0), (seq.frames[9], 101.0)])
    ref = _run_states(JaxSystem(cfg), frames, flush=True)
    port = System(tcfg, device="cpu")
    rows = _run_states(port, frames)
    _assert_runs_agree(ref, rows)
    assert [m["state"] for m in rows[8:]] == ["LOST", "OK", "OK"]
    assert int(port.kfs.valid.sum()) >= 2, "map was reset"


def test_relocalization_recovers_a_lost_pose(mapped, tmp_path):
    """From the reference's checkpoint after 8 frames, the pose is knocked
    0.5 off in both packages: frame 8 cannot be tracked from it, and only
    relocalization against the stored keyframes brings it back."""
    seq, cfg, tcfg, js, _ = mapped
    ckpt = str(tmp_path / "state.npz")
    js.save_state(ckpt)
    ref = JaxSystem(cfg)
    ref.load_state(ckpt)
    port = System(tcfg, device="cpu")
    port.load_state(ckpt)
    kick = np.eye(4, dtype=np.float32)
    kick[:3, 3] = [0.5, -0.3, 0.2]
    ref.pose = ref.prev_pose = jnp.asarray(kick) @ ref.pose
    port.pose = port.prev_pose = torch.as_tensor(kick) @ port.pose
    calls = []
    real = pose_opt.relocalize

    def counted(*args):
        out = real(*args)
        calls.append((bool(out[0]), int(out[2])))
        return out

    pose_opt.relocalize = counted
    try:
        frames = [(seq.frames[t], float(t)) for t in (8, 9)]
        ref_rows = _run_states(ref, frames, flush=True)[-2:]
        rows = _run_states(port, frames)[-2:]
    finally:
        pose_opt.relocalize = real
    _assert_runs_agree(ref_rows, rows)
    assert [m["state"] for m in rows] == ["OK", "OK"]
    assert calls and calls[0][0] and calls[0][1] >= cfg.tracking.min_inliers_ok
    assert port.get_tracking_state() == TrackingState.OK
