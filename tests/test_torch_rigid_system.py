"""The port's rigid ORB-SLAM2 mode (``rigid/system.py``,
``rigid/loop_closing.py``, ``cli mono --orbslam``) against the JAX
package's, on the CPU: the run of ``tests/test_rigid_system.py``'s
``rigid_run`` fixture through both packages, one keyframe step from the
reference's own state, and the loop-closing pipeline on its ``_loop_world``
carried across by ``convert.py``.  The port's RANSAC uniforms are patched
to ``jax.random.uniform(PRNGKey(cfg.seed), (200, 8))``, so both packages
draw the same sample sets.

Tolerances and why:

- The free run (14 frames): per-frame states and the initialization frame
  equal, keyframe counts equal, point counts within 10%, and each pose
  within max(1e-4, the reference pose's own distance from SO(3)).  The
  JAX package's rigid mode composes its motion model from poses it never
  puts back onto SE(3), and the transpose-inverse multiplies their float32
  drift by ~2.4 a frame (1e-2 by frame 13 here); the port re-orthonormalizes
  each solved pose (``se3.orthonormalize``, as both packages' deformable
  tracker does), so the two part by about that drift (5.5e-3 at frame 13),
  and the last keyframe triangulates from poses that far apart.
- One keyframe step (frame 9, where the reference's drift is 3e-4) from
  the reference's state after frame 8 (``convert.load_rigid_state``): the
  point and observation counts after every sub-step (the triangulations,
  fusions, point culling, local BA, keyframe culling) equal, and the pose
  within 1e-4 of the reference's put back onto SE(3) (the pose LM's
  tolerance, tests/test_torch_pose_opt.py).
- Loop closing on the same world: the candidate, its votes and matches
  equal; after ``close_loop`` the observation tables and point validity
  equal, poses and points within 1e-3 (Horn's SVD, a 20-iteration Sim(3)
  LM and a 56-unknown pose-graph LM); after ``fuse_and_global_ba`` the
  merge count, tables and validity equal, poses within 1e-3.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from defslam_tpu.config import CapacityConfig, Config, OrbConfig, TrackingConfig
from defslam_tpu.geometry import se3 as jse3
from defslam_tpu.io.synthetic import make_sequence
from defslam_tpu.rigid import loop_closing as jloop
from defslam_tpu.rigid import system as jsystem
from defslam_tpu.rigid import triangulation as jtri
from defslam_tpu_torch import cli
from defslam_tpu_torch.geometry import se3
from defslam_tpu_torch.convert import (config_from_dict, load_rigid_state, rigid_state_to_numpy,
                                       state_from_numpy, to_numpy_dict)
from defslam_tpu_torch.io import datasets
from defslam_tpu_torch.rigid import loop_closing
from defslam_tpu_torch.rigid import system as rsystem
from defslam_tpu_torch.rigid import triangulation as tri
from test_rigid_system import _loop_world

torch.set_num_threads(2)

N_FRAMES = 14
STEP = 9  # the keyframe frame replayed from the reference's state
SUBSTEPS = ("_triangulate_pair", "_fuse_pair", "_cull_points", "_local_ba", "_cull_keyframe")


def _jax_uniforms(seed):
    return torch.as_tensor(np.array(jax.random.uniform(jax.random.PRNGKey(seed), (200, 8))))


def _counts(s):
    return (int(np.asarray(s.points.valid).sum()), int((np.asarray(s.kfs.point_id) >= 0).sum()),
            int(np.asarray(s.kfs.valid).sum()))


def _logged(mp, cls, log):
    """Record the map's counts after each mapping sub-step of ``cls``."""
    for name in SUBSTEPS:
        def wrapped(self, *a, _orig=getattr(cls, name), _name=name, **k):
            out = _orig(self, *a, **k)
            log.append((_name, a, _counts(self)))
            return out
        mp.setattr(cls, name, wrapped)


@pytest.fixture(scope="module")
def runs():
    seq = make_sequence(n_frames=N_FRAMES, height=240, width=320, max_amp=0.0, camera_motion=0.5, seed=3)
    cfg = Config(
        camera=seq.camera,
        orb=OrbConfig(n_features=600, n_levels=4, max_keypoints=768),
        tracking=TrackingConfig(keyframe_period=4),
        capacity=CapacityConfig(max_map_points=2048, max_keyframes=8),
    )
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    out = {"seq": seq, "log_port": []}
    jlog = out["log_jax"] = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rsystem, "ransac_uniforms", _jax_uniforms)
        js = jsystem.RigidSystem(cfg)
        jrows = []
        for t in range(N_FRAMES):
            if t == STEP:
                out["state"] = rigid_state_to_numpy(js)
                _logged(mp, jsystem.RigidSystem, jlog)
            p = js.track_monocular(seq.frames[t], float(t))
            jrows.append((js.state.name, None if p is None else np.asarray(p), _counts(js)))
            if t == STEP:
                out["log_jax"] = list(out["log_jax"])  # this frame's sub-steps only
        ts = rsystem.RigidSystem(tcfg, device="cpu")
        prows = []
        for t in range(N_FRAMES):
            p = ts.track_monocular(seq.frames[t], float(t))
            prows.append((ts.state.name, p, _counts(ts)))
        step = rsystem.RigidSystem(tcfg, device="cpu")
        load_rigid_state(step, out["state"])
        _logged(mp, rsystem.RigidSystem, out["log_port"])
        out["step_pose"] = step.track_monocular(seq.frames[STEP], float(STEP))
    out.update(jrows=jrows, prows=prows, port=ts)
    return out


def test_rigid_run_states_and_init_frame_match_reference(runs):
    js = [r[0] for r in runs["jrows"]]
    assert [r[0] for r in runs["prows"]] == js
    first = [r[1] is not None for r in runs["prows"]].index(True)
    assert first == [r[1] is not None for r in runs["jrows"]].index(True) <= 8
    assert all(s == "OK" for s in js[first:])


def test_rigid_run_counts_match_reference(runs):
    for (_, _, cj), (_, _, cp) in zip(runs["jrows"], runs["prows"]):
        assert cp[2] == cj[2]  # keyframes
        assert abs(cp[0] - cj[0]) <= 0.1 * cj[0]
    sys_ = runs["port"]
    assert int(sys_.points.valid.sum()) > int((sys_.kfs.point_id[0] >= 0).sum())
    assert int(sys_.kfs.valid.sum()) >= 3


def test_rigid_run_trajectory_matches_reference(runs):
    gaps = [np.abs(rp[1] - rj[1]).max() for rj, rp in zip(runs["jrows"], runs["prows"])
            if rj[1] is not None]
    drift = [np.abs(rj[1][:3, :3] @ rj[1][:3, :3].T - np.eye(3)).max() for rj in runs["jrows"]
             if rj[1] is not None]
    for g, d in zip(gaps, drift):
        assert g <= max(1e-4, d), (gaps, drift)
    # the JAX test's monocular ATE after a similarity alignment
    seq = runs["seq"]
    poses = [(t, r[1]) for t, r in enumerate(runs["prows"]) if r[1] is not None]
    est = np.stack([np.linalg.inv(p)[:3, 3] for _, p in poses])
    gt = np.stack([np.asarray(jse3.inverse(jnp.asarray(seq.poses[t])))[:3, 3] for t, _ in poses])
    s, R, t = (np.asarray(v) for v in jse3.horn_alignment(jnp.asarray(est), jnp.asarray(gt),
                                                           jnp.ones(len(poses))))
    ate = np.sqrt(np.mean(np.sum((s * est @ R.T + t - gt) ** 2, axis=1)))
    assert ate < 0.05


def test_rigid_keyframe_step_from_reference_state(runs):
    log_j, log_p = runs["log_jax"], runs["log_port"]
    assert [e[0] for e in log_j].count("_triangulate_pair") >= 2
    assert log_p == log_j
    # the port puts the solved pose back onto SE(3); the reference keeps it
    jpose = se3.orthonormalize(torch.as_tensor(runs["jrows"][STEP][1])).numpy()
    assert np.abs(runs["step_pose"] - jpose).max() <= 1e-4


def test_rigid_system_defaults_to_cuda():
    cfg = rsystem.Config()
    if torch.cuda.is_available():
        assert rsystem.RigidSystem(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            rsystem.RigidSystem(cfg)


# ------------------------------------------------------------ loop closing


@pytest.fixture(scope="module")
def loop():
    cfg, K, kfs, pts, T_true, X, X_dup = _loop_world()
    sig2 = jtri.level_sigma2(cfg.orb.n_levels, cfg.orb.scale_factor)
    closed, kfs_g, pts_g, cand = jloop.close_loop(kfs, pts, 7, K, cfg)
    kfs_f, pts_f, n_fused = jloop.fuse_and_global_ba(kfs_g, pts_g, 7, cand, K, sig2, cfg)
    st = state_from_numpy(to_numpy_dict(kfs=kfs, points=pts), "cpu")
    return dict(cfg=cfg, tcfg=config_from_dict(dataclasses.asdict(cfg)), K=K, kfs=kfs, pts=pts,
                T_true=T_true, X=X, closed=(closed, kfs_g, pts_g, cand),
                fused=(kfs_f, pts_f, n_fused), tkfs=st.kfs, tpts=st.points,
                tK=torch.as_tensor(np.asarray(K)))


@pytest.mark.parametrize("slot,min_votes", [(7, 40), (6, 5), (0, 40)])
def test_detect_loop_matches_reference(loop, slot, min_votes):
    ref = jloop.detect_loop(loop["kfs"], jnp.asarray(slot, jnp.int32), loop["K"], loop["cfg"],
                            min_votes=min_votes)
    got = loop_closing.detect_loop(loop["tkfs"], slot, loop["tcfg"], min_votes=min_votes)
    assert bool(got.found) == bool(ref.found)
    assert int(got.kf) == int(ref.kf)
    assert int(got.votes) == int(ref.votes)
    np.testing.assert_array_equal(got.match_idx.numpy(), np.asarray(ref.match_idx))
    if slot == 7:
        assert bool(got.found) and int(got.kf) == 0 and int(got.votes) > 80


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol)


def test_close_loop_matches_reference(loop):
    closed, kfs_g, pts_g, cand = loop["closed"]
    c2, tkfs, tpts, tcand = loop_closing.close_loop(loop["tkfs"], loop["tpts"], 7, loop["tK"],
                                                    loop["tcfg"])
    assert c2 == closed is True and tcand == cand == 0
    np.testing.assert_array_equal(tkfs.point_id.numpy(), np.asarray(kfs_g.point_id))
    np.testing.assert_array_equal(tpts.valid.numpy(), np.asarray(pts_g.valid))
    np.testing.assert_array_equal(tpts.n_obs.numpy(), np.asarray(pts_g.n_obs))
    _close(tkfs.pose.numpy(), kfs_g.pose, 1e-3)
    _close(tpts.xyz.numpy(), pts_g.xyz, 1e-3)
    # the JAX test's criteria: the drift is corrected, the points follow
    T_true, X = loop["T_true"], loop["X"]
    err_before = np.linalg.norm(np.asarray(loop["kfs"].pose[7])[:3, 3] - T_true[7][:3, 3])
    assert np.linalg.norm(tkfs.pose[7, :3, 3].numpy() - T_true[7][:3, 3]) < 0.5 * err_before
    np.testing.assert_allclose(tpts.xyz[:100].numpy(), X, atol=1e-3)


def test_fuse_and_global_ba_matches_reference(loop):
    _, kfs_g, pts_g, cand = loop["closed"]
    kfs_f, pts_f, n_fused = loop["fused"]
    st = state_from_numpy(to_numpy_dict(kfs=kfs_g, points=pts_g), "cpu")
    sig2 = tri.level_sigma2(loop["cfg"].orb.n_levels, loop["cfg"].orb.scale_factor)
    tkfs, tpts, tn = loop_closing.fuse_and_global_ba(st.kfs, st.points, 7, cand, loop["tK"], sig2,
                                                     loop["tcfg"])
    assert tn == n_fused
    np.testing.assert_array_equal(tkfs.point_id.numpy(), np.asarray(kfs_f.point_id))
    np.testing.assert_array_equal(tpts.valid.numpy(), np.asarray(pts_f.valid))
    _close(tkfs.pose.numpy(), kfs_f.pose, 1e-3)
    assert int(tpts.valid.sum()) <= 120

    def mean_reproj(kfs_, pts_):
        K = loop["K"]
        errs = []
        for s in (0, 7):
            pid = np.asarray(kfs_.point_id[s])
            sel = (pid >= 0) & np.asarray(kfs_.kp_valid[s])
            xyz = np.asarray(pts_.xyz)[pid[sel]]
            pc = xyz @ np.asarray(kfs_.pose[s])[:3, :3].T + np.asarray(kfs_.pose[s])[:3, 3]
            uv = np.stack([K[0, 0] * pc[:, 0] / pc[:, 2] + K[0, 2],
                           K[1, 1] * pc[:, 1] / pc[:, 2] + K[1, 2]], -1)
            errs.append(np.linalg.norm(uv - np.asarray(kfs_.xy[s])[sel], axis=1))
        return float(np.mean(np.concatenate(errs)))

    assert mean_reproj(tkfs, tpts) < 0.5 * mean_reproj(kfs_g, pts_g)


# -------------------------------------------------------------------- CLI


def test_orbslam_cli_mode(tmp_path, monkeypatch):
    """``mono --orbslam`` (tests/test_rigid_system.py's run of the JAX CLI):
    the rigid system on the mono input, ``Trajectory.txt`` written."""
    seq = make_sequence(n_frames=8, height=160, width=200, max_amp=0.0, camera_motion=0.5, seed=3)
    monkeypatch.setattr(datasets, "load_video",
                        lambda _src: ((np.asarray(seq.frames[t]), float(t)) for t in range(8)))
    y = tmp_path / "s.yaml"
    c = seq.camera
    y.write_text(f"Camera.fx: {c.fx}\nCamera.fy: {c.fy}\nCamera.cx: {c.cx}\nCamera.cy: {c.cy}\n"
                 f"Camera.width: {c.width}\nCamera.height: {c.height}\n"
                 f"ORBextractor.nFeatures: 400\nFile.outputdir: {tmp_path / 'out'}\n")
    assert cli.main(["mono", str(y), "0", "--orbslam", "--device", "cpu"]) == 0
    rows = (tmp_path / "out" / "Trajectory.txt").read_text().strip().splitlines()
    assert len(rows) >= 4
    assert all(len(r.split()) == 17 for r in rows)
