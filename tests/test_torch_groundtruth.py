"""The ground-truth harness of the PyTorch port (``groundtruth/gt.py``,
``groundtruth/normals_gt.py``) against the JAX package's, on the CPU.

Tolerances and why:

- ``scaled_error``: scale and RMSE within 1e-6 relative, per-point errors
  within 1e-5 absolute (float32 norms and a median of the same values).
- ``ate_rmse``: the same numpy code, equal to 1e-12.
- ``stereo_depth_ncc`` on a blurred random texture and its shifted copy
  (``tests/test_groundtruth.py``'s pair, the blur in numpy): ``ok`` masks
  equal and depths within 1e-4 relative (NCC sums in another order; the
  best disparity and its neighbours are the same).
- The CT run (12 frames at 160x120, the keyframe's NRSfM chain on): rows of
  ``ErrorGTs0.txt`` / ``ScaleVariation.txt`` one per frame in both, the
  inlier counts within 2 and the RMSE and scale within 3x the largest gap
  that a 1e-7 relative perturbation of the template after frame 0 opens in
  the JAX package's own rows (or 1e-3, whichever is larger): the same rule
  as the pose in ``tests/test_torch_system.py``, because the RMSE measures
  the SfT's structure, which moves within that sensitivity.  The
  keyframe's angle file has the same name and size in both, and medians
  within 0.5 degree.
- The stereo run (``track_monocular_gt``, the port alone): one row per
  frame, a median RMSE under 0.1, the keyframe's angle file written.
"""

import dataclasses
import glob
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from defslam_tpu.config import CapacityConfig, Config, MappingConfig, OrbConfig, SfTConfig
from defslam_tpu.config import TrackingConfig
from defslam_tpu.groundtruth import gt as jgt
from defslam_tpu.io.synthetic import make_sequence
from defslam_tpu.system import System as JaxSystem
from defslam_tpu_torch.config import CapacityConfig as TCapacityConfig
from defslam_tpu_torch.config import Config as TConfig
from defslam_tpu_torch.convert import config_from_dict
from defslam_tpu_torch.groundtruth import gt
from defslam_tpu_torch.io.synthetic import _gaussian_blur
from defslam_tpu_torch.mapstore import state as store
from defslam_tpu_torch.system import System

torch.set_num_threads(2)


def test_scaled_error_matches_reference():
    rng = np.random.default_rng(0)
    gt_pts = (rng.normal(0, 1, (200, 3)) + [0, 0, 3.0]).astype(np.float32)
    est = (gt_pts * 0.4 + rng.normal(0, 0.01, gt_pts.shape)).astype(np.float32)
    est[:7] = 0.0  # zero-norm estimates take ratio 1
    mask = rng.uniform(size=200) < 0.8
    s_r, e_r, r_r = jgt.scaled_error(jnp.asarray(est), jnp.asarray(gt_pts), jnp.asarray(mask))
    s_t, e_t, r_t = gt.scaled_error(torch.tensor(est), torch.tensor(gt_pts), torch.tensor(mask))
    assert float(s_t) == pytest.approx(float(s_r), rel=1e-6)
    assert float(r_t) == pytest.approx(float(r_r), rel=1e-6)
    assert np.abs(e_t.numpy() - np.asarray(e_r)).max() <= 1e-5
    assert float(s_t) == pytest.approx(2.5, rel=1e-2)


def test_ate_rmse_matches_reference():
    rng = np.random.default_rng(2)
    from defslam_tpu.geometry import se3 as jse3

    xi = rng.normal(0, 0.2, (30, 6)).astype(np.float32)
    est = np.stack([np.asarray(jse3.se3_exp(jnp.asarray(x))) for x in xi])
    gtp = est.copy()
    gtp[:, :3, 3] = 2.0 * est[:, :3, 3] + rng.normal(0, 0.01, (30, 3))
    assert gt.ate_rmse(est, gtp) == pytest.approx(jgt.ate_rmse(est, gtp), rel=1e-12)
    traj = [(float(t), est[t]) for t in range(0, 30, 2)]
    assert gt.ate_rmse_trajectory(traj, gtp) == pytest.approx(
        jgt.ate_rmse_trajectory(traj, gtp), rel=1e-12)
    assert gt.ate_rmse(est, est) == pytest.approx(0.0, abs=1e-9)


def _stereo_pair(h=120, w=200, disp=9, seed=1):
    rng = np.random.default_rng(seed)
    img = _gaussian_blur(rng.uniform(0, 255, (h, w)).astype(np.float32), 1.5)
    return img, np.roll(img, -disp, axis=1), rng


def test_stereo_depth_ncc_matches_reference():
    img, img_r, rng = _stereo_pair()
    n = 80
    uv = np.stack([rng.uniform(2, 198, n), rng.uniform(2, 118, n)], 1).astype(np.float32)
    uv[:4] = [[10.5, 50.5], [11.5, 60.0], [100.5, 7.5], [199.4, 3.0]]  # half-pixel ties, edges
    mask = rng.uniform(size=n) < 0.9
    cfg = Config()
    d_r, ok_r = jgt.stereo_depth_ncc(jnp.asarray(img), jnp.asarray(img_r), jnp.asarray(uv),
                                     jnp.asarray(mask), 54.0, cfg)
    d_t, ok_t = gt.stereo_depth_ncc(torch.tensor(img), torch.tensor(img_r), torch.tensor(uv),
                                    torch.tensor(mask), 54.0, TConfig())
    ok_r = np.asarray(ok_r)
    np.testing.assert_array_equal(ok_t.numpy(), ok_r)
    assert ok_r.sum() > 40
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_r), rtol=1e-4)
    np.testing.assert_allclose(d_t.numpy()[ok_r], 6.0, rtol=0.05)  # depth = 54 / 9


def test_stereo_evaluation_matches_reference():
    """evaluate_stereo on planted points at the pair's depth (camera at the
    identity): NCC depths, radius outlier removal, scale, RMSE."""
    from defslam_tpu.geometry import camera as jcam
    from defslam_tpu.mapstore import state as jstore

    img, img_r, rng = _stereo_pair(seed=0)
    cfg = Config(capacity=CapacityConfig(max_map_points=128, max_keyframes=4))
    tcfg = TConfig(capacity=TCapacityConfig(max_map_points=128, max_keyframes=4))
    n = 60
    uv = np.stack([rng.uniform(60, 180, n), rng.uniform(20, 100, n)], 1).astype(np.float32)
    K = jnp.asarray(cfg.camera.K)
    pts = np.asarray(jcam.backproject(K, jnp.asarray(uv), jnp.full(n, 6.0)))
    xyz = np.zeros((128, 3), np.float32)
    xyz[:n] = pts
    valid = np.arange(128) < n

    class Fake:
        pass

    ref, port = Fake(), Fake()
    ref.K, ref.pose = K, jnp.eye(4)
    ref.points = jstore.empty_points(cfg)._replace(
        xyz=jnp.asarray(xyz), valid=jnp.asarray(valid),
        facet=jnp.asarray(np.where(valid, 0, -1).astype(np.int32)))
    port.K, port.pose = torch.as_tensor(tcfg.camera.K), torch.eye(4)
    port.points = store.empty_points(tcfg, "cpu")._replace(
        xyz=torch.tensor(xyz), valid=torch.tensor(valid),
        facet=torch.where(torch.tensor(valid), 0, -1))
    baseline = 54.0 / cfg.camera.fx
    r_ref = jgt.GroundTruthEvaluator(cfg).evaluate_stereo(ref, img, img_r, baseline, 0.0)
    ev = gt.GroundTruthEvaluator(tcfg)
    r_port = ev.evaluate_stereo(port, img, img_r, baseline, 0.0)
    assert r_port == pytest.approx(r_ref, rel=1e-4, abs=1e-6)
    assert r_port < 0.1 and ev.rows[0][2] > 30


def _ct_cfg(cam, outdir):
    return Config(
        camera=cam,
        orb=OrbConfig(n_features=300, n_levels=3, max_keypoints=384),
        sft=SfTConfig(lm_iterations=20),
        tracking=TrackingConfig(keyframe_period=6),
        capacity=CapacityConfig(max_map_points=1024, max_keyframes=8),
        # the NRSfM chain runs at the keyframe (tests/test_groundtruth.py's
        # angle-file settings)
        mapping=MappingConfig(points_to_template=100000, min_normals=10),
        save_results=True, output_dir=outdir,
    )


@pytest.fixture(scope="module")
def ct_runs(tmp_path_factory):
    """12 frames through track_monocular_ct in the JAX package (and its
    1e-7 probe) and in the port; each writes its metrics files."""
    seq = make_sequence(n_frames=12, height=120, width=160, max_amp=0.05)
    root = tmp_path_factory.mktemp("ct")
    runs = {}
    for name in ("jax", "probe", "port"):
        cfg = _ct_cfg(seq.camera, str(root / name))
        s = (System(config_from_dict(dataclasses.asdict(cfg)), device="cpu") if name == "port"
             else JaxSystem(cfg))
        for t in range(12):
            s.track_monocular_ct(seq.frames[t], seq.depths[t], float(t))
            if t == 0 and name == "probe":
                noise = np.random.default_rng(1).normal(0, 1e-7, (cfg.mesh.n_nodes, 3))
                s.template = s.template._replace(
                    nodes=s.template.nodes * (1 + jnp.asarray(noise, jnp.float32)))
        s.write_metrics()
        runs[name] = (s, root / name)
    return runs


def _rows(path, name):
    return [r.split() for r in (path / name).read_text().splitlines()]


def test_ct_run_errors_match_reference(ct_runs):
    rows = {k: np.array(_rows(p, "ScaleVariation.txt"), np.float64) for k, (_, p) in ct_runs.items()}
    errs = {k: np.loadtxt(p / "ErrorGTs0.txt") for k, (_, p) in ct_runs.items()}
    assert rows["port"].shape == rows["jax"].shape == (12, 3)
    np.testing.assert_array_equal(rows["port"][:, 0], rows["jax"][:, 0])  # timestamps
    assert np.abs(rows["port"][:, 2] - rows["jax"][:, 2]).max() <= 2  # inlier counts
    for gap_port, gap_probe in (
        (np.abs(errs["port"] - errs["jax"]), np.abs(errs["probe"] - errs["jax"])),
        (np.abs(rows["port"][:, 1] - rows["jax"][:, 1]),
         np.abs(rows["probe"][:, 1] - rows["jax"][:, 1])),
    ):
        assert gap_port.max() <= max(1e-3, 3 * gap_probe.max()), (gap_port, gap_probe)
    assert np.median(errs["port"]) < 0.06
    port = ct_runs["port"][0]
    assert port._gt_eval.rows[0][2] == int(rows["port"][0, 2])
    assert isinstance(port._gt_eval.rows[0][2], int)


def test_ct_run_writes_the_reference_files(ct_runs):
    ref_dir, port_dir = ct_runs["jax"][1], ct_runs["port"][1]
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(ref_dir))
    assert _rows(port_dir, "StatusTracking.txt") == _rows(ref_dir, "StatusTracking.txt")
    for name, flags in (("Matches.txt", slice(3, 6)), ("MapPointUsage.txt", slice(0, 0))):
        ref, got = _rows(ref_dir, name), _rows(port_dir, name)
        assert len(got) == len(ref) == 12
        for a, b in zip(ref, got):
            assert len(a) == len(b) and a[0] == b[0] and a[flags] == b[flags], (a, b)
            assert abs(int(a[1]) - int(b[1])) <= 1 and abs(int(a[2]) - int(b[2])) <= 2, (a, b)
    traj = np.array(_rows(port_dir, "Trajectory.txt"), np.float64)
    assert traj.shape == (12, 17) and np.isfinite(traj).all()


def test_keyframe_angle_files_written(ct_runs):
    """The keyframe at frame 6 runs the NRSfM chain, so the GT hook writes
    its isometric-normal angle file, named by the GT source's timestamp."""
    ref = sorted(glob.glob(str(ct_runs["jax"][1] / "ErrorAng*.txt")))
    got = sorted(glob.glob(str(ct_runs["port"][1] / "ErrorAng*.txt")))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in ref]
    assert any("ErrorAngIso" in p for p in got)
    for a, b in zip(ref, got):
        ea, eb = np.loadtxt(a), np.loadtxt(b)
        assert ea.shape == eb.shape and eb.size >= 5
        assert abs(np.median(ea) - np.median(eb)) <= 0.5
        assert np.median(eb) < 45.0


def test_stereo_gt_run_writes_rows_and_angles(tmp_path):
    """track_monocular_gt on a rendered stereo pair (the DefSLAMGT layout):
    one scaled-RMSE row per tracked frame, and the keyframe's angle file
    from NCC depths at its keypoints (the stereo seam of the GT hook)."""
    from defslam_tpu_torch.config import MappingConfig as TMappingConfig
    from defslam_tpu_torch.config import OrbConfig as TOrbConfig
    from defslam_tpu_torch.config import TrackingConfig as TTrackingConfig
    from defslam_tpu_torch.io.synthetic import make_sequence as tmake_sequence

    seq = tmake_sequence(n_frames=7, height=120, width=160, max_amp=0.05, baseline=0.1)
    cfg = TConfig(
        camera=seq.camera, orb=TOrbConfig(n_features=300, n_levels=3, max_keypoints=384),
        tracking=TTrackingConfig(keyframe_period=6),
        capacity=TCapacityConfig(max_map_points=1024, max_keyframes=8),
        mapping=TMappingConfig(points_to_template=100000, min_normals=10),
        save_results=True, output_dir=str(tmp_path),
    )
    s = System(cfg, device="cpu")
    for t in range(7):
        assert s.track_monocular_gt(seq.frames[t], seq.frames_right[t], float(t),
                                    baseline=0.1) is not None
    s.write_metrics()
    rows = s._gt_eval.rows
    assert len(rows) == 7 and all(r[2] >= 8 for r in rows[1:])
    assert np.median([r[1] for r in rows]) < 0.1
    assert (tmp_path / "ErrorAngIso5.txt").exists()
    assert len((tmp_path / "ErrorGTs0.txt").read_text().splitlines()) == 7
