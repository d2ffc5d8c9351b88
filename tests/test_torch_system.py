"""The System of the PyTorch port against the JAX package's, on the CPU.
Tracking: an 8-frame 160x120 sequence, frame 0 initializes, then
localization mode (no keyframes).  Mapping: a 22-frame 160x120 sequence
with a keyframe every 4 frames and template swaps.

Tolerances and why:

- One step from the reference's own state (``convert.state_from_numpy``):
  match and inlier counts within 1, point->keypoint matches equal on
  >= 99% of the map, and the map reprojected by the new pose within 0.5 px.
  The pose itself is not held tighter than 1e-2: the SfT solve has flat
  directions (camera vs rigid mesh motion, and a curvature Jacobian that is
  rounding noise on the near-flat template), so rounding-level differences
  move the pose along them while the observable structure stays put (see
  tests/test_torch_sft.py).
- The free run (each package on its own state): per-frame tracking states
  equal, match counts within 1, inlier counts within 2, and the pose within
  3x the distance a 1e-7 relative perturbation of the template after frame
  0 moves the JAX package's own trajectory (or 1e-3, whichever is larger).
- The mapping run: per-frame tracking states, keyframe and template flags
  equal; match counts within 2 and inlier counts within 3 (after a template
  swap both packages re-create the map points from their own SfN surface);
  the accepted registration scales within 1e-3 relative, culled-point counts
  within 2; the pose within 2e-2 (the swaps' Sim(3) gauge and the
  re-anchoring SfT carry the solve's sensitivity across keyframes).
"""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from defslam_tpu.config import CapacityConfig, Config, OrbConfig, SfTConfig, TrackingConfig
from defslam_tpu.geometry import camera as jcam
from defslam_tpu.geometry import se3 as jse3
from defslam_tpu.io.synthetic import make_sequence
from defslam_tpu.system import System as JaxSystem
from defslam_tpu.tracking import tracker as jtracker
from defslam_tpu_torch.convert import config_from_dict, state_from_numpy, to_numpy_dict
from defslam_tpu_torch.system import System, TrackingState
from defslam_tpu_torch.tracking import tracker as ttracker

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
N_FRAMES = 8


@pytest.fixture(scope="module")
def seq():
    return make_sequence(n_frames=16, height=120, width=160, max_amp=0.08)


@pytest.fixture(scope="module")
def cfgs(seq):
    # the configuration of test_system_e2e's localization-mode test
    cfg = Config(
        camera=seq.camera,
        orb=OrbConfig(n_features=300, n_levels=3, max_keypoints=384),
        sft=SfTConfig(lm_iterations=15),
        tracking=TrackingConfig(keyframe_period=3),
        capacity=CapacityConfig(max_map_points=512, max_keyframes=8),
    )
    return cfg, config_from_dict(dataclasses.asdict(cfg))


def _run_jax(cfg, frames, perturb=0.0):
    s = JaxSystem(cfg)
    for t, f in enumerate(frames):
        s.track_monocular(f, timestamp=float(t))
        if t == 0:
            s.activate_localization_mode()
            if perturb:
                rng = np.random.default_rng(1)
                noise = jnp.asarray(rng.normal(0, perturb, (cfg.mesh.n_nodes, 3)), jnp.float32)
                s.template = s.template._replace(nodes=s.template.nodes * (1 + noise))
    s.flush()
    return s


def _run_port(tcfg, frames):
    s = System(tcfg, device="cpu")
    for t, f in enumerate(frames):
        s.track_monocular(f, timestamp=float(t))
        if t == 0:
            s.activate_localization_mode()
    return s


def test_tracking_steps_match_reference(seq, cfgs):
    cfg, tcfg = cfgs
    js = JaxSystem(cfg)
    js.track_monocular(seq.frames[0])
    js.activate_localization_mode()
    js.flush()
    K = torch.as_tensor(tcfg.camera.K)
    for t in range(1, N_FRAMES):
        ms = state_from_numpy(to_numpy_dict(points=js.points, template=js.template,
                                            pose=js.pose, prev_pose=js.prev_pose), "cpu")
        img = seq.frames[t]
        fj, mj, rj, pj, sj = jtracker.track_frame(
            jnp.asarray(img), js.points, js.pose, js.prev_pose, js.template, js.K, cfg)
        ft, mt, rt, pt, st = ttracker.track_frame(
            torch.from_numpy(img), ms.points, ms.pose, ms.prev_pose, ms.template, K, tcfg)
        sj, st = np.asarray(sj), st.numpy()
        assert abs(int(st[0]) - int(sj[0])) <= 1 and abs(int(st[1]) - int(sj[1])) <= 1, (t, sj, st)
        assert (mt.kp_of_point.numpy() == np.asarray(mj.kp_of_point)).mean() >= 0.99
        live = np.asarray(js.points.valid) & (np.asarray(js.points.facet) >= 0)

        def reproject(T, xyz):
            return np.asarray(jcam.project(js.K, jse3.transform(jnp.asarray(T), jnp.asarray(xyz))))

        gap = np.abs(reproject(rj.T, pj.xyz) - reproject(rt.T.numpy(), pt.xyz.numpy()))[live]
        assert gap.max() <= 0.5, (t, gap.max())
        assert np.abs(rt.T.numpy() - np.asarray(rj.T)).max() <= 1e-2
        js.track_monocular(img, timestamp=float(t))
        js.flush()


def test_tracking_run_matches_reference(seq, cfgs):
    cfg, tcfg = cfgs
    frames = seq.frames[:N_FRAMES]
    ref = _run_jax(cfg, frames)
    probe = _run_jax(cfg, frames, perturb=1e-7)
    port = _run_port(tcfg, frames)
    assert len(port._metrics) == len(ref._metrics) == N_FRAMES
    for mj, mt in zip(ref._metrics, port._metrics):
        assert mt["state"] == mj["state"] == "OK"
        assert abs(mt["matches"] - mj["matches"]) <= 1, (mj, mt)
        assert abs(mt["inliers"] - mj["inliers"]) <= 2, (mj, mt)
    assert len(port.trajectory) == len(ref.trajectory) == N_FRAMES
    for (_, Tj), (_, Tp), (_, Tt) in zip(ref.trajectory, probe.trajectory, port.trajectory):
        Tj, Tp = np.asarray(Tj), np.asarray(Tp)
        assert np.abs(Tt - Tj).max() <= max(1e-3, 3 * np.abs(Tp - Tj).max())


def test_system_defaults_to_cuda(cfgs):
    _, tcfg = cfgs
    if torch.cuda.is_available():
        assert System(tcfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            System(tcfg)


def test_keyframe_branch_is_a_later_slice(seq, cfgs):
    """The keyframe branch was a later slice of the port and raised; it now
    inserts the keyframe and runs the mapping step."""
    _, tcfg = cfgs
    s = System(tcfg, device="cpu")  # localization mode off, keyframe_period 3
    for t in range(4):
        assert s.track_monocular(seq.frames[t]) is not None
    assert [m["keyframe"] for m in s._metrics] == [True, False, False, True]
    assert int(s.kfs.valid.sum()) == 2 and s.kf_counter == 2 and s.frames_since_kf == 0
    assert s.last_map_diag.slot == 1 and s.last_map_diag.n_pairs == 1
    assert "reg_scale" in s._metrics[3] and torch.equal(s.prev_pose, s.pose)


def test_localization_mode_toggles_keyframes(seq, cfgs):
    _, tcfg = cfgs
    s = System(tcfg, device="cpu")
    s.track_monocular(seq.frames[0])
    s.activate_localization_mode()
    for t in range(1, 5):
        s.track_monocular(seq.frames[t])
    assert s.kf_counter == 1 and not any(m["keyframe"] for m in s._metrics[1:])
    s.deactivate_localization_mode()
    s.track_monocular(seq.frames[5])
    assert s._metrics[5]["keyframe"] and s.kf_counter == 2


@pytest.fixture(scope="module")
def mapping_runs():
    """The JAX package's and the port's 22-frame runs with keyframes, at the
    size of tests/test_retemplate.py."""
    from defslam_tpu.config import MappingConfig

    seq = make_sequence(n_frames=22, height=120, width=160, max_amp=0.05, camera_motion=0.5,
                        seed=5)
    cfg = Config(
        camera=seq.camera,
        orb=OrbConfig(n_features=400, n_levels=3, max_keypoints=512),
        sft=SfTConfig(lm_iterations=25),
        tracking=TrackingConfig(keyframe_period=4),
        capacity=CapacityConfig(max_map_points=2048, max_keyframes=10),
        mapping=MappingConfig(points_to_template=60, chi_limit=0.2),
    )
    ref = JaxSystem(cfg)
    port = System(config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    for t, f in enumerate(seq.frames):
        ref.track_monocular(f, timestamp=float(t))
        port.track_monocular(f, timestamp=float(t))
    ref.flush()
    return ref, port


def test_mapping_run_matches_reference(mapping_runs):
    ref, port = mapping_runs
    assert len(port._metrics) == len(ref._metrics) == 22
    for mj, mt in zip(ref._metrics, port._metrics):
        assert mt["state"] == mj["state"] == "OK"
        assert mt["keyframe"] == mj["keyframe"] and mt["template"] == mj["template"], (mj, mt)
        assert abs(mt["matches"] - mj["matches"]) <= 2, (mj, mt)
        assert abs(mt["inliers"] - mj["inliers"]) <= 3, (mj, mt)
        if mj["keyframe"] and mj["frame"] > 0:
            assert mt["reg_scale"] == pytest.approx(mj["reg_scale"], rel=1e-3)
            assert abs(mt["points_culled"] - mj["points_culled"]) <= 2
            for k in ("map_obs_dropped", "map_pair_dropped", "map_pt_dropped"):
                assert mt[k] == mj[k]
    for (_, Tj), (_, Tt) in zip(ref.trajectory, port.trajectory):
        assert np.abs(Tt - np.asarray(Tj)).max() <= 2e-2
    assert port.template_ref_kf == ref.template_ref_kf and port.kf_counter == ref.kf_counter


def test_mapping_run_swaps_the_template(mapping_runs):
    _, port = mapping_runs
    kf_rows = [m for m in port._metrics if m["keyframe"]]
    assert [m["frame"] for m in kf_rows] == [0, 4, 8, 12, 16, 20]
    assert sum(m["template"] for m in kf_rows[1:]) >= 1
    assert int(port.kfs.valid.sum()) == 6
    assert int(port.kfs.surf_valid.sum()) >= 1


def test_relocalization_branch_is_a_later_slice(seq, cfgs):
    _, tcfg = cfgs
    s = System(tcfg, device="cpu")
    s.track_monocular(seq.frames[0])
    s.activate_localization_mode()
    with pytest.raises(NotImplementedError, match="slice 3"):
        s.track_monocular(np.full_like(seq.frames[1], 128.0))  # featureless


def test_lost_then_reinitialize(seq, cfgs, monkeypatch):
    """With relocalization failing, a featureless frame is LOST (pose None,
    velocity dropped), and after ``lost_patience`` LOST frames the map is
    re-initialized."""
    _, tcfg = cfgs
    tcfg = dataclasses.replace(
        tcfg, tracking=dataclasses.replace(tcfg.tracking, lost_patience=1))
    s = System(tcfg, device="cpu")
    monkeypatch.setattr(s, "_relocalize", lambda img: (False, None))
    assert s.track_monocular(seq.frames[0]) is not None
    s.activate_localization_mode()
    assert s.track_monocular(seq.frames[1]) is not None
    assert s.track_monocular(np.full_like(seq.frames[2], 128.0)) is None
    assert s.get_tracking_state() == TrackingState.LOST
    assert torch.equal(s.prev_pose, s.pose)
    assert s.track_monocular(seq.frames[3]) is not None  # re-initialized
    assert [m["state"] for m in s._metrics] == ["OK", "OK", "LOST", "OK"]
    assert s._metrics[3]["keyframe"] and s._metrics[3]["template"]


def _port_sources():
    return sorted((ROOT / "defslam_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(mod: str) -> bool:
    return mod.split(".")[0] in ("jax", "jaxlib", "defslam_tpu")


def test_port_imports_no_jax_by_ast():
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                bad += [(path.name, a.name) for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                if _forbidden(node.module):
                    bad.append((path.name, node.module))
    assert not bad, bad


def test_port_imports_no_jax_at_run_time():
    mods = [
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in _port_sources() if p.name != "__init__.py"
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'defslam_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
