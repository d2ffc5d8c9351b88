"""Checkpoint and resume of the PyTorch port (``System.save_state`` /
``load_state``), and checkpoints carried between the port and the JAX
package, on the CPU.

Tolerances and why:

- The port's own round trip and resume: exactly equal.  The port is
  deterministic on the CPU and a checkpoint holds every bit of the state,
  so a resumed run is the uninterrupted run (poses, Matches.txt,
  StatusTracking.txt, Trajectory.txt and ErrorGTs0.txt rows alike).
- A checkpoint of one package continued in the other: the loaded state is
  bit-equal to what was saved (descriptor words as uint32, index fields as
  int32 in the file), and the two continuations agree per frame as the
  free runs of ``tests/test_torch_system.py`` do: tracking states and
  keyframe / template flags equal, match counts within 2, inlier counts
  within 3 (the mapping run's tolerance: keyframes and template swaps
  follow), poses within 2e-2.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from defslam_tpu.config import (CapacityConfig, Config, MappingConfig, OrbConfig, SfTConfig,
                                TrackingConfig)
from defslam_tpu.io.synthetic import make_sequence
from defslam_tpu.system import System as JaxSystem
from defslam_tpu_torch.convert import config_from_dict
from defslam_tpu_torch.system import System, TrackingState

torch.set_num_threads(2)


def _cfg(cam, **kw):
    # the configuration of tests/test_checkpoint.py: re-templating on
    return Config(
        camera=cam,
        orb=OrbConfig(n_features=300, n_levels=3, max_keypoints=384),
        sft=SfTConfig(lm_iterations=15),
        tracking=TrackingConfig(keyframe_period=4),
        capacity=CapacityConfig(max_map_points=512, max_keyframes=8),
        mapping=MappingConfig(points_to_template=60, chi_limit=0.2),
        **kw,
    )


@pytest.fixture(scope="module")
def seq():
    return make_sequence(n_frames=20, height=120, width=160, max_amp=0.05)


def _port(cfg, pipelined: bool = True):
    """The port's System; ``pipelined=False`` for the synchronous protocol,
    where a continuation is compared right after its last call."""
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    return System(dataclasses.replace(tcfg, tracking=dataclasses.replace(tcfg.tracking,
                                                                         pipelined=pipelined)),
                  device="cpu")


def _store_fields(s):
    return {f"{p}_{k}": v for p, obj in (("kf", s.kfs), ("pt", s.points), ("tmpl", s.template))
            for k, v in obj._asdict().items()}


def test_checkpoint_roundtrip_and_resume(seq, tmp_path):
    cfg = _cfg(seq.camera)
    s1 = _port(cfg)
    for t in range(6):
        s1.track_monocular(seq.frames[t], float(t))
    ckpt = str(tmp_path / "state.npz")
    s1.save_state(ckpt)
    s2 = _port(cfg)
    s2.load_state(ckpt)
    a, b = _store_fields(s1), _store_fields(s2)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    assert torch.equal(s1.pose, s2.pose) and torch.equal(s1.prev_pose, s2.prev_pose)
    for attr in ("frame_id", "frames_since_kf", "template_ref_kf", "state", "kf_counter",
                 "_lost_count", "_metrics"):
        assert getattr(s2, attr) == getattr(s1, attr), attr
    assert len(s2.template_history) == len(s1.template_history) == 1  # the keyframe at 4
    for t in range(6, 12):
        p1 = s1.track_monocular(seq.frames[t], float(t))
        p2 = s2.track_monocular(seq.frames[t], float(t))
        np.testing.assert_array_equal(p1, p2)
    assert s1._metrics == s2._metrics


def test_resume_continues_metric_streams(seq, tmp_path):
    """10 frames, a checkpoint, a fresh System, 10 more: every file the run
    writes equals the uninterrupted 20-frame run's."""
    cfg = _cfg(seq.camera, save_results=True)
    full = _port(dataclasses.replace(cfg, output_dir=str(tmp_path / "full")))
    for t in range(20):
        full.track_monocular_ct(seq.frames[t], seq.depths[t], float(t))
    full.write_metrics()
    a = _port(dataclasses.replace(cfg, output_dir=str(tmp_path / "split")))
    for t in range(10):
        a.track_monocular_ct(seq.frames[t], seq.depths[t], float(t))
    ckpt = str(tmp_path / "ck.npz")
    a.save_state(ckpt)
    b = _port(dataclasses.replace(cfg, output_dir=str(tmp_path / "split")))
    b.load_state(ckpt)
    for t in range(10, 20):
        b.track_monocular_ct(seq.frames[t], seq.depths[t], float(t))
    b.write_metrics()
    for name in ("Matches.txt", "StatusTracking.txt", "MapPointUsage.txt", "Trajectory.txt",
                 "ErrorGTs0.txt", "ScaleVariation.txt"):
        fa = (tmp_path / "full" / name).read_text()
        assert fa == (tmp_path / "split" / name).read_text(), name
    assert len((tmp_path / "full" / "ErrorGTs0.txt").read_text().splitlines()) == 20
    assert all(isinstance(r[2], int) for r in b._gt_eval.rows)


def _continue(s, frames, flush=False):
    for t, f in frames:
        s.track_monocular(f, float(t))
    if flush:
        s.flush()
    return s


def _assert_continuations_agree(ref, port, start):
    assert len(ref._metrics) == len(port._metrics)
    for mj, mt in zip(ref._metrics[start:], port._metrics[start:]):
        for k in ("state", "keyframe", "template"):
            assert mt[k] == mj[k], (mj, mt)
        assert abs(mt["matches"] - mj["matches"]) <= 2, (mj, mt)
        assert abs(mt["inliers"] - mj["inliers"]) <= 3, (mj, mt)
    assert len(ref.trajectory) == len(port.trajectory)
    for (_, Tj), (_, Tt) in zip(ref.trajectory, port.trajectory):
        assert np.abs(np.asarray(Tt) - np.asarray(Tj)).max() <= 2e-2


def test_reference_checkpoint_continues_in_the_port(seq, tmp_path):
    cfg = _cfg(seq.camera)
    ref = _continue(JaxSystem(cfg), [(t, seq.frames[t]) for t in range(6)], flush=True)
    ckpt = str(tmp_path / "jax.npz")
    ref.save_state(ckpt)
    port = _port(cfg, pipelined=False)
    port.load_state(ckpt)
    with np.load(ckpt) as data:
        for key, v in _store_fields(port).items():
            saved = data[key]
            got = v.numpy().view(np.uint32) if saved.dtype == np.uint32 else v.numpy()
            np.testing.assert_array_equal(got, saved, err_msg=key)
    assert port.frame_id == ref.frame_id == 5 and port.kf_counter == ref.kf_counter
    assert port.state == TrackingState.OK and port._metrics == ref._metrics
    frames = [(t, seq.frames[t]) for t in range(6, 14)]
    _assert_continuations_agree(_continue(ref, frames, flush=True), _continue(port, frames), 6)


def test_port_checkpoint_continues_in_the_reference(seq, tmp_path):
    cfg = _cfg(seq.camera)
    port = _continue(_port(cfg, pipelined=False), [(t, seq.frames[t]) for t in range(6)])
    ckpt = str(tmp_path / "port.npz")
    port.save_state(ckpt)
    with np.load(ckpt) as data:
        assert data["kf_desc"].dtype == data["pt_desc"].dtype == np.uint32
        for key in ("kf_point_id", "kf_frame_id", "pt_facet", "pt_ref_kf", "pt_ref_kp",
                    "kf_level", "pt_n_obs", "pt_first_kf"):
            assert data[key].dtype == np.int32, key
        assert data["pose"].dtype == data["kf_pose"].dtype == np.float32
    ref = JaxSystem(cfg)
    ref.load_state(ckpt)
    np.testing.assert_array_equal(np.asarray(ref.kfs.desc).view(np.int32), port.kfs.desc.numpy())
    np.testing.assert_array_equal(np.asarray(ref.points.facet), port.points.facet.numpy())
    assert ref._metrics == port._metrics and ref.kf_counter == port.kf_counter
    frames = [(t, seq.frames[t]) for t in range(6, 14)]
    ref = _continue(ref, frames, flush=True)
    _assert_continuations_agree(ref, _continue(port, frames), 6)
    assert int(jnp.sum(ref.kfs.valid)) == int(port.kfs.valid.sum())
