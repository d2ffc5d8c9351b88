"""The pipelined frame loop and the split keyframe dispatch of the PyTorch
port, on the CPU, at the size of tests/test_system_e2e.py's protocol tests
(160x120, 300 features, 3 levels, 384 keypoints, 15 LM iterations, a
keyframe every 4 frames).

Tolerances and why:

- The port pipelined (depths 1-3) against the port synchronous: metrics
  rows equal, the trajectory within 1e-6.  Both protocols run the same
  operations on the same state in the same order; only when the host reads
  the results differs (the JAX package's own contract,
  test_system_e2e.py:106-137).
- The port against the JAX package with the same flags: the mapping-run
  tolerances of tests/test_torch_system.py (states and keyframe/template
  flags equal, matches within 2, inliers within 3, the pose within 2e-2),
  except that over the whole 16-frame run the pose is held within
  max(2e-2, 3x the distance a 1e-7 relative perturbation of the template
  after frame 0 moves the JAX package's own trajectory), the free-run rule
  of tests/test_torch_system.py: on this sequence the port's synchronous
  run, unchanged by the pipeline, already ends 0.044 from the JAX
  package's, where the perturbation moves the JAX package by 0.13-0.30.
- The keyframe step's halves from the JAX package's state, on
  tests/test_torch_mapper.py's sequence, where the step swaps the
  template: the hand-over's integers equal, the gauge and the pose within
  the fused step's 5e-3 (tests/test_torch_mapper.py); the fused step
  against the two halves without the split's re-anchor, bit for bit in the
  port.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from defslam_tpu.config import (
    CapacityConfig, Config, MappingConfig, OrbConfig, SfTConfig, TrackingConfig,
)
from defslam_tpu.io.synthetic import make_sequence
from defslam_tpu.mapping import mapper as jmapper
from defslam_tpu.system import System as JaxSystem
from defslam_tpu_torch import profiling
from defslam_tpu_torch.convert import config_from_dict, state_from_numpy, to_numpy_dict
from defslam_tpu_torch.mapping import mapper as tmapper
from defslam_tpu_torch.system import System
from defslam_tpu_torch.utils import Readback

torch.set_num_threads(2)

KF_FRAME = 8  # keyframes at frames 4 and 8


@pytest.fixture(scope="module")
def seq():
    return make_sequence(n_frames=16, height=120, width=160, max_amp=0.08)


def _cfg(seq, **tracking):
    """test_system_e2e.py's protocol-test configuration (the JAX one)."""
    return Config(
        camera=seq.camera,
        orb=OrbConfig(n_features=300, n_levels=3, max_keypoints=384),
        sft=SfTConfig(lm_iterations=15),
        tracking=TrackingConfig(keyframe_period=4, **tracking),
        capacity=CapacityConfig(max_map_points=1024, max_keyframes=8),
        mapping=MappingConfig(points_to_template=60, chi_limit=0.2),
    )


def _blank(frames, at):
    return [np.full_like(f, 128.0) if t == at else f for t, f in enumerate(frames)]


def _run(system, frames, flush=True):
    for t, f in enumerate(frames):
        system.track_monocular(f, timestamp=float(t))
    if flush:
        system.flush()
    return system


def _port(seq, frames, **tracking):
    return _run(System(config_from_dict(dataclasses.asdict(_cfg(seq, **tracking))), device="cpu"),
                frames)


def _jax(seq, frames, **tracking):
    return _run(JaxSystem(_cfg(seq, **tracking)), frames)


def _same_run(a, b):
    """Metrics rows equal and the trajectory within 1e-6."""
    assert len(a._metrics) == len(b._metrics)
    for ma, mb in zip(a._metrics, b._metrics):
        assert ma == mb, (ma, mb)
    assert len(a.trajectory) == len(b.trajectory)
    for (tsa, ta), (tsb, tb) in zip(a.trajectory, b.trajectory):
        assert tsa == tsb
        np.testing.assert_allclose(ta, tb, atol=1e-6)


def _like_reference(port, ref, probe=None):
    """test_torch_system.py's mapping-run tolerances; with a ``probe`` run,
    its free-run rule for the pose."""
    assert len(port._metrics) == len(ref._metrics)
    for mj, mt in zip(ref._metrics, port._metrics):
        assert mt["state"] == mj["state"], (mj, mt)
        assert mt["keyframe"] == mj["keyframe"] and mt["template"] == mj["template"], (mj, mt)
        assert abs(mt["matches"] - mj["matches"]) <= 2, (mj, mt)
        assert abs(mt["inliers"] - mj["inliers"]) <= 3, (mj, mt)
    assert len(port.trajectory) == len(ref.trajectory)
    for i, ((tsj, Tj), (tst, Tt)) in enumerate(zip(ref.trajectory, port.trajectory)):
        assert tsj == tst
        bound = 2e-2
        if probe is not None:
            bound = max(bound, 3 * np.abs(np.asarray(probe.trajectory[i][1]) - np.asarray(Tj)).max())
        assert np.abs(Tt - np.asarray(Tj)).max() <= bound, (i, bound)
    assert port.kf_counter == ref.kf_counter and port.template_ref_kf == ref.template_ref_kf


# ------------------------------------------------- pipelined == synchronous


@pytest.fixture(scope="module")
def sync_run(seq):
    return _port(seq, seq.frames[:10], pipelined=False)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipelined_matches_synchronous(seq, sync_run, depth):
    _same_run(sync_run, _port(seq, seq.frames[:10], pipeline_depth=depth))


def test_pipelined_rows_wait_for_validation(seq):
    """Optimistic rows hold -1 until their frame is validated, the returned
    pose is the unvalidated device tensor, and ``flush`` fills the rows."""
    s = System(config_from_dict(dataclasses.asdict(_cfg(seq))), device="cpu")
    assert isinstance(s.track_monocular(seq.frames[0]), np.ndarray)  # initialization
    poses = [s.track_monocular(torch.from_numpy(f)) for f in seq.frames[1:4]]
    assert all(torch.is_tensor(p) and p.shape == (4, 4) for p in poses)
    assert [m["matches"] for m in s._metrics[2:]] == [-1, -1]  # depth 2: frames 2, 3 in flight
    assert s._metrics[1]["matches"] > 0 and len(s._pending) == 2 and len(s.trajectory) == 2
    s.flush()
    assert not s._pending and min(m["matches"] for m in s._metrics[1:]) > 0
    assert len(s.trajectory) == 4
    np.testing.assert_allclose(s.trajectory[-1][1], poses[-1].numpy(), atol=0)


def test_reset_drops_in_flight_work(seq):
    s = _run(System(config_from_dict(dataclasses.asdict(_cfg(seq, split_keyframe_dispatch=True))),
                    device="cpu"), seq.frames[:5], flush=False)
    assert s._pending and s._pending_kf_b is not None  # keyframe 4's half B waits
    s.reset()
    assert not s._pending and s._pending_kf_b is None and s._pending_map is None
    assert int(s.kfs.valid.sum()) == 0 and s.template is None


# ---------------------------------------------- against the JAX package


@pytest.fixture(scope="module")
def reference_probe(seq):
    """The JAX package's pipelined run with the template perturbed by
    N(0, 1e-7) relative right after the initialization."""
    s = JaxSystem(_cfg(seq))
    for t, f in enumerate(seq.frames):
        s.track_monocular(f, timestamp=float(t))
        if t == 0:
            noise = np.random.default_rng(1).normal(0, 1e-7, (s.cfg.mesh.n_nodes, 3))
            s.template = s.template._replace(
                nodes=s.template.nodes * (1 + jnp.asarray(noise, jnp.float32)))
    s.flush()
    return s


@pytest.mark.parametrize("split", [False, True])
def test_pipelined_run_matches_reference(seq, reference_probe, split):
    frames = seq.frames
    _like_reference(_port(seq, frames, split_keyframe_dispatch=split),
                    _jax(seq, frames, split_keyframe_dispatch=split), reference_probe)


# ------------------------------------------------------------- rollbacks


def test_keyframe_rollback_matches_synchronous_and_reference(seq):
    """test_system_e2e.py:140-173: the frame at the second keyframe slot is
    blank and fails validation; the optimistic keyframe insertion is undone
    and the run ends as the synchronous one."""
    frames = _blank(seq.frames[:9], 8)
    port = _port(seq, frames)
    _same_run(_port(seq, frames, pipelined=False), port)
    ref = _jax(seq, frames)
    _like_reference(port, ref)
    assert int(port.kfs.valid.sum()) == int(np.asarray(ref.kfs.valid).sum()) == 2
    assert port._metrics[8]["state"] != "OK"
    assert len(port.template_history) == len(ref.template_history)


def test_split_rollback_recovers_like_reference(seq):
    """test_system_e2e.py:218-249: the frame right after a split keyframe
    (between its halves) is blank; its rollback restores the state before
    half B, drops B, and the run recovers with the stores consistent."""
    frames = _blank(seq.frames[:12], 5)
    port = _port(seq, frames, split_keyframe_dispatch=True)
    ref = _jax(seq, frames, split_keyframe_dispatch=True)
    by_t = {m["t"]: m for m in port._metrics}
    assert by_t[5.0]["state"] != "OK" and by_t[11.0]["state"] == "OK"
    # the replayed frame keeps its own frame id (the JAX package's row takes
    # the id of the frame being dispatched when the failure is found)
    assert [m["frame"] for m in port._metrics] == list(range(12))
    _like_reference(port, ref)
    pid = port.kfs.point_id
    bound = pid[pid >= 0]
    assert bool((bound < port.points.capacity).all())
    assert float(port.points.valid[bound].float().mean()) > 0.5
    assert port.kf_counter == ref.kf_counter


# -------------------------------------------------- the keyframe step's halves


@pytest.fixture(scope="module")
def before_kf():
    """On tests/test_torch_mapper.py's sequence, the JAX system's state just
    before its second keyframe step (frame 8 tracked and committed by hand),
    and the configs."""
    mseq = make_sequence(n_frames=KF_FRAME + 1, height=120, width=160, max_amp=0.05,
                         camera_motion=0.5, seed=5)
    cfg = Config(
        camera=mseq.camera,
        orb=OrbConfig(n_features=400, n_levels=3, max_keypoints=512),
        sft=SfTConfig(lm_iterations=25),
        tracking=TrackingConfig(keyframe_period=4, pipelined=False),
        capacity=CapacityConfig(max_map_points=2048, max_keyframes=10),
        mapping=MappingConfig(points_to_template=60, chi_limit=0.2),
    )
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    js = JaxSystem(cfg)
    _run(js, mseq.frames[:KF_FRAME])
    feats, matches, res, new_points, _ = js._track_frame(jnp.asarray(mseq.frames[KF_FRAME]))
    js.frame_id += 1
    js.prev_pose, js.pose = js.pose, res.T
    js.template = js.template._replace(nodes=res.nodes)
    js.points = new_points
    return js, feats, matches, res, cfg, tcfg


def _copy(tree):
    return jax.tree.map(jnp.copy, tree)


def _port_args(js, feats, matches, res):
    ms = state_from_numpy(to_numpy_dict(points=js.points, kfs=js.kfs, template=js.template,
                                        pose=js.pose, feats=feats, matches=matches), "cpu")
    K = torch.as_tensor(np.asarray(js.K))
    inlier = torch.from_numpy(np.array(res.inlier))
    return ms, K, inlier, torch.from_numpy(np.array(js.dom)), torch.from_numpy(
        np.array(js.bend_warp)), torch.from_numpy(np.array(js.bend_sfn))


def _clone(nt):
    return type(nt)(*(t.clone() for t in nt))


class HostReads(TorchDispatchMode):
    """Counts the operations that read a tensor's value on the host (on a
    card each one waits for the stream): ``item`` / ``int`` / ``bool``, and
    a boolean mask's ``nonzero``."""

    READS = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select")

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if name.startswith(self.READS):
            self.reads.append(name)
        return func(*args, **(kwargs or {}))


def test_keyframe_halves_match_reference(before_kf):
    js, feats, matches, res, cfg, tcfg = before_kf
    jargs = (js.K, js.dom, js.bend_warp, jnp.asarray(js.template_ref_kf, jnp.int32),
             jnp.asarray(js.frame_id, jnp.int32), cfg)
    jk, jp, jc = jmapper.keyframe_step_a(_copy(js.kfs), _copy(js.points), js.pose, feats,
                                         matches.kp_of_point, res.inlier, *jargs)
    jout = jmapper.keyframe_step_b(jk, jp, js.template, js.pose, feats, jc, js.K, js.dom,
                                   js.bend_sfn, jnp.asarray(js.kf_counter, jnp.int32), cfg)
    ms, K, inlier, dom, bend_w, bend_s = _port_args(js, feats, matches, res)
    reads = HostReads()
    with reads:
        tk, tp, tc = tmapper.keyframe_step_a(ms.kfs, ms.points, ms.pose, ms.feats,
                                             ms.matches.kp_of_point, inlier, K, dom, bend_w,
                                             js.template_ref_kf, js.frame_id, tcfg)
    assert reads.reads == []  # the slot and kf_t stay on the device
    for f in tmapper.KFCarry._fields:
        assert getattr(tc, f).ndim == 0 and int(getattr(tc, f)) == int(getattr(jc, f)), f
    # half B from the port's own half A
    tout = tmapper.keyframe_step_b(tk, tp, ms.template, ms.pose, ms.feats, tc, K, dom,
                                   bend_s, js.kf_counter, tcfg)
    for f in tmapper.MappingDiag._fields:
        if f != "reg_scale":
            assert int(getattr(tout[4], f)) == int(getattr(jout[4], f)), f
    assert bool(tout[4].accepted)
    scale = max(1.0, float(np.abs(np.asarray(jout[5])).max()))
    np.testing.assert_allclose(tout[5].numpy(), np.asarray(jout[5]), atol=5e-3 * scale)
    np.testing.assert_allclose(tout[3].numpy(), np.asarray(jout[3]), atol=5e-3)
    np.testing.assert_allclose(tout[2].nodes.numpy(), np.asarray(jout[2].nodes), atol=5e-3)
    # half B from the JAX package's half A, through convert's KFCarry
    mb = state_from_numpy(to_numpy_dict(kfs=jk, points=jp, carry=jc), "cpu")
    bout = tmapper.keyframe_step_b(mb.kfs, mb.points, ms.template, ms.pose, ms.feats, mb.carry,
                                   K, dom, bend_s, js.kf_counter, tcfg)
    assert np.array_equal(bout[0].point_id.numpy(), np.asarray(jout[0].point_id))
    np.testing.assert_allclose(bout[5].numpy(), np.asarray(jout[5]), atol=5e-3 * scale)


def test_fused_step_is_the_two_halves_bit_for_bit(before_kf):
    js, feats, matches, res, cfg, tcfg = before_kf
    ms, K, inlier, dom, bend_w, bend_s = _port_args(js, feats, matches, res)
    fused = tmapper.keyframe_step(_clone(ms.kfs), _clone(ms.points), ms.template, ms.pose,
                                  ms.feats, ms.matches.kp_of_point, inlier, K, dom, bend_w,
                                  bend_s, js.template_ref_kf, js.kf_counter, js.frame_id, tcfg)
    kfs, points, carry = tmapper.keyframe_step_a(_clone(ms.kfs), _clone(ms.points), ms.pose,
                                                 ms.feats, ms.matches.kp_of_point, inlier, K,
                                                 dom, bend_w, js.template_ref_kf, js.frame_id,
                                                 tcfg)
    kfs_a = _clone(kfs)
    halves = tmapper._kf_step_b(kfs, points, ms.template, ms.pose, ms.feats, carry, K, dom,
                                bend_s, js.kf_counter, tcfg, tmapper._no_mark, split=False)
    assert bool(fused[4].accepted)
    for a, b in zip(fused[:2], halves[:2]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert torch.equal(fused[2].nodes, halves[2].nodes) and torch.equal(fused[3], halves[3])
    for x, y in zip(fused[4], halves[4]):
        assert torch.equal(x, y)
    # half B leaves the store it was given as it was (the split's rollback
    # snapshot of the frame between the halves)
    for x, y in zip(kfs, kfs_a):
        assert torch.equal(x, y)


# -------------------------------------------------------------- profiling


def test_profiling_stages():
    """tests/test_aux.py:99-111 for the port."""
    profiling.enable(True)
    try:
        with profiling.stage("unit_test_stage", sync=torch.ones(8)):
            _ = torch.ones(8).sum()
        rep = profiling.report(reset=True)
        assert "unit_test_stage" in rep
        assert rep["unit_test_stage"]["count"] == 1
    finally:
        profiling.enable(False)


@pytest.mark.parametrize("split", [False, True])
def test_profiling_stage_report_in_system(seq, split):
    """tests/test_aux.py:210-240 for the port, fused and split."""
    profiling.enable(True)
    profiling.report(reset=True)
    try:
        _port(seq, seq.frames[:5], split_keyframe_dispatch=split)
        rows = profiling.report(reset=True)
    finally:
        profiling.enable(False)
    assert "frame.dispatch" in rows and rows["frame.dispatch"]["count"] >= 4
    assert "frame.finalize" in rows
    if split:
        assert rows["keyframe.dispatch_a"]["count"] == rows["keyframe.dispatch_b"]["count"] == 1
    else:
        assert rows["keyframe.dispatch"]["count"] == 1


def test_profiling_off_records_nothing():
    profiling.report(reset=True)
    with profiling.stage("off_stage"):
        pass
    assert "off_stage" not in profiling.report()


def test_readback_on_the_cpu_is_a_ready_copy():
    x = torch.arange(6, dtype=torch.int32)
    rb = Readback.start((x, x.float().reshape(2, 3)))
    x += 100  # the copy was taken at start
    assert rb.ready()
    a, b = rb.get()
    assert isinstance(a, np.ndarray) and a.tolist() == list(range(6)) and b.shape == (2, 3)
