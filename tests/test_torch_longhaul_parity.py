"""The long-haul path of the PyTorch port against the JAX package, on the
CPU, on a short run that reaches every branch of the JAX package's
long-haul stress run (tests/test_stress_longhaul.py) under the default
pipelined protocol.

The run: 36 frames at 160x120 (camera_motion 1.0, frames 18-22 blank),
300 features, 3 levels, 384 keypoints, 15 LM iterations, a keyframe every
4 frames and a 3-slot keyframe store, both packages fed the same frames.
It takes 5 evictions, a blank frame dispatched optimistically and rolled
back, an optimistic keyframe (frame 20, from a LOST state) that evicts a
slot and is undone from its store snapshot, failed relocalizations on the
blank frames and a successful one after them.

Tolerances and why:

- States, keyframe and template flags, the ``frame`` column, the
  relocalization outcomes and the keyframe store's frame ids and valid
  flags after every call: equal.  They are the protocol's integers.
- Matches within max(2, 3x) and inliers within max(3, 3x) the largest gap
  a 1e-7 relative perturbation of the JAX package's template after frame 0
  has opened in the JAX run's counts by that frame, the pose within
  max(2e-2, 3x) the probe's largest pose gap so far: the free-run rule of
  tests/test_torch_pipeline.py, taken over the run so far because the port
  and the probe are two perturbations of one ill-conditioned run (ROADMAP
  C), and one shows at another frame than the other (frame 17: the probe
  moves the inliers by 1 and the port by 4, after the probe moved them by
  10 at frame 13).  After the occlusion the probe moves the reference's
  own counts by up to 100 and its pose by up to 1.06.
- The synchronous run of the port against its pipelined run: every
  metrics column but ``frame`` equal, the trajectory within 1e-6, the
  stores equal.  A frame replayed after a rollback takes the newest frame
  id in the JAX package, and the port copies that (ROADMAP C).
- The keyframe step at capacity from the JAX package's state: the slot
  chosen, the store's integer tables and the observation counts equal.
- The render at the stress run's parameters: frames within 1e-3 (the port
  blurs the texture in numpy, the JAX package with OpenCV), poses and
  depths equal; the port's pooled render equal to one call, bit for bit.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from defslam_tpu.config import (
    CapacityConfig, Config, MappingConfig, OrbConfig, SfTConfig, TrackingConfig,
)
from defslam_tpu.geometry import camera as jcam
from defslam_tpu.geometry import se3 as jse3
from defslam_tpu.io.synthetic import make_sequence as jax_make_sequence
from defslam_tpu.mapping import mapper as jmapper
from defslam_tpu.system import System as JaxSystem
from defslam_tpu.tracking import pose_opt as jpose_opt
from defslam_tpu_torch import system as tsystem
from defslam_tpu_torch.convert import config_from_dict, state_from_numpy, to_numpy_dict
from defslam_tpu_torch.groundtruth import gt as tgt
from defslam_tpu_torch.io import synthetic as tsyn
from defslam_tpu_torch.mapping import mapper as tmapper
from defslam_tpu_torch.system import System
from defslam_tpu_torch.tracking import pose_opt as tpose_opt

torch.set_num_threads(2)

N_FRAMES = 36
OCCLUSION = (18, 22)
SLOTS = 3
PERTURB = 1e-7
HISTORY_CAP = 4  # the template history's cap in these runs (256 by default)
# the long-haul stress run's render (tests/test_stress_longhaul.py), cut to
# 24 frames with the occlusion moved inside them
STRESS_RENDER = dict(n_frames=24, height=120, width=160, max_amp=0.07, camera_motion=0.9,
                     seed=9, occlusion=(10, 12), rotation_deg=16, deform_modes=3,
                     brightness_drift=0.1)


@pytest.fixture(scope="module")
def seq():
    return jax_make_sequence(n_frames=N_FRAMES, height=120, width=160, max_amp=0.08,
                             camera_motion=1.0, occlusion=OCCLUSION)


def _cfg(seq):
    return Config(
        camera=seq.camera,
        orb=OrbConfig(n_features=300, n_levels=3, max_keypoints=384),
        sft=SfTConfig(lm_iterations=15),
        tracking=TrackingConfig(keyframe_period=4),
        capacity=CapacityConfig(max_map_points=1024, max_keyframes=SLOTS),
        mapping=MappingConfig(points_to_template=60, chi_limit=0.2),
    )


def _port_cfg(cfg, **tracking):
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    return dataclasses.replace(tcfg, tracking=dataclasses.replace(tcfg.tracking, **tracking))


def _run(system, frames, pose_opt_module, perturb=0.0):
    """Track every frame; after each call the keyframe store's frame ids and
    valid flags; every relocalization's outcome; then flush."""
    outcomes = []
    real = pose_opt_module.relocalize

    def counted(*a, **k):
        out = real(*a, **k)
        outcomes.append(bool(out[0]))
        return out

    store = []
    pose_opt_module.relocalize = counted
    try:
        for t, f in enumerate(frames):
            system.track_monocular(f, timestamp=float(t))
            if t == 0 and perturb:
                noise = np.random.default_rng(1).normal(0, perturb, (system.cfg.mesh.n_nodes, 3))
                system.template = system.template._replace(
                    nodes=system.template.nodes * (1 + jnp.asarray(noise, jnp.float32)))
            store.append((np.asarray(system.kfs.frame_id).tolist(),
                          np.asarray(system.kfs.valid).tolist()))
        system.flush()
    finally:
        pose_opt_module.relocalize = real
    return dict(system=system, store=store, relocs=outcomes)


@pytest.fixture(scope="module")
def runs(seq):
    """The JAX run, its 1e-7 probe, the port pipelined (with the slots its
    ``_choose_slot`` picks) and synchronous; the template history capped at
    ``HISTORY_CAP`` in both packages, so that the run overflows it."""
    cfg = _cfg(seq)
    slots = []
    real_choose = tmapper._choose_slot

    def choose(kfs, points, tmpl_ref_kf):
        slot = real_choose(kfs, points, tmpl_ref_kf)
        slots.append((int(slot), int(tmpl_ref_kf), bool(kfs.valid.all())))
        return slot

    caps = (tsystem.TEMPLATE_HISTORY_CAP, JaxSystem._record_template_history.__defaults__)
    tsystem.TEMPLATE_HISTORY_CAP = HISTORY_CAP
    JaxSystem._record_template_history.__defaults__ = (HISTORY_CAP,)
    tmapper._choose_slot = choose
    try:
        port = _run(System(_port_cfg(cfg), device="cpu"), seq.frames, tpose_opt)
        tmapper._choose_slot = real_choose
        port["slots"] = slots
        return {
            "jax": _run(JaxSystem(cfg), seq.frames, jpose_opt),
            "probe": _run(JaxSystem(cfg), seq.frames, jpose_opt, perturb=PERTURB),
            "port": port,
            "sync": _run(System(_port_cfg(cfg, pipelined=False), device="cpu"), seq.frames,
                         tpose_opt),
        }
    finally:
        tmapper._choose_slot = real_choose
        tsystem.TEMPLATE_HISTORY_CAP, JaxSystem._record_template_history.__defaults__ = caps


def test_longhaul_run_reaches_every_branch(runs):
    """Evictions at capacity (never of the template's source), a rollback
    that undoes an optimistic keyframe's eviction, a failed and a
    successful relocalization: in the port and in the JAX package."""
    port, ref = runs["port"], runs["jax"]
    s = port["system"]
    n_kf = sum(1 for m in s._metrics if m["keyframe"])
    assert n_kf - SLOTS >= 4
    full = [(slot, ref_kf) for slot, ref_kf, was_full in port["slots"] if was_full]
    assert len(full) >= 4 and all(slot != ref_kf for slot, ref_kf in full), full
    assert s.n_rollbacks >= 2
    # an optimistic keyframe evicted a slot, and the rollback put it back
    undone = [t for t in range(1, N_FRAMES - 1)
              if port["store"][t][0] != port["store"][t - 1][0]
              and port["store"][t + 1][0] == port["store"][t - 1][0]]
    assert undone, port["store"]
    for r in (port, ref):
        assert False in r["relocs"] and True in r["relocs"], r["relocs"]
    assert [m["state"] for m in s._metrics[OCCLUSION[0]:OCCLUSION[1] + 1]] == ["LOST"] * 5
    assert all(m["state"] == "OK" for m in s._metrics[OCCLUSION[1] + 1:])
    assert bool(s.kfs.valid.all())


def test_longhaul_protocol_matches_reference(runs):
    """States, flags, frame ids, relocalization outcomes and the keyframe
    store after every call equal the JAX package's."""
    port, ref = runs["port"], runs["jax"]
    ms, mj = port["system"]._metrics, ref["system"]._metrics
    assert len(ms) == len(mj) == N_FRAMES
    for a, b in zip(ms, mj):
        for k in ("frame", "t", "state", "keyframe", "template"):
            assert a[k] == b[k], (k, a, b)
    assert port["relocs"] == ref["relocs"]
    assert port["store"] == ref["store"]
    assert port["system"].n_rollbacks >= 2
    # the template history past its cap, a rollback at the cap included
    hist = [f for f, _ in port["system"].template_history]
    assert hist == [f for f, _ in ref["system"].template_history]
    assert len(hist) == HISTORY_CAP < sum(m["keyframe"] for m in ms)


def test_depth_error_matches_reference(runs, seq):
    """The final median depth error of the port's ``gt.system_depth_error``
    against the JAX long-haul test's own computation, on the JAX run's
    final state."""
    js = runs["jax"]["system"]
    depth = seq.depths[N_FRAMES - 1]
    pc = jse3.transform(js.pose, js.points.xyz)
    uv = np.asarray(jcam.project(js.K, pc))
    pc = np.asarray(pc)
    valid = np.asarray(js.points.valid) & (np.asarray(js.points.facet) >= 0) & (pc[:, 2] > 1e-6)
    x = np.clip(uv[:, 0].round().astype(int), 0, depth.shape[1] - 1)
    y = np.clip(uv[:, 1].round().astype(int), 0, depth.shape[0] - 1)
    hh, ww = depth.shape
    inb = (uv[:, 0] >= 0) & (uv[:, 0] < ww) & (uv[:, 1] >= 0) & (uv[:, 1] < hh)
    m = valid & inb
    gt_z, z = depth[y[m], x[m]], pc[m, 2]
    s = np.median(gt_z / np.maximum(z, 1e-9))
    med = float(np.median(np.abs(s * z - gt_z) / np.maximum(gt_z, 1e-9)))
    ms = state_from_numpy(to_numpy_dict(points=js.points, pose=js.pose), "cpu")
    err, n = tgt.system_depth_error(
        SimpleNamespace(pose=ms.pose, points=ms.points, K=torch.as_tensor(np.asarray(js.K))),
        depth)
    assert n == int(m.sum()) >= 50
    assert err == pytest.approx(med, rel=1e-5)


def test_longhaul_counts_and_pose_match_reference(runs):
    """Counts and poses within the free-run rule (the module docstring)."""
    ms = runs["port"]["system"]._metrics
    mj, mq = runs["jax"]["system"]._metrics, runs["probe"]["system"]._metrics
    probe = {"matches": 0, "inliers": 0}
    for a, b, q in zip(ms, mj, mq):
        for k, floor in (("matches", 2), ("inliers", 3)):
            probe[k] = max(probe[k], abs(q[k] - b[k]))
            assert abs(a[k] - b[k]) <= max(floor, 3 * probe[k]), (k, a, b, q)
    tt, tj, tq = (runs[k]["system"].trajectory for k in ("port", "jax", "probe"))
    assert len(tt) == len(tj) == len(tq)
    probe_gap = 0.0
    for (ts, Tt), (tsj, Tj), (tsq, Tq) in zip(tt, tj, tq):
        assert ts == tsj == tsq
        Tj = np.asarray(Tj)
        probe_gap = max(probe_gap, float(np.abs(np.asarray(Tq) - Tj).max()))
        bound = max(2e-2, 3 * probe_gap)
        assert float(np.abs(np.asarray(Tt) - Tj).max()) <= bound, (ts, bound)


def test_longhaul_pipelined_rows_equal_synchronous(runs):
    """The port's synchronous run gives the pipelined run's rows (all but
    the replayed rows' ``frame``), trajectory and stores."""
    a, b = runs["port"]["system"], runs["sync"]["system"]
    assert len(a._metrics) == len(b._metrics)
    replayed = 0
    for ra, rb in zip(a._metrics, b._metrics):
        assert {k: v for k, v in ra.items() if k != "frame"} == \
            {k: v for k, v in rb.items() if k != "frame"}
        replayed += ra["frame"] != rb["frame"]
    assert replayed and b.n_rollbacks == 0
    assert [t for t, _ in a.trajectory] == [t for t, _ in b.trajectory]
    for (_, Ta), (_, Tb) in zip(a.trajectory, b.trajectory):
        np.testing.assert_allclose(Ta, Tb, atol=1e-6)
    for f in ("frame_id", "valid", "point_id"):
        assert torch.equal(getattr(a.kfs, f), getattr(b.kfs, f)), f
    assert torch.equal(a.points.valid, b.points.valid)
    assert runs["sync"]["relocs"] == runs["port"]["relocs"]


def test_two_blank_frames_row_matches_reference(seq):
    """Two blank frames, then a trackable one: the rollback's replays both
    end LOST, the next frame is still dispatched optimistically and passes
    validation, and keeps the row it was recorded with in the LOST state,
    in the JAX package and in the port alike (ROADMAP C)."""
    frames = [np.full_like(f, 128.0) if t in (6, 7) else f for t, f in enumerate(seq.frames[:10])]
    cfg = _cfg(seq)
    port = _run(System(_port_cfg(cfg), device="cpu"), frames, tpose_opt)["system"]
    ref = _run(JaxSystem(cfg), frames, jpose_opt)["system"]
    for a, b in zip(port._metrics, ref._metrics):
        assert (a["frame"], a["state"], a["keyframe"], a["template"]) == \
            (b["frame"], b["state"], b["keyframe"], b["template"]), (a, b)
        assert abs(a["inliers"] - b["inliers"]) <= 3, (a, b)
    row = port._metrics[8]
    assert row["state"] == "LOST" and row["inliers"] >= port.cfg.tracking.min_inliers_ok
    assert [t for t, _ in port.trajectory] == [t for t, _ in ref.trajectory]
    assert 8.0 in [t for t, _ in port.trajectory]


@pytest.fixture(scope="module")
def full_store(seq):
    """The JAX system's state at frame 12, its keyframe frame, with the
    3-slot store full (keyframes 0, 4, 8): frames 0-11 tracked
    synchronously, frame 12 tracked and committed by hand."""
    cfg = dataclasses.replace(_cfg(seq), tracking=TrackingConfig(keyframe_period=4,
                                                                 pipelined=False))
    js = JaxSystem(cfg)
    for t in range(12):
        js.track_monocular(seq.frames[t], timestamp=float(t))
    feats, matches, res, new_points, _ = js._track_frame(jnp.asarray(seq.frames[12]))
    js.frame_id += 1
    js.prev_pose, js.pose = js.pose, res.T
    js.template = js.template._replace(nodes=res.nodes)
    js.points = new_points
    assert np.asarray(js.kfs.valid).all()
    return cfg, js, feats, matches, res


@pytest.mark.parametrize("tmpl_ref_kf", [None, 0])
def test_keyframe_step_at_capacity_matches_reference(full_store, tmpl_ref_kf):
    """Both packages' fused keyframe step from the full store: the slot
    evicted, the store's frame ids, valid flags and keypoint-to-point
    tables, and every observation count equal.  With the oldest keyframe
    made the template's source (``tmpl_ref_kf`` 0), it is not evicted."""
    cfg, js, feats, matches, res = full_store
    tcfg = _port_cfg(cfg)
    ref_kf = js.template_ref_kf if tmpl_ref_kf is None else tmpl_ref_kf
    ms = state_from_numpy(to_numpy_dict(
        points=js.points, kfs=js.kfs, template=js.template, pose=js.pose,
        feats=feats, matches=matches), "cpu")
    jk, jp, _, _, jd = jmapper.keyframe_step(
        jax.tree.map(jnp.copy, js.kfs), jax.tree.map(jnp.copy, js.points), js.template, js.pose,
        feats, matches.kp_of_point, res.inlier, js.K, js.dom, js.bend_warp, js.bend_sfn,
        jnp.asarray(ref_kf, jnp.int32), jnp.asarray(js.kf_counter, jnp.int32),
        jnp.asarray(js.frame_id, jnp.int32), cfg)
    tk, tp, _, _, td = tmapper.keyframe_step(
        ms.kfs, ms.points, ms.template, ms.pose, ms.feats, ms.matches.kp_of_point,
        torch.from_numpy(np.asarray(res.inlier)), torch.as_tensor(tcfg.camera.K),
        torch.from_numpy(np.asarray(js.dom)), torch.from_numpy(np.asarray(js.bend_warp)),
        torch.from_numpy(np.asarray(js.bend_sfn)), ref_kf, js.kf_counter, js.frame_id, tcfg)
    assert int(td.slot) == int(jd.slot) != ref_kf
    if tmpl_ref_kf == 0:
        assert int(td.slot) == 1  # the oldest evictable keyframe
    assert int(tk.frame_id[int(td.slot)]) == js.frame_id
    # the evicted keyframe's table is overwritten, and its points keep the
    # counts the JAX package leaves them
    for f in ("frame_id", "valid", "point_id", "kp_valid"):
        assert np.array_equal(getattr(tk, f).numpy(), np.asarray(getattr(jk, f))), f
    for f in ("n_obs", "valid", "ref_kf", "first_kf"):
        assert np.array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f))), f


def test_stress_render_matches_reference():
    """The port's render at the stress run's parameters against the JAX
    package's."""
    a = jax_make_sequence(**STRESS_RENDER)
    b = tsyn.make_sequence(**STRESS_RENDER)
    assert np.abs(a.frames - b.frames).max() <= 1e-3
    assert np.array_equal(a.poses, b.poses) and np.array_equal(a.depths, b.depths)
    assert np.array_equal(a.mode_amps, b.mode_amps)
    lo, hi = STRESS_RENDER["occlusion"]
    assert (b.frames[lo:hi + 1] == 128.0).all()


def test_render_pieces_equal_one_call():
    """Frames rendered in pieces (``start`` / ``stop``, as chip_smoke.py's
    long-haul phase renders them on worker processes) equal one call's, bit
    for bit."""
    one = tsyn.make_sequence(**STRESS_RENDER)
    n = STRESS_RENDER["n_frames"]
    pieces = [tsyn.make_sequence(**STRESS_RENDER, start=a, stop=min(a + 5, n))
              for a in range(0, n, 5)]
    for f in ("frames", "depths", "poses", "amps", "mode_amps"):
        assert np.array_equal(np.concatenate([getattr(p, f) for p in pieces]),
                              getattr(one, f)), f
    assert all(p.camera == one.camera for p in pieces)
    piece = tsyn.make_sequence(**STRESS_RENDER, start=9, stop=14)
    assert np.array_equal(piece.frames, one.frames[9:14])
    assert np.array_equal(piece.depths, one.depths[9:14])
