"""The keyframe mapping chain of the PyTorch port (``mapping/mapper.py``,
``mapstore/state.insert_keyframe_from_matches``) against the JAX package's,
on the CPU.

The fixture tracks a 160x120 sequence with the JAX ``System`` up to the
frame of its second keyframe, commits that frame by hand, and walks the
first half of the JAX keyframe chain stage by stage; every stage of the
port is fed the JAX stage's inputs (through ``convert.py``) and compared
with its outputs.  Then both packages run the whole ``keyframe_step`` from
that state.

Tolerances: integer tables, masks and counts are exact.  Warp control
points 2e-3 of the largest (see tests/test_torch_warp.py), the warps'
values and derivatives at the matched points 1e-3; solved normals 2e-3;
SfN control depths, template nodes, point positions and the pose 5e-3;
``reg_scale`` 1e-3.  The float stages feed gates (pixel error, covariance,
2.5x median, chi limit); the fixture's data keeps clear of them, so the
gated counts are compared exactly too.

Every scatter of the chain whose indices can repeat has a test with
repeated indices, against the JAX function on the CPU (where updates land
in order, so the last writer wins).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from defslam_tpu.config import (
    CapacityConfig, Config, MappingConfig, OrbConfig, SfTConfig, TrackingConfig,
)
from defslam_tpu.io.synthetic import make_sequence
from defslam_tpu.mapping import mapper as jmapper
from defslam_tpu.mapping import warp as jwarp
from defslam_tpu.mapstore import state as jstore
from defslam_tpu.system import System as JaxSystem
from defslam_tpu_torch.convert import config_from_dict, state_from_numpy, to_numpy_dict
from defslam_tpu_torch.mapping import mapper as tmapper
from defslam_tpu_torch.mapping import registration as treg
from defslam_tpu_torch.mapstore import state as tstore

torch.set_num_threads(2)

KF_FRAME = 8  # keyframe_period 4: keyframes at frames 4 and 8


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(t, j, tol):
    t, j = _np(t), _np(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    np.testing.assert_allclose(t, j, rtol=0, atol=tol * max(1.0, np.abs(j[np.isfinite(j)]).max()))


def _same(t, j):
    t, j = _np(t), _np(j)
    if j.dtype == np.uint32:
        j = j.view(np.int32)
    assert t.shape == j.shape and np.array_equal(t, j), (t, j)


def _tt(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if a.dtype == np.int32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a, copy=True))


def _copy(tree):
    return jax.tree.map(jnp.copy, tree)


@pytest.fixture(scope="module")
def cfgs():
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
    return seq, cfg, config_from_dict(dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def before_kf(cfgs):
    """The JAX system's state just before its second keyframe step: frames
    0..7 tracked (one keyframe step at frame 4), frame 8 tracked and
    committed by hand."""
    seq, cfg, _ = cfgs
    js = JaxSystem(cfg)
    for t in range(KF_FRAME):
        js.track_monocular(seq.frames[t], timestamp=float(t))
    js.flush()
    feats, matches, res, new_points, _ = js._track_frame(jnp.asarray(seq.frames[KF_FRAME]))
    js.frame_id += 1
    js.prev_pose, js.pose = js.pose, res.T
    js.template = js.template._replace(nodes=res.nodes)
    js.points = new_points
    assert js.kf_counter == 2 and int(js.kfs.valid.sum()) == 2
    return js, feats, matches, res


def _port_state(js, feats, matches, **extra):
    return state_from_numpy(to_numpy_dict(
        points=js.points, kfs=js.kfs, template=js.template, pose=js.pose,
        feats=feats, matches=matches, **extra), "cpu")


@pytest.fixture(scope="module")
def chain(cfgs, before_kf):
    """The first half of the JAX keyframe chain, stage by stage (the body of
    ``_kf_step_a`` with the free slot known to be 2)."""
    _, cfg, _ = cfgs
    js, feats, matches, res = before_kf
    c = cfg
    slot = jnp.asarray(2, jnp.int32)
    out = {}
    kfs, n_obs = jstore.insert_keyframe_from_matches(
        _copy(js.kfs), js.points.n_obs, slot, js.pose, feats, matches.kp_of_point, res.inlier,
        js.K, jnp.asarray(js.frame_id, jnp.int32), js.points.xyz)
    points = js.points._replace(n_obs=n_obs)
    out["inserted"] = (_copy(kfs), points)
    cp = jmapper.covis_pairs(kfs.point_id, kfs.retina, kfs.valid, points.valid, slot, c)
    out["cp"] = cp
    batch = jmapper.WarpBatch(uv1=cp.uv1, uv2=cp.uv2, mask=cp.mask, pair_valid=cp.pair_valid)
    dps, ctrls = jmapper.fit_warps(batch, js.dom, js.bend_warp, c)
    out["dps"], out["ctrls"] = dps, ctrls
    best, _ = jmapper.densify_matches(
        ctrls, kfs.retina[slot], kfs.kp_valid[slot], kfs.desc[slot], kfs.retina[cp.pair_kf],
        kfs.kp_valid[cp.pair_kf], kfs.desc[cp.pair_kf], js.dom, cp.pair_valid, c)
    best = jnp.where(cp.pair_valid[:, None], best, -1)
    out["best"] = best
    pid2, n_obs3 = jmapper.apply_densify(jnp.copy(kfs.point_id), points.n_obs, slot, cp.pair_kf, best)
    out["densified"] = (pid2, n_obs3)
    kfs = kfs._replace(point_id=pid2)
    points = points._replace(n_obs=n_obs3)
    desc = jmapper.distinctive_descriptors(kfs.point_id, kfs.valid, kfs.kp_valid, kfs.desc, points.desc)
    out["desc"] = desc
    points = points._replace(desc=desc)
    obs, obs_dropped = jmapper.accumulate_obs_device(
        cp.pid_table, dps.mask, cp.uv1, dps.warped, dps.J12, dps.Huu, dps.Hvv,
        points.capacity, jmapper.OBS_CAP)
    out["obs"] = (obs, obs_dropped)
    nres = jmapper.solve_normals_compact(
        obs, points.norm_k0, min(feats.capacity, points.capacity),
        num_iters=c.mapping.normal_lm_iterations)
    out["nres"] = nres
    solved_ok = jmapper.normal_reliability_gate(nres, c.regularizer.reliability)
    out["solved_ok"] = solved_ok
    pid_row = kfs.point_id[slot]
    norm_k, norm_valid, n_written = jmapper.write_normals(
        kfs.norm_k, kfs.norm_valid, slot, pid_row, nres.k, solved_ok)
    out["written"] = (norm_k, norm_valid, n_written)
    out["propagated"] = jmapper.propagate_normals(norm_k, norm_valid, cp, dps, nres.k, solved_ok)
    out["kfs"], out["points"] = kfs, points
    out["n_new"] = jmapper.exploration_count(kfs.xy[slot], kfs.kp_valid[slot], pid_row, c)
    out["sel"] = jmapper.select_ref_keyframe(pid_row, points.ref_kf, points.valid, kfs.valid, slot)
    return out


# ------------------------------------------------------------- stage parity


def test_insert_keyframe_from_matches(cfgs, before_kf, chain):
    _, _, tcfg = cfgs
    js, feats, matches, res = before_kf
    ms = _port_state(js, feats, matches)
    kfs, n_obs = tstore.insert_keyframe_from_matches(
        ms.kfs, ms.points.n_obs, 2, ms.pose, ms.feats, ms.matches.kp_of_point,
        _tt(res.inlier), torch.as_tensor(tcfg.camera.K), js.frame_id, ms.points.xyz)
    jk, jp = chain["inserted"]
    _same(n_obs, jp.n_obs)
    for f in ("point_id", "kp_valid", "kp_xyz_valid", "valid", "frame_id", "desc", "level"):
        _same(getattr(kfs, f), getattr(jk, f))
    for f in ("pose", "retina", "kp_xyz", "xy", "angle"):
        _close(getattr(kfs, f), getattr(jk, f), 1e-6)
    assert int((kfs.point_id[2] >= 0).sum()) > 100


def _port_cp(chain):
    return state_from_numpy(to_numpy_dict(covis=chain["cp"], diff_props=chain["dps"]), "cpu")


def test_covis_pairs(cfgs, chain):
    _, _, tcfg = cfgs
    jk, jp = chain["inserted"]
    cp = tmapper.covis_pairs(_tt(jk.point_id), _tt(jk.retina), _tt(jk.valid), _tt(jp.valid), 2, tcfg)
    ref = chain["cp"]
    for f in tmapper.CovisPairs._fields:
        _same(getattr(cp, f), getattr(ref, f))
    assert int(cp.n_pairs) == 2 and int(cp.mask.sum()) > 200


def test_fit_warps(cfgs, before_kf, chain):
    _, _, tcfg = cfgs
    js = before_kf[0]
    ms = _port_cp(chain)
    cp = ms.covis
    batch = tmapper.WarpBatch(uv1=cp.uv1, uv2=cp.uv2, mask=cp.mask, pair_valid=cp.pair_valid)
    dps, ctrls = tmapper.fit_warps(batch, _tt(js.dom), _tt(js.bend_warp), tcfg)
    v = np.asarray(cp.pair_valid)
    _close(ctrls[v], np.asarray(chain["ctrls"])[v], 2e-3)
    ref = chain["dps"]
    _same(dps.mask, ref.mask)
    m = np.asarray(ref.mask)
    assert m.sum() > 200
    for f in ("warped", "J12", "J21", "Huu", "Huv", "Hvv"):
        _close(getattr(dps, f)[m], np.asarray(getattr(ref, f))[m], 1e-3)


def test_densify_matches_on_tracked_keyframes(cfgs, before_kf, chain):
    _, _, tcfg = cfgs
    js = before_kf[0]
    jk, _ = chain["inserted"]
    cp = chain["cp"]
    pk = np.asarray(cp.pair_kf)
    best, _ = tmapper.densify_matches(
        _tt(chain["ctrls"]), _tt(jk.retina[2]), _tt(jk.kp_valid[2]), _tt(jk.desc[2]).int(),
        _tt(jk.retina)[pk], _tt(jk.kp_valid)[pk], _tt(jk.desc).int()[pk], _tt(js.dom),
        _tt(cp.pair_valid), tcfg)
    best = torch.where(_tt(cp.pair_valid)[:, None], best, -1)
    _same(best, chain["best"])
    assert int((best >= 0).sum()) > 100


def test_apply_densify(chain):
    jk, jp = chain["inserted"]
    pid, n_obs = tmapper.apply_densify(_tt(jk.point_id), _tt(jp.n_obs).int(), 2,
                                       _tt(chain["cp"].pair_kf), _tt(chain["best"]))
    _same(pid, chain["densified"][0])
    _same(n_obs, chain["densified"][1])
    assert not np.array_equal(_np(pid), np.asarray(jk.point_id))


def test_distinctive_descriptors(chain):
    kfs, (_, jp) = chain["kfs"], chain["inserted"]
    out = tmapper.distinctive_descriptors(_tt(kfs.point_id), _tt(kfs.valid), _tt(kfs.kp_valid),
                                          _tt(kfs.desc).int(), _tt(jp.desc).int())
    _same(out, chain["desc"])
    assert not np.array_equal(_np(out), np.asarray(jp.desc).view(np.int32))


def test_accumulate_obs_device(chain):
    ms = _port_cp(chain)
    cp, dps = ms.covis, ms.diff_props
    p_cap = chain["points"].capacity
    obs, dropped = tmapper.accumulate_obs_device(
        cp.pid_table, dps.mask, cp.uv1, dps.warped, dps.J12, dps.Huu, dps.Hvv, p_cap,
        tmapper.OBS_CAP)
    ref, ref_dropped = chain["obs"]
    assert int(dropped) == int(ref_dropped)
    for f in tmapper.nrm.PairObs._fields:  # a regrouping: every value is a copy
        _same(getattr(obs, f), getattr(ref, f))


def test_accumulate_obs_device_past_the_cap():
    rng = np.random.default_rng(0)
    pid = rng.integers(-1, 6, (3, 40)).astype(np.int32)  # ~17 observations a point, cap 4
    mask = rng.uniform(size=(3, 40)) > 0.2
    vals = {k: rng.normal(size=(3, 40) + s).astype(np.float32)
            for k, s in dict(uv1=(2,), warped=(2,), J12=(2, 2), Huu=(2,), Hvv=(2,)).items()}
    ref, ref_dropped = jmapper.accumulate_obs_device(
        jnp.asarray(pid), jnp.asarray(mask), *(jnp.asarray(v) for v in vals.values()), 8, 4)
    obs, dropped = tmapper.accumulate_obs_device(
        _tt(pid), _tt(mask), *(_tt(v) for v in vals.values()), 8, 4)
    assert int(dropped) == int(ref_dropped) > 0
    for f in tmapper.nrm.PairObs._fields:
        _same(getattr(obs, f), getattr(ref, f))


def test_solve_normals_compact_and_gate(cfgs, chain):
    _, cfg, tcfg = cfgs
    ref_obs, _ = chain["obs"]
    obs = state_from_numpy(to_numpy_dict(pair_obs=ref_obs), "cpu").pair_obs
    points = chain["points"]
    nres = tmapper.solve_normals_compact(obs, _tt(points.norm_k0), 512,
                                         num_iters=tcfg.mapping.normal_lm_iterations)
    ref = chain["nres"]
    _same(nres.n_obs, ref.n_obs)
    _same(nres.valid, ref.valid)
    ok = tmapper.normal_reliability_gate(nres, tcfg.regularizer.reliability)
    _same(ok, chain["solved_ok"])
    m = np.asarray(chain["solved_ok"])
    assert m.sum() > 100
    _close(nres.k[m], np.asarray(ref.k)[m], 2e-3)
    # capacity >= P takes the uncompacted path: same result
    full = tmapper.solve_normals_compact(obs, _tt(points.norm_k0), 4096,
                                         num_iters=tcfg.mapping.normal_lm_iterations)
    assert torch.allclose(full.k[m], nres.k[m], atol=1e-6)


def test_write_and_propagate_normals(chain):
    kfs = chain["kfs"]
    nres, ok = chain["nres"], chain["solved_ok"]
    nk, nv, n = tmapper.write_normals(_tt(kfs.norm_k), _tt(kfs.norm_valid), 2, _tt(kfs.point_id[2]),
                                      _tt(nres.k), _tt(ok))
    _close(nk, chain["written"][0], 1e-6)
    _same(nv, chain["written"][1])
    assert int(n) == int(chain["written"][2]) > 100
    ms = _port_cp(chain)
    pk, pv = tmapper.propagate_normals(nk, nv, ms.covis, ms.diff_props, _tt(nres.k), _tt(ok))
    _same(pv, chain["propagated"][1])
    _close(pk, chain["propagated"][0], 1e-5)
    assert int(pv.sum()) > int(nv.sum())


def test_exploration_count_and_ref_keyframe(cfgs, chain):
    _, _, tcfg = cfgs
    kfs, points = chain["kfs"], chain["points"]
    assert (tcfg.camera.width // 20) % 2 == 0  # the even dilation window
    n_new = tmapper.exploration_count(_tt(kfs.xy[2]), _tt(kfs.kp_valid[2]), _tt(kfs.point_id[2]), tcfg)
    assert int(n_new) == int(chain["n_new"]) > 0
    sel = tmapper.select_ref_keyframe(_tt(kfs.point_id[2]), _tt(points.ref_kf), _tt(points.valid),
                                      _tt(kfs.valid), 2)
    assert int(sel) == int(chain["sel"])


@pytest.mark.parametrize("width", [160, 100, 640])
def test_exploration_count_window_parity(cfgs, width):
    """Even (8, 32) and odd (5) dilation windows, keypoints at the border."""
    _, cfg, _ = cfgs
    cam = dataclasses.replace(cfg.camera, width=width, height=90)
    c = dataclasses.replace(cfg, camera=cam)
    tc = config_from_dict(dataclasses.asdict(c))
    rng = np.random.default_rng(width)
    xy = np.stack([rng.uniform(-2, width + 2, 300), rng.uniform(-2, 92, 300)], -1).astype(np.float32)
    valid = rng.uniform(size=300) > 0.1
    pid = np.where(rng.uniform(size=300) > 0.7, rng.integers(0, 50, 300), -1).astype(np.int32)
    ref = jmapper.exploration_count(jnp.asarray(xy), jnp.asarray(valid), jnp.asarray(pid), c)
    out = tmapper.exploration_count(_tt(xy), _tt(valid), _tt(pid), tc)
    assert int(out) == int(ref) > 0


def test_select_ref_keyframe_ties_and_fallback():
    pid_row = np.array([0, 1, 2, 3, -1, 9], np.int32)
    ref_kf = np.array([2, 1, 1, 2, 0, 0, 0, 0, 0, 3], np.int32)
    pv = np.ones(10, bool)
    kv = np.array([True, True, True, False])
    for kfv, pvv in ((kv, pv), (kv, np.zeros(10, bool))):
        ref = jmapper.select_ref_keyframe(jnp.asarray(pid_row), jnp.asarray(ref_kf), jnp.asarray(pvv),
                                          jnp.asarray(kfv), jnp.asarray(3, jnp.int32))
        out = tmapper.select_ref_keyframe(_tt(pid_row), _tt(ref_kf), _tt(pvv), _tt(kfv), 3)
        assert int(out) == int(ref)
    assert int(tmapper.select_ref_keyframe(_tt(pid_row), _tt(ref_kf), _tt(pv), _tt(kv), 3)) == 1


def test_bbox_domain():
    rng = np.random.default_rng(1)
    uv = rng.uniform(-0.4, 0.5, (50, 2)).astype(np.float32)
    fb = np.array([-1, 1, -1, 1], np.float32)
    for valid in (rng.uniform(size=50) > 0.3, np.arange(50) < 3):
        ref = jmapper.bbox_domain(jnp.asarray(uv), jnp.asarray(valid), jnp.asarray(fb), margin=0.1)
        _close(tmapper.bbox_domain(_tt(uv), _tt(valid), _tt(fb), margin=0.1), ref, 1e-6)


def test_cull_points(cfgs, chain):
    kfs, points = chain["kfs"], chain["points"]
    ms = state_from_numpy(to_numpy_dict(points=points), "cpu")
    for kfc in (2, 3, 1 << 30):
        ref, ref_n = jmapper.cull_points(_copy(points), kfs.point_id, kfs.valid, kfc)
        out, n = tmapper.cull_points(ms.points, _tt(kfs.point_id), _tt(kfs.valid), kfc)
        assert int(n) == int(ref_n)
        _same(out.valid, ref.valid)


# ---------------------------------------------- scatters with repeated indices


def _small_cfg(cfgs, **cap):
    _, cfg, _ = cfgs
    c = dataclasses.replace(
        cfg, orb=dataclasses.replace(cfg.orb, max_keypoints=32),
        capacity=CapacityConfig(max_map_points=64, max_keyframes=4, max_warp_pairs=3),
        mapping=dataclasses.replace(cfg.mapping, min_shared_points=3),
    )
    return c, config_from_dict(dataclasses.asdict(c))


def test_covis_pairs_with_duplicate_point_ids(cfgs):
    """After densification two keypoints of one keyframe can carry one
    point id: the inverse table keeps the higher keypoint index."""
    c, tc = _small_cfg(cfgs)
    rng = np.random.default_rng(2)
    point_id = rng.integers(-1, 20, (4, 32)).astype(np.int32)  # ids repeat within rows
    retina = rng.normal(size=(4, 32, 2)).astype(np.float32)
    kf_valid = np.array([True, True, True, False])
    pv = rng.uniform(size=64) > 0.1
    ref = jmapper.covis_pairs(jnp.asarray(point_id), jnp.asarray(retina), jnp.asarray(kf_valid),
                              jnp.asarray(pv), jnp.asarray(1, jnp.int32), c)
    out = tmapper.covis_pairs(_tt(point_id), _tt(retina), _tt(kf_valid), _tt(pv), 1, tc)
    for f in tmapper.CovisPairs._fields:
        _same(getattr(out, f), getattr(ref, f))
    assert int(out.n_pairs) == 2 and tmapper.PAIR_CAP > 64  # the padded-table branch too


def test_insert_keyframe_with_two_points_on_one_keypoint(cfgs):
    from defslam_tpu.frontend import Features as JFeatures

    c, tc = _small_cfg(cfgs)
    rng = np.random.default_rng(3)
    feats = JFeatures(
        xy=jnp.asarray(rng.uniform(0, 100, (32, 2)).astype(np.float32)),
        response=jnp.ones(32), level=jnp.zeros(32, jnp.int32), angle=jnp.zeros(32),
        desc=jnp.asarray(rng.integers(0, 2**32, (32, 8), dtype=np.uint32)),
        valid=jnp.ones(32, bool))
    kp_of_point = rng.integers(-1, 10, 64).astype(np.int32)  # many points per keypoint
    inlier = rng.uniform(size=64) > 0.2
    xyz = rng.normal(size=(64, 3)).astype(np.float32)
    K = jnp.asarray(c.camera.K)
    jk, jn = jstore.insert_keyframe_from_matches(
        jstore.empty_keyframes(c), jnp.zeros(64, jnp.int32), jnp.asarray(1, jnp.int32), jnp.eye(4),
        feats, jnp.asarray(kp_of_point), jnp.asarray(inlier), K, jnp.asarray(7, jnp.int32),
        jnp.asarray(xyz))
    tf = state_from_numpy(to_numpy_dict(feats=feats), "cpu").feats
    tk, tn = tstore.insert_keyframe_from_matches(
        tstore.empty_keyframes(tc, "cpu"), torch.zeros(64, dtype=torch.int32), 1, torch.eye(4), tf,
        _tt(kp_of_point), _tt(inlier), torch.as_tensor(tc.camera.K), 7, _tt(xyz))
    _same(tk.point_id, jk.point_id)
    _same(tk.kp_xyz_valid, jk.kp_xyz_valid)
    _same(tk.kp_xyz, jk.kp_xyz)
    _same(tn, jn)
    assert int(tn.sum()) > int((tk.point_id[1] >= 0).sum())  # there were collisions


def test_apply_densify_with_colliding_pairs():
    """Several pairs match one keypoint of the new keyframe, and several
    keypoints match one keypoint of another: the last pair in order wins
    both tables."""
    rng = np.random.default_rng(4)
    F_, K_, P_, NP_ = 4, 24, 40, 3
    point_id = np.where(rng.uniform(size=(F_, K_)) > 0.5, rng.integers(0, P_, (F_, K_)), -1).astype(np.int32)
    n_obs = rng.integers(0, 5, P_).astype(np.int32)
    kf_idx = np.array([0, 2, 2], np.int32)  # two pairs on one keyframe
    best = rng.integers(-1, 6, (NP_, K_)).astype(np.int32)  # few targets: collisions
    ref_pid, ref_n = jmapper.apply_densify(jnp.asarray(point_id), jnp.asarray(n_obs),
                                           jnp.asarray(1, jnp.int32), jnp.asarray(kf_idx),
                                           jnp.asarray(best))
    pid, n = tmapper.apply_densify(_tt(point_id), _tt(n_obs).int(), 1, _tt(kf_idx), _tt(best))
    _same(pid, ref_pid)
    _same(n, ref_n)
    assert not np.array_equal(_np(pid), point_id)


def test_propagate_normals_with_colliding_observations():
    rng = np.random.default_rng(5)
    NP_, C_, F_, K_, P_ = 3, 30, 4, 16, 20
    cp = jmapper.CovisPairs(
        pair_kf=jnp.asarray([0, 2, 2], jnp.int32), pair_valid=jnp.ones(NP_, bool),
        pid_table=jnp.asarray(rng.integers(-1, P_, (NP_, C_)).astype(np.int32)),
        uv1=jnp.zeros((NP_, C_, 2)), uv2=jnp.zeros((NP_, C_, 2)),
        kp_new=jnp.zeros((NP_, C_), jnp.int32),
        kp_other=jnp.asarray(rng.integers(-1, 5, (NP_, C_)).astype(np.int32)),  # collisions
        mask=jnp.ones((NP_, C_), bool), n_pairs=jnp.asarray(3), n_pair_dropped=jnp.asarray(0),
        n_pt_dropped=jnp.asarray(0))
    f = lambda *s: jnp.asarray(rng.normal(size=s).astype(np.float32))  # noqa: E731
    J12 = jnp.eye(2) + 0.1 * f(NP_, C_, 2, 2)
    dps = jwarp.DiffProps(uv1=f(NP_, C_, 2), uv2=f(NP_, C_, 2), warped=f(NP_, C_, 2), J12=J12,
                          J21=jnp.linalg.inv(J12), Huu=f(NP_, C_, 2), Huv=f(NP_, C_, 2),
                          Hvv=f(NP_, C_, 2), mask=jnp.asarray(rng.uniform(size=(NP_, C_)) > 0.2))
    k_solved, ok = f(P_, 2), jnp.asarray(rng.uniform(size=P_) > 0.2)
    nk0, nv0 = f(F_, K_, 2), jnp.zeros((F_, K_), bool)
    ref_k, ref_v = jmapper.propagate_normals(nk0, nv0, cp, dps, k_solved, ok)
    ms = state_from_numpy(to_numpy_dict(covis=cp, diff_props=dps), "cpu")
    out_k, out_v = tmapper.propagate_normals(_tt(nk0), _tt(nv0), ms.covis, ms.diff_props,
                                             _tt(k_solved), _tt(ok))
    _same(out_v, ref_v)
    _close(out_k, ref_k, 1e-5)
    assert int(out_v.sum()) < int(np.asarray(ok)[np.asarray(cp.pid_table)].sum())  # collisions


# ------------------------------------------------------------ the second half


@pytest.fixture(scope="module")
def second_half(cfgs, before_kf, chain):
    """SfN, registration pairs, registration and template regeneration of
    the JAX package on the chain's stores (template keyframe = the new one,
    which is exploring)."""
    _, cfg, _ = cfgs
    js = before_kf[0]
    norm_k, norm_valid = chain["propagated"]
    kfs = chain["kfs"]._replace(norm_k=norm_k, norm_valid=norm_valid)
    points = chain["points"]
    kf_t = 2
    sres = jmapper.integrate_surface(kfs.retina[kf_t], kfs.norm_k[kf_t], kfs.norm_valid[kf_t],
                                     js.dom, js.bend_sfn, cfg, ext_dom=js.dom)
    pairs = jmapper.registration_pairs(
        sres.xyz, kfs.point_id[kf_t], kfs.kp_xyz[kf_t], kfs.kp_xyz_valid[kf_t],
        kfs.norm_valid[kf_t], points.valid, points.facet, kfs.pose[kf_t])
    reg = jmapper.register_surface(pairs[0], pairs[1], pairs[2], cfg)
    regen = jmapper.regen_template(sres.ctrl, reg, kfs.pose[kf_t], kfs.retina[kf_t], js.dom, cfg)
    return kfs, points, sres, pairs, reg, regen


def test_integrate_surface_and_registration(cfgs, before_kf, second_half):
    _, _, tcfg = cfgs
    js = before_kf[0]
    kfs, points, sres, pairs, reg, _ = second_half
    out = tmapper.integrate_surface(_tt(kfs.retina[2]), _tt(kfs.norm_k[2]), _tt(kfs.norm_valid[2]),
                                    _tt(js.dom), _tt(js.bend_sfn), tcfg, ext_dom=_tt(js.dom))
    assert bool(out.ok) and bool(sres.ok)
    _close(out.ctrl, sres.ctrl, 5e-3)
    _close(out.xyz, sres.xyz, 5e-3)
    tp = tmapper.registration_pairs(
        _tt(sres.xyz), _tt(kfs.point_id[2]), _tt(kfs.kp_xyz[2]), _tt(kfs.kp_xyz_valid[2]),
        _tt(kfs.norm_valid[2]), _tt(points.valid), _tt(points.facet), _tt(kfs.pose[2]))
    _same(tp[2], pairs[2])
    _same(tp[3], pairs[3])
    _close(tp[1], pairs[1], 1e-6)
    treg_ = tmapper.register_surface(tp[0], tp[1], tp[2], tcfg)
    assert bool(treg_.accepted) == bool(reg.accepted) is True
    assert int(treg_.n_pairs) == int(reg.n_pairs) > 15
    _close(treg_.s, reg.s, 1e-3)
    _close(treg_.R, reg.R, 1e-3)
    _close(treg_.t, reg.t, 1e-3)


def _port_reg(reg):
    return treg.RegistrationResult(*(_tt(v) for v in reg))


def test_regen_template_and_rebuild_points(cfgs, before_kf, second_half):
    _, cfg, tcfg = cfgs
    js = before_kf[0]
    kfs, points, sres, _, reg, regen = second_half
    out = tmapper.regen_template(_tt(sres.ctrl), _port_reg(reg), _tt(kfs.pose[2]), _tt(kfs.retina[2]),
                                 _tt(js.dom), tcfg)
    _close(out.template.nodes, regen.template.nodes, 1e-4)
    _close(out.template.rest_len, regen.template.rest_len, 1e-4)
    _close(out.point_xyz, regen.point_xyz, 1e-4)
    _same(out.point_facet, regen.point_facet)
    _same(out.point_inside, regen.point_inside)
    ref_pts, ref_row = jmapper.rebuild_points(
        _copy(points), regen, kfs.pose[2], js.K, kfs.point_id[2], kfs.kp_valid[2], kfs.desc[2],
        kfs.angle[2], jnp.asarray(2, jnp.int32), js.dom, cfg, 2)
    ms = state_from_numpy(to_numpy_dict(points=points, template=regen.template), "cpu")
    tregen = tmapper.TemplateRegen(ms.template, _tt(regen.point_xyz), _tt(regen.point_facet),
                                   _tt(regen.point_bary), _tt(regen.point_inside))
    pts, row = tmapper.rebuild_points(
        ms.points, tregen, _tt(kfs.pose[2]), torch.as_tensor(tcfg.camera.K), _tt(kfs.point_id[2]),
        _tt(kfs.kp_valid[2]), _tt(kfs.desc[2]).int(), _tt(kfs.angle[2]), 2, _tt(js.dom), tcfg, 2)
    _same(row, ref_row)
    for f in ("valid", "facet", "ref_kf", "ref_kp", "n_obs", "n_visible", "n_found", "first_kf", "desc"):
        _same(getattr(pts, f), getattr(ref_pts, f))
    for f in ("xyz", "bary", "angle", "norm_k0"):
        _close(getattr(pts, f), getattr(ref_pts, f), 1e-5)
    assert int(pts.valid.sum()) > int(np.asarray(points.valid).sum())  # new points were made


def test_rebuild_points_with_two_keypoints_on_one_point(cfgs, before_kf, second_half):
    _, cfg, tcfg = cfgs
    js = before_kf[0]
    kfs, points, _, _, _, regen = second_half
    pid_row = np.asarray(kfs.point_id[2]).copy()
    have = np.nonzero(pid_row >= 0)[0]
    pid_row[have[1::2]] = pid_row[have[0:len(have[1::2]) * 2:2]]  # pairs of keypoints share a point
    ref_pts, ref_row = jmapper.rebuild_points(
        _copy(points), regen, kfs.pose[2], js.K, jnp.asarray(pid_row), kfs.kp_valid[2], kfs.desc[2],
        kfs.angle[2], jnp.asarray(2, jnp.int32), js.dom, cfg, 2)
    ms = state_from_numpy(to_numpy_dict(points=points, template=regen.template), "cpu")
    tregen = tmapper.TemplateRegen(ms.template, _tt(regen.point_xyz), _tt(regen.point_facet),
                                   _tt(regen.point_bary), _tt(regen.point_inside))
    pts, row = tmapper.rebuild_points(
        ms.points, tregen, _tt(kfs.pose[2]), torch.as_tensor(tcfg.camera.K), _tt(pid_row),
        _tt(kfs.kp_valid[2]), _tt(kfs.desc[2]).int(), _tt(kfs.angle[2]), 2, _tt(js.dom), tcfg, 2)
    _same(row, ref_row)
    _same(pts.xyz, ref_pts.xyz)  # copies of the same rows: the same winner
    _same(pts.facet, ref_pts.facet)


def test_polish_surface(cfgs, before_kf, second_half):
    _, cfg, tcfg = cfgs
    js = before_kf[0]
    kfs, _, sres, pairs, reg, _ = second_half
    c = dataclasses.replace(cfg, mapping=dataclasses.replace(cfg.mapping, consistency_polish=2.0))
    tc = config_from_dict(dataclasses.asdict(c))
    ref = jmapper.polish_surface(sres.ctrl, reg, kfs.retina[2], pairs[1], pairs[3], js.dom,
                                 js.bend_sfn, c, grid_dom=js.dom)
    out = tmapper.polish_surface(_tt(sres.ctrl), _port_reg(reg), _tt(kfs.retina[2]), _tt(pairs[1]),
                                 _tt(pairs[3]), _tt(js.dom), _tt(js.bend_sfn), tc, grid_dom=_tt(js.dom))
    _close(out, ref, 2e-3)
    assert not np.allclose(_np(out), np.asarray(sres.ctrl), atol=1e-4)
    same = tmapper.polish_surface(_tt(sres.ctrl), _port_reg(reg), _tt(kfs.retina[2]), _tt(pairs[1]),
                                  _tt(pairs[3]), _tt(js.dom), _tt(js.bend_sfn), tcfg)
    _same(same, sres.ctrl)  # consistency_polish = 0: untouched


# ------------------------------------------------------------- the whole step


def test_keyframe_step_matches_reference(cfgs, before_kf):
    """Both packages run the whole fused step from the same state."""
    _, cfg, tcfg = cfgs
    js, feats, matches, res = before_kf
    ms = _port_state(js, feats, matches)
    jk, jp, jt, jpose, jd = jmapper.keyframe_step(
        _copy(js.kfs), _copy(js.points), js.template, js.pose, feats, matches.kp_of_point,
        res.inlier, js.K, js.dom, js.bend_warp, js.bend_sfn,
        jnp.asarray(js.template_ref_kf, jnp.int32), jnp.asarray(js.kf_counter, jnp.int32),
        jnp.asarray(js.frame_id, jnp.int32), cfg)
    stages = []
    tk, tp, ttm, tpose, td = tmapper.keyframe_step(
        ms.kfs, ms.points, ms.template, ms.pose, ms.feats, ms.matches.kp_of_point,
        _tt(res.inlier), torch.as_tensor(tcfg.camera.K), _tt(js.dom), _tt(js.bend_warp),
        _tt(js.bend_sfn), js.template_ref_kf, js.kf_counter, js.frame_id, tcfg,
        mark=lambda name, **_: stages.append(name))
    assert stages == ["start", "insert", "warps", "densify", "normals", "sfn_registration", "retemplate",
                      "reanchor", "cull"]
    for f in tmapper.MappingDiag._fields:
        if f == "reg_scale":
            assert float(td.reg_scale) == pytest.approx(float(jd.reg_scale), rel=1e-3)
        else:
            assert int(getattr(td, f)) == int(getattr(jd, f)), f
    assert bool(td.accepted) and int(td.n_pairs) == 2 and int(td.slot) == 2
    # keyframe store
    for f in ("point_id", "kp_valid", "kp_xyz_valid", "valid", "frame_id", "norm_valid",
              "surf_valid", "desc"):
        _same(getattr(tk, f), getattr(jk, f))
    for f in ("pose", "retina", "kp_xyz", "surf_dom"):
        _close(getattr(tk, f), getattr(jk, f), 1e-5)
    nv = np.asarray(jk.norm_valid)
    _close(tk.norm_k[nv], np.asarray(jk.norm_k)[nv], 5e-3)
    _close(tk.surf_ctrl, jk.surf_ctrl, 5e-3)
    # point store
    for f in ("valid", "facet", "ref_kf", "ref_kp", "n_obs", "n_visible", "n_found", "first_kf", "desc"):
        _same(getattr(tp, f), getattr(jp, f))
    live = np.asarray(jp.valid)
    _close(tp.xyz[live], np.asarray(jp.xyz)[live], 5e-3)
    _close(tp.bary[live], np.asarray(jp.bary)[live], 5e-3)
    # template and pose after the re-anchoring SfT
    _close(ttm.nodes, jt.nodes, 5e-3)
    _close(ttm.nodes_rest, jt.nodes_rest, 5e-3)
    _close(tpose, jpose, 5e-3)


def test_keyframe_step_without_pairs_skips_the_chain(cfgs):
    """A first keyframe with nothing covisible: no pairs, the gate is shut,
    nothing is swapped, and only culling and bookkeeping run."""
    seq, cfg, tcfg = cfgs
    from defslam_tpu_torch.system import System

    s = System(tcfg, device="cpu")
    s.track_monocular(seq.frames[0])
    s.kfs.valid[0] = False  # forget the initial keyframe
    stages = []
    s._kf_mark = lambda name, **_: stages.append(name)
    for t in range(1, 5):
        s.track_monocular(seq.frames[t])
    d = s.last_map_diag
    assert stages == ["start", "insert", "warps", "densify", "normals", "cull"]
    assert d.n_pairs == 0 and not d.accepted and d.reg_scale == 1.0 and d.slot == 0
