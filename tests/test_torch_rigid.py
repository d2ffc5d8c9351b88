"""The rigid mode's libraries in the PyTorch port against the JAX package
(``rigid/{initializer,triangulation,culling,ba}.py``, ``geometry/se3``'s
Sim(3) additions), on the CPU, on the same seeded numpy inputs; the
scenes are those of ``tests/test_rigid_{init,triangulation,ba}.py``.

Tolerances and why:

- ``draw_sets`` on ``jax.random.uniform``'s numbers gives
  ``jax.random.choice``'s sets exactly (the same inverse-CDF search).
- ``two_view_init`` on JAX-drawn sets: ok, the model choice and the
  triangulated count equal; R and t within 1e-4 and the good points'
  structure within 1e-3 relative (float32 SVDs of the same matrices by
  two LAPACK builds; which of the 12 hypotheses carries the winner may
  differ, the winner may not).
- Triangulation, fusion, culling and the replacement table: integers
  exact, triangulated points within 1e-4 (the same 4x4 eigenproblems).
- ``ba_solve``: poses within 1e-4, points within 5e-4, inlier sets equal
  (15 float32 LM iterations; the segment sums pair their terms
  differently).  ``optimize_sim3`` within 1e-4, inliers equal.
  ``optimize_essential_graph`` within 1e-4 (a 56-unknown LM, the
  Jacobian by forward mode here and ``jax.jacfwd`` there).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from defslam_tpu.geometry import se3 as jse3
from defslam_tpu.rigid import ba as jba
from defslam_tpu.rigid import culling as jcull
from defslam_tpu.rigid import initializer as jini
from defslam_tpu.rigid import triangulation as jtri
from defslam_tpu_torch.geometry import se3
from defslam_tpu_torch.rigid import ba, culling, initializer, triangulation as tri

torch.set_num_threads(2)

K_INIT = np.array([[500.0, 0.0, 320.0], [0.0, 500.0, 240.0], [0.0, 0.0, 1.0]], np.float32)
K_BA = np.array([[400.0, 0.0, 160.0], [0.0, 400.0, 120.0], [0.0, 0.0, 1.0]], np.float32)


def T(a):
    return torch.as_tensor(np.array(a, copy=True))


def _uniforms(key):
    return np.asarray(jax.random.uniform(key, (initializer.RANSAC_ITERS, 8)))


# ----------------------------------------------------------- se3 / Sim(3)


def test_so3_log_and_sim3_exp_match_reference():
    rng = np.random.default_rng(0)
    w = (rng.normal(0, 0.8, (64, 3)) * rng.uniform(0, 1, (64, 1)) ** 4).astype(np.float32)
    w[:4] = [[0, 0, 0], [1e-7, 0, 0], [0, 2e-5, 1e-5], [0.3, -0.2, 0.1]]
    R = np.asarray(jse3.so3_exp(jnp.asarray(w)))
    np.testing.assert_allclose(se3.so3_log(T(R)).numpy(), np.asarray(jse3.so3_log(jnp.asarray(R))),
                               atol=2e-6)
    xi = rng.normal(0, 0.3, (16, 7)).astype(np.float32)
    for a, b in zip(se3.sim3_exp(T(xi)), jse3.sim3_exp(jnp.asarray(xi))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    p = rng.normal(0, 1, (16, 5, 3)).astype(np.float32)
    s, Rs, t = (np.asarray(v) for v in jse3.sim3_exp(jnp.asarray(xi)))
    np.testing.assert_allclose(se3.sim3_apply(T(s), T(Rs), T(t), T(p)).numpy(),
                               np.asarray(jse3.sim3_apply(*(jnp.asarray(v) for v in (s, Rs, t, p)))),
                               atol=1e-5)


def test_so3_log_forward_derivative_is_finite_at_identity():
    """The safe-where pattern: the derivative of log(exp(w)) at w = 0 is
    the identity, finite, as ``jax.jacfwd`` gives it."""
    def f(w):
        return se3.so3_log(se3.so3_exp(w))

    J = torch.func.jacfwd(f)(torch.zeros(3))
    Jj = jax.jacfwd(lambda w: jse3.so3_log(jse3.so3_exp(w)))(jnp.zeros(3))
    assert torch.isfinite(J).all()
    np.testing.assert_allclose(J.numpy(), np.asarray(Jj), atol=1e-6)
    np.testing.assert_allclose(J.numpy(), np.eye(3), atol=1e-6)


# ------------------------------------------------------------ initializer


@pytest.mark.parametrize("seed", range(6))
def test_draw_sets_gives_jax_random_choice(seed):
    rng = np.random.default_rng(seed)
    n = 1536 if seed % 2 == 0 else 200
    mask = rng.uniform(size=n) < rng.uniform(0.05, 0.95)
    key = jax.random.PRNGKey(seed + 7)
    p = jnp.asarray(mask, jnp.float32)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    ref = np.asarray(jax.random.choice(key, n, shape=(200, 8), replace=True, p=p))
    got = initializer.draw_sets(T(mask), T(_uniforms(key)))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert mask[got.numpy()].all()


def _rot(axis, deg):
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    th = np.radians(deg)
    Kx = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def _two_view(X, R, t, n_pad=512, noise=0.3, seed=0):
    """tests/test_rigid_init.py's correspondences."""
    rng = np.random.default_rng(seed)

    def proj(R_, t_):
        Xc = X @ np.asarray(R_).T + np.asarray(t_)
        return np.stack([500 * Xc[:, 0] / Xc[:, 2] + 320, 500 * Xc[:, 1] / Xc[:, 2] + 240], -1), Xc[:, 2]

    xy1, z1 = proj(np.eye(3), np.zeros(3))
    xy2, z2 = proj(R, t)
    ok = (z1 > 0.1) & (z2 > 0.1)
    ok &= (np.abs(xy1[:, 0] - 320) < 310) & (np.abs(xy1[:, 1] - 240) < 230)
    ok &= (np.abs(xy2[:, 0] - 320) < 310) & (np.abs(xy2[:, 1] - 240) < 230)
    xy1 = xy1 + rng.normal(0, noise, xy1.shape)
    xy2 = xy2 + rng.normal(0, noise, xy2.shape)
    n = X.shape[0]
    p1 = np.zeros((n_pad, 2), np.float32)
    p2 = np.zeros((n_pad, 2), np.float32)
    m = np.zeros(n_pad, bool)
    p1[:n], p2[:n], m[:n] = xy1, xy2, ok
    return p1, p2, m


def _scene(case):
    if case == "general":
        rng = np.random.default_rng(1)
        X = rng.uniform([-2, -1.5, 4.0], [2, 1.5, 9.0], (300, 3))
        return X, _rot([0.2, 1.0, 0.1], 6.0), np.array([0.4, 0.02, 0.05])
    if case == "planar":
        rng = np.random.default_rng(2)
        uv = rng.uniform([-2, -1.5], [2, 1.5], (300, 2))
        X = np.stack([uv[:, 0], uv[:, 1], 6.0 + 0.3 * uv[:, 0]], axis=-1)
        return X, _rot([0.0, 1.0, 0.0], 8.0), np.array([0.6, 0.05, 0.1])
    if case == "rotation":
        rng = np.random.default_rng(3)
        X = rng.uniform([-2, -1.5, 4.0], [2, 1.5, 9.0], (300, 3))
        return X, _rot([0, 1, 0], 3.0), np.zeros(3) + 1e-6
    rng = np.random.default_rng(4)  # too few matches
    X = rng.uniform([-2, -1.5, 4.0], [2, 1.5, 9.0], (30, 3))
    return X, _rot([0.2, 1.0, 0.1], 6.0), np.array([0.4, 0.0, 0.0])


@pytest.mark.parametrize("case,ok,used_h", [("general", True, False), ("planar", True, True),
                                            ("rotation", False, None), ("few", False, None)])
def test_two_view_init_matches_reference(case, ok, used_h):
    p1, p2, m = _two_view(*_scene(case))
    key = jax.random.PRNGKey(3)
    ref = jax.device_get(jini.two_view_init_jit(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(m),
                                                jnp.asarray(K_INIT), key))
    sets = initializer.draw_sets(T(m), T(_uniforms(key)))
    got = initializer.two_view_init(T(p1), T(p2), T(m), T(K_INIT), sets)
    assert bool(got.ok) == bool(ref.ok) == ok
    assert bool(got.used_h) == bool(ref.used_h)
    assert int(got.n_good) == int(ref.n_good)
    if not ok:
        return
    assert bool(got.used_h) == used_h
    np.testing.assert_allclose(got.R.numpy(), ref.R, atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), ref.t, atol=1e-4)
    np.testing.assert_array_equal(got.good.numpy(), ref.good)
    g = ref.good
    np.testing.assert_allclose(got.xyz.numpy()[g], ref.xyz[g], rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------- triangulation

SIG2 = np.asarray(jtri.level_sigma2(8, 1.2))


def _rig(n=200, seed=0):
    """tests/test_rigid_triangulation.py's two-view rig."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-2, -1.5, 4.0], [2, 1.5, 9.0], (n, 3)).astype(np.float32)
    th = np.radians(5.0)
    R2 = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]], np.float32)
    T1 = np.eye(4, dtype=np.float32)
    T2 = np.eye(4, dtype=np.float32)
    T2[:3, :3], T2[:3, 3] = R2, [-0.5, 0.0, 0.0]

    def proj(Tm):
        Xc = X @ Tm[:3, :3].T + Tm[:3, 3]
        return np.stack([500 * Xc[:, 0] / Xc[:, 2] + 320, 500 * Xc[:, 1] / Xc[:, 2] + 240],
                        -1).astype(np.float32)

    desc = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    return X, T1, T2, proj(T1), proj(T2), desc, rng


def test_level_sigma2_and_fundamental_match_reference():
    np.testing.assert_allclose(tri.level_sigma2(8, 1.2).numpy(), SIG2, rtol=1e-6)
    _, T1, T2, *_ = _rig()
    F_ref = np.asarray(jtri.fundamental_from_poses(jnp.asarray(T1), jnp.asarray(T2), jnp.asarray(K_INIT)))
    np.testing.assert_allclose(tri.fundamental_from_poses(T(T1), T(T2), T(K_INIT)).numpy(), F_ref,
                               rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("bound", [0, 40])
def test_search_and_triangulate_match_reference(bound):
    """Epipolar search (B1's plain version), then triangulation: the match
    indices exactly, the acceptance mask exactly, the points within 1e-4.
    ``bound``: keypoints already bound to map points in both keyframes."""
    n = 200
    X, T1, T2, xy1, xy2, desc, rng = _rig(n)
    perm = rng.permutation(n)
    xy2s, descs = xy2[perm], desc[perm]
    lvl = rng.integers(0, 3, n).astype(np.int32)
    ang1 = rng.uniform(0, 0.2, n).astype(np.float32)
    ang2 = ang1[perm] + 0.05
    pid = np.full(n, -1, np.int32)
    pid[:bound] = np.arange(bound)
    valid = np.ones(n, bool)
    valid[-5:] = False
    F12 = jtri.fundamental_from_poses(jnp.asarray(T1), jnp.asarray(T2), jnp.asarray(K_INIT))
    args = (xy1, desc, valid, ang1, pid, xy2s, descs, valid, ang2, pid, lvl)
    ref = jtri.search_for_triangulation(*(jnp.asarray(a) for a in args), F12, jnp.asarray(SIG2))
    got = tri.search_for_triangulation(*(T(a.view(np.int32) if a.dtype == np.uint32 else a)
                                         for a in args), T(np.asarray(F12)), T(SIG2))
    np.testing.assert_array_equal(got.idx2.numpy(), np.asarray(ref.idx2))
    found = np.asarray(ref.idx2) >= 0
    np.testing.assert_array_equal(got.dist.numpy()[found], np.asarray(ref.dist)[found])
    assert found.sum() > 0.8 * (n - 2 * bound - 5)  # bound in both, in another order

    targs = (T1, T2, K_INIT, xy1, lvl, xy2s, lvl)
    rt = jtri.triangulate_matches(*(jnp.asarray(a) for a in targs), ref.idx2, jnp.asarray(SIG2), 1.2)
    gt = tri.triangulate_matches(*(T(a) for a in targs), got.idx2, T(SIG2), 1.2)
    ok = np.asarray(rt.ok)
    np.testing.assert_array_equal(gt.ok.numpy(), ok)
    assert ok.sum() > 0.8 * found.sum()
    np.testing.assert_allclose(gt.xyz.numpy()[ok], np.asarray(rt.xyz)[ok], rtol=1e-4, atol=1e-4)


def test_triangulation_rejects_low_parallax_as_reference():
    n = 100
    X, T1, _, xy1, _, _, _ = _rig(n)
    T2 = np.eye(4, dtype=np.float32)
    T2[0, 3] = 1e-5
    Xc = X @ T2[:3, :3].T + T2[:3, 3]
    xy2 = np.stack([500 * Xc[:, 0] / Xc[:, 2] + 320, 500 * Xc[:, 1] / Xc[:, 2] + 240], -1).astype(np.float32)
    lvl = np.zeros(n, np.int32)
    idx = np.arange(n, dtype=np.int32)
    targs = (T1, T2, K_INIT, xy1, lvl, xy2, lvl)
    rt = jtri.triangulate_matches(*(jnp.asarray(a) for a in targs), jnp.asarray(idx), jnp.asarray(SIG2), 1.2)
    gt = tri.triangulate_matches(*(T(a) for a in targs), T(idx.astype(np.int64)), T(SIG2), 1.2)
    np.testing.assert_array_equal(gt.ok.numpy(), np.asarray(rt.ok))
    assert gt.ok.sum() < 0.05 * n


@pytest.mark.parametrize("radius", [3.0, 4.0])
def test_fuse_into_keyframe_matches_reference(radius):
    n = 120
    X, T1, T2, xy1, xy2, desc, rng = _rig(n)
    pid = np.full(n, -1, np.int32)
    pid[:60] = np.arange(60)
    valid = np.ones(n, bool)
    pts_valid = rng.uniform(size=n) < 0.9
    lvl = rng.integers(0, 2, n).astype(np.int32)
    xyz = X + rng.normal(0, 0.003, X.shape).astype(np.float32)
    args = (xyz, desc, pts_valid, T2, K_INIT, xy2, desc, valid, lvl, pid)
    ref = jtri.fuse_into_keyframe(*(jnp.asarray(a) for a in args), jnp.asarray(SIG2), 640, 480,
                                  radius=radius)
    got = tri.fuse_into_keyframe(*(T(a.view(np.int32) if a.dtype == np.uint32 else a)
                                   for a in args), T(SIG2), 640, 480, radius=radius)
    np.testing.assert_array_equal(got.kp_idx.numpy(), np.asarray(ref.kp_idx))
    np.testing.assert_array_equal(got.existing_pid.numpy(), np.asarray(ref.existing_pid))
    assert (got.kp_idx.numpy() >= 0).sum() > 0.8 * pts_valid.sum()


@pytest.mark.parametrize("seed", range(3))
def test_apply_replacements_matches_reference(seed):
    """Random tables and merge lists with repeated sources (the last
    writer wins in both) and -1 padding."""
    rng = np.random.default_rng(seed)
    p_cap = 64
    tables = rng.integers(-1, p_cap, (6, 40)).astype(np.int32)
    src = rng.integers(-1, p_cap, 20).astype(np.int32)
    dst = rng.integers(0, p_cap, 20).astype(np.int32)
    ref = np.asarray(jtri.apply_replacements(jnp.asarray(tables), jnp.asarray(src), jnp.asarray(dst), p_cap))
    got = tri.apply_replacements(T(tables.astype(np.int64)), T(src.astype(np.int64)),
                                 T(dst.astype(np.int64)), p_cap)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_apply_replacements_lut():
    out = tri.apply_replacements(torch.tensor([[0, 1, 2, -1], [3, 2, 0, 1]]), torch.tensor([2, 0, -1]),
                                 torch.tensor([7, 5, 0]), 8)
    assert out.tolist() == [[5, 1, 7, -1], [3, 7, 5, 1]]


# ---------------------------------------------------------------- culling


def _cull_case(seed):
    if seed < 0:  # tests/test_rigid_ba.py's case
        P, F = 40, 4
        point_id = np.full((F, P), -1, np.int32)
        point_id[:3] = np.arange(P)
        point_id[3, :30] = np.arange(30)
        return point_id, np.zeros((F, P), np.int32), point_id >= 0, np.ones(F, bool), np.ones(P, bool)
    rng = np.random.default_rng(seed)
    F, K, P = 8, 50, 60
    point_id = np.where(rng.uniform(size=(F, K)) < 0.7, rng.integers(0, P, (F, K)), -1).astype(np.int32)
    level = rng.integers(0, 4, (F, K)).astype(np.int32)
    return (point_id, level, rng.uniform(size=(F, K)) < 0.95, rng.uniform(size=F) < 0.9,
            rng.uniform(size=P) < 0.9)


@pytest.mark.parametrize("seed", [-1, 0, 1, 2])
def test_redundancy_and_pick_cull_match_reference(seed):
    args = _cull_case(seed)
    ref = np.asarray(jcull.redundancy_ratios(*(jnp.asarray(a) for a in args)))
    got = culling.redundancy_ratios(*(T(a.astype(np.int64) if a.dtype == np.int32 else a) for a in args))
    np.testing.assert_array_equal(got.numpy(), ref)
    F = args[0].shape[0]
    for protect in (np.arange(F) == 0, np.zeros(F, bool)):
        for th in (0.9, 0.3):
            r = int(jcull.pick_cull(jnp.asarray(ref), jnp.asarray(protect), th))
            assert int(culling.pick_cull(got, T(protect), th)) == r
    if seed < 0:
        assert got[3] == 1.0 and int(culling.pick_cull(got, T(np.arange(F) == 0))) == 3


# --------------------------------------------------------------------- BA


def _ba_scene(rng, n_cams=6, n_pts=120, noise_px=0.3):
    """tests/test_rigid_ba.py's scene."""
    pts = rng.uniform([-1.0, -0.8, 3.0], [1.0, 0.8, 5.0], size=(n_pts, 3)).astype(np.float32)
    poses = np.stack([np.asarray(jse3.se3_exp(jnp.array(
        [0.25 * c, 0.02 * c, 0.01 * c, 0.0, 0.04 * c, 0.01 * c], jnp.float32))) for c in range(n_cams)])
    pc = np.einsum("cij,pj->cpi", poses[:, :3, :3], pts) + poses[:, None, :3, 3]
    uv = np.stack([400 * pc[..., 0] / pc[..., 2] + 160, 400 * pc[..., 1] / pc[..., 2] + 120], -1)
    return poses, pts, (uv + rng.normal(0, noise_px, uv.shape)).astype(np.float32)


def _problem(seed):
    rng = np.random.default_rng(seed)
    poses_gt, pts_gt, uv = _ba_scene(rng)
    C, P = poses_gt.shape[0], pts_gt.shape[0]
    pid = np.broadcast_to(np.arange(P)[None], (C, P)).astype(np.int32).copy()
    poses = np.stack([np.asarray(jse3.se3_exp(jnp.asarray(rng.normal(0, 0.02, 6), jnp.float32)
                                              * (1.0 if c >= 2 else 0.0))) @ poses_gt[c]
                      for c in range(C)]).astype(np.float32)
    xyz = (pts_gt + rng.normal(0, 0.05, (P, 3))).astype(np.float32)
    obs = np.ones((C, P), bool)
    if seed == 1:  # gross outliers in camera 3, missing observations, a fixed point
        uv[3, :10] += 40.0
        pid[4, 50:60] = -1
        obs[5, 60:64] = False
    point_free = np.ones(P, bool)
    point_free[7] = seed != 1
    inv_s2 = np.ones((C, P), np.float32) / (1.2 ** (2 * (np.arange(P) % 3)))[None]
    return (poses, xyz, pid, uv, inv_s2.astype(np.float32), obs, np.arange(C) >= 2, point_free)


@pytest.mark.parametrize("seed", [0, 1])
def test_ba_solve_matches_reference(seed):
    arrays = _problem(seed)
    ref = jba.ba_solve(jba.BAProblem(*(jnp.asarray(a) for a in arrays)), jnp.asarray(K_BA))
    got = ba.ba_solve(ba.BAProblem(*(T(a.astype(np.int64) if a.dtype == np.int32 else a)
                                     for a in arrays)), T(K_BA))
    np.testing.assert_array_equal(got.inlier.numpy(), np.asarray(ref.inlier))
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(ref.poses), atol=1e-4)
    np.testing.assert_allclose(got.xyz.numpy(), np.asarray(ref.xyz), atol=5e-4)
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=1e-3)
    if seed == 1:
        assert not got.inlier[3, :10].any()


def test_segment_sum_matches_reference():
    rng = np.random.default_rng(5)
    vals = rng.normal(0, 1, (500, 9)).astype(np.float32)
    seg = rng.integers(-2, 60, 500)
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(np.where(seg < 0, 60, seg)),
                                         num_segments=61))[:60]
    got = ba.segment_sum(T(vals), T(seg), 60)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_optimize_sim3_matches_reference():
    rng = np.random.default_rng(2)
    n = 80
    x2 = rng.uniform([-1, -1, 3], [1, 1, 6], (n, 3)).astype(np.float32)
    s_gt = jnp.asarray(1.4, jnp.float32)
    R_gt = jse3.so3_exp(jnp.array([0.1, -0.2, 0.05], jnp.float32))
    t_gt = jnp.array([0.3, -0.1, 0.2], jnp.float32)
    x1 = np.asarray(jse3.sim3_apply(s_gt[None], R_gt, t_gt, jnp.asarray(x2)[None])[0])

    def proj(x):
        return np.stack([400 * x[:, 0] / x[:, 2] + 160, 400 * x[:, 1] / x[:, 2] + 120], -1).astype(np.float32)

    uv1, uv2 = proj(x1), proj(x2)
    uv1[:6] += 25.0  # outliers
    x1n = (x1 + rng.normal(0, 0.05, x1.shape)).astype(np.float32)
    s0, R0, t0 = (np.asarray(v) for v in jse3.horn_alignment(jnp.asarray(x2), jnp.asarray(x1n), jnp.ones(n)))
    isg = rng.uniform(0.5, 1.0, (2, n)).astype(np.float32)
    mask = rng.uniform(size=n) < 0.95
    args = (K_BA, s0, R0, t0, x1, x2, uv1, uv2, isg[0], isg[1], mask)
    ref = jba.optimize_sim3(*(jnp.asarray(a) for a in args))
    got = ba.optimize_sim3(*(T(a) for a in args))
    np.testing.assert_array_equal(got.inlier.numpy(), np.asarray(ref.inlier))
    assert int(got.n_inliers) == int(ref.n_inliers) > 60
    assert abs(float(got.s) - float(ref.s)) < 1e-4
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-4)


def test_essential_graph_matches_reference():
    """tests/test_rigid_ba.py's circle of 8 keyframes with drift and a loop
    edge, plus a masked-out edge."""
    F = 8
    angles = np.linspace(0, 2 * np.pi * 7 / 8, F)
    T_gt = jnp.stack([jse3.se3_exp(jnp.array([np.cos(a), np.sin(a), 0.0, 0.0, 0.0, a], jnp.float32))
                      for a in angles])
    s_gt, R_gt, t_gt = jba.sim3_from_se3(T_gt)
    rng = np.random.default_rng(3)
    drift = jnp.cumsum(jnp.asarray(rng.normal(0, 0.02, (F, 7)), jnp.float32), axis=0).at[0].set(0.0)
    ds, dR, dt = jax.vmap(jse3.sim3_exp)(drift)
    s0, R0, t0 = jba._sim3_compose(ds, dR, dt, s_gt, R_gt, t_gt)
    edge_i = np.array(list(range(F - 1)) + [7, 2], np.int32)
    edge_j = np.array(list(range(1, F)) + [0, 5], np.int32)
    emask = np.ones(F + 1, bool)
    emask[-1] = False
    fixed = np.arange(F) == 0
    g_ref = jba.build_edges_from_poses(jnp.asarray(edge_i), jnp.asarray(edge_j), s_gt, R_gt, t_gt,
                                       jnp.asarray(emask), jnp.asarray(fixed))
    ref = jba.optimize_essential_graph(g_ref, s0, R0, t0)
    g = ba.build_edges_from_poses(T(edge_i.astype(np.int64)), T(edge_j.astype(np.int64)),
                                  *(T(np.asarray(v)) for v in (s_gt, R_gt, t_gt)), T(emask), T(fixed))
    for a, b in zip(g, g_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    got = ba.optimize_essential_graph(g, *(T(np.asarray(v)) for v in (s0, R0, t0)))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    assert float((got[2] - T(np.asarray(t_gt))).abs().max()) < 1e-2


def test_se3_from_sim3_matches_reference():
    rng = np.random.default_rng(4)
    s = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    R = np.asarray(jse3.so3_exp(jnp.asarray(rng.normal(0, 0.5, (5, 3)), jnp.float32)))
    t = rng.normal(0, 1, (5, 3)).astype(np.float32)
    np.testing.assert_allclose(ba.se3_from_sim3(T(s), T(R), T(t)).numpy(),
                               np.asarray(jba.se3_from_sim3(jnp.asarray(s), jnp.asarray(R), jnp.asarray(t))),
                               atol=1e-6)
