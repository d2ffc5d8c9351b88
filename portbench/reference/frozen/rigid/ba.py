"""Schur-complement bundle adjustment, Sim(3) refinement, essential graph.

Port of ``defslam_tpu/rigid/ba.py`` (the reference's rigid g2o suite,
``Thirdparty/ORBSLAM_2/src/Optimizer.cc``): ``LocalBundleAdjustment``'s
schedule (5 LM iterations, chi2 gate, 10 more, outliers erased),
``OptimizeSim3`` and ``OptimizeEssentialGraph``.

Observations live in a dense (C, K) table (camera slot x keypoint slot);
the point blocks and the camera-point coupling blocks are segment sums over
it, the Schur complement onto the cameras is two contractions, and a
(6C, 6C) dense Cholesky replaces g2o's sparse solver.

The segment sums are deterministic on every device: the observations are
sorted by segment (a stable sort), laid out in a (segments, max count)
table and summed along it, so no sum depends on the order atomics land in
(``index_add_`` on CUDA does).  Each segment's values keep their input
order, the order of the JAX CPU backend's scatter-add; the reduction may
pair them differently, so the results agree to float32 rounding.  A failed
factorization gives NaN and the step is zeroed, as in JAX (``inv_nan``,
``psd_solve``: no exception).

Parity thresholds: Huber delta sqrt(5.991), chi2 gate 5.991 sigma2[level],
positive-depth gate.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.frozen.geometry import se3
from portbench.reference.frozen.ops import lm
from portbench.reference.frozen.utils import inv_nan, psd_solve

CHI2_MONO = 5.991
HUBER_DELTA = 2.4477  # sqrt(5.991)


class BAProblem(NamedTuple):
    """C cameras x K keypoint slots of observations, P points.  ``pid``
    maps each observation to a point (-1: none).  Fixed cameras and points
    contribute residuals but take no update (g2o setFixed)."""

    poses: torch.Tensor  # (C, 4, 4) world->camera
    xyz: torch.Tensor  # (P, 3)
    pid: torch.Tensor  # (C, K) int64, -1 = none
    uv: torch.Tensor  # (C, K, 2)
    inv_sigma2: torch.Tensor  # (C, K)
    obs_mask: torch.Tensor  # (C, K) bool
    cam_free: torch.Tensor  # (C,) bool
    point_free: torch.Tensor  # (P,) bool


class BAResult(NamedTuple):
    poses: torch.Tensor  # (C, 4, 4)
    xyz: torch.Tensor  # (P, 3)
    inlier: torch.Tensor  # (C, K) bool: surviving observations
    cost: torch.Tensor  # () final robust cost
    n_inliers: torch.Tensor  # () int64


def segment_sum(values: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` of (N, d) values into ``num_segments`` rows;
    segment ids outside [0, num_segments) are dropped.  Deterministic: a
    stable sort by segment lays the values out in a (segments, largest
    count) table, each segment's values in their input order, and one sum
    along it reduces them.  Reads two counts on the host."""
    n, d = values.shape
    seg = torch.where((seg >= 0) & (seg < num_segments), seg, torch.full_like(seg, num_segments))
    order = torch.argsort(seg, stable=True)
    s = seg[order]
    counts = torch.bincount(s, minlength=num_segments + 1)
    n_drop, width = torch.stack([counts[num_segments], counts[:num_segments].max()]).tolist()
    n_keep = n - n_drop
    s = s[:n_keep]  # the dropped ids sort last
    rank = torch.arange(n_keep, device=seg.device) - (torch.cumsum(counts, 0) - counts)[s]
    table = torch.zeros((num_segments, max(width, 1), d), dtype=values.dtype, device=values.device)
    table[s, rank] = values[order[:n_keep]]
    return table.sum(dim=1)


def _obs_terms(poses, xyz, K, pid, uv):
    """Residuals and analytic camera / point Jacobians of every (c, k)
    slot.  Left-multiplicative SE(3) perturbation [rho, phi] (as
    ``se3_exp(xi) @ T``): d(exp(xi) p)/d xi = [I | -hat(p)]."""
    X = xyz[torch.clamp(pid, min=0)]  # (C, K, 3)
    R = poses[:, :3, :3]
    pc = torch.einsum("cij,ckj->cki", R, X) + poses[:, None, :3, 3]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    fx, fy = K[0, 0], K[1, 1]
    u = fx * x / zs + K[0, 2]
    v = fy * y / zs + K[1, 2]
    r = torch.stack([u, v], dim=-1) - uv  # (C, K, 2)
    iz = 1.0 / zs
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    duv_dpc = torch.stack([
        torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1),
        torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1),
    ], dim=-2)  # (C, K, 2, 3)
    Jc = torch.cat([duv_dpc, -(duv_dpc @ se3.hat(pc))], dim=-1)  # (C, K, 2, 6)
    Jp = duv_dpc @ R[:, None]  # (C, K, 2, 3)
    return r, Jc, Jp, z


def _robust_cost(chi2, w_valid, delta):
    """Sum of the Huber rho over the valid observations."""
    s = torch.sqrt(torch.clamp(chi2, min=1e-12))
    rho = torch.where(chi2 <= delta * delta, chi2, 2.0 * delta * s - delta * delta)
    return torch.sum(rho * w_valid)


def _gn_step(problem: BAProblem, K, lam, huber_delta):
    """One damped Schur-complement Gauss-Newton step: the candidate
    (poses, xyz) and the current robust cost."""
    poses, xyz = problem.poses, problem.xyz
    C, Kk = problem.pid.shape
    P = xyz.shape[0]
    r, Jc, Jp, z = _obs_terms(poses, xyz, K, problem.pid, problem.uv)
    valid = problem.obs_mask & (problem.pid >= 0) & (z > 1e-6)
    vf = valid.to(r.dtype)
    chi2 = torch.sum(r * r, dim=-1) * problem.inv_sigma2
    cost = _robust_cost(chi2, vf, huber_delta)
    hub = torch.clamp(huber_delta / torch.sqrt(torch.clamp(chi2, min=1e-12)), max=1.0)
    w = problem.inv_sigma2 * hub * vf  # (C, K)

    cam_f = problem.cam_free.to(r.dtype)
    pt_f = problem.point_free.to(r.dtype)
    Jc_e = Jc * cam_f[:, None, None, None]
    Jp_e = Jp * pt_f[torch.clamp(problem.pid, min=0)][..., None, None]
    JcW = Jc_e * w[..., None, None]
    JpW = Jp_e * w[..., None, None]

    U = torch.einsum("ckai,ckaj->cij", JcW, Jc_e)  # (C, 6, 6)
    b_c = torch.einsum("ckai,cka->ci", JcW, r)  # (C, 6)
    seg_p = torch.where(valid, problem.pid, torch.full_like(problem.pid, P)).reshape(-1)
    V = segment_sum(torch.einsum("ckai,ckaj->ckij", JpW, Jp_e).reshape(-1, 9), seg_p, P).reshape(P, 3, 3)
    b_p = segment_sum(torch.einsum("ckai,cka->cki", JpW, r).reshape(-1, 3), seg_p, P)
    # camera-point coupling blocks, grouped per point: A[p, c] = sum_k Jc^T W Jp
    Wcp = torch.einsum("ckai,ckaj->ckij", JcW, Jp_e)  # (C, K, 6, 3)
    cam_idx = torch.arange(C, device=r.device)[:, None].expand(C, Kk)
    seg_pc = torch.where(valid, problem.pid * C + cam_idx, torch.full_like(problem.pid, P * C)).reshape(-1)
    A = segment_sum(Wcp.reshape(-1, 18), seg_pc, P * C).reshape(P, C, 6, 3)

    # Marquardt damping, and identity for fixed or unconstrained blocks
    eye6 = torch.eye(6, dtype=U.dtype, device=U.device)
    U_d = U + lam * U * eye6 + 1e-8 * eye6
    U_d = U_d + (1.0 - cam_f)[:, None, None] * eye6
    eye3 = torch.eye(3, dtype=V.dtype, device=V.device)
    V_d = V + lam * V * eye3 + 1e-8 * eye3
    constrained = (torch.abs(torch.diagonal(V, dim1=-2, dim2=-1)).sum(-1) > 0).to(V.dtype)
    V_d = V_d + (1.0 - constrained * pt_f)[:, None, None] * eye3

    Vinv = inv_nan(V_d)  # (P, 3, 3) batched tiny inverses
    Y = A @ Vinv[:, None]  # (P, C, 6, 3)
    S_off = torch.einsum("pcik,pdjk->cidj", Y, A).reshape(6 * C, 6 * C)
    S = torch.block_diag(*U_d) - S_off
    rhs = b_c - torch.einsum("pcik,pk->ci", Y, b_p)  # (C, 6)
    d_cam = -psd_solve(S, rhs.reshape(-1), jitter=1e-8).reshape(C, 6)
    d_cam = torch.where(torch.isfinite(d_cam), d_cam, torch.zeros_like(d_cam)) * cam_f[:, None]
    d_pt = -(Vinv @ (b_p + torch.einsum("pcki,ck->pi", A, d_cam))[..., None])[..., 0]
    d_pt = torch.where(torch.isfinite(d_pt), d_pt, torch.zeros_like(d_pt)) * (constrained * pt_f)[:, None]
    return se3.se3_exp(d_cam) @ poses, xyz + d_pt, cost


def _chi2_valid(problem: BAProblem, K, poses, xyz):
    r, _, _, z = _obs_terms(poses, xyz, K, problem.pid, problem.uv)
    return torch.sum(r * r, dim=-1) * problem.inv_sigma2, z


def _cost_at(problem: BAProblem, K, poses, xyz, huber_delta):
    chi2, z = _chi2_valid(problem, K, poses, xyz)
    valid = problem.obs_mask & (problem.pid >= 0) & (z > 1e-6)
    return _robust_cost(chi2, valid.to(chi2.dtype), huber_delta)


def chi2_of(problem: BAProblem, K, poses, xyz):
    """Per-observation chi2, inf behind the camera."""
    chi2, z = _chi2_valid(problem, K, poses, xyz)
    return torch.where(z > 1e-6, chi2, torch.full_like(chi2, float("inf")))


def _lm_phase(problem: BAProblem, K, iters: int, huber_delta, lam0=1e-4):
    """Fixed-length accept/reject LM loop, one ``_gn_step`` an iteration."""
    poses, xyz = problem.poses, problem.xyz
    lam = torch.full((), lam0, dtype=xyz.dtype, device=xyz.device)
    for _ in range(iters):
        poses_n, xyz_n, cost = _gn_step(problem._replace(poses=poses, xyz=xyz), K, lam, huber_delta)
        cost_n = _cost_at(problem, K, poses_n, xyz_n, huber_delta)
        accept = torch.isfinite(cost_n) & (cost_n < cost)
        poses = torch.where(accept, poses_n, poses)
        xyz = torch.where(accept, xyz_n, xyz)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e8)
    return poses, xyz


def ba_solve(problem: BAProblem, K: torch.Tensor, iters_first: int = 5, iters_second: int = 10,
             chi2_th: float = CHI2_MONO, huber_delta: float = HUBER_DELTA) -> BAResult:
    """LocalBundleAdjustment's schedule (Optimizer.cc:447-771): optimize
    ``iters_first``, drop the chi2 > 5.991 observations, optimize
    ``iters_second`` on the survivors without the robust kernel (a huge
    delta), return the final inlier set."""
    return ba_solve_stages(problem, K, iters_first, iters_second, chi2_th, huber_delta)[0]


def ba_solve_stages(problem: BAProblem, K: torch.Tensor, iters_first: int = 5,
                    iters_second: int = 10, chi2_th: float = CHI2_MONO,
                    huber_delta: float = HUBER_DELTA) -> tuple[BAResult, BAProblem]:
    """:func:`ba_solve`, and the second phase's problem, whose objective
    (:func:`ba_objective`) the answer minimizes."""
    poses, xyz = _lm_phase(problem, K, iters_first, huber_delta)
    keep = problem.obs_mask & (problem.pid >= 0) & (chi2_of(problem, K, poses, xyz) <= chi2_th)
    prob2 = problem._replace(poses=poses, xyz=xyz, obs_mask=keep)
    poses, xyz = _lm_phase(prob2, K, iters_second, 1e6)
    inlier = keep & (chi2_of(prob2, K, poses, xyz) <= chi2_th)
    cost = _cost_at(prob2, K, poses, xyz, huber_delta)
    return (BAResult(poses=poses, xyz=xyz, inlier=inlier, cost=cost, n_inliers=inlier.sum()),
            prob2)


def ba_objective(problem: BAProblem, K, poses, xyz) -> torch.Tensor:
    """The cost the second phase of :func:`ba_solve` minimizes on
    ``problem`` (its survivors, no robust kernel) at (poses, xyz)."""
    return _cost_at(problem, K, poses, xyz, 1e6)


# ------------------------------------------------------------------ Sim3 ----


class Sim3Result(NamedTuple):
    s: torch.Tensor  # ()
    R: torch.Tensor  # (3, 3)
    t: torch.Tensor  # (3,)
    inlier: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor  # ()


def _sim3_inverse(s, R, t):
    si = 1.0 / s
    Rt = R.transpose(-1, -2)
    return si, Rt, -si[..., None] * torch.einsum("...ij,...j->...i", Rt, t)


def _sim3_compose(sa, Ra, ta, sb, Rb, tb):
    """(sa, Ra, ta) o (sb, Rb, tb): b first, then a."""
    return sa * sb, Ra @ Rb, sa[..., None] * torch.einsum("...ij,...j->...i", Ra, tb) + ta


def optimize_sim3(K, s0, R0, t0, xyz1, xyz2, uv1, uv2, inv_sigma2_1, inv_sigma2_2, mask,
                  chi2_th: float = 10.0, num_iters: int = 20) -> Sim3Result:
    """Refine the camera-2 -> camera-1 Sim(3) (g2o ``OptimizeSim3``,
    Optimizer.cc:1036-1233): bidirectional reprojection residuals, Huber,
    one chi2 re-gate half way (th2 = 10, LoopClosing.cc:323).  The update
    is ``sim3_exp(xi)`` on the left, its Jacobian by forward mode."""
    n = xyz1.shape[0]

    def project(p):
        z = torch.where(torch.abs(p[..., 2]) < 1e-6, torch.full_like(p[..., 2], 1e-6), p[..., 2])
        return torch.stack([K[0, 0] * p[..., 0] / z + K[0, 2], K[1, 1] * p[..., 1] / z + K[1, 2]], -1)

    def residuals(s, R, t, m):
        """(L,), (L, 3, 3), (L, 3) lanes -> (L, 4N)."""
        p1 = se3.sim3_apply(s, R, t, xyz2.expand(s.shape[0], -1, -1))  # S12 * x2
        p2 = torch.reciprocal(s)[:, None, None] * torch.einsum(
            "lji,lnj->lni", R, xyz1[None] - t[:, None, :])
        r1 = (project(p1) - uv1) * torch.sqrt(inv_sigma2_1 * m)[:, None]
        r2 = (project(p2) - uv2) * torch.sqrt(inv_sigma2_2 * m)[:, None]
        return torch.cat([r1.reshape(s.shape[0], -1), r2.reshape(s.shape[0], -1)], dim=-1)

    def retract(s, R, t, xi):
        ds, dR, dt = se3.sim3_exp(xi)
        return s * ds, dR @ R, ds[:, None] * (dR @ t[:, :, None])[..., 0] + dt

    def solve_round(s, R, t, m, iters):
        def residual(xi):
            L = xi.shape[0]
            return residuals(*retract(s.expand(L), R.expand(L, 3, 3), t.expand(L, 3), xi), m)

        res = lm.lm_solve(
            lambda x: lm.forward_jacobian(residual, x), torch.zeros((1, 7), dtype=s.dtype, device=s.device),
            num_iters=iters,
            weight_fn=lambda r: lm.huber_block_weights(r, 2, chi2_th ** 0.5),
        )
        return retract(s, R, t, res.x)

    def chi2_each(s, R, t):
        r = residuals(s, R, t, torch.ones_like(m)).reshape(2, n, 2)
        return torch.maximum(torch.sum(r[0] ** 2, dim=-1), torch.sum(r[1] ** 2, dim=-1))

    m = mask.to(torch.get_default_dtype())
    s, R, t = solve_round(s0.reshape(1).to(torch.get_default_dtype()), R0[None], t0[None], m, num_iters // 2)
    m = m * (chi2_each(s, R, t) <= chi2_th).to(m.dtype)
    s, R, t = solve_round(s, R, t, m, num_iters)
    inlier = (m > 0) & (chi2_each(s, R, t) <= chi2_th)
    return Sim3Result(s=s[0], R=R[0], t=t[0], inlier=inlier, n_inliers=inlier.sum())


# -------------------------------------------------------- essential graph ----


class EssentialGraph(NamedTuple):
    """Pose graph over keyframe Sim(3) poses (world->camera): edges carry
    S_ji = S_jw o S_iw^-1 (spanning tree, covisibility and loop edges,
    Optimizer.cc:773-1034), with a validity mask."""

    edge_i: torch.Tensor  # (E,) int64
    edge_j: torch.Tensor  # (E,) int64
    meas_s: torch.Tensor  # (E,)
    meas_R: torch.Tensor  # (E, 3, 3)
    meas_t: torch.Tensor  # (E, 3)
    edge_mask: torch.Tensor  # (E,) bool
    fixed: torch.Tensor  # (F,) bool


def build_edges_from_poses(edge_i, edge_j, s_w, R_w, t_w, edge_mask, fixed) -> EssentialGraph:
    """Measurements from the current poses: S_ji = S_jw o S_iw^-1."""
    si, Ri, ti = _sim3_inverse(s_w[edge_i], R_w[edge_i], t_w[edge_i])
    ms, mR, mt = _sim3_compose(s_w[edge_j], R_w[edge_j], t_w[edge_j], si, Ri, ti)
    return EssentialGraph(edge_i=edge_i, edge_j=edge_j, meas_s=ms, meas_R=mR, meas_t=mt,
                          edge_mask=edge_mask, fixed=fixed)


def optimize_essential_graph(graph: EssentialGraph, s0, R0, t0, num_iters: int = 20):
    """Sim(3) pose-graph optimization (OptimizeEssentialGraph): per edge
    the error [so3_log(R_err), t_err, log(s_err)] of meas^-1 o predicted;
    the (F, 7) tangent is one dense LM (its Jacobian by forward mode, the
    7F directions as lanes).  Returns the corrected (s, R, t)."""
    F = s0.shape[0]
    free = (~graph.fixed).to(s0.dtype)
    em = graph.edge_mask.to(s0.dtype)
    fixed = graph.fixed.to(s0.dtype)
    inv_meas = _sim3_inverse(graph.meas_s, graph.meas_R, graph.meas_t)

    def poses_of(x):
        """(L, 7F) -> (L, F) Sim(3) poses."""
        xi = x.reshape(-1, F, 7) * free[:, None]
        ds, dR, dt = se3.sim3_exp(xi)
        return _sim3_compose(ds, dR, dt, s0, R0, t0)

    def residual(x):
        s, R, t = poses_of(x)
        si, Ri, ti = _sim3_inverse(s[:, graph.edge_i], R[:, graph.edge_i], t[:, graph.edge_i])
        ps, pR, pt = _sim3_compose(s[:, graph.edge_j], R[:, graph.edge_j], t[:, graph.edge_j],
                                   si, Ri, ti)
        es, eR, et = _sim3_compose(*inv_meas, ps, pR, pt)
        r = torch.cat([se3.so3_log(eR), et, torch.log(torch.clamp(es, min=1e-12))[..., None]], -1)
        # pin the fixed poses' tangent so the normal matrix keeps full rank
        pin = (x.reshape(-1, F, 7) * fixed[:, None]).reshape(x.shape[0], -1)
        return torch.cat([(r * em[:, None]).reshape(x.shape[0], -1), pin], dim=-1)

    res = lm.lm_solve(lambda x: lm.forward_jacobian(residual, x),
                      torch.zeros((1, F * 7), dtype=s0.dtype, device=s0.device), num_iters=num_iters)
    s, R, t = poses_of(res.x)
    return s[0], R[0], t[0]


def sim3_from_se3(T: torch.Tensor):
    """(F, 4, 4) SE(3) -> a unit-scale Sim(3) triplet."""
    return torch.ones(T.shape[:-2], dtype=T.dtype, device=T.device), T[..., :3, :3], T[..., :3, 3]


def se3_from_sim3(s, R, t):
    """Sim(3) -> SE(3) with the scale folded into the translation, [R t/s]
    (CorrectLoop, LoopClosing.cc:554-561)."""
    return se3._rt_to_mat(R, t / s[..., None])
