"""The numbers that decide ``correct``: gaps between what the program's
timed path produced and what the reference works out from the same
inputs, and the trajectory against the render's ground truth.

Every gap is a plain number on the host (float64): a share of entries
that differ, a largest or root-mean-square difference relative to max(1,
the reference's), or a solver's objective at the program's answer
against its value at the judge's.  Poses are compared by the rotation
angle of R_a R_b^T (radians) and the distance of the translations.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _h(t) -> torch.Tensor:
    return t.detach().to("cpu", torch.float64)


def rel_gap(a, b, mask=None) -> float:
    """Largest |a - b| relative to max(1, largest |b|), over ``mask``'s rows."""
    a, b = _h(a), _h(b)
    if mask is not None:
        m = mask.detach().cpu()
        a, b = a[m], b[m]
    if a.numel() == 0:
        return 0.0
    d = (a - b).abs()
    if torch.isnan(d).any():
        return math.inf
    return float(d.max() / max(1.0, float(b.abs().max())))


def rms_gap(a, b, mask=None) -> float:
    """Root mean square of |a - b| relative to max(1, the root mean square
    of ``b``), over ``mask``'s rows."""
    a, b = _h(a), _h(b)
    if mask is not None:
        m = mask.detach().cpu()
        a, b = a[m], b[m]
    if a.numel() == 0:
        return 0.0
    d = a - b
    if torch.isnan(d).any():
        return math.inf
    return float(d.pow(2).mean().sqrt() / max(1.0, float(b.pow(2).mean().sqrt())))


def pose_gap(Ta, Tb) -> float:
    """max(rotation angle of Ra Rb^T, |ta - tb|) of two (4, 4) poses."""
    Ta, Tb = _h(Ta).numpy(), _h(Tb).numpy()
    if not (np.isfinite(Ta).all() and np.isfinite(Tb).all()):
        return math.inf
    R = Ta[:3, :3] @ Tb[:3, :3].T
    s = 0.5 * np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    rot = math.atan2(s, 0.5 * (np.trace(R) - 1.0))
    return max(abs(rot), float(np.linalg.norm(Ta[:3, 3] - Tb[:3, 3])))


def share_differ(a, b, among) -> float:
    """Entries of ``a`` and ``b`` that differ, over the count of ``among``
    (at least 1)."""
    a, b = a.detach().cpu(), b.detach().cpu()
    diff = a != b
    if diff.ndim > 1:
        diff = diff.reshape(diff.shape[0], -1).any(dim=1)
    return float(diff.sum()) / max(1, int(among.detach().cpu().sum()))


def features_gap(prog, ref) -> float:
    """Keypoint slots whose validity differs, or where both are valid and
    the level, a descriptor word or the position (by 1e-3 px) differs, as
    a share of the reference's valid keypoints."""
    pv, rv = prog.valid.cpu(), ref.valid.cpu()
    both = pv & rv
    moved = ((prog.xy.cpu() - ref.xy.cpu()).abs().amax(dim=-1) > 1e-3)
    other = (prog.level.cpu() != ref.level.cpu()) | (prog.desc.cpu() != ref.desc.cpu()).any(dim=-1)
    bad = (pv != rv) | (both & (moved | other))
    return float(bad.sum()) / max(1, int(rv.sum()))


def match_gap(prog_idx, ref_idx) -> float:
    """Map points whose matched keypoint differs, as a share of the points
    the reference matched."""
    return share_differ(prog_idx, ref_idx, ref_idx >= 0)


def sft_parts(prog, judge, objective) -> dict:
    """The SfT's answer against the judge's (float64) from the same inputs:
    ``cost``, the excess of the judge's objective at the program's answer
    over its value at the judge's, relative to the latter (negative where
    the program's answer is the better); ``inliers``, the share of
    observations whose chi2 gate differs; ``pose`` and ``nodes``, the raw
    gaps, which an ill-conditioned LM moves along its flat directions."""
    c_prog, c_judge = objective(prog.T, prog.nodes), objective(judge.T, judge.nodes)
    cost = (c_prog - c_judge) / max(abs(c_judge), 1e-30)
    return {"cost": cost if math.isfinite(cost) else math.inf,
            "inliers": share_differ(prog.inlier, judge.inlier, prog.inlier | judge.inlier),
            "pose": pose_gap(prog.T, judge.T), "nodes": rel_gap(prog.nodes, judge.nodes)}


def keyframe_parts(prog, ref) -> dict:
    """One keyframe step, (kfs, points, template, pose, diag) on each side:
    shares of integer table entries that differ (point ids of the keyframe
    store, validity of keyframes, normals and points, observation counts,
    facets), each integer diagnostic's gap relative to max(1, the
    reference's), and the largest and root-mean-square relative gaps of the
    template nodes, the points, the surfaces and the normals, the pose gap
    and the registration's scale."""
    (kp, pp, tp, Tp, dp), (kr, pr, tr, Tr, dr) = prog, ref
    out = _table_parts(kp, pp, kr, pr)
    for name in dp._fields:
        a, b = getattr(dp, name), getattr(dr, name)
        if not a.dtype.is_floating_point:
            out["diag_" + name] = abs(int(a) - int(b)) / max(1, abs(int(b)))
    out.update(_map_gaps(kp, pp, tp, kr, pr, tr))
    out["pose"] = pose_gap(Tp, Tr)
    out["reg_scale"] = (abs(float(dp.reg_scale) - float(dr.reg_scale))
                        / max(1.0, abs(float(dr.reg_scale))))
    return out


def legacy_keyframe_parts(prog, ref) -> dict:
    """One step of the multi-device keyframe chain, (kfs, points, template,
    template source, keyframe counter, swapped) on each side: the table
    shares and the map's gaps of :func:`keyframe_parts`, and whether the
    template's source, the counter and the swap differ (1) or not (0)."""
    (kp, pp, tp, sp, np_, up), (kr, pr, tr, sr, nr, ur) = prog, ref
    out = _table_parts(kp, pp, kr, pr)
    out.update(_map_gaps(kp, pp, tp, kr, pr, tr))
    out.update(tmpl_ref_kf=float(sp != sr), kf_counter=float(np_ != nr),
               updated=float(bool(up) != bool(ur)))
    return out


def _table_parts(kp, pp, kr, pr) -> dict:
    return {
        "point_id": share_differ(kp.point_id, kr.point_id, kr.point_id >= 0),
        "kf_valid": share_differ(kp.valid, kr.valid, kr.valid | kp.valid),
        "norm_valid": share_differ(kp.norm_valid, kr.norm_valid, kr.norm_valid | kp.norm_valid),
        "pt_valid": share_differ(pp.valid, pr.valid, pr.valid | pp.valid),
        "n_obs": share_differ(pp.n_obs, pr.n_obs, pr.valid),
        "facet": share_differ(pp.facet, pr.facet, pr.valid),
    }


def _map_gaps(kp, pp, tp, kr, pr, tr) -> dict:
    out = {}
    pts = pr.valid & pp.valid
    sv = kr.surf_valid.cpu()
    nv = kr.norm_valid.cpu() & kp.norm_valid.cpu()
    for name, a, b, m in (("nodes", tp.nodes, tr.nodes, None), ("xyz", pp.xyz, pr.xyz, pts),
                          ("surf", kp.surf_ctrl, kr.surf_ctrl, sv),
                          ("norm", kp.norm_k, kr.norm_k, nv)):
        out[name] = rel_gap(a, b, m)
        out[name + "_rms"] = rms_gap(a, b, m)
    return out


def init_gap(prog, ref) -> float:
    """The initialization: shares of points whose validity, facet or
    descriptor differ, and the relative gaps of positions, barycentric
    coordinates and template nodes."""
    return max(
        share_differ(prog.valid, ref.valid, ref.valid),
        share_differ(prog.facet, ref.facet, ref.valid),
        share_differ(prog.desc, ref.desc, ref.valid),
        rel_gap(prog.xyz, ref.xyz),
        rel_gap(prog.bary, ref.bary),
        rel_gap(prog.nodes, ref.nodes),
    )


def commit_gap(out_points, out_T, out_nodes, in_pose, nxt) -> float:
    """A frame's results against the state the next frame was given:
    the points, the pose, the template nodes and the motion model's
    previous pose."""
    return max(
        rel_gap(nxt["points"].xyz, out_points.xyz),
        share_differ(nxt["points"].n_found, out_points.n_found, out_points.valid),
        pose_gap(nxt["pose"], out_T),
        rel_gap(nxt["tmpl"].nodes, out_nodes),
        pose_gap(nxt["prev_pose"], in_pose),
    )


def pose_parts(prog, ref) -> dict:
    """The rigid pose LM: the pose gap and the share of inlier flags that
    differ."""
    return {"pose": pose_gap(prog.T, ref.T),
            "inliers": share_differ(prog.inlier, ref.inlier, ref.inlier | prog.inlier)}


def ba_parts(prog_poses, prog_xyz, prog_pid, ref_poses, ref_xyz, ref_pid, cams, pts,
             objective) -> dict:
    """The rigid local BA against the judge's (float64) from the same
    inputs: ``cost``, the excess of the judge's objective at the program's
    answer over its value at the judge's, relative to the latter; the
    share of observations whose point id differs after the chi2 gate
    erased the outliers'; and the raw gaps: the largest pose gap over the
    stored keyframes ``cams``, the largest and root-mean-square relative
    gaps of the points ``pts``."""
    gaps = [pose_gap(prog_poses[i], ref_poses[i])
            for i in torch.nonzero(cams.detach().cpu())[:, 0].tolist()]
    c_prog, c_judge = objective(prog_poses, prog_xyz), objective(ref_poses, ref_xyz)
    cost = (c_prog - c_judge) / max(abs(c_judge), 1e-30)
    return {"cost": cost if math.isfinite(cost) else math.inf,
            "pose": max(gaps, default=0.0), "xyz": rel_gap(prog_xyz, ref_xyz, pts),
            "xyz_rms": rms_gap(prog_xyz, ref_xyz, pts),
            "obs": share_differ(prog_pid, ref_pid, ref_pid >= 0)}


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray) -> float:
    """Sim(3)-aligned absolute trajectory error RMSE (the TUM benchmark's
    definition): camera centres aligned by a closed-form Umeyama Sim(3),
    then the RMSE of the residual centres.  (T, 4, 4) world->camera each."""
    est = np.asarray(est_poses, np.float64)
    gt = np.asarray(gt_poses, np.float64)
    if len(est) < 3 or not np.isfinite(est).all():
        return math.inf
    c_est = -np.einsum("tij,ti->tj", est[:, :3, :3], est[:, :3, 3])
    c_gt = -np.einsum("tij,ti->tj", gt[:, :3, :3], gt[:, :3, 3])
    mu_e, mu_g = c_est.mean(0), c_gt.mean(0)
    X, Y = c_est - mu_e, c_gt - mu_g
    var = (X * X).sum() / len(X)
    if var < 1e-18:
        aligned = c_est - mu_e + mu_g
    else:
        S = Y.T @ X / len(X)
        U, D, Vt = np.linalg.svd(S)
        W = np.eye(3)
        if np.linalg.det(U) * np.linalg.det(Vt) < 0:
            W[2, 2] = -1.0
        R = U @ W @ Vt
        s = np.trace(np.diag(D) @ W) / var
        aligned = s * c_est @ R.T + (mu_g - s * R @ mu_e)
    return float(np.sqrt(np.mean(np.sum((aligned - c_gt) ** 2, axis=1))))


def rot_ate(est_poses: np.ndarray, gt_poses: np.ndarray) -> float:
    """Root mean square rotation error (radians) of a trajectory after one
    fixed rotation of the world: the chordal mean G of R_gt_i^T R_est_i
    (the estimate's world in the ground truth's), then the angle of
    R_gt_i^T R_est_i G^T per frame.  (T, 4, 4) world->camera each."""
    est = np.asarray(est_poses, np.float64)
    gt = np.asarray(gt_poses, np.float64)
    if len(est) < 3 or not np.isfinite(est).all():
        return math.inf
    rel = np.einsum("tji,tjk->tik", gt[:, :3, :3], est[:, :3, :3])
    U, _, Vt = np.linalg.svd(rel.sum(0))
    G = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt
    E = rel @ G.T
    cos = np.clip(0.5 * (np.trace(E, axis1=1, axis2=2) - 1.0), -1.0, 1.0)
    return float(np.sqrt(np.mean(np.arccos(cos) ** 2)))
