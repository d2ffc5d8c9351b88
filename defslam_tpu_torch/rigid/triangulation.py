"""Epipolar-constrained matching, batched triangulation and point fusion.

Port of ``defslam_tpu/rigid/triangulation.py``: rigid-mode map growth
(``LocalMapping::CreateNewMapPoints``, LocalMapping.cc:201-458;
``ORBmatcher::SearchForTriangulation`` and ``Fuse``, ORBmatcher.cc:676-998).
The candidate structure is a dense masked distance matrix from kernel B1
with the epipolar (or projection-window) test folded in as a mask.

Parity thresholds: epipolar d^2 < 3.84 sigma2[level]; Hamming <= TH_LOW
50; parallax 0 < cos < 0.9998; reprojection chi2 < 5.991 sigma2[level];
scale ratio within 1.5 scaleFactor; fuse chi2 <= 5.99 sigma2.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from defslam_tpu_torch.geometry import se3
from defslam_tpu_torch.ops import matching
from defslam_tpu_torch.rigid.initializer import triangulate_dlt
from defslam_tpu_torch.utils import inv_nan, scatter_last

TH_LOW = 50
EPI_CHI2 = 3.84
REPROJ_CHI2 = 5.991
FUSE_CHI2 = 5.99
COS_PARALLAX_MAX = 0.9998


def level_sigma2(n_levels: int, scale_factor: float, device=None) -> torch.Tensor:
    """Per-level measurement variance (mvLevelSigma2): scaleFactor^(2 l)."""
    e = 2.0 * torch.arange(n_levels, dtype=torch.float32, device=device)
    return torch.pow(torch.full_like(e, scale_factor), e)


def fundamental_from_poses(T1w: torch.Tensor, T2w: torch.Tensor, K: torch.Tensor):
    """F12 with x2^T F12 x1 = 0 for pixel coordinates (ComputeF12)."""
    T12 = T2w @ se3.inverse(T1w)  # cam1 -> cam2
    R, t = T12[:3, :3], T12[:3, 3]
    tx = se3.hat(t)
    Kinv = inv_nan(K)
    return Kinv.T @ tx @ R @ Kinv


class TriangulationMatches(NamedTuple):
    idx2: torch.Tensor  # (K1,) best kp in KF2 for each free kp in KF1, -1
    dist: torch.Tensor  # (K1,) Hamming distance


def search_for_triangulation(
    xy1, desc1, valid1, angle1, pid1,
    xy2, desc2, valid2, angle2, pid2,
    level2, F12, sig2,
) -> TriangulationMatches:
    """Match the keypoints without a map point of two keyframes under the
    epipolar constraint (SearchForTriangulation; the BoW buckets are the
    full masked matrix)."""
    free1 = valid1 & (pid1 < 0)
    free2 = valid2 & (pid2 < 0)
    l2 = torch.cat([xy1, torch.ones_like(xy1[:, :1])], dim=1) @ F12.T  # (K1, 3)
    num = l2[:, None, 0] * xy2[None, :, 0] + l2[:, None, 1] * xy2[None, :, 1] + l2[:, None, 2]
    den = torch.clamp(l2[:, 0] ** 2 + l2[:, 1] ** 2, min=1e-12)[:, None]
    dsq = num * num / den
    epi_ok = dsq < EPI_CHI2 * sig2[torch.clamp(level2, 0, sig2.shape[0] - 1)][None, :]
    d = matching.masked_hamming(desc1, desc2, free1, free2, pair_mask=epi_ok)
    m = matching.best_match(d, TH_LOW)
    m = matching.rotation_consistency(angle1, angle2, m)
    return TriangulationMatches(idx2=m.idx, dist=m.dist)


class Triangulated(NamedTuple):
    xyz: torch.Tensor  # (K1, 3) world points
    ok: torch.Tensor  # (K1,) bool: passed every check


def triangulate_matches(T1w, T2w, K, xy1, level1, xy2_all, level2_all, idx2, sig2,
                        scale_factor: float) -> Triangulated:
    """Triangulate kp1 <-> kp2 matches with the reference's acceptance
    cascade (LocalMapping.cc:283-446), batched over all matches."""
    j = torch.clamp(idx2, 0, xy2_all.shape[0] - 1)
    xy2, level2 = xy2_all[j], level2_all[j]
    X = triangulate_dlt(K @ T1w[:3, :4], K @ T2w[:3, :4], xy1, xy2)
    finite = torch.isfinite(X).all(dim=-1)
    X = torch.where(finite[:, None], X, torch.zeros_like(X))

    # parallax between the viewing rays (world frame)
    r1 = X - se3.inverse(T1w)[:3, 3]
    r2 = X - se3.inverse(T2w)[:3, 3]
    d1 = torch.linalg.norm(r1, dim=-1)
    d2 = torch.linalg.norm(r2, dim=-1)
    cosp = torch.sum(r1 * r2, dim=-1) / torch.clamp(d1 * d2, min=1e-12)
    par_ok = (cosp > 0) & (cosp < COS_PARALLAX_MAX)

    Xc1 = se3.transform(T1w, X)
    Xc2 = se3.transform(T2w, X)
    depth_ok = (Xc1[:, 2] > 0) & (Xc2[:, 2] > 0)

    def chi2(Xc, uv, lv):
        z = torch.where(torch.abs(Xc[:, 2]) < 1e-12, torch.full_like(Xc[:, 2], 1e-12), Xc[:, 2])
        u = K[0, 0] * Xc[:, 0] / z + K[0, 2]
        v = K[1, 1] * Xc[:, 1] / z + K[1, 2]
        return ((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2) / sig2[torch.clamp(lv, 0, sig2.shape[0] - 1)]

    reproj_ok = (chi2(Xc1, xy1, level1) < REPROJ_CHI2) & (chi2(Xc2, xy2, level2) < REPROJ_CHI2)

    # scale consistency (LocalMapping.cc:418-446)
    ratio_dist = d2 / torch.clamp(d1, min=1e-12)
    dl = (level1 - level2).to(torch.float32)
    ratio_octave = torch.pow(torch.full_like(dl, scale_factor), dl)
    ratio_factor = 1.5 * scale_factor
    scale_ok = (ratio_dist * ratio_factor >= ratio_octave) & (ratio_dist <= ratio_octave * ratio_factor)

    ok = ((idx2 >= 0) & finite & par_ok & depth_ok & reproj_ok & scale_ok
          & (d1 > 1e-6) & (d2 > 1e-6))
    return Triangulated(xyz=X, ok=ok)


class FuseResult(NamedTuple):
    kp_idx: torch.Tensor  # (P,) best keypoint in the target KF, -1 if none
    existing_pid: torch.Tensor  # (P,) map point already at that kp, -1 if free


def fuse_into_keyframe(pts_xyz, pts_desc, pts_valid, Tkw, K, xy, desc, kp_valid, level, pid,
                       sig2, width: int, height: int, radius: float = 3.0) -> FuseResult:
    """Project map points into a keyframe and match them to its keypoints
    (ORBmatcher::Fuse): per point, the matched keypoint and the point bound
    there now (the host merges duplicates, keeping the more-observed)."""
    Xc = se3.transform(Tkw, pts_xyz)
    z = Xc[:, 2]
    zs = torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
    u = K[0, 0] * Xc[:, 0] / zs + K[0, 2]
    v = K[1, 1] * Xc[:, 1] / zs + K[1, 2]
    in_img = (z > 0) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    proj = torch.stack([u, v], dim=-1)

    s2 = sig2[torch.clamp(level, 0, sig2.shape[0] - 1)]
    r = radius * torch.sqrt(s2)  # th * scaleFactor^level
    diff = proj[:, None, :] - xy[None, :, :]
    near = torch.abs(diff).max(dim=-1).values <= r[None, :]
    chi_ok = torch.sum(diff * diff, dim=-1) / s2[None, :] <= FUSE_CHI2
    d = matching.masked_hamming(pts_desc, desc, pts_valid & in_img, kp_valid,
                                pair_mask=near & chi_ok)
    kp = matching.best_match(d, TH_LOW).idx
    existing = torch.where(kp >= 0, pid[torch.clamp(kp, 0, pid.shape[0] - 1)], torch.full_like(kp, -1))
    return FuseResult(kp_idx=kp, existing_pid=existing)


def apply_replacements(point_id_tables: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                       p_cap: int) -> torch.Tensor:
    """Apply point merges src[i] -> dst[i] to every keyframe's kp->point
    table (MapPoint::Replace through the observations): one scatter into
    an identity table (of repeated sources the last one wins, the JAX CPU
    backend's order) and one gather.  src / dst (R,) padded with -1."""
    lut = torch.arange(p_cap, dtype=point_id_tables.dtype, device=point_id_tables.device)
    tgt = torch.where(src >= 0, src, torch.full_like(src, p_cap))
    lut = scatter_last(lut, tgt, torch.where(src >= 0, dst, torch.zeros_like(dst)))
    mapped = lut[torch.clamp(point_id_tables, 0, p_cap - 1)]
    return torch.where(point_id_tables >= 0, mapped, point_id_tables)
