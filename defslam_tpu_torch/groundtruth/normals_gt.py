"""Per-keyframe normal-angle evaluation against ground truth.

Port of ``defslam_tpu/groundtruth/normals_gt.py``, the equivalent of
``GroundTruthKeyFrame::estimateAngleErrorAndScale``
(``Modules/GroundTruth/GroundTruthKeyFrame.cc:61-209``): the NRSfM
per-keypoint normals (isometric estimate) and the integrated SfN surface's
normals at a keyframe's keypoints against the normals of the GT point
cloud, written as ``ErrorAngIso<ts>.txt`` / ``ErrorAngSfN<ts>.txt``.

The reference computes GT normals with PCL's kNN-PCA estimator and an MLS
outlier pass (``Modules/ToolsPCL/``); here that is numpy and scipy's
``cKDTree`` on the host, as in the JAX package: evaluation only, never on
the tracking path.  The estimated normals come from the port's
``mapping.normals.normal_from_k`` and ``ops.bspline.evaluate`` on the
System's device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from defslam_tpu_torch.mapping import normals as nrm
from defslam_tpu_torch.ops import bspline


def knn_pca_normals(cloud: np.ndarray, k: int = 12) -> np.ndarray:
    """kNN-PCA normals (PCLNormalEstimator): the smallest eigenvector of
    each point's neighbourhood covariance, oriented toward the camera."""
    from scipy.spatial import cKDTree

    tree = cKDTree(cloud)
    _, idx = tree.query(cloud, k=min(k, len(cloud)))
    nbrs = cloud[idx]  # (N, k, 3)
    x = nbrs - nbrs.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", x, x)
    _, v = np.linalg.eigh(cov)
    normals = v[:, :, 0]  # smallest eigenvalue
    flip = np.sum(normals * cloud, axis=1) > 0  # orient toward the origin
    normals[flip] *= -1
    return normals


def radius_outlier_mask(cloud: np.ndarray, radius: float, min_neighbors: int = 5) -> np.ndarray:
    """SmootherMLS::outlierRemovalRadius (SmootherMLS.h:27-59): keep points
    with at least ``min_neighbors`` points (themselves included) within
    ``radius``."""
    from scipy.spatial import cKDTree

    tree = cKDTree(cloud)
    counts = np.array(tree.query_ball_point(cloud, r=radius, return_length=True))
    return counts >= min_neighbors


def angle_errors_deg(n_est: np.ndarray, n_gt: np.ndarray) -> np.ndarray:
    """Unsigned angle between normals in degrees (sign-agnostic, like the
    reference)."""
    a = n_est / np.maximum(np.linalg.norm(n_est, axis=1, keepdims=True), 1e-9)
    b = n_gt / np.maximum(np.linalg.norm(n_gt, axis=1, keepdims=True), 1e-9)
    cos = np.abs(np.sum(a * b, axis=1))
    return np.degrees(np.arccos(np.clip(cos, 0.0, 1.0)))


def evaluate_keyframe_normals(system, slot: int, depth_map: np.ndarray,
                              outdir: str | None = None, timestamp: float = 0.0) -> dict | None:
    """Angle errors of (a) the isometric-NRSfM normals and (b) the SfN
    surface normals at keyframe ``slot``'s keypoints against the normals of
    the GT depth map's cloud."""
    kp_xy = system.kfs.xy[slot].cpu().numpy()
    h, w = depth_map.shape
    xi = np.clip(np.round(kp_xy[:, 0]).astype(int), 0, w - 1)
    yi = np.clip(np.round(kp_xy[:, 1]).astype(int), 0, h - 1)
    return evaluate_keyframe_normals_at(system, slot, depth_map[yi, xi], outdir=outdir,
                                        timestamp=timestamp)


def evaluate_keyframe_normals_at(system, slot: int, kp_depth: np.ndarray,
                                 outdir: str | None = None,
                                 timestamp: float = 0.0) -> dict | None:
    """:func:`evaluate_keyframe_normals` with per-KEYPOINT GT depths (K,):
    the stereo GT path gives NCC depths at the keyframe's keypoints instead
    of a dense depth image."""
    kfs = system.kfs
    if not bool(kfs.valid[slot]):
        return None
    retina = kfs.retina[slot].cpu().numpy()
    norm_valid = kfs.norm_valid[slot].cpu().numpy()
    if norm_valid.sum() < 5:
        return None
    d = np.asarray(kp_depth)
    sel = norm_valid & (d > 1e-6)
    if sel.sum() < 5:
        return None
    cloud = np.stack([retina[sel, 0] * d[sel], retina[sel, 1] * d[sel], d[sel]], axis=1)
    keep = radius_outlier_mask(cloud, radius=0.3 * np.median(d[sel]))
    n_gt = knn_pca_normals(cloud)

    dev = kfs.retina.device
    sel_t = torch.as_tensor(sel, device=dev)
    uv = kfs.retina[slot][sel_t]
    # (a) isometric normals
    n_iso = nrm.normal_from_k(kfs.norm_k[slot][sel_t], uv).cpu().numpy()
    out = {"iso_deg": angle_errors_deg(n_iso[keep], n_gt[keep])}
    # (b) SfN surface normals: the depth spline's gradient, k = -grad / gamma
    if bool(kfs.surf_valid[slot]):
        ctrl, sdom = kfs.surf_ctrl[slot], kfs.surf_dom[slot]  # per-keyframe spline domain
        u, v = uv[:, 0], uv[:, 1]
        g = bspline.evaluate(ctrl, u, v, sdom)
        gu = bspline.evaluate(ctrl, u, v, sdom, du=1)
        gv = bspline.evaluate(ctrl, u, v, sdom, dv=1)
        k_sfn = torch.stack([-gu / g, -gv / g], dim=1)
        n_sfn = nrm.normal_from_k(k_sfn, uv).cpu().numpy()
        out["sfn_deg"] = angle_errors_deg(n_sfn[keep], n_gt[keep])

    if outdir:
        os.makedirs(outdir, exist_ok=True)
        np.savetxt(os.path.join(outdir, f"ErrorAngIso{timestamp:.0f}.txt"), out["iso_deg"])
        if "sfn_deg" in out:
            np.savetxt(os.path.join(outdir, f"ErrorAngSfN{timestamp:.0f}.txt"), out["sfn_deg"])
    return out
