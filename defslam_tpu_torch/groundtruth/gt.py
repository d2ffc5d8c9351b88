"""Ground-truth evaluation harness.

Port of ``defslam_tpu/groundtruth/gt.py`` (the reference's
``Modules/GroundTruth/``): every tracked frame, the scaled 3D RMSE of the
tracked map points against depth-map or stereo ground truth
(``GroundTruthFrame::{Estimate3DScale, Estimate3DError}``,
GroundTruthFrame.cc:124-266), per keyframe the normal-angle errors
(:mod:`defslam_tpu_torch.groundtruth.normals_gt`), written in the
reference's text formats (``ErrorGTs<tag>.txt``, ``ScaleVariation.txt``).

The stereo NCC search (the reference's per-point ``cv::matchTemplate``
over an epipolar band, GroundTruthCalculator.cc:203-274) is one batched
gather and correlation over all points and all disparities.  Rounding and
ties follow the JAX package: ``torch.round`` is half-to-even like
``jnp.round``, and the best disparity is the first maximum.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from defslam_tpu_torch.config import Config
from defslam_tpu_torch.geometry import camera as cam
from defslam_tpu_torch.geometry import se3
from defslam_tpu_torch.utils import first_argmax, masked_median


def stereo_depth_ncc(img_l: torch.Tensor, img_r: torch.Tensor, uv: torch.Tensor,
                     mask: torch.Tensor, baseline_fx: float, cfg: Config):
    """NCC stereo matching along the epipolar (same-row) band of a
    rectified pair: for each point, ``cfg.gt.ncc_template``-square patches
    at disparities 0 .. ``ncc_search`` - 1 to the left, sub-pixel by a
    parabola through the best score's neighbours.  img_l, img_r (H, W)
    float, uv (N, 2) pixels in the left image, mask (N,) bool.  Returns
    (depth (N,), ok (N,) bool), depth = baseline_fx / disparity."""
    g = cfg.gt
    h, w = img_l.shape
    half = g.ncc_template // 2
    dmax = g.ncc_search
    dev = uv.device
    cx = torch.round(uv[:, 0]).to(torch.int64)
    cy = torch.round(uv[:, 1]).to(torch.int64)
    off = torch.arange(-half, half + 1, device=dev)
    dy, dx = torch.meshgrid(off, off, indexing="ij")
    disps = torch.arange(dmax, device=dev)

    def centred(p):
        return p - p.mean(dim=(-2, -1), keepdim=True)

    def norm(p):
        return torch.sqrt(torch.sum(p * p, dim=(-2, -1)) + 1e-6)

    yy = torch.clamp(cy[:, None, None] + dy, 0, h - 1)  # (N, T, T)
    tmpl = centred(img_l[yy, torch.clamp(cx[:, None, None] + dx, 0, w - 1)])
    tnorm = norm(tmpl)
    px = cx[None, :] - disps[:, None]  # (D, N)
    xx = torch.clamp(px[:, :, None, None] + dx, 0, w - 1)  # (D, N, T, T)
    p = centred(img_r[yy[None].expand_as(xx), xx])
    scores = (torch.sum(p * tmpl, dim=(-2, -1)) / (norm(p) * tnorm)).T  # (N, D)
    best = first_argmax(scores, dim=1)
    best_score = scores.gather(1, best[:, None])[:, 0]
    sm1 = scores.gather(1, torch.clamp(best - 1, 0, dmax - 1)[:, None])[:, 0]
    sp1 = scores.gather(1, torch.clamp(best + 1, 0, dmax - 1)[:, None])[:, 0]
    denom = sm1 - 2.0 * best_score + sp1
    frac = torch.where(torch.abs(denom) > 1e-9, 0.5 * (sm1 - sp1) / denom,
                       torch.zeros_like(denom))
    disp = best.to(scores.dtype) + torch.clamp(frac, -0.5, 0.5)
    ok = (mask & (best_score > g.ncc_threshold) & (disp > 0.5) & (best > 0)
          & (best < dmax - 1) & (cx - dmax >= 0))
    depth = baseline_fx / torch.clamp(disp, min=1e-3)
    return depth, ok


def scaled_error(est_cam: torch.Tensor, gt_cam: torch.Tensor, mask: torch.Tensor):
    """Min-median scale and per-point error (Estimate3DScale /
    Estimate3DError): the estimated points (N, 3, camera frame) are scaled
    to the GT by the median norm ratio over ``mask``.  Returns (scale,
    per-point error (N,), RMSE over ``mask``)."""
    ne = torch.linalg.norm(est_cam, dim=-1)
    ng = torch.linalg.norm(gt_cam, dim=-1)
    ratio = torch.where(ne > 1e-9, ng / torch.clamp(ne, min=1e-9), torch.ones_like(ne))
    s = masked_median(ratio, mask)
    err = torch.linalg.norm(s * est_cam - gt_cam, dim=-1)
    sq = torch.where(mask, err * err, torch.zeros_like(err))
    rmse = torch.sqrt(torch.sum(sq) / torch.clamp(mask.sum(), min=1))
    return s, err, rmse


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray) -> float:
    """Sim(3)-aligned absolute trajectory error RMSE (the TUM benchmark's
    definition): camera centres aligned by a closed-form Umeyama Sim(3),
    then the RMSE of the residual centres.  (T, 4, 4) world->camera each."""
    est = np.asarray(est_poses, np.float64)
    gt = np.asarray(gt_poses, np.float64)
    if est.shape != gt.shape or est.ndim != 3 or est.shape[1:] != (4, 4):
        raise ValueError(f"expected two (T, 4, 4) pose arrays, got {est.shape} and {gt.shape}")
    # camera centre c = -R^T t for world->camera [R|t]
    c_est = -np.einsum("tij,ti->tj", est[:, :3, :3], est[:, :3, 3])
    c_gt = -np.einsum("tij,ti->tj", gt[:, :3, :3], gt[:, :3, 3])
    mu_e, mu_g = c_est.mean(0), c_gt.mean(0)
    X, Y = c_est - mu_e, c_gt - mu_g
    var = (X * X).sum() / len(X)
    if var < 1e-18:
        # stationary estimate: no similarity to fit beyond translation
        aligned = c_est - mu_e + mu_g
    else:
        S = Y.T @ X / len(X)
        U, D, Vt = np.linalg.svd(S)
        W = np.eye(3)
        if np.linalg.det(U) * np.linalg.det(Vt) < 0:
            W[2, 2] = -1.0
        R = U @ W @ Vt
        s = np.trace(np.diag(D) @ W) / var
        t = mu_g - s * R @ mu_e
        aligned = s * c_est @ R.T + t
    return float(np.sqrt(np.mean(np.sum((aligned - c_gt) ** 2, axis=1))))


def ate_rmse_trajectory(trajectory, gt_poses: np.ndarray) -> float:
    """ATE RMSE of a ``System.trajectory`` list of (timestamp, pose) against
    per-frame GT poses; timestamps index the GT array modulo its length.
    LOST frames have no trajectory entry and drop out of the pairing."""
    gt_poses = np.asarray(gt_poses)
    idx = [int(round(ts)) % len(gt_poses) for ts, _ in trajectory]
    est = np.stack([np.asarray(T) for _, T in trajectory])
    return ate_rmse(est, gt_poses[idx])


class GroundTruthEvaluator:
    """Per-frame GT evaluation and the reference-format result files."""

    def __init__(self, cfg: Config, outdir: str | None = None):
        self.cfg = cfg
        self.outdir = outdir or cfg.output_dir
        self.rows: list[tuple[float, float, int, float]] = []  # (ts, rmse, n, scale)
        # the latest GT source, kept for the per-keyframe normal-angle
        # evaluation (the reference evaluates inside NRSfM with the
        # keyframe's GT data, DefLocalMapping.cc:216-221)
        self._last_depth: np.ndarray | None = None
        self._last_stereo: tuple | None = None  # (img_l, img_r, baseline)
        self._last_ts: float = 0.0

    def evaluate_depth(self, system, depth_map: np.ndarray, timestamp: float) -> float | None:
        """CT-style GT (Apps/simple_CT.cc, TrackMonocularCTGT): the GT depth
        at each tracked point's pixel; returns the scaled RMSE."""
        self._last_depth, self._last_stereo = depth_map, None
        self._last_ts = timestamp
        pts, mask = self._tracked_points(system)
        if pts is None:
            return None
        uv = cam.project(system.K, pts)
        uv_h = uv.cpu().numpy()
        h, w = depth_map.shape
        xi = np.clip(np.round(uv_h[:, 0]).astype(int), 0, w - 1)
        yi = np.clip(np.round(uv_h[:, 1]).astype(int), 0, h - 1)
        d = depth_map[yi, xi]
        d_t = torch.as_tensor(d, dtype=uv.dtype, device=uv.device)
        gt = cam.backproject(system.K, uv, d_t)
        ok = mask & (d_t > 1e-6)
        return self._add_row(timestamp, pts, gt, ok)

    def evaluate_stereo(self, system, img_l, img_r, baseline: float,
                        timestamp: float) -> float | None:
        """Stereo GT (TrackMonocularGT): NCC correspondences on the
        rectified pair, radius outlier removal on the GT cloud (SmootherMLS::
        outlierRemovalRadius), then the min-median scale and the RMSE
        (GroundTruthFrame::Estimate3DScale, GroundTruthFrame.cc:124-228)."""
        from defslam_tpu_torch.groundtruth.normals_gt import radius_outlier_mask

        self._last_stereo, self._last_depth = (img_l, img_r, baseline), None
        self._last_ts = timestamp
        pts, mask = self._tracked_points(system)
        if pts is None:
            return None
        uv = cam.project(system.K, pts)
        depth, ok = stereo_depth_ncc(
            self._image(img_l, uv.device), self._image(img_r, uv.device), uv, mask,
            baseline * self.cfg.camera.fx, self.cfg,
        )
        gt = cam.backproject(system.K, uv, depth)
        ok_h = ok.cpu().numpy()
        if ok_h.sum() >= 8:
            gt_h = gt.cpu().numpy()[ok_h]
            keep = radius_outlier_mask(gt_h, radius=0.1 * float(np.median(gt_h[:, 2])),
                                       min_neighbors=4)
            ok_h[np.nonzero(ok_h)[0][~keep]] = False
            ok = torch.as_tensor(ok_h, device=uv.device)
        return self._add_row(timestamp, pts, gt, ok)

    def evaluate_keyframe_angles(self, system, slot: int) -> dict | None:
        """Per-keyframe normal-angle errors against the latest GT source,
        written as ErrorAngIso / ErrorAngSfN files (GroundTruthKeyFrame.cc:
        61-209)."""
        from defslam_tpu_torch.groundtruth import normals_gt

        if self._last_depth is not None:
            return normals_gt.evaluate_keyframe_normals(
                system, slot, self._last_depth, outdir=self.outdir, timestamp=self._last_ts)
        if self._last_stereo is not None:
            img_l, img_r, baseline = self._last_stereo
            dev = system.kfs.xy.device
            depth, ok = stereo_depth_ncc(
                self._image(img_l, dev), self._image(img_r, dev), system.kfs.xy[slot],
                system.kfs.kp_valid[slot], baseline * self.cfg.camera.fx, self.cfg,
            )
            kp_depth = torch.where(ok, depth, torch.zeros_like(depth)).cpu().numpy()
            return normals_gt.evaluate_keyframe_normals_at(
                system, slot, kp_depth, outdir=self.outdir, timestamp=self._last_ts)
        return None

    @staticmethod
    def _image(img, device) -> torch.Tensor:
        return torch.as_tensor(np.asarray(img), dtype=torch.float32, device=device)

    def _add_row(self, timestamp, pts, gt, ok) -> float:
        s, _, rmse = scaled_error(pts, gt, ok)
        rmse_h, n, s_h = torch.stack([rmse, ok.sum().to(rmse.dtype), s]).tolist()
        self.rows.append((timestamp, rmse_h, int(n), s_h))
        return rmse_h

    @staticmethod
    def _tracked_points(system):
        """The live, template-embedded map points in front of the camera, in
        the camera frame: (points (P, 3), mask (P,)), or (None, None) when
        fewer than 3 are live."""
        valid = system.points.valid & (system.points.facet >= 0)
        if int(valid.sum()) < 3:
            return None, None
        pc = se3.transform(system.pose, system.points.xyz)
        return pc, valid & (pc[:, 2] > 1e-6)

    def write(self, timestamp_tag: float = 0.0):
        """ErrorGTs<tag>.txt and ScaleVariation.txt, reference formats."""
        os.makedirs(self.outdir, exist_ok=True)
        with open(os.path.join(self.outdir, f"ErrorGTs{timestamp_tag:.0f}.txt"), "w") as f:
            for _, rmse, _, _ in self.rows:
                f.write(f"{rmse:.8f}\n")
        with open(os.path.join(self.outdir, "ScaleVariation.txt"), "w") as f:
            for t, _, n, s in self.rows:
                f.write(f"{t:.6f} {s:.8f} {n}\n")
