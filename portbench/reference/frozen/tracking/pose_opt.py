"""Pose-only optimization and relocalization.

Port of ``defslam_tpu/tracking/pose_opt.py``:

- :func:`solve_pose`: camera-only robust LM over fixed 3D points (the
  reference's ``Optimizer::poseOptimization``, DefOptimizer.cc:63-246):
  4 rounds of a 10-iteration Huber LM, each followed by a chi2 re-gate.
- :func:`relocalize`: recover the camera after tracking failed.  Every
  stored keyframe is scored by dense descriptor-match votes (the role of
  ``KeyFrameDatabase::DetectRelocalizationCandidates``), and a pose-only LM
  seeded at each of the 5 best keyframes' stored poses runs on the map
  points those keyframes observe; the candidate with the most inliers wins.

The JAX package scores one keyframe slot at a time under ``lax.map`` and
solves the candidates under ``vmap``.  Here the frame's descriptors meet
every slot's in ONE launch of kernel B1 (a (K, F*K) distance matrix viewed
as (K, F, K)), and the candidates are the lanes of the batched
:func:`ops.lm.lm_solve`.  The results are the same: each slot's matches
come from its own (K, K) block, and each lane is an independent problem.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.frozen.config import Config
from portbench.reference.frozen.frontend import Features
from portbench.reference.frozen.geometry import camera as cam
from portbench.reference.frozen.geometry import se3
from portbench.reference.frozen.mapstore.state import KeyframeStore, PointStore
from portbench.reference.frozen.ops import lm, matching
from portbench.reference.frozen.ops.fast import stable_topk
from portbench.reference.frozen.ops.hamming import hamming_matrix
from portbench.reference.frozen.utils import first_argmax

N_CANDIDATES = 5  # keyframes tried per relocalization (Tracking.cc:1631-1799)
# the reference relocalizes with a stricter ratio than tracking:
# ORBmatcher(0.75, true) in Tracking::Relocalization (Tracking.cc:1654-1656)
RELOC_NN_RATIO = 0.75


class PoseResult(NamedTuple):
    T: torch.Tensor  # (..., 4, 4)
    inlier: torch.Tensor  # (..., N) bool
    n_inliers: torch.Tensor  # (...,)
    cost: torch.Tensor  # (...,) robust cost of the last round


def solve_pose(K: torch.Tensor, T0: torch.Tensor, pts_w: torch.Tensor, obs_uv: torch.Tensor,
               inv_sigma2: torch.Tensor, mask: torch.Tensor, cfg: Config,
               num_iters: int = 10, rounds: int = 4) -> PoseResult:
    """Robust camera-only LM: ``rounds`` passes of optimize + chi2 re-gate
    (the reference's 4 x 10-iteration schedule).  Unbatched: T0 (4, 4),
    pts_w (N, 3), obs_uv (N, 2), inv_sigma2 (N,), mask (N,).  Batched: T0
    (B, 4, 4), pts_w (B, N, 3), mask (B, N), and obs_uv / inv_sigma2 either
    per lane or shared; the B problems are the lanes of one LM.

    Each round solves for a left increment xi, ``T <- exp(xi) @ T``, from
    xi = 0 with an additive update, as the reference does: the Jacobian is
    the derivative of the residual through ``se3_exp`` at the accumulated
    xi (forward mode along the 6 axes), not the closed form at xi = 0."""
    single = T0.ndim == 2
    if single:
        T0, pts_w, mask = T0[None], pts_w[None], mask[None]
    b = T0.shape[0]
    delta = cfg.sft.huber_delta

    def chi2_of(T):
        pc = se3.transform(T, pts_w)
        uv = cam.project(K, pc)
        e2 = torch.sum((uv - obs_uv) ** 2, dim=-1) * inv_sigma2
        return torch.where(pc[..., 2] > 1e-6, e2, torch.full_like(e2, float("inf")))

    # the 6 forward-mode directions ride as extra lanes (lm.forward_jacobian):
    # lane k*B + b is lane b with tangent e_k
    pts6 = pts_w.repeat(6, 1, 1)
    T = T0
    m = mask.to(T0.dtype)
    cost = None
    for _ in range(rounds):
        w = torch.sqrt(inv_sigma2) * m
        T6, w6 = T.repeat(6, 1, 1), w.repeat(6, 1)

        def residual(xi, T=T6, w=w6):
            pc = se3.transform(se3.se3_exp(xi) @ T, pts6)
            uv = cam.project(K, pc)
            wz = torch.where(pc[..., 2] > 1e-6, w, torch.zeros_like(w))
            return ((uv - obs_uv) * wz[..., None]).reshape(6 * b, -1)

        res = lm.lm_solve(
            lambda xi, residual=residual: lm.forward_jacobian(residual, xi),
            torch.zeros((b, 6), dtype=T0.dtype, device=T0.device),
            num_iters=num_iters,
            weight_fn=lambda r: lm.huber_block_weights(r, 2, delta),
        )
        T = se3.se3_exp(res.x) @ T
        m = mask.to(T0.dtype) * (chi2_of(T) <= cfg.sft.chi2_threshold).to(T0.dtype)
        cost = res.cost
    inlier = m > 0
    out = PoseResult(T=T, inlier=inlier, n_inliers=inlier.sum(dim=-1), cost=cost)
    return PoseResult(*(v[0] for v in out)) if single else out


def keyframe_votes(feats: Features, kfs: KeyframeStore, cfg: Config):
    """Match the frame's keypoints against every keyframe slot: one (K,
    F*K) distance matrix from kernel B1, masked per slot (a slot's columns
    are its valid keypoints that observe a map point), then the mutual,
    ratio-tested best match of each frame keypoint within each slot.
    Returns (votes (F,) int64, match_idx (K, F) int64: the slot's keypoint
    matched to each frame keypoint, or -1)."""
    f_cap, k_cap = kfs.point_id.shape
    d = hamming_matrix(feats.desc, kfs.desc.reshape(f_cap * k_cap, 8))
    d = d.view(feats.capacity, f_cap, k_cap)
    col_ok = kfs.kp_valid & (kfs.point_id >= 0)  # (F, K)
    ok = feats.valid[:, None, None] & col_ok[None]
    d.masked_fill_(~ok, matching.INVALID)
    m = matching.best_match(
        d, max_dist=cfg.tracking.match_th_low, nn_ratio=RELOC_NN_RATIO, mutual=True,
    )
    votes = ((m.idx >= 0) & kfs.valid[None, :]).sum(dim=0)
    return votes, m.idx


def relocalize(feats: Features, kfs: KeyframeStore, points: PointStore, K: torch.Tensor,
               cfg: Config):
    """Try to recover the camera pose against the stored keyframes:

    1. score every keyframe by match votes (:func:`keyframe_votes`);
    2. for each of the 5 best-voted keyframes (``jax.lax.top_k``'s order:
       equal votes in slot order), frame keypoint -> map point matches
       through that keyframe's observation table;
    3. a robust pose-only LM seeded at each candidate's stored pose, the
       candidates as lanes; keep the first candidate with the most inliers.

    Returns (ok () bool, T (4, 4), n_inliers ()) as tensors on the device:
    no host read."""
    f_cap, k_cap = kfs.point_id.shape
    p_cap = points.capacity
    votes, match_idx = keyframe_votes(feats, kfs, cfg)
    cand_votes, cand_kf = stable_topk(votes, min(N_CANDIDATES, f_cap))
    cand_ok = (cand_votes > 0) & kfs.valid[cand_kf]

    idx = match_idx[:, cand_kf].T  # (C, K): frame kp -> candidate kf kp
    kp = torch.clamp(idx, 0, k_cap - 1)
    pid = torch.where(idx >= 0, kfs.point_id[cand_kf[:, None], kp], torch.full_like(idx, -1))
    pidc = torch.clamp(pid, 0, p_cap - 1)
    ok_obs = (pid >= 0) & points.valid[pidc] & cand_ok[:, None]
    lv = feats.level.to(torch.get_default_dtype())
    inv_sigma2 = 1.0 / torch.pow(torch.full_like(lv, cfg.orb.scale_factor), 2.0 * lv)
    res = solve_pose(K, kfs.pose[cand_kf], points.xyz[pidc], feats.xy, inv_sigma2, ok_obs, cfg)
    best = first_argmax(res.n_inliers)
    n_best = res.n_inliers[best]
    return n_best >= cfg.tracking.min_inliers_ok, res.T[best], n_best
