"""Per-frame deformable tracking.

Port of ``defslam_tpu/tracking/tracker.py``: the projection search of
``TrackWithMotionModel`` (DefORBmatcher::SearchByProjection, restricted to
template-embedded points) and the SfT solve of ``TrackLocalMap``, plus the
constant-velocity prediction and point reposing.  The projection search's
distance matrix runs through kernel B1 (``ops.hamming``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from defslam_tpu_torch import profiling
from defslam_tpu_torch.config import Config
from defslam_tpu_torch.frontend import Features, extract_features
from defslam_tpu_torch.geometry import camera as cam
from defslam_tpu_torch.geometry import se3
from defslam_tpu_torch.mapstore.state import PointStore
from defslam_tpu_torch.ops import matching
from defslam_tpu_torch.ops.fast import stable_topk
from defslam_tpu_torch.template import mesh as meshmod
from defslam_tpu_torch.tracking import sft


class FrameMatches(NamedTuple):
    kp_of_point: torch.Tensor  # (P,) int64 — frame keypoint per map point, -1
    dist: torch.Tensor  # (P,) int32
    n_matches: torch.Tensor  # () int64
    n_dropped: torch.Tensor  # () int64 — candidates past match_capacity
    visible: torch.Tensor  # (P,) bool — point was a frustum candidate


def match_points_to_frame(
    points: PointStore,
    pose: torch.Tensor,
    K: torch.Tensor,
    feats: Features,
    cfg: Config,
    window: float | None = None,
) -> FrameMatches:
    """Project map points with the pose prior and match them to frame
    keypoints within a pixel window that scales with the keypoint's pyramid
    level.  Only valid, template-embedded, in-frustum points are
    candidates; they are compacted into ``tracking.match_capacity`` slots
    first (overflow counted in ``n_dropped``)."""
    with profiling.stage("tracking.match"):
        w = cfg.tracking.projection_window if window is None else window
        pc = se3.transform(pose, points.xyz)
        uv = cam.project(K, pc)
        in_front = pc[..., 2] > 1e-6
        in_img = cam.in_image(uv, cfg.camera.width, cfg.camera.height)
        ok_p = points.valid & (points.facet >= 0) & in_front & in_img

        p_cap = points.capacity
        n_c = min(cfg.tracking.match_capacity, p_cap)
        sel, ok_c, n_dropped = matching.compact_select(ok_p, n_c)
        uv_c = uv[sel]

        scale = torch.pow(
            torch.full_like(feats.xy[:, 0], cfg.orb.scale_factor), feats.level.float()
        )
        d = torch.abs(uv_c[:, None, :] - feats.xy[None, :, :])
        inside = d.max(dim=-1).values <= w * scale[None, :]
        dist = matching.masked_hamming(
            points.desc[sel], feats.desc, ok_c, feats.valid, pair_mask=inside
        )
        m = matching.best_match(
            dist, max_dist=cfg.tracking.match_th_high, nn_ratio=cfg.tracking.nn_ratio,
            mutual=True,
        )
        m = matching.rotation_consistency(points.angle[sel], feats.angle, m)
        idx_ok = torch.where(ok_c, m.idx, torch.full_like(m.idx, -1))
        kp_full = torch.full((p_cap,), -1, dtype=torch.int64, device=pose.device)
        kp_full[sel] = idx_ok
        dist_full = torch.full((p_cap,), matching.INVALID, dtype=torch.int32, device=pose.device)
        dist_full[sel] = m.dist
        return FrameMatches(
            kp_of_point=kp_full,
            dist=dist_full,
            n_matches=(idx_ok >= 0).sum(),
            n_dropped=n_dropped,
            visible=ok_p,
        )


def _sft_data_from_matches(points: PointStore, matches: FrameMatches,
                           feats: Features, tmpl: meshmod.Template,
                           pose0: torch.Tensor, K: torch.Tensor, cfg: Config):
    """Compacted SfT problem from point->keypoint matches: the matched
    slots (at most K, since mutual matching is injective) are gathered
    first, in ascending order.  Returns (data, sel (N,), sel_mask (N,))."""
    p_cap = points.capacity
    mask_full = (matches.kp_of_point >= 0) & points.valid & (points.facet >= 0)
    n_obs = min(cfg.orb.max_keypoints, p_cap)
    if n_obs < p_cap:
        _, sel = stable_topk(mask_full.to(torch.int32), n_obs)
        sel_mask = mask_full[sel]
    else:
        sel = torch.arange(p_cap, device=pose0.device)
        sel_mask = mask_full
    kp = torch.clamp(matches.kp_of_point[sel], 0, feats.capacity - 1)
    lv = feats.level[kp].float()
    inv_sigma2 = 1.0 / torch.pow(torch.full_like(lv, cfg.orb.scale_factor), 2.0 * lv)
    data = sft.data_from_template(
        tmpl, K, pose0,
        obs_uv=feats.xy[kp],
        obs_face=points.facet[sel],
        obs_bary=points.bary[sel],
        obs_invsigma2=inv_sigma2,
        obs_mask=sel_mask,
        n_kp=feats.valid.sum().float(),
    )
    return data, sel, sel_mask


def sft_track(points: PointStore, matches: FrameMatches, feats: Features,
              tmpl: meshmod.Template, pose0: torch.Tensor, K: torch.Tensor,
              cfg: Config, reg_temp: float | None = None) -> sft.SfTResult:
    """Assemble the SfT problem from the matches, solve it, and scatter the
    per-observation outputs back to the P point slots."""
    topo = meshmod.grid_topology(cfg.mesh.nodes_u, cfg.mesh.nodes_v)
    data, sel, sel_mask = _sft_data_from_matches(points, matches, feats, tmpl, pose0, K, cfg)
    res = sft.solve(data, topo, cfg, reg_temp=reg_temp)
    return _scatter_sft_result(res, sel, sel_mask, points.capacity, cfg)


def sft_track_sharded(group, points: PointStore, matches: FrameMatches, feats: Features,
                      tmpl: meshmod.Template, pose0: torch.Tensor, K: torch.Tensor,
                      cfg: Config, reg_temp: float | None = None) -> sft.SfTResult:
    """:func:`sft_track` with the solve's observation rows sharded over
    ``group`` (``parallel.sharded.sft_solve_sharded``): the frame solve of
    ``Config.parallel``.  The observation axis, min(max_keypoints,
    max_map_points), must divide over the group.  Traced as
    ``parallel.sft``."""
    from defslam_tpu_torch.parallel import sharded

    n_obs = min(cfg.orb.max_keypoints, points.capacity)
    if n_obs % group.size:
        raise ValueError(f"the sharded observation axis min(max_keypoints, max_map_points) = "
                         f"{n_obs} must divide over {group.size} ranks")
    with profiling.stage("parallel.sft"):
        data, sel, sel_mask = _sft_data_from_matches(points, matches, feats, tmpl, pose0, K, cfg)
        res = sharded.sft_solve_sharded(group, data, cfg, reg_temp=reg_temp)
        return _scatter_sft_result(res, sel, sel_mask, points.capacity, cfg)


def _scatter_sft_result(res: sft.SfTResult, sel, sel_mask, p_cap: int,
                        cfg: Config) -> sft.SfTResult:
    """The per-observation outputs scattered back to the P point slots
    (nothing to do when the observation axis is the point axis)."""
    if min(cfg.orb.max_keypoints, p_cap) == p_cap:
        return res
    dev = res.T.device
    inlier = torch.zeros(p_cap, dtype=torch.bool, device=dev)
    inlier[sel] = res.inlier & sel_mask
    chi2 = torch.full((p_cap,), float("inf"), device=dev)
    chi2[sel] = res.chi2
    return res._replace(inlier=inlier, chi2=chi2)


def motion_model_prediction(pose: torch.Tensor, prev_pose: torch.Tensor) -> torch.Tensor:
    """Constant-velocity prediction velocity @ pose with velocity =
    pose @ prev_pose^-1, both re-orthonormalized first (float32 drift off
    SO(3) is amplified by the transpose-inverse)."""
    pose = se3.orthonormalize(pose)
    vel = pose @ se3.inverse(se3.orthonormalize(prev_pose))
    return vel @ pose


def reposition_points(points: PointStore, nodes: torch.Tensor, cfg: Config) -> PointStore:
    """Recompute every embedded point from its barycentric embedding after a
    mesh update (DefMapPoint::RecalculatePosition)."""
    topo = meshmod.grid_topology(cfg.mesh.nodes_u, cfg.mesh.nodes_v)
    new_xyz = meshmod.facet_positions(nodes, topo, points.facet, points.bary)
    keep = points.valid & (points.facet >= 0)
    return points._replace(xyz=torch.where(keep[:, None], new_xyz, points.xyz))


def _frame_stats(matches: FrameMatches, res: sft.SfTResult) -> torch.Tensor:
    """[n_matches, n_inliers, n_local_candidates, n_match_dropped]."""
    return torch.stack([
        matches.n_matches,
        res.inlier.sum(),
        matches.visible.sum(),
        matches.n_dropped.reshape(()),
    ])


def track_frame(img: torch.Tensor, points: PointStore, pose: torch.Tensor,
                prev_pose: torch.Tensor, tmpl: meshmod.Template, K: torch.Tensor,
                cfg: Config, window_scale: float = 1.0):
    """The per-frame path: predict, extract, project-match, SfT, repose the
    points and refresh their per-point angle and lifecycle counters.
    Returns (feats, matches, sft_result, new_points, stats)."""
    return _track_frame(sft_track, img, points, pose, prev_pose, tmpl, K, cfg, window_scale)


def track_frame_parallel(group, img: torch.Tensor, points: PointStore, pose: torch.Tensor,
                         prev_pose: torch.Tensor, tmpl: meshmod.Template, K: torch.Tensor,
                         cfg: Config, window_scale: float = 1.0):
    """:func:`track_frame` with the SfT solve sharded over ``group``
    (:func:`sft_track_sharded`), the frame path of ``Config.parallel``.
    Extraction and matching run replicated on every rank.  Same outputs."""
    return _track_frame(functools.partial(sft_track_sharded, group), img, points, pose,
                        prev_pose, tmpl, K, cfg, window_scale)


def _track_frame(solve, img, points, pose, prev_pose, tmpl, K, cfg: Config, window_scale):
    pred = motion_model_prediction(pose, prev_pose)
    feats = extract_features(img, cfg)
    matches = match_points_to_frame(
        points, pred, K, feats, cfg, window=window_scale * cfg.tracking.projection_window
    )
    with profiling.stage("tracking.sft"):
        res = solve(points, matches, feats, tmpl, pred, K, cfg)
    new_points = reposition_points(points, res.nodes, cfg)
    matched = matches.kp_of_point >= 0
    kp = torch.clamp(matches.kp_of_point, 0, feats.capacity - 1)
    new_points = new_points._replace(
        angle=torch.where(matched, feats.angle[kp], new_points.angle),
        n_visible=new_points.n_visible + matches.visible.int(),
        n_found=new_points.n_found + (res.inlier & matched).int(),
    )
    return feats, matches, res, new_points, _frame_stats(matches, res)
