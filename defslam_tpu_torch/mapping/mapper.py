"""Deformation mapping (NRSfM): the keyframe step.

Port of ``defslam_tpu/mapping/mapper.py`` (``DefLocalMapping``).  Per new
keyframe:

 1. for every covisible keyframe pair, fit and refine a retina warp and
    take its differential properties;
 2. densify the matches through the warps (kernel B2,
    :mod:`defslam_tpu_torch.ops.windowed_match`) and refresh the points'
    distinctive descriptors;
 3. batched per-point normal solves, gated by their covariance;
 4. shape-from-normals on the chosen reference keyframe;
 5. Sim(3) registration against the metric map;
 6. template regeneration from the registered surface, new map points, and
    a re-anchoring SfT of camera and mesh with the temporal term off.

All keyframes share the camera-wide retina domain, so one bending matrix
serves every warp.  The JAX package runs the whole step as one device
computation with ``lax.cond``; here :func:`keyframe_step` is a sequence of
tensor functions with two host reads, the branch decisions eager PyTorch
cannot take on the device (the template gate and the registration's
verdict).  The slot and the template-source keyframe stay 0-dim device
tensors that index the stores (``utils.take`` / ``utils.put_``).  Repeated
scatter indices follow the reference's in-order rule (the last writer
wins), through ``utils.last_writer``; every ranking keeps the lower index
first on ties.  The first half updates the keyframe store in place; the
second half's writes make new tensors.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from defslam_tpu_torch.config import Config
from defslam_tpu_torch.frontend import Features
from defslam_tpu_torch.geometry import se3
from defslam_tpu_torch.mapping import normals as nrm
from defslam_tpu_torch.mapping import registration, sfn, warp
from defslam_tpu_torch.mapstore import state as store
from defslam_tpu_torch.mapstore.state import KeyframeStore, PointStore
from defslam_tpu_torch.ops import bspline, matching
from defslam_tpu_torch.ops.fast import stable_topk
from defslam_tpu_torch.ops.hamming import _popcount32
from defslam_tpu_torch.ops.windowed_match import windowed_match
from defslam_tpu_torch.template import mesh as meshmod
from defslam_tpu_torch.tracking import tracker
from defslam_tpu_torch.utils import (
    first_argmax, first_argmin, last_writer, linspace, masked_median, psd_solve, put_,
    scatter_last, take,
)

# padded capacity of matched points per warp pair
PAIR_CAP = 512
# padded capacity of pair observations per map point for the normal solver
OBS_CAP = 8
# Unit conversion of the covariance gate: the reference thresholds the
# covariance diagonal of a pixel-scaled cost at Regularizer.Reliability
# (NormalEstimator.cc:159); the normal solver here minimizes
# unit-Frobenius-normalized metric residuals.  Conditioned normals show
# covariance diagonals <= ~1e2, degenerate ones >= ~1e7; the gate
# reliability * COV_GATE_SCALE (0.7 -> 1400) sits between.
COV_GATE_SCALE = 2000.0
INT32_MAX = 2**31 - 1


def normal_reliability_gate(nres: nrm.NormalResult, reliability: float) -> torch.Tensor:
    """Covariance acceptance mask (P,); see COV_GATE_SCALE."""
    gate = reliability * COV_GATE_SCALE
    return (nres.valid & (nres.n_obs > 0)
            & (nres.cov[:, 0, 0] <= gate) & (nres.cov[:, 1, 1] <= gate))


def bending_for(dom: torch.Tensor, nu: int, nv: int) -> torch.Tensor:
    return bspline.bending_matrix(dom, nu, nv, device=dom.device)


class WarpBatch(NamedTuple):
    """Padded matched retina pairs for NP warps."""

    uv1: torch.Tensor  # (NP, PAIR_CAP, 2)
    uv2: torch.Tensor  # (NP, PAIR_CAP, 2)
    mask: torch.Tensor  # (NP, PAIR_CAP) bool
    pair_valid: torch.Tensor  # (NP,) bool


class CovisPairs(NamedTuple):
    """Warp-pair tables of one new keyframe."""

    pair_kf: torch.Tensor  # (NP,) int64 covisible keyframe slot per pair
    pair_valid: torch.Tensor  # (NP,) bool
    pid_table: torch.Tensor  # (NP, PAIR_CAP) int64 shared point id, -1 pad
    uv1: torch.Tensor  # (NP, PAIR_CAP, 2) new-KF retina coords
    uv2: torch.Tensor  # (NP, PAIR_CAP, 2) covisible-KF retina coords
    kp_new: torch.Tensor  # (NP, PAIR_CAP) int64 new-KF keypoint index
    kp_other: torch.Tensor  # (NP, PAIR_CAP) int64 covisible-KF keypoint index
    mask: torch.Tensor  # (NP, PAIR_CAP) bool
    n_pairs: torch.Tensor  # () int
    # what the static shapes cut off (the reference's observation sets are
    # unbounded, SchwarpDatabase.cc:83-118), counted so it is never silent
    n_pair_dropped: torch.Tensor  # () eligible pairs past max_warp_pairs
    n_pt_dropped: torch.Tensor  # () shared points past PAIR_CAP


def covis_pairs(point_id: torch.Tensor, retina: torch.Tensor, kf_valid: torch.Tensor,
                points_valid: torch.Tensor, slot, cfg: Config) -> CovisPairs:
    """Covisible-anchor selection and matched-pair tables
    (SchwarpDatabase::add): every stored keyframe sharing at least
    ``min_shared_points`` map points with the new one, strongest first.
    Point->keypoint inverse tables come from two scatters (where two
    keypoints of a keyframe carry one point id, the higher keypoint index
    wins); the top pairs and points from stable rankings."""
    f_cap, k_cap = point_id.shape
    p_cap = points_valid.shape[0]
    np_pairs = cfg.capacity.max_warp_pairs
    dev = point_id.device

    row = torch.arange(f_cap, device=dev)[:, None]
    dest_all = torch.where(point_id >= 0, row * p_cap + point_id, f_cap * p_cap)
    win = last_writer(dest_all, f_cap * p_cap).reshape(f_cap, p_cap)
    inv_all = torch.where(win >= 0, win % k_cap, win)  # (F, P) keypoint index, -1
    inv_new = take(inv_all, slot)

    shared = (inv_new >= 0)[None, :] & (inv_all >= 0) & points_valid[None, :]
    counts = shared.sum(dim=1)
    eligible = kf_valid & (torch.arange(f_cap, device=dev) != slot)
    counts = torch.where(eligible & (counts >= cfg.mapping.min_shared_points), counts, -1)
    n_eligible = (counts > 0).sum()
    top_counts, pair_kf = stable_topk(counts, min(np_pairs, f_cap))
    if np_pairs > f_cap:  # pad to the static pair capacity
        pad = np_pairs - f_cap
        top_counts = torch.cat([top_counts, top_counts.new_full((pad,), -1)])
        pair_kf = torch.cat([pair_kf, pair_kf.new_zeros(pad)])
    pair_valid = top_counts > 0
    n_pt_dropped = torch.where(
        pair_valid, torch.clamp(top_counts - PAIR_CAP, min=0), 0).sum()

    # up to PAIR_CAP shared points per pair, lowest point ids first
    ones, pid_sel = stable_topk(shared[pair_kf].to(torch.int32), min(PAIR_CAP, p_cap), dim=1)
    if p_cap < PAIR_CAP:
        ones = F.pad(ones, (0, PAIR_CAP - p_cap))
        pid_sel = F.pad(pid_sel, (0, PAIR_CAP - p_cap))
    sel_ok = (ones > 0) & pair_valid[:, None]
    kp_new = inv_new[pid_sel]
    kp_i = inv_all[pair_kf[:, None], pid_sel]
    uv1 = take(retina, slot)[torch.clamp(kp_new, 0, k_cap - 1)]
    uv2 = retina[pair_kf[:, None], torch.clamp(kp_i, 0, k_cap - 1)]
    zero2 = torch.zeros_like(uv1)
    return CovisPairs(
        pair_kf=pair_kf,
        pair_valid=pair_valid,
        pid_table=torch.where(sel_ok, pid_sel, -1),
        uv1=torch.where(sel_ok[:, :, None], uv1, zero2),
        uv2=torch.where(sel_ok[:, :, None], uv2, zero2),
        kp_new=torch.where(sel_ok, kp_new, -1),
        kp_other=torch.where(sel_ok, kp_i, -1),
        mask=sel_ok,
        n_pairs=pair_valid.sum(),
        n_pair_dropped=torch.clamp(n_eligible - pair_valid.sum(), min=0),
        n_pt_dropped=n_pt_dropped,
    )


def _group_slots(key: torch.Tensor, n_groups: int, cap: int):
    """Stable grouping of rows by ``key`` (rows with key >= n_groups are
    dropped): returns (order, dest, store_ok, overflow) where row
    ``order[i]`` goes to flat slot ``dest[i]`` of an (n_groups, cap) table
    in arrival order, ``n_groups * cap`` being the discard slot."""
    ks, order = torch.sort(key, stable=True)
    first = torch.searchsorted(ks, ks, right=False)
    rank = torch.arange(ks.shape[0], device=key.device) - first
    in_group = ks < n_groups
    store_ok = in_group & (rank < cap)
    dest = torch.where(store_ok, ks * cap + rank, n_groups * cap)
    return order, dest, store_ok, (in_group & (rank >= cap)).sum()


def _scatter_rows(init: torch.Tensor, dest: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``init`` (n, ...) with ``src`` rows written at ``dest``; slot n
    discards.  Kept destinations are distinct, so the write is
    deterministic."""
    buf = torch.cat([init, init.new_zeros((1,) + init.shape[1:])])
    buf[dest] = src
    return buf[:-1]


def accumulate_obs_device(pid, mask, uv1, warped, J12, Huu, Hvv, n_points: int,
                          obs_cap: int = OBS_CAP):
    """Per-point observation tables for the normal solver: (NP, PAIR_CAP)
    pair observations regrouped by point id, in arrival order, at most
    ``obs_cap`` per point.  Returns (PairObs with (P, O) leading shape,
    number of observations past the cap)."""
    def flat(a):
        return a.reshape((-1,) + a.shape[2:])

    pidf = flat(pid)
    okf = flat(mask) & (pidf >= 0) & (pidf < n_points)
    key = torch.where(okf, pidf, n_points)
    order, dest, store_ok, n_dropped = _group_slots(key, n_points, obs_cap)
    dev = pid.device

    def scat(a, init):
        out = _scatter_rows(init.reshape((n_points * obs_cap,) + a.shape[2:]), dest, flat(a)[order])
        return out.reshape((n_points, obs_cap) + a.shape[2:])

    z2 = torch.zeros((n_points, obs_cap, 2), device=dev)
    eye = torch.eye(2, device=dev).expand(n_points, obs_cap, 2, 2)
    obs_mask = _scatter_rows(
        torch.zeros(n_points * obs_cap, dtype=torch.bool, device=dev), dest, store_ok
    ).reshape(n_points, obs_cap)
    return nrm.PairObs(
        uv1=scat(uv1, z2), uv2=scat(warped, z2), J12=scat(J12, eye),
        Huu=scat(Huu, z2), Hvv=scat(Hvv, z2), mask=obs_mask,
    ), n_dropped


def fit_warps(batch: WarpBatch, dom: torch.Tensor, bending: torch.Tensor, cfg: Config):
    """Fit and refine all pair warps and take their DiffProps.  Returns
    (DiffProps with a leading pair dimension, ctrl (NP, nu, nv, 2)); the
    control grids feed the warp-guided densification."""
    mc = cfg.mapping
    nu, nv = mc.warp_ctrl_u, mc.warp_ctrl_v
    fx, fy = cfg.camera.fx, cfg.camera.fy
    w = batch.mask.to(batch.uv1.dtype)
    ctrl = warp.fit_initial(batch.uv1, batch.uv2, w, dom, nu, nv, bending,
                            mc.schwarp_regularizer * 1e-3)
    ctrl = warp.refine(ctrl, batch.uv1, batch.uv2, w, dom, mc.schwarp_regularizer, fx, fy,
                       num_iters=mc.schwarp_lm_iterations)
    dps = warp.diff_props(ctrl, batch.uv1, batch.uv2, batch.mask, dom, fx, fy, mc.warp_error_px)
    # invalid pairs contribute nothing
    return dps._replace(mask=dps.mask & batch.pair_valid[:, None]), ctrl


def densify_matches(ctrls, retina1, valid1, desc1, retina2, valid2, desc2, dom, pair_valid,
                    cfg: Config):
    """Warp-guided descriptor matching (DefORBmatcher::searchBySchwarp):
    warp every keypoint of KF1 (the new keyframe) into each covisible
    keyframe and match descriptors within a pixel window around the
    prediction, forward and reverse for the mutual-best check.  Both
    directions run through kernel B2.  ctrls (NP, nu, nv, 2); retina1
    (K, 2), valid1 (K,), desc1 (K, 8); retina2 (NP, K, 2), valid2 (NP, K),
    desc2 (NP, K, 8).  Returns (best (NP, K) int64 kp2 index or -1, dist
    (NP, K) int32)."""
    th = cfg.tracking.match_th_low
    rad_ret = 2.0 * cfg.tracking.projection_window / cfg.camera.fx
    n_pairs, k_cap = desc2.shape[0], desc1.shape[0]

    pred = bspline.evaluate(ctrls, retina1[:, 0], retina1[:, 1], dom).contiguous()
    va = valid1[None, :] & pair_valid[:, None]
    d1 = desc1[None].expand(n_pairs, k_cap, 8).contiguous()
    retina2, valid2, desc2 = retina2.contiguous(), valid2.contiguous(), desc2.contiguous()
    best, idx, second = windowed_match(d1, desc2, pred, retina2, va, valid2, rad_ret,
                                       matching.INVALID)
    _, ridx, _ = windowed_match(desc2, d1, retina2, pred, valid2, va, rad_ret,
                                matching.INVALID)
    ok = best <= th
    if cfg.tracking.nn_ratio < 1.0:
        ok = ok & (best.float() <= cfg.tracking.nn_ratio * second.float())
    back = torch.gather(ridx, 1, torch.clamp(idx, 0, desc2.shape[1] - 1))
    ok = ok & (back == torch.arange(k_cap, device=back.device)[None, :])
    return torch.where(ok, idx, -1), best


def solve_normals_compact(obs: nrm.PairObs, k_init: torch.Tensor, capacity: int,
                          num_iters: int = 30) -> nrm.NormalResult:
    """The normal solve with the point axis compacted to ``capacity`` slots
    first: only points with an observation can solve, and at most K
    distinct points appear in the pair tables.  Results scatter back to
    the full axis; pass capacity >= min(max_keypoints, P)."""
    p_cap = k_init.shape[0]
    if capacity >= p_cap:
        return nrm.solve_k1k2(obs, k_init, num_iters=num_iters)
    has = obs.mask.any(dim=1)
    sel, sel_ok, _ = matching.compact_select(has, capacity)
    obs_c = nrm.PairObs(*(a[sel] for a in obs))
    obs_c = obs_c._replace(mask=obs_c.mask & sel_ok[:, None])
    r = nrm.solve_k1k2(obs_c, k_init[sel], num_iters=num_iters)
    dev = k_init.device
    k = torch.zeros((p_cap, 2), dtype=k_init.dtype, device=dev)
    k[sel] = r.k
    cov = (torch.eye(2, dtype=r.cov.dtype, device=dev) * 1e12).repeat(p_cap, 1, 1)
    cov[sel] = r.cov
    cost = torch.zeros(p_cap, dtype=r.cost.dtype, device=dev)
    cost[sel] = r.cost
    n_obs = torch.zeros(p_cap, dtype=r.n_obs.dtype, device=dev)
    n_obs[sel] = r.n_obs
    valid = torch.zeros(p_cap, dtype=torch.bool, device=dev)
    valid[sel] = r.valid & sel_ok
    return nrm.NormalResult(k=k, cov=cov, cost=cost, n_obs=n_obs, valid=valid)


def bbox_domain(uv: torch.Tensor, valid: torch.Tensor, fallback: torch.Tensor,
                margin: float = 0.10, min_extent: float = 0.05) -> torch.Tensor:
    """Keypoint bounding-box retina domain plus a relative margin (the
    reference's per-keyframe warp domain, DefKeyFrame.cc:94-133);
    ``fallback`` when fewer than 4 keypoints are valid or an extent is
    degenerate."""
    big = torch.full_like(uv[:, 0], 1e9)
    lo_u = torch.where(valid, uv[:, 0], big).min()
    hi_u = torch.where(valid, uv[:, 0], -big).max()
    lo_v = torch.where(valid, uv[:, 1], big).min()
    hi_v = torch.where(valid, uv[:, 1], -big).max()
    du, dv = hi_u - lo_u, hi_v - lo_v
    dom_bb = torch.stack([lo_u - margin * du, hi_u + margin * du,
                          lo_v - margin * dv, hi_v + margin * dv])
    ok = (valid.sum() >= 4) & (du >= min_extent) & (dv >= min_extent)
    return torch.where(ok, dom_bb, fallback)


def integrate_surface(retina, k_vals, mask, dom, bending, cfg: Config,
                      ext_dom: torch.Tensor | None = None) -> sfn.SfNResult:
    normals = nrm.normal_from_k(k_vals, retina)
    return sfn.solve(
        retina, normals, mask, dom, cfg.mapping.sfn_ctrl_u, cfg.mapping.sfn_ctrl_v,
        bending, cfg.mapping.bending, mean_depth=1.0,
        flat_extension=cfg.mapping.sfn_flat_extension,
        tilt_extension=cfg.mapping.sfn_tilt_extension, ext_dom=ext_dom,
    )


def registration_pairs(surf_xyz, pid_row, kp_xyz, kp_xyz_valid, norm_valid, points_valid,
                       points_facet, kf_pose):
    """(surface, registered map) 3D pairs in the keyframe's camera frame
    for the Sim(3) registration (SurfaceRegistration.cc:48-105): the
    positions stored at keyframe insertion, of points that are embedded.
    ``mask`` also requires a reliable normal and drives the registration;
    ``embedded`` does not and anchors the polish.  The map positions of
    pairs outside ``embedded`` are zeroed but stay in the min-median scale
    candidate pool, as in the reference."""
    p_cap = points_valid.shape[0]
    pid = torch.clamp(pid_row, 0, p_cap - 1)
    embedded = (pid_row >= 0) & points_valid[pid] & (points_facet[pid] >= 0) & kp_xyz_valid
    mask = embedded & norm_valid
    map_cam = se3.transform(kf_pose, kp_xyz)
    return (surf_xyz, torch.where(embedded[:, None], map_cam, torch.zeros_like(map_cam)),
            mask, embedded)


def polish_surface(ctrl, reg: registration.RegistrationResult, retina, map_cam, pair_mask,
                   dom, bend, cfg: Config, grid_dom: torch.Tensor | None = None):
    """Map-consistency polish (``mapping.consistency_polish`` > 0): re-fit
    the control depths so the registered surface passes through the inlier
    map points while a 16x16 grid of anchors over ``grid_dom`` keeps the
    SfN shape elsewhere.  One ridge-regularized linear solve."""
    lam = cfg.mapping.consistency_polish
    if lam <= 0.0:
        return ctrl
    gdom = dom if grid_dom is None else grid_dom
    nu, nv = ctrl.shape
    u, v = retina[:, 0], retina[:, 1]
    # target depth along each keypoint ray, in the surface frame:
    # x_surf = (1/s) R^T (m - t), d = <x_surf, ray> / |ray|^2
    x_t = (map_cam - reg.t) @ reg.R / torch.clamp(reg.s, min=1e-9)
    ray2 = u * u + v * v + 1.0
    d_tgt = (x_t[:, 0] * u + x_t[:, 1] * v + x_t[:, 2]) / ray2
    d_cur = bspline.evaluate(ctrl, u, v, dom)
    surf = torch.stack([u * d_cur, v * d_cur, d_cur], dim=-1)
    r = torch.linalg.norm(reg.s * surf @ reg.R.T + reg.t - map_cam, dim=-1)
    med = masked_median(r, pair_mask)
    w_t = (pair_mask & (r <= 2.5 * med + 1e-9) & (d_tgt > 1e-3)).to(ctrl.dtype) * lam
    g = 16
    GU, GV = torch.meshgrid(linspace(gdom[0], gdom[1], g), linspace(gdom[2], gdom[3], g),
                            indexing="ij")
    gu, gv = GU.reshape(-1), GV.reshape(-1)
    d_grid = bspline.evaluate(ctrl, gu, gv, dom)
    uu, vv = torch.cat([u, gu]), torch.cat([v, gv])
    vals = torch.cat([d_tgt, d_grid])
    wts = torch.cat([w_t, torch.ones(g * g, dtype=ctrl.dtype, device=ctrl.device)])
    A = bspline.coloc_2d(uu, vv, dom, nu, nv)
    k = nu * nv
    wA_t = (A * wts[:, None]).T
    AtA = wA_t @ A + 1e-3 * bend
    AtA = AtA + (1e-6 * torch.trace(AtA) / k) * torch.eye(k, dtype=ctrl.dtype, device=ctrl.device)
    return psd_solve(AtA, wA_t @ vals).reshape(nu, nv)


def register_surface(surf_xyz, map_xyz_cam, mask, cfg: Config):
    return registration.register(
        surf_xyz, map_xyz_cam, mask, chi_limit=cfg.mapping.chi_limit,
        min_pairs=cfg.mapping.min_registration_points,
    )


def apply_densify(point_id: torch.Tensor, n_obs: torch.Tensor, slot,
                  kf_idx: torch.Tensor, best: torch.Tensor):
    """Merge densified matches into the observation tables
    (DefORBmatcher.cc:270-292).  Per (pair, kp k) with match j = best:
      the new KF's kp has a point, the other's has none -> the other gains it;
      the other's kp has a point, the new KF's has none -> the new KF gains it.
    Where several pairs write one table entry, the last pair in order wins
    (the reference's in-order scatter).  Returns (point_id (F, K), n_obs)."""
    n_pairs, k_cap = best.shape
    f_cap = point_id.shape[0]
    p_cap = n_obs.shape[0]
    pid_new = take(point_id, slot)

    j = torch.clamp(best, 0, k_cap - 1)
    matched = best >= 0
    pid_other = torch.gather(point_id[kf_idx], 1, j)  # (NP, K)
    give_other = matched & (pid_new[None, :] >= 0) & (pid_other < 0)
    give_new = matched & (pid_new[None, :] < 0) & (pid_other >= 0)

    # other keyframes gain observations of the new KF's points
    vals_new = pid_new[None, :].expand(n_pairs, k_cap)
    dest = torch.where(give_other, kf_idx[:, None] * k_cap + j, f_cap * k_cap)
    flat = scatter_last(point_id.reshape(-1), dest, vals_new)
    # the new KF gains observations of other keyframes' points
    col = torch.arange(k_cap, device=best.device)[None, :].expand(n_pairs, k_cap)
    dest = torch.where(give_new, slot * k_cap + col, f_cap * k_cap)
    flat = scatter_last(flat, dest, pid_other)

    delta = torch.zeros(p_cap + 1, dtype=n_obs.dtype, device=n_obs.device)
    one = torch.ones(n_pairs * k_cap, dtype=n_obs.dtype, device=n_obs.device)
    delta.index_add_(0, torch.where(give_other, vals_new, p_cap).reshape(-1), one)
    delta.index_add_(0, torch.where(give_new, pid_other, p_cap).reshape(-1), one)
    return flat.reshape(f_cap, k_cap), n_obs + delta[:-1]


def write_normals(norm_k, norm_valid, slot, pid_row, k_solved, solved_ok):
    """Write the solved per-point normals into the keyframe's per-keypoint
    slots (Surface::setNormalSurfacePoint), in place.  Returns (norm_k,
    norm_valid, number written)."""
    p_cap = k_solved.shape[0]
    pid = torch.clamp(pid_row, 0, p_cap - 1)
    has = (pid_row >= 0) & solved_ok[pid]
    put_(norm_k, slot, torch.where(has[:, None], k_solved[pid], take(norm_k, slot)))
    put_(norm_valid, slot, take(norm_valid, slot) | has)
    return norm_k, norm_valid, has.sum()


def propagate_normals(norm_k, norm_valid, cp: CovisPairs, dps: warp.DiffProps, k_solved,
                      solved_ok):
    """Transfer the normals solved at the new keyframe to the covisible
    keyframes through the warp Jacobians (NormalEstimator.cc:173-224).
    Where several observations land on one keypoint the last in order
    wins."""
    p_cap = k_solved.shape[0]
    f_cap, k_cap = norm_valid.shape
    pid = torch.clamp(cp.pid_table, 0, p_cap - 1)
    has = (cp.pid_table >= 0) & solved_ok[pid] & dps.mask & (cp.kp_other >= 0)
    k_t = nrm.transfer_k(k_solved[pid], nrm.pair_obs(dps))  # (NP, C, 2)
    dest = torch.where(
        has, cp.pair_kf[:, None] * k_cap + torch.clamp(cp.kp_other, 0, k_cap - 1),
        f_cap * k_cap,
    )
    norm_k = scatter_last(norm_k.reshape(-1, 2), dest, k_t).reshape(f_cap, k_cap, 2)
    norm_valid = scatter_last(norm_valid.reshape(-1), dest, True).reshape(f_cap, k_cap)
    return norm_k, norm_valid


def exploration_count(kp_xy, kp_valid, pid_row, cfg: Config) -> torch.Tensor:
    """needNewTemplate's exploration test (DefLocalMapping.cc:355-404):
    rasterize the matched keypoints, dilate with a (width/20)^2 box, and
    count the unmatched keypoints outside the dilated mask.  The box is the
    reference's window: for an even side k it reaches (k-1)//2 before and
    k//2 after the pixel."""
    h, w = cfg.camera.height, cfg.camera.width
    x = torch.clamp(kp_xy[:, 0].long(), 0, w - 1)
    y = torch.clamp(kp_xy[:, 1].long(), 0, h - 1)
    matched = kp_valid & (pid_row >= 0)
    occ = torch.zeros(h * w, device=kp_xy.device)
    occ.scatter_reduce_(0, y * w + x, matched.float(), reduce="amax")
    k = max(w // 20, 1)
    lo, hi = (k - 1) // 2, k // 2
    dil = F.max_pool2d(F.pad(occ.reshape(1, 1, h, w), (lo, hi, lo, hi)), k, stride=1)[0, 0]
    outside = dil[y, x] < 0.5
    return (kp_valid & (pid_row < 0) & outside).sum()


def select_ref_keyframe(pid_row, point_ref_kf, point_valid, kf_valid, slot) -> torch.Tensor:
    """selectKeyframe (DefLocalMapping.cc:411-441): the points the new
    keyframe observes vote for their creating keyframe; the first maximum
    wins, the new keyframe itself without votes."""
    p_cap = point_ref_kf.shape[0]
    f_cap = kf_valid.shape[0]
    pid = torch.clamp(pid_row, 0, p_cap - 1)
    ok = (pid_row >= 0) & point_valid[pid]
    ref = torch.clamp(point_ref_kf[pid], 0, f_cap - 1)
    votes = torch.zeros(f_cap + 1, dtype=torch.int64, device=pid_row.device)
    votes.index_add_(0, torch.where(ok, ref, f_cap), torch.ones_like(ref))
    votes = torch.where(kf_valid, votes[:-1], 0)
    return torch.where(votes.max() > 0, first_argmax(votes), slot)


class TemplateRegen(NamedTuple):
    template: meshmod.Template
    point_xyz: torch.Tensor  # (K, 3) world positions of the ref-KF keypoints
    point_facet: torch.Tensor  # (K,) facet of each ref-KF keypoint
    point_bary: torch.Tensor  # (K, 3)
    point_inside: torch.Tensor  # (K,) bool: keypoint inside the mesh domain


def regen_template(surf_ctrl, reg: registration.RegistrationResult, kf_pose, retina, dom,
                   cfg: Config, spline_dom: torch.Tensor | None = None) -> TemplateRegen:
    """updateTemplate (DefLocalMapping.cc:138-153): sample the registered
    surface on the node grid, build the template in the world frame, and
    embed the keyframe's keypoints.  ``spline_dom`` is the SfN spline's own
    domain; the node grid and the embedding use the camera-wide ``dom``."""
    sdom = dom if spline_dom is None else spline_dom
    topo = meshmod.grid_topology(cfg.mesh.nodes_u, cfg.mesh.nodes_v)
    T_cw = se3.inverse(kf_pose)

    def surf_xyz_fn(u, v):
        d = bspline.evaluate(surf_ctrl, u, v, sdom)
        cam_pts = torch.stack([u * d, v * d, d], dim=-1)
        return se3.transform(T_cw, reg.s * cam_pts @ reg.R.T + reg.t)

    nodes = meshmod.grid_nodes_from_surface(surf_xyz_fn, dom, topo)
    facet, bary, inside = meshmod.embed_uv(retina, dom, topo)
    return TemplateRegen(
        template=meshmod.make_template(nodes, topo),
        point_xyz=surf_xyz_fn(retina[:, 0], retina[:, 1]),
        point_facet=facet, point_bary=bary, point_inside=inside,
    )


def rebuild_points(points: PointStore, regen: TemplateRegen, kf_pose, K, pid_row, kp_valid,
                   kp_desc, kp_angle, slot, dom, cfg: Config, kf_counter: int = 0):
    """CreateNewMapPoints (DefLocalMapping.cc:240-347):

    1. points observed by the reference keyframe move onto the new surface
       (of two keypoints carrying one point, the higher index wins);
    2. every point is re-embedded into the new template through its
       projection into the reference keyframe's retina;
    3. unmatched keypoints inside the mesh become new map points in the
       free store slots, lowest slot first.

    Returns (new PointStore, updated pid_row)."""
    topo = meshmod.grid_topology(cfg.mesh.nodes_u, cfg.mesh.nodes_v)
    p_cap = points.capacity
    k_cap = pid_row.shape[0]
    dev = pid_row.device

    cond = (pid_row >= 0) & regen.point_inside & kp_valid
    tgt = torch.where(cond, torch.clamp(pid_row, 0, p_cap - 1), p_cap)
    xyz = scatter_last(points.xyz, tgt, regen.point_xyz)

    pc = se3.transform(kf_pose, xyz)
    z = torch.clamp(pc[:, 2], min=1e-6)
    retina_p = torch.stack([pc[:, 0] / z, pc[:, 1] / z], dim=-1)
    facet_all, bary_all, inside_all = meshmod.embed_uv(retina_p, dom, topo)
    embeddable = inside_all & (pc[:, 2] > 1e-6) & points.valid
    facet = torch.where(embeddable, facet_all, -1)
    bary = torch.where(embeddable[:, None], bary_all, torch.zeros_like(bary_all))

    new_mask = kp_valid & (pid_row < 0) & regen.point_inside
    rank = torch.cumsum(new_mask.to(torch.int64), dim=0) - 1
    free_order = torch.sort(points.valid.to(torch.int32), stable=True).indices
    n_free = (~points.valid).sum()
    can = new_mask & (rank < n_free)
    dest = torch.where(can, free_order[torch.clamp(rank, 0, p_cap - 1)], p_cap)

    def put(init, src):
        if not torch.is_tensor(src):
            src = torch.full((k_cap,) + init.shape[1:], src, dtype=init.dtype, device=dev)
        return _scatter_rows(init, dest, src.to(init.dtype))

    new_points = points._replace(
        xyz=put(xyz, regen.point_xyz),
        desc=put(points.desc, kp_desc),
        angle=put(points.angle, kp_angle),
        facet=put(facet, regen.point_facet),
        bary=put(bary, regen.point_bary),
        ref_kf=put(points.ref_kf, slot),
        ref_kp=put(points.ref_kp, torch.arange(k_cap, device=dev)),
        valid=put(points.valid, True),
        n_obs=put(points.n_obs, 1),
        # new points start Found/Visible at 1/1 (MapPoint ctor) and carry
        # their birth keyframe for the found-ratio culling window
        n_visible=put(points.n_visible, 1),
        n_found=put(points.n_found, 1),
        first_kf=put(points.first_kf, int(kf_counter)),
        norm_k0=put(points.norm_k0, 0.0),
    )
    return new_points, torch.where(can, dest, pid_row)


def cull_points(points: PointStore, point_id, kf_valid, kf_counter: int = 1 << 30):
    """MapPointCulling (LocalMapping.cc:173-199): drop a point that no
    valid keyframe references and that is not embedded in the template;
    drop a RECENT point (born within the last 3 keyframes) whose
    found/visible ratio is below 0.25, or that is 2 keyframes old with at
    most 2 observations.  Returns (points, n_culled)."""
    p_cap = points.capacity
    ids = torch.where(kf_valid[:, None] & (point_id >= 0), point_id, p_cap).reshape(-1)
    referenced = torch.zeros(p_cap + 1, dtype=torch.bool, device=ids.device)
    referenced.index_fill_(0, ids, True)
    keep = points.valid & (referenced[:-1] | (points.facet >= 0))
    age = int(kf_counter) - points.first_kf
    ratio = points.n_found.float() / torch.clamp(points.n_visible, min=1).float()
    bad_recent = (age < 3) & ((ratio < 0.25) | ((age >= 2) & (points.n_obs <= 2)))
    keep = keep & ~bad_recent
    return points._replace(valid=keep), (points.valid & ~keep).sum()


def distinctive_descriptors(point_id, kf_valid, kp_valid, kf_desc, points_desc):
    """MapPoint::ComputeDistinctiveDescriptors, batched: per map point, up
    to OBS_CAP observed descriptors (in keyframe, keypoint order) and of
    those the medoid, the first one minimizing the summed Hamming distance
    to the others.  Points with < 2 gathered observations keep theirs."""
    p_cap = points_desc.shape[0]
    pidf = torch.where(kf_valid[:, None] & kp_valid & (point_id >= 0), point_id, p_cap).reshape(-1)
    order, dest, store_ok, _ = _group_slots(pidf, p_cap, OBS_CAP)
    dev = point_id.device
    buf = _scatter_rows(
        torch.zeros((p_cap * OBS_CAP, 8), dtype=kf_desc.dtype, device=dev), dest,
        kf_desc.reshape(-1, 8)[order],
    ).reshape(p_cap, OBS_CAP, 8)
    got = _scatter_rows(
        torch.zeros(p_cap * OBS_CAP, dtype=torch.bool, device=dev), dest, store_ok
    ).reshape(p_cap, OBS_CAP)
    x = (buf[:, :, None, :] ^ buf[:, None, :, :]).to(torch.int64) & 0xFFFFFFFF
    d = _popcount32(x).sum(dim=-1)  # (P, O, O)
    pair_ok = got[:, :, None] & got[:, None, :]
    sums = torch.where(pair_ok, d, 0).sum(dim=-1)
    sums = torch.where(got, sums, INT32_MAX)
    best = first_argmin(sums, dim=-1)
    medoid = torch.gather(buf, 1, best[:, None, None].expand(-1, 1, 8))[:, 0]
    return torch.where((got.sum(dim=1) >= 2)[:, None], medoid, points_desc)


class MappingDiag(NamedTuple):
    """Scalars of one keyframe step (0-dim tensors on the device)."""

    slot: torch.Tensor  # keyframe slot used
    kf_t: torch.Tensor  # template-source keyframe
    accepted: torch.Tensor  # bool: the template was regenerated and swapped
    exploring: torch.Tensor  # bool
    n_pairs: torch.Tensor  # covisible warp pairs
    n_new: torch.Tensor  # exploration count
    n_norm: torch.Tensor  # normals on the template keyframe
    n_culled: torch.Tensor  # points culled this step
    obs_dropped: torch.Tensor  # observations past OBS_CAP
    pair_dropped: torch.Tensor  # eligible pairs past max_warp_pairs
    pt_dropped: torch.Tensor  # shared points past PAIR_CAP
    # surface->map scale of the accepted registration (1.0 without a swap);
    # SfN normalizes the surface to median depth 1, so across swaps this is
    # the map's absolute-scale trajectory
    reg_scale: torch.Tensor


class KFCarry(NamedTuple):
    """What the first half of the keyframe step hands to the second (0-dim
    tensors on the device, as in the JAX package): everything else the
    second half needs lives in the stores."""

    slot: torch.Tensor  # int64 keyframe slot used
    kf_t: torch.Tensor  # int64 template-source keyframe
    gate: torch.Tensor  # bool: the NRSfM chain runs
    exploring: torch.Tensor
    n_new: torch.Tensor
    n_norm: torch.Tensor
    n_pairs: torch.Tensor
    obs_dropped: torch.Tensor
    pair_dropped: torch.Tensor
    pt_dropped: torch.Tensor


def _choose_slot(kfs: KeyframeStore, points: PointStore, tmpl_ref_kf: int) -> torch.Tensor:
    """First free slot; at capacity the most redundant keyframe if more
    than 90% of its points have >= 4 observations (KeyFrameCulling's rule,
    applied lazily), else the oldest; never the template's source.  A
    0-dim int64 tensor on the device: no host read."""
    f_cap = kfs.capacity
    p_cap = points.capacity
    free = ~kfs.valid
    first_free = first_argmax(free.to(torch.int32))
    pid_ok = kfs.point_id >= 0
    pidc = torch.clamp(kfs.point_id, 0, p_cap - 1)
    redundant = pid_ok & (points.n_obs[pidc] >= 4)
    red_ratio = redundant.sum(dim=1) / torch.clamp(pid_ok.sum(dim=1), min=1)
    evictable = kfs.valid & (torch.arange(f_cap, device=free.device) != tmpl_ref_kf)
    red_ratio = torch.where(evictable, red_ratio, -1.0)
    most_red = first_argmax(red_ratio)
    oldest = first_argmin(torch.where(evictable, kfs.frame_id, INT32_MAX))
    evict = torch.where(red_ratio.max() > 0.9, most_red, oldest)
    return torch.where(free.any(), first_free, evict)


def _no_mark(_name, **_tensors):
    return None


def _kf_step_a(kfs, points, pose, feats: Features, kp_of_point, inlier, K, dom, bend_warp,
               tmpl_ref_kf: int, frame_id: int, cfg: Config, mark):
    """First half: slot choice and insertion, warps, densification,
    distinctive descriptors, normals, and the template decision.  No host
    read.  Returns (kfs, points, KFCarry)."""
    c = cfg
    p_cap = points.capacity
    slot = _choose_slot(kfs, points, tmpl_ref_kf)

    kfs, n_obs2 = store.insert_keyframe_from_matches(
        kfs, points.n_obs, slot, pose, feats, kp_of_point, inlier, K, frame_id, points.xyz)
    points = points._replace(n_obs=n_obs2)
    mark("insert")

    cp = covis_pairs(kfs.point_id, kfs.retina, kfs.valid, points.valid, slot, c)
    batch = WarpBatch(uv1=cp.uv1, uv2=cp.uv2, mask=cp.mask, pair_valid=cp.pair_valid)
    retina_s, kp_valid_s = take(kfs.retina, slot), take(kfs.kp_valid, slot)
    # per-KF warp domain (DefKeyFrame.cc:94-133): all warps of the batch
    # have the new keyframe as source, so one bbox domain serves them
    if c.mapping.per_kf_domain:
        dom_w = bbox_domain(retina_s, kp_valid_s, dom, margin=c.mapping.kf_domain_margin)
        bend_w = bspline.bending_matrix_dyn(dom_w, c.mapping.warp_ctrl_u, c.mapping.warp_ctrl_v)
    else:
        dom_w, bend_w = dom, bend_warp
    dps, ctrls = fit_warps(batch, dom_w, bend_w, c)
    mark("warps")

    best, _dist = densify_matches(
        ctrls, retina_s, kp_valid_s, take(kfs.desc, slot),
        kfs.retina[cp.pair_kf], kfs.kp_valid[cp.pair_kf], kfs.desc[cp.pair_kf],
        dom_w, cp.pair_valid, c,
    )
    best = torch.where(cp.pair_valid[:, None], best, -1)
    point_id2, n_obs3 = apply_densify(kfs.point_id, points.n_obs, slot, cp.pair_kf, best)
    kfs = kfs._replace(point_id=point_id2)
    points = points._replace(n_obs=n_obs3)
    points = points._replace(desc=distinctive_descriptors(
        kfs.point_id, kfs.valid, kfs.kp_valid, kfs.desc, points.desc))
    mark("densify", best=best)

    obs, obs_dropped = accumulate_obs_device(
        cp.pid_table, dps.mask, cp.uv1, dps.warped, dps.J12, dps.Huu, dps.Hvv, p_cap, OBS_CAP)
    nres = solve_normals_compact(
        obs, points.norm_k0, min(feats.capacity, p_cap),
        num_iters=c.mapping.normal_lm_iterations,
    )
    # covariance gate (NormalEstimator.cc:159); gated normals also stay out
    # of the Sim(3) registration through norm_valid
    solved_ok = normal_reliability_gate(nres, c.regularizer.reliability)
    points = points._replace(
        norm_k0=torch.where(solved_ok[:, None], nres.k, points.norm_k0))
    pid_row = take(kfs.point_id, slot)
    norm_k, norm_valid, _ = write_normals(
        kfs.norm_k, kfs.norm_valid, slot, pid_row, nres.k, solved_ok)
    norm_k, norm_valid = propagate_normals(norm_k, norm_valid, cp, dps, nres.k, solved_ok)
    kfs = kfs._replace(norm_k=norm_k, norm_valid=norm_valid)

    # template decision (needNewTemplate 355-404, selectKeyframe 411-441,
    # enoughNormals Surface.cc:62-67)
    n_new = exploration_count(take(kfs.xy, slot), kp_valid_s, pid_row, c)
    sel = select_ref_keyframe(pid_row, points.ref_kf, points.valid, kfs.valid, slot)
    exploring = n_new > c.mapping.points_to_template
    kf_t = torch.where(exploring, slot, sel)
    n_norm_t = kfs.norm_valid.sum(dim=1).gather(0, kf_t.reshape(1))[0]
    gate = (cp.n_pairs > 0) & (n_norm_t >= c.mapping.min_normals)
    mark("normals")
    carry = KFCarry(
        slot=slot, kf_t=kf_t, gate=gate, exploring=exploring, n_new=n_new,
        n_norm=n_norm_t, n_pairs=cp.n_pairs, obs_dropped=obs_dropped,
        pair_dropped=cp.n_pair_dropped, pt_dropped=cp.n_pt_dropped,
    )
    return kfs, points, carry


def _kf_step_b(kfs, points, tmpl, pose, feats: Features, carry: KFCarry, K, dom, bend_sfn,
               kf_counter: int, cfg: Config, mark, split: bool = False,
               gate: bool | None = None):
    """Second half: SfN, Sim(3) registration, re-template, re-anchoring
    SfT, lifecycle culling.  Two host reads decide its branches: the gate
    (``gate``, when the caller has read ``carry.gate`` already, saves it)
    and the registration's verdict.  Its writes to the stores make new
    tensors: the stores it is given stay as they were (they are the
    rollback snapshot of the frame the split dispatch runs between the
    halves).  ``split`` selects the re-anchor's formulation (see below).
    Returns (kfs, points, template, pose, diag, gauge)."""
    c = cfg
    kf_t = carry.kf_t
    dev = pose.device
    accepted = torch.zeros((), dtype=torch.bool, device=dev)
    reg_s = torch.ones((), device=dev)
    gauge = torch.eye(4, device=dev)
    if bool(carry.gate) if gate is None else gate:  # host read: the chain runs
        retina_t = take(kfs.retina, kf_t)
        kp_valid_t = take(kfs.kp_valid, kf_t)
        norm_valid_t = take(kfs.norm_valid, kf_t)
        pose_t = take(kfs.pose, kf_t)
        pid_t = take(kfs.point_id, kf_t)
        # per-KF SfN domain: the depth spline lives on the reference
        # keyframe's keypoint bbox; the extension prior, the polish anchors
        # and the template grid stay on the camera-wide domain
        if c.mapping.per_kf_domain:
            dom_s = bbox_domain(retina_t, kp_valid_t, dom, margin=c.mapping.kf_domain_margin)
            bend_s = bspline.bending_matrix_dyn(dom_s, c.mapping.sfn_ctrl_u, c.mapping.sfn_ctrl_v)
        else:
            dom_s, bend_s = dom, bend_sfn
        res_sfn = integrate_surface(retina_t, take(kfs.norm_k, kf_t), norm_valid_t,
                                    dom_s, bend_s, c, ext_dom=dom)
        surf_xyz, map_xyz, mask, embedded = registration_pairs(
            res_sfn.xyz, pid_t, take(kfs.kp_xyz, kf_t), take(kfs.kp_xyz_valid, kf_t),
            norm_valid_t, points.valid, points.facet, pose_t,
        )
        reg = register_surface(surf_xyz, map_xyz, mask, c)
        accepted = res_sfn.ok & reg.accepted
        mark("sfn_registration")
        if bool(accepted):  # host read: the expensive branch runs only then
            ctrl_p = polish_surface(res_sfn.ctrl, reg, retina_t, map_xyz, embedded, dom_s,
                                    bend_s, c, grid_dom=dom)
            regen = regen_template(ctrl_p, reg, pose_t, retina_t, dom, c, spline_dom=dom_s)
            points, pid_row_new = rebuild_points(
                points, regen, pose_t, K, pid_t, kp_valid_t, take(kfs.desc, kf_t),
                take(kfs.angle, kf_t), kf_t, dom, c, kf_counter,
            )
            kfs = kfs._replace(
                point_id=put_(kfs.point_id.clone(), kf_t, pid_row_new),
                surf_ctrl=put_(kfs.surf_ctrl.clone(), kf_t, ctrl_p),
                surf_valid=put_(kfs.surf_valid.clone(), kf_t, True),
                surf_dom=put_(kfs.surf_dom.clone(), kf_t, dom_s),
            )
            mark("retemplate")
            # re-anchor camera and new mesh against the keyframe's features
            # with the temporal term off (DefTracking.cc:115-117).  Fused,
            # the keyframe is the current frame: the solve starts from
            # `pose` and its result replaces the live pose (bit for bit the
            # earlier behaviour).  Split, the system has moved on a frame:
            # the solve anchors on the keyframe's stored pose, and the
            # swap's change of gauge, pose_kf^-1 @ re-anchored pose, is
            # applied to the live pose (and by the caller to its motion
            # model) instead of rewinding to the keyframe's viewpoint.
            pose_kf = take(kfs.pose, carry.slot) if split else pose
            m2 = tracker.match_points_to_frame(points, pose_kf, K, feats, c)
            res2 = tracker.sft_track(points, m2, feats, regen.template, pose_kf, K, c,
                                     reg_temp=0.0)
            tmpl = regen.template._replace(nodes=res2.nodes)
            points = tracker.reposition_points(points, res2.nodes, c)
            if split:
                gauge = se3.inverse(pose_kf) @ res2.T
                pose = pose @ gauge
            else:
                pose = res2.T
            reg_s = reg.s.float()
            mark("reanchor")

    points, n_culled = cull_points(points, kfs.point_id, kfs.valid, kf_counter)
    diag = MappingDiag(
        slot=carry.slot, kf_t=kf_t, accepted=accepted, exploring=carry.exploring,
        n_pairs=carry.n_pairs, n_new=carry.n_new, n_norm=carry.n_norm, n_culled=n_culled,
        obs_dropped=carry.obs_dropped, pair_dropped=carry.pair_dropped,
        pt_dropped=carry.pt_dropped, reg_scale=reg_s,
    )
    mark("cull")
    return kfs, points, tmpl, pose, diag, gauge


def keyframe_step(kfs: KeyframeStore, points: PointStore, tmpl: meshmod.Template,
                  pose: torch.Tensor, feats: Features, kp_of_point: torch.Tensor,
                  inlier: torch.Tensor, K: torch.Tensor, dom: torch.Tensor,
                  bend_warp: torch.Tensor, bend_sfn: torch.Tensor, tmpl_ref_kf: int,
                  kf_counter: int, frame_id: int, cfg: Config,
                  mark: Callable[..., None] | None = None):
    """The whole keyframe step: slot choice (redundancy-aware eviction),
    keyframe insertion, warps -> densify -> distinctive descriptors ->
    normals (covariance-gated, warm-started) -> template decision -> SfN +
    Sim(3) + re-template -> re-anchoring SfT -> lifecycle culling.

    ``pose`` is the current frame's pose (the new keyframe's);
    ``kp_of_point`` (P,) and ``inlier`` (P,) are the frame's matches and the
    SfT's inlier gate; ``tmpl_ref_kf`` is the current template's source
    keyframe.  ``mark(name, **tensors)`` is called at the start and at the
    end of each stage, for timing and inspection (the densify stage hands
    over its match table as ``best``).  The first half updates the
    keyframe store in place.  Two host reads (the gate and the
    registration's verdict).  Returns (kfs, points, template, pose,
    MappingDiag).  The same computation runs as two calls,
    :func:`keyframe_step_a` and :func:`keyframe_step_b`, so the caller can
    put a frame between them (``tracking.split_keyframe_dispatch``)."""
    mark = mark or _no_mark
    mark("start")
    kfs, points, carry = _kf_step_a(
        kfs, points, pose, feats, kp_of_point, inlier, K, dom, bend_warp, tmpl_ref_kf,
        frame_id, cfg, mark,
    )
    return _kf_step_b(kfs, points, tmpl, pose, feats, carry, K, dom, bend_sfn, kf_counter,
                      cfg, mark)[:5]


def keyframe_step_a(kfs, points, pose, feats, kp_of_point, inlier, K, dom, bend_warp,
                    tmpl_ref_kf: int, frame_id: int, cfg: Config,
                    mark: Callable[..., None] | None = None):
    """First half of the split keyframe chain (insert, warps, densify,
    normals, the decision scalars), with no host read; see
    :func:`keyframe_step`.  Returns (kfs, points, KFCarry)."""
    mark = mark or _no_mark
    mark("start")
    return _kf_step_a(kfs, points, pose, feats, kp_of_point, inlier, K, dom, bend_warp,
                      tmpl_ref_kf, frame_id, cfg, mark)


def keyframe_step_b(kfs, points, tmpl, pose, feats, carry: KFCarry, K, dom, bend_sfn,
                    kf_counter: int, cfg: Config, mark: Callable[..., None] | None = None,
                    gate: bool | None = None):
    """Second half of the split keyframe chain (SfN, Sim(3), re-template,
    re-anchor, culling); see :func:`keyframe_step`.  ``pose`` is the live
    pose, a frame past the keyframe; the re-anchor starts from the
    keyframe's stored pose and the swap's gauge is applied to ``pose``.
    The stores given stay unchanged.  Returns (kfs, points, template,
    pose, diag, gauge): ``gauge`` (4, 4) is the identity unless the
    template was swapped."""
    return _kf_step_b(kfs, points, tmpl, pose, feats, carry, K, dom, bend_sfn, kf_counter,
                      cfg, mark or _no_mark, split=True, gate=gate)
