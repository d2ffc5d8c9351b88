"""Loop detection, Sim(3) computation and loop correction (rigid mode).

Port of ``defslam_tpu/rigid/loop_closing.py`` (the reference's
``LoopClosing.cc``: DetectLoop 101-226, ComputeSim3 228-396, CorrectLoop
398-616).  The DBoW2 inverted index becomes dense descriptor voting:
keyframe pairs that share many independently matched descriptors are the
candidates, the covisible neighbourhood and recent keyframes excluded.

1. :func:`detect_loop`: the keyframe's descriptors against every slot in
   ONE launch of kernel B1 (a (K, F*K) distance matrix viewed as (K, F, K),
   as ``tracking/pose_opt.keyframe_votes`` does; the JAX package maps over
   the slots one (K, K) matrix at a time), each slot masked and matched on
   its own, so the votes are the JAX package's.
2. :func:`compute_sim3`: 3D-3D pairs through both keyframes' observation
   tables -> closed-form Horn -> ``ba.optimize_sim3`` (th2 = 10).
3. :func:`correct_loop`: the essential graph over keyframe Sim(3) poses
   (odometry chain, covisibility edges, the measured loop edge; the loop
   keyframe fixed), and each point moved with its reference keyframe.

:func:`close_loop`, :func:`fuse_and_global_ba` and the point merges around
them are host code over numpy copies, as in the JAX package.  Ranking keeps
the JAX tie rules: ``stable_topk`` for ``jax.lax.top_k``, a stable argsort,
the first maximum for ``jnp.argmax``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from defslam_tpu_torch.config import Config
from defslam_tpu_torch.geometry import se3
from defslam_tpu_torch.mapstore.state import KeyframeStore, PointStore
from defslam_tpu_torch.ops import matching
from defslam_tpu_torch.ops.fast import stable_topk
from defslam_tpu_torch.ops.hamming import hamming_matrix
from defslam_tpu_torch.rigid import ba
from defslam_tpu_torch.rigid import triangulation as tri
from defslam_tpu_torch.utils import first_argmax

_INT32_MAX = 2**31 - 1


class LoopCandidate(NamedTuple):
    found: torch.Tensor  # () bool
    kf: torch.Tensor  # () int64: the candidate keyframe slot
    votes: torch.Tensor  # () int64: descriptor votes
    match_idx: torch.Tensor  # (K,) current-KF kp -> candidate kp, -1


def detect_loop(kfs: KeyframeStore, slot: int, cfg: Config, min_votes: int = 40,
                min_gap: int = 3) -> LoopCandidate:
    """The best loop-candidate keyframe for ``slot``.  Votes: mutual best
    descriptor matches below TH_LOW with the 0.75 ratio and the rotation
    check (the BoW score's role).  Excluded: invalid slots, ``slot``
    itself, keyframes within ``min_gap`` insertions (LoopClosing.cc:110),
    and covisible keyframes (>= ``min_shared_points`` shared points,
    LoopClosing.cc:116-133)."""
    f_cap, k_cap = kfs.point_id.shape
    p_cap = cfg.capacity.max_map_points
    d = hamming_matrix(kfs.desc[slot], kfs.desc.reshape(f_cap * k_cap, 8)).view(k_cap, f_cap, k_cap)
    ok = kfs.kp_valid[slot][:, None, None] & kfs.kp_valid[None]
    d.masked_fill_(~ok, matching.INVALID)
    m = matching.best_match(d, max_dist=cfg.tracking.match_th_low, nn_ratio=0.75, mutual=True)
    idx = matching.rotation_consistency(kfs.angle[slot], kfs.angle, m).idx  # (K, F)
    votes = (idx >= 0).sum(dim=0)
    # covisibility: pairs of keypoints of the two tables bound to one point
    pid_q = kfs.point_id[slot]
    pid_o = torch.where(kfs.point_id >= 0, kfs.point_id, torch.full_like(kfs.point_id, p_cap))
    cnt = torch.zeros((f_cap, p_cap + 1), dtype=torch.int64, device=pid_o.device)
    cnt.scatter_add_(1, pid_o, torch.ones_like(pid_o))
    q_ok = pid_q >= 0
    shared = (cnt[:, torch.where(q_ok, pid_q, torch.full_like(pid_q, p_cap))] * q_ok).sum(dim=1)
    recency = torch.abs(kfs.frame_id - kfs.frame_id[slot])
    eligible = (kfs.valid & (torch.arange(f_cap, device=votes.device) != slot)
                & (shared < cfg.mapping.min_shared_points)
                & (recency > min_gap * cfg.tracking.keyframe_period))
    votes = torch.where(eligible, votes, torch.full_like(votes, -1))
    best = first_argmax(votes)
    return LoopCandidate(found=votes[best] >= min_votes, kf=best, votes=votes[best],
                         match_idx=idx[:, best])


class Sim3Estimate(NamedTuple):
    ok: torch.Tensor  # () bool
    s: torch.Tensor  # () scale, candidate camera -> current camera
    R: torch.Tensor  # (3, 3)
    t: torch.Tensor  # (3,)
    n_inliers: torch.Tensor  # ()


def compute_sim3(kfs: KeyframeStore, points: PointStore, slot: int, cand: int,
                 match_idx: torch.Tensor, K_cam: torch.Tensor, cfg: Config,
                 min_inliers: int = 20) -> Sim3Estimate:
    """The relative Sim(3) S_cur_cand from 3D-3D pairs: each descriptor
    match whose keypoints are both bound to map points is one physical
    point in both camera frames (LoopClosing.cc:263-281).  Closed-form Horn
    start, then the robust bidirectional-reprojection refinement."""
    k_cap = kfs.point_id.shape[1]
    p_cap = points.capacity
    j = torch.clamp(match_idx, 0, k_cap - 1)
    pid1 = kfs.point_id[slot]
    pid2 = kfs.point_id[cand][j]
    c1, c2 = torch.clamp(pid1, 0, p_cap - 1), torch.clamp(pid2, 0, p_cap - 1)
    ok = (match_idx >= 0) & (pid1 >= 0) & (pid2 >= 0) & points.valid[c1] & points.valid[c2]
    x1 = se3.transform(kfs.pose[slot], points.xyz[c1])  # in the current camera
    x2 = se3.transform(kfs.pose[cand], points.xyz[c2])  # in the candidate camera
    s0, R0, t0 = se3.horn_alignment(x2, x1, ok.to(torch.float32))  # cand cam -> cur cam
    sf = cfg.orb.scale_factor

    def inv_sigma2(lv):
        lv = lv.to(torch.float32)
        return 1.0 / torch.pow(torch.full_like(lv, sf), 2.0 * lv)

    res = ba.optimize_sim3(
        K_cam, s0, R0, t0, xyz1=x1, xyz2=x2, uv1=kfs.xy[slot], uv2=kfs.xy[cand][j],
        inv_sigma2_1=inv_sigma2(kfs.level[slot]), inv_sigma2_2=inv_sigma2(kfs.level[cand][j]),
        mask=ok,
    )
    return Sim3Estimate(ok=res.n_inliers >= min_inliers, s=res.s, R=res.R, t=res.t,
                        n_inliers=res.n_inliers)


class LoopCorrection(NamedTuple):
    poses: torch.Tensor  # (F, 4, 4) corrected keyframe poses
    xyz: torch.Tensor  # (P, 3) corrected map points


def correct_loop(kfs: KeyframeStore, points: PointStore, slot: int, cand: int,
                 sim3: Sim3Estimate) -> LoopCorrection:
    """Essential-graph correction of every keyframe pose and map point.
    Edges: the odometry chain between consecutive keyframes in frame
    order, covisibility edges between non-consecutive pairs sharing >= 100
    observations (Optimizer.cc:860-896), and the loop edge slot <-> cand
    with the measured Sim(3).  The candidate is held fixed; the current
    keyframe starts at the loop-implied pose.  Points move with their
    reference keyframe: X' = S_new^-1(S_old(X)) (LoopClosing.cc:480-520)."""
    f_cap = kfs.pose.shape[0]
    dev = kfs.pose.device
    s_w, R_w, t_w = ba.sim3_from_se3(kfs.pose)

    order = torch.argsort(torch.where(kfs.valid, kfs.frame_id, torch.full_like(kfs.frame_id, _INT32_MAX)),
                          stable=True)
    n_valid = kfs.valid.sum()
    seq_mask = torch.arange(1, f_cap, device=dev) < n_valid
    # covisibility edges (consecutive pairs are the chain's)
    p_cap = points.capacity
    pid = torch.where(kfs.kp_valid & (kfs.point_id >= 0) & kfs.valid[:, None], kfs.point_id,
                      torch.full_like(kfs.point_id, p_cap))
    occ = torch.zeros((f_cap, p_cap + 1), dtype=torch.float32, device=dev)
    occ.scatter_(1, pid, 1.0)
    occ = occ[:, :p_cap] * points.valid[None, :].to(torch.float32)
    shared = occ @ occ.T  # (F, F) shared-observation counts, exact integers
    pos = torch.empty_like(order)
    pos[order] = torch.arange(f_cap, device=dev)
    iu, ju = torch.triu_indices(f_cap, f_cap, offset=1, device=dev)
    consec = torch.abs(pos[iu] - pos[ju]) == 1
    # the slot <-> cand pair takes the MEASURED loop edge; a covisibility
    # edge there would carry the drifted relative pose
    lo, hi = min(slot, cand), max(slot, cand)
    excl = consec | ((iu == lo) & (ju == hi))
    counts = torch.where(excl, torch.zeros_like(shared[iu, ju]), shared[iu, ju])
    top_c, top_idx = stable_topk(counts, min(3 * f_cap, iu.shape[0]))
    one = torch.ones(1, dtype=torch.int64, device=dev)
    edge_i = torch.cat([order[:-1], iu[top_idx], cand * one])
    edge_j = torch.cat([order[1:], ju[top_idx], slot * one])
    edge_mask = torch.cat([seq_mask, top_c >= 100.0, one.to(torch.bool)])
    graph = ba.build_edges_from_poses(edge_i, edge_j, s_w, R_w, t_w, edge_mask,
                                      fixed=torch.arange(f_cap, device=dev) == cand)
    graph = graph._replace(
        meas_s=torch.cat([graph.meas_s[:-1], sim3.s.reshape(1)]),
        meas_R=torch.cat([graph.meas_R[:-1], sim3.R[None]]),
        meas_t=torch.cat([graph.meas_t[:-1], sim3.t[None]]),
    )
    # the current keyframe starts at S_slot_cand o S_cand_w
    sc, Rc, tc = ba._sim3_compose(sim3.s.reshape(1), sim3.R[None], sim3.t[None],
                                  s_w[cand:cand + 1], R_w[cand:cand + 1], t_w[cand:cand + 1])
    at = (torch.arange(f_cap, device=dev) == slot)
    s0 = torch.where(at, sc, s_w)
    R0 = torch.where(at[:, None, None], Rc, R_w)
    t0 = torch.where(at[:, None], tc, t_w)
    s_new, R_new, t_new = ba.optimize_essential_graph(graph, s0, R0, t0)
    poses_new = ba.se3_from_sim3(s_new, R_new, t_new)

    # map points through their reference keyframe
    ref = torch.clamp(points.ref_kf, 0, f_cap - 1)
    x_cam = s_w[ref][:, None] * torch.einsum("pij,pj->pi", R_w[ref], points.xyz) + t_w[ref]
    si, Ri, ti = ba._sim3_inverse(s_new[ref], R_new[ref], t_new[ref])
    xyz_new = si[:, None] * torch.einsum("pij,pj->pi", Ri, x_cam) + ti
    movable = points.valid & (points.ref_kf >= 0)
    return LoopCorrection(poses=poses_new, xyz=torch.where(movable[:, None], xyz_new, points.xyz))


def close_loop(kfs: KeyframeStore, points: PointStore, slot: int, K_cam: torch.Tensor,
               cfg: Config, min_votes: int = 40):
    """LoopClosing::Run for one new keyframe.  Returns (closed, kfs,
    points, cand_slot): the stores change only when a loop was detected,
    Sim(3)-verified and corrected; ``cand_slot`` (-1 if not closed) feeds
    :func:`fuse_and_global_ba`."""
    cand = detect_loop(kfs, slot, cfg, min_votes=min_votes)
    if not bool(cand.found):
        return False, kfs, points, -1
    c = int(cand.kf)
    est = compute_sim3(kfs, points, slot, c, cand.match_idx, K_cam, cfg)
    if not bool(est.ok):
        return False, kfs, points, -1
    corr = correct_loop(kfs, points, slot, c, est)
    kfs = kfs._replace(pose=corr.poses)
    points = points._replace(xyz=corr.xyz)
    # the loop-side point replaces its current-side duplicate through the
    # verified descriptor matches, ungated by any window
    # (LoopClosing.cc:462-478)
    kfs, points, _ = replace_loop_matches(kfs, points, slot, c, cand.match_idx)
    return True, kfs, points, c


def _resolve_chains(src, dst):
    """Forward every merge destination through the src -> dst map until it
    is not itself a retired source (MapPoint::Replace's mpReplaced
    chains); pairs whose chain cycles back are dropped.  Returns (src,
    dst) int64 arrays."""
    fwd = {int(s): int(d) for s, d in zip(src, dst)}
    out_s, out_d = [], []
    for s, d in fwd.items():
        seen = {s}
        while d in fwd and d not in seen:
            seen.add(d)
            d = fwd[d]
        if d in seen:
            continue  # a cycle
        out_s.append(s)
        out_d.append(d)
    return np.asarray(out_s, np.int64), np.asarray(out_d, np.int64)


def _merge(kfs: KeyframeStore, points: PointStore, pid_all: np.ndarray, nobs: np.ndarray,
           pvalid: np.ndarray, src: np.ndarray, dst: np.ndarray):
    """Apply merges src -> dst to every table, move the observation counts
    and retire the sources; returns the new stores."""
    dev = kfs.point_id.device
    table = torch.as_tensor(pid_all, device=dev)
    if len(src):
        table = tri.apply_replacements(table, torch.as_tensor(src, device=dev),
                                       torch.as_tensor(dst, device=dev), points.capacity)
        for s, d in zip(src, dst):
            nobs[d] += nobs[s]
            pvalid[s] = False
    kfs = kfs._replace(point_id=table)
    points = points._replace(n_obs=torch.as_tensor(nobs, device=dev),
                             valid=torch.as_tensor(pvalid, device=dev))
    return kfs, points


def replace_loop_matches(kfs: KeyframeStore, points: PointStore, slot: int, cand: int,
                         match_idx: torch.Tensor):
    """Merge the point pairs bound to matched keypoints of the two loop
    keyframes: the loop-side point replaces the current-side duplicate
    (LoopClosing.cc:467-477).  Returns (kfs, points, n_replaced)."""
    k_cap = kfs.point_id.shape[1]
    mi = match_idx.cpu().numpy()
    pid_all = kfs.point_id.cpu().numpy()
    pid1 = pid_all[slot]
    pid2 = pid_all[cand][np.clip(mi, 0, k_cap - 1)]
    pvalid = points.valid.cpu().numpy().copy()
    cap = points.capacity
    ok = ((mi >= 0) & (pid1 >= 0) & (pid2 >= 0) & (pid1 != pid2)
          & pvalid[np.clip(pid1, 0, cap - 1)] & pvalid[np.clip(pid2, 0, cap - 1)])
    if not ok.any():
        return kfs, points, 0
    dst_of = {}
    for a, b in zip(pid1[ok], pid2[ok]):
        dst_of.setdefault(int(a), int(b))  # the first match of each source
    src, dst = _resolve_chains(list(dst_of.keys()), list(dst_of.values()))
    if len(src) == 0:
        return kfs, points, 0
    kfs, points = _merge(kfs, points, pid_all, points.n_obs.cpu().numpy().copy(), pvalid, src, dst)
    return kfs, points, len(src)


def fuse_points_into(kfs: KeyframeStore, points: PointStore, s_tgt: int, K_cam: torch.Tensor,
                     sig2: torch.Tensor, cfg: Config, radius: float = 3.0):
    """Project every valid map point into keyframe ``s_tgt`` and merge the
    duplicates (``ORBmatcher::Fuse`` + ``MapPoint::Replace``; a superset of
    SearchAndFuse's loop-neighbourhood points with the same effect: the
    window and chi2 gate keep the others out).  Returns (kfs, points,
    n_merged)."""
    fr = tri.fuse_into_keyframe(
        points.xyz, points.desc, points.valid, kfs.pose[s_tgt], K_cam,
        kfs.xy[s_tgt], kfs.desc[s_tgt], kfs.kp_valid[s_tgt], kfs.level[s_tgt], kfs.point_id[s_tgt],
        sig2, cfg.camera.width, cfg.camera.height, radius=radius,
    )
    kp = fr.kp_idx.cpu().numpy()
    existing = fr.existing_pid.cpu().numpy()
    nobs = points.n_obs.cpu().numpy().copy()
    pvalid = points.valid.cpu().numpy().copy()
    pid_all = kfs.point_id.cpu().numpy().copy()
    pid_t = pid_all[s_tgt]
    src_list, dst_list = [], []
    for p in np.nonzero((kp >= 0) & pvalid)[0]:
        e = existing[p]
        if e < 0:
            pid_t[kp[p]] = p  # a new observation at a free keypoint
            nobs[p] += 1
        elif e != p:
            # a duplicate: the more-observed point stays (ORBmatcher.cc:~1000)
            if nobs[e] >= nobs[p]:
                src_list.append(p)
                dst_list.append(e)
            else:
                src_list.append(e)
                dst_list.append(p)
    src, dst = _resolve_chains(src_list, dst_list)
    kfs, points = _merge(kfs, points, pid_all, nobs, pvalid, src, dst)
    return kfs, points, len(src)


def global_ba(kfs: KeyframeStore, points: PointStore, K_cam: torch.Tensor, sig2: torch.Tensor,
              iters: int = 10):
    """Bundle adjustment of every stored keyframe and point
    (``Optimizer::GlobalBundleAdjustemnt`` from RunGlobalBundleAdjustment,
    LoopClosing.cc:630-741); keyframe 0 fixes the gauge.  Observations that
    fail the chi2 gate leave the kp->point tables.  Returns (kfs, points,
    n_inliers)."""
    lv = torch.clamp(kfs.level, 0, sig2.shape[0] - 1)
    # observations of retired points contribute no residual
    pt_ok = points.valid[torch.clamp(kfs.point_id, 0, points.capacity - 1)]
    problem = ba.BAProblem(
        poses=kfs.pose, xyz=points.xyz, pid=kfs.point_id, uv=kfs.xy, inv_sigma2=1.0 / sig2[lv],
        obs_mask=kfs.kp_valid & kfs.valid[:, None] & pt_ok,
        cam_free=kfs.valid & (torch.arange(kfs.pose.shape[0], device=lv.device) != 0),
        point_free=points.valid,
    )
    res = ba.ba_solve(problem, K_cam, iters_first=iters, iters_second=iters)
    pid = torch.where((kfs.point_id >= 0) & ~res.inlier, torch.full_like(kfs.point_id, -1),
                      kfs.point_id)
    return (kfs._replace(pose=res.poses, point_id=pid), points._replace(xyz=res.xyz),
            int(res.n_inliers))


def fuse_and_global_ba(kfs: KeyframeStore, points: PointStore, slot: int, cand: int,
                       K_cam: torch.Tensor, sig2: torch.Tensor, cfg: Config):
    """CorrectLoop's completion (LoopClosing.cc:496-741): SearchAndFuse of
    the map into both loop keyframes under the corrected poses (the wider
    window th = 4), then a global bundle adjustment.  Returns (kfs,
    points, n_merged)."""
    total = 0
    for tgt in (slot, cand):
        kfs, points, n = fuse_points_into(kfs, points, tgt, K_cam, sig2, cfg, radius=4.0)
        total += n
    kfs, points, _ = global_ba(kfs, points, K_cam, sig2)
    return kfs, points, total
