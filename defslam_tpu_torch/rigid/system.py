"""Rigid ORB-SLAM2 comparison mode: the reference's ``#ifdef ORBSLAM``
build (``Modules/Settings/set_MAC.h:24-25``, ``Modules/Common/System.cc:
24-38,103-157``), the same input plumbing with stock rigid SLAM in place
of the deformable layer.

Port of ``defslam_tpu/rigid/system.py``.  :class:`RigidSystem` is a host
state machine over the batched device steps:

- two-view H/F RANSAC initialization (``rigid.initializer``;
  Tracking::MonocularInitialization);
- motion-model projection tracking (all map points against the frame in
  one launch of kernel B1) and the pose-only LM
  (``tracking.pose_opt.solve_pose``), relocalization on failure
  (``tracking.pose_opt.relocalize``);
- epipolar triangulation and fusion (``rigid.triangulation``);
- the Schur-complement local BA (``rigid.ba``);
- found-ratio point culling and redundancy keyframe culling
  (``rigid.culling``);
- loop closing (``rigid.loop_closing``).

The stores are the deformable system's SoA arrays (``mapstore.state``),
point and frame ids as int64.  The bookkeeping between the steps
(slot allocation, triangulated points, culling, covisibility order) is
host code over numpy copies, as in the JAX package.

The RANSAC's sample sets: the JAX package passes ``PRNGKey(cfg.seed)`` on
every initialization attempt; here each attempt takes (200, 8) uniforms
from a CPU ``torch.Generator`` seeded with ``cfg.seed`` afresh
(:func:`ransac_uniforms`), uploads them, and draws the sets on the device
(``initializer.draw_sets``), so the card and the CPU draw the same sets.

``RigidSystem(cfg)`` runs on CUDA and raises without a card; pass
``device="cpu"`` for the CPU.  TF32 stays off (importing
``defslam_tpu_torch.system`` turns it off): the BA's contractions run in
full float32, as the reference's do.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from defslam_tpu_torch import profiling
from defslam_tpu_torch.config import Config
from defslam_tpu_torch.frontend import Features, extract_features
from defslam_tpu_torch.geometry import camera as cam
from defslam_tpu_torch.geometry import se3
from defslam_tpu_torch.mapstore import state as store
from defslam_tpu_torch.ops import matching
from defslam_tpu_torch.rigid import ba, culling, initializer, loop_closing
from defslam_tpu_torch.rigid import triangulation as tri
from defslam_tpu_torch.system import resolve_device
from defslam_tpu_torch.tracking import pose_opt


class RigidState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


def ransac_uniforms(seed: int) -> torch.Tensor:
    """The (200, 8) float32 uniforms of one initialization attempt, on the
    CPU, the same for every attempt (the JAX package's fixed key)."""
    g = torch.Generator().manual_seed(seed)
    return torch.rand((initializer.RANSAC_ITERS, 8), generator=g, dtype=torch.float32)


def match_points_rigid(points, pose, K, feats: Features, cfg: Config, window: float = 15.0):
    """Projection search of ALL valid map points against the frame
    (ORBmatcher::SearchByProjection(Frame, ...), ORBmatcher.cc:42-166; no
    template gate).  B1 at (P, K).  Returns (kp_of_point (P,), n_matches
    (), visible (P,))."""
    with profiling.stage("rigid.match"):
        pc = se3.transform(pose, points.xyz)
        uv = cam.project(K, pc)
        ok_p = points.valid & (pc[..., 2] > 1e-6) & cam.in_image(uv, cfg.camera.width, cfg.camera.height)
        lv = feats.level.to(torch.float32)
        scale = torch.pow(torch.full_like(lv, cfg.orb.scale_factor), lv)
        inside = torch.abs(uv[:, None, :] - feats.xy[None, :, :]).max(dim=-1).values <= window * scale[None, :]
        dist = matching.masked_hamming(points.desc, feats.desc, ok_p, feats.valid, pair_mask=inside)
        m = matching.best_match(dist, max_dist=cfg.tracking.match_th_high,
                                nn_ratio=cfg.tracking.nn_ratio, mutual=True)
        m = matching.rotation_consistency(points.angle, feats.angle, m)
        return m.idx, (m.idx >= 0).sum(), ok_p


def match_for_init(f1: Features, f2: Features, cfg: Config, radius: float = 100.0):
    """SearchForInitialization (ORBmatcher.cc:418-536): windowed descriptor
    match of the two initialization frames with the ratio and rotation
    checks.  B1 at (K, K)."""
    inside = matching.window_mask(f1.xy, f2.xy, radius)
    d = matching.masked_hamming(f1.desc, f2.desc, f1.valid, f2.valid, pair_mask=inside)
    m = matching.best_match(d, max_dist=cfg.tracking.match_th_low, nn_ratio=0.9, mutual=True)
    return matching.rotation_consistency(f1.angle, f2.angle, m).idx


class RigidSystem:
    """Monocular rigid SLAM (the reference's ORB-SLAM2 A/B baseline)."""

    def __init__(self, cfg: Config | None = None, device=None):
        self.cfg = cfg or Config()
        self.device = resolve_device(device)
        self.K = torch.as_tensor(self.cfg.camera.K, device=self.device)
        self.sig2 = tri.level_sigma2(self.cfg.orb.n_levels, self.cfg.orb.scale_factor, self.device)
        self.reset()

    # ----------------------------------------------------------- lifecycle

    def reset(self):
        c = self.cfg
        self.kfs = store.empty_keyframes(c, self.device)
        self.points = store.empty_points(c, self.device)
        self.pose = torch.eye(4, device=self.device)
        self.velocity = torch.eye(4, device=self.device)
        self.state = RigidState.NO_IMAGES_YET
        self.frame_id = -1
        self.frames_since_kf = 0
        self.trajectory: list[tuple[float, np.ndarray]] = []
        self._init_feats: Features | None = None
        # found-ratio statistics (MapPoint::IncreaseVisible / IncreaseFound)
        p = c.capacity.max_map_points
        self._visible = np.zeros(p, np.int32)
        self._found = np.zeros(p, np.int32)
        self._born_kf = np.full(p, -1, np.int32)  # keyframe count at creation
        self._n_kf_inserted = 0
        self.loops_closed = 0

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # ------------------------------------------------------------ tracking

    def track_monocular(self, img, timestamp: float = 0.0):
        """Process one grey frame (numpy or tensor); returns the world ->
        camera pose (4x4 numpy) or None while not initialized or lost."""
        self.frame_id += 1
        with profiling.stage("rigid.frame", frame=self.frame_id):
            if not torch.is_tensor(img):
                img = torch.from_numpy(np.ascontiguousarray(img))
            img = img.to(self.device)
            if img.ndim == 3:
                img = img.float().mean(dim=-1)
            feats = extract_features(img, self.cfg)
            if self.state in (RigidState.NO_IMAGES_YET, RigidState.NOT_INITIALIZED):
                ok = self._try_initialize(feats)
                self.state = RigidState.OK if ok else RigidState.NOT_INITIALIZED
                if ok:
                    pose = self.pose.cpu().numpy()
                    self.trajectory.append((timestamp, pose))
                    return pose
                return None
            return self._track(feats, timestamp)

    def _try_initialize(self, feats: Features) -> bool:
        c = self.cfg
        if int(feats.valid.sum()) < 100:  # the reference needs > 100 keypoints
            self._init_feats = None
            return False
        if self._init_feats is None:
            self._init_feats = feats
            return False
        f1 = self._init_feats
        idx = match_for_init(f1, feats, c)
        mask = idx >= 0
        if int(mask.sum()) < 100:
            self._init_feats = feats  # the reference replaces the init frame
            return False
        j = torch.clamp(idx, 0, feats.capacity - 1)
        sets = initializer.draw_sets(mask, ransac_uniforms(c.seed).to(self.device))
        res = initializer.two_view_init(f1.xy, feats.xy[j], mask, self.K, sets)
        if not bool(res.ok):
            return False
        good = (res.good & mask).cpu().numpy()
        xyz = res.xyz.cpu().numpy()
        # median-depth normalization (CreateInitialMapMonocular)
        med = float(np.median(xyz[good, 2])) if good.any() else 1.0
        if med <= 1e-6:
            return False
        xyz = xyz / med
        T1 = np.eye(4, dtype=np.float32)
        T1[:3, :3] = res.R.cpu().numpy()
        T1[:3, 3] = res.t.cpu().numpy() / med

        p_cap = c.capacity.max_map_points
        kp1 = np.nonzero(good)[0][:p_cap]
        n = len(kp1)
        if n < 50:
            return False
        kp2 = j.cpu().numpy()[kp1]
        xyz_arr = np.zeros((p_cap, 3), np.float32)
        xyz_arr[:n] = xyz[kp1]
        valid = np.zeros(p_cap, bool)
        valid[:n] = True
        desc_arr = np.zeros((p_cap, 8), np.int32)
        desc_arr[:n] = feats.desc.cpu().numpy()[kp2]
        ang_arr = np.zeros(p_cap, np.float32)
        ang_arr[:n] = feats.angle.cpu().numpy()[kp2]
        self.points = store.empty_points(c, self.device)._replace(
            xyz=self._put(xyz_arr), desc=self._put(desc_arr), angle=self._put(ang_arr),
            ref_kf=self._put(np.where(valid, 1, -1).astype(np.int64)),
            ref_kp=self._put(np.concatenate([kp2, -np.ones(p_cap - n)]).astype(np.int64)),
            valid=self._put(valid), n_obs=self._put(valid.astype(np.int32) * 2),
        )
        k_cap = feats.capacity
        pid1 = np.full(k_cap, -1, np.int64)
        pid1[kp1] = np.arange(n)
        pid2 = np.full(k_cap, -1, np.int64)
        pid2[kp2] = np.arange(n)
        kfs = store.empty_keyframes(c, self.device)
        store.add_keyframe(kfs, 0, torch.eye(4, device=self.device), f1,
                           cam.to_retina(self.K, f1.xy), self._put(pid1), self.frame_id - 1)
        store.add_keyframe(kfs, 1, self._put(T1), feats, cam.to_retina(self.K, feats.xy),
                           self._put(pid2), self.frame_id)
        self.kfs = kfs
        self._n_kf_inserted = 2
        self._born_kf[:n] = 0
        self._visible[:n] = 2
        self._found[:n] = 2
        # global BA of the initial map (Tracking.cc: GlobalBundleAdjustemnt
        # right after initialization), the first camera fixed
        self._local_ba()
        self.pose = self.kfs.pose[1].clone()
        self.velocity = torch.eye(4, device=self.device)
        self.frames_since_kf = 0
        self._init_feats = None
        return True

    def _track(self, feats: Features, timestamp: float):
        c = self.cfg
        pred = self.velocity @ self.pose
        idx, n_m, visible = match_points_rigid(self.points, pred, self.K, feats, c)
        if int(n_m) < 20:  # the wider window (Tracking.cc:1040-1052)
            idx, n_m, visible = match_points_rigid(self.points, pred, self.K, feats, c, window=30.0)
        res = self._pose_solve(pred, idx, feats)
        if int(res.n_inliers) < c.tracking.min_inliers_ok:
            ok_r, T_r, _ = pose_opt.relocalize(feats, self.kfs, self.points, self.K, c)
            if bool(ok_r):
                idx, n_m, visible = match_points_rigid(self.points, T_r, self.K, feats, c, window=30.0)
                res = self._pose_solve(T_r, idx, feats)
            if int(res.n_inliers) < c.tracking.min_inliers_ok:
                self.state = RigidState.LOST
                return None
        prev = self.pose
        # back onto SE(3) before the motion model composes it: the
        # transpose-inverse turns float32 drift off SO(3) into x2.4 a frame
        # (the JAX package's rigid mode lacks this; its tracker has it)
        self.pose = se3.orthonormalize(res.T)
        self.velocity = self.pose @ se3.inverse(prev)
        self.state = RigidState.OK
        pose = self.pose.cpu().numpy()
        self.trajectory.append((timestamp, pose))

        self._visible += visible.cpu().numpy()
        self._found += ((idx >= 0) & res.inlier).cpu().numpy()

        self.frames_since_kf += 1
        if (self.frames_since_kf >= c.tracking.keyframe_period
                and int(res.n_inliers) >= c.tracking.min_inliers_ok):
            self._insert_keyframe(feats, idx, res.inlier)
            self.frames_since_kf = 0
        return pose

    def _pose_solve(self, T0, idx, feats: Features):
        c = self.cfg
        with profiling.stage("rigid.pose"):
            kp = torch.clamp(idx, 0, feats.capacity - 1)
            lv = feats.level[kp].to(torch.float32)
            inv_sigma2 = 1.0 / torch.pow(torch.full_like(lv, c.orb.scale_factor), 2.0 * lv)
            mask = (idx >= 0) & self.points.valid
            return pose_opt.solve_pose(self.K, T0, self.points.xyz, feats.xy[kp], inv_sigma2, mask, c)

    # ------------------------------------------------------------- mapping

    def _free_kf_slot(self) -> int:
        valid = self.kfs.valid.cpu().numpy()
        free = np.nonzero(~valid)[0]
        if len(free):
            return int(free[0])
        fid = self.kfs.frame_id.cpu().numpy().copy()
        fid[:2] = np.iinfo(np.int64).max  # never recycle the initial pair
        return int(np.argmin(fid))

    def _covis_order(self, slot: int) -> list[int]:
        """Keyframes by points shared with ``slot``, most first (the
        covisible neighbours of triangulation and fusion)."""
        pid = self.kfs.point_id.cpu().numpy()
        me = pid[slot]
        out = []
        for i in np.nonzero(self.kfs.valid.cpu().numpy())[0]:
            if i == slot:
                continue
            shared = len(np.intersect1d(me[me >= 0], pid[i][pid[i] >= 0]))
            if shared >= 10:
                out.append((shared, int(i)))
        out.sort(reverse=True)
        return [i for _, i in out]

    def _insert_keyframe(self, feats: Features, idx, inlier):
        c = self.cfg
        with profiling.stage("rigid.keyframe"):
            slot = self._free_kf_slot()
            self.kfs, n_obs = store.insert_keyframe_from_matches(
                self.kfs, self.points.n_obs, slot, self.pose, feats, idx, inlier, self.K,
                self.frame_id, self.points.xyz,
            )
            self.points = self.points._replace(n_obs=n_obs)
            self._n_kf_inserted += 1

            neighbors = self._covis_order(slot)[:3]
            for nb in neighbors:
                self._triangulate_pair(slot, nb)
            for nb in neighbors[:2]:
                self._fuse_pair(slot, nb)
            self._cull_points()
            self._local_ba()
            self._cull_keyframe(slot)
            closed, kfs2, pts2, cand = loop_closing.close_loop(self.kfs, self.points, slot, self.K, c)
            if closed:
                # CorrectLoop's completion (LoopClosing.cc:496-741): fuse the
                # loop-side duplicates under the corrected poses, global BA
                self.kfs, self.points, _ = loop_closing.fuse_and_global_ba(
                    kfs2, pts2, slot, cand, self.K, self.sig2, c)
                self.pose = self.kfs.pose[slot].clone()
                self.velocity = torch.eye(4, device=self.device)
                self.loops_closed += 1

    def _triangulate_pair(self, s1: int, s2: int):
        """CreateNewMapPoints for one keyframe pair."""
        kfs = self.kfs
        F12 = tri.fundamental_from_poses(kfs.pose[s1], kfs.pose[s2], self.K)
        m = tri.search_for_triangulation(
            kfs.xy[s1], kfs.desc[s1], kfs.kp_valid[s1], kfs.angle[s1], kfs.point_id[s1],
            kfs.xy[s2], kfs.desc[s2], kfs.kp_valid[s2], kfs.angle[s2], kfs.point_id[s2],
            kfs.level[s2], F12, self.sig2,
        )
        t = tri.triangulate_matches(kfs.pose[s1], kfs.pose[s2], self.K, kfs.xy[s1], kfs.level[s1],
                                    kfs.xy[s2], kfs.level[s2], m.idx2, self.sig2,
                                    self.cfg.orb.scale_factor)
        ok = t.ok.cpu().numpy()
        if not ok.any():
            return
        pts = self.points
        pvalid = pts.valid.cpu().numpy().copy()
        free = np.nonzero(~pvalid)[0]
        kp1 = np.nonzero(ok)[0][:len(free)]
        if len(kp1) == 0:
            return
        dst = free[:len(kp1)]
        kp2 = m.idx2.cpu().numpy()[kp1]
        xyz = pts.xyz.cpu().numpy().copy()
        desc = pts.desc.cpu().numpy().copy()
        ang = pts.angle.cpu().numpy().copy()
        refk = pts.ref_kf.cpu().numpy().copy()
        refp = pts.ref_kp.cpu().numpy().copy()
        nobs = pts.n_obs.cpu().numpy().copy()
        xyz[dst] = t.xyz.cpu().numpy()[kp1]
        desc[dst] = kfs.desc[s1].cpu().numpy()[kp1]
        ang[dst] = kfs.angle[s1].cpu().numpy()[kp1]
        refk[dst] = s1
        refp[dst] = kp1
        nobs[dst] = 2
        pvalid[dst] = True
        self.points = pts._replace(
            xyz=self._put(xyz), desc=self._put(desc), angle=self._put(ang),
            ref_kf=self._put(refk), ref_kp=self._put(refp), valid=self._put(pvalid),
            n_obs=self._put(nobs),
        )
        pid = kfs.point_id.cpu().numpy().copy()
        pid[s1, kp1] = dst
        pid[s2, kp2] = dst
        self.kfs = kfs._replace(point_id=self._put(pid))
        self._born_kf[dst] = self._n_kf_inserted
        self._visible[dst] = 2
        self._found[dst] = 2

    def _fuse_pair(self, s_src: int, s_tgt: int):
        """Project the map points into ``s_tgt`` and merge duplicates
        (ORBmatcher::Fuse + MapPoint::Replace): the loop closer's pass."""
        self.kfs, self.points, _ = loop_closing.fuse_points_into(
            self.kfs, self.points, s_tgt, self.K, self.sig2, self.cfg)

    def _cull_points(self):
        """Found-ratio MapPoint culling (LocalMapping.cc:173-199): recent
        points rarely re-found or under-observed go."""
        pvalid = self.points.valid.cpu().numpy().copy()
        nobs = self.points.n_obs.cpu().numpy()
        age = self._n_kf_inserted - self._born_kf
        ratio = self._found / np.maximum(self._visible, 1)
        bad = pvalid & (self._born_kf >= 0) & (
            (ratio < 0.25) | ((age >= 2) & (age <= 3) & (nobs < 3))
        ) & (age <= 3)
        if bad.any():
            pvalid[bad] = False
            pid = self.kfs.point_id.cpu().numpy().copy()
            pid[np.isin(pid, np.nonzero(bad)[0])] = -1
            self.kfs = self.kfs._replace(point_id=self._put(pid))
            self.points = self.points._replace(valid=self._put(pvalid))

    def _cull_keyframe(self, current: int):
        """Redundancy KeyFrame culling (LocalMapping.cc:645-725)."""
        ratios = culling.redundancy_ratios(self.kfs.point_id, self.kfs.level, self.kfs.kp_valid,
                                           self.kfs.valid, self.points.valid)
        protect = np.zeros(self.kfs.capacity, bool)
        protect[[0, 1, current]] = True
        pick = int(culling.pick_cull(ratios, self._put(protect)))
        if pick >= 0:
            valid = self.kfs.valid.clone()
            valid[pick] = False
            self.kfs = self.kfs._replace(valid=valid)

    def _local_ba(self):
        """LocalBundleAdjustment over every stored keyframe (at this
        capacity the local window is the whole map; 5 iterations, chi2
        gate, 10 more, prune), keyframe 0 fixing the gauge."""
        kfs = self.kfs
        with profiling.stage("rigid.local_ba"):
            lv = torch.clamp(kfs.level, 0, self.sig2.shape[0] - 1)
            problem = ba.BAProblem(
                poses=kfs.pose, xyz=self.points.xyz, pid=kfs.point_id, uv=kfs.xy,
                inv_sigma2=1.0 / self.sig2[lv], obs_mask=kfs.kp_valid & kfs.valid[:, None],
                cam_free=kfs.valid & (torch.arange(kfs.capacity, device=self.device) != 0),
                point_free=self.points.valid,
            )
            res = ba.ba_solve(problem, self.K)
            # erase the observations that failed the chi2 gate (Optimizer.cc:720-760)
            pid = torch.where((kfs.point_id >= 0) & ~res.inlier, torch.full_like(kfs.point_id, -1),
                              kfs.point_id)
            self.kfs = kfs._replace(pose=res.poses, point_id=pid)
            self.points = self.points._replace(xyz=res.xyz)

    # ------------------------------------------------------------- outputs

    def write_trajectory(self, path: str):
        with open(path, "w") as f:
            for ts, T in self.trajectory:
                f.write(f"{ts:.6f} " + " ".join(f"{x:.8f}" for x in T.reshape(-1)) + "\n")
