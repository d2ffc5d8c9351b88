"""The reference's layer steps, on the frozen copy (``frozen``): each takes
the inputs a step of the program was given, as plain tensors, and works
the step out again with the reference's own constants (camera matrix,
retina domain, bending matrices, level variances), built from the cell's
configuration file.

A :class:`Reference` computes in one floating-point type: float32, the
configuration's, for the steps compared exactly (the frontend, the
matcher, the initialization), and float64 for the judge of the solvers
(the SfT, the keyframe step, the rigid pose LM and BA), whose float32
answers depend on the order of their sums.  The frozen modules make every
floating-point tensor in torch's default type, which the reference sets
around each step; the program's inputs are cast to it.

Besides the frozen modules' entry points this holds plain copies of the
steps that live in the program's orchestrators: the plane-at-z=1
initialization (``System._initialize``), the rigid pose solve's inputs
(``RigidSystem._pose_solve``) and the rigid local bundle adjustment
(``RigidSystem._local_ba``), the rigid projection search
(``rigid.system.match_points_rigid``), and the multi-device System's
host-orchestrated keyframe chain (``System._insert_keyframe_legacy``),
unsharded: its warp fits and normal solves are independent per pair and
per point, so one device solving all of them is the same semantics.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.frozen import config as rconfig
from portbench.reference.frozen import frontend
from portbench.reference.frozen.geometry import camera as cam
from portbench.reference.frozen.geometry import se3
from portbench.reference.frozen.mapping import mapper
from portbench.reference.frozen.mapstore import state as store
from portbench.reference.frozen.ops import bspline, matching
from portbench.reference.frozen.rigid import ba
from portbench.reference.frozen.template import mesh as meshmod
from portbench.reference.frozen.tracking import pose_opt, sft, tracker


def build(cls, values: dict):
    """A (nested) frozen dataclass from a dict of its fields."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in values:
            continue
        v = values[f.name]
        if dataclasses.is_dataclass(f.default_factory if callable(f.default_factory) else None):
            kwargs[f.name] = build(f.default_factory, v)
        else:
            kwargs[f.name] = v
    unknown = set(values) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise KeyError(f"{cls.__name__}: unknown keys {sorted(unknown)}")
    return cls(**kwargs)


def cast(obj, dtype):
    """``obj`` (a tensor, or a tuple of them, nested) with its floating-point
    tensors in ``dtype``."""
    if torch.is_tensor(obj):
        return obj.to(dtype) if obj.dtype.is_floating_point else obj
    if isinstance(obj, tuple):
        items = [cast(v, dtype) for v in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    return obj


@contextlib.contextmanager
def default_dtype(dtype):
    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


def in_dtype(step):
    """A step of :class:`Reference` run in its type: the inputs cast, and
    torch's default type set around it."""
    def run(self, *args, **kw):
        with default_dtype(self.dtype):
            return step(self, *cast(args, self.dtype),
                        **{k: cast(v, self.dtype) for k, v in kw.items()})
    run.__name__, run.__doc__ = step.__name__, step.__doc__
    return run


class Reference:
    """The configuration and constants of the reference on ``device``, in
    ``dtype``."""

    def __init__(self, config_values: dict, device, dtype=torch.float32):
        self.dtype = dtype
        with default_dtype(dtype):
            self._build(config_values, device)

    def _build(self, config_values: dict, device):
        self.cfg = build(rconfig.Config, config_values)
        self.device = torch.device(device)
        c = self.cfg
        self.K = torch.as_tensor(c.camera.K, device=self.device).to(self.dtype)
        self.dom = cam.retina_domain(self.K, c.camera.width, c.camera.height)
        self.topo = meshmod.grid_topology(c.mesh.nodes_u, c.mesh.nodes_v)
        self.bend_warp = mapper.bending_for(self.dom, c.mapping.warp_ctrl_u, c.mapping.warp_ctrl_v)
        self.bend_sfn = mapper.bending_for(self.dom, c.mapping.sfn_ctrl_u, c.mapping.sfn_ctrl_v)
        e = 2.0 * torch.arange(c.orb.n_levels, dtype=self.dtype, device=self.device)
        self.sig2 = torch.pow(torch.full_like(e, c.orb.scale_factor), e)

    # ------------------------------------------------------ plain types

    @staticmethod
    def features(t) -> frontend.Features:
        return frontend.Features(*t)

    @staticmethod
    def points(t) -> store.PointStore:
        return store.PointStore(*t)

    @staticmethod
    def keyframes(t) -> store.KeyframeStore:
        return store.KeyframeStore(*t)

    @staticmethod
    def template(t) -> meshmod.Template:
        return meshmod.Template(*t)

    @staticmethod
    def matches(t) -> tracker.FrameMatches:
        return tracker.FrameMatches(*t)

    # ------------------------------------------------------- the steps

    @in_dtype
    def extract(self, img):
        return frontend.extract_features(img, self.cfg)

    @in_dtype
    def predict(self, pose, prev_pose):
        return tracker.motion_model_prediction(pose, prev_pose)

    @in_dtype
    def match(self, points, pred, feats, window_scale: float):
        c = self.cfg
        return tracker.match_points_to_frame(
            self.points(points), pred, self.K, self.features(feats), c,
            window=window_scale * c.tracking.projection_window)

    @in_dtype
    def sft_judged(self, points, matches, feats, tmpl, pred):
        """The SfT's answer (``tracker.sft_track``'s) and the objective its
        polish minimizes, a function of (T, nodes) that gives a float."""
        c = self.cfg
        points = self.points(points)
        data, sel, sel_mask = tracker._sft_data_from_matches(
            points, self.matches(matches), self.features(feats), self.template(tmpl), pred,
            self.K, c)
        res, polish = sft.solve_stages(data, self.topo, c)

        def objective(T, nodes) -> float:
            with default_dtype(self.dtype):
                return float(sft.objective(T.to(self.dtype), nodes.to(self.dtype), polish,
                                           self.topo, c))
        return tracker._scatter_sft_result(res, sel, sel_mask, points.capacity, c), objective

    @in_dtype
    def keyframe_step(self, kfs, points, tmpl, pose, feats, kp_of_point, inlier, tmpl_ref_kf,
                      kf_counter, frame_id):
        return mapper.keyframe_step(
            self.keyframes(kfs), self.points(points), self.template(tmpl), pose,
            self.features(feats), kp_of_point, inlier, self.K, self.dom, self.bend_warp,
            self.bend_sfn, tmpl_ref_kf, kf_counter, frame_id, self.cfg)

    @in_dtype
    def keyframe_legacy(self, kfs, points, tmpl, pose, feats, kp_of_point, inlier, tmpl_ref_kf,
                        kf_counter, frame_id) -> "LegacyState":
        """The multi-device System's keyframe chain: CreateNewKeyFrame into
        the first free slot (else the oldest keyframe that is not the
        template's source), then warps -> densify -> normals -> the
        template decision -> (maybe) SfN, registration and re-template,
        new map points and culling with the counter after its increment.
        Writes ``kfs`` in place."""
        c = self.cfg
        kfs, points = self.keyframes(kfs), self.points(points)
        tmpl, feats = self.template(tmpl), self.features(feats)
        valid, fid = kfs.valid.cpu().numpy(), kfs.frame_id.cpu().numpy().copy()
        free = np.nonzero(~valid)[0]
        if len(free):
            slot = int(free[0])
        else:
            fid[tmpl_ref_kf] = 2**31 - 1
            slot = int(np.argmin(fid))
        kf_counter += 1
        kfs, n_obs = store.insert_keyframe_from_matches(
            kfs, points.n_obs, slot, pose, feats, kp_of_point, inlier, self.K, frame_id,
            points.xyz)
        points = points._replace(n_obs=n_obs)

        def state(updated=False):
            return LegacyState(kfs, points, tmpl, tmpl_ref_kf, kf_counter, updated)

        # warps over every covisible pair, on the full retina domain
        cp = mapper.covis_pairs(kfs.point_id, kfs.retina, kfs.valid, points.valid, slot, c)
        batch = mapper.WarpBatch(uv1=cp.uv1, uv2=cp.uv2, mask=cp.mask, pair_valid=cp.pair_valid)
        dps, ctrls = mapper.fit_warps(batch, self.dom, self.bend_warp, c)
        best, _ = mapper.densify_matches(
            ctrls, kfs.retina[slot], kfs.kp_valid[slot], kfs.desc[slot],
            kfs.retina[cp.pair_kf], kfs.kp_valid[cp.pair_kf], kfs.desc[cp.pair_kf],
            self.dom, cp.pair_valid, c)
        best = torch.where(cp.pair_valid[:, None], best, -1)
        point_id, n_obs = mapper.apply_densify(kfs.point_id, points.n_obs, slot, cp.pair_kf, best)
        kfs = kfs._replace(point_id=point_id)
        points = points._replace(n_obs=n_obs)

        # normals over every point, written into the keyframe and carried to
        # the covisible keyframes through the warp Jacobians
        p_cap = c.capacity.max_map_points
        obs, _ = mapper.accumulate_obs_device(cp.pid_table, dps.mask, cp.uv1, dps.warped,
                                              dps.J12, dps.Huu, dps.Hvv, p_cap, mapper.OBS_CAP)
        nres = mapper.solve_normals(obs, points.norm_k0, num_iters=c.mapping.normal_lm_iterations)
        solved_ok = mapper.normal_reliability_gate(nres, c.regularizer.reliability)
        points = points._replace(norm_k0=torch.where(solved_ok[:, None], nres.k, points.norm_k0))
        pid_row = kfs.point_id[slot]
        norm_k, norm_valid, _ = mapper.write_normals(kfs.norm_k, kfs.norm_valid, slot, pid_row,
                                                     nres.k, solved_ok)
        norm_k, norm_valid = mapper.propagate_normals(norm_k, norm_valid, cp, dps, nres.k,
                                                      solved_ok)
        kfs = kfs._replace(norm_k=norm_k, norm_valid=norm_valid)

        # the template's source: the new keyframe when exploring, else the
        # most voted reference keyframe
        n_new = int(mapper.exploration_count(kfs.xy[slot], kfs.kp_valid[slot], pid_row, c))
        sel = int(mapper.select_ref_keyframe(pid_row, points.ref_kf, points.valid, kfs.valid,
                                             slot))
        if int(cp.n_pairs) == 0:
            return state()
        kf_t = slot if n_new > c.mapping.points_to_template else sel
        if int(kfs.norm_valid[kf_t].sum()) < c.mapping.min_normals:
            return state()

        # SfN, the Sim(3) registration and the template swap
        retina = kfs.retina[kf_t]
        if c.mapping.per_kf_domain:
            dom_s = mapper.bbox_domain(retina, kfs.kp_valid[kf_t], self.dom,
                                       margin=c.mapping.kf_domain_margin)
            bend_s = bspline.bending_matrix_dyn(dom_s, c.mapping.sfn_ctrl_u, c.mapping.sfn_ctrl_v)
        else:
            dom_s, bend_s = self.dom, self.bend_sfn
        res_sfn = mapper.integrate_surface(retina, kfs.norm_k[kf_t], kfs.norm_valid[kf_t], dom_s,
                                           bend_s, c, ext_dom=self.dom)
        kf_pose = kfs.pose[kf_t]
        pid_t = kfs.point_id[kf_t]
        surf_xyz, map_xyz, mask, embedded = mapper.registration_pairs(
            res_sfn.xyz, pid_t, kfs.kp_xyz[kf_t], kfs.kp_xyz_valid[kf_t], kfs.norm_valid[kf_t],
            points.valid, points.facet, kf_pose)
        reg = mapper.register_surface(surf_xyz, map_xyz, mask, c)
        if not (bool(res_sfn.ok) and bool(reg.accepted)):
            return state()
        ctrl_p = mapper.polish_surface(res_sfn.ctrl, reg, retina, map_xyz, embedded, dom_s,
                                       bend_s, c, grid_dom=self.dom)
        regen = mapper.regen_template(ctrl_p, reg, kf_pose, retina, self.dom, c, spline_dom=dom_s)
        tmpl, tmpl_ref_kf = regen.template, kf_t
        points, pid_new = mapper.rebuild_points(
            points, regen, kf_pose, self.K, pid_t, kfs.kp_valid[kf_t], kfs.desc[kf_t],
            kfs.angle[kf_t], kf_t, self.dom, c, kf_counter)
        kfs.point_id[kf_t] = pid_new
        kfs.surf_ctrl[kf_t] = ctrl_p
        kfs.surf_valid[kf_t] = True
        kfs.surf_dom[kf_t] = dom_s
        points, _ = mapper.cull_points(points, kfs.point_id, kfs.valid, kf_counter)
        return state(True)

    @in_dtype
    def initialize(self, feats) -> "InitState":
        """The plane-at-z=1 initialization of the first frame: every
        keypoint inside the retina domain becomes a map point on z = 1,
        and the template is the plane mesh over the domain."""
        c, dev = self.cfg, self.device
        feats = self.features(feats)
        retina = cam.to_retina(self.K, feats.xy)
        nodes = meshmod.grid_nodes_from_surface(
            lambda u, v: torch.stack([u, v, torch.ones_like(u)], dim=-1), self.dom, self.topo)
        tmpl = meshmod.make_template(nodes, self.topo)
        facet, bary, inside = meshmod.embed_uv(retina, self.dom, self.topo)
        p_cap = c.capacity.max_map_points
        idx_kp = torch.nonzero(feats.valid & inside)[:, 0][: min(feats.capacity, p_cap)]
        n = int(idx_kp.shape[0])
        pts = store.empty_points(c, dev)
        xyz = pts.xyz.clone()
        xyz[:n, :2] = retina[idx_kp]
        xyz[:n, 2] = 1.0
        gather = torch.cat([idx_kp, idx_kp.new_zeros(p_cap - n)])
        facet_p = pts.facet.clone()
        facet_p[:n] = facet[idx_kp]
        bary_p = pts.bary.clone()
        bary_p[:n] = bary[idx_kp]
        live = torch.arange(p_cap, device=dev) < n
        return InitState(xyz=xyz, desc=feats.desc[gather], facet=facet_p, bary=bary_p,
                         valid=live, nodes=tmpl.nodes)

    # ------------------------------------------------------- rigid mode

    @in_dtype
    def match_rigid(self, points, pose, feats, window: float):
        """All valid map points projected with ``pose`` and matched to the
        frame (B1 at (P, K)): (kp_of_point (P,), n_matches, visible (P,))."""
        c = self.cfg
        points, feats = self.points(points), self.features(feats)
        pc = se3.transform(pose, points.xyz)
        uv = cam.project(self.K, pc)
        ok_p = points.valid & (pc[..., 2] > 1e-6) & cam.in_image(uv, c.camera.width,
                                                                   c.camera.height)
        lv = feats.level.to(self.dtype)
        scale = torch.pow(torch.full_like(lv, c.orb.scale_factor), lv)
        inside = (torch.abs(uv[:, None, :] - feats.xy[None, :, :]).max(dim=-1).values
                  <= window * scale[None, :])
        dist = matching.masked_hamming(points.desc, feats.desc, ok_p, feats.valid,
                                       pair_mask=inside)
        m = matching.best_match(dist, max_dist=c.tracking.match_th_high,
                                nn_ratio=c.tracking.nn_ratio, mutual=True)
        m = matching.rotation_consistency(points.angle, feats.angle, m)
        return m.idx, (m.idx >= 0).sum(), ok_p

    @in_dtype
    def pose_solve(self, T0, idx, feats, points) -> pose_opt.PoseResult:
        """The rigid frame's pose LM from the prediction ``T0`` and the
        matches ``idx``."""
        c = self.cfg
        feats, points = self.features(feats), self.points(points)
        kp = torch.clamp(idx, 0, feats.capacity - 1)
        lv = feats.level[kp].to(self.dtype)
        inv_sigma2 = 1.0 / torch.pow(torch.full_like(lv, c.orb.scale_factor), 2.0 * lv)
        mask = (idx >= 0) & points.valid
        return pose_opt.solve_pose(self.K, T0, points.xyz, feats.xy[kp], inv_sigma2, mask, c)

    @in_dtype
    def local_ba(self, kfs, points):
        """The rigid local BA over every stored keyframe, keyframe 0 fixed:
        its answer (a ``BAResult``) and the objective its second phase
        minimizes, a function of (poses, xyz) that gives a float."""
        kfs, points = self.keyframes(kfs), self.points(points)
        lv = torch.clamp(kfs.level, 0, self.sig2.shape[0] - 1)
        problem = ba.BAProblem(
            poses=kfs.pose, xyz=points.xyz, pid=kfs.point_id, uv=kfs.xy,
            inv_sigma2=1.0 / self.sig2[lv], obs_mask=kfs.kp_valid & kfs.valid[:, None],
            cam_free=kfs.valid & (torch.arange(kfs.capacity, device=self.device) != 0),
            point_free=points.valid,
        )
        res, survivors = ba.ba_solve_stages(problem, self.K)

        def objective(poses, xyz) -> float:
            with default_dtype(self.dtype):
                return float(ba.ba_objective(survivors, self.K, poses.to(self.dtype),
                                             xyz.to(self.dtype)))
        return res, objective


class LegacyState(NamedTuple):
    """What the multi-device keyframe chain leaves: the stores, the
    template and its source keyframe, the keyframe counter, and whether
    the template was swapped."""

    kfs: store.KeyframeStore
    points: store.PointStore
    tmpl: meshmod.Template
    tmpl_ref_kf: int
    kf_counter: int
    updated: bool


class InitState(NamedTuple):
    """The map and template the initialization makes."""

    xyz: torch.Tensor
    desc: torch.Tensor
    facet: torch.Tensor
    bary: torch.Tensor
    valid: torch.Tensor
    nodes: torch.Tensor
