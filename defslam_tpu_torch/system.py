"""defslam_tpu_torch.System — the port's public API (tracking and mapping).

Port of ``defslam_tpu/system.py``: plane-at-z=1 initialization
(DefTracking.cc:583-664), then per frame the synchronous track / validate /
commit protocol with the wide-window retry and the LOST state, and every
``tracking.keyframe_period`` frames a keyframe with the whole NRSfM mapping
chain (``mapping.mapper.keyframe_step``: warps, densification, normals,
shape-from-normals, Sim(3) registration, re-template, re-anchor).
Relocalization is a later slice of the port and raises
``NotImplementedError``.  The port always runs the synchronous protocol and
the fused keyframe step: ``tracking.pipelined``, ``pipeline_depth`` and
``tracking.split_keyframe_dispatch`` are read as off, and the keyframe
step's diagnostics are read back right after it instead of a frame later,
which changes no result.

Everything runs on ``System.device``: CUDA unless the caller passes
``device="cpu"``.  Importing this module turns TF32 off for CUDA matmuls
and cuDNN convolutions: the reference computes its matmuls in full float32
(``Precision.HIGHEST``), and the pyramid's Gaussian blur is a convolution
that cuDNN would otherwise run in TF32.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch

from defslam_tpu_torch.config import Config
from defslam_tpu_torch.frontend import Features, extract_features
from defslam_tpu_torch.geometry import camera as cam
from defslam_tpu_torch.mapping import mapper
from defslam_tpu_torch.mapstore import state as store
from defslam_tpu_torch.template import mesh as meshmod
from defslam_tpu_torch.tracking import tracker

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RELOCALIZATION_SLICE = "relocalization is slice 3 of the PyTorch port"


class TrackingState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


@dataclass
class FrameResult:
    pose: np.ndarray
    state: TrackingState
    n_matches: int
    n_inliers: int
    is_keyframe: bool
    template_updated: bool


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; raises when CUDA is asked for and absent (the
    port never falls back to the CPU on its own)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "defslam_tpu_torch runs on a CUDA device and none is available; "
            'pass device="cpu" to run on the CPU'
        )
    return dev


class System:
    """Monocular deformable SLAM (System.h:62-202 API: TrackMonocular,
    Reset, Activate/DeactivateLocalizationMode, GetTrackingState)."""

    def __init__(self, cfg: Config | str | None = None, device=None):
        if isinstance(cfg, str):
            cfg = Config.from_yaml(cfg)
        self.cfg = cfg or Config()
        self.device = resolve_device(device)
        c = self.cfg
        self.K = torch.as_tensor(c.camera.K, device=self.device)
        self.dom = cam.retina_domain(self.K, c.camera.width, c.camera.height)
        self.topo = meshmod.grid_topology(c.mesh.nodes_u, c.mesh.nodes_v)
        self.bend_warp = mapper.bending_for(self.dom, c.mapping.warp_ctrl_u, c.mapping.warp_ctrl_v)
        self.bend_sfn = mapper.bending_for(self.dom, c.mapping.sfn_ctrl_u, c.mapping.sfn_ctrl_v)
        self._localization_only = False
        self._metrics: list[dict] = []
        self._kf_mark = None  # optional stage callback handed to keyframe_step
        self.reset()

    # ----------------------------------------------------------- lifecycle

    def reset(self):
        """Full map reset (System::Reset)."""
        c = self.cfg
        self.kfs = store.empty_keyframes(c, self.device)
        self.points = store.empty_points(c, self.device)
        self.template: meshmod.Template | None = None
        self.template_ref_kf = -1  # the current template's source keyframe
        # keyframes created so far: the age reference of recent-point culling
        self.kf_counter = 0
        self.last_map_diag: mapper.MappingDiag | None = None  # host values
        self.pose = torch.eye(4, device=self.device)
        # previous validated pose: the constant-velocity motion model state;
        # prev_pose == pose means "no velocity"
        self.prev_pose = self.pose
        self.state = TrackingState.NO_IMAGES_YET
        self.frame_id = -1
        self.frames_since_kf = 0
        self._lost_count = 0
        self.trajectory: list[tuple[float, np.ndarray]] = []

    def activate_localization_mode(self):
        self._localization_only = True

    def deactivate_localization_mode(self):
        self._localization_only = False

    def get_tracking_state(self) -> TrackingState:
        return self.state

    # ------------------------------------------------------------ tracking

    def track_monocular(self, img, timestamp: float = 0.0) -> np.ndarray | None:
        """Process one grayscale frame; returns the validated world->camera
        pose (4x4 numpy) or None while not initialized / lost."""
        self.frame_id += 1
        img = torch.as_tensor(np.asarray(img), device=self.device)
        if img.ndim == 3:
            img = img.float().mean(dim=-1)
        reinit = self.state in (TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED)
        if self.state == TrackingState.LOST and (
            self.template is None or self._lost_count >= self.cfg.tracking.lost_patience
        ):
            reinit = True
        if reinit:
            feats = extract_features(img, self.cfg)
            ok = self._initialize(feats, timestamp)
            self.state = TrackingState.OK if ok else TrackingState.NOT_INITIALIZED
            self._record(timestamp, 0, 0, ok, ok)
            return self.pose.cpu().numpy() if ok else None
        result = self._validate_and_commit(img, self._track_frame(img), timestamp)
        if result.state == TrackingState.OK:
            self._lost_count = 0
            return result.pose
        self._lost_count += 1
        return None

    # ------------------------------------------------------ initialization

    def _initialize(self, feats: Features, timestamp: float) -> bool:
        """Plane-at-z=1 monocular initialization: every keypoint becomes a
        map point on the plane z=1 through its retina ray; the template is
        the plane mesh over the retina domain."""
        c = self.cfg
        dev = self.device
        if int(feats.valid.sum()) < c.tracking.min_inliers_ok * 2:
            return False
        retina = cam.to_retina(self.K, feats.xy)
        nodes = meshmod.grid_nodes_from_surface(
            lambda u, v: torch.stack([u, v, torch.ones_like(u)], dim=-1),
            self.dom, self.topo,
        )
        self.template = meshmod.make_template(nodes, self.topo)

        facet, bary, inside = meshmod.embed_uv(retina, self.dom, self.topo)
        k = feats.capacity
        p_cap = c.capacity.max_map_points
        idx_kp = torch.nonzero(feats.valid & inside)[:, 0][: min(k, p_cap)]
        n = int(idx_kp.shape[0])
        if n < c.tracking.min_inliers_ok:
            return False

        pts = store.empty_points(c, dev)
        live = torch.arange(p_cap, device=dev) < n
        xyz = pts.xyz.clone()
        xyz[:n, :2] = retina[idx_kp]
        xyz[:n, 2] = 1.0
        gather = torch.cat([idx_kp, idx_kp.new_zeros(p_cap - n)])
        facet_p = pts.facet.clone()
        facet_p[:n] = facet[idx_kp]
        bary_p = pts.bary.clone()
        bary_p[:n] = bary[idx_kp]
        ref_kp = pts.ref_kp.clone()
        ref_kp[:n] = idx_kp
        ones = live.to(torch.int32)
        self.points = pts._replace(
            xyz=xyz,
            desc=feats.desc[gather],
            angle=feats.angle[gather],
            facet=facet_p,
            bary=bary_p,
            ref_kf=torch.where(live, 0, -1),
            ref_kp=ref_kp,
            valid=live,
            n_obs=ones,
            # MapPoint ctor: mnVisible = mnFound = 1
            n_visible=ones.clone(),
            n_found=ones.clone(),
        )
        pid_of_kp = torch.full((k,), -1, dtype=torch.int64, device=dev)
        pid_of_kp[idx_kp] = torch.arange(n, device=dev)
        self.pose = torch.eye(4, device=dev)
        self.prev_pose = self.pose
        self.kfs = store.add_keyframe(
            store.empty_keyframes(c, dev), 0, self.pose, feats, retina,
            pid_of_kp, self.frame_id,
        )
        self.template_ref_kf = 0
        self.kf_counter = 1
        self.frames_since_kf = 0
        self.trajectory.append((timestamp, self.pose.cpu().numpy()))
        return True

    # ------------------------------------------------------------ tracking

    def _track_frame(self, img, window_scale: float = 1.0):
        return tracker.track_frame(
            img, self.points, self.pose, self.prev_pose, self.template,
            self.K, self.cfg, window_scale=window_scale,
        )

    @staticmethod
    def _readback(out):
        """One host readback per frame attempt: the stats and the pose."""
        stats, T = out[4], out[2].T
        stats_h = stats.cpu().numpy()
        return int(stats_h[0]), int(stats_h[1]), stats_h, T.cpu().numpy()

    def _validate_and_commit(self, img, out, timestamp: float) -> FrameResult:
        c = self.cfg
        min_ok = c.tracking.min_inliers_ok
        n_matches, n_inliers, stats_h, pose_h = self._readback(out)
        if n_matches < min_ok:
            # wider search window once (TrackWithMotionModel retry)
            out = self._track_frame(img, window_scale=2.0)
            n_matches, n_inliers, stats_h, pose_h = self._readback(out)
        if n_matches < min_ok or n_inliers < min_ok:
            ok_r, T_r = self._relocalize(img)
            if ok_r:
                self.pose = T_r
                self.prev_pose = T_r  # velocity reset after relocalization
                out = self._track_frame(img)
                n_matches, n_inliers, stats_h, pose_h = self._readback(out)
            if n_inliers < min_ok:
                self.state = TrackingState.LOST
                self.prev_pose = self.pose  # drop velocity when lost
                self._record(timestamp, n_matches, n_inliers, False, False)
                return FrameResult(self.pose.cpu().numpy(), self.state,
                                   n_matches, n_inliers, False, False)

        feats, matches, res, new_points, _ = out
        self.prev_pose = self.pose
        self.pose = res.T
        self.template = self.template._replace(nodes=res.nodes)
        self.points = new_points
        self.trajectory.append((timestamp, pose_h))
        self.state = TrackingState.OK

        self.frames_since_kf += 1
        is_kf = (
            not self._localization_only
            and self.frames_since_kf >= c.tracking.keyframe_period
        )
        self._record(timestamp, n_matches, n_inliers, is_kf, False,
                     n_local=int(stats_h[2]), n_dropped=int(stats_h[3]))
        if is_kf:
            self._insert_keyframe(feats, matches, res)
            self.frames_since_kf = 0
            # the keyframe step may re-register (Sim(3) rescale) or
            # re-anchor the pose: a velocity spanning that gauge jump would
            # extrapolate garbage, so it is dropped for one frame
            self.prev_pose = self.pose
        # as in the JAX package's fused path, the result reports the
        # template flag as False; the keyframe's metrics row carries it
        return FrameResult(pose_h, self.state, n_matches, n_inliers, is_kf, False)

    def _relocalize(self, img):
        """Relocalization against the stored keyframes before declaring LOST
        (``tracking/pose_opt.py::relocalize`` in the JAX package)."""
        raise NotImplementedError(RELOCALIZATION_SLICE)

    def _insert_keyframe(self, feats, matches, res) -> None:
        """CreateNewKeyFrame and the mapping step: one fused
        ``mapper.keyframe_step``, which also re-anchors pose and template
        when it swaps the template.  The swap is reported through the
        keyframe's metrics row, filled by :meth:`_finalize_map`."""
        self.kfs, self.points, self.template, self.pose, diag = mapper.keyframe_step(
            self.kfs, self.points, self.template, self.pose, feats,
            matches.kp_of_point, res.inlier, self.K, self.dom,
            self.bend_warp, self.bend_sfn, self.template_ref_kf, self.kf_counter,
            self.frame_id, self.cfg, mark=self._kf_mark,
        )
        self.kf_counter += 1
        self._finalize_map(diag, len(self._metrics) - 1)

    def _finalize_map(self, diag: mapper.MappingDiag, row: int):
        """Read the keyframe step's scalars back (one host read), keep the
        template bookkeeping, and fill the keyframe's metrics row."""
        vals = torch.stack([v.to(torch.float64) for v in diag]).tolist()
        d = mapper.MappingDiag(*(
            bool(v) if f in ("accepted", "exploring") else
            float(v) if f == "reg_scale" else int(v)
            for f, v in zip(mapper.MappingDiag._fields, vals)
        ))
        self.last_map_diag = d
        if d.accepted:
            self.template_ref_kf = d.kf_t
        self._metrics[row].update(
            template=d.accepted,
            map_obs_dropped=d.obs_dropped,
            map_pair_dropped=d.pair_dropped,
            map_pt_dropped=d.pt_dropped,
            points_culled=d.n_culled,
            reg_scale=d.reg_scale,
        )
        return d

    # ------------------------------------------------------------- metrics

    def _record(self, timestamp, n_matches, n_inliers, is_kf, tmpl,
                n_local=0, n_dropped=0):
        self._metrics.append(
            dict(
                frame=self.frame_id, t=timestamp, matches=n_matches,
                inliers=n_inliers, keyframe=bool(is_kf),
                template=bool(tmpl), state=self.state.name,
                n_local=int(n_local), match_dropped=int(n_dropped),
            )
        )
