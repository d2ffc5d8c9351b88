"""defslam_tpu_torch.System — the port's public API.

Port of ``defslam_tpu/system.py``: plane-at-z=1 initialization
(DefTracking.cc:583-664), then per frame the track / validate / commit
protocol with the wide-window retry, relocalization against the stored
keyframes (``tracking.pose_opt.relocalize``) and the LOST state, and every
``tracking.keyframe_period`` frames a keyframe with the whole NRSfM mapping
chain (``mapping.mapper.keyframe_step``: warps, densification, normals,
shape-from-normals, Sim(3) registration, re-template, re-anchor).  Around
it: the ground-truth entry points (``track_monocular_ct`` /
``track_monocular_gt``, ``groundtruth.gt``), the reference's text streams
(:meth:`System.write_metrics`), checkpoints in the JAX package's npz format
(:meth:`System.save_state` / :meth:`System.load_state`: either package
loads the other's), live tuning and restart.

Two protocols, as in the JAX package (``Config.tracking``):

- ``pipelined`` (the default, ``pipeline_depth`` 2): a frame is
  dispatched, and only then is the oldest in-flight frame validated, from
  scalars copied to pinned host memory behind its compute
  (``utils.Readback``).  The frame's state is committed optimistically; a
  keyframe frame's mapping chain is dispatched on it as well (the keyframe
  store snapshotted first).  A frame that fails validation is rolled back
  with every newer in-flight frame, and they are replayed through the
  synchronous ladder in frame order.  Metrics rows hold -1 until their
  frame is validated and are filled in place; the keyframe step's
  diagnostics are read when they have landed.  ``flush`` drains it all.
- synchronous (``pipelined=False``): every frame is validated before
  ``track_monocular`` returns, and a keyframe's diagnostics are read right
  after its step.  The two give the same metrics rows and trajectory.

``split_keyframe_dispatch`` runs the chain as two calls,
``keyframe_step_a`` and ``keyframe_step_b``, with the next frame dispatched
between them; B re-anchors from the keyframe's stored pose and applies the
swap's gauge to the live pose and the motion model.  The GT harness's
per-keyframe angle evaluation needs the step's state at once, so it reads
the diagnostics synchronously and turns the split off.  The JAX package's
synchronous path re-anchors a second time after a template swap when the
GT harness is on; its default (pipelined) path does not, and neither does
the port.

Everything runs on ``System.device``: CUDA unless the caller passes
``device="cpu"``.  Importing this module turns TF32 off for CUDA matmuls
and cuDNN convolutions: the reference computes its matmuls in full float32
(``Precision.HIGHEST``), and the pyramid's Gaussian blur is a convolution
that cuDNN would otherwise run in TF32.
"""

from __future__ import annotations

import enum
import json
import os
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from defslam_tpu_torch import config as cfgmod
from defslam_tpu_torch import profiling
from defslam_tpu_torch.config import Config
from defslam_tpu_torch.convert import numpy_from_tensor, tensor_from_numpy
from defslam_tpu_torch.frontend import Features, extract_features
from defslam_tpu_torch.geometry import camera as cam
from defslam_tpu_torch.mapping import mapper
from defslam_tpu_torch.mapstore import state as store
from defslam_tpu_torch.template import mesh as meshmod
from defslam_tpu_torch.tracking import pose_opt, tracker
from defslam_tpu_torch.utils import Readback

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TEMPLATE_HISTORY_CAP = 256  # keyframe-time templates kept for export


class TrackingState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


@dataclass
class FrameResult:
    pose: np.ndarray | torch.Tensor  # a device tensor for an optimistic frame
    state: TrackingState
    n_matches: int
    n_inliers: int
    is_keyframe: bool
    template_updated: bool


class _InFlight(NamedTuple):
    """A pipelined frame awaiting validation."""

    img: torch.Tensor
    out: tuple  # tracker.track_frame's outputs
    timestamp: float
    frame_id: int
    backup: tuple  # (pose, prev_pose, template, points, frames_since_kf) before it
    row: int  # its metrics row
    kf_backup: tuple | None  # (kfs, kf_counter, template_ref_kf, len(template_history))
    readback: Readback  # (stats, pose) on their way to the host


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
    Reset, Restart, Shutdown, Activate/DeactivateLocalizationMode,
    GetTrackingState)."""

    def __init__(self, cfg: Config | str | None = None, device=None):
        if isinstance(cfg, str):
            cfg = Config.from_yaml(cfg)
        self.cfg = cfg or Config()
        self.device = resolve_device(device)
        self._derive_constants()
        self._localization_only = False
        self._metrics: list[dict] = []
        self._kf_mark = None  # optional stage callback handed to keyframe_step
        self._gt_eval = None  # the GT harness, created by the first GT frame
        self.reset()

    def _derive_constants(self):
        """Camera matrix, retina domain, mesh topology and bending matrices
        from ``self.cfg``."""
        c = self.cfg
        self.K = torch.as_tensor(c.camera.K, device=self.device)
        self.dom = cam.retina_domain(self.K, c.camera.width, c.camera.height)
        self.topo = meshmod.grid_topology(c.mesh.nodes_u, c.mesh.nodes_v)
        self.bend_warp = mapper.bending_for(self.dom, c.mapping.warp_ctrl_u, c.mapping.warp_ctrl_v)
        self.bend_sfn = mapper.bending_for(self.dom, c.mapping.sfn_ctrl_u, c.mapping.sfn_ctrl_v)

    # ----------------------------------------------------------- lifecycle

    def reset(self):
        """Full map reset (System::Reset).  In-flight pipelined frames and
        pending keyframe halves are dropped: the map they worked on is
        being destroyed."""
        c = self.cfg
        self._pending: list[_InFlight] = []
        # (Readback of the diagnostics, metrics row, evaluate GT angles)
        self._pending_map = None
        # (KFCarry, Readback of its gate, features, metrics row, kf_counter)
        self._pending_kf_b = None
        self.n_rollbacks = 0  # in-flight frames found failed and replayed
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
        # keyframe-time template states (frame_id, nodes) for the
        # mesh-history export (viewer.export.export_template_history)
        self.template_history: list[tuple[int, torch.Tensor]] = []

    def apply_tuning(self, overrides: dict) -> None:
        """Live parameter overrides (the DefViewer regularizer sliders,
        DefViewer.cc:53-120, for a headless host).  Keys are reference YAML
        names ('Regularizer.laplacian') or dotted config paths
        ('sft.lm_iterations'); values are coerced to the field's type.  The
        pipeline is flushed and the next frame runs with the new Config."""
        self.flush()
        cfg = self.cfg
        for key, value in overrides.items():
            cfg = cfgmod.replace_path(cfg, cfgmod.reference_key_path(key), value)
        self.cfg = cfg
        self._derive_constants()

    def restart(self):
        """System::Restart (System.cc:254-266): put the template back to its
        rest shape, keep the map."""
        self.flush()
        if self.template is not None:
            self.template = self.template._replace(nodes=self.template.nodes_rest)
            self.points = tracker.reposition_points(self.points, self.template.nodes, self.cfg)

    def flush(self):
        """Validate every in-flight frame, dispatch a pending keyframe half
        B, and read the last keyframe step's diagnostics (blocking).  The
        frames come before B: their compute consumed the state before B,
        and a rollback must not have to undo it."""
        while self._pending:
            self._finalize_pending()
        self._dispatch_pending_kf_b()
        self._finalize_pending_map()

    def shutdown(self):
        """No threads to join; drain the pipeline."""
        self.flush()

    def activate_localization_mode(self):
        self._localization_only = True

    def deactivate_localization_mode(self):
        self._localization_only = False

    def get_tracking_state(self) -> TrackingState:
        return self.state

    # ------------------------------------------------------------ tracking

    def track_monocular(self, img, timestamp: float = 0.0):
        """Process one grayscale frame (a numpy array, or a tensor, best
        already on ``System.device``); returns the world->camera pose (4x4)
        or None while not initialized / lost.

        Under ``tracking.pipelined`` (the default) the pose returned for a
        tracked frame is its SfT solution before validation, as a tensor on
        the device; validation comes up to ``pipeline_depth`` frames later,
        and a frame that fails it is rolled back and tracked again, its
        outcome landing in the metrics and the trajectory, not in this
        return value.  With ``pipelined=False``, or after :meth:`flush`,
        poses are validated, and returned as numpy arrays."""
        self.frame_id += 1
        img = self._upload(img)
        if img.ndim == 3:
            img = img.float().mean(dim=-1)
        reinit = self.state in (TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED)
        if self.state == TrackingState.LOST and (
            self.template is None or self._lost_count >= self.cfg.tracking.lost_patience
        ):
            reinit = True
        if reinit:
            self.flush()
            feats = extract_features(img, self.cfg)
            ok = self._initialize(feats, timestamp)
            self.state = TrackingState.OK if ok else TrackingState.NOT_INITIALIZED
            self._record(timestamp, 0, 0, ok, ok)
            return self.pose.cpu().numpy() if ok else None
        result = self._track(img, timestamp)
        if result.state == TrackingState.OK:
            self._lost_count = 0
            return result.pose
        self._lost_count += 1
        return None

    def track_monocular_gt(self, img_left, img_right, timestamp: float = 0.0,
                           baseline: float = 0.1):
        """Track on the left image and, with ``save_results``, evaluate
        against stereo-NCC ground truth (System::TrackMonocularGT,
        System.cc:268-341)."""
        pose = self.track_monocular(img_left, timestamp)
        if pose is not None and self.cfg.save_results:
            self.flush()  # the evaluation reads the validated state
            self._gt_evaluator().evaluate_stereo(self, img_left, img_right, baseline, timestamp)
        return pose

    def track_monocular_ct(self, img, depth_map, timestamp: float = 0.0):
        """Track and, with ``save_results``, evaluate against a per-frame GT
        depth map (System::TrackMonocularCTGT, System.cc:343-416)."""
        pose = self.track_monocular(img, timestamp)
        if pose is not None and self.cfg.save_results:
            self.flush()  # the evaluation reads the validated state
            self._gt_evaluator().evaluate_depth(self, np.asarray(depth_map), timestamp)
        return pose

    def _gt_evaluator(self):
        if self._gt_eval is None:
            from defslam_tpu_torch.groundtruth.gt import GroundTruthEvaluator

            self._gt_eval = GroundTruthEvaluator(self.cfg)
        return self._gt_eval

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

    def _upload(self, img) -> torch.Tensor:
        """The frame on ``self.device``.  A tensor already there is taken as
        it is; a numpy frame bound for CUDA goes through pinned memory with
        a non-blocking copy (a copy from pageable memory would make the
        host wait for the stream, and serialize the pipeline)."""
        if not torch.is_tensor(img):
            img = torch.from_numpy(np.ascontiguousarray(img))
            if self.device.type == "cuda":
                img = img.pin_memory()
        return img.to(self.device, non_blocking=True)

    def _track_frame(self, img, window_scale: float = 1.0):
        return tracker.track_frame(
            img, self.points, self.pose, self.prev_pose, self.template,
            self.K, self.cfg, window_scale=window_scale,
        )

    def _track(self, img, timestamp: float) -> FrameResult:
        """One tracked frame with a depth-D frame pipeline
        (``tracking.pipeline_depth``): this frame is dispatched first, then
        in-flight frames are validated until at most D - 1 remain, so the
        readback of the oldest overlaps the newer frames' device work (the
        reference's PARALLEL-mode overlap, System.cc:140-142, as an
        asynchronous dispatch).  Keyframe frames are pipelined too: the
        mapping chain is dispatched on the frame's unvalidated outputs,
        after a snapshot of the keyframe store, which the chain's first
        half writes in place.  A frame found failed up to D frames late is
        rolled back from the backups, an optimistic keyframe insertion
        with it, and it and every newer in-flight frame are replayed
        through the synchronous retry ladder, in frame order."""
        c = self.cfg
        will_kf = (not self._localization_only
                   and self.frames_since_kf + 1 >= c.tracking.keyframe_period)
        pipelined = c.tracking.pipelined and self.state == TrackingState.OK
        with profiling.stage("frame.dispatch"):
            out = self._track_frame(img)
        target = max(1, c.tracking.pipeline_depth) - 1 if pipelined else 0
        with profiling.stage("frame.finalize"):
            while len(self._pending) > target:
                if not self._finalize_pending():
                    # an in-flight frame failed: the state was rolled back and
                    # the queue replayed; this frame's dispatch used stale
                    # state, and a replay that ended LOST needs the ladder
                    out = self._track_frame(img)
                    pipelined = pipelined and self.state == TrackingState.OK
        # the keyframe step's diagnostics, if they have landed (no wait: no
        # consumer needs them before the next keyframe)
        self._finalize_pending_map(force=False)
        if not pipelined:
            result = self._validate_and_commit(img, out, timestamp)
            self._dispatch_pending_kf_b()
            return result
        feats, matches, res, new_points, stats = out
        # the validation scalars start for the host right behind the
        # frame's compute, ahead of any mapping work queued below
        readback = Readback.start((stats, res.T))
        backup = (self.pose, self.prev_pose, self.template, self.points, self.frames_since_kf)
        self.prev_pose = self.pose
        self.pose = res.T
        self.template = self.template._replace(nodes=res.nodes)
        self.points = new_points
        # the metrics row now, in frame order, with -1 counts until validated
        row = self._record(timestamp, -1, -1, will_kf, False)
        kf_backup = None
        if will_kf:
            self._finalize_pending_map()
            kf_backup = (store.KeyframeStore(*(t.clone() for t in self.kfs)), self.kf_counter,
                         self.template_ref_kf, len(self.template_history))
            self._insert_keyframe(feats, matches, res, row)
            # the step may re-register or re-anchor the pose (a gauge jump):
            # drop the velocity, as the synchronous path does
            self.prev_pose = self.pose
            self.frames_since_kf = 0
        else:
            self.frames_since_kf += 1
            # half B of a split chain rides behind this frame's compute; the
            # state before B is what this frame consumed, so it is also
            # this frame's rollback snapshot of the keyframe store
            kf_backup = self._dispatch_pending_kf_b()
        self._pending.append(_InFlight(img, out, timestamp, self.frame_id, backup,
                                       len(self._metrics) - 1, kf_backup, readback))
        return FrameResult(res.T, TrackingState.OK, -1, -1, False, False)

    def _finalize_pending(self) -> bool:
        """Validate the oldest in-flight frame.  False when it failed: the
        state was then rolled back and it and every newer in-flight frame
        were replayed through the synchronous ladder (the queue is empty
        afterwards)."""
        f = self._pending.pop(0)
        c = self.cfg
        stats_h, pose_h = f.readback.get()
        n_matches, n_inliers = int(stats_h[0]), int(stats_h[1])
        if n_matches >= c.tracking.min_inliers_ok and n_inliers >= c.tracking.min_inliers_ok:
            self.trajectory.append((f.timestamp, pose_h))
            self._metrics[f.row].update(matches=n_matches, inliers=n_inliers,
                                        n_local=int(stats_h[2]), match_dropped=int(stats_h[3]))
            return True
        self.n_rollbacks += 1
        rest, self._pending = self._pending, []
        (self.pose, self.prev_pose, self.template, self.points, self.frames_since_kf) = f.backup
        # undo an optimistic keyframe insertion among these frames: the
        # stores change only at keyframes and in order, so the oldest
        # snapshot is the state before any of them
        for kb in [f.kf_backup] + [e.kf_backup for e in rest]:
            if kb is not None:
                self.kfs, self.kf_counter, self.template_ref_kf, n_hist = kb
                del self.template_history[n_hist:]
                # the diagnostics or the undispatched half belong to the undone step
                self._pending_map = None
                self._pending_kf_b = None
                break
        # the failed frame reuses its dispatch (made from exactly the backup
        # state); the newer ones are tracked again.  Each takes its own
        # frame id back for the replay, and its row is replaced in place.
        newest = self.frame_id
        for e, out in [(f, f.out)] + [(e, None) for e in rest]:
            self.frame_id = e.frame_id
            if out is None:
                out = self._track_frame(e.img)
            n_rows = len(self._metrics)
            self._validate_and_commit(e.img, out, e.timestamp)
            if len(self._metrics) > n_rows:
                self._metrics[e.row] = self._metrics.pop()
        self.frame_id = newest
        return False

    @staticmethod
    def _readback(out):
        """One host readback per frame attempt: the stats and the pose."""
        stats_h, pose_h = Readback.start((out[4], out[2].T)).get()
        return int(stats_h[0]), int(stats_h[1]), stats_h, pose_h

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
        row = self._record(timestamp, n_matches, n_inliers, is_kf, False,
                           n_local=int(stats_h[2]), n_dropped=int(stats_h[3]))
        if is_kf:
            self._insert_keyframe(feats, matches, res, row)
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
        (the reference's DefSLAM mode resets at once, DefTracking.cc:194-207;
        the JAX package first tries the recovery its ORBSLAM mode uses).
        Returns (ok, pose or None); one host read."""
        ok, T, _ = pose_opt.relocalize(
            extract_features(img, self.cfg), self.kfs, self.points, self.K, self.cfg)
        return (True, T) if bool(ok) else (False, None)

    def _insert_keyframe(self, feats, matches, res, row: dict) -> None:
        """CreateNewKeyFrame and the mapping step, reported through the
        keyframe's metrics ``row`` when its diagnostics are read
        (:meth:`_finalize_pending_map`).  Fused: one ``keyframe_step``,
        which also re-anchors pose and template when it swaps the template.
        Split (``tracking.split_keyframe_dispatch``, off while the GT
        harness evaluates keyframe angles): half A now, half B dispatched
        by the next tracked frame (:meth:`_dispatch_pending_kf_b`)."""
        c = self.cfg
        self._finalize_pending_map()
        self._dispatch_pending_kf_b()  # a keyframe period of 1
        # the GT harness evaluates the keyframe's normal angles whenever
        # the NRSfM chain ran (estimateAngleErrorAndScale inside NRSfM,
        # DefLocalMapping.cc:216-221), on the state right after the step
        gt_angles = c.save_results and self._gt_eval is not None
        if c.tracking.split_keyframe_dispatch and not gt_angles:
            with profiling.stage("keyframe.dispatch_a"):
                self.kfs, self.points, carry = mapper.keyframe_step_a(
                    self.kfs, self.points, self.pose, feats, matches.kp_of_point, res.inlier,
                    self.K, self.dom, self.bend_warp, self.template_ref_kf, self.frame_id, c,
                    mark=self._kf_mark,
                )
            # B takes the counter before the increment (the culling window
            # is keyed on it), and the gate copied right behind A: reading
            # it then waits for A, not for the frame dispatched after A
            self._pending_kf_b = (carry, Readback.start([carry.gate]), feats, row,
                                  self.kf_counter)
            self.kf_counter += 1
            return
        with profiling.stage("keyframe.dispatch"):
            self.kfs, self.points, self.template, self.pose, diag = mapper.keyframe_step(
                self.kfs, self.points, self.template, self.pose, feats,
                matches.kp_of_point, res.inlier, self.K, self.dom,
                self.bend_warp, self.bend_sfn, self.template_ref_kf, self.kf_counter,
                self.frame_id, c, mark=self._kf_mark,
            )
        self.kf_counter += 1
        self._record_template_history()
        self._start_map_readback(diag, row, gt_angles)
        if gt_angles or not c.tracking.pipelined:
            self._finalize_pending_map()

    def _dispatch_pending_kf_b(self):
        """Dispatch half B of a split keyframe chain.  Called right after
        the next frame's state is committed, so the stream runs [frame t]
        [A][frame t+1][B][frame t+2] and no frame waits behind more than
        half the chain.  Returns the state before B in the keyframe
        snapshot's format (B leaves the stores it is given unchanged, so no
        copy is needed): the frame between the halves consumed exactly
        that state, and its rollback restores it.  None if nothing was
        pending."""
        if self._pending_kf_b is None:
            return None
        carry, gate, feats, row, kf_counter = self._pending_kf_b
        self._pending_kf_b = None
        b_backup = (self.kfs, self.kf_counter, self.template_ref_kf, len(self.template_history))
        with profiling.stage("keyframe.dispatch_b"):
            self.kfs, self.points, self.template, self.pose, diag, gauge = mapper.keyframe_step_b(
                self.kfs, self.points, self.template, self.pose, feats, carry, self.K,
                self.dom, self.bend_sfn, kf_counter, self.cfg, mark=self._kf_mark,
                gate=bool(gate.get()[0]),
            )
        # a template swap changes the world's gauge; B moved the live pose
        # by it (pose @ gauge): move the motion model alike, so the
        # constant-velocity prediction survives the swap
        self.prev_pose = self.prev_pose @ gauge
        self._record_template_history()
        self._start_map_readback(diag, row, False)
        if not self.cfg.tracking.pipelined:
            self._finalize_pending_map()
        return b_backup

    def _record_template_history(self):
        """Keep the keyframe-time template for the mesh-history view
        (DefMapDrawer::MeshDrawershist), at most TEMPLATE_HISTORY_CAP."""
        if self.template is not None:
            self.template_history.append((self.frame_id, self.template.nodes.clone()))
            del self.template_history[:-TEMPLATE_HISTORY_CAP]

    def _start_map_readback(self, diag: mapper.MappingDiag, row: dict, gt_angles: bool):
        """Start the keyframe step's scalars for the host (one copy)."""
        vals = torch.stack([v.to(torch.float64) for v in diag])
        self._pending_map = (Readback.start([vals]), row, gt_angles)

    def _finalize_pending_map(self, force: bool = True):
        """Read the last keyframe step's scalars (``force=False``: only if
        they have landed, never waiting), keep the template bookkeeping,
        set ``last_map_diag``, and fill the keyframe's metrics row.  With
        the GT harness's angles due, evaluate the keyframe's normal angles
        when the NRSfM chain ran, swap or not.  Returns the host
        MappingDiag, or None when nothing was read."""
        if self._pending_map is None:
            return None
        readback, row, gt_angles = self._pending_map
        if not force and not readback.ready():
            return None
        self._pending_map = None
        (vals,) = readback.get()
        d = mapper.MappingDiag(*(
            bool(v) if f in ("accepted", "exploring") else
            float(v) if f == "reg_scale" else int(v)
            for f, v in zip(mapper.MappingDiag._fields, vals.tolist())
        ))
        self.last_map_diag = d
        if d.accepted:
            self.template_ref_kf = d.kf_t
        row.update(
            template=d.accepted,
            map_obs_dropped=d.obs_dropped,
            map_pair_dropped=d.pair_dropped,
            map_pt_dropped=d.pt_dropped,
            points_culled=d.n_culled,
            reg_scale=d.reg_scale,
        )
        if gt_angles and d.n_pairs > 0 and d.n_norm >= self.cfg.mapping.min_normals:
            self._gt_eval.evaluate_keyframe_angles(self, d.kf_t)
        return d

    # -------------------------------------------------------- persistence

    def save_state(self, path: str):
        """Checkpoint the whole run in one npz file, in the JAX package's
        format (keys ``kf_*``, ``pt_*``, ``tmpl_*``, ``pose``, ``prev_pose``,
        ``meta``, ``metrics_json``, ``traj_*``, ``hist_*``, ``gt_rows``; its
        dtypes: uint32 descriptor words, int32 index fields), so either
        package loads the other's checkpoint.  The run history goes with the
        map: a resumed run continues the metric streams.  The pipeline is
        flushed first."""
        self.flush()
        arrays = {}
        parts = [("kf", self.kfs), ("pt", self.points)]
        if self.template is not None:
            parts.append(("tmpl", self.template))
        for prefix, obj in parts:
            for name, t in obj._asdict().items():
                arrays[f"{prefix}_{name}"] = numpy_from_tensor(name, t)
        arrays["pose"] = self.pose.cpu().numpy()
        arrays["prev_pose"] = self.prev_pose.cpu().numpy()
        arrays["meta"] = np.asarray(
            [self.frame_id, self.frames_since_kf, self.template_ref_kf,
             self.state.value, self.kf_counter, self._lost_count])
        arrays["metrics_json"] = np.frombuffer(json.dumps(self._metrics).encode(), np.uint8)
        if self.trajectory:
            arrays["traj_ts"] = np.asarray([t for t, _ in self.trajectory])
            arrays["traj_T"] = np.stack([np.asarray(T) for _, T in self.trajectory])
        if self.template_history:
            arrays["hist_fid"] = np.asarray([f for f, _ in self.template_history], np.int64)
            arrays["hist_nodes"] = np.stack([n.cpu().numpy() for _, n in self.template_history])
        if self._gt_eval is not None and self._gt_eval.rows:
            arrays["gt_rows"] = np.asarray(self._gt_eval.rows, np.float64)
        np.savez_compressed(path, **arrays)

    def load_state(self, path: str):
        """Restore a checkpoint written by :meth:`save_state` of either
        package, onto this System's device; in-flight work is dropped."""
        dev = self.device
        self._pending, self._pending_map, self._pending_kf_b = [], None, None
        with np.load(path) as data:
            def part(prefix, cls):
                return cls(**{f: tensor_from_numpy(f, data[f"{prefix}_{f}"], dev)
                              for f in cls._fields})

            self.kfs = part("kf", store.KeyframeStore)
            self.points = part("pt", store.PointStore)
            if "tmpl_nodes" in data:
                self.template = part("tmpl", meshmod.Template)
            self.pose = torch.as_tensor(data["pose"], device=dev)
            self.prev_pose = (torch.as_tensor(data["prev_pose"], device=dev)
                              if "prev_pose" in data else self.pose)
            meta = [int(v) for v in data["meta"]]
            self.frame_id, self.frames_since_kf, self.template_ref_kf = meta[:3]
            self.state = TrackingState(meta[3])
            self.kf_counter = meta[4] if len(meta) > 4 else 1
            self._lost_count = meta[5] if len(meta) > 5 else 0
            if "metrics_json" in data:
                self._metrics = json.loads(bytes(data["metrics_json"]).decode())
            if "traj_ts" in data:
                self.trajectory = [(float(t), T) for t, T in zip(data["traj_ts"], data["traj_T"])]
            if "hist_fid" in data:
                self.template_history = [
                    (int(f), torch.as_tensor(n, device=dev))
                    for f, n in zip(data["hist_fid"], data["hist_nodes"])
                ]
            if "gt_rows" in data:
                # rows are (ts, rmse, n, scale): the inlier count goes back to
                # an int, or ScaleVariation.txt would print "12.0"
                self._gt_evaluator().rows = [
                    (float(t), float(r), int(n), float(s)) for t, r, n, s in data["gt_rows"]
                ]

    # ------------------------------------------------------------- metrics

    def _record(self, timestamp, n_matches, n_inliers, is_kf, tmpl,
                n_local=0, n_dropped=0) -> dict:
        """Append the frame's metrics row and return it (later readbacks
        fill it in place)."""
        row = dict(
            frame=self.frame_id, t=timestamp, matches=n_matches,
            inliers=n_inliers, keyframe=bool(is_kf),
            template=bool(tmpl), state=self.state.name,
            n_local=int(n_local), match_dropped=int(n_dropped),
        )
        self._metrics.append(row)
        return row

    def write_metrics(self, outdir: str | None = None):
        """The reference's tracking text streams (Tracking.cc:150-167), in
        the JAX package's formats:

        - ``Matches.txt``: "timestamp matches inliers keyframe template
          state" per frame;
        - ``StatusTracking.txt``: "timestamp 0|1" (1 = not tracked);
        - ``MapPointUsage.txt``: "timestamp matches inliers frustum-
          candidates live-map-points";
        - ``Trajectory.txt``: "timestamp" and the 16 entries of the pose;
        - with the GT harness on, ``ErrorGTs0.txt`` and
          ``ScaleVariation.txt`` (the per-keyframe ``ErrorAngIso*`` /
          ``ErrorAngSfN*`` files are written as the keyframes come).

        The pipeline is flushed first."""
        self.flush()
        outdir = outdir or self.cfg.output_dir
        os.makedirs(outdir, exist_ok=True)
        n_points_valid = int(self.points.valid.sum())
        with open(os.path.join(outdir, "Matches.txt"), "w") as f:
            for m in self._metrics:
                f.write(f"{m['t']:.6f} {m['matches']} {m['inliers']} "
                        f"{int(m['keyframe'])} {int(m['template'])} {m['state']}\n")
        with open(os.path.join(outdir, "StatusTracking.txt"), "w") as f:
            for m in self._metrics:
                f.write(f"{m['t']:.6f} {int(m['state'] != 'OK')}\n")
        with open(os.path.join(outdir, "MapPointUsage.txt"), "w") as f:
            for m in self._metrics:
                f.write(f"{m['t']:.6f} {m['matches']} {m['inliers']} "
                        f"{m.get('n_local', 0)} {n_points_valid}\n")
        with open(os.path.join(outdir, "Trajectory.txt"), "w") as f:
            for ts, T in self.trajectory:
                f.write(f"{ts:.6f} " + " ".join(f"{x:.8f}" for x in np.asarray(T).reshape(-1))
                        + "\n")
        if self._gt_eval is not None:
            self._gt_eval.outdir = outdir
            self._gt_eval.write()
