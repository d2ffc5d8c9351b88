"""Fixed-capacity structure-of-arrays map state.

Port of ``defslam_tpu/mapstore/state.py`` (the stores and the two
keyframe insertions: from the plane initialization and from a tracked
frame's matches).  Capacities come from
``CapacityConfig``; K = keypoints/frame, P = map points, F = keyframes.
Descriptors are int32 words (the JAX package's uint32 bits).  Index fields
are int64 so they index tensors directly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.frozen.config import Config
from portbench.reference.frozen.frontend import Features
from portbench.reference.frozen.geometry import camera
from portbench.reference.frozen.utils import last_writer, put_


class KeyframeStore(NamedTuple):
    """All keyframes, SoA (KeyFrame + DefKeyFrame state)."""

    pose: torch.Tensor  # (F, 4, 4) world->camera
    xy: torch.Tensor  # (F, K, 2) pixel coords
    retina: torch.Tensor  # (F, K, 2) normalized coords
    desc: torch.Tensor  # (F, K, 8) int32
    level: torch.Tensor  # (F, K) int32
    angle: torch.Tensor  # (F, K)
    kp_valid: torch.Tensor  # (F, K) bool
    point_id: torch.Tensor  # (F, K) int64 — map point seen at this kp, -1
    kp_xyz: torch.Tensor  # (F, K, 3) matched point position at insertion
    kp_xyz_valid: torch.Tensor  # (F, K) bool
    frame_id: torch.Tensor  # (F,) int64 source frame
    valid: torch.Tensor  # (F,) bool
    surf_ctrl: torch.Tensor  # (F, nu, nv) control depths
    surf_valid: torch.Tensor  # (F,) bool
    surf_dom: torch.Tensor  # (F, 4) [umin, umax, vmin, vmax]
    norm_k: torch.Tensor  # (F, K, 2) per-keypoint (k1, k2)
    norm_valid: torch.Tensor  # (F, K) bool

    @property
    def capacity(self) -> int:
        return self.pose.shape[0]


class PointStore(NamedTuple):
    """All map points, SoA (MapPoint + DefMapPoint)."""

    xyz: torch.Tensor  # (P, 3) world
    desc: torch.Tensor  # (P, 8) int32 distinctive descriptor
    facet: torch.Tensor  # (P,) int64 template facet (-1 if unembedded)
    bary: torch.Tensor  # (P, 3)
    ref_kf: torch.Tensor  # (P,) int64
    ref_kp: torch.Tensor  # (P,) int64 keypoint index in ref KF
    angle: torch.Tensor  # (P,) f32 — angle of the last matched keypoint
    valid: torch.Tensor  # (P,) bool
    n_obs: torch.Tensor  # (P,) int32 — observation count
    n_visible: torch.Tensor  # (P,) int32 — frames as a frustum candidate
    n_found: torch.Tensor  # (P,) int32 — frames matched as an inlier
    first_kf: torch.Tensor  # (P,) int32 — keyframe counter at creation
    norm_k0: torch.Tensor  # (P, 2) normal-solver warm start

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]


def empty_keyframes(cfg: Config, device) -> KeyframeStore:
    f = cfg.capacity.max_keyframes
    k = cfg.orb.max_keypoints
    nu, nv = cfg.mapping.sfn_ctrl_u, cfg.mapping.sfn_ctrl_v
    z = dict(device=device)
    K = torch.as_tensor(cfg.camera.K, device=device)
    dom = camera.retina_domain(K, cfg.camera.width, cfg.camera.height)
    return KeyframeStore(
        pose=torch.eye(4, **z).repeat(f, 1, 1),
        xy=torch.zeros((f, k, 2), **z),
        retina=torch.zeros((f, k, 2), **z),
        desc=torch.zeros((f, k, 8), dtype=torch.int32, **z),
        level=torch.zeros((f, k), dtype=torch.int32, **z),
        angle=torch.zeros((f, k), **z),
        kp_valid=torch.zeros((f, k), dtype=torch.bool, **z),
        point_id=torch.full((f, k), -1, dtype=torch.int64, **z),
        kp_xyz=torch.zeros((f, k, 3), **z),
        kp_xyz_valid=torch.zeros((f, k), dtype=torch.bool, **z),
        frame_id=torch.full((f,), -1, dtype=torch.int64, **z),
        valid=torch.zeros((f,), dtype=torch.bool, **z),
        surf_ctrl=torch.ones((f, nu, nv), **z),
        surf_valid=torch.zeros((f,), dtype=torch.bool, **z),
        surf_dom=dom[None].repeat(f, 1),
        norm_k=torch.zeros((f, k, 2), **z),
        norm_valid=torch.zeros((f, k), dtype=torch.bool, **z),
    )


def empty_points(cfg: Config, device) -> PointStore:
    p = cfg.capacity.max_map_points
    z = dict(device=device)
    return PointStore(
        xyz=torch.zeros((p, 3), **z),
        desc=torch.zeros((p, 8), dtype=torch.int32, **z),
        facet=torch.full((p,), -1, dtype=torch.int64, **z),
        bary=torch.zeros((p, 3), **z),
        ref_kf=torch.full((p,), -1, dtype=torch.int64, **z),
        ref_kp=torch.full((p,), -1, dtype=torch.int64, **z),
        angle=torch.zeros((p,), **z),
        valid=torch.zeros((p,), dtype=torch.bool, **z),
        n_obs=torch.zeros((p,), dtype=torch.int32, **z),
        n_visible=torch.zeros((p,), dtype=torch.int32, **z),
        n_found=torch.zeros((p,), dtype=torch.int32, **z),
        first_kf=torch.zeros((p,), dtype=torch.int32, **z),
        norm_k0=torch.zeros((p, 2), **z),
    )


def add_keyframe(
    kfs: KeyframeStore,
    slot,
    pose: torch.Tensor,
    feats: Features,
    retina: torch.Tensor,
    point_id: torch.Tensor,
    frame_id,
    kp_xyz: torch.Tensor | None = None,
    kp_xyz_valid: torch.Tensor | None = None,
) -> KeyframeStore:
    """Insert a keyframe at ``slot`` (an int or a 0-dim device tensor: no
    host read).  Updates the store's tensors IN PLACE (the JAX package
    donates the store to the same effect) and returns it."""
    put_(kfs.pose, slot, pose)
    put_(kfs.xy, slot, feats.xy)
    put_(kfs.retina, slot, retina)
    put_(kfs.desc, slot, feats.desc)
    put_(kfs.level, slot, feats.level)
    put_(kfs.angle, slot, feats.angle)
    put_(kfs.kp_valid, slot, feats.valid)
    put_(kfs.point_id, slot, point_id)
    put_(kfs.kp_xyz, slot, 0.0 if kp_xyz is None else kp_xyz)
    put_(kfs.kp_xyz_valid, slot, False if kp_xyz_valid is None else kp_xyz_valid)
    put_(kfs.frame_id, slot, frame_id)
    put_(kfs.valid, slot, True)
    put_(kfs.surf_valid, slot, False)
    put_(kfs.norm_valid, slot, False)
    return kfs


def insert_keyframe_from_matches(
    kfs: KeyframeStore,
    n_obs: torch.Tensor,
    slot,
    pose: torch.Tensor,
    feats: Features,
    kp_of_point: torch.Tensor,
    inlier: torch.Tensor,
    K: torch.Tensor,
    frame_id: int,
    points_xyz: torch.Tensor | None = None,
):
    """Invert the frame's point->keypoint matches into the keyframe's
    keypoint->point table, normalize the keypoints to retina coordinates,
    register the matched points' current world positions for the later
    Sim(3) registration (DefKeyFrame.cc:59-74), insert the keyframe at
    ``slot`` (in place) and bump the matched points' observation counts.
    Where two points claim one keypoint the higher point id wins (the
    reference's in-order scatter).  Returns (kfs, n_obs)."""
    p_cap = kp_of_point.shape[0]
    k_cap = feats.capacity
    good = (kp_of_point >= 0) & inlier
    tgt = torch.where(good, torch.clamp(kp_of_point, 0, k_cap - 1), k_cap)
    pid_of_kp = last_writer(tgt, k_cap)  # the writer's position IS the point id
    retina = camera.to_retina(K, feats.xy)
    kp_xyz = kp_xyz_valid = None
    if points_xyz is not None:
        kp_xyz_valid = pid_of_kp >= 0
        kp_xyz = torch.where(
            kp_xyz_valid[:, None], points_xyz[torch.clamp(pid_of_kp, min=0)],
            torch.zeros_like(points_xyz[:1]),
        )
    kfs = add_keyframe(kfs, slot, pose, feats, retina, pid_of_kp, frame_id, kp_xyz, kp_xyz_valid)
    return kfs, n_obs + good.to(n_obs.dtype)
