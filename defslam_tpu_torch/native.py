"""Host bookkeeping of the keyframe chain, in numpy.

Port of ``defslam_tpu/native.py``'s ``covis_shared`` and ``accumulate_obs``
(SchwarpDatabase's covisibility intersection and warp-observation scatter,
SchwarpDatabase.cc:50-128), as its numpy versions.  No path of the System
calls them: the keyframe chain computes both on the device
(``mapping.mapper.covis_pairs``, ``mapper.accumulate_obs_device``).  The
JAX module's third piece, the threaded ``FramePipeline`` image loader, is
``io/prefetch.FramePipeline`` here.
"""

from __future__ import annotations

import numpy as np


def covis_shared(point_id_a: np.ndarray, point_id_b: np.ndarray, max_out: int):
    """Shared points between two keypoint->point tables (-1: no point), in
    increasing point id.  Returns (kp_a, kp_b, pid) int32 arrays of at most
    ``max_out`` entries."""
    a = np.ascontiguousarray(point_id_a, np.int32)
    b = np.ascontiguousarray(point_id_b, np.int32)
    common, ia, ib = np.intersect1d(a[a >= 0], b[b >= 0], return_indices=True)
    kp_a = np.nonzero(a >= 0)[0][ia][:max_out]
    kp_b = np.nonzero(b >= 0)[0][ib][:max_out]
    return kp_a.astype(np.int32), kp_b.astype(np.int32), common[:len(kp_a)].astype(np.int32)


def accumulate_obs(pid: np.ndarray, mask: np.ndarray, uv1: np.ndarray, warped: np.ndarray,
                   J12: np.ndarray, Huu: np.ndarray, Hvv: np.ndarray, n_points: int,
                   obs_cap: int):
    """Scatter per-pair observations ((n_pairs, cap) tables, point id ``pid``,
    kept where ``mask``) into per-point tables of ``obs_cap`` rows, in pair
    then slot order; observations past the cap are dropped.  Returns (dict
    of uv1, uv2, J12, Huu, Hvv, mask shaped (n_points, obs_cap, ...),
    observations kept per point (n_points,) int32)."""
    n_pairs, cap = pid.shape
    out = dict(
        uv1=np.zeros((n_points, obs_cap, 2), np.float32),
        uv2=np.zeros((n_points, obs_cap, 2), np.float32),
        J12=np.tile(np.eye(2, dtype=np.float32), (n_points, obs_cap, 1, 1)),
        Huu=np.zeros((n_points, obs_cap, 2), np.float32),
        Hvv=np.zeros((n_points, obs_cap, 2), np.float32),
        mask=np.zeros((n_points, obs_cap), bool),
    )
    counts = np.zeros(n_points, np.int32)
    for pi in range(n_pairs):
        for j in range(cap):
            p = int(pid[pi, j])
            if not mask[pi, j] or p < 0 or p >= n_points or counts[p] >= obs_cap:
                continue
            o = counts[p]
            out["uv1"][p, o] = uv1[pi, j]
            out["uv2"][p, o] = warped[pi, j]
            out["J12"][p, o] = J12[pi, j]
            out["Huu"][p, o] = Huu[pi, j]
            out["Hvv"][p, o] = Hvv[pi, j]
            out["mask"][p, o] = True
            counts[p] += 1
    return out, counts
