"""Oriented-BRIEF (ORB) orientation + descriptors on torch tensors.

Port of ``defslam_tpu/ops/orb.py::orient_describe_stack``.  The TPU version
extracts patches and BRIEF samples with one-hot matmuls because scalar
gathers were slow there; here plain gathers give the identical values
(each one-hot product selects a single element).

Descriptors are (K, 8) int32 words holding the same 32 bits as the JAX
package's uint32 words (torch has no shifts on uint32): bit i of word w is
BRIEF test 32 w + i.  Convert at the boundary with ``ndarray.view``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from defslam_tpu_torch.utils import device_constant

HALF_PATCH = 15  # orientation patch radius, reference ORBextractor.cc
PATTERN_CLIP = 13  # BRIEF sample coordinate range
PATCH_R = 19  # covers the orientation disc (15) and the rotated BRIEF reach
PATCH = 2 * PATCH_R + 1


@functools.lru_cache(maxsize=1)
def brief_pattern() -> np.ndarray:
    """(256, 2, 2) int32: 256 point pairs (x, y) in [-13, 13], drawn from the
    classic BRIEF recipe with a fixed seed (same values as the JAX
    package)."""
    rng = np.random.default_rng(20240817)
    pts = rng.normal(0.0, (2 * PATTERN_CLIP + 1) / 5.0, size=(256, 2, 2))
    return np.clip(np.round(pts), -PATTERN_CLIP, PATTERN_CLIP).astype(np.int32)


@functools.lru_cache(maxsize=1)
def _circle_offsets():
    """Offsets and mask of the radius-15 orientation disc."""
    r = HALF_PATCH
    dy, dx = np.mgrid[-r : r + 1, -r : r + 1]
    mask = (dx * dx + dy * dy) <= r * r
    return dy.astype(np.int32), dx.astype(np.int32), mask.astype(np.float32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) bool -> (N, 8) int32 words (bit i of word w = test 32w+i),
    packed in int64 and bit-cast to int32."""
    n = bits.shape[0]
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = (bits.reshape(n, 8, 32).to(torch.int64) << shifts).sum(dim=-1)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def orient_describe_stack(
    raw: torch.Tensor,  # (L, H, W) f32 padded pyramid canvas
    blur: torch.Tensor,  # (L, H, W) f32 blurred canvas
    lv: torch.Tensor,  # (N,) int64 canvas index per keypoint
    xy: torch.Tensor,  # (N, 2) f32 integer-valued level coords
    level_hw: torch.Tensor,  # (L, 2) int64 true (h, w) of each level
) -> tuple[torch.Tensor, torch.Tensor]:
    """Intensity-centroid orientation + steered BRIEF for keypoints of all
    pyramid levels in one pass, sampling clipped to each level's edge.
    Returns (angle (N,) f32, desc (N, 8) int32)."""
    dev = raw.device
    cx = torch.round(xy[:, 0]).long()
    cy = torch.round(xy[:, 1]).long()
    h_l = level_hw[lv, 0]
    w_l = level_hw[lv, 1]
    dr = torch.arange(-PATCH_R, PATCH_R + 1, device=dev)
    rows = torch.minimum(torch.clamp(cy[:, None] + dr[None], min=0), (h_l - 1)[:, None])
    cols = torch.minimum(torch.clamp(cx[:, None] + dr[None], min=0), (w_l - 1)[:, None])
    li = lv[:, None, None]
    ri = rows[:, :, None]
    ci = cols[:, None, :]
    patch_raw = raw[li, ri, ci]  # (N, P, P)
    patch_blur = blur[li, ri, ci]

    dy31, dx31, mask31 = _circle_offsets()
    s = PATCH_R - HALF_PATCH
    raw31 = patch_raw[:, s : s + 31, s : s + 31].reshape(-1, 31 * 31)
    wx = device_constant("orb_moment_x", lambda: (dx31 * mask31).reshape(-1), dev, torch.float32)
    wy = device_constant("orb_moment_y", lambda: (dy31 * mask31).reshape(-1), dev, torch.float32)
    m10 = raw31 @ wx
    m01 = raw31 @ wy
    angle = torch.atan2(m01, m10)

    # steered BRIEF: in-patch index = round(xy + r) - (c - R), clipped
    pat = device_constant("brief_pattern", brief_pattern, dev, torch.float32)
    ca, sa = torch.cos(angle), torch.sin(angle)
    px = pat[..., 0].reshape(-1)  # (512,)
    py = pat[..., 1].reshape(-1)
    rx = ca[:, None] * px[None] - sa[:, None] * py[None]
    ry = sa[:, None] * px[None] + ca[:, None] * py[None]
    jx = torch.clamp(
        torch.round(xy[:, 0, None] + rx).long() - (cx - PATCH_R)[:, None], 0, PATCH - 1
    )
    jy = torch.clamp(
        torch.round(xy[:, 1, None] + ry).long() - (cy - PATCH_R)[:, None], 0, PATCH - 1
    )
    n = xy.shape[0]
    vals = patch_blur.reshape(n, -1).gather(1, jy * PATCH + jx)  # (N, 512)
    vp = vals.reshape(n, 256, 2)
    return angle, pack_bits(vp[..., 0] < vp[..., 1])
