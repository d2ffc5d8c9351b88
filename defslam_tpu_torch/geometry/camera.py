"""Pinhole camera model on torch tensors.

Port of ``defslam_tpu/geometry/camera.py`` (the subset the tracking path
and the GT harness use).  Projection is pure pinhole; lens distortion applies to keypoint
coordinates only (:func:`undistort_points`, wired into the frontend).
"""

from __future__ import annotations

import torch


def project(K: torch.Tensor, pts_cam: torch.Tensor) -> torch.Tensor:
    """Project camera-frame points (..., 3) to pixels (..., 2)."""
    z = pts_cam[..., 2]
    zsafe = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    u = K[0, 0] * pts_cam[..., 0] / zsafe + K[0, 2]
    v = K[1, 1] * pts_cam[..., 1] / zsafe + K[1, 2]
    return torch.stack([u, v], dim=-1)


def backproject(K: torch.Tensor, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) + depth (...) -> camera-frame points (..., 3)."""
    x = (uv[..., 0] - K[0, 2]) / K[0, 0]
    y = (uv[..., 1] - K[1, 2]) / K[1, 1]
    return torch.stack([x * depth, y * depth, depth], dim=-1)


def to_retina(K: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Normalized retina coordinates K^{-1} [u v 1] (z=1 plane)."""
    x = (uv[..., 0] - K[0, 2]) / K[0, 0]
    y = (uv[..., 1] - K[1, 2]) / K[1, 1]
    return torch.stack([x, y], dim=-1)


def undistort_points(
    K: torch.Tensor, dist, uv: torch.Tensor, iters: int = 8
) -> torch.Tensor:
    """Invert the OpenCV radial-tangential distortion on keypoint
    coordinates by OpenCV's fixed-point iteration; dist = (k1, k2, p1, p2,
    k3).  Exact identity when all coefficients are zero."""
    k1, k2, p1, p2, k3 = dist
    xd = (uv[..., 0] - K[0, 2]) / K[0, 0]
    yd = (uv[..., 1] - K[1, 2]) / K[1, 1]
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return torch.stack([K[0, 0] * x + K[0, 2], K[1, 1] * y + K[1, 2]], dim=-1)


def in_image(uv: torch.Tensor, width: int, height: int, margin: float = 0.0):
    return (
        (uv[..., 0] >= margin)
        & (uv[..., 0] < width - margin)
        & (uv[..., 1] >= margin)
        & (uv[..., 1] < height - margin)
    )


def retina_domain(K: torch.Tensor, width: int, height: int, margin: float = 0.10):
    """Retina-plane bounding box of the image with a relative margin,
    (umin, umax, vmin, vmax) as a 4-vector."""
    corners = torch.tensor(
        [[0.0, 0.0], [width - 1.0, 0.0], [0.0, height - 1.0],
         [width - 1.0, height - 1.0]],
        dtype=torch.float32, device=K.device,
    )
    xy = to_retina(K, corners)
    umin, vmin = xy[:, 0].min(), xy[:, 1].min()
    umax, vmax = xy[:, 0].max(), xy[:, 1].max()
    du, dv = umax - umin, vmax - vmin
    return torch.stack(
        [umin - margin * du, umax + margin * du, vmin - margin * dv,
         vmax + margin * dv]
    )
