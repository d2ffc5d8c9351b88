"""SE(3) / SO(3) Lie-group operations on torch tensors.

Port of ``defslam_tpu/geometry/se3.py`` (the subset the tracking path and
the rigid mode use).
Poses are (..., 4, 4) float32 world->camera matrices; solvers optimize a
6-vector increment applied on the left, ``T <- exp(delta) @ T``, ordered
[rho(3), phi(3)].  Small-angle branches use ``torch.where`` on Taylor
expansions, so no function branches on a tensor value on the host.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat map: (..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def _sinc_coeffs(theta2: torch.Tensor):
    """(sin t/t, (1-cos t)/t^2, (t - sin t)/t^3) with Taylor fallbacks near
    zero; theta2 = t^2."""
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / theta2)
    return a, b, c


def _eye3(like: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Exponential map so(3) -> SO(3): (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)
    a, b, _ = _sinc_coeffs(theta2)
    W = hat(w)
    W2 = W @ W
    return _eye3(w, W.shape) + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Logarithm SO(3) -> so(3): (..., 3, 3) -> (..., 3), valid away from
    theta = pi.  theta = atan2(||v||, trace - 1) with the sqrt's input
    replaced by 1 in the small branch (the safe-where pattern), so forward-
    mode derivatives stay finite at theta = 0: essential-graph edges
    between consecutive keyframes are near identity."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    v = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )  # 2 sin(theta) * axis
    v2 = torch.sum(v * v, dim=-1)
    small = v2 < 1e-12
    vnorm = torch.sqrt(torch.where(small, torch.ones_like(v2), v2))
    theta = torch.atan2(vnorm, trace - 1.0)
    scale = torch.where(small, 0.5 + v2 / 48.0, theta / vnorm)
    return scale[..., None] * v


def _rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3].fill_(1.0)  # a Python scalar: no host-to-device copy
    return T


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Exponential map se(3) -> SE(3): (..., 6) [rho, phi] -> (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(phi * phi, dim=-1)
    a, b, c = _sinc_coeffs(theta2)
    W = hat(phi)
    W2 = W @ W
    eye = _eye3(xi, W.shape)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    t = torch.einsum("...ij,...j->...i", V, rho)
    return _rt_to_mat(R, t)


def inverse(T: torch.Tensor) -> torch.Tensor:
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return _rt_to_mat(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def orthonormalize(T: torch.Tensor) -> torch.Tensor:
    """Project the rotation block back onto SO(3) (3 Newton polar steps),
    the per-frame renormalization that keeps composed poses stable."""
    R = T[..., :3, :3]
    for _ in range(3):
        # inv_ex: inv without its error check, a host read of the info
        R = 0.5 * (R + torch.linalg.inv_ex(R.transpose(-1, -2)).inverse)
    return _rt_to_mat(R, T[..., :3, 3])


def transform(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., N, 3) or (..., 3)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    if p.ndim >= 2 and p.shape[-2] != 3:
        return torch.einsum("...ij,...nj->...ni", R, p) + t[..., None, :]
    return torch.einsum("...ij,...j->...i", R, p) + t


def sim3_apply(s: torch.Tensor, R: torch.Tensor, t: torch.Tensor, p: torch.Tensor):
    """p' = s * R @ p + t for points (..., N, 3)."""
    return s[..., None, None] * torch.einsum("...ij,...nj->...ni", R, p) + t[..., None, :]


def sim3_exp(xi: torch.Tensor):
    """sim(3) tangent (..., 7) = [rho(3), phi(3), sigma] -> (s, R, t) by the
    simple retraction s = exp(sigma), R = exp(phi), t = rho (a chart near
    identity: the solvers take small steps)."""
    return torch.exp(xi[..., 6]), so3_exp(xi[..., 3:6]), xi[..., :3]


def horn_alignment(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor):
    """Closed-form weighted Sim(3) alignment (Horn/Umeyama): (s, R, t)
    minimizing sum_i w_i || s R src_i + t - dst_i ||^2.  src, dst (N, 3),
    w (N,) mask or weights.  The sign of det(U) det(Vt) flips the last
    singular direction, so R is a rotation, never a reflection.
    ``torch.linalg.svd`` reads its convergence info on the host: on a
    card, two waits for the stream a call (inside the keyframe step's
    registration, just before its verdict is read)."""
    wsum = torch.clamp(w.sum(), min=_EPS)
    wn = w / wsum
    mu_s = torch.sum(wn[:, None] * src, dim=0)
    mu_d = torch.sum(wn[:, None] * dst, dim=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = (xd * wn[:, None]).T @ xs
    var_s = torch.sum(wn * torch.sum(xs * xs, dim=-1))
    U, D, Vt = torch.linalg.svd(cov)
    sign = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    S = torch.stack([torch.ones_like(sign), torch.ones_like(sign), sign])
    R = (U * S[None, :]) @ Vt
    s = torch.sum(D * S) / torch.clamp(var_s, min=_EPS)
    t = mu_d - s * R @ mu_s
    return s, R, t
