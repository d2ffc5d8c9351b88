"""Isometric-NRSfM normal estimation: batched per-point (k1, k2) solves.

Port of ``defslam_tpu/mapping/normals.py``.  For a map point seen in two
keyframes related by a warp, isometry constrains the log-depth gradient
k = (k1, k2) of the reference view; the surface normal is
n = [k1, k2, 1 - k1 u - k2 v] (NormalEstimator.cc:162-169).

- The scaled metric of a view is G(k; u, v) with T_u/gamma = -k1 [u,v,1] +
  e_u etc.; isometry and the warp eta give G1(k) = (gamma2/gamma1)^2 J^T
  G2(k') J with J = d eta / d(u,v).
- Infinitesimal planarity transfers k through the warp (NormalEstimator.cc:
  199-214): k' = J21 k + [(d t2 - b t1), (a t1 - c t2)] / det(J)^2.
- Normalizing both metrics to unit Frobenius norm removes the unknown scale
  ratio and leaves 3 residuals per pair observation in 2 unknowns.

All points are solved at once by the batched LM of ``ops/lm.py``.  The JAX
package differentiates the residuals with ``jax.jacfwd``; here the 3x2
Jacobian of each observation is written out (``metric_residuals_jac``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.frozen.mapping.warp import DiffProps
from portbench.reference.frozen.ops import lm


class PairObs(NamedTuple):
    """Differential observation of one point through one warp, stackable
    to a (P, O) leading shape."""

    uv1: torch.Tensor  # (..., 2) point in the reference view's retina
    uv2: torch.Tensor  # (..., 2) point in the target view (warp prediction)
    J12: torch.Tensor  # (..., 2, 2)
    Huu: torch.Tensor  # (..., 2)
    Hvv: torch.Tensor  # (..., 2)
    mask: torch.Tensor  # (...,) bool


def pair_obs(dp: DiffProps) -> PairObs:
    return PairObs(uv1=dp.uv1, uv2=dp.warped, J12=dp.J12, Huu=dp.Huu, Hvv=dp.Hvv,
                   mask=dp.mask)


def _transfer_parts(obs: PairObs):
    """(J21 (..., 2, 2), offset (..., 2)) of the affine map k -> k'."""
    a = obs.J12[..., 0, 0]
    c = obs.J12[..., 0, 1]
    b = obs.J12[..., 1, 0]
    d = obs.J12[..., 1, 1]
    det = a * d - c * b
    det = torch.where(det.abs() < 1e-9, torch.full_like(det, 1e-9), det)
    det2 = det * det
    t1 = (-b * obs.Hvv[..., 0] + a * obs.Hvv[..., 1]) / 2.0
    t2 = (d * obs.Huu[..., 0] - c * obs.Huu[..., 1]) / 2.0
    return (a, b, c, d, det), ((d * t2 - b * t1) / det2, (a * t1 - c * t2) / det2)


def transfer_k(k: torch.Tensor, obs: PairObs) -> torch.Tensor:
    """Infinitesimal-planarity transfer of k through the warp: (..., 2) in
    view 1 -> (..., 2) in view 2."""
    (a, b, c, d, det), (o1, o2) = _transfer_parts(obs)
    k1p = (d * k[..., 0] - c * k[..., 1]) / det + o1
    k2p = (-b * k[..., 0] + a * k[..., 1]) / det + o2
    return torch.stack([k1p, k2p], dim=-1)


def _metric(k: torch.Tensor, uv: torch.Tensor, grad: bool = False):
    """Scaled first fundamental form G(k)/gamma^2, (..., 2, 2); with
    ``grad`` also dG/dk, (..., 2 [k1|k2], 2, 2)."""
    u, v = uv[..., 0], uv[..., 1]
    k1, k2 = k[..., 0], k[..., 1]
    e2 = 1.0 + u * u + v * v  # |eta|^2
    tuu = k1 * k1 * e2 - 2.0 * k1 * u + 1.0
    tvv = k2 * k2 * e2 - 2.0 * k2 * v + 1.0
    tuv = k1 * k2 * e2 - k1 * v - k2 * u

    def sym(xx, xy, yy):
        return torch.stack([torch.stack([xx, xy], dim=-1), torch.stack([xy, yy], dim=-1)], dim=-2)

    G = sym(tuu, tuv, tvv)
    if not grad:
        return G
    z = torch.zeros_like(tuu)
    dG = torch.stack(
        [sym(2.0 * k1 * e2 - 2.0 * u, k2 * e2 - v, z),
         sym(z, k1 * e2 - u, 2.0 * k2 * e2 - 2.0 * v)], dim=-3,
    )
    return G, dG


def _pick(D: torch.Tensor) -> torch.Tensor:
    return torch.stack([D[..., 0, 0], D[..., 0, 1], D[..., 1, 1]], dim=-1)


def metric_residuals(k: torch.Tensor, obs: PairObs) -> torch.Tensor:
    """3 isometry residuals per observation (leading dims broadcast): both
    sides of the pullback identity normalized to unit Frobenius norm."""
    G1 = _metric(k, obs.uv1)
    G2 = _metric(transfer_k(k, obs), obs.uv2)
    J = obs.J12
    G2p = J.transpose(-1, -2) @ G2 @ J
    n1 = torch.sqrt(torch.sum(G1 * G1, dim=(-2, -1)) + 1e-12)
    n2 = torch.sqrt(torch.sum(G2p * G2p, dim=(-2, -1)) + 1e-12)
    return _pick(G1 / n1[..., None, None] - G2p / n2[..., None, None])


def metric_residuals_jac(k: torch.Tensor, obs: PairObs):
    """``metric_residuals`` and its Jacobian: (..., 3), (..., 3, 2)."""
    (a, b, c, d, det), _ = _transfer_parts(obs)
    G1, dG1 = _metric(k, obs.uv1, grad=True)
    G2, dG2 = _metric(transfer_k(k, obs), obs.uv2, grad=True)
    J = obs.J12
    Jt = J.transpose(-1, -2)
    G2p = Jt @ G2 @ J
    dG2p_kp = Jt[..., None, :, :] @ dG2 @ J[..., None, :, :]  # wrt k'
    # chain through k' = J21 k + offset, J21 = [[d, -c], [-b, a]] / det
    J21 = torch.stack(
        [torch.stack([d, -c], dim=-1), torch.stack([-b, a], dim=-1)], dim=-2
    ) / det[..., None, None]
    dG2p = torch.einsum("...mij,...mn->...nij", dG2p_kp, J21)

    def unit(G, dG):
        n = torch.sqrt(torch.sum(G * G, dim=(-2, -1)) + 1e-12)
        proj = torch.sum(G[..., None, :, :] * dG, dim=(-2, -1))  # (..., 2)
        n_ = n[..., None, None]
        return G / n_, dG / n_[..., None, :, :] - (
            G[..., None, :, :] * (proj / (n * n * n)[..., None])[..., None, None]
        )

    U1, dU1 = unit(G1, dG1)
    U2, dU2 = unit(G2p, dG2p)
    dD = dU1 - dU2  # (..., 2 params, 2, 2)
    return _pick(U1 - U2), torch.stack([_pick(dD[..., 0, :, :]), _pick(dD[..., 1, :, :])], dim=-1)


class NormalResult(NamedTuple):
    k: torch.Tensor  # (P, 2) solved (k1, k2) per point
    cov: torch.Tensor  # (P, 2, 2) covariance = inv(JtJ)
    cost: torch.Tensor  # (P,)
    n_obs: torch.Tensor  # (P,) number of valid pair observations
    valid: torch.Tensor  # (P,) bool: >= 1 observation and a finite k


def solve_k1k2(obs: PairObs, k_init: torch.Tensor, num_iters: int = 30) -> NormalResult:
    """All points' normals in one batched 2-parameter LM.  ``obs`` has a
    (P, O) leading shape, ``k_init`` is (P, 2)."""
    p = k_init.shape[0]
    m = obs.mask.to(k_init.dtype)

    def residual_jac(x):
        r, J = metric_residuals_jac(x[:, None, :], obs)  # (P, O, 3), (P, O, 3, 2)
        return (r * m[..., None]).reshape(p, -1), (J * m[..., None, None]).reshape(p, -1, 2)

    res = lm.lm_solve(residual_jac, k_init, num_iters=num_iters)
    # cov = inv(JtJ + 1e-10 I), the 2x2 inverse written out: a singular
    # matrix gives inf/NaN (and fails the reliability gate), no exception
    A = res.JtJ
    a00 = A[:, 0, 0] + 1e-10
    a11 = A[:, 1, 1] + 1e-10
    det = a00 * a11 - A[:, 0, 1] * A[:, 1, 0]
    cov = torch.stack(
        [torch.stack([a11, -A[:, 0, 1]], dim=-1), torch.stack([-A[:, 1, 0], a00], dim=-1)],
        dim=-2,
    ) / det[:, None, None]
    n_obs = obs.mask.sum(dim=-1)
    valid = (n_obs >= 1) & torch.isfinite(res.x).all(dim=-1)
    return NormalResult(k=res.x, cov=cov, cost=res.cost, n_obs=n_obs, valid=valid)


def normal_from_k(k: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """n = [k1, k2, 1 - k1 u - k2 v] (NormalEstimator.cc:162-169)."""
    return torch.stack(
        [k[..., 0], k[..., 1], 1.0 - k[..., 0] * uv[..., 0] - k[..., 1] * uv[..., 1]], dim=-1
    )
