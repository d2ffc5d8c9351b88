"""Shape-from-Normals: integrate per-keypoint normals into a depth surface.

Port of ``defslam_tpu/mapping/sfn.py`` (``ShapeFromNormals.{h,cc}``): the
surface is a 1-valued bicubic B-spline gamma(u, v) over the keyframe's
retina domain; each keypoint normal gives two linear rows

    n . (eta dC_u[i] + e_u C[i]) = 0,   n . (eta dC_v[i] + e_v C[i]) = 0

with eta = [u, v, 1], plus a bending penalty and one gauge row fixing the
mean control depth.  The solution is normalized to median control depth 1.
Masked normal equations and one Cholesky solve of the nu*nv system.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.frozen.ops import bspline
from portbench.reference.frozen.utils import linspace, masked_median, psd_solve

# distance damping of the tilt-continuation targets: larger values fade the
# continuation back to flat closer to the supported region
TILT_SHRINK = 0.5


class SfNResult(NamedTuple):
    ctrl: torch.Tensor  # (nu, nv) control depths, median-normalized
    depth: torch.Tensor  # (N,) depth at the keypoints
    xyz: torch.Tensor  # (N, 3) camera-frame surface points gamma [u,v,1]
    ok: torch.Tensor  # () bool: finite solve on >= 3 normals


def _wtw(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return rows.T @ (rows * w[:, None])


def solve(uv: torch.Tensor, normals: torch.Tensor, mask: torch.Tensor, dom: torch.Tensor,
          nu: int, nv: int, bending: torch.Tensor, bending_weight: float,
          mean_depth: float = 1.0, flat_extension: float = 0.0,
          tilt_extension: float = 0.0, ext_dom: torch.Tensor | None = None) -> SfNResult:
    """uv (N, 2) retina keypoints, normals (N, 3), mask (N,) keypoints with
    a valid normal.  ``flat_extension`` > 0 adds weak zero-gradient rows at
    unsupported points of a 16x16 grid over ``ext_dom`` (default ``dom``):
    a linear depth tilt is in the bending penalty's null space, so without
    them the spline extrapolates an arbitrary tilt.  ``tilt_extension`` > 0
    replaces the zero target by a distance-shrunk continuation of the
    supported region's own inverse-depth slope, found in two re-solves with
    the same normal matrix."""
    k = nu * nv
    n = normals / torch.clamp(torch.linalg.norm(normals, dim=-1, keepdim=True), min=1e-9)
    u, v = uv[:, 0], uv[:, 1]
    C = bspline.coloc_2d(u, v, dom, nu, nv)
    Cu = bspline.coloc_2d(u, v, dom, nu, nv, 1, 0)
    Cv = bspline.coloc_2d(u, v, dom, nu, nv, 0, 1)
    eta_n = n[:, 0] * u + n[:, 1] * v + n[:, 2]  # n . [u, v, 1]
    row_u = eta_n[:, None] * Cu + n[:, 0:1] * C
    row_v = eta_n[:, None] * Cv + n[:, 1:2] * C
    w = mask.to(C.dtype)

    # normal equations of [rows_u; rows_v; lambda B; gauge]
    AtA = _wtw(row_u, w) + _wtw(row_v, w) + (bending_weight**2) * (bending @ bending)
    ones = torch.ones(k, dtype=C.dtype, device=C.device)
    tilt = None
    if flat_extension > 0.0:
        edom = dom if ext_dom is None else ext_dom
        g = 16
        GU, GV = torch.meshgrid(
            linspace(edom[0], edom[1], g), linspace(edom[2], edom[3], g), indexing="ij"
        )
        gq = torch.stack([GU.reshape(-1), GV.reshape(-1)], dim=-1)  # (G, 2)
        cell2 = ((dom[1] - dom[0]) / (nu - 3)) ** 2 + ((dom[3] - dom[2]) / (nv - 3)) ** 2
        d2 = torch.sum((gq[:, None, :] - uv[None, :, :]) ** 2, dim=-1)
        # support: soft RBF coverage by valid-normal keypoints, one cell wide
        support = torch.clamp(torch.sum(torch.exp(-d2 / cell2) * w[None, :], dim=1), max=1.0)
        wf = flat_extension * (1.0 - support)  # (G,)
        Gu = bspline.coloc_2d(gq[:, 0], gq[:, 1], dom, nu, nv, 1, 0)
        Gv = bspline.coloc_2d(gq[:, 0], gq[:, 1], dom, nu, nv, 0, 1)
        AtA = AtA + _wtw(Gu, wf * wf) + _wtw(Gv, wf * wf)
        if tilt_extension > 0.0:
            # the normal rows give gamma_u / gamma = -n_u / (n.eta); a plane
            # is linear in 1/gamma, so 1/gamma is continued at the supported
            # region's kernel-averaged slope.  Clipped against grazing rays.
            safe = torch.where(eta_n.abs() > 1e-3, eta_n, torch.full_like(eta_n, 1e-3))
            s_u = torch.clamp(-n[:, 0] / safe, -2.0, 2.0)
            s_v = torch.clamp(-n[:, 1] / safe, -2.0, 2.0)
            ker = torch.exp(-d2 / (4.0 * cell2)) * w[None, :]  # (G, N), 4 cells wide
            ksum = torch.clamp(torch.sum(ker, dim=1), min=1e-6)
            shrink = tilt_extension * ksum / (ksum + TILT_SHRINK)
            G0 = bspline.coloc_2d(gq[:, 0], gq[:, 1], dom, nu, nv)
            tilt = (G0, Gu, Gv, wf, ker, ksum, shrink, s_u, s_v)
    AtA = AtA + torch.outer(ones, ones)
    base_rhs = ones * (k * mean_depth)

    def _normalize(ctrl):
        med = masked_median(ctrl, torch.ones_like(ctrl, dtype=torch.bool))
        return ctrl * torch.where(med.abs() > 1e-9, 1.0 / med, torch.ones_like(med))

    # pass 0: flat targets; the final answer when tilt_extension == 0
    ctrl = _normalize(psd_solve(AtA, base_rhs, jitter=1e-7 * k))
    if tilt is not None:
        G0, Gu, Gv, wf, ker, ksum, shrink, s_u, s_v = tilt
        for _ in range(2):
            g_kp = torch.clamp(C @ ctrl, 0.3, 3.0)
            sig_u = (ker @ (s_u / g_kp)) / ksum
            sig_v = (ker @ (s_v / g_kp)) / ksum
            g_est = torch.clamp(G0 @ ctrl, 0.3, 3.0)
            tgt_u = shrink * sig_u * g_est * g_est
            tgt_v = shrink * sig_v * g_est * g_est
            rhs2 = base_rhs + Gu.T @ (wf * wf * tgt_u) + Gv.T @ (wf * wf * tgt_v)
            ctrl = _normalize(psd_solve(AtA, rhs2, jitter=1e-7 * k))
    depth = C @ ctrl
    xyz = torch.stack([u * depth, v * depth, depth], dim=-1)
    ok = torch.isfinite(ctrl).all() & (mask.sum() >= 3)
    return SfNResult(ctrl=ctrl.reshape(nu, nv), depth=depth, xyz=xyz, ok=ok)
