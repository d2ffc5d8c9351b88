"""Keyframe-to-keyframe spline warps ("Schwarps").

Port of ``defslam_tpu/mapping/warp.py``.  A warp KF1 -> KF2 is a 2-valued
bicubic B-spline over KF1's retina domain.  Init is a closed-form ridge fit
of the displacement field; refinement is a short damped LM over the control
values whose data term is linear (constant Jacobian, precomputed) and whose
regularizer keeps the warp locally projective: at each colocation point the
homography's perspective vector g is eliminated in closed form and the
remaining Hessian inconsistency ``H_k + g grad_k^T + grad_k g^T`` is
penalized.  The differential properties NRSfM consumes are spline
evaluations at the matched keypoints.

``fit_initial``, ``refine`` and ``diff_props`` take a leading pair
dimension where the JAX package ``vmap``s over pairs; all pairs share one
domain.  The regularizer's Jacobian is the chain of a pointwise 8x10
Jacobian (forward mode, ``torch.func``) with the constant colocation
matrices of the five derivative orders.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from defslam_tpu_torch.ops import bspline
from defslam_tpu_torch.utils import device_constant

# derivative orders (du, dv) the projectivity residual reads, in z's order
_DERIVS = ((1, 0), (0, 1), (2, 0), (1, 1), (0, 2))


class DiffProps(NamedTuple):
    """Differential properties of a warp at N matched points.
    J12 = [[a, c], [b, d]] = d(u2,v2)/d(u1,v1)."""

    uv1: torch.Tensor  # (..., N, 2) retina coords in KF1
    uv2: torch.Tensor  # (..., N, 2) observed retina coords in KF2
    warped: torch.Tensor  # (..., N, 2) warp(uv1)
    J12: torch.Tensor  # (..., N, 2, 2)
    J21: torch.Tensor  # (..., N, 2, 2)
    Huu: torch.Tensor  # (..., N, 2) d2(u2,v2)/du1^2
    Huv: torch.Tensor  # (..., N, 2)
    Hvv: torch.Tensor  # (..., N, 2)
    mask: torch.Tensor  # (..., N) bool


def identity_ctrl(dom: torch.Tensor, nu: int, nv: int) -> torch.Tensor:
    """Control points of the identity warp (Greville abscissae), (nu, nv, 2)."""
    gu = dom[0] + (torch.arange(nu, device=dom.device) - 1.0) * (dom[1] - dom[0]) / (nu - 3)
    gv = dom[2] + (torch.arange(nv, device=dom.device) - 1.0) * (dom[3] - dom[2]) / (nv - 3)
    U, V = torch.meshgrid(gu, gv, indexing="ij")
    return torch.stack([U, V], dim=-1)


def fit_initial(uv1: torch.Tensor, uv2: torch.Tensor, w: torch.Tensor, dom: torch.Tensor,
                nu: int, nv: int, bending: torch.Tensor, bending_weight: float) -> torch.Tensor:
    """Closed-form warp init (Warp::initialize): a bending-regularized
    ridge fit of the displacement uv2 - uv1, so the prior pulls toward the
    identity warp, plus the identity control points.  uv1, uv2 (..., N, 2),
    w (..., N) -> (..., nu, nv, 2)."""
    dctrl = bspline.fit_ridge(
        uv1[..., 0], uv1[..., 1], uv2 - uv1, dom, nu, nv, bending_weight,
        weights=w, bending=bending,
    )
    return identity_ctrl(dom, nu, nv) + dctrl


def _coloc_grid(dom: torch.Tensor, nu: int, nv: int):
    """Colocation points of the projectivity regularizer: cell centers."""
    nun, nvn = nu - 3, nv - 3
    cu = dom[0] + (torch.arange(nun, device=dom.device) + 0.5) * (dom[1] - dom[0]) / nun
    cv = dom[2] + (torch.arange(nvn, device=dom.device) + 0.5) * (dom[3] - dom[2]) / nvn
    U, V = torch.meshgrid(cu, cv, indexing="ij")
    return U.reshape(-1), V.reshape(-1)


def _projectivity_point(z: torch.Tensor) -> torch.Tensor:
    """Local-projectivity violation of one point from its derivatives
    z (..., 5, 2) = [d10, d01, d20, d11, d02] x [u2, v2 component] ->
    (..., 8) = R[comp, i, j] flattened."""
    d10, d01, d20, d11, d02 = (z[..., i, :] for i in range(5))
    grad = torch.stack([d10, d01], dim=-1)  # (..., comp, d/du|d/dv)
    H = torch.stack(
        [torch.stack([d20, d11], dim=-1), torch.stack([d11, d02], dim=-1)], dim=-2
    )  # (..., comp, i, j)
    # min_g sum_k || H_k + g grad_k^T + grad_k g^T ||_F^2: a 2x2 system
    gg = torch.einsum("...ki,...kj->...ij", grad, grad)
    g2 = torch.einsum("...ki,...ki->...", grad, grad)
    rhs = -torch.einsum("...kij,...kj->...i", H, grad)
    # (the floor is a tensor: under forward-mode autodiff a Python float
    # added to a 0-dim tensor promotes the result to float64)
    diag = g2 + torch.full_like(g2, 1e-8)
    m00 = gg[..., 0, 0] + diag
    m11 = gg[..., 1, 1] + diag
    m01, m10 = gg[..., 0, 1], gg[..., 1, 0]
    det = m00 * m11 - m01 * m10
    g = torch.stack(
        [(m11 * rhs[..., 0] - m01 * rhs[..., 1]) / det,
         (m00 * rhs[..., 1] - m10 * rhs[..., 0]) / det], dim=-1,
    )
    R = (H + torch.einsum("...i,...kj->...kij", g, grad)
         + torch.einsum("...ki,...j->...kij", grad, g))
    return R.reshape(R.shape[:-3] + (8,))


def _deriv_colocs(qu: torch.Tensor, qv: torch.Tensor, dom: torch.Tensor, nu: int, nv: int):
    """(5, Q, nu*nv) colocation matrices of the five derivative orders."""
    return torch.stack([bspline.coloc_2d(qu, qv, dom, nu, nv, du, dv) for du, dv in _DERIVS])


def projectivity_residuals(ctrl: torch.Tensor, qu: torch.Tensor, qv: torch.Tensor,
                           dom: torch.Tensor) -> torch.Tensor:
    """Per-colocation-point local-projectivity violation, 8 values a point
    (the symmetric entry appears twice): zero iff the warp is locally a
    homography.  ctrl (nu, nv, 2) -> (Q*8,); (B, nu, nv, 2) -> (B, Q*8)."""
    nu, nv = ctrl.shape[-3], ctrl.shape[-2]
    Cd = _deriv_colocs(qu, qv, dom, nu, nv)
    z = torch.einsum("dqk,...kc->...qdc", Cd, ctrl.reshape(ctrl.shape[:-3] + (nu * nv, 2)))
    r = _projectivity_point(z)
    return r.reshape(r.shape[:-2] + (-1,))


def projectivity_jacobian(ctrl: torch.Tensor, Cd: torch.Tensor):
    """Residuals and their Jacobian w.r.t. the flattened control values.
    ctrl (B, nu, nv, 2), Cd (5, Q, K) -> r (B, Q*8), J (B, Q*8, 2K)."""
    b, nu, nv, _ = ctrl.shape
    k = nu * nv
    z = torch.einsum("dqk,bkc->bqdc", Cd, ctrl.reshape(b, k, 2))
    q = z.shape[1]
    zf = z.reshape(b * q, 5, 2)
    r = _projectivity_point(zf)
    dfdz = torch.func.vmap(torch.func.jacfwd(_projectivity_point))(zf)  # (BQ, 8, 5, 2)
    J = torch.einsum("bqrdc,dqk->bqrkc", dfdz.reshape(b, q, 8, 5, 2), Cd)
    return r.reshape(b, q * 8), J.reshape(b, q * 8, 2 * k)


def refine(ctrl0: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor, w: torch.Tensor,
           dom: torch.Tensor, reg_weight: float, fx: float, fy: float,
           num_iters: int = 3) -> torch.Tensor:
    """LM refinement of the warps (SchwarpDatabase.cc:199-222): data term
    in pixel units through fx/fy plus the projectivity regularizer.  The
    data term is linear in the control points, so its Jacobian and normal
    matrix are computed once.  ctrl0 (B, nu, nv, 2), uv1, uv2 (B, N, 2),
    w (B, N) -> (B, nu, nv, 2)."""
    b, nu, nv, _ = ctrl0.shape
    k = nu * nv
    k2 = 2 * k
    qu, qv = _coloc_grid(dom, nu, nv)
    n_q = qu.shape[0]
    pix = device_constant(("pix", fx, fy), lambda: [fx, fy], ctrl0.device, ctrl0.dtype)
    lam_r = (reg_weight / (8.0 * n_q)) ** 0.5
    Cd = _deriv_colocs(qu, qv, dom, nu, nv)

    C = bspline.coloc_2d(uv1[..., 0], uv1[..., 1], dom, nu, nv)  # (B, N, K)
    CtC = (C * (w * w)[..., None]).transpose(-1, -2) @ C  # (B, K, K)
    # H_data[(i,c),(j,c')] = delta_cc' pix_c^2 CtC[i,j]
    H_data = (
        CtC[:, :, None, :, None] * torch.diag(pix * pix)[None, None, :, None, :]
    ).reshape(b, k2, k2)
    y = uv2 * pix * w[..., None]

    def data_parts(x):
        r = (C @ x.reshape(b, k, 2)) * pix * w[..., None] - y
        g = C.transpose(-1, -2) @ (r * pix * w[..., None])  # (B, K, 2)
        return r.reshape(b, -1), g.reshape(b, k2)

    def cost_of(x):
        rd, _ = data_parts(x)
        rr = lam_r * projectivity_residuals(x.reshape(b, nu, nv, 2), qu, qv, dom)
        return 0.5 * (torch.sum(rd * rd, dim=-1) + torch.sum(rr * rr, dim=-1))

    x = ctrl0.reshape(b, k2)
    lam = torch.full((b,), 1e-4, dtype=x.dtype, device=x.device)
    cost = cost_of(x)
    for _ in range(num_iters):
        _, g_d = data_parts(x)
        rr, Jr = projectivity_jacobian(x.reshape(b, nu, nv, 2), Cd)
        rr, Jr = lam_r * rr, lam_r * Jr
        H = H_data + Jr.transpose(-1, -2) @ Jr
        g = g_d + (Jr.transpose(-1, -2) @ rr[..., None])[..., 0]
        D = torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1) + 1e-9)
        L, info = torch.linalg.cholesky_ex(H + lam[:, None, None] * D)
        dx = -torch.cholesky_solve(g[..., None], L)[..., 0]
        dx = torch.where((info == 0)[:, None] & torch.isfinite(dx), dx, torch.zeros_like(dx))
        x_new = x + dx
        c_new = cost_of(x_new)
        accept = (c_new < cost) & torch.isfinite(c_new)
        x = torch.where(accept[:, None], x_new, x)
        cost = torch.where(accept, c_new, cost)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e8)
    return x.reshape(b, nu, nv, 2)


def diff_props(ctrl: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor, mask: torch.Tensor,
               dom: torch.Tensor, fx: float, fy: float, max_err_px: float) -> DiffProps:
    """Warp value and 1st/2nd derivatives at the matched points, gated by
    the pixel reprojection error (SchwarpDatabase.cc:246-292).  ctrl
    (nu, nv, 2) with (N, ...) points, or (B, nu, nv, 2) with (B, N, ...)."""
    u, v = uv1[..., 0], uv1[..., 1]
    val = bspline.evaluate(ctrl, u, v, dom)
    du = bspline.evaluate(ctrl, u, v, dom, 1, 0)  # (a, b)
    dv = bspline.evaluate(ctrl, u, v, dom, 0, 1)  # (c, d)
    huu = bspline.evaluate(ctrl, u, v, dom, 2, 0)
    huv = bspline.evaluate(ctrl, u, v, dom, 1, 1)
    hvv = bspline.evaluate(ctrl, u, v, dom, 0, 2)
    J12 = torch.stack([du, dv], dim=-1)  # [[a, c], [b, d]]
    det = J12[..., 0, 0] * J12[..., 1, 1] - J12[..., 0, 1] * J12[..., 1, 0]
    det = torch.where(det.abs() < 1e-9, torch.full_like(det, 1e-9), det)
    J21 = torch.stack(
        [torch.stack([J12[..., 1, 1], -J12[..., 0, 1]], dim=-1),
         torch.stack([-J12[..., 1, 0], J12[..., 0, 0]], dim=-1)], dim=-2,
    ) / det[..., None, None]
    pix = device_constant(("pix", fx, fy), lambda: [fx, fy], val.device, val.dtype)
    err = torch.linalg.norm((val - uv2) * pix, dim=-1)
    return DiffProps(uv1=uv1, uv2=uv2, warped=val, J12=J12, J21=J21,
                     Huu=huu, Huv=huv, Hvv=hvv, mask=mask & (err <= max_err_px))
