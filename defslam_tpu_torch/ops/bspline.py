"""Uniform bicubic B-spline surfaces on torch tensors.

Port of ``defslam_tpu/ops/bspline.py``.  Control grids are small (13x15),
so colocation matrices are dense and every spline operation is a small
matmul or a 4x4-window gather.  A spline with ``n`` basis functions along
an axis over ``[lo, hi]`` has ``n - 3`` uniform knot intervals; the cubic
basis window at cell ``i`` covers control points ``i .. i+3``.

``evaluate`` and ``coloc_2d`` accept one leading batch dimension on the
query points (and on the control grid), where the JAX package uses
``vmap``; the domain is shared by the batch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from defslam_tpu_torch.utils import device_constant, psd_solve

# 4x4 uniform cubic B-spline coefficient matrix: basis_j(t) = sum_k M[j,k] t^k
_M = np.array(
    [[1, -3, 3, -1], [4, 0, -6, 3], [1, 3, 3, -3], [0, 0, 0, 1]], dtype=np.float64
) / 6.0
# derivative on the polynomial coefficients: (M @ _D)[j, k] = (k+1) M[j, k+1]
_D = np.array(
    [[0, 0, 0, 0], [1, 0, 0, 0], [0, 2, 0, 0], [0, 0, 3, 0]], dtype=np.float64
)


def _basis_matrix_np(order: int) -> np.ndarray:
    m = _M
    for _ in range(order):
        m = m @ _D
    return m


def _locate(x: torch.Tensor, lo, hi, n: int):
    """Coordinates -> (cell index int64, local parameter t, cell width)."""
    nint = n - 3
    h = (hi - lo) / nint
    s = (x - lo) / h
    i = torch.clamp(torch.floor(s), 0, nint - 1)
    return i.long(), s - i, h


def basis_1d(x: torch.Tensor, lo, hi, n: int, order: int = 0):
    """The 4 active cubic basis functions (or their ``order``-th
    derivative) at ``x``.  Returns (idx (...,), w (..., 4)): weights of
    control points idx..idx+3, scaled by the chain-rule factor h^-order."""
    i, t, h = _locate(x, lo, hi, n)
    m = device_constant(("bspline_basis", order), lambda: _basis_matrix_np(order), x.device,
                        torch.float32)
    tt = t[..., None]
    w = m[:, 3] * tt  # Horner
    w = (w + m[:, 2]) * tt
    w = (w + m[:, 1]) * tt
    w = w + m[:, 0]
    return i, w / (h**order)


def coloc_1d(x: torch.Tensor, lo, hi, n: int, order: int = 0) -> torch.Tensor:
    """Dense 1D colocation matrix (..., n): row r holds the ``order``-th
    derivative of the basis functions at x[r]."""
    i, w = basis_1d(x, lo, hi, n, order)
    out = torch.zeros(x.shape + (n,), dtype=w.dtype, device=x.device)
    cols = i[..., None] + torch.arange(4, device=x.device)
    return out.scatter_(-1, cols, w)  # the 4 columns of a row are distinct


def coloc_2d(u: torch.Tensor, v: torch.Tensor, dom: torch.Tensor, nu: int, nv: int,
             du: int = 0, dv: int = 0) -> torch.Tensor:
    """Dense 2D colocation matrix (..., N, nu*nv) for the mixed derivative
    (du, dv); ``dom`` = [umin, umax, vmin, vmax].  ``coloc_2d(...) @
    ctrl.reshape(-1, C)`` evaluates the surface at the N points."""
    cu = coloc_1d(u, dom[0], dom[1], nu, du)
    cv = coloc_1d(v, dom[2], dom[3], nv, dv)
    return (cu[..., :, None] * cv[..., None, :]).reshape(u.shape + (nu * nv,))


def evaluate(ctrl: torch.Tensor, u: torch.Tensor, v: torch.Tensor, dom: torch.Tensor,
             du: int = 0, dv: int = 0) -> torch.Tensor:
    """Evaluate a spline at points by gathering each point's 4x4 control
    window.  Unbatched: ctrl (nu, nv) or (nu, nv, C), u, v (N,) -> (N,) or
    (N, C).  Batched: ctrl (B, nu, nv, C), u, v (B, N) or (N,) -> (B, N, C).
    """
    batched = ctrl.ndim == 4
    squeeze = ctrl.ndim == 2
    if squeeze:
        ctrl = ctrl[..., None]
    if not batched:
        ctrl, u, v = ctrl[None], u[None], v[None]
    b, nu, nv, c = ctrl.shape
    if u.ndim == 1:
        u, v = u.expand(b, -1), v.expand(b, -1)
    iu, wu = basis_1d(u, dom[0], dom[1], nu, du)  # (B, N), (B, N, 4)
    iv, wv = basis_1d(v, dom[2], dom[3], nv, dv)
    off = torch.arange(4, device=u.device)
    idx = (iu[..., None] + off)[..., :, None] * nv + (iv[..., None] + off)[..., None, :]
    n = u.shape[1]
    flat = ctrl.reshape(b, nu * nv, c)
    window = torch.gather(
        flat, 1, idx.reshape(b, n * 16, 1).expand(-1, -1, c)
    ).reshape(b, n, 4, 4, c)
    out = torch.einsum("bni,bnj,bnijc->bnc", wu, wv, window)
    if not batched:
        out = out[0]
    return out[..., 0] if squeeze else out


@functools.lru_cache(maxsize=64)
def _gauss_legendre(npts: int):
    x, w = np.polynomial.legendre.leggauss(npts)
    return (x + 1.0) / 2.0, w / 2.0  # remapped to [0, 1]


def _coloc_1d_np(x: np.ndarray, lo: float, hi: float, n: int, order: int):
    """float64 numpy twin of coloc_1d, for host-side precomputation."""
    nint = n - 3
    h = (hi - lo) / nint
    s = (x - lo) / h
    i = np.clip(np.floor(s), 0, nint - 1).astype(np.int64)
    t = s - i
    m = _basis_matrix_np(order)
    powers = np.stack([np.ones_like(t), t, t * t, t**3], axis=-1)
    w = powers @ m.T / h**order  # (N, 4)
    C = np.zeros((len(x), n))
    np.add.at(C, (np.arange(len(x))[:, None], i[:, None] + np.arange(4)), w)
    return C


def _bending_terms_np(dom: np.ndarray, nu: int, nv: int, n_quad: int):
    """The three quadrature sums (f_uu^2, 2 f_uv^2, f_vv^2) over ``dom`` in
    float64: entries are O(h^-4) and smooth surfaces rely on cancellation
    float32 cannot hold."""
    nint_u, nint_v = nu - 3, nv - 3
    hu = (dom[1] - dom[0]) / nint_u
    hv = (dom[3] - dom[2]) / nint_v
    q, qw = _gauss_legendre(n_quad)
    uu = (dom[0] + hu * (np.arange(nint_u)[:, None] + q[None, :])).reshape(-1)
    vv = (dom[2] + hv * (np.arange(nint_v)[:, None] + q[None, :])).reshape(-1)
    U, V = np.meshgrid(uu, vv, indexing="ij")
    W = np.outer(np.tile(qw * hu, nint_u), np.tile(qw * hv, nint_v)).reshape(-1)
    out = []
    for du, dv, fac in ((2, 0, 1.0), (1, 1, 2.0), (0, 2, 1.0)):
        Cu = _coloc_1d_np(U.reshape(-1), dom[0], dom[1], nu, du)
        Cv = _coloc_1d_np(V.reshape(-1), dom[2], dom[3], nv, dv)
        Cm = (Cu[:, :, None] * Cv[:, None, :]).reshape(-1, nu * nv)
        out.append(fac * np.einsum("q,qi,qj->ij", W, Cm, Cm))
    return out


def bending_matrix(dom, nu: int, nv: int, n_quad: int = 3, device=None) -> torch.Tensor:
    """Dense bending-energy matrix B (nu*nv, nu*nv): c^T B c is the
    integral of f_uu^2 + 2 f_uv^2 + f_vv^2 over the domain (BBS
    ``BendingEigen``).  Gauss-Legendre per knot cell, exact for n_quad >= 3;
    computed on the host once per domain."""
    dom_np = np.asarray(torch.as_tensor(dom).detach().cpu(), dtype=np.float64)
    B = sum(_bending_terms_np(dom_np, nu, nv, n_quad))
    return torch.as_tensor(0.5 * (B + B.T), dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=8)
def _bending_components_np(nu: int, nv: int, n_quad: int):
    unit = np.asarray([0.0, 1.0, 0.0, 1.0])
    return tuple(
        (0.5 * (B + B.T)).astype(np.float32)
        for B in _bending_terms_np(unit, nu, nv, n_quad)
    )


def bending_components(nu: int, nv: int, n_quad: int = 3, device=None):
    """Unit-domain bending components (B20, B11, B02), B11 carrying its
    factor 2.  For the domain [a,b]x[c,d] with su = b-a, sv = d-c,
    B(dom) = (sv/su^3) B20 + (1/(su sv)) B11 + (su/sv^3) B02 exactly."""
    return tuple(torch.as_tensor(B, device=device) for B in _bending_components_np(nu, nv, n_quad))


def bending_matrix_dyn(dom: torch.Tensor, nu: int, nv: int) -> torch.Tensor:
    """Bending matrix of a domain held on the device: the exact rescale of
    the three unit-domain components, no host read."""
    B20, B11, B02 = bending_components(nu, nv, device=dom.device)
    su = dom[1] - dom[0]
    sv = dom[3] - dom[2]
    return (sv / su**3) * B20 + (1.0 / (su * sv)) * B11 + (su / sv**3) * B02


def fit_ridge(u: torch.Tensor, v: torch.Tensor, values: torch.Tensor, dom: torch.Tensor,
              nu: int, nv: int, bending_weight: float,
              weights: torch.Tensor | None = None,
              bending: torch.Tensor | None = None) -> torch.Tensor:
    """Closed-form bending-regularized least-squares spline fit: min_c
    |W^(1/2)(A c - y)|^2 + lambda c^T B c (Warp::initialize's normal
    system).  u, v (..., N), values (..., N, C) -> ctrl (..., nu, nv, C)."""
    A = coloc_2d(u, v, dom, nu, nv)
    k = nu * nv
    if weights is None:
        weights = torch.ones_like(u)
    B = bending if bending is not None else bending_matrix(dom, nu, nv, device=u.device)
    wA_t = (A * weights[..., None]).transpose(-1, -2)
    AtA = wA_t @ A + bending_weight * B
    # float32 conditioning floor: unsupported basis functions make AtA
    # near-singular; a trace-scaled ridge keeps the solve stable
    ridge = 1e-6 * torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1) / k
    AtA = AtA + ridge[..., None, None] * torch.eye(k, dtype=A.dtype, device=A.device)
    Aty = wA_t @ values
    # the system is symmetric positive definite by construction: Cholesky
    # (the reference's LU solve gives the same answer up to rounding)
    ctrl = psd_solve(AtA, Aty)
    return ctrl.reshape(u.shape[:-1] + (nu, nv, values.shape[-1]))
