"""Two-view monocular initialization: batched H/F RANSAC on torch tensors.

Port of ``defslam_tpu/rigid/initializer.py`` (the reference's
``Initializer``, ``Thirdparty/ORBSLAM_2/src/Initializer.cc:44-733``): all
200 homography DLTs are one (200, 16, 9) SVD, all 200 fundamental DLTs one
(200, 8, 9) SVD plus a rank-2 projection, scoring is a (200, N) residual
reduction, and the 8 Faugeras homography motions and the 4 essential
motions are scored as one stacked 12-hypothesis cheirality check.

The draw is split from the solve.  The JAX package draws its sample sets
inside the solve with ``jax.random.choice(key, n, (200, 8), p=mask/sum)``;
:func:`draw_sets` turns (200, 8) uniforms into the same sets by the same
formula (an inverse-CDF search of the cumulative mask), and
:func:`two_view_init` takes the sets as an input.  Handed the uniforms
``jax.random.uniform`` gives for a key, the port draws that key's sets.

Singular vectors have no fixed sign, and LAPACK and cuSOLVER may order the
8 H and 4 E motions differently; the chosen motion, its count and the
model choice are the same, the index of the hypothesis may not be.  Every
arg-max takes the first maximum, as ``jnp.argmax`` does.  A failed
inverse gives NaN (``utils.inv_nan``), as in JAX, never an exception.

Parity thresholds (the reference's): RH = SH/(SH+SF) > 0.40 -> homography
(Initializer.cc:115); chi2 5.991 (H), 3.841/5.991 (F) (:333,408-409); the
winner triangulates > 90% of the inliers, beats the runners-up (0.7 / 0.75)
and clears the parallax and count minima (:504-567,721).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from defslam_tpu_torch.utils import first_argmax, inv_nan

RANSAC_ITERS = 200
CHI2_H = 5.991
CHI2_F = 3.841
CHI2_F_SCORE = 5.991
MIN_PARALLAX_DEG = 1.0
MIN_TRIANGULATED = 50
COS_PARALLAX_GOOD = 0.99998  # Initializer.cc CheckRT


class InitResult(NamedTuple):
    ok: torch.Tensor  # () bool
    R: torch.Tensor  # (3, 3) rotation cam1 -> cam2
    t: torch.Tensor  # (3,) unit-norm translation
    xyz: torch.Tensor  # (N, 3) triangulated points in the cam1 frame
    good: torch.Tensor  # (N,) bool triangulated and inlier
    used_h: torch.Tensor  # () bool: the model selection's outcome
    n_good: torch.Tensor  # () int64


def draw_sets(mask: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(N,) bool mask and uniforms u in [0, 1) of any shape -> indices of
    that shape, drawn with replacement with probability mask / sum(mask):
    ``jax.random.choice``'s inverse-CDF formula, ``searchsorted(c, c[-1] *
    (1 - u))`` on the float32 cumulative sum, side left."""
    p = mask.to(torch.float32)
    p = p / torch.clamp(p.sum(), min=1.0)
    c = torch.cumsum(p, dim=0)
    r = c[-1] * (1.0 - u.to(torch.float32))
    return torch.searchsorted(c, r.reshape(-1).contiguous(), side="left").reshape(u.shape)


def _normalize(xy: torch.Tensor, mask: torch.Tensor):
    """Similarity normalization to mean 0 and mean absolute deviation 1 per
    axis (Initializer::Normalize).  Returns (normalized xy, 3x3 T)."""
    w = mask.to(xy.dtype)
    n = torch.clamp(w.sum(), min=1.0)
    mean = torch.sum(xy * w[:, None], dim=0) / n
    d = torch.abs(xy - mean) * w[:, None]
    md = torch.clamp(torch.sum(d, dim=0) / n, min=1e-8)
    s = 1.0 / md
    xn = (xy - mean) * s
    z, o = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([
        torch.stack([s[0], z, -mean[0] * s[0]]),
        torch.stack([z, s[1], -mean[1] * s[1]]),
        torch.stack([z, z, o]),
    ])
    return xn, T


def _h_rows(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """The two DLT rows of each correspondence (Initializer::ComputeH21):
    (..., n, 2) x2 -> (..., 2n, 9), the first rows of all points, then the
    second rows."""
    u1, v1, u2, v2 = x1[..., 0], x1[..., 1], x2[..., 0], x2[..., 1]
    z, o = torch.zeros_like(u1), torch.ones_like(u1)
    r1 = torch.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], dim=-1)
    r2 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], dim=-1)
    return torch.cat([r1, r2], dim=-2)


def _f_rows(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """One DLT row per correspondence (Initializer::ComputeF21)."""
    u1, v1, u2, v2 = x1[..., 0], x1[..., 1], x2[..., 0], x2[..., 1]
    o = torch.ones_like(u1)
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, o], dim=-1)


def _null_vector(A: torch.Tensor, full: bool) -> torch.Tensor:
    """(..., m, 9) -> (..., 3, 3): the right singular vector of the least
    singular value."""
    _, _, Vt = torch.linalg.svd(A, full_matrices=full)
    return Vt[..., -1, :].reshape(A.shape[:-2] + (3, 3))


def _rank2(Fpre: torch.Tensor) -> torch.Tensor:
    U, D, Vt = torch.linalg.svd(Fpre)
    D = torch.cat([D[..., :2], torch.zeros_like(D[..., 2:])], dim=-1)
    return (U * D[..., None, :]) @ Vt


def _score_h(H21, H12, xy1, xy2, mask, sigma2=1.0):
    """Symmetric transfer error score (Initializer::CheckHomography); H
    batched (..., 3, 3).  Returns (score (...), inlier (..., N))."""

    def transfer(H, a, b):
        x = H[..., 0, 0, None] * a[:, 0] + H[..., 0, 1, None] * a[:, 1] + H[..., 0, 2, None]
        y = H[..., 1, 0, None] * a[:, 0] + H[..., 1, 1, None] * a[:, 1] + H[..., 1, 2, None]
        w = H[..., 2, 0, None] * a[:, 0] + H[..., 2, 1, None] * a[:, 1] + H[..., 2, 2, None]
        winv = 1.0 / torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
        return ((x * winv - b[:, 0]) ** 2 + (y * winv - b[:, 1]) ** 2) / sigma2

    chi_12 = transfer(H12, xy2, xy1)  # 2 projected into 1
    chi_21 = transfer(H21, xy1, xy2)
    in1, in2 = chi_12 < CHI2_H, chi_21 < CHI2_H
    inlier = in1 & in2 & mask
    zero = torch.zeros_like(chi_12)
    score = torch.sum(torch.where(mask & in1, CHI2_H - chi_12, zero)
                      + torch.where(mask & in2, CHI2_H - chi_21, zero), dim=-1)
    return score, inlier


def _score_f(F21, xy1, xy2, mask, sigma2=1.0):
    """Epipolar-distance score (Initializer::CheckFundamental); F batched."""

    def epi(F, a, b):
        la = F[..., 0, 0, None] * a[:, 0] + F[..., 0, 1, None] * a[:, 1] + F[..., 0, 2, None]
        lb = F[..., 1, 0, None] * a[:, 0] + F[..., 1, 1, None] * a[:, 1] + F[..., 1, 2, None]
        lc = F[..., 2, 0, None] * a[:, 0] + F[..., 2, 1, None] * a[:, 1] + F[..., 2, 2, None]
        num = la * b[:, 0] + lb * b[:, 1] + lc
        return num * num / torch.clamp(la * la + lb * lb, min=1e-12) / sigma2

    chi_21 = epi(F21, xy1, xy2)
    chi_12 = epi(F21.transpose(-1, -2), xy2, xy1)
    in1, in2 = chi_21 < CHI2_F, chi_12 < CHI2_F
    inlier = in1 & in2 & mask
    zero = torch.zeros_like(chi_21)
    score = torch.sum(torch.where(mask & in1, CHI2_F_SCORE - chi_21, zero)
                      + torch.where(mask & in2, CHI2_F_SCORE - chi_12, zero), dim=-1)
    return score, inlier


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, xy1: torch.Tensor,
                    xy2: torch.Tensor) -> torch.Tensor:
    """Batched DLT triangulation: projection matrices (..., 3, 4), pixels
    (..., N, 2) -> (..., N, 3).  The 4x4 SVD per point (Initializer::
    Triangulate) is the eigenvector of the least eigenvalue of AtA, the
    rows normalized first (the same null space, better conditioned)."""
    P1, P2 = P1[..., None, :, :], P2[..., None, :, :]
    rows = torch.stack([
        xy1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        xy1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        xy2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        xy2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ], dim=-2)  # (..., N, 4, 4)
    rows = rows / torch.clamp(torch.linalg.norm(rows, dim=-1, keepdim=True), min=1e-12)
    AtA = rows.transpose(-1, -2) @ rows
    _, vecs = torch.linalg.eigh(AtA)
    X = vecs[..., 0]  # least eigenvalue
    w = X[..., 3]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return X[..., :3] / w[..., None]


def _check_rt(Rs, ts, K, xy1, xy2, mask, sigma2=1.0):
    """For each of the stacked motions (B, 3, 3), (B, 3): the matches that
    triangulate in front of both cameras with a small reprojection error
    (Initializer::CheckRT).  Returns (n_good (B,), parallax_deg (B,), xyz
    (B, N, 3), good (B, N))."""
    b = Rs.shape[0]
    eye34 = torch.eye(3, 4, dtype=K.dtype, device=K.device)
    P1 = (K @ eye34).expand(b, 3, 4)
    P2 = K @ torch.cat([Rs, ts[:, :, None]], dim=-1)
    X = triangulate_dlt(P1, P2, xy1.expand(b, -1, -1), xy2.expand(b, -1, -1))
    finite = torch.isfinite(X).all(dim=-1)
    Xs = torch.where(finite[..., None], X, torch.zeros_like(X))

    O2 = -(Rs.transpose(-1, -2) @ ts[:, :, None])[..., 0]
    ray2 = Xs - O2[:, None, :]
    n1 = torch.linalg.norm(Xs, dim=-1)
    n2 = torch.linalg.norm(ray2, dim=-1)
    cos_par = torch.sum(Xs * ray2, dim=-1) / torch.clamp(n1 * n2, min=1e-12)

    z1 = Xs[..., 2]
    z2 = (Xs @ Rs.transpose(-1, -2) + ts[:, None, :])[..., 2]
    ok_depth = (z1 > 0) & (z2 > 0) & finite

    def reproj_err(P, uv):
        h = torch.cat([Xs, torch.ones_like(Xs[..., :1])], dim=-1) @ P.transpose(-1, -2)
        z = torch.where(torch.abs(h[..., 2]) < 1e-12, torch.full_like(h[..., 2], 1e-12), h[..., 2])
        return torch.sum((h[..., :2] / z[..., None] - uv) ** 2, dim=-1)

    th = 4.0 * sigma2  # Initializer.cc:494 (4 sigma^2)
    good = (mask & ok_depth & (reproj_err(P1, xy1) < th) & (reproj_err(P2, xy2) < th)
            & (cos_par < COS_PARALLAX_GOOD))
    n_good = good.sum(dim=-1)

    # robust parallax: the min(50, n)-th smallest cos (CheckRT's tail)
    cos_sorted = torch.sort(torch.where(good, cos_par, torch.full_like(cos_par, 2.0)), dim=-1).values
    k = torch.clamp(torch.clamp(n_good, max=50) - 1, 0, cos_par.shape[-1] - 1)
    cos_k = torch.clamp(cos_sorted.gather(-1, k[:, None])[:, 0], -1.0, 1.0)
    parallax = torch.where(n_good > 0, torch.rad2deg(torch.arccos(cos_k)), torch.zeros_like(cos_k))
    return n_good, parallax, Xs, good


def _motions_from_e(E: torch.Tensor):
    """The four (R, t) motions of an essential matrix (DecomposeE)."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    tu = U[:, 2]
    tu = tu / torch.clamp(torch.linalg.norm(tu), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([tu, -tu, tu, -tu])


def _motions_from_h(H: torch.Tensor, K: torch.Tensor):
    """Eight (R, t, valid) motions of a homography by the Faugeras SVD
    decomposition (Initializer::ReconstructH).  Returns (Rs (8, 3, 3), ts
    (8, 3), valid (8,))."""
    A = inv_nan(K) @ H @ K
    U, d, Vt = torch.linalg.svd(A)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = d[0], d[1], d[2]
    # degenerate when the singular values are not distinct
    distinct = (d1 / torch.clamp(d2, min=1e-12) > 1.0001) & (d2 / torch.clamp(d3, min=1e-12) > 1.0001)
    den13 = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den13, min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den13, min=0.0))
    sgn = dict(dtype=H.dtype, device=H.device)
    x1s = torch.tensor([1.0, 1.0, -1.0, -1.0], **sgn) * aux1
    x3s = torch.tensor([1.0, -1.0, 1.0, -1.0], **sgn) * aux3
    s_pat = torch.tensor([1.0, -1.0, -1.0, 1.0], **sgn)
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    z4, o4 = torch.zeros(4, **sgn), torch.ones(4, **sgn)

    # case d' > 0
    den_p = torch.clamp((d1 + d3) * d2, min=1e-12)
    sins = s_pat * (root / den_p)
    cos_t = ((d2 * d2 + d1 * d3) / den_p).expand(4)
    Rp_p = torch.stack([torch.stack([cos_t, z4, -sins], -1), torch.stack([z4, o4, z4], -1),
                        torch.stack([sins, z4, cos_t], -1)], dim=-2)
    tp_p = torch.stack([x1s, z4, -x3s], dim=-1) * (d1 - d3)
    # case d' < 0
    den_n = torch.clamp((d1 - d3) * d2, min=1e-12)
    sphs = s_pat * (root / den_n)
    cos_ph = ((d1 * d3 - d2 * d2) / den_n).expand(4)
    Rp_n = torch.stack([torch.stack([cos_ph, z4, sphs], -1), torch.stack([z4, -o4, z4], -1),
                        torch.stack([sphs, z4, -cos_ph], -1)], dim=-2)
    tp_n = torch.stack([x1s, z4, x3s], dim=-1) * (d1 + d3)

    Rp = torch.cat([Rp_p, Rp_n])  # (8, 3, 3)
    tp = torch.cat([tp_p, tp_n])  # (8, 3)
    Rs = s * (U @ Rp @ Vt)
    ts = tp @ U.T
    ts = ts / torch.clamp(torch.linalg.norm(ts, dim=-1, keepdim=True), min=1e-12)
    return Rs, ts, distinct.expand(8)


def two_view_init(
    xy1: torch.Tensor,  # (N, 2) pixel coords in frame 1
    xy2: torch.Tensor,  # (N, 2) matched pixel coords in frame 2
    mask: torch.Tensor,  # (N,) bool valid correspondence
    K: torch.Tensor,  # (3, 3)
    sets: torch.Tensor,  # (200, 8) sample sets (draw_sets)
    sigma: float = 1.0,
) -> InitResult:
    """Two-view reconstruction (Initializer::Initialize, Initializer.cc:
    44-124): RANSAC H and F on the given sets, an all-inlier refit of each,
    model selection, motion decomposition and the cheirality check.  No
    host read."""
    sigma2 = sigma * sigma
    x1n, T1 = _normalize(xy1, mask)
    x2n, T2 = _normalize(xy2, mask)
    T2inv = inv_nan(T2)
    s1, s2 = x1n[sets], x2n[sets]  # (I, 8, 2)

    Hs = T2inv @ _null_vector(_h_rows(s1, s2), full=True) @ T1  # (I, 3, 3)
    Fs = T2.T @ _rank2(_null_vector(_f_rows(s1, s2), full=True)) @ T1
    score_h, inl_h = _score_h(Hs, inv_nan(Hs), xy1, xy2, mask, sigma2)
    score_f, inl_f = _score_f(Fs, xy1, xy2, mask, sigma2)
    bh, bf = first_argmax(score_h), first_argmax(score_f)
    SH, SF = score_h[bh], score_f[bf]
    H_best, H_inl = Hs[bh], inl_h[bh]
    F_best, F_inl = Fs[bf], inl_f[bf]

    # refit on ALL inliers (masked-row DLT): the minimal 8-point model
    # leaves ~1 deg of rotation error; one least-squares refit is nearly free
    wh = H_inl.to(x1n.dtype).repeat(2)[:, None]
    H_ref = T2inv @ _null_vector(_h_rows(x1n, x2n) * wh, full=False) @ T1
    _, H_inl2 = _score_h(H_ref, inv_nan(H_ref), xy1, xy2, mask, sigma2)
    keep_h = H_inl2.sum() >= H_inl.sum()
    H_best = torch.where(keep_h, H_ref, H_best)
    H_inl = torch.where(keep_h, H_inl2, H_inl)

    wf = F_inl.to(x1n.dtype)[:, None]
    F_ref = T2.T @ _rank2(_null_vector(_f_rows(x1n, x2n) * wf, full=False)) @ T1
    _, F_inl2 = _score_f(F_ref, xy1, xy2, mask, sigma2)
    keep_f = F_inl2.sum() >= F_inl.sum()
    F_best = torch.where(keep_f, F_ref, F_best)
    F_inl = torch.where(keep_f, F_inl2, F_inl)

    use_h = SH / torch.clamp(SH + SF, min=1e-12) > 0.40  # Initializer.cc:115

    # ---- the stacked 12-hypothesis reconstruction (8 from H, 4 from E)
    Rs_h, ts_h, valid_h = _motions_from_h(H_best, K)
    Rs_f, ts_f = _motions_from_e(K.T @ F_best @ K)
    Rs = torch.cat([Rs_h, Rs_f])
    ts = torch.cat([ts_h, ts_f])
    from_h = torch.arange(12, device=K.device) < 8
    hyp_valid = torch.cat([valid_h, torch.ones_like(valid_h[:4])]) & (from_h == use_h)

    inlier = torch.where(use_h, H_inl, F_inl)
    n_inl = inlier.sum()
    ng, par, X, good = _check_rt(Rs, ts, K, xy1, xy2, inlier, sigma2)
    ng = torch.where(hyp_valid, ng, torch.zeros_like(ng))

    best = first_argmax(ng)
    n_best = ng[best]
    # runner-up dominance: H needs second < 0.75 best (Initializer.cc:721);
    # F rejects if > 1 hypothesis has > 0.7 best (:507-517)
    second = torch.where(torch.arange(12, device=K.device) == best, torch.zeros_like(ng), ng).max()
    dominance = torch.where(use_h, second < 0.75 * n_best, second <= 0.7 * n_best)
    n_min = torch.clamp((0.9 * n_inl.to(torch.float32)).to(torch.int64), min=MIN_TRIANGULATED)
    count_ok = torch.where(use_h, (n_best > MIN_TRIANGULATED) & (n_best > 0.9 * n_inl),
                           n_best >= n_min)
    ok = dominance & count_ok & (par[best] > MIN_PARALLAX_DEG) & (n_best > 0)
    return InitResult(ok=ok, R=Rs[best], t=ts[best], xyz=X[best], good=good[best],
                      used_h=use_h, n_good=n_best)
