"""Sim(3) registration of a new up-to-scale surface against the metric map.

Port of ``defslam_tpu/mapping/registration.py`` (``SurfaceRegistration``):
the scale starts from a min-median search over per-point ratio candidates,
the alignment is the closed-form weighted Horn/Umeyama solution with one
robust reweighted second pass, and acceptance gates the median residual
relative to the median map-point range.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.frozen.geometry import se3
from portbench.reference.frozen.utils import first_argmin, masked_median


class RegistrationResult(NamedTuple):
    s: torch.Tensor  # scale applied to the surface
    R: torch.Tensor  # (3, 3)
    t: torch.Tensor  # (3,)
    residual: torch.Tensor  # robust (median) relative residual
    accepted: torch.Tensor  # () bool: residual below the chi limit
    n_pairs: torch.Tensor  # () int


def scale_min_median(src: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor,
                     n_candidates: int = 128) -> torch.Tensor:
    """Among per-point ratio candidates s_i = |dst_i| / |src_i| (an evenly
    strided subset of ALL rows, masked or not, as the reference takes
    them), the one minimizing the median residual |s src - dst| over the
    mask; the first such candidate on a tie."""
    n = src.shape[0]
    ns = torch.linalg.norm(src, dim=-1)
    nd = torch.linalg.norm(dst, dim=-1)
    ratio = torch.where(ns > 1e-9, nd / torch.clamp(ns, min=1e-9), torch.ones_like(ns))
    c = min(n_candidates, n)
    idx = torch.arange(c, device=src.device) * (n // max(c, 1))
    cand = ratio[idx]
    res = torch.linalg.norm(cand[:, None, None] * src[None] - dst[None], dim=-1)  # (C, N)
    big = torch.where(mask[None, :], res, torch.full_like(res, float("inf")))
    srt = torch.sort(big, dim=-1).values
    cnt = mask.sum()
    i1 = torch.clamp(cnt - 1, min=0) // 2
    i2 = torch.clamp(cnt // 2, max=n - 1)
    med = 0.5 * srt.index_select(1, torch.stack([i1, i2])).sum(dim=1)  # no host read
    return cand.gather(0, first_argmin(med).reshape(1))[0]


def register(surf_xyz: torch.Tensor, map_xyz: torch.Tensor, mask: torch.Tensor,
             chi_limit: float, min_pairs: int = 15) -> RegistrationResult:
    """Align surface -> map: the Sim(3) minimizing |s R surf + t - map|
    over the masked pairs.  (N, 3), (N, 3), (N,) bool."""
    n_pairs = mask.sum()
    w = mask.to(surf_xyz.dtype)

    s0 = scale_min_median(surf_xyz, map_xyz, mask)
    src = s0 * surf_xyz
    s1, R1, t1 = se3.horn_alignment(src, map_xyz, w)

    # robust second pass: drop pairs beyond 2.5x the median residual
    res1 = torch.linalg.norm(s1 * src @ R1.T + t1 - map_xyz, dim=-1)
    med1 = masked_median(res1, mask)
    w2 = w * (res1 <= 2.5 * med1 + 1e-9).to(w.dtype)
    s2, R2, t2 = se3.horn_alignment(src, map_xyz, w2)

    res2 = torch.linalg.norm(s2 * src @ R2.T + t2 - map_xyz, dim=-1)
    # scale-free residual: relative to the median map-point range
    scene = masked_median(torch.linalg.norm(map_xyz, dim=-1), mask)
    rel = masked_median(res2, mask) / torch.clamp(scene, min=1e-9)
    accepted = (n_pairs >= min_pairs) & (rel < chi_limit) & torch.isfinite(rel)
    return RegistrationResult(s=s0 * s2, R=R2, t=t2, residual=rel, accepted=accepted,
                              n_pairs=n_pairs)
