"""Keyframe redundancy detection (``LocalMapping::KeyFrameCulling``,
LocalMapping.cc:645-725).

Port of ``defslam_tpu/rigid/culling.py``: the observation structure is a
dense (F, P) table of each keyframe's least observation level of each
point, built with one scatter-min (``scatter_reduce`` with ``amin``: the
same result in any order), and the cross-count is one broadcast
comparison.  The orchestrator culls the single most redundant keyframe per
mapping step (the first maximum, as ``jnp.argmax``).
"""

from __future__ import annotations

import torch

from defslam_tpu_torch.utils import first_argmax

_NO_OBS = 255


def redundancy_ratios(point_id: torch.Tensor, level: torch.Tensor, kp_valid: torch.Tensor,
                      kf_valid: torch.Tensor, point_valid: torch.Tensor,
                      min_obs: int = 3) -> torch.Tensor:
    """Fraction of each keyframe's observed points that >= ``min_obs``
    other keyframes see at a level <= its own + 1 (LocalMapping.cc:
    665-704).  point_id, level, kp_valid (F, K); kf_valid (F,); point_valid
    (P,).  Returns (F,) float32, 0 for invalid keyframes."""
    f, k = point_id.shape
    p = point_valid.shape[0]
    obs_ok = kp_valid & (point_id >= 0) & kf_valid[:, None]
    pid = torch.where(obs_ok, point_id, torch.full_like(point_id, p))
    src = torch.where(obs_ok, level.to(torch.int32), torch.full_like(level, _NO_OBS, dtype=torch.int32))
    lvl = torch.full((f, p + 1), _NO_OBS, dtype=torch.int32, device=point_id.device)
    lvl.scatter_reduce_(1, pid.to(torch.int64), src, reduce="amin")
    lvl = lvl[:, :p]
    obs = (lvl < _NO_OBS) & point_valid[None, :]
    # covered[f, p]: the other keyframes seeing p at a level <= lvl[f, p] + 1
    finer = obs[None, :, :] & (lvl[None, :, :] <= lvl[:, None, :] + 1)  # (F, F', P)
    counts = finer.sum(dim=1) - obs.to(torch.int64)  # without itself
    redundant = obs & (counts >= min_obs)
    n_seen = obs.sum(dim=1)
    ratio = redundant.sum(dim=1) / torch.clamp(n_seen, min=1)
    return torch.where(kf_valid & (n_seen > 0), ratio, torch.zeros_like(ratio))


def pick_cull(ratios: torch.Tensor, protect: torch.Tensor, threshold: float = 0.9) -> torch.Tensor:
    """Slot of the most redundant cullable keyframe (the first of equals),
    or -1.  ``protect`` (F,) bool: keyframes that must stay."""
    r = torch.where(protect, torch.zeros_like(ratios), ratios)
    best = first_argmax(r)
    return torch.where(r[best] > threshold, best, torch.full_like(best, -1))
