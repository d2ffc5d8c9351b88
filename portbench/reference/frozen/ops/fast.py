"""FAST-9/16 corner scores, 3x3 NMS and grid-distributed selection.

Port of ``defslam_tpu/ops/fast.py``.  The score of a pixel is the largest
threshold at which it would still be detected: the max over the 16
contiguous 9-arcs of the min over the arc of |p_i - c|, brighter and darker
arcs separately.  Every ranking here is a stable descending sort, so equal
scores keep ascending index order exactly as ``jax.lax.top_k`` does
(``torch.topk`` orders ties differently).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle of radius 3, clockwise from 12 o'clock, (row, col)
_CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

ARC = 9  # contiguous arc length (FAST-9)
BORDER = 3


def stable_topk(x: torch.Tensor, k: int, dim: int = -1):
    """``jax.lax.top_k`` semantics: the k largest values along ``dim`` in
    descending order, ties broken toward the lower index."""
    vals, idx = torch.sort(x, dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)


def score_map(img: torch.Tensor) -> torch.Tensor:
    """Dense FAST score of an (H, W) f32 image; border pixels score 0."""
    h, w = img.shape
    ring = torch.stack(
        [torch.roll(img, (-int(dr), -int(dc)), dims=(0, 1)) for dr, dc in _CIRCLE]
    )  # ring[j][y, x] = img[y + dr, x + dc]
    d = ring - img[None]

    def arc_score(delta):
        circ = torch.cat([delta, delta[: ARC - 1]], dim=0)  # (24, H, W)
        m = circ
        for shift in (1, 2, 4):  # windowed min of length 8
            m = torch.minimum(m[: m.shape[0] - shift], m[shift:])
        m = torch.minimum(m[:16], circ[8:24])  # length-9 windows
        return m.max(dim=0).values

    score = torch.clamp(torch.maximum(arc_score(d), arc_score(-d)), min=0.0)
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    inside = (yy >= BORDER) & (yy < h - BORDER) & (xx >= BORDER) & (xx < w - BORDER)
    return torch.where(inside, score, torch.zeros_like(score))


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression: keep local maxima (ties survive)."""
    pooled = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= pooled, score, torch.zeros_like(score))


def select_grid_topk(
    score: torch.Tensor,
    threshold: float,
    cell: int,
    k: int,
    ini_threshold: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per ``cell x cell`` tile, the top-2 pixels through the reference's
    two-threshold admission rule (ORBextractor.cc:765-857), then the global
    top-``k`` candidates by score.  Returns (xy (k, 2) f32 pixel coords,
    score (k,) f32); score 0 marks an empty slot."""
    h, w = score.shape
    if ini_threshold is None:
        ini_threshold = threshold
    ph = (cell - h % cell) % cell
    pw = (cell - w % cell) % cell
    s = F.pad(score, (0, pw, 0, ph))
    gh, gw = s.shape[0] // cell, s.shape[1] // cell
    tiles = s.reshape(gh, cell, gw, cell).permute(0, 2, 1, 3).reshape(gh * gw, -1)
    top2_score, top2_idx = stable_topk(tiles, 2, dim=1)
    s1, s2 = top2_score[:, 0], top2_score[:, 1]
    ok1 = s1 > threshold
    ok2 = (s2 > ini_threshold) | ((s1 <= ini_threshold) & (s2 > threshold))
    zero = torch.zeros_like(s1)
    cand_score = torch.cat([torch.where(ok1, s1, zero), torch.where(ok2, s2, zero)])
    cand_idx = torch.cat([top2_idx[:, 0], top2_idx[:, 1]])
    n_cand = cand_score.shape[0]
    top_score, top_c = stable_topk(cand_score, min(k, n_cand))
    tile_id = top_c % (gh * gw)
    in_tile = cand_idx[top_c]
    y = torch.div(tile_id, gw, rounding_mode="floor") * cell + torch.div(
        in_tile, cell, rounding_mode="floor"
    )
    x = (tile_id % gw) * cell + in_tile % cell
    xy = torch.stack([x, y], dim=-1).float()
    if k > n_cand:  # pad to the static budget
        pad = k - n_cand
        xy = torch.cat([xy, xy.new_zeros((pad, 2))])
        top_score = torch.cat([top_score, top_score.new_zeros(pad)])
    return xy, top_score
