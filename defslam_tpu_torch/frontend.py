"""Feature-extraction frontend: image -> fixed-capacity keypoint arrays.

Port of ``defslam_tpu/frontend.py``: pyramid, dense FAST scores,
grid-distributed selection per level, then orientation, blur and
descriptors batched across all levels on a zero-padded canvas stack.
Per-level budgets follow the reference's geometric distribution
(ORBextractor.cc ctor).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from defslam_tpu_torch import profiling
from defslam_tpu_torch.config import Config
from defslam_tpu_torch.geometry import camera as cammod
from defslam_tpu_torch.ops import fast, orb, pyramid
from defslam_tpu_torch.utils import device_constant


class Features(NamedTuple):
    """Per-frame keypoints, padded to a static capacity K.

    xy      (K, 2) f32   : level-0 pixel coordinates
    response(K,)   f32   : FAST score
    level   (K,)   i32   : pyramid level
    angle   (K,)   f32   : orientation (radians)
    desc    (K, 8) i32   : 256-bit rBRIEF (uint32 bits held as int32)
    valid   (K,)   bool  : capacity mask
    """

    xy: torch.Tensor
    response: torch.Tensor
    level: torch.Tensor
    angle: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]


def level_budgets(n_features: int, n_levels: int, scale_factor: float):
    """Geometric per-level keypoint budgets (reference ORBextractor ctor)."""
    f = 1.0 / scale_factor
    raw = np.array([f**lv for lv in range(n_levels)])
    raw = raw / raw.sum() * n_features
    out = [int(round(x)) for x in raw]
    out[0] += n_features - sum(out)
    return out


def _level_quotas(avail: list[int], k: int) -> list[int]:
    """Largest-remainder proportional quotas: split budget ``k`` over levels
    with ``avail[i]`` candidates each, never exceeding a level's count."""
    total = sum(avail)
    raw = [k * a / total for a in avail]
    q = [min(int(x), a) for x, a in zip(raw, avail)]
    rest = k - sum(q)
    order = sorted(range(len(avail)), key=lambda i: raw[i] - int(raw[i]),
                   reverse=True)
    while rest > 0:
        gave = False
        for i in order:
            if rest == 0:
                break
            if q[i] < avail[i]:
                q[i] += 1
                rest -= 1
                gave = True
        if not gave:
            break
    return q


def _cell_size(h: int, w: int, budget: int) -> int:
    """Tile size giving ~2x budget candidate cells (>= 8 px)."""
    return max(8, int(math.sqrt(h * w / max(2 * budget, 1))))


def extract_features(img: torch.Tensor, cfg: Config) -> Features:
    """(H, W) image -> Features with capacity ``cfg.orb.max_keypoints``, on
    the image's device."""
    with profiling.stage("frontend.extract"):
        img = img.float()
        dev = img.device
        oc = cfg.orb
        levels = pyramid.build_pyramid(img, oc.n_levels, oc.scale_factor)
        budgets = level_budgets(oc.n_features, oc.n_levels, oc.scale_factor)
        scales = pyramid.scale_factors(oc.n_levels, oc.scale_factor)
        h0, w0 = levels[0].shape

        used = [lv for lv, b in enumerate(budgets) if b > 0]
        xs, resps, lvs, canvas_of, scs = [], [], [], [], []
        for ci, lv in enumerate(used):
            img_lv, budget = levels[lv], budgets[lv]
            score = fast.nms3(fast.score_map(img_lv))
            cell = _cell_size(*img_lv.shape, budget)
            xy, resp = fast.select_grid_topk(
                score, float(oc.min_th_fast), cell, budget,
                ini_threshold=float(oc.ini_th_fast),
            )
            n = xy.shape[0]
            xs.append(xy)
            resps.append(resp)
            lvs.append(torch.full((n,), lv, dtype=torch.int32, device=dev))
            canvas_of.append(torch.full((n,), ci, dtype=torch.int64, device=dev))
            scs.append(torch.full((n,), float(scales[lv]), device=dev))
        xy_lv = torch.cat(xs)
        resp = torch.cat(resps)
        lv_all = torch.cat(lvs)
        sc_all = torch.cat(scs)

        raw = torch.stack(
            [
                F.pad(levels[lv], (0, w0 - levels[lv].shape[1], 0, h0 - levels[lv].shape[0]))
                for lv in used
            ]
        )
        blur = pyramid.gaussian_blur_batched(raw, sigma=2.0, radius=3)
        hw = tuple(tuple(levels[lv].shape) for lv in used)
        level_hw = device_constant(("level_hw", hw), lambda: np.asarray(hw, np.int64), dev)
        ang, desc = orb.orient_describe_stack(raw, blur, torch.cat(canvas_of), xy_lv, level_hw)

        cat = Features(
            xy=xy_lv * sc_all[:, None],
            response=resp,
            level=lv_all,
            angle=ang,
            desc=desc,
            valid=resp > 0,
        )
        if cfg.camera.has_distortion:
            K = torch.as_tensor(cfg.camera.K, device=dev)
            cat = cat._replace(xy=cammod.undistort_points(K, cfg.camera.dist, cat.xy))
        k = cfg.orb.max_keypoints
        n = cat.xy.shape[0]
        if n > k:
            # level-aware truncation: each level keeps its proportional quota of
            # its valid detections; unused quota backfills by response
            used_budgets = [budgets[lv] for lv in used]
            quotas = _level_quotas(used_budgets, k)
            starts = np.concatenate([[0], np.cumsum(used_budgets)])
            ranks, quota_of = [], []
            for i, q in enumerate(quotas):
                seg_valid = cat.valid[starts[i]:starts[i + 1]]
                ranks.append(torch.cumsum(seg_valid.int(), 0) - 1)
                quota_of.append(torch.full(seg_valid.shape, q, device=dev))
            in_quota = cat.valid & (torch.cat(ranks) < torch.cat(quota_of))
            # float32 like the reference: 1e9 + response rounds to a multiple
            # of 64, so in-quota keys tie and keep index order
            boost = torch.where(in_quota, 1e9, 0.0).float()
            key = torch.where(cat.valid, boost + cat.response, -1.0)
            _, order = fast.stable_topk(key, k)
            cat = Features(*(a[order] for a in cat))
        elif n < k:
            pad = k - n
            cat = Features(*(torch.cat([a, a.new_zeros((pad,) + a.shape[1:])]) for a in cat))
        return cat
