"""Hamming-space descriptor matching on torch tensors.

Port of ``defslam_tpu/ops/matching.py``: dense masked distance matrices
stand in for the reference's per-keypoint ORBmatcher loops.  The distance
matrix is kernel B1 (:mod:`defslam_tpu_torch.ops.hamming`).  Every ranking
keeps ``jax.lax.top_k``'s tie rule: among equal values the lower index
comes first.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from defslam_tpu_torch.ops.fast import stable_topk
from defslam_tpu_torch.ops.hamming import hamming_matrix

INVALID = 10_000  # sentinel distance (max real distance is 256)
HISTO_BINS = 30  # rotation-consistency histogram bins (ORBmatcher.cc:35)


class Matches(NamedTuple):
    idx: torch.Tensor  # (N,) int64 — best match in B for each A, -1 if none
    dist: torch.Tensor  # (N,) int32


def compact_select(mask: torch.Tensor, capacity: int):
    """Select up to ``capacity`` True rows of ``mask`` in ascending index
    order.  Returns (sel (capacity,) int64, sel_mask (capacity,) bool,
    n_dropped () int64)."""
    n = mask.shape[0]
    if capacity >= n:
        return torch.arange(n, device=mask.device), mask, mask.new_zeros((), dtype=torch.int64)
    _, sel = stable_topk(mask.to(torch.int32), capacity)
    n_elig = mask.sum()
    return sel, mask[sel], torch.clamp(n_elig - capacity, min=0)


def masked_hamming(
    desc_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_a: torch.Tensor,
    valid_b: torch.Tensor,
    pair_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """(N, M) int32 distances with INVALID where a row or column is invalid
    or ``pair_mask`` is False."""
    d = hamming_matrix(desc_a, desc_b)
    ok = valid_a[:, None] & valid_b[None, :]
    if pair_mask is not None:
        ok = ok & pair_mask
    return torch.where(ok, d, torch.full_like(d, INVALID))


def best_match(
    dist: torch.Tensor,
    max_dist: int,
    nn_ratio: float = 1.0,
    mutual: bool = False,
) -> Matches:
    """Row-wise best match with the Lowe ratio and an optional mutual-best
    check.  Equal to the top-2 of ``jax.lax.top_k(-dist, 2)``: the best is
    the first minimum (``argmin``) and the second is the minimum of the row
    with that one entry removed.

    ``dist`` is (N, M), or (N, B, M): B independent matrices that share
    their N rows (one (N, B*M) distance matrix viewed so), matched each on
    its own; the results are then (N, B)."""
    j = torch.argmin(dist, dim=-1)
    best = dist.gather(-1, j[..., None])[..., 0]
    rest = dist.scatter(-1, j[..., None], torch.iinfo(dist.dtype).max)
    second = rest.min(dim=-1).values
    ok = best <= max_dist
    if nn_ratio < 1.0:
        ok = ok & (best.float() <= nn_ratio * second.float())
    if mutual:
        back = torch.argmin(dist, dim=0)  # best A for each B: (..., M)
        back_j = back.expand(dist.shape).gather(-1, j[..., None])[..., 0]
        rows = torch.arange(dist.shape[0], device=dist.device)
        ok = ok & (back_j == rows.reshape((-1,) + (1,) * (dist.ndim - 2)))
    return Matches(idx=torch.where(ok, j, torch.full_like(j, -1)), dist=best)


def rotation_consistency(
    angle_a: torch.Tensor,
    angle_b: torch.Tensor,
    matches: Matches,
    keep_bins: int = 3,
) -> Matches:
    """Keep only matches whose rotation offset falls in the top-k histogram
    bins (the reference's CheckOrientation, ORBmatcher.cc:35-37)."""
    valid = matches.idx >= 0
    da = angle_a - angle_b[torch.clamp(matches.idx, 0, angle_b.shape[0] - 1)]
    # divide by a tensor, not a Python scalar: a scalar divisor may be
    # turned into a multiply by its reciprocal, which rounds differently
    frac = torch.remainder(da / torch.full_like(da, 2.0 * math.pi), 1.0)
    bin_id = torch.clamp((frac * HISTO_BINS).to(torch.int64), 0, HISTO_BINS - 1)
    hist = torch.zeros(HISTO_BINS, dtype=torch.int32, device=da.device)
    hist.index_add_(0, bin_id, valid.to(torch.int32))
    _, top_bins = stable_topk(hist, keep_bins)
    in_top = (bin_id[:, None] == top_bins[None, :]).any(dim=1)
    ok = valid & in_top
    return Matches(idx=torch.where(ok, matches.idx, torch.full_like(matches.idx, -1)),
                   dist=matches.dist)


def window_mask(xy_a: torch.Tensor, xy_b: torch.Tensor, radius) -> torch.Tensor:
    """(N, M) bool: is B's keypoint within ``radius`` (Chebyshev) of A's
    predicted position?"""
    d = torch.abs(xy_a[:, None, :] - xy_b[None, :, :])
    return d.max(dim=-1).values <= radius
