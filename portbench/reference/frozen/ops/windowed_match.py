"""Windowed Hamming matching with a two-minimum row reduction: kernel B2.

Replaces ``defslam_tpu/ops/pallas_kernels.py::windowed_match_pallas``.  For
every row keypoint of every pair, over the columns that are valid and
within a Chebyshev ``radius`` of the row's position: the least Hamming
distance, the column of the FIRST minimum, and the least distance over all
other columns; ``invalid`` where nothing is admissible (index 0 then).  The
reference's copy: :func:`windowed_match` is the plain version on every
device.
"""

from __future__ import annotations

import torch

from portbench.reference.frozen.ops.hamming import hamming_matrix_plain
from portbench.reference.frozen.utils import first_argmin


def windowed_match_plain(desc_a, desc_b, xy_a, xy_b, valid_a, valid_b, radius: float,
                         invalid: int):
    """Plain torch version, one pair at a time: the masked distance matrix,
    its first row-wise argmin, and the row minimum with that entry removed.
    Returns (best (B, N) int32, idx (B, N) int64, second (B, N) int32)."""
    best, idx, second = [], [], []
    for k in range(desc_a.shape[0]):
        d = hamming_matrix_plain(desc_a[k], desc_b[k])
        win = (xy_a[k][:, None, :] - xy_b[k][None, :, :]).abs().max(dim=-1).values <= radius
        ok = valid_a[k][:, None] & valid_b[k][None, :] & win
        d = torch.where(ok, d, torch.full_like(d, invalid))
        if d.shape[1] == 0:
            d = torch.full((d.shape[0], 1), invalid, dtype=d.dtype, device=d.device)
        j = first_argmin(d, dim=1)
        rest = d.scatter(1, j[:, None], invalid)
        best.append(d.gather(1, j[:, None])[:, 0])
        idx.append(j)
        second.append(rest.min(dim=1).values)
    return torch.stack(best), torch.stack(idx), torch.stack(second)


def windowed_match(desc_a: torch.Tensor, desc_b: torch.Tensor, xy_a: torch.Tensor,
                   xy_b: torch.Tensor, valid_a: torch.Tensor, valid_b: torch.Tensor,
                   radius: float, invalid: int, out=None):
    """(best, idx, second) by :func:`windowed_match_plain`, on any device."""
    if out is not None:
        raise ValueError("the reference's windowed_match writes into no buffer")
    return windowed_match_plain(desc_a, desc_b, xy_a, xy_b, valid_a, valid_b, radius, invalid)
