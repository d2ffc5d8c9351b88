"""Windowed Hamming matching with a two-minimum row reduction: kernel B2.

Replaces ``defslam_tpu/ops/pallas_kernels.py::windowed_match_pallas``.  For
every row keypoint of every pair, over the columns that are valid and
within a Chebyshev ``radius`` of the row's position: the least Hamming
distance, the column of the FIRST minimum, and the least distance over all
other columns; ``invalid`` where nothing is admissible (index 0 then).  On
CUDA tensors :func:`windowed_match` launches the hand-written kernel in
``csrc/windowed_match.cu`` (the (B, N, M) distance array never reaches
device memory) or raises; on CPU tensors it runs
:func:`windowed_match_plain`.  There is no fallback from the kernel to the
plain version.
"""

from __future__ import annotations

import torch

from defslam_tpu_torch.ops import cuda_build
from defslam_tpu_torch.ops.hamming import hamming_matrix_plain
from defslam_tpu_torch.utils import first_argmin


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


def _check(name: str, t: torch.Tensor, dtype, shape, dev) -> None:
    if t.dtype != dtype or t.shape != shape:
        raise ValueError(f"{name}: expected {tuple(shape)} {dtype}, got {tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.device != dev:
        raise ValueError(f"{name}: on {t.device}, the row descriptors on {dev}")


def windowed_match(desc_a: torch.Tensor, desc_b: torch.Tensor, xy_a: torch.Tensor,
                   xy_b: torch.Tensor, valid_a: torch.Tensor, valid_b: torch.Tensor,
                   radius: float, invalid: int, out=None):
    """desc_a (B, N, 8), desc_b (B, M, 8) int32 descriptor words; xy_a
    (B, N, 2), xy_b (B, M, 2) float32 positions in one frame; valid_a
    (B, N), valid_b (B, M) bool; ``invalid`` the sentinel distance (> 256).
    Returns (best (B, N) int32, idx (B, N) int64, second (B, N) int32).
    On the card the kernel loads a descriptor as two 16-byte words and a
    position as one 8-byte word: the descriptor tensors must start on a
    16-byte and the position tensors on an 8-byte boundary (any tensor that
    owns its storage does; a view at an odd offset raises ValueError).
    ``out``, where given, is a pair of contiguous tensors on the same
    device to write into: (2, B, N) int32, whose two planes become ``best``
    and ``second``, and (B, N) int64 for ``idx``."""
    if desc_a.ndim != 3 or desc_b.ndim != 3:
        raise ValueError("windowed_match: descriptors must be (B, N, 8)")
    b, n, _ = desc_a.shape
    m = desc_b.shape[1]
    dev = desc_a.device
    _check("desc_a", desc_a, torch.int32, (b, n, 8), dev)
    _check("desc_b", desc_b, torch.int32, (b, m, 8), dev)
    _check("xy_a", xy_a, torch.float32, (b, n, 2), dev)
    _check("xy_b", xy_b, torch.float32, (b, m, 2), dev)
    _check("valid_a", valid_a, torch.bool, (b, n), dev)
    _check("valid_b", valid_b, torch.bool, (b, m), dev)
    if invalid <= 256:
        raise ValueError("windowed_match: the invalid sentinel must exceed 256")
    if out is not None:
        pair, idx = out
        _check("out[0]", pair, torch.int32, (2, b, n), dev)
        _check("out[1]", idx, torch.int64, (b, n), dev)
    if dev.type == "cpu":
        res = windowed_match_plain(desc_a, desc_b, xy_a, xy_b, valid_a, valid_b, radius, invalid)
        if out is None:
            return res
        best, second = pair.unbind(0)
        return best.copy_(res[0]), idx.copy_(res[1]), second.copy_(res[2])
    if dev.type != "cuda":
        raise ValueError(f"windowed_match: unsupported device {dev}")
    if (desc_a.data_ptr() | desc_b.data_ptr()) % 16 or (xy_a.data_ptr() | xy_b.data_ptr()) % 8:
        raise ValueError("windowed_match: descriptors must be 16-byte and positions 8-byte aligned")
    if out is None:
        pair = torch.empty((2, b, n), dtype=torch.int32, device=dev)
        idx = torch.empty((b, n), dtype=torch.int64, device=dev)
    best, second = pair.unbind(0)
    if b == 0 or n == 0:
        return best, idx, second
    cuda_build.launch(
        "windowed_match", dev, desc_a.data_ptr(), desc_b.data_ptr(), xy_a.data_ptr(),
        xy_b.data_ptr(), valid_a.data_ptr(), valid_b.data_ptr(), best.data_ptr(), idx.data_ptr(),
        second.data_ptr(), b, n, m, float(radius), int(invalid))
    cuda_build.LAUNCHES["windowed_match"] += 1
    return best, idx, second
