"""All-pairs Hamming distance of 256-bit descriptors: kernel B1.

Replaces ``defslam_tpu/ops/pallas_kernels.py::hamming_matrix_pallas``.  The
reference's copy: :func:`hamming_matrix` is the plain version on every
device.

Descriptors are (N, 8) int32 tensors holding the 256 descriptor bits (the
JAX package's uint32 words, bit-cast).
"""

from __future__ import annotations

import torch


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int64 values in [0, 2^32) (SWAR; no overflow in
    int64, and every shift is of a non-negative value)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """(N, 8) words -> (N, 256) float32 0/1: bit i of word w at 32 w + i."""
    shifts = torch.arange(32, device=desc.device, dtype=torch.int64)
    words = desc.to(torch.int64) & 0xFFFFFFFF
    return ((words[:, :, None] >> shifts) & 1).reshape(desc.shape[0], -1).to(torch.float32)


def hamming_matrix_plain(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 x (M, 8) int32 -> (N, M) int32, in plain torch ops:
    popc(a) + popc(b) - 2 popc(a & b), the last term one float32 product of
    the unpacked 0/1 bit matrices.  Exact: every product is 0 or 1 and
    every sum at most 256 (also where TF32 is allowed: 0 and 1 are exact in
    it and it accumulates in float32)."""
    ba, bb = unpack_bits(desc_a), unpack_bits(desc_b)
    d = ba.sum(dim=1)[:, None] + bb.sum(dim=1)[None, :] - 2.0 * (ba @ bb.T)
    return d.to(torch.int32)


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """(N, 8) x (M, 8) descriptor words -> (N, M) int32 Hamming distances,
    on any device, by :func:`hamming_matrix_plain`."""
    plain = hamming_matrix_plain(desc_a, desc_b)
    return plain if out is None else out.copy_(plain)
