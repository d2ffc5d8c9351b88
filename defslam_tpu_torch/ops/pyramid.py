"""Image pyramid + separable Gaussian blur on torch tensors.

Port of ``defslam_tpu/ops/pyramid.py``.  Levels have static shapes derived
from the config; the blur runs once over the zero-padded (L, H, W) canvas
of every level.

The bilinear resize reproduces ``jax.image.resize(..., "linear",
antialias=False)`` as the JAX package runs it on the CPU: the same sample
positions and normalized tent weights, with the sample position and each
two-tap sum rounded once (fused multiply-add), as XLA's CPU code computes
them.  The two-tap sums are formed in float64 and rounded to float32, so
the CPU and the GPU give the same bits.  ``F.interpolate`` agrees with it
only to ~3e-5.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from defslam_tpu_torch.utils import device_constant


def level_shapes(height: int, width: int, n_levels: int, scale_factor: float):
    """Static (h, w) per pyramid level (round, like cv::resize with
    1/scale^level)."""
    shapes = []
    for lv in range(n_levels):
        s = 1.0 / (scale_factor**lv)
        shapes.append((int(round(height * s)), int(round(width * s))))
    return shapes


@functools.lru_cache(maxsize=16)
def _gaussian_kernel(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur_batched(stack: torch.Tensor, sigma: float = 2.0,
                          radius: int = 3) -> torch.Tensor:
    """Separable zero-padded Gaussian blur of a batch of single-channel
    images (L, H, W) f32 (the 7x7 sigma=2 blur applied before BRIEF)."""
    k = device_constant(("gaussian_kernel", sigma, radius),
                        lambda: _gaussian_kernel(sigma, radius), stack.device)
    x = stack[:, None]
    x = F.conv2d(x, k.view(1, 1, 1, -1), padding=(0, radius))
    x = F.conv2d(x, k.view(1, 1, -1, 1), padding=(radius, 0))
    return x[:, 0]


@functools.lru_cache(maxsize=64)
def _resize_taps(in_size: int, out_size: int):
    """Two-tap linear resampling table along one axis: for every output
    index the first and second contributing input index and their weights
    (numpy; second weight 0 where one tap contributes, both 0 where the
    sample lies outside the input)."""
    inv_scale = np.float32(1.0 / (out_size / in_size))
    centers = np.arange(out_size, dtype=np.float32) + np.float32(0.5)
    sample = (centers.astype(np.float64) * np.float64(inv_scale) - 0.5).astype(
        np.float32
    )
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None])
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, dtype=np.float32)  # <= 2 nonzero terms: exact
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = np.where(np.abs(total) > eps, w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    w = np.where(inside[None, :], w, 0).astype(np.float32)
    nz = w != 0
    count = nz.sum(axis=0)
    ar = np.arange(out_size)
    k0 = np.argmax(nz, axis=0)
    k1 = np.where(count > 1, k0 + 1, k0)
    w0 = w[k0, ar]
    w1 = np.where(count > 1, w[np.minimum(k1, in_size - 1), ar], 0).astype(np.float32)
    return k0, k1, w0, w1


def _resize_axis(x: torch.Tensor, out_size: int, dim: int) -> torch.Tensor:
    i0, i1, w0, w1 = (
        device_constant(("resize_taps", x.shape[dim], out_size, j),
                        lambda j=j: _resize_taps(x.shape[dim], out_size)[j], x.device)
        for j in range(4))
    shape = [1, 1]
    shape[dim] = -1
    w0 = w0.view(shape)
    w1 = w1.view(shape).double()
    first = w0 * x.index_select(dim, i0)
    return (first.double() + w1 * x.index_select(dim, i1).double()).float()


def resize_linear(img: torch.Tensor, shape) -> torch.Tensor:
    """Bilinear (H, W) -> shape, no antialiasing; rows first, then columns
    (the contraction order of the reference's einsum)."""
    return _resize_axis(_resize_axis(img, shape[0], 0), shape[1], 1)


def build_pyramid(img: torch.Tensor, n_levels: int, scale_factor: float):
    """f32 image (H, W) -> list of n_levels images with static shapes,
    each resized from the previous level (the reference's low-pass
    cascade)."""
    shapes = level_shapes(img.shape[0], img.shape[1], n_levels, scale_factor)
    levels = [img]
    for lv in range(1, n_levels):
        levels.append(resize_linear(levels[-1], shapes[lv]))
    return levels


def scale_factors(n_levels: int, scale_factor: float) -> np.ndarray:
    return np.asarray([scale_factor**lv for lv in range(n_levels)], np.float32)
