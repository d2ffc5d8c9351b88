"""Shared numerics helpers.

Port of ``defslam_tpu/utils.py`` (``psd_solve``, ``masked_median``,
``masked_mean``) plus the deterministic scatter rule the mapping chain
needs: the JAX package scatters with repeated indices in several places,
and on its CPU backend the updates land in order, so the LAST writer of a
destination wins.  ``index_put_`` with repeated indices is not
deterministic on CUDA; :func:`last_writer` reproduces the in-order rule on
any device.
"""

from __future__ import annotations

import torch


def psd_solve(A: torch.Tensor, b: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Solve A x = b for symmetric positive definite A by Cholesky.  A
    matrix that is not positive definite gives NaN (as ``jnp.linalg.
    cholesky`` does), never an exception."""
    n = A.shape[-1]
    if jitter:
        A = A + jitter * torch.eye(n, dtype=A.dtype, device=A.device)
    L, info = torch.linalg.cholesky_ex(A)
    vec = b.ndim == A.ndim - 1
    x = torch.cholesky_solve(b[..., None] if vec else b, L)
    x = x[..., 0] if vec else x
    ok = (info == 0).reshape(info.shape + (1,) * (x.ndim - info.ndim))
    return torch.where(ok, x, torch.full_like(x, float("nan")))


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None) -> torch.Tensor:
    m = mask.to(x.dtype)
    if dim is None:
        return (x * m).sum() / torch.clamp(m.sum(), min=1e-9)
    return (x * m).sum(dim=dim) / torch.clamp(m.sum(dim=dim), min=1e-9)


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of ``x`` where ``mask`` (any shape, flattened): masked-out
    entries sort to +inf and the two middle indices come from the true
    count; 0 for an empty mask."""
    x, mask = x.reshape(-1), mask.reshape(-1)
    big = torch.where(mask, x, torch.full_like(x, float("inf")))
    s = torch.sort(big).values
    cnt = mask.sum()
    i1 = torch.clamp(cnt - 1, min=0) // 2
    i2 = torch.clamp(cnt // 2, max=x.shape[0] - 1)
    med = 0.5 * s.gather(0, torch.stack([i1, i2])).sum()  # no host read
    return torch.where(cnt > 0, med, torch.zeros_like(med))


def last_writer(dest: torch.Tensor, size: int) -> torch.Tensor:
    """For a scatter of ``dest.numel()`` updates (in flat order) into
    ``size`` slots, the flat position of the LAST update landing in each
    slot, or -1 for an untouched slot.  Destinations outside [0, size) are
    dropped.  Deterministic on every device (``scatter_reduce_`` with amax
    of the writer's position)."""
    dest = dest.reshape(-1)
    pos = torch.arange(dest.shape[0], device=dest.device)
    ok = (dest >= 0) & (dest < size)
    win = torch.full((size + 1,), -1, dtype=torch.int64, device=dest.device)
    win.scatter_reduce_(0, torch.where(ok, dest, size), pos, reduce="amax")
    return win[:size]


def scatter_last(init: torch.Tensor, dest: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``init.at[dest].set(src, mode="drop")`` along dim 0 with the in-order
    rule: of several updates to one slot the last one wins.  ``src`` may be
    a scalar (broadcast)."""
    win = last_writer(dest, init.shape[0])
    hit = win >= 0
    if not torch.is_tensor(src) or src.ndim == 0:
        fill = torch.as_tensor(src, dtype=init.dtype, device=init.device)
        return torch.where(hit.reshape((-1,) + (1,) * (init.ndim - 1)), fill, init)
    vals = src.reshape((-1,) + init.shape[1:])[torch.clamp(win, min=0)]
    return torch.where(hit.reshape((-1,) + (1,) * (init.ndim - 1)), vals.to(init.dtype), init)


def linspace(lo: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` points from ``lo`` to ``hi`` as the JAX package's
    ``jnp.linspace`` rounds them: lo (1 - s) + hi s with s = i / (n - 1),
    and the endpoint exactly ``hi`` (``torch.linspace`` rounds otherwise)."""
    s = torch.arange(n - 1, dtype=lo.dtype, device=lo.device) / float(n - 1)
    return torch.cat([lo * (1 - s) + hi * s, hi.reshape(1)])


def first_argmin(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the FIRST minimum along ``dim`` (``jnp.argmin``'s rule),
    by a min over the positions that attain it: the same on every device."""
    n = x.shape[dim]
    shape = [1] * x.ndim
    shape[dim] = n
    pos = torch.arange(n, device=x.device).reshape(shape)
    hit = x == x.amin(dim=dim, keepdim=True)
    return torch.clamp(torch.where(hit, pos, n).amin(dim=dim), max=n - 1)


def first_argmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the FIRST maximum along ``dim`` (``jnp.argmax``'s rule)."""
    return first_argmin(-x if x.dtype.is_floating_point else -x.to(torch.int64), dim)
