"""Batched damped Levenberg-Marquardt on torch tensors.

Port of ``defslam_tpu/ops/lm.py``.  The JAX package writes one solve and
``vmap``s it over problems; here the batch dimension is written out: ``B``
independent problems of ``n`` unknowns and ``R`` residuals run in lock
step, each lane frozen once it is done.  The caller supplies residuals AND
their Jacobian (the JAX package differentiates the residual function with
``jax.jacfwd``; the port's callers have closed forms).

Per lane the result equals the reference's fixed-trip form (``unroll > 0``
there): a lane is done before it starts when its initial cost is <= 0, and
after an accepted step that improves the cost by at most ``rtol``
relative, or when the damping reaches ``lam_max``; a done lane keeps its
state.  Zero iterations return the start point.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from portbench.reference.frozen.utils import device_constant


class LMResult(NamedTuple):
    x: torch.Tensor  # (B, n) final parameters
    cost: torch.Tensor  # (B,) final robust cost
    cost0: torch.Tensor  # (B,) initial cost
    lam: torch.Tensor  # (B,) final damping
    JtJ: torch.Tensor  # (B, n, n) undamped normal matrix at x


def huber_block_weights(r: torch.Tensor, block: int, delta: float,
                        mask: torch.Tensor | None = None) -> torch.Tensor:
    """IRLS weights (..., R): residuals in consecutive blocks of ``block``;
    each block gets min(1, delta / ||r_block||).  ``mask`` (..., R/block)
    zeroes invalid blocks."""
    rb = r.reshape(r.shape[:-1] + (-1, block))
    norm = torch.sqrt(torch.sum(rb * rb, dim=-1) + 1e-12)
    w = torch.clamp(delta / norm, max=1.0)
    if mask is not None:
        w = w * mask.to(w.dtype)
    return torch.repeat_interleave(w, block, dim=-1)


def forward_jacobian(residual: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor):
    """(r (B, R), J (B, R, n)) of ``residual``, a map of lanes (L, n) -> (L,
    R), at x (B, n), by one forward-mode ``jvp``: the n tangent directions
    ride as n*B extra lanes (lane k*B + b is lane b with tangent e_k), the
    role of ``jax.jacfwd``."""
    b, n = x.shape
    tangents = device_constant(("jvp_tangents", n, b), lambda: np.repeat(np.eye(n), b, axis=0),
                               x.device, x.dtype)
    r, jv = torch.func.jvp(residual, (x.repeat(n, 1),), (tangents,))
    return r[:b], jv.reshape(n, b, -1).permute(1, 2, 0)


def lm_solve(
    residual_jac_fn: Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]],
    x0: torch.Tensor,
    num_iters: int,
    weight_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
    lam0: float = 1e-4,
    lam_up: float = 4.0,
    lam_down: float = 0.5,
    lam_min: float = 1e-10,
    lam_max: float = 1e8,
    rtol: float = 1e-6,
) -> LMResult:
    """``residual_jac_fn``: x (B, n) -> (r (B, R), J (B, R, n)).
    ``weight_fn``: r -> per-residual IRLS weight (B, R)."""

    def weights(r):
        return torch.ones_like(r) if weight_fn is None else weight_fn(r.detach())

    def cost_of(r, w):
        return 0.5 * torch.sum(w * r * r, dim=-1)

    def normal_matrix(J, w):
        return J.transpose(-1, -2) @ (J * w[..., None])

    x = x0
    r, J = residual_jac_fn(x)
    w = weights(r)
    cost = cost0 = cost_of(r, w)
    lam = torch.full_like(cost, lam0)
    done = cost0 <= 0.0
    for _ in range(num_iters):
        H = normal_matrix(J, w)
        g = (J.transpose(-1, -2) @ (w * r)[..., None])[..., 0]
        # Marquardt scaling: damp by lam * diag(H), with a tiny floor
        D = torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1) + 1e-9)
        # a matrix that is not positive definite gives no step (the
        # reference's NaN step), not an exception
        L, info = torch.linalg.cholesky_ex(H + lam[:, None, None] * D)
        dx = -torch.cholesky_solve(g[..., None], L)[..., 0]
        dx = torch.where((info == 0)[:, None] & torch.isfinite(dx), dx, torch.zeros_like(dx))
        x_new = x + dx
        r_new, J_new = residual_jac_fn(x_new)
        w_new = weights(r_new)
        c_new = cost_of(r_new, w_new)
        accept = (c_new < cost) & torch.isfinite(c_new)
        converged = accept & (cost - c_new <= rtol * (cost + 1e-30))
        take = accept & ~done
        x = torch.where(take[:, None], x_new, x)
        r = torch.where(take[:, None], r_new, r)
        J = torch.where(take[:, None, None], J_new, J)
        w = torch.where(take[:, None], w_new, w)
        cost = torch.where(take, c_new, cost)
        lam_new = torch.clamp(torch.where(accept, lam * lam_down, lam * lam_up), lam_min, lam_max)
        lam = torch.where(done, lam, lam_new)
        done = done | converged | (lam_new >= lam_max)
    # J and w are those of the kept x: the final normal matrix needs no
    # further evaluation
    return LMResult(x=x, cost=cost, cost0=cost0, lam=lam, JtJ=normal_matrix(J, w))
