"""Spline warps of the PyTorch port against the JAX package's, on the CPU.

A smooth synthetic warp (a homography plus a small bump) observed at
random keypoints, some masked.  Tolerances: the fitted warps evaluated at
their data points 2e-5 (retina units); their control points 2e-3 of the
largest one (a float32 solve by another library of a system that the
weak bending prior leaves ill-conditioned where no keypoint supports a
control point), the regularizer's residuals 1e-5 and its Jacobian 1e-4
relative to the largest entry (forward-mode autodiff in both, with another
2x2 solve inside), differential properties 1e-4; the pixel-error gate must
select the same points.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from defslam_tpu.mapping import warp as jwarp
from defslam_tpu.ops import bspline as jbs
from defslam_tpu_torch.mapping import warp as twarp
from defslam_tpu_torch.ops import bspline as tbs

DOM = np.array([-0.62, 0.58, -0.47, 0.49], np.float32)
NU, NV = 7, 9
FX, FY = 140.0, 138.0
NP, N = 3, 120


def _close(t, j, tol):
    t = t.numpy() if torch.is_tensor(t) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    np.testing.assert_allclose(t, j, rtol=0, atol=tol * max(1.0, np.abs(j).max()))


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(0)
    uv1 = np.stack([rng.uniform(DOM[0], DOM[1], (NP, N)),
                    rng.uniform(DOM[2], DOM[3], (NP, N))], -1).astype(np.float32)
    uv2 = np.empty_like(uv1)
    for p in range(NP):
        Hm = np.eye(3) + 0.05 * rng.normal(size=(3, 3))
        q = np.concatenate([uv1[p], np.ones((N, 1))], -1) @ Hm.T
        uv2[p] = q[:, :2] / q[:, 2:] + 0.02 * np.sin(3 * uv1[p][:, ::-1])
    uv2 += 0.002 * rng.normal(size=uv2.shape)
    uv2[0, :5] += 0.5  # gross outliers: the pixel gate must drop them
    mask = rng.uniform(size=(NP, N)) > 0.15
    mask[2] = False  # an empty pair
    return uv1, uv2.astype(np.float32), mask


@pytest.fixture(scope="module")
def fitted(pairs):
    uv1, uv2, mask = pairs
    B = jbs.bending_matrix(DOM, NU, NV)
    w = mask.astype(np.float32)

    def one(a, b, ww):
        c0 = jwarp.fit_initial(a, b, ww, jnp.asarray(DOM), NU, NV, B, 5e-5)
        c1 = jwarp.refine(c0, a, b, ww, jnp.asarray(DOM), 0.05, FX, FY, num_iters=3)
        return c0, c1

    j0, j1 = jax.vmap(one)(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(w))
    td = torch.from_numpy(DOM)
    t0 = twarp.fit_initial(torch.from_numpy(uv1), torch.from_numpy(uv2), torch.from_numpy(w),
                           td, NU, NV, torch.from_numpy(np.array(B)), 5e-5)
    t1 = twarp.refine(t0, torch.from_numpy(uv1), torch.from_numpy(uv2), torch.from_numpy(w),
                      td, 0.05, FX, FY, num_iters=3)
    return j0, j1, t0, t1


def test_identity_ctrl():
    _close(twarp.identity_ctrl(torch.from_numpy(DOM), NU, NV),
           jwarp.identity_ctrl(jnp.asarray(DOM), NU, NV), 1e-6)


def _at_data(ctrl, uv1):
    return tbs.evaluate(torch.as_tensor(np.asarray(ctrl)), torch.from_numpy(uv1[..., 0]),
                        torch.from_numpy(uv1[..., 1]), torch.from_numpy(DOM))


def test_fit_initial(pairs, fitted):
    j0, _, t0, _ = fitted
    _close(t0, j0, 2e-3)
    m = pairs[2]
    assert (_at_data(t0, pairs[0]) - _at_data(j0, pairs[0]))[torch.from_numpy(m)].abs().max() < 2e-5


def test_refine(pairs, fitted):
    _, j1, _, t1 = fitted
    _close(t1, j1, 2e-3)
    m = pairs[2]
    assert (_at_data(t1, pairs[0]) - _at_data(j1, pairs[0]))[torch.from_numpy(m)].abs().max() < 2e-5
    assert not np.allclose(np.asarray(j1), np.asarray(fitted[0]), atol=1e-5)  # it moved


def test_refine_zero_iterations_is_a_no_op(pairs, fitted):
    uv1, uv2, mask = pairs
    t0 = fitted[2]
    out = twarp.refine(t0, torch.from_numpy(uv1), torch.from_numpy(uv2),
                       torch.from_numpy(mask.astype(np.float32)), torch.from_numpy(DOM),
                       0.05, FX, FY, num_iters=0)
    assert torch.equal(out, t0)


def test_projectivity_residuals_and_jacobian(fitted):
    j0 = fitted[0]
    qu, qv = jwarp._coloc_grid(jnp.asarray(DOM), NU, NV)
    tqu, tqv = twarp._coloc_grid(torch.from_numpy(DOM), NU, NV)
    _close(tqu, qu, 1e-6)
    ctrl = np.asarray(j0[0])
    f = lambda x: jwarp.projectivity_residuals(x.reshape(NU, NV, 2), qu, qv, jnp.asarray(DOM))  # noqa: E731
    r_ref = f(jnp.asarray(ctrl.reshape(-1)))
    J_ref = jax.jacfwd(f)(jnp.asarray(ctrl.reshape(-1)))
    td = torch.from_numpy(DOM)
    _close(twarp.projectivity_residuals(torch.from_numpy(ctrl), tqu, tqv, td), r_ref, 1e-5)
    Cd = twarp._deriv_colocs(tqu, tqv, td, NU, NV)
    r, J = twarp.projectivity_jacobian(torch.from_numpy(np.asarray(j0)), Cd)
    _close(r[0], r_ref, 1e-5)
    _close(J[0], J_ref, 1e-4)
    # a homography's control grid is not representable exactly, but the
    # identity warp is: its residual vanishes
    ident = twarp.identity_ctrl(td, NU, NV)
    assert twarp.projectivity_residuals(ident, tqu, tqv, td).abs().max() < 1e-4


def test_diff_props(pairs, fitted):
    uv1, uv2, mask = pairs
    _, j1, _, _ = fitted
    ref = jax.vmap(lambda c, a, b, m: jwarp.diff_props(c, a, b, m, jnp.asarray(DOM), FX, FY, 10.0))(
        j1, jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(mask))
    out = twarp.diff_props(torch.from_numpy(np.asarray(j1)), torch.from_numpy(uv1),
                           torch.from_numpy(uv2), torch.from_numpy(mask),
                           torch.from_numpy(DOM), FX, FY, 10.0)
    assert np.array_equal(out.mask.numpy(), np.asarray(ref.mask))
    assert not out.mask[0, :5].any() and out.mask[0].sum() > 50 and not out.mask[2].any()
    for name in ("warped", "J12", "J21", "Huu", "Huv", "Hvv"):
        _close(getattr(out, name), getattr(ref, name), 1e-4)
    one = twarp.diff_props(torch.from_numpy(np.asarray(j1[1])), torch.from_numpy(uv1[1]),
                           torch.from_numpy(uv2[1]), torch.from_numpy(mask[1]),
                           torch.from_numpy(DOM), FX, FY, 10.0)
    assert torch.equal(one.mask, out.mask[1]) and torch.allclose(one.J12, out.J12[1])
