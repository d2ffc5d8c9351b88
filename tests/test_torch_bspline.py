"""B-spline operations, shared numerics helpers and the batched LM of the
PyTorch port against the JAX package's, on the CPU.

Same numpy inputs through both.  Tolerances: spline evaluation, colocation
and bending matrices 1e-6 relative to the largest entry (the same float32
operations in another summation order); ridge fits and LM results 1e-4
(a float32 linear solve by another library).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from defslam_tpu import utils as jutils
from defslam_tpu.ops import bspline as jbs
from defslam_tpu.ops import lm as jlm
from defslam_tpu_torch import utils as tutils
from defslam_tpu_torch.ops import bspline as tbs
from defslam_tpu_torch.ops import lm as tlm

DOM = np.array([-0.62, 0.58, -0.47, 0.49], np.float32)
NU, NV = 7, 9


def _close(t, j, tol=1e-6):
    t = t.numpy() if torch.is_tensor(t) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    np.testing.assert_allclose(t, j, rtol=0, atol=tol * max(1.0, np.abs(j).max()))


@pytest.fixture(scope="module")
def pts():
    rng = np.random.default_rng(0)
    u = rng.uniform(-0.7, 0.65, 200).astype(np.float32)  # some outside the domain
    v = rng.uniform(-0.5, 0.55, 200).astype(np.float32)
    ctrl = rng.normal(size=(NU, NV, 2)).astype(np.float32)
    return u, v, ctrl


@pytest.mark.parametrize("order", [0, 1, 2])
def test_basis_and_coloc_1d(pts, order):
    u = pts[0]
    ij, wj = jbs.basis_1d(jnp.asarray(u), DOM[0], DOM[1], NU, order)
    it, wt = tbs.basis_1d(torch.from_numpy(u), torch.tensor(DOM[0]), torch.tensor(DOM[1]), NU, order)
    assert np.array_equal(it.numpy(), np.asarray(ij))
    _close(wt, wj)
    _close(tbs.coloc_1d(torch.from_numpy(u), torch.tensor(DOM[0]), torch.tensor(DOM[1]), NU, order),
           jbs.coloc_1d(jnp.asarray(u), DOM[0], DOM[1], NU, order))


@pytest.mark.parametrize("du,dv", [(0, 0), (1, 0), (0, 1), (2, 0), (1, 1), (0, 2)])
def test_evaluate_and_coloc_2d_all_orders(pts, du, dv):
    u, v, ctrl = pts
    ref = jbs.evaluate(jnp.asarray(ctrl), jnp.asarray(u), jnp.asarray(v), jnp.asarray(DOM), du, dv)
    tu, tv, td = torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(DOM)
    _close(tbs.evaluate(torch.from_numpy(ctrl), tu, tv, td, du, dv), ref)
    # scalar-valued grid, and the batched form with shared / per-batch points
    ref1 = jbs.evaluate(jnp.asarray(ctrl[..., 0]), jnp.asarray(u), jnp.asarray(v), jnp.asarray(DOM), du, dv)
    _close(tbs.evaluate(torch.from_numpy(ctrl[..., 0].copy()), tu, tv, td, du, dv), ref1)
    cb = torch.from_numpy(np.stack([ctrl, 2 * ctrl]))
    out = tbs.evaluate(cb, tu, tv, td, du, dv)
    _close(out[0], ref)
    _close(out[1], 2 * np.asarray(ref))
    _close(tbs.evaluate(cb, torch.stack([tu, tu]), torch.stack([tv, tv]), td, du, dv)[1],
           2 * np.asarray(ref))
    C = tbs.coloc_2d(tu, tv, td, NU, NV, du, dv)
    _close(C, jbs.coloc_2d(jnp.asarray(u), jnp.asarray(v), jnp.asarray(DOM), NU, NV, du, dv))
    _close(C @ torch.from_numpy(ctrl).reshape(-1, 2), ref, 1e-5)


def test_bending_matrices():
    ref = jbs.bending_matrix(DOM, NU, NV)
    _close(tbs.bending_matrix(torch.from_numpy(DOM), NU, NV), ref)
    for t, j in zip(tbs.bending_components(NU, NV), jbs.bending_components(NU, NV)):
        _close(t, j)
    dyn = tbs.bending_matrix_dyn(torch.from_numpy(DOM), NU, NV)
    _close(dyn, jbs.bending_matrix_dyn(jnp.asarray(DOM), NU, NV))
    _close(dyn, ref, 1e-5)


def test_fit_ridge_plain_and_batched(pts):
    u, v, _ = pts
    rng = np.random.default_rng(1)
    vals = rng.normal(size=(200, 2)).astype(np.float32)
    w = (rng.uniform(size=200) > 0.3).astype(np.float32)
    B = jbs.bending_matrix(DOM, NU, NV)
    ref = jbs.fit_ridge(jnp.asarray(u), jnp.asarray(v), jnp.asarray(vals), jnp.asarray(DOM),
                        NU, NV, 1e-3, weights=jnp.asarray(w), bending=B)
    tB = torch.from_numpy(np.array(B))
    tu, tv, td = torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(DOM)
    out = tbs.fit_ridge(tu, tv, torch.from_numpy(vals), td, NU, NV, 1e-3,
                        weights=torch.from_numpy(w), bending=tB)
    _close(out, ref, 1e-4)
    outb = tbs.fit_ridge(torch.stack([tu, tu]), torch.stack([tv, tv]),
                         torch.from_numpy(np.stack([vals, -vals])), td, NU, NV, 1e-3,
                         weights=torch.from_numpy(np.stack([w, w])), bending=tB)
    _close(outb[1], -np.asarray(ref), 1e-4)
    ref0 = jbs.fit_ridge(jnp.asarray(u), jnp.asarray(v), jnp.asarray(vals), jnp.asarray(DOM), NU, NV, 1e-3)
    _close(tbs.fit_ridge(tu, tv, torch.from_numpy(vals), td, NU, NV, 1e-3), ref0, 1e-4)


def test_psd_solve_and_masked_reductions():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(12, 12)).astype(np.float32)
    A = A @ A.T + 0.5 * np.eye(12, dtype=np.float32)
    b = rng.normal(size=12).astype(np.float32)
    _close(tutils.psd_solve(torch.from_numpy(A), torch.from_numpy(b), jitter=1e-3),
           jutils.psd_solve(jnp.asarray(A), jnp.asarray(b), jitter=1e-3), 1e-4)
    # not positive definite: NaN in both, no exception
    bad = -torch.eye(3)
    assert torch.isnan(tutils.psd_solve(bad, torch.ones(3))).all()
    assert np.isnan(np.asarray(jutils.psd_solve(-jnp.eye(3), jnp.ones(3)))).all()
    x = rng.normal(size=50).astype(np.float32)
    for frac in (0.0, 0.02, 0.5, 0.51, 1.0):
        m = rng.uniform(size=50) < frac
        assert float(tutils.masked_median(torch.from_numpy(x), torch.from_numpy(m))) == float(
            jutils.masked_median(jnp.asarray(x), jnp.asarray(m)))
        _close(tutils.masked_mean(torch.from_numpy(x), torch.from_numpy(m)),
               jutils.masked_mean(jnp.asarray(x), jnp.asarray(m)))


def test_last_writer_scatter_rule_with_duplicates():
    """The in-order rule of the JAX package's CPU scatters: of several
    updates to one slot the last one wins; out-of-range updates drop."""
    rng = np.random.default_rng(3)
    dest = rng.integers(0, 60, 4000)  # 50 slots: some out of range
    vals = rng.normal(size=(4000, 2)).astype(np.float32)
    ref = jnp.zeros((50, 2)).at[jnp.asarray(dest)].set(jnp.asarray(vals), mode="drop")
    out = tutils.scatter_last(torch.zeros(50, 2), torch.from_numpy(dest), torch.from_numpy(vals))
    assert np.array_equal(out.numpy(), np.asarray(ref))
    flag = tutils.scatter_last(torch.zeros(50, dtype=torch.bool), torch.from_numpy(dest), True)
    assert np.array_equal(flag.numpy(), np.isin(np.arange(50), dest))


def test_huber_block_weights():
    rng = np.random.default_rng(4)
    r = (3 * rng.normal(size=40)).astype(np.float32)
    m = rng.uniform(size=20) > 0.3
    _close(tlm.huber_block_weights(torch.from_numpy(r), 2, 1.5, torch.from_numpy(m)),
           jlm.huber_block_weights(jnp.asarray(r), 2, 1.5, jnp.asarray(m)))


def _curve_problem():
    """B exponential-fit problems y = a exp(b t) with outliers; lane 2 is
    fully masked (zero cost: done before it starts)."""
    rng = np.random.default_rng(5)
    t = np.linspace(0, 1, 16).astype(np.float32)
    a = rng.uniform(0.5, 2, 4).astype(np.float32)
    b = rng.uniform(-1, 1, 4).astype(np.float32)
    y = a[:, None] * np.exp(b[:, None] * t) + 0.01 * rng.normal(size=(4, 16)).astype(np.float32)
    y[:, 3] += 2.0
    mask = np.ones((4, 16), np.float32)
    mask[2] = 0.0
    x0 = np.tile(np.array([1.0, 0.0], np.float32), (4, 1))
    return t, y, mask, x0


@pytest.mark.parametrize("iters", [0, 1, 25])
def test_lm_solve_matches_reference_per_lane(iters):
    t, y, mask, x0 = _curve_problem()

    def jsolve(yk, mk, xk):
        res_fn = lambda x: (x[0] * jnp.exp(x[1] * jnp.asarray(t)) - yk) * mk  # noqa: E731
        wf = lambda r: jlm.huber_block_weights(r, 1, 0.5)  # noqa: E731
        return jlm.lm_solve(res_fn, xk, iters, weight_fn=wf, unroll=4)

    ref = jax.vmap(jsolve)(jnp.asarray(y), jnp.asarray(mask), jnp.asarray(x0))
    tt, ty, tm = torch.from_numpy(t), torch.from_numpy(y), torch.from_numpy(mask)

    def res_jac(x):
        e = torch.exp(x[:, 1:2] * tt)
        r = (x[:, 0:1] * e - ty) * tm
        J = torch.stack([e * tm, x[:, 0:1] * tt * e * tm], dim=-1)
        return r, J

    out = tlm.lm_solve(res_jac, torch.from_numpy(x0), iters,
                       weight_fn=lambda r: tlm.huber_block_weights(r, 1, 0.5))
    _close(out.x, ref.x, 1e-4)
    _close(out.cost, ref.cost, 1e-4)
    _close(out.cost0, ref.cost0, 1e-5)
    _close(out.JtJ, ref.JtJ, 1e-3)
    assert np.array_equal(out.x[2].numpy(), x0[2])  # the masked lane never moved
    if iters == 0:
        assert np.array_equal(out.x.numpy(), x0)
    if iters == 1:  # later, accepting a step at convergence is a rounding-level tie
        np.testing.assert_allclose(out.lam.numpy(), np.asarray(ref.lam), rtol=1e-6)
