"""Normals, shape-from-normals, Sim(3) registration and Horn alignment of
the PyTorch port against the JAX package's, on the CPU.

Inputs are made with numpy from a seed: a tilted, gently curved surface
seen from two views gives exact warp differentials for the normal solver;
SfN integrates analytic normals; registration aligns a scaled, rotated,
noisy copy.  Tolerances: residuals and closed-form transfers 1e-5, the
residual Jacobian (written out in the port, ``jax.jacfwd`` in the
reference) 1e-4 of its largest entry, solved k 1e-3 (12 LM trips of 2x2
float32 solves, accept tests at convergence can tie), SfN control depths
and depths 1e-3 (a Cholesky of a 63x63 system by another library),
Sim(3) 1e-4; gates and counts equal.  Where a solve is ill-conditioned by
construction the test says so and compares what the data determines.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from defslam_tpu.geometry import se3 as jse3
from defslam_tpu.mapping import normals as jnrm
from defslam_tpu.mapping import registration as jreg
from defslam_tpu.mapping import sfn as jsfn
from defslam_tpu.ops import bspline as jbs
from defslam_tpu_torch.geometry import se3 as tse3
from defslam_tpu_torch.mapping import normals as tnrm
from defslam_tpu_torch.mapping import registration as treg
from defslam_tpu_torch.mapping import sfn as tsfn

DOM = np.array([-0.62, 0.58, -0.47, 0.49], np.float32)
NU, NV = 7, 9


def _close(t, j, tol):
    t = t.numpy() if torch.is_tensor(t) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    np.testing.assert_allclose(t, j, rtol=0, atol=tol * max(1.0, np.abs(j[np.isfinite(j)]).max()))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def obs_np():
    """(P, O) pair observations: J12 near identity, small Hessians, some
    masked; point 0 has no observation at all."""
    rng = np.random.default_rng(0)
    P, O = 40, 4
    uv1 = rng.uniform(-0.5, 0.5, (P, O, 2)).astype(np.float32)
    uv1[:] = uv1[:, :1]  # one reference position per point
    uv2 = (uv1 + rng.normal(0, 0.05, (P, O, 2))).astype(np.float32)
    J12 = (np.eye(2) + rng.normal(0, 0.08, (P, O, 2, 2))).astype(np.float32)
    Huu = rng.normal(0, 0.05, (P, O, 2)).astype(np.float32)
    Hvv = rng.normal(0, 0.05, (P, O, 2)).astype(np.float32)
    mask = rng.uniform(size=(P, O)) > 0.25
    mask[0] = False
    k0 = rng.normal(0, 0.1, (P, 2)).astype(np.float32)
    return dict(uv1=uv1, uv2=uv2, J12=J12, Huu=Huu, Hvv=Hvv, mask=mask), k0


def _both(obs_np):
    d, k0 = obs_np
    return (jnrm.PairObs(**{k: jnp.asarray(v) for k, v in d.items()}),
            tnrm.PairObs(**{k: _t(v) for k, v in d.items()}), k0)


def test_transfer_and_residuals(obs_np):
    jo, to, k0 = _both(obs_np)
    kj, kt = jnp.asarray(k0)[:, None, :], _t(k0)[:, None, :]
    _close(tnrm.transfer_k(kt, to), jnrm.transfer_k(kj, jo), 1e-5)
    _close(tnrm.metric_residuals(kt, to), jnrm.metric_residuals(kj, jo), 1e-5)
    _close(tnrm.normal_from_k(_t(k0), to.uv1[:, 0]), jnrm.normal_from_k(jnp.asarray(k0), jo.uv1[:, 0]), 1e-6)


def test_residual_jacobian_matches_jacfwd(obs_np):
    jo, to, k0 = _both(obs_np)

    def one(o, k):
        return jax.jacfwd(lambda x: jnrm.metric_residuals(x, o))(k)  # (O, 3, 2)

    J_ref = jax.vmap(one)(jo, jnp.asarray(k0))
    r, J = tnrm.metric_residuals_jac(_t(k0)[:, None, :], to)
    _close(r, jnrm.metric_residuals(jnp.asarray(k0)[:, None, :], jo), 1e-5)
    _close(J, J_ref, 1e-4)


@pytest.mark.parametrize("iters", [0, 12])
def test_solve_k1k2(obs_np, iters):
    jo, to, k0 = _both(obs_np)
    ref = jnrm.solve_k1k2(jo, jnp.asarray(k0), num_iters=iters)
    out = tnrm.solve_k1k2(to, _t(k0), num_iters=iters)
    assert np.array_equal(out.n_obs.numpy(), np.asarray(ref.n_obs))
    assert np.array_equal(out.valid.numpy(), np.asarray(ref.valid))
    assert not out.valid[0] and np.array_equal(out.k[0].numpy(), k0[0])
    # (inconsistent random observations send a lane or two far away: those
    # are compared relatively)
    np.testing.assert_allclose(out.k.numpy(), np.asarray(ref.k), rtol=5e-3, atol=1e-3)
    _close(out.cost, ref.cost, 1e-4)
    # the covariance gates at 1400 (mapper.COV_GATE_SCALE x reliability):
    # compare where it is below 1e5, and the gate's verdict everywhere
    cj, ct = np.asarray(ref.cov), out.cov.numpy()
    dj = np.stack([cj[:, 0, 0], cj[:, 1, 1]], -1)
    dt = np.stack([ct[:, 0, 0], ct[:, 1, 1]], -1)
    small = dj.max(-1) < 1e5
    np.testing.assert_allclose(dt[small], dj[small], rtol=2e-2)
    assert np.array_equal((dt <= 1400).all(-1), (dj <= 1400).all(-1))
    if iters == 0:
        assert np.array_equal(out.k.numpy(), k0)


@pytest.fixture(scope="module")
def surface():
    rng = np.random.default_rng(1)
    n = 150
    uv = np.stack([rng.uniform(DOM[0], DOM[1], n), rng.uniform(DOM[2], DOM[3], n)], -1).astype(np.float32)
    # inverse depth linear in (u, v): a plane; k = -grad(gamma)/gamma
    a, b, c = 0.25, -0.15, 1.0
    k = np.stack([np.full(n, a) / (a * uv[:, 0] + b * uv[:, 1] + c),
                  np.full(n, b) / (a * uv[:, 0] + b * uv[:, 1] + c)], -1).astype(np.float32)
    k += rng.normal(0, 0.01, k.shape).astype(np.float32)
    mask = (uv[:, 0] < 0.25) & (rng.uniform(size=n) > 0.1)  # an unsupported strip
    return uv, k, mask


@pytest.mark.parametrize("flat,tilt", [(0.0, 0.0), (0.3, 0.0), (0.3, 1.0)])
def test_sfn_solve(surface, flat, tilt):
    uv, k, mask = surface
    B = jbs.bending_matrix(DOM, NU, NV)
    nj = jnrm.normal_from_k(jnp.asarray(k), jnp.asarray(uv))
    ref = jsfn.solve(jnp.asarray(uv), nj, jnp.asarray(mask), jnp.asarray(DOM), NU, NV, B, 0.1,
                     flat_extension=flat, tilt_extension=tilt, ext_dom=jnp.asarray(DOM * 1.2))
    nt = tnrm.normal_from_k(_t(k), _t(uv))
    out = tsfn.solve(_t(uv), nt, _t(mask), _t(DOM), NU, NV, _t(np.array(B)), 0.1,
                     flat_extension=flat, tilt_extension=tilt, ext_dom=_t(DOM * 1.2))
    assert bool(out.ok) and bool(ref.ok)
    # without the extension prior the unsupported strip's control depths
    # lie in the bending penalty's null space: only the supported depths
    # are determined
    _close(out.ctrl, ref.ctrl, 1e-3 if flat > 0 else 5e-2)
    _close(out.depth[_t(mask)], np.asarray(ref.depth)[mask], 1e-3)
    _close(out.xyz[_t(mask)], np.asarray(ref.xyz)[mask], 1e-3)
    assert abs(float(np.median(out.ctrl.numpy())) - 1.0) < 1e-5


def test_sfn_not_ok_with_two_normals(surface):
    uv, k, mask = surface
    m2 = np.zeros_like(mask)
    m2[:2] = True
    B = _t(np.array(jbs.bending_matrix(DOM, NU, NV)))
    out = tsfn.solve(_t(uv), tnrm.normal_from_k(_t(k), _t(uv)), _t(m2), _t(DOM), NU, NV, B, 0.1)
    assert not bool(out.ok)


def _sim3_case(seed, reflect=False, n=80):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(n, 3)).astype(np.float32) + np.array([0, 0, 3], np.float32)
    R = np.asarray(jse3.so3_exp(jnp.asarray(rng.normal(0, 0.4, 3).astype(np.float32))))
    if reflect:
        src[:, 2] = 3.0 + 1e-4 * rng.normal(size=n)  # near-planar: a reflection fits as well
    dst = (1.7 * src @ R.T + np.array([0.2, -0.1, 0.4], np.float32)).astype(np.float32)
    dst += rng.normal(0, 0.005, dst.shape).astype(np.float32)
    dst[:6] += 1.0  # outliers for the robust pass
    mask = rng.uniform(size=n) > 0.2
    return src, dst, mask


@pytest.mark.parametrize("seed,reflect", [(0, False), (1, False), (2, True), (3, True)])
def test_horn_alignment_rotation_not_reflection(seed, reflect):
    src, dst, mask = _sim3_case(seed, reflect)
    w = mask.astype(np.float32)
    sj, Rj, tj = jse3.horn_alignment(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
    st, Rt, tt = tse3.horn_alignment(_t(src), _t(dst), _t(w))
    assert abs(float(torch.linalg.det(Rt)) - 1.0) < 1e-4
    if not reflect:  # a near-planar source leaves the third direction to noise
        _close(Rt, Rj, 1e-4)
        _close(tt, tj, 1e-4)
    _close(st, sj, 1e-4)
    # what is determined in both cases: the aligned points
    _close(float(st) * _t(src) @ Rt.T + tt,
           float(sj) * jnp.asarray(src) @ Rj.T + tj, 2e-4)


def test_horn_alignment_zero_weight():
    src, dst, _ = _sim3_case(4)
    s, R, t = tse3.horn_alignment(_t(src), _t(dst), torch.zeros(src.shape[0]))
    assert torch.isfinite(R).all() and torch.isfinite(t).all() and float(s) == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_scale_min_median_and_register(seed):
    src, dst, mask = _sim3_case(seed)
    sj = jreg.scale_min_median(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask))
    st = treg.scale_min_median(_t(src), _t(dst), _t(mask))
    assert float(st) == pytest.approx(float(sj), rel=1e-6)
    ref = jreg.register(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask), 0.07, 15)
    out = treg.register(_t(src), _t(dst), _t(mask), 0.07, 15)
    assert int(out.n_pairs) == int(ref.n_pairs)
    assert bool(out.accepted) == bool(ref.accepted) is True
    _close(out.s, ref.s, 1e-4)
    _close(out.R, ref.R, 1e-4)
    _close(out.t, ref.t, 1e-4)
    _close(out.residual, ref.residual, 1e-4)
    assert float(out.s) == pytest.approx(1.7, rel=2e-2)


def test_register_rejects_few_pairs_and_bad_fit():
    src, dst, mask = _sim3_case(5)
    few = np.zeros_like(mask)
    few[:10] = True
    assert not bool(treg.register(_t(src), _t(dst), _t(few), 0.07, 15).accepted)
    rng = np.random.default_rng(6)
    junk = rng.normal(size=dst.shape).astype(np.float32)
    ref = jreg.register(jnp.asarray(src), jnp.asarray(junk), jnp.asarray(mask), 0.07, 15)
    out = treg.register(_t(src), _t(junk), _t(mask), 0.07, 15)
    assert not bool(out.accepted) and not bool(ref.accepted)
    # the candidate pool is strided over ALL rows, masked or not
    assert int(out.n_pairs) == int(mask.sum())
