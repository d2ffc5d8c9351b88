"""Kernel B1 and the matching ops of the PyTorch port against the JAX
package, on the CPU.

Every comparison here is exact: Hamming distances, match indices and the
tie rules are integer results.  Inputs are built from a numpy seed and
handed to both packages; uint32 descriptor words cross as int32 with the
same bits.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from defslam_tpu.ops import matching as jm
from defslam_tpu.ops.pallas_kernels import hamming_matrix_pallas
from defslam_tpu_torch.ops import cuda_build, hamming
from defslam_tpu_torch.ops import matching as tm

torch.set_num_threads(2)


def _desc(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint32)


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a.copy())


@pytest.mark.parametrize("n,m,seed", [(200, 333, 0), (256, 128, 1), (17, 9, 10), (5, 4, 11),
                                      (64, 299, 12), (257, 193, 13), (1, 1, 14)])
def test_plain_matches_jax_and_pallas(n, m, seed):
    rng = np.random.default_rng(seed)
    a, b = _desc(rng, n), _desc(rng, m)
    ref = np.asarray(jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    pallas = np.asarray(hamming_matrix_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True))
    out = hamming.hamming_matrix_plain(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, pallas)


def _sign_bit_words(rng, n):
    """Every word 0x80000000 or 0xFFFFFFFF: the sign bit of the int32 view
    is always set."""
    return np.array([0x80000000, 0xFFFFFFFF], dtype=np.uint32)[rng.integers(0, 2, (n, 8))]


def test_sign_bit_words_match_jax_and_pallas():
    rng = np.random.default_rng(15)
    a, b = _sign_bit_words(rng, 200), _sign_bit_words(rng, 300)
    assert (_t(a) < 0).all() and (_t(b) < 0).all()
    ref = np.asarray(jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    pallas = np.asarray(hamming_matrix_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True))
    out = hamming.hamming_matrix_plain(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, pallas)


@pytest.mark.parametrize("words", ["random", "signbit"])
def test_and_popcount_identity(words):
    """hamming(a, b) = popc(a) + popc(b) - 2 popc(a & b): what the CUDA
    kernel computes with the tensor cores' AND + popcount product, written
    here with the plain popcount on words taken as unsigned."""
    rng = np.random.default_rng(16)
    make = _desc if words == "random" else _sign_bit_words
    a, b = _t(make(rng, 120)), _t(make(rng, 150))
    ua, ub = a.to(torch.int64) & 0xFFFFFFFF, b.to(torch.int64) & 0xFFFFFFFF
    pa = hamming._popcount32(ua).sum(dim=1)
    pb = hamming._popcount32(ub).sum(dim=1)
    pab = hamming._popcount32(ua[:, None, :] & ub[None, :, :]).sum(dim=2)
    got = (pa[:, None] + pb[None, :] - 2 * pab).to(torch.int32)
    assert torch.equal(got, hamming.hamming_matrix_plain(a, b))


def test_wrapper_writes_into_out_on_cpu():
    rng = np.random.default_rng(17)
    a, b = _t(_desc(rng, 13)), _t(_desc(rng, 7))
    out = torch.full((13, 7), -1, dtype=torch.int32)
    got = hamming.hamming_matrix(a, b, out=out)
    assert got is out and torch.equal(out, hamming.hamming_matrix_plain(a, b))
    with pytest.raises(ValueError, match="out"):
        hamming.hamming_matrix(a, b, out=torch.zeros((13, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="out"):
        hamming.hamming_matrix(a, b, out=torch.zeros((13, 7), dtype=torch.int64))


def test_wrapper_uses_plain_on_cpu_and_counts_no_launch():
    rng = np.random.default_rng(2)
    a, b = _t(_desc(rng, 17)), _t(_desc(rng, 9))
    before = cuda_build.LAUNCHES["hamming_matrix"]
    out = hamming.hamming_matrix(a, b)
    assert out.dtype == torch.int32 and out.shape == (17, 9)
    assert torch.equal(out, hamming.hamming_matrix_plain(a, b))
    assert cuda_build.LAUNCHES["hamming_matrix"] == before


@pytest.mark.parametrize("bad", ["dtype", "width", "noncontig", "device_mix"])
def test_wrapper_rejects_bad_input(bad):
    a = torch.zeros((4, 8), dtype=torch.int32)
    b = torch.zeros((5, 8), dtype=torch.int32)
    if bad == "dtype":
        a = a.to(torch.int64)
    elif bad == "width":
        a = torch.zeros((4, 4), dtype=torch.int32)
    elif bad == "noncontig":
        a = torch.zeros((8, 4), dtype=torch.int32).T
    else:
        b = b.to("meta")
    with pytest.raises(ValueError):
        hamming.hamming_matrix(a, b)


def _tied_descriptors(rng, n, pool=6):
    """Descriptors drawn from a small pool, so distances tie everywhere."""
    base = _desc(rng, pool)
    return base[rng.integers(0, pool, n)]


def test_masked_hamming_with_ties():
    rng = np.random.default_rng(3)
    a, b = _tied_descriptors(rng, 40), _tied_descriptors(rng, 30)
    va, vb = rng.uniform(size=40) > 0.2, rng.uniform(size=30) > 0.2
    pm = rng.uniform(size=(40, 30)) > 0.3
    ref = jm.masked_hamming(jnp.asarray(a), jnp.asarray(b), jnp.asarray(va),
                            jnp.asarray(vb), pair_mask=jnp.asarray(pm))
    out = tm.masked_hamming(_t(a), _t(b), _t(va), _t(vb), pair_mask=_t(pm))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("nn_ratio,mutual", [(1.0, False), (0.9, False), (0.9, True), (1.0, True)])
def test_best_match_with_ties(nn_ratio, mutual):
    rng = np.random.default_rng(4)
    # few distinct values: equal minima and equal best/second are common
    dist = rng.choice([3, 5, 7, 10_000], size=(60, 45)).astype(np.int32)
    ref = jm.best_match(jnp.asarray(dist), max_dist=6, nn_ratio=nn_ratio, mutual=mutual)
    out = tm.best_match(_t(dist), max_dist=6, nn_ratio=nn_ratio, mutual=mutual)
    np.testing.assert_array_equal(out.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(out.dist.numpy(), np.asarray(ref.dist))


def test_rotation_consistency_with_tied_bins():
    rng = np.random.default_rng(5)
    n, m = 90, 70
    # angle offsets on 6 bins with equal counts: the top-3 choice is a tie
    offs = np.repeat(np.arange(6), 15) * (2 * np.pi / 30) + np.pi / 30
    angle_b = rng.uniform(-np.pi, np.pi, m).astype(np.float32)
    idx = rng.integers(0, m, n).astype(np.int32)
    angle_a = (angle_b[idx] + offs).astype(np.float32)
    idx[rng.uniform(size=n) < 0.1] = -1
    dist = rng.integers(0, 80, n).astype(np.int32)
    ref = jm.rotation_consistency(jnp.asarray(angle_a), jnp.asarray(angle_b),
                                  jm.Matches(jnp.asarray(idx), jnp.asarray(dist)))
    out = tm.rotation_consistency(_t(angle_a), _t(angle_b),
                                  tm.Matches(_t(idx).long(), _t(dist)))
    np.testing.assert_array_equal(out.idx.numpy(), np.asarray(ref.idx))
    assert (out.idx.numpy() >= 0).sum() > 0


@pytest.mark.parametrize("capacity", [10, 64, 300])
def test_compact_select_with_ties(capacity):
    rng = np.random.default_rng(6)
    mask = rng.uniform(size=200) > 0.6
    sel, sm, nd = jm.compact_select(jnp.asarray(mask), capacity)
    tsel, tsm, tnd = tm.compact_select(_t(mask), capacity)
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(sel))
    np.testing.assert_array_equal(tsm.numpy(), np.asarray(sm))
    assert int(tnd) == int(nd)


def test_window_mask():
    rng = np.random.default_rng(7)
    xa = rng.uniform(0, 40, (50, 2)).astype(np.float32)
    xb = np.round(rng.uniform(0, 40, (60, 2))).astype(np.float32)
    ref = jm.window_mask(jnp.asarray(xa), jnp.asarray(xb), 5.0)
    np.testing.assert_array_equal(tm.window_mask(_t(xa), _t(xb), 5.0).numpy(), np.asarray(ref))
