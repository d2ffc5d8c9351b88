"""Kernel B2's plain version and wrapper (``ops/windowed_match.py``) against
the JAX package, on the CPU, exact on all three outputs.

``windowed_match_plain`` is held against ``windowed_match_pallas`` in
interpret mode and against the per-pair reference the JAX package's own
test uses (masked distance matrix, first argmin, minimum with that entry
removed), including the index on rows with no admissible column (0).  The
port's ``densify_matches``, which always goes through the wrapper, is held
against the JAX package's unfused branch.  The CUDA kernel itself is held
against the plain version on the card (tests/test_torch_cuda.py).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from defslam_tpu.config import Config
from defslam_tpu.mapping import mapper as jmapper
from defslam_tpu.ops import matching as jmatching
from defslam_tpu.ops.pallas_kernels import windowed_match_pallas
from defslam_tpu_torch.convert import config_from_dict
from defslam_tpu_torch.mapping import mapper as tmapper
from defslam_tpu_torch.ops import cuda_build, matching, windowed_match as wm

INVALID = matching.INVALID


def _inputs(seed, b, n, m, spread=1.0, p_valid=0.8):
    rng = np.random.default_rng(seed)
    return dict(
        da=rng.integers(0, 2**32, (b, n, 8), dtype=np.uint32),
        db=rng.integers(0, 2**32, (b, m, 8), dtype=np.uint32),
        xa=rng.uniform(-spread, spread, (b, n, 2)).astype(np.float32),
        xb=rng.uniform(-spread, spread, (b, m, 2)).astype(np.float32),
        va=rng.uniform(size=(b, n)) < p_valid,
        vb=rng.uniform(size=(b, m)) < p_valid,
    )


def _case(name):
    if name == "ragged":
        return _inputs(2, 3, 150, 200), 0.35
    if name == "one":
        return _inputs(3, 1, 1, 1, p_valid=1.0), 5.0
    if name == "outside":
        return _inputs(4, 2, 70, 90), 0.0
    if name == "dead":
        d = _inputs(5, 4, 100, 300)
        d["va"][1] = False
        d["vb"][2] = False
        d["va"][0, :40] = False
        return d, 0.5
    if name == "ties":  # equal minima in different 128-column tiles of the TPU kernel
        d = _inputs(6, 2, 64, 700, p_valid=1.0)
        d["db"][:] = d["db"][:, :1]
        d["db"][0, 300:] ^= 1
        return d, 5.0
    if name == "tile_multiple":
        return _inputs(7, 2, 256, 128), 0.6
    if name == "nan":  # NaN positions in rows and columns admit nothing
        d = _inputs(8, 2, 120, 260)
        d["xa"][0, ::7, 0] = np.nan
        d["xa"][1, 3::11, 1] = np.nan
        d["xb"][0, 5::9, 1] = np.nan
        d["xb"][1, ::13, 0] = np.nan
        return d, 0.6
    if name == "wide":  # few rows, many columns
        return _inputs(9, 2, 40, 300), 0.3
    if name == "dense":  # the radius admits every pair of valid keypoints
        return _inputs(10, 2, 150, 290), 10.0
    if name == "deadpairs":  # only pair 0 alive, as at the first keyframe
        d = _inputs(11, 4, 200, 200)
        d["va"][1:] = False
        d["vb"][1:] = False
        return d, 0.4
    if name == "overflow":  # clustered rows admit hundreds of columns, the others few
        d = _inputs(12, 3, 90, 280)
        d["xa"][:, :45] *= 0.1
        d["xb"][:, :140] *= 0.1
        return d, 0.25
    raise KeyError(name)


CASES = ["ragged", "one", "outside", "dead", "ties", "tile_multiple",
         "nan", "wide", "dense", "deadpairs", "overflow"]


def _plain(d, radius):
    t = lambda a: torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)  # noqa: E731
    return wm.windowed_match(t(d["da"]), t(d["db"]), t(d["xa"]), t(d["xb"]), t(d["va"]), t(d["vb"]),
                             radius, INVALID)


@pytest.mark.parametrize("case", CASES)
def test_plain_equals_pallas_interpret(case):
    d, radius = _case(case)
    best, idx, second = _plain(d, radius)
    ref = windowed_match_pallas(*(jnp.asarray(d[k]) for k in ("da", "db", "xa", "xb", "va", "vb")),
                                radius, interpret=True)
    assert best.dtype == torch.int32 and idx.dtype == torch.int64 and second.dtype == torch.int32
    assert np.array_equal(best.numpy(), np.asarray(ref[0]))
    assert np.array_equal(idx.numpy(), np.asarray(ref[1]))  # every row, matched or not
    assert np.array_equal(second.numpy(), np.asarray(ref[2]))


@pytest.mark.parametrize("case", CASES)
def test_plain_equals_per_pair_reference(case):
    d, radius = _case(case)
    best, idx, second = _plain(d, radius)
    for k in range(d["da"].shape[0]):
        dist = np.asarray(jmatching.masked_hamming(
            jnp.asarray(d["da"][k]), jnp.asarray(d["db"][k]), jnp.asarray(d["va"][k]),
            jnp.asarray(d["vb"][k]),
            pair_mask=jmatching.window_mask(jnp.asarray(d["xa"][k]), jnp.asarray(d["xb"][k]), radius),
            use_pallas=False))
        n = dist.shape[0]
        j1 = dist.argmin(axis=1)
        d2 = dist.copy()
        d2[np.arange(n), j1] = int(jmatching.INVALID)
        assert np.array_equal(best[k].numpy(), dist.min(axis=1))
        assert np.array_equal(idx[k].numpy(), j1)
        assert np.array_equal(second[k].numpy(), np.minimum(d2.min(axis=1), int(jmatching.INVALID)))
    if case == "outside":
        assert (best == INVALID).all() and (idx == 0).all() and (second == INVALID).all()
    if case == "ties":
        assert (best == second).all() and (idx[1] == 0).all() and ((idx[0] == 0) | (idx[0] == 300)).all()
    if case == "dead":
        assert (best[1] == INVALID).all() and (best[2] == INVALID).all() and (idx[1] == 0).all()
    if case == "nan":
        assert (best[0, ::7] == INVALID).all() and (idx[0, ::7] == 0).all()
        assert (best[1, 3::11] == INVALID).all() and not (idx[0] % 9 == 5)[best[0] < INVALID].any()
        assert (best < INVALID).sum() > 100
    if case == "dense":
        n_cols = torch.from_numpy(d["vb"]).sum(dim=1, keepdim=True)
        assert ((best < INVALID) == (torch.from_numpy(d["va"]) & (n_cols > 0))).all()
    if case == "overflow":
        win = np.abs(d["xa"][:, :, None, :] - d["xb"][:, None, :, :]).max(axis=-1) <= radius
        per_row = (win & d["va"][:, :, None] & d["vb"][:, None, :]).sum(axis=2)
        assert (per_row[:, :45] > 64).any() and (per_row[:, 45:] < 64).any()
    if case == "deadpairs":
        assert (best[1:] == INVALID).all() and (idx[1:] == 0).all() and (best[0] < INVALID).any()


def test_wrapper_writes_into_out_on_cpu():
    d, radius = _case("ragged")
    b, n = d["va"].shape
    pre = (torch.full((2, b, n), -1, dtype=torch.int32), torch.full((b, n), -1, dtype=torch.int64))
    t = lambda a: torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)  # noqa: E731
    args = [t(d[k]) for k in ("da", "db", "xa", "xb", "va", "vb")]
    best, idx, second = wm.windowed_match(*args, radius, INVALID, out=pre)
    ref = _plain(d, radius)
    assert best.data_ptr() == pre[0][0].data_ptr() and second.data_ptr() == pre[0][1].data_ptr()
    assert idx is pre[1]
    assert all(torch.equal(o, r) for o, r in zip((best, idx, second), ref))
    with pytest.raises(ValueError, match="out"):
        wm.windowed_match(*args, radius, INVALID, out=(pre[0], pre[1].int()))


def test_sentinel_is_the_reference_value():
    assert INVALID == int(jmatching.INVALID) == 10_000


def test_wrapper_checks_inputs_and_counts_no_cpu_launch():
    d, radius = _case("ragged")
    before = cuda_build.LAUNCHES["windowed_match"]
    _plain(d, radius)
    assert cuda_build.LAUNCHES["windowed_match"] == before  # the CPU path launches nothing
    t = torch.from_numpy
    args = [t(d["da"].view(np.int32)), t(d["db"].view(np.int32)), t(d["xa"]), t(d["xb"]),
            t(d["va"]), t(d["vb"])]
    with pytest.raises(ValueError, match="sentinel"):
        wm.windowed_match(*args, radius, 256)
    bad = list(args)
    bad[2] = bad[2].double()
    with pytest.raises(ValueError, match="xy_a"):
        wm.windowed_match(*bad, radius, INVALID)
    bad = list(args)
    bad[1] = bad[1].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        wm.windowed_match(*bad, radius, INVALID)
    bad = list(args)
    bad[5] = bad[5][:, :-1]
    with pytest.raises(ValueError, match="valid_b"):
        wm.windowed_match(*bad, radius, INVALID)


@pytest.mark.parametrize("nn_ratio", [0.9, 1.0])
def test_densify_matches_equals_reference_unfused_branch(nn_ratio):
    """Keypoints of a 'new keyframe' and three 'covisible keyframes' that
    share most descriptors (a few bits flipped) at warped positions; pair 2
    is invalid.  Exact on the match table and the distances."""
    rng = np.random.default_rng(9)
    NP, K, nu, nv = 3, 96, 7, 9
    cfg = Config()
    cfg = dataclasses.replace(cfg, tracking=dataclasses.replace(cfg.tracking, nn_ratio=nn_ratio))
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    dom = np.array([-0.62, 0.58, -0.47, 0.49], np.float32)
    from defslam_tpu.mapping import warp as jwarp
    ctrls = np.stack([np.asarray(jwarp.identity_ctrl(jnp.asarray(dom), nu, nv))
                      + rng.normal(0, 0.004, (nu, nv, 2)) for _ in range(NP)]).astype(np.float32)
    retina1 = np.stack([rng.uniform(dom[0], dom[1], K), rng.uniform(dom[2], dom[3], K)], -1).astype(np.float32)
    valid1 = rng.uniform(size=K) > 0.1
    desc1 = rng.integers(0, 2**32, (K, 8), dtype=np.uint32)
    desc1[10] = desc1[11]  # two keypoints with one descriptor, close together
    retina1[11] = retina1[10] + 0.001
    perm = np.stack([rng.permutation(K) for _ in range(NP)])
    retina2 = (retina1[perm] + rng.normal(0, 0.01, (NP, K, 2))).astype(np.float32)
    desc2 = desc1[perm] ^ (rng.uniform(size=(NP, K, 8)) < 0.2).astype(np.uint32) * np.uint32(1 << 7)
    valid2 = rng.uniform(size=(NP, K)) > 0.1
    pair_valid = np.array([True, True, False])
    ref_idx, ref_dist = jmapper.densify_matches(
        jnp.asarray(ctrls), jnp.asarray(retina1), jnp.asarray(valid1), jnp.asarray(desc1),
        jnp.asarray(retina2), jnp.asarray(valid2), jnp.asarray(desc2), jnp.asarray(dom),
        jnp.asarray(pair_valid), cfg)
    t = torch.from_numpy
    idx, dist = tmapper.densify_matches(
        t(ctrls), t(retina1), t(valid1), t(desc1.view(np.int32)), t(retina2), t(valid2),
        t(desc2.view(np.int32)), t(dom), t(pair_valid), tcfg)
    assert np.array_equal(idx.numpy(), np.asarray(ref_idx))
    assert np.array_equal(dist.numpy(), np.asarray(ref_dist))
    assert (idx[:2] >= 0).sum() > K and (idx[2] == -1).all()
