"""``defslam_tpu_torch.native`` (numpy) against ``defslam_tpu.native``.

The JAX package's functions run its C++ library where it is built and
loads, else their numpy versions; the port carries the numpy versions.
Both are held equal, exactly: ``accumulate_obs`` to either route, and
``covis_shared`` to the numpy route, and to the library as a set of
(keypoint, keypoint, point) triples (the library lists them in keypoint
order, the numpy route in point order) where nothing is cut at
``max_out``.  The device scatter of the keyframe chain
(``mapper.accumulate_obs_device``) gives the same tables.
"""

import numpy as np
import pytest
import torch

from defslam_tpu import native as jnative
from defslam_tpu_torch import native
from defslam_tpu_torch.mapping import mapper


def _tables(rng, k=300, n_a=120, n_b=150, n_points=500):
    a = np.full(k, -1, np.int32)
    b = np.full(k, -1, np.int32)
    a[rng.choice(k, n_a, replace=False)] = rng.choice(n_points, n_a, replace=False)
    b[rng.choice(k, n_b, replace=False)] = rng.choice(n_points, n_b, replace=False)
    return a, b


@pytest.mark.parametrize("seed,max_out", [(0, 256), (1, 256), (2, 10), (3, 0)])
def test_covis_shared_equals_reference(monkeypatch, seed, max_out):
    a, b = _tables(np.random.default_rng(seed))
    ours = native.covis_shared(a, b, max_out)
    for x in ours:
        assert x.dtype == np.int32
    if jnative.available():
        lib = jnative.covis_shared(a, b, max_out)
        if len(np.intersect1d(a[a >= 0], b[b >= 0])) <= max_out:
            assert sorted(zip(*(x.tolist() for x in ours))) == sorted(zip(*(x.tolist() for x in lib)))
    monkeypatch.setattr(jnative, "_load", lambda: None)
    for x, y in zip(ours, jnative.covis_shared(a, b, max_out)):
        np.testing.assert_array_equal(x, y)


def _pair_obs(rng, n_pairs, cap, n_points):
    return dict(
        pid=rng.integers(-1, n_points + 2, (n_pairs, cap)).astype(np.int32),
        mask=rng.random((n_pairs, cap)) > 0.3,
        uv1=rng.normal(size=(n_pairs, cap, 2)).astype(np.float32),
        warped=rng.normal(size=(n_pairs, cap, 2)).astype(np.float32),
        J12=rng.normal(size=(n_pairs, cap, 2, 2)).astype(np.float32),
        Huu=rng.normal(size=(n_pairs, cap, 2)).astype(np.float32),
        Hvv=rng.normal(size=(n_pairs, cap, 2)).astype(np.float32),
    )


@pytest.mark.parametrize("seed,n_pairs,cap,n_points,obs_cap", [
    (1, 3, 16, 32, 4), (2, 8, 64, 40, 8), (3, 4, 32, 8, 2)])
def test_accumulate_obs_equals_reference(monkeypatch, seed, n_pairs, cap, n_points, obs_cap):
    """Random point ids, some out of range, a third masked; the last case
    overflows the per-point cap."""
    d = _pair_obs(np.random.default_rng(seed), n_pairs, cap, n_points)
    tables, counts = native.accumulate_obs(**d, n_points=n_points, obs_cap=obs_cap)
    assert counts.dtype == np.int32 and counts.max() <= obs_cap

    def check(ref):
        ref_tables, ref_counts = ref
        np.testing.assert_array_equal(counts, ref_counts)
        assert tables.keys() == ref_tables.keys()
        for k, v in ref_tables.items():
            assert tables[k].dtype == v.dtype, k
            np.testing.assert_array_equal(tables[k], v, err_msg=k)

    if jnative.available():
        check(jnative.accumulate_obs(**d, n_points=n_points, obs_cap=obs_cap))
    monkeypatch.setattr(jnative, "_load", lambda: None)
    check(jnative.accumulate_obs(**d, n_points=n_points, obs_cap=obs_cap))

    # the keyframe chain's device scatter: the same tables, and the count
    # of what the cap dropped
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    obs, dropped = mapper.accumulate_obs_device(
        t["pid"].long(), t["mask"], t["uv1"], t["warped"], t["J12"], t["Huu"], t["Hvv"],
        n_points, obs_cap)
    for ours, k in ((obs.uv1, "uv1"), (obs.uv2, "uv2"), (obs.J12, "J12"), (obs.Huu, "Huu"),
                    (obs.Hvv, "Hvv"), (obs.mask, "mask")):
        np.testing.assert_array_equal(ours.numpy(), tables[k], err_msg=k)
    ok = d["mask"] & (d["pid"] >= 0) & (d["pid"] < n_points)
    assert int(dropped) == int(ok.sum()) - int(counts.sum())
