"""The device renderer against the port's numpy generator."""

import numpy as np
import pytest
import torch

from defslam_tpu_torch.io.synthetic import make_sequence
from portbench import render

MIX = dict(n_frames=24, camera_motion=0.9, rotation_deg=16.0, deform_modes=3, max_amp=0.07,
           brightness_drift=0.1)


@pytest.fixture(scope="module")
def both():
    seed = 2**31 + 7
    seq = make_sequence(height=120, width=160, seed=seed, **MIX)
    scene = render.Scene(dict(MIX, width=160, height=120), seed, "cpu")
    return seq, scene


def test_texture_matches_the_numpy_generator():
    from defslam_tpu_torch.io.synthetic import _texture

    t = render.texture(11, "cpu").numpy()
    np.testing.assert_allclose(t, _texture(1024, 1024, 11), rtol=0, atol=1e-3)


def test_frames_depths_and_poses_match_make_sequence(both):
    seq, scene = both
    for i in range(seq.frames.shape[0]):
        img, depth = scene.render(i)
        np.testing.assert_allclose(img.numpy(), seq.frames[i], rtol=0, atol=1e-3)
        np.testing.assert_allclose(depth.numpy(), seq.depths[i], rtol=1e-6, atol=0)
        np.testing.assert_array_equal(scene.pose(i), seq.poses[i])


def test_stream_plays_forwards_and_back():
    small = render.Scene(dict(MIX, n_frames=5, width=32, height=24), 3, "cpu")
    s = render.Stream(small)
    assert [s.index(k) for k in range(12)] == [0, 1, 2, 3, 4, 3, 2, 1, 0, 1, 2, 3]
    assert s.frames.dtype == torch.uint8 and s.frames.shape == (5, 24, 32)
    img, _ = small.render(2)
    assert torch.equal(s.frame(2), torch.round(img))
