"""Tests of the port that need a CUDA card (marker ``cuda``).

They skip on a host without one; on the card run
``python -m pytest tests/test_torch_cuda.py -m cuda``.  This file imports
no JAX, so it runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from defslam_tpu_torch.ops import cuda_build, hamming


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hamming kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(2048, 1536), (200, 333), (256, 128), (1, 1)])
def test_hamming_kernel_matches_plain(cuda_device, n, m):
    rng = np.random.default_rng(n * 7 + m)
    a = torch.as_tensor(rng.integers(-2**31, 2**31, (n, 8)).astype(np.int32), device=cuda_device)
    b = torch.as_tensor(rng.integers(-2**31, 2**31, (m, 8)).astype(np.int32), device=cuda_device)
    before = cuda_build.LAUNCHES["hamming_matrix"]
    out = hamming.hamming_matrix(a, b)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["hamming_matrix"] == before + 1
    assert torch.equal(out, hamming.hamming_matrix_plain(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["path", "ragged", "one", "outside", "dead", "ties"])
def test_windowed_match_kernel_matches_plain(cuda_device, case):
    """The cases of ``chip_smoke.windowed_cases``: the mapping path's
    shape, ragged shapes, one element, nothing in the window, dead rows and
    pairs, and minima tied across lanes and column tiles."""
    from chip_smoke import windowed_cases
    from defslam_tpu_torch.config import Config
    from defslam_tpu_torch.ops import matching, windowed_match as wm

    args, radius = windowed_cases(Config(), cuda_device)[case]
    before = cuda_build.LAUNCHES["windowed_match"]
    out = wm.windowed_match(*args, radius, matching.INVALID)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["windowed_match"] == before + 1
    ref = wm.windowed_match_plain(*args, radius, matching.INVALID)
    for o, r, name in zip(out, ref, ("best", "idx", "second")):
        assert o.dtype == r.dtype and torch.equal(o, r), (case, name)
    if case == "outside":
        assert (out[0] == matching.INVALID).all() and (out[1] == 0).all()
    if case == "ties":
        assert (out[0] == out[2]).all()
