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
@pytest.mark.parametrize("n,m", [(2048, 1536), (200, 333), (256, 128), (1, 1),
                                 (2049, 1537), (17, 9), (5, 4), (64, 1535)])
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
def test_hamming_kernel_sign_bit_words(cuda_device):
    """Every word 0x80000000 or 0xFFFFFFFF: the kernel must treat the int32
    words as unsigned bits."""
    from chip_smoke import hamming_cases

    a, b = hamming_cases(cuda_device)["signbit"]
    assert (a < 0).all() and (b < 0).all()
    out = hamming.hamming_matrix(a, b)
    torch.cuda.synchronize()
    assert torch.equal(out, hamming.hamming_matrix_plain(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2])
def test_hamming_kernel_writes_into_out(cuda_device, offset):
    """``out=``: the same buffer comes back, and an output that is not
    16-byte aligned (offsets 1 and 2) takes the kernel's 4-byte stores."""
    rng = np.random.default_rng(5)
    n, m = 100, 64
    a = torch.as_tensor(rng.integers(-2**31, 2**31, (n, 8)).astype(np.int32), device=cuda_device)
    b = torch.as_tensor(rng.integers(-2**31, 2**31, (m, 8)).astype(np.int32), device=cuda_device)
    flat = torch.full((n * m + 8,), -7, dtype=torch.int32, device=cuda_device)
    out = flat[offset:offset + n * m].view(n, m)
    got = hamming.hamming_matrix(a, b, out=out)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(out, hamming.hamming_matrix_plain(a, b))
    assert (flat[:offset] == -7).all() and (flat[offset + n * m:] == -7).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["path", "ragged", "one", "outside", "dead", "ties",
                                  "nan", "wide", "dense", "deadpairs", "overflow"])
def test_windowed_match_kernel_matches_plain(cuda_device, case):
    """The cases of ``chip_smoke.windowed_cases``: the mapping path's
    shape, ragged shapes, one element, nothing in the window, dead rows and
    pairs, minima tied across lanes and warps, NaN positions, more columns
    than one staged round, every pair admitted (the row queues overflow),
    only pair 0 alive, and rows that overflow their queue beside rows that
    do not in one warp."""
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
    if case == "deadpairs":
        assert (out[0][1:] == matching.INVALID).all() and (out[1][1:] == 0).all()


@pytest.mark.cuda
def test_windowed_match_kernel_writes_into_out(cuda_device):
    """``out=``: best and second are the two planes of the given int32
    buffer, idx the given int64 tensor, with one launch and no cast."""
    from chip_smoke import windowed_cases, windowed_out
    from defslam_tpu_torch.config import Config
    from defslam_tpu_torch.ops import matching, windowed_match as wm

    args, radius = windowed_cases(Config(), cuda_device)["ragged"]
    pre = windowed_out(args[0].shape[0], args[0].shape[1], cuda_device)
    best, idx, second = wm.windowed_match(*args, radius, matching.INVALID, out=pre)
    torch.cuda.synchronize()
    assert best.data_ptr() == pre[0][0].data_ptr() and second.data_ptr() == pre[0][1].data_ptr()
    assert idx.data_ptr() == pre[1].data_ptr() and idx.dtype == torch.int64
    ref = wm.windowed_match_plain(*args, radius, matching.INVALID)
    assert all(torch.equal(o, r) for o, r in zip((best, idx, second), ref))
