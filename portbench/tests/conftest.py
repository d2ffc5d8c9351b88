"""The benchmark's own tests: on the CPU at small sizes, and the card's
tests (marked ``cuda``), which skip without a card.

    python -m pytest portbench/tests -q            # here, on the CPU
    python -m pytest portbench/tests -q -m cuda    # on the card
"""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# a cell at a size a CPU test holds: the generator's 160x120 camera, a
# smaller frontend, map and mesh solve; the mix cut to 40 frames
TINY = {"camera": {"fx": 200.0, "fy": 200.0, "cx": 80.0, "cy": 60.0, "width": 160, "height": 120},
        "orb": {"n_features": 400, "n_levels": 3, "max_keypoints": 512},
        "sft": {"lm_iterations": 25},
        "tracking": {"keyframe_period": 4},
        "capacity": {"max_map_points": 2048, "max_keyframes": 10},
        "mapping": {"points_to_template": 60, "chi_limit": 0.2}}
TINY_MIX = {"n_frames": 40, "warmup_frames": 6, "check_frames": 4, "check_keyframes": 2}
SEED = 2**31 + 12345  # wider than 32 signed bits: a run takes any such seed


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny():
    """run_cell's keyword arguments for a CPU run at the small size."""
    torch.set_num_threads(4)
    return {"device": "cpu", "config_overrides": TINY, "mix_overrides": TINY_MIX}
