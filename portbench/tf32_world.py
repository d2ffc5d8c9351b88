"""The TF32 control of a System that spans a world of ranks.

The control runs the program with TF32 allowed, and at world N it has to
be allowed in every rank: a rank that computes apart from the others
leaves the collectives' order (it rolls back a frame that they keep), and
the world hangs.  The workers are processes of their own, which turn TF32
off when they import the program (``defslam_tpu_torch.system``), after
their environment is read.  Each then unpickles the configuration that
rank 0 sends it, and unpickling imports the configuration's class: a
configuration of :class:`TF32Config` brings this module into the worker,
and its import allows TF32 there, for CUDA matmuls and cuDNN alike, as
``bench.set_tf32(True)`` does in rank 0.
"""

from __future__ import annotations

import dataclasses

import torch

from defslam_tpu_torch.config import Config

torch.backends.cuda.matmul.allow_tf32 = True
torch.backends.cudnn.allow_tf32 = True


@dataclasses.dataclass(frozen=True)
class TF32Config(Config):
    """A configuration whose worker processes compute in TF32."""


def tf32_allowed(system) -> bool:
    """Whether this rank allows TF32 (``driver.Driver.gather`` runs it on
    every rank)."""
    return torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
