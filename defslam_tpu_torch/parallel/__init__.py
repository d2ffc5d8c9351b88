"""Multi-device execution on ``torch.distributed``.

Port of ``defslam_tpu/parallel``.  A JAX mesh spans many devices inside one
process; ``torch.distributed`` has one device per process, so a world of N
processes stands in for an N-device mesh.  Every rank runs the whole
``System`` on the same frames (SPMD); each computes its own share of the
sharded work and all of the replicated work.

- :mod:`defslam_tpu_torch.parallel.sharded`: the group of ranks and the
  sharded solvers (pair-sharded warp fits, point-sharded normal solves,
  observation-sharded SfT with all-reduced normal equations).
- :func:`init_distributed` / :func:`shutdown`: the process group.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist


def init_distributed(cfg, device, timeout: float | None = None) -> bool:
    """Bring up the default process group for ``Config.parallel`` on
    ``device``: NCCL for a CUDA device, gloo for the CPU.  With
    ``parallel.coordinator`` set, ``num_processes`` ranks meet there
    (``host:port`` means ``tcp://host:port``; a URL such as ``file://path``
    is taken as it is) and this process is rank ``process_id``; without
    one, a world of 1 on an in-process ``dist.HashStore`` (no port, no
    file).  ``timeout`` (seconds) bounds every collective, so a rank that
    falls out of step fails instead of hanging.  Idempotent; raises when
    the group that is up has another backend than ``device`` needs.
    Returns whether the group spans more than one process."""
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"a {dist.get_backend()} process group is up; a {torch.device(device).type} "
                f"System needs {backend}: call parallel.shutdown() first")
        return dist.get_world_size() > 1
    pc = cfg.parallel
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    if pc.coordinator:
        url = pc.coordinator if "://" in pc.coordinator else f"tcp://{pc.coordinator}"
        dist.init_process_group(backend, init_method=url, world_size=pc.num_processes,
                                rank=pc.process_id, **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0, **kw)
    return dist.get_world_size() > 1


def shutdown() -> None:
    """Destroy the default process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()
