"""Multi-device execution on ``torch.distributed``.

Port of ``defslam_tpu/parallel``.  A JAX mesh spans many devices inside one
process; ``torch.distributed`` has one device per process, so a world of N
processes stands in for an N-device mesh.  Every rank runs the whole
``System`` on the same frames (SPMD); each computes its own share of the
sharded work and all of the replicated work.

- :mod:`defslam_tpu_torch.parallel.sharded`: the group of ranks and the
  sharded solvers (pair-sharded warp fits, point-sharded normal solves,
  observation-sharded SfT with all-reduced normal equations).
- :mod:`defslam_tpu_torch.parallel.driver` and
  :mod:`~defslam_tpu_torch.parallel.worker`: a ``System`` built in a plain
  process spans the devices ``parallel.n_devices`` asks for, as the JAX
  System does: that process is rank 0 and sends each call to worker
  ranks, one card each.
- :mod:`defslam_tpu_torch.parallel.launch`: one launch of N ranks, one card
  each, for a world started by hand, and the process layer that the
  driver starts its workers with.
- :func:`place` / :func:`rank_device`: where this process sits in the
  world, and its card.
- :func:`init_distributed` / :func:`shutdown`: the process group.
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple

import torch
import torch.distributed as dist

# the launcher's environment (torchrun's names, and the rendezvous URL)
ENV_RENDEZVOUS = "DEFSLAM_RENDEZVOUS"


class Place(NamedTuple):
    """This process in its world: the rendezvous ("" for a world of 1 in
    this process), the world size and rank, and the rank and world size
    among the processes of this host (-1 where they are not known: then a
    rank takes the card its rank modulo the host's cards names)."""

    rendezvous: str
    world: int
    rank: int
    local_rank: int
    local_world: int


def place(cfg) -> Place:
    """From ``parallel.coordinator`` where it is set (``host:port`` means
    ``tcp://host:port``; a URL such as ``file://path`` is taken as it is;
    this host's ranks from ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` where they
    are set, since the world may span hosts), else from the environment of
    :mod:`~defslam_tpu_torch.parallel.launch`, else a world of 1."""
    pc = cfg.parallel
    e = os.environ
    if pc.coordinator:
        url = pc.coordinator if "://" in pc.coordinator else f"tcp://{pc.coordinator}"
        return Place(url, pc.num_processes, pc.process_id, int(e.get("LOCAL_RANK", -1)),
                     int(e.get("LOCAL_WORLD_SIZE", -1)))
    if e.get(ENV_RENDEZVOUS):
        return Place(e[ENV_RENDEZVOUS], int(e["WORLD_SIZE"]), int(e["RANK"]),
                     int(e["LOCAL_RANK"]), int(e["LOCAL_WORLD_SIZE"]))
    return Place("", 1, 0, 0, 1)


def check_cards(ranks: int, n_cards: int) -> None:
    """Raise unless ``ranks`` ranks on one host have ``n_cards`` CUDA cards,
    one each: two NCCL ranks cannot share a card."""
    if ranks > n_cards:
        raise RuntimeError(f"{ranks} ranks on this host need as many CUDA cards, and {n_cards} "
                           "are visible (NCCL puts no two ranks on one card)")


def rank_device(device, where: Place, n_cards: int) -> torch.device:
    """The device of a rank.  A CPU device stays as it is.  For CUDA in a
    world of more than one process, the host's ranks must have a card
    each where their count is known (:func:`check_cards`); then a device
    with an index stays as it is, and ``cuda`` becomes ``cuda:{local
    rank}`` (the launcher's, or the rank modulo ``n_cards``)."""
    dev = torch.device(device)
    if dev.type != "cuda" or where.world == 1:
        return dev
    if where.local_world > 0:
        check_cards(where.local_world, n_cards)
    if dev.index is not None:
        return dev
    local = where.local_rank if where.local_rank >= 0 else where.rank % max(n_cards, 1)
    return torch.device("cuda", local)


def init_distributed(cfg, device, timeout: float | None = None,
                     where: Place | None = None) -> bool:
    """Bring up the default process group for ``Config.parallel`` on
    ``device``: NCCL for a CUDA device, gloo for the CPU.  The ranks meet
    where ``where`` says (default :func:`place`); a world of 1 without a
    rendezvous runs on an in-process ``dist.HashStore`` (no port, no
    file).  For NCCL the rank's card (:func:`rank_device`) becomes this
    process's current card and the group's bound device.  ``timeout``
    (seconds) bounds every collective, so a rank that falls out of step
    fails instead of hanging.  Idempotent; raises when the group that is
    up has another backend than ``device`` needs.  Returns whether the
    group spans more than one process."""
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"a {dist.get_backend()} process group is up; a {dev.type} "
                f"System needs {backend}: call parallel.shutdown() first")
        return dist.get_world_size() > 1
    where = where or place(cfg)
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    if backend == "nccl":
        card = rank_device(dev, where, torch.cuda.device_count())
        if card.index is None:
            card = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(card)
        kw["device_id"] = card
    if where.rendezvous:
        dist.init_process_group(backend, init_method=where.rendezvous, world_size=where.world,
                                rank=where.rank, **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0, **kw)
    return dist.get_world_size() > 1


def shutdown() -> None:
    """Destroy the default process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()
