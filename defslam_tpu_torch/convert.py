"""Carry configuration and map state from the JAX package into the port.

A map SLAM system has no weights: what the two packages share is the map
state (point store, keyframe store, template, pose) and, for the keyframe
step, a frame's features and matches and the mapping chain's intermediate
tuples.  These functions take plain numpy arrays (``np.asarray`` of the JAX
package's arrays) and build the port's structures, so a test can start both
packages from the same state.  uint32 descriptor words are reinterpreted as int32 with the same
bits; index fields become int64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from defslam_tpu_torch.config import Config, _build
from defslam_tpu_torch.frontend import Features
from defslam_tpu_torch.mapping.mapper import CovisPairs
from defslam_tpu_torch.mapping.normals import PairObs
from defslam_tpu_torch.mapping.warp import DiffProps
from defslam_tpu_torch.mapstore.state import KeyframeStore, PointStore
from defslam_tpu_torch.template.mesh import Template
from defslam_tpu_torch.tracking.tracker import FrameMatches

# the structures a test may carry across, by the name of their part
_PARTS = {
    "points": PointStore, "kfs": KeyframeStore, "template": Template,
    "feats": Features, "matches": FrameMatches, "covis": CovisPairs,
    "diff_props": DiffProps, "pair_obs": PairObs,
}

# int32 fields of the JAX stores that the port holds as int64 indices
_INDEX_FIELDS = {
    "facet", "ref_kf", "ref_kp", "point_id", "frame_id", "obs_face",
    # FrameMatches and CovisPairs
    "kp_of_point", "n_matches", "n_dropped", "pair_kf", "pid_table", "kp_new", "kp_other",
    "n_pairs", "n_pair_dropped", "n_pt_dropped",
}


class MapState(NamedTuple):
    points: PointStore | None
    kfs: KeyframeStore | None
    template: Template | None
    pose: torch.Tensor | None
    prev_pose: torch.Tensor | None
    feats: Features | None = None
    matches: FrameMatches | None = None
    covis: CovisPairs | None = None
    diff_props: DiffProps | None = None
    pair_obs: PairObs | None = None


def config_from_dict(d: dict) -> Config:
    """The port's Config from ``dataclasses.asdict`` of the JAX one."""
    return _build(Config, d)


def to_numpy_dict(**parts) -> dict[str, np.ndarray]:
    """Flatten NamedTuples (or single arrays) of array-likes into
    ``{"<part>.<field>": ndarray}`` / ``{"<part>": ndarray}``."""
    out = {}
    for name, obj in parts.items():
        if hasattr(obj, "_asdict"):
            for field, v in obj._asdict().items():
                out[f"{name}.{field}"] = np.asarray(v)
        else:
            out[name] = np.asarray(obj)
    return out


def tensor_from_numpy(name: str, a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype.kind in "iu" and name in _INDEX_FIELDS:
        a = a.astype(np.int64)
    return torch.as_tensor(np.array(a, copy=True, order="C"), device=device)


def namedtuple_from_numpy(cls, d: dict, device, prefix: str = ""):
    """Build NamedTuple ``cls`` from ``d[prefix + field]`` for every field."""
    return cls(**{
        f: tensor_from_numpy(f, d[prefix + f], device) for f in cls._fields
    })


def state_from_numpy(d: dict[str, np.ndarray], device) -> MapState:
    """The port's map state from flat numpy arrays keyed ``<part>.<field>``
    for the parts of ``_PARTS`` (``points``, ``kfs``, ``template``,
    ``feats``, ``matches``, ``covis``, ``diff_props``, ``pair_obs``), plus
    ``pose`` and ``prev_pose``; each part optional."""
    def part(name):
        if not any(k.startswith(name + ".") for k in d):
            return None
        return namedtuple_from_numpy(_PARTS[name], d, device, prefix=name + ".")

    def pose(name):
        return None if name not in d else tensor_from_numpy(name, d[name], device).float()

    return MapState(
        pose=pose("pose"), prev_pose=pose("prev_pose"), **{n: part(n) for n in _PARTS}
    )
