"""Carry configuration and map state from the JAX package into the port.

A map SLAM system has no weights: what the two packages share is the map
state (point store, keyframe store, template, pose) and, for the keyframe
step, a frame's features and matches and the mapping chain's intermediate
tuples.  These functions take plain numpy arrays (``np.asarray`` of the JAX
package's arrays) and build the port's structures, so a test can start both
packages from the same state.  uint32 descriptor words are reinterpreted as int32 with the same
bits; index fields become int64.  :func:`numpy_from_tensor` is the reverse
rule, so the port writes the JAX package's dtypes (its checkpoints).

The rigid mode's structures come across the same way (``init``,
``ba_problem``, ``ba_result``, ``sim3``, ``loop``), and
:func:`rigid_state_to_numpy` / :func:`load_rigid_state` carry a whole
``RigidSystem``: its stores, pose, motion model and the host arrays of its
bookkeeping.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from defslam_tpu_torch.config import Config, _build
from defslam_tpu_torch.frontend import Features
from defslam_tpu_torch.mapping.mapper import CovisPairs, KFCarry
from defslam_tpu_torch.mapping.normals import PairObs
from defslam_tpu_torch.mapping.warp import DiffProps
from defslam_tpu_torch.mapstore.state import KeyframeStore, PointStore
from defslam_tpu_torch.rigid.ba import BAProblem, BAResult
from defslam_tpu_torch.rigid.initializer import InitResult
from defslam_tpu_torch.rigid.loop_closing import LoopCandidate, Sim3Estimate
from defslam_tpu_torch.template.mesh import Template
from defslam_tpu_torch.tracking.tracker import FrameMatches

# the structures a test may carry across, by the name of their part
_PARTS = {
    "points": PointStore, "kfs": KeyframeStore, "template": Template,
    "feats": Features, "matches": FrameMatches, "covis": CovisPairs,
    "diff_props": DiffProps, "pair_obs": PairObs, "carry": KFCarry,
    # the rigid mode
    "init": InitResult, "ba_problem": BAProblem, "ba_result": BAResult, "sim3": Sim3Estimate,
    "loop": LoopCandidate,
}

# int32 fields of the JAX stores that the port holds as int64 indices
_INDEX_FIELDS = {
    "facet", "ref_kf", "ref_kp", "point_id", "frame_id", "obs_face",
    # FrameMatches and CovisPairs
    "kp_of_point", "n_matches", "n_dropped", "pair_kf", "pid_table", "kp_new", "kp_other",
    "n_pairs", "n_pair_dropped", "n_pt_dropped",
    # KFCarry
    "slot", "kf_t",
    # BAProblem, LoopCandidate
    "pid", "kf", "match_idx",
}

# RigidSystem's host state besides its stores, pose and motion model
_RIGID_HOST = ("frame_id", "frames_since_kf", "_n_kf_inserted", "loops_closed",
               "_visible", "_found", "_born_kf")


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
    carry: KFCarry | None = None
    init: InitResult | None = None
    ba_problem: BAProblem | None = None
    ba_result: BAResult | None = None
    sim3: Sim3Estimate | None = None
    loop: LoopCandidate | None = None


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


def numpy_from_tensor(name: str, t: torch.Tensor) -> np.ndarray:
    """A tensor as the JAX package holds the same field: descriptor words as
    uint32 (same bits), index fields as int32; other dtypes unchanged."""
    a = t.detach().cpu().numpy()
    if name == "desc" and a.dtype == np.int32:
        return a.view(np.uint32)
    if name in _INDEX_FIELDS and a.dtype == np.int64:
        return a.astype(np.int32)
    return a


def namedtuple_from_numpy(cls, d: dict, device, prefix: str = ""):
    """Build NamedTuple ``cls`` from ``d[prefix + field]`` for every field."""
    return cls(**{
        f: tensor_from_numpy(f, d[prefix + f], device) for f in cls._fields
    })


def state_from_numpy(d: dict[str, np.ndarray], device) -> MapState:
    """The port's map state from flat numpy arrays keyed ``<part>.<field>``
    for the parts of ``_PARTS`` (``points``, ``kfs``, ``template``,
    ``feats``, ``matches``, ``covis``, ``diff_props``, ``pair_obs``,
    ``carry``: the keyframe step's first half's hand-over), plus
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


def rigid_state_to_numpy(rsys) -> dict[str, np.ndarray]:
    """A ``RigidSystem``'s state (of either package) as flat numpy arrays:
    ``kfs.*``, ``points.*``, ``pose``, ``velocity`` and ``rigid.<name>``
    for its state enum's value and host bookkeeping."""
    d = to_numpy_dict(kfs=rsys.kfs, points=rsys.points)
    d["pose"] = np.asarray(rsys.pose)
    d["velocity"] = np.asarray(rsys.velocity)
    d["rigid.state"] = np.asarray(rsys.state.value)
    for name in _RIGID_HOST:
        d[f"rigid.{name}"] = np.array(getattr(rsys, name), copy=True)
    return d


def load_rigid_state(rsys, d: dict) -> None:
    """Set the port's ``RigidSystem`` to the state of
    :func:`rigid_state_to_numpy`; the features of an unfinished
    initialization are not carried."""
    from defslam_tpu_torch.rigid.system import RigidState

    st = state_from_numpy(d, rsys.device)
    rsys.kfs, rsys.points = st.kfs, st.points
    rsys.pose = st.pose
    rsys.velocity = tensor_from_numpy("velocity", d["velocity"], rsys.device).float()
    rsys.state = RigidState(int(d["rigid.state"]))
    rsys._init_feats = None
    for name in _RIGID_HOST:
        v = np.asarray(d[f"rigid.{name}"])
        setattr(rsys, name, v.copy() if v.ndim else int(v))
