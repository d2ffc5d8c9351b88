"""The tracer in a System that spans a world of ranks (``parallel.enabled``):
the spans ``parallel.forward``, ``parallel.sft`` and ``keyframe.legacy``
(with its stages) and the counter ``parallel.all_reduce``, on the CPU in
a world of 2 over gloo (this process rank 0, one worker process), at a
small size, a few frames and one keyframe; and that a System on one
device, or the tracer off, records none of them.

This file imports no JAX.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from defslam_tpu_torch import profiling
from defslam_tpu_torch.config import (CapacityConfig, Config, MappingConfig, OrbConfig,
                                      ParallelConfig, SfTConfig, TrackingConfig)
from defslam_tpu_torch.io.synthetic import make_sequence
from defslam_tpu_torch.system import System

WORLD_NAMES = {"parallel.forward", "parallel.sft", "keyframe.legacy", "parallel.all_reduce"}
LEGACY_STAGES = {"keyframe.insert", "keyframe.warps", "keyframe.densify", "keyframe.normals",
                 "keyframe.sfn_registration"}
LEGACY_SWAP = {"keyframe.retemplate", "keyframe.cull", "keyframe.reanchor"}
N_FRAMES = 7  # frame 0 initializes; the keyframe is frame 4, and it swaps the template
UNTRACED = 2  # frames 0 and 1 run with the tracer off


@pytest.fixture(autouse=True)
def _tracer_off_one_thread():
    """Each test starts and ends with the tracer off and nothing recorded;
    one torch thread in rank 0, so one in the worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.enable(False)
    profiling.report(reset=True)
    profiling.timeline(reset=True)
    yield
    profiling.enable(False)
    profiling.report(reset=True)
    profiling.timeline(reset=True)
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def seq():
    # camera motion 0.5 swaps the template at the keyframe (the sequence and
    # configuration of tests/test_torch_parallel_system.py)
    return make_sequence(n_frames=N_FRAMES, height=96, width=128, max_amp=0.04, seed=2,
                         camera_motion=0.5)


def _config(camera, world: int) -> Config:
    return Config(camera=camera, orb=OrbConfig(n_features=160, n_levels=2, max_keypoints=192),
                  sft=SfTConfig(lm_iterations=10), tracking=TrackingConfig(keyframe_period=4),
                  capacity=CapacityConfig(max_map_points=512, max_keyframes=8),
                  mapping=MappingConfig(schwarp_lm_iterations=1, points_to_template=60,
                                        chi_limit=0.2),
                  parallel=ParallelConfig(enabled=world > 1, n_devices=world if world > 1 else 0))


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def _traced(system, frames) -> list:
    """Frames UNTRACED.. with the tracer on and a CPU profiler session, and
    a flush; returns the timeline."""
    profiling.enable(True)
    with profile(activities=[ProfilerActivity.CPU]):
        for t in range(UNTRACED, len(frames)):
            system.track_monocular(frames[t], float(t))
        system.flush()
    profiling.enable(False)
    return profiling.timeline()


def test_a_world_of_two_records_its_spans_and_counts_its_all_reduces(seq):
    s = System(_config(seq.camera, 2), device="cpu")
    try:
        for t in range(UNTRACED):
            s.track_monocular(seq.frames[t], float(t))
        # the tracer off: the frame's all-reduces ran, and nothing was kept
        assert s.group.n_all_reduce > 0
        assert profiling.report() == {} and profiling.timeline() == []
        calls0, bytes0 = s.group.n_all_reduce, s.group.all_reduce_bytes
        spans = _traced(s, seq.frames)
        rep = profiling.report()
        calls, nbytes = s.group.n_all_reduce - calls0, s.group.all_reduce_bytes - bytes0
        rows = {r["frame"]: r for r in s._metrics}
    finally:
        s.shutdown()
    assert all(r["state"] == "OK" for r in rows.values())
    by_id = {x.id: x for x in spans}
    names = _by_name(spans)
    traced = list(range(UNTRACED, N_FRAMES))

    # rank 0 sends each call before it runs it: the frame it tracks, then
    # the flush, which serves the newest frame
    forward = names["parallel.forward"]
    assert [x.frame for x in forward] == traced + [traced[-1]]
    assert all(x.parent is None for x in forward)
    assert [x.frame for x in names["frame.dispatch"]] == traced

    # one sharded SfT inside each frame's tracking.sft, and the re-anchor's
    # inside keyframe.reanchor after a swap
    solves = names["parallel.sft"]
    for x in solves:
        parent = by_id[x.parent]
        assert parent.name in ("tracking.sft", "keyframe.reanchor"), parent.name
        assert x.frame == parent.frame
    for x in names["tracking.sft"]:
        assert [y.name for y in spans if y.parent == x.id] == ["parallel.sft"]
    (reanchor,) = names["keyframe.reanchor"]
    assert [y.name for y in spans if y.parent == reanchor.id] == ["tracking.match",
                                                                  "parallel.sft"]

    # the keyframe: the legacy chain, top level, with the fused chain's stage names
    (kf,) = names["keyframe.legacy"]
    assert kf.parent is None and rows[kf.frame]["keyframe"] and kf.frame in traced
    stages = {x.name for x in spans if x.parent == kf.id}
    assert stages == LEGACY_STAGES | LEGACY_SWAP and rows[kf.frame]["template"]
    assert all(x.frame == kf.frame for x in spans if x.parent == kf.id)
    for x in spans:
        if x.name.startswith("keyframe.") and x is not kf:
            assert by_id[x.parent].name.startswith("keyframe."), x.name

    # the aggregates count the same spans, and the counter every all-reduce
    for name in ("parallel.forward", "parallel.sft", "keyframe.legacy"):
        assert rep[name]["count"] == len(names[name])
    assert rep["parallel.all_reduce"] == {"count": calls, "bytes": nbytes}
    assert calls > len(traced)


def test_a_system_on_one_device_records_none_of_them(seq):
    s = System(_config(seq.camera, 1), device="cpu")
    assert s.group is None
    s.track_monocular(seq.frames[0], 0.0)
    s.track_monocular(seq.frames[1], 1.0)
    spans = _traced(s, seq.frames)
    rep = profiling.report()
    assert rep["keyframe.dispatch"]["count"] == 1  # the one-card chain ran
    assert not WORLD_NAMES & ({x.name for x in spans} | set(rep))


def test_the_counter_keeps_calls_and_bytes_while_on_and_resets():
    profiling.count("unit.counter", 100)  # off: not kept
    assert profiling.report() == {}
    profiling.enable(True)
    profiling.count("unit.counter", 100)
    profiling.count("unit.counter", 28)
    with profiling.stage("unit.span"):
        pass
    rep = profiling.report(reset=True)
    assert rep["unit.counter"] == {"count": 2, "bytes": 128}
    assert rep["unit.span"]["count"] == 1
    assert profiling.report() == {}
