"""The port's tracer (``defslam_tpu_torch/profiling.py``): spans, their
parents, frame ids and self time, the timeline a ``torch.profiler``
session fills on the profiler's clock, the spans a System run records,
and the benchmark's readers of them.

On the CPU here; the last test (marker ``cuda``) needs a card:
``python -m pytest tests/test_torch_tracing.py -m cuda --noconftest``.
This file imports no JAX, so it runs where JAX is not installed.
"""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from defslam_tpu_torch import profiling
from defslam_tpu_torch.config import (
    CapacityConfig, Config, MappingConfig, OrbConfig, SfTConfig, TrackingConfig,
)
from defslam_tpu_torch.io.synthetic import make_sequence
from defslam_tpu_torch.system import System
from portbench import bench
from portbench.trace import Activity, Trace

MS = 1_000_000  # ns
FRAME_CHILDREN = {"frontend.extract", "tracking.match", "tracking.sft"}
KEYFRAME_STAGES = {"keyframe.insert", "keyframe.warps", "keyframe.densify", "keyframe.normals",
                   "keyframe.cull"}


@pytest.fixture(autouse=True)
def _tracer_off():
    """Each test starts and ends with the tracer off and nothing recorded."""
    profiling.enable(False)
    profiling.report(reset=True)
    profiling.timeline(reset=True)
    yield
    profiling.enable(False)
    profiling.report(reset=True)
    profiling.timeline(reset=True)


def _spin(seconds: float) -> None:
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        pass


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


# --------------------------------------------------------------- spans


def test_spans_nest_with_parents_frames_and_self_time():
    profiling.enable(True)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.stage("outer", frame=7):
            _spin(0.002)
            with profiling.stage("inner"):
                _spin(0.003)
                with profiling.stage("leaf", frame=3):
                    _spin(0.001)
            with profiling.stage("inner"):
                _spin(0.001)
        with profiling.stage("alone"):
            pass
    spans = _by_name(profiling.timeline())
    (outer,), inner, (leaf,), (alone,) = (spans[n] for n in ("outer", "inner", "leaf", "alone"))
    assert outer.parent is None and alone.parent is None
    assert [s.parent for s in inner] == [outer.id, outer.id]
    assert leaf.parent == inner[0].id
    # a frame id is the span's own or its parent's
    assert outer.frame == 7 and [s.frame for s in inner] == [7, 7] and leaf.frame == 3
    assert alone.frame is None
    for child, parent in ((inner[0], outer), (inner[1], outer), (leaf, inner[0])):
        assert parent.t0_ns <= child.t0_ns <= child.t1_ns <= parent.t1_ns
    rep = profiling.report()
    dur = {n: [(s.t1_ns - s.t0_ns) * 1e-6 for s in v] for n, v in spans.items()}
    assert rep["inner"]["count"] == 2
    assert rep["outer"]["self_ms"] == pytest.approx(dur["outer"][0] - sum(dur["inner"]))
    assert rep["inner"]["self_ms"] == pytest.approx((sum(dur["inner"]) - dur["leaf"][0]) / 2)
    assert rep["leaf"]["self_ms"] == pytest.approx(rep["leaf"]["mean_ms"])
    assert rep["outer"]["self_ms"] >= 1.9 and rep["inner"]["self_ms"] >= 1.9


def test_report_keeps_its_keys_for_frame_dispatch():
    profiling.enable(True)
    took = []
    for s in (0.001, 0.003):
        t = time.perf_counter()
        with profiling.stage("frame.dispatch", frame=1):
            _spin(s)
        took.append(time.perf_counter() - t)
    st = profiling.report()["frame.dispatch"]
    assert set(st) == {"count", "total_s", "mean_ms", "max_ms", "self_ms"}
    assert st["count"] == 2
    assert st["total_s"] == pytest.approx(sum(took), abs=2e-4)
    assert st["mean_ms"] == pytest.approx(1e3 * st["total_s"] / 2)
    assert st["max_ms"] == pytest.approx(1e3 * max(took), abs=0.2)
    assert st["self_ms"] == pytest.approx(st["mean_ms"])
    # the benchmark's reader of the span
    assert bench.metric_module("dispatch_host_ms").read(
        bench.Records(cell="x", stages=profiling.report())) == st["mean_ms"]


def test_off_records_nothing():
    assert profiling.stage("a") is profiling.stage("b", sync=torch.ones(2), frame=3)
    with profiling.stage("off_stage", frame=1):
        with profiling.stage("off_child"):
            pass
    assert profiling.report() == {} and profiling.timeline() == []


def test_a_span_around_an_op_contains_its_profiler_event():
    """Spans and the profiler's events share one clock, and the profiler's
    flag turns the timeline on with the tracer itself off."""
    a = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.stage("unit.op", frame=5):
            torch.mm(a, a)
    (span,) = profiling.timeline()
    assert (span.name, span.frame) == ("unit.op", 5)
    assert profiling.report() == {}  # enable() was off
    events = list(prof.profiler.kineto_results.events())
    (mm,) = [e for e in events if e.name() == "aten::mm"]
    assert span.t0_ns <= mm.start_ns() <= mm.start_ns() + mm.duration_ns() <= span.t1_ns
    # the span is also a record_function range of its name
    (rng,) = [e for e in events if e.name() == "unit.op"]
    assert span.t0_ns <= rng.start_ns() <= rng.start_ns() + rng.duration_ns() <= span.t1_ns


def test_the_timeline_survives_a_report_reset():
    profiling.enable(True)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.stage("kept"):
            pass
    profiling.report(reset=True)
    assert [s.name for s in profiling.timeline()] == ["kept"]
    assert [s.name for s in profiling.timeline(reset=True)] == ["kept"]
    assert profiling.timeline() == []


# ------------------------------------------------------ a System's spans


def _system(pipelined: bool) -> tuple[System, list]:
    seq = make_sequence(n_frames=6, height=120, width=160, max_amp=0.08)
    cfg = Config(
        camera=seq.camera,
        orb=OrbConfig(n_features=300, n_levels=3, max_keypoints=384),
        sft=SfTConfig(lm_iterations=15),
        tracking=TrackingConfig(keyframe_period=4, pipelined=pipelined),
        capacity=CapacityConfig(max_map_points=1024, max_keyframes=8),
        mapping=MappingConfig(points_to_template=60, chi_limit=0.2),
    )
    return System(cfg, device="cpu"), seq.frames


@pytest.mark.parametrize("pipelined", [False, True])
def test_a_system_run_records_the_layers_of_each_frame(pipelined):
    torch.set_num_threads(2)
    s, frames = _system(pipelined)
    s.track_monocular(frames[0], 0.0)  # the initialization, untraced
    profiling.enable(True)
    with profile(activities=[ProfilerActivity.CPU]):
        for t in range(1, len(frames)):
            s.track_monocular(frames[t], float(t))
        s.flush()
    rows = {r["frame"]: r for r in s._metrics}
    assert all(r["state"] == "OK" for r in rows.values())
    spans = profiling.timeline()
    by_id = {x.id: x for x in spans}
    names = _by_name(spans)
    dispatches = names["frame.dispatch"]
    assert [d.frame for d in dispatches] == list(range(1, len(frames)))
    for d in dispatches:
        kids = [x for x in spans if x.parent == d.id]
        assert sorted(x.name for x in kids) == sorted(FRAME_CHILDREN)
        assert all(x.frame == d.frame for x in kids)
    # a finalize that validates a frame carries that frame's id: depth 2
    # validates the frame dispatched two calls before
    depth = 2 if pipelined else 0
    waited = {by_id[x.parent].frame for x in names["host.wait"]
              if x.parent is not None and by_id[x.parent].name == "frame.finalize"}
    assert waited == set(range(1, len(frames) - depth)) if pipelined else not waited
    for d, f in zip(dispatches, names["frame.finalize"]):
        assert f.frame == max(1, d.frame - depth) and f.t0_ns >= d.t1_ns
    (kf,) = names["keyframe.dispatch"]
    assert rows[kf.frame]["keyframe"]
    stages = {x.name for x in spans if x.parent == kf.id}
    assert KEYFRAME_STAGES <= stages <= KEYFRAME_STAGES | {
        "host.wait", "keyframe.sfn_registration", "keyframe.retemplate", "keyframe.reanchor"}
    assert "host.wait" in stages  # the gate's read
    assert all(by_id[x.parent].name.startswith("keyframe.") for x in spans
               if x.name.startswith("keyframe.") and x.parent is not None)
    # the aggregates count the same spans
    rep = profiling.report()
    assert rep["frame.dispatch"]["count"] == len(dispatches)
    assert rep["tracking.sft"]["count"] == len(names["tracking.sft"]) >= len(dispatches)


def test_the_split_keyframe_halves_carry_the_keyframe_frame():
    torch.set_num_threads(2)
    seq = make_sequence(n_frames=7, height=120, width=160, max_amp=0.08)
    cfg = Config(
        camera=seq.camera,
        orb=OrbConfig(n_features=300, n_levels=3, max_keypoints=384),
        sft=SfTConfig(lm_iterations=15),
        tracking=TrackingConfig(keyframe_period=4, split_keyframe_dispatch=True),
        capacity=CapacityConfig(max_map_points=1024, max_keyframes=8),
        mapping=MappingConfig(points_to_template=60, chi_limit=0.2),
    )
    s = System(cfg, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        for t, f in enumerate(seq.frames):
            s.track_monocular(f, float(t))
        s.flush()
    names = _by_name(profiling.timeline())
    (a,), (b,) = names["keyframe.dispatch_a"], names["keyframe.dispatch_b"]
    assert a.frame == b.frame and b.t0_ns > a.t1_ns
    kids = {x.name for x in profiling.timeline() if x.parent == b.id}
    assert "keyframe.cull" in kids and "host.wait" in kids


# ------------------------------------------- the benchmark's span readers


def _spans(*rows):
    """Synthetic timeline rows: (name, t0 ms, t1 ms, id, parent)."""
    return [profiling.Span(n, int(a * MS), int(b * MS), i, p, 0) for n, a, b, i, p in rows]


def _trace():
    # device busy 0-1, 3-4, 8-9 ms: idle 1-3 and 4-8 ms
    dev = [Activity("k", 0, 1 * MS), Activity("k", 3 * MS, 4 * MS), Activity("k", 8 * MS, 9 * MS)]
    host = [Activity("cudaLaunchKernel", int(0.5 * MS), int(0.6 * MS)),
            Activity("cudaLaunchKernel", int(2.5 * MS), int(2.6 * MS)),
            Activity("cudaLaunchKernelExC", int(5.0 * MS), int(5.1 * MS)),
            Activity("cuLaunchKernel", int(6.0 * MS), int(6.1 * MS)),
            Activity("cudaMemcpyAsync", int(6.5 * MS), int(6.6 * MS)),
            Activity("cudaLaunchKernel", int(7.5 * MS), int(7.6 * MS))]
    return Trace(device=dev, host=host, wall_s=0.01)


TIMELINE = _spans(("frame.dispatch", 0, 7, 1, None), ("frontend.extract", 0, 2, 2, 1),
                  ("tracking.sft", 2, 6.5, 3, 1), ("host.wait", 4.5, 5.5, 4, 3))


def test_the_timeline_readers_on_a_synthetic_trace(monkeypatch):
    idle_mod = bench.metric_module("sft_idle_pct")
    launches = bench.metric_module("sft_launches_per_frame")
    rec = bench.Records(cell="stereo0_stream", frames=2, trace=_trace())
    monkeypatch.setattr(profiling, "timeline", lambda reset=False: [])
    assert idle_mod.read(rec) is None and launches.read(rec) is None
    monkeypatch.setattr(profiling, "timeline", lambda reset=False: TIMELINE)
    # idle 6 ms; inside tracking.sft: 2-3 and 4-6.5 ms
    assert idle_mod.read(rec) == pytest.approx(100 * 3.5 / 6)
    # the launches at 2.5, 5.0 and 6.0 ms start inside it; two frames
    assert launches.read(rec) == 1.5
    by = idle_mod.idle_by_span(rec.trace, TIMELINE)
    assert by == pytest.approx({"frontend.extract": 1e-3, "tracking.sft": 2.5e-3,
                                "host.wait": 1e-3, "frame.dispatch": 0.5e-3, None: 1e-3})
    assert sum(by.values()) == pytest.approx(6e-3)
    assert idle_mod.read(bench.Records(cell="x", frames=2)) is None


def test_the_stage_readers_on_synthetic_records():
    def st(count, mean_ms):
        return {"count": count, "total_s": count * mean_ms * 1e-3, "mean_ms": mean_ms}

    rec = bench.Records(cell="stereo0_stream", frame_s_after=[0.4] * 9, stages={
        "frontend.extract": st(10, 15.0), "tracking.sft": st(10, 380.0),
        "keyframe.dispatch": st(1, 650.0), "host.wait": st(12, 0.5),
        "rigid.pose": st(10, 450.0), "rigid.local_ba": st(2, 150.0)})
    read = {n: bench.metric_module(n).read(rec) for n in (
        "extract_host_ms", "sft_host_ms", "keyframe_host_ms", "host_wait_ms",
        "rigid_pose_host_ms", "rigid_local_ba_host_ms")}
    assert read == pytest.approx({"extract_host_ms": 15.0, "sft_host_ms": 380.0,
                                  "keyframe_host_ms": 650.0, "host_wait_ms": 0.6,
                                  "rigid_pose_host_ms": 450.0, "rigid_local_ba_host_ms": 150.0})
    # a split chain: both halves, over the steps begun
    rec.stages = {"keyframe.dispatch_a": st(2, 300.0), "keyframe.dispatch_b": st(1, 400.0)}
    assert bench.metric_module("keyframe_host_ms").read(rec) == pytest.approx(500.0)
    # nothing to read: None, never 0
    empty = bench.Records(cell="x")
    for n in read:
        assert bench.metric_module(n).read(empty) is None


# ------------------------------------------------------------- the card


@pytest.mark.cuda
def test_a_span_holds_its_kernel_launch_on_the_card():
    """In a CUDA-only profile, the runtime call that launches B1 lies inside
    the span around it, and the kernel starts after the span began, to
    50 us: the spans and the device trace share one clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hamming kernel has no CPU mode")
    from defslam_tpu_torch.ops import hamming

    tol = 50_000  # ns
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(3)
    a = torch.randint(-2**31, 2**31, (2048, 8), generator=g, dtype=torch.int64)
    b = torch.randint(-2**31, 2**31, (1536, 8), generator=g, dtype=torch.int64)
    a, b = a.to(torch.int32).to(dev), b.to(torch.int32).to(dev)
    hamming.hamming_matrix(a, b)  # built and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        with profiling.stage("unit.b1"):
            hamming.hamming_matrix(a, b)
        torch.cuda.synchronize()
    (span,) = profiling.timeline()
    events = list(prof.profiler.kineto_results.events())
    launch = [e for e in events if e.name().startswith(("cudaLaunchKernel", "cuLaunchKernel"))]
    kernel = [e for e in events if "hamming" in e.name()
              and str(e.device_type()).endswith("CUDA")]
    assert launch and len(kernel) == 1, [e.name() for e in events]
    for e in launch:
        assert span.t0_ns - tol <= e.start_ns() <= e.start_ns() + e.duration_ns() <= span.t1_ns + tol
    assert kernel[0].start_ns() >= span.t0_ns - tol
    assert kernel[0].start_ns() >= min(e.start_ns() for e in launch) - tol
