"""The reduction from a trace and from spans to metrics, on synthetic
records."""

import numpy as np
import pytest

from portbench import bench, rooflines
from portbench.trace import Activity, Trace, busy_s, idle_gaps, top_device_ops, union_intervals

MS = 1_000_000  # ns


def _trace():
    dev = [Activity("hamming_kernel", 0, 2 * MS), Activity("elementwise", 1 * MS, 3 * MS),
           Activity("Memcpy HtoD", 5 * MS, 6 * MS), Activity("ncclDevKernel_AllReduce", 9 * MS,
                                                             10 * MS)]
    host = [Activity("cudaLaunchKernel", 0, MS // 2), Activity("cudaStreamSynchronize", 3 * MS,
                                                                 5 * MS + MS // 2),
            Activity("cudaMemcpyAsync", 6 * MS, 6 * MS + MS // 4)]
    return Trace(device=dev, host=host, wall_s=0.02)


def test_busy_time_is_the_union_of_the_device_intervals():
    t = _trace()
    assert union_intervals(t.device) == [(0, 3 * MS), (5 * MS, 6 * MS), (9 * MS, 10 * MS)]
    assert busy_s(t) == pytest.approx(0.005)
    assert [a.name for a in t.kernels] == ["hamming_kernel", "elementwise",
                                           "ncclDevKernel_AllReduce"]


def test_idle_gaps_are_named_by_the_host():
    gaps = dict(idle_gaps(_trace()))
    assert gaps == {"cudaStreamSynchronize": pytest.approx(0.002),
                    "after cudaMemcpyAsync": pytest.approx(0.003)}


def test_top_device_ops_sum_by_name():
    top = top_device_ops(_trace(), n=2)
    assert [n for n, _ in top] == ["hamming_kernel", "elementwise"]
    assert top[0][1] == pytest.approx(0.002)


def test_the_bounds_of_the_two_kernels():
    # B1 at the tracking shape: 12.7 MB written and read at 3.35 TB/s
    assert rooflines.b1_bound_s(2048, 1536) * 1e3 == pytest.approx(0.003790, rel=1e-3)
    # 4096 x 1536 (the rigid frame) and 1536 x 36864 (relocalization)
    assert rooflines.b1_bound_s(4096, 1536) * 1e3 == pytest.approx(0.0076, rel=1e-2)
    assert rooflines.b1_bound_s(1536, 36864) * 1e3 == pytest.approx(0.0680, rel=1e-2)
    rates = rooflines.card_rates(sms=132, mhz=1980.0)
    assert rates["instr_per_s"] == pytest.approx(33.45e12, rel=1e-3)
    # B2 with nothing admitted is bound by the window test of every pair
    t = rooflines.b2_bound_s(8, 1536, 1536, 0, rates)
    assert t == pytest.approx(4 * 8 * 1536 * 1536 / rates["instr_per_s"])


def _records(**kw):
    return bench.Records(cell="stereo0_stream", frames=2, trace=_trace(), **kw)


def test_metric_readers_on_synthetic_records():
    rec = _records(b1_shapes=[(2048, 1536)])
    b1 = bench.metric_module("b1_roofline_pct").read(rec)
    assert b1 == pytest.approx(100 * rooflines.b1_bound_s(2048, 1536) / 0.002)
    # a launch the shapes missed: nothing to read, never 0
    assert bench.metric_module("b1_roofline_pct").read(_records(b1_shapes=[])) is None
    assert bench.metric_module("b2_roofline_pct").read(rec) is None
    assert bench.metric_module("launches_per_frame").read(rec) == 1.5
    assert bench.metric_module("device_idle_pct").read(rec) is None
    rec.frame_s_after = [0.01, 0.01]  # 2.5 ms busy a frame in 10 ms
    assert bench.metric_module("device_idle_pct").read(rec) == pytest.approx(75.0)
    assert bench.metric_module("keyframe_ms").read(rec) is None
    rec.keyframe_steps = [{"warps_ms": 1.0, "keyframe_ms": 3.0}, {"keyframe_ms": 0.0},
                          {"warps_ms": 2.0, "keyframe_ms": 5.0}]
    assert bench.metric_module("keyframe_ms").read(rec) == 4.0
    rec.stages = {"frame.dispatch": {"count": 3, "mean_ms": 12.5}}
    assert bench.metric_module("dispatch_host_ms").read(rec) == 12.5
    rec.spans = {"rigid_pose": [3.0, 1.0, 2.0], "rigid_local_ba": [10.0]}
    assert bench.metric_module("rigid_pose_ms").read(rec) == 2.0
    assert bench.metric_module("rigid_local_ba_ms").read(rec) == 10.0
    rec.replays = {"extract_ms": 20.0, "sft_ms": 400.0}
    assert bench.metric_module("extract_ms").read(rec) == 20.0
    assert bench.metric_module("sft_ms").read(rec) == 400.0


def test_the_traced_frame_tail_is_the_p95_of_the_later_frames():
    read = bench.metric_module("traced_frame_ms_p95").read
    assert read(_records()) is None  # no frame after the profiled ones
    times = [0.4] * 18 + [1.0, 1.2]
    assert read(_records(frame_s_after=times)) == pytest.approx(
        float(np.percentile(np.asarray(times) * 1e3, 95)))


def test_reservoir_keeps_a_seeded_uniform_sample():
    import numpy as np

    def draw(seed):
        r = bench.Reservoir(3, np.random.default_rng(seed))
        for i in range(50):
            j = r.slot()
            if j is not None:
                r.items[j] = i
        return r.items

    assert draw(1) == draw(1) and len(draw(1)) == 3
    assert draw(1) != draw(2)
    counts = np.zeros(50)
    for s in range(400):
        counts[draw(s)] += 1
    assert counts.min() > 5  # every call can be drawn, late ones too
