"""The benchmark's four-card cell, ``stereo0_world4_stream``, by its name:
its entries in ``BENCHMARK.json`` and its files, a run of it through the
harness on the CPU (a world of 4 over gloo at a small size: this process
rank 0 and three worker processes), judged under the cell's own limits,
a planted fault that its limits catch, and the readers of its per-layer
metrics on synthetic records.

This file imports no JAX.
"""

import pytest
import torch

from defslam_tpu_torch.parallel import sharded
from portbench import bench
from portbench.tests.conftest import SEED, TINY, TINY_MIX
from portbench.tests.test_portbench_world import _workers
from portbench.trace import Activity, Trace

CELL = "stereo0_world4_stream"
METRICS = ("world_sft_host_ms", "all_reduces_per_frame", "all_reduce_ms",
           "world_keyframe_host_ms", "forward_host_ms")
# a world of 4 on the CPU tracks about a frame in 2 s: a window of 12 s
# keeps frames and a keyframe step to judge
SECONDS = 12.0


@pytest.fixture
def small():
    """run_cell's keyword arguments at the small size, at the configuration's
    own four ranks; one torch thread a rank."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield {"device": "cpu", "config_overrides": TINY, "mix_overrides": TINY_MIX}
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- its entries


def test_the_cell_is_the_four_card_deployment_of_the_shipped_operating_point():
    b = bench.load_benchmark()
    entry = bench.cell_entry(b, CELL)
    assert (entry["config"], entry["traffic"], entry["chips"]) == (
        "mandala_stereo0_world4", "handheld_stream", 4)
    world = bench.load_data("configs", "mandala_stereo0_world4")
    one = bench.load_data("configs", "mandala_stereo0")
    assert world["config"]["parallel"]["enabled"] and world["config"]["parallel"]["n_devices"] == 4
    # no other key of the one-card configuration changes
    assert {k: v for k, v in world["config"].items() if k != "parallel"} == {
        k: v for k, v in one["config"].items() if k != "parallel"}
    # the camera as in the one-card file; the parallel group is what this
    # deployment sets beyond the source, which runs in one process
    assert one["reduced"] == ["camera"] and world["reduced"] == ["camera", "parallel"]
    assert world["source"] != one["source"]
    entry = next(c for c in b["configs"] if c["name"] == "mandala_stereo0_world4")
    assert entry["reduced"] == world["reduced"]
    assert entry["source"] != next(c for c in b["configs"] if c["name"] == "mandala_stereo0")["source"]
    assert world["guarantees"] == one["guarantees"]
    # frames_per_s and setup_s; frame_ms_p95 spreads too widely at world 4
    assert [m["name"] for m in bench.cell_metrics(b, CELL, False)] == ["frames_per_s", "setup_s"]
    assert [m["name"] for m in bench.cell_metrics(b, CELL, True)] == list(METRICS)
    for name in METRICS:
        mod = bench.metric_module(name)
        assert not hasattr(mod, "replay")  # a collective replayed on rank 0 alone would hang
        assert not hasattr(mod, "SPANS")
    limits = bench.load_data("limits", CELL)
    assert all(limits[k] == 0.0 for k in ("init", "features", "match", "commit"))
    assert 0 < limits["sft"] and 0 < limits["sft_inliers"]


# ------------------------------------------------------------------- its runs


def test_a_world_of_four_runs_the_cell_correct_and_is_taken_down(small):
    out, samples = bench.run_cell(CELL, SEED, SECONDS, False, **small)
    assert out["correct"], out["compared"]
    assert set(out["compared"]) == set(bench.load_data("limits", CELL)) | {"ate"}
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
    assert samples["checked"]["sft_n"] > 0, samples["checked"]
    assert samples["detail"]["world"] == 4
    assert samples["workers_left"] == [] and _workers() == []


def test_a_rank_that_leaves_out_its_own_share_fails_the_cells_sft(small, monkeypatch):
    """Rank 0 (this process) zeroes its share before every all-reduce: every
    rank then sums the other ranks' shares alone, in step, and the frame's
    SfT solves three quarters of its observations."""
    orig = sharded.Group.all_reduce

    def without_own(self, t):
        return orig(self, t.zero_())

    monkeypatch.setattr(sharded.Group, "all_reduce", without_own)
    out, samples = bench.run_cell(CELL, SEED, SECONDS, False, **small)
    assert not out["correct"]
    assert out["compared"]["sft"]["value"] > out["compared"]["sft"]["limit"], out["compared"]
    assert samples["workers_left"] == [] and _workers() == []


# ------------------------------------------------------ its metrics' readers


def _st(count, mean_ms):
    return {"count": count, "total_s": count * mean_ms * 1e-3, "mean_ms": mean_ms}


def _trace():
    ms = 1_000_000  # ns
    dev = [Activity("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
                    0, 2 * ms),
           Activity("void at::native::vectorized_elementwise_kernel<4>", 2 * ms, 3 * ms),
           Activity("ncclKernel_AllReduce_RING_LL_Sum_float", 4 * ms, 5 * ms),
           Activity("Memcpy DtoH (Device -> Pinned)", 5 * ms, 6 * ms)]
    return Trace(device=dev, host=[], wall_s=0.01)


@pytest.mark.parametrize("name, value", [
    ("world_sft_host_ms", 450.0),
    ("all_reduces_per_frame", 125.0),
    ("all_reduce_ms", 1.5),
    ("world_keyframe_host_ms", 900.0),
    ("forward_host_ms", 3.0),
])
def test_a_reader_gives_its_value_and_none_without_its_span(name, value):
    """Nine frames after the profiled ones, and the last (the flush): ten;
    two profiled frames carry 3 ms of NCCL's kernels."""
    rec = bench.Records(cell=CELL, frames=2, trace=_trace(), frame_s_after=[0.7] * 9, stages={
        "parallel.sft": _st(11, 450.0), "keyframe.legacy": _st(1, 900.0),
        "parallel.forward": _st(11, 30 / 11), "tracking.sft": _st(10, 460.0),
        "parallel.all_reduce": {"count": 1250, "bytes": 1250 * 4096}})
    mod = bench.metric_module(name)
    assert mod.read(rec) == pytest.approx(value)
    # the parent commit's program: no span, no counter; an untraced window: no trace
    assert mod.read(bench.Records(cell=CELL, frames=2, frame_s_after=[0.7] * 9,
                                  stages={"tracking.sft": _st(10, 460.0)})) is None
    assert mod.read(bench.Records(cell=CELL)) is None
