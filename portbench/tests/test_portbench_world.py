"""A System that spans a world of ranks (``parallel.enabled``), run through
the harness on the CPU: a world of 2 over gloo, this process rank 0 and
one worker process.  The harness captures the sharded SfT and the
host-orchestrated keyframe chain on rank 0, judges them against the
unsharded float64 reference, and takes the world down before judging.

The card's test (marked ``cuda``) runs the world of 4 on four cards: a
sound run is correct, and the TF32 control fails."""

import os
import types

import pytest
import torch

from defslam_tpu_torch.mapping import mapper
from defslam_tpu_torch.parallel import sharded
from defslam_tpu_torch.tracking import tracker
from portbench import bench
from portbench.tests.conftest import SEED, TINY, TINY_MIX

WORKER = "defslam_tpu_torch.parallel.worker"

# the limits proposed for the four-card cell (PERF.md, section 7): sound
# runs read at most 1.85e-4 and 1.3e-3 over 8 seeds, the TF32 control at
# least 6.3e-4 and 6.4e-3 over 3
WORLD4_LIMITS = {"sft": 4e-4, "sft_inliers": 3.5e-3}


def _world(n: int) -> dict:
    return dict(TINY, parallel={"enabled": True, "n_devices": n})


def _workers() -> list[int]:
    """Live worker processes of a world whose parent is this process."""
    me, out = str(os.getpid()), []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read()
        except OSError:
            continue
        if ppid == me and state != "Z" and WORKER.encode() in cmd:
            out.append(int(pid))
    return out


@pytest.fixture
def pids(monkeypatch):
    """The workers' process ids, by rank, as the run's world had them just
    before the harness took it down."""
    seen = {}
    orig = bench.close_world

    def close(system):
        seen.update(system._driver.pids)
        return orig(system)

    monkeypatch.setattr(bench, "close_world", close)
    return seen


def _run(tiny, n=2, **kw):
    # a world of 2 on the CPU tracks about one frame in 2 s: 15 s leave
    # frames whose successor's inputs are captured (``commit``) under load
    kw = dict(tiny, config_overrides=_world(n), **kw)
    return bench.run_cell("stereo0_stream", SEED, 15.0, False, **kw)


def test_a_world_of_two_is_captured_judged_and_taken_down(tiny, pids):
    out, samples = _run(tiny)
    assert out["correct"], out["compared"]
    checked = samples["checked"]
    assert checked["sft_n"] > 0 and checked["keyframe_n"] > 0, checked
    assert samples["detail"]["world"] == 2
    # the keyframe steps are the host-orchestrated chain's, judged part by part
    assert "keyframe.updated" in samples["detail"], sorted(samples["detail"])
    assert list(pids) == [1]
    assert samples["workers_left"] == [] and _workers() == []


def test_a_rank_that_leaves_out_its_own_share_fails(tiny, monkeypatch, pids):
    """Rank 0 (this process) zeroes its share before every all-reduce: every
    rank then sums the other ranks' shares alone, in step, and the frame's
    SfT solves half of its observations."""
    orig = sharded.Group.all_reduce

    def without_own(self, t):
        return orig(self, t.zero_())

    monkeypatch.setattr(sharded.Group, "all_reduce", without_own)
    out, samples = _run(tiny)
    assert not out["correct"]
    assert out["compared"]["sft"]["value"] > out["compared"]["sft"]["limit"], out["compared"]
    assert samples["workers_left"] == [] and _workers() == []


def test_the_tf32_control_reaches_every_rank(tiny, monkeypatch):
    """The control allows TF32 in the workers too, which turn it off when
    they import the program: each rank reads it allowed before the world
    is taken down."""
    allowed = []
    orig = bench.close_world

    def close(system):
        from portbench.tf32_world import tf32_allowed

        allowed.extend(system._driver.gather(system, tf32_allowed))
        return orig(system)

    monkeypatch.setattr(bench, "close_world", close)
    out, samples = _run(tiny, control="tf32")
    assert allowed == [True, True]
    assert samples["workers_left"] == [] and _workers() == []
    assert not torch.backends.cuda.matmul.allow_tf32  # the judge's, after the run


@pytest.mark.parametrize("world, hooked", [
    (1, [(tracker, "track_frame"), (mapper, "keyframe_step"), ("system", "_initialize")]),
    (4, [(tracker, "track_frame_parallel"), ("system", "_insert_keyframe_legacy"),
         ("system", "_initialize")]),
], ids=["world1", "world4"])
def test_the_hooks_follow_the_world(world, hooked):
    """A System with no group gets the hooks of one card, and only those; one
    with a group gets the sharded frame path and the legacy keyframe chain."""
    group = None if world == 1 else types.SimpleNamespace(size=world)
    system = types.SimpleNamespace(group=group, _initialize=lambda feats, ts: False,
                                   _insert_keyframe_legacy=lambda feats, m, r: False)
    mix = {"check_frames": 8, "check_keyframes": 10}
    capture = bench.Capture(bench.Program(), "deformable", mix, SEED)
    capture.install(system)
    try:
        got = [("system" if owner is system else owner, name) for owner, name, _ in capture._undo]
        assert got == hooked
        assert capture.world == world
    finally:
        capture.restore()
    assert tracker.track_frame.__module__ == tracker.__name__


@pytest.mark.cuda
def test_on_four_cards_a_sound_world_is_correct_and_the_tf32_control_fails(card):
    """The world of 4 at a size a test holds: the sound run is correct under
    the proposed limits, the TF32 control fails them by ``sft`` or
    ``sft_inliers``."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    kw = {"config_overrides": _world(4), "mix_overrides": TINY_MIX}
    sound, samples = bench.run_cell("stereo0_stream", SEED, 6.0, False, **kw)
    assert sound["correct"], sound["compared"]
    assert samples["detail"]["world"] == 4 and samples["workers_left"] == []
    for name, limit in WORLD4_LIMITS.items():
        assert sound["compared"][name]["value"] <= limit, sound["compared"]
    ctl, samples = bench.run_cell("stereo0_stream", SEED, 6.0, False, control="tf32", **kw)
    assert samples["workers_left"] == []
    assert any(ctl["compared"][name]["value"] > limit
               for name, limit in WORLD4_LIMITS.items()), ctl["compared"]
