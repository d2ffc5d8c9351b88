"""``parallel.driver``: a ``System`` that makes its world from the caller's
process, on the CPU over gloo (one torch thread a rank).

- Which calls go to every rank: every public method of ``System`` is on
  exactly one of the driver's lists.
- When a System makes a world (``driver.spans``), and that a card index
  for a world of several ranks is refused.
- Failure: a worker killed between calls or inside one makes rank 0's
  call raise ``RuntimeError`` naming its rank and exit code, at once (the
  bound is the collective timeout plus a few seconds); a worker that
  fails at its start makes ``System()`` raise; after either, and after
  ``shutdown()`` or the interpreter's exit without it, no process is left
  and a new world comes up.
- The apps at world 2 (``cli.main`` in this process, which is rank 0):
  ``mono`` from camera ``"0"`` through a ``load_video`` patched in this
  process alone (a worker that opened camera 0 would fail: the workers
  read nothing), ``--tune`` with a file that the reader writes at frame
  ``TUNE_AT``, and ``--step``.  Their result files must equal, byte for
  byte, those of an in-process world-2 ``System`` given the same frames
  and calls (``--step``: those of the run without it).
"""

import os
import pathlib
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from defslam_tpu_torch import cli, parallel
from defslam_tpu_torch.config import (CapacityConfig, Config, OrbConfig, ParallelConfig,
                                      SfTConfig, TrackingConfig, load_raw_yaml)
from defslam_tpu_torch.io import datasets
from defslam_tpu_torch.io.synthetic import make_sequence
from defslam_tpu_torch.parallel import driver
from defslam_tpu_torch.system import System
from defslam_tpu_torch.viewer import export

ROOT = pathlib.Path(__file__).resolve().parent.parent
N_FRAMES = 8
TUNE_AT = 4  # the frame after which the tuning file appears
APP_FILES = ("Matches.txt", "StatusTracking.txt", "MapPointUsage.txt", "Trajectory.txt",
             "trajectory.txt", "template.obj")
# raised within this of the call (the bound: the collective timeout plus a few seconds)
RAISE_BOUND_S = driver.COLLECTIVE_TIMEOUT_S + driver.EXIT_WAIT_S


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread in rank 0, so one in each worker (the driver gives
    the workers rank 0's count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def seq():
    return make_sequence(n_frames=N_FRAMES, height=120, width=160, max_amp=0.05)


def _settings(path: pathlib.Path, camera, outdir) -> str:
    """A nested-schema settings file at world 2 (the small sizes of
    tests/test_torch_launch.py)."""
    c = camera
    path.write_text(f"camera:\n  fx: {c.fx}\n  fy: {c.fy}\n  cx: {c.cx}\n  cy: {c.cy}\n"
                    f"  width: {c.width}\n  height: {c.height}\n"
                    "orb:\n  n_features: 300\n  n_levels: 3\n  max_keypoints: 384\n"
                    "sft:\n  lm_iterations: 15\n"
                    "tracking:\n  keyframe_period: 4\n"
                    "capacity:\n  max_map_points: 512\n  max_keyframes: 8\n"
                    "parallel:\n  enabled: true\n  n_devices: 2\n"
                    f"output_dir: {outdir}\n")
    return str(path)


def _world2(camera) -> Config:
    """The settings file's Config, in memory."""
    return Config(camera=camera, orb=OrbConfig(n_features=300, n_levels=3, max_keypoints=384),
                  sft=SfTConfig(lm_iterations=15), tracking=TrackingConfig(keyframe_period=4),
                  capacity=CapacityConfig(max_map_points=512, max_keyframes=8),
                  parallel=ParallelConfig(enabled=True, n_devices=2))


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] not in ("Z", "X")
    except FileNotFoundError:
        return False


def _children() -> list[int]:
    """The live child processes of this process."""
    me, out = os.getpid(), []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
            except (FileNotFoundError, ProcessLookupError):
                continue
            if int(fields[1]) == me and fields[0] not in ("Z", "X"):
                out.append(int(d))
    return out


def _gone(pids) -> None:
    deadline = time.monotonic() + 10
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not any(_alive(p) for p in pids), pids
    assert not torch.distributed.is_initialized()


# ------------------------------------------------------------- the lists --


def test_every_public_method_is_on_one_list():
    public = {n for n, v in vars(System).items() if callable(v) and not n.startswith("_")}
    lists = driver.FORWARDED + driver.FLUSHED + driver.LOCAL
    assert len(set(lists)) == len(lists), "a method on two lists"
    assert public == set(lists), ("on no list:", public - set(lists), "not a method:",
                                  set(lists) - public)


def test_when_a_system_makes_its_world(monkeypatch):
    """``parallel.enabled`` with ``n_devices`` 2 makes a world of 2 on the
    CPU (0 means every card on CUDA, 1 on the CPU); not inside a launched
    rank or with a group up; a card index for a world of 2 raises."""
    for k in (parallel.ENV_RENDEZVOUS, "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    two = Config(parallel=ParallelConfig(enabled=True, n_devices=2))
    assert driver.spans(two, "cpu") == 2
    assert driver.spans(Config(parallel=ParallelConfig(enabled=True)), "cpu") == 0
    assert driver.spans(Config(), "cpu") == 0
    with pytest.raises(ValueError, match="names one card for a world of 2"):
        driver.spans(two, "cuda:1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert driver.spans(Config(parallel=ParallelConfig(enabled=True)), "cuda") == 4
    for k, v in ((parallel.ENV_RENDEZVOUS, "file:///tmp/r"), ("RANK", "1"), ("WORLD_SIZE", "2"),
                 ("LOCAL_RANK", "1"), ("LOCAL_WORLD_SIZE", "2")):
        monkeypatch.setenv(k, v)
    assert driver.spans(two, "cpu") == 0  # a launched rank joins its world


# --------------------------------------------------------------- failure --


def test_a_worker_lost_between_calls_makes_the_next_call_raise(seq):
    s = System(_world2(seq.camera), device="cpu")
    for t in range(3):
        s.track_monocular(seq.frames[t], float(t))
    pids = list(s._driver.pids.values())
    os.kill(pids[0], signal.SIGKILL)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 exited -9"):
        s.track_monocular(seq.frames[3], 3.0)
    assert time.monotonic() - t0 < RAISE_BOUND_S
    _gone(pids)
    with pytest.raises(RuntimeError, match="world is down"):
        s.flush()
    # a new world comes up
    s2 = System(_world2(seq.camera), device="cpu")
    s2.track_monocular(seq.frames[0], 0.0)
    s2.shutdown()
    assert _children() == []


def test_a_worker_lost_inside_a_call_makes_it_raise(seq):
    """The worker is killed while rank 0 tracks frames: rank 0's gloo
    collective meets the lost rank and the call raises."""
    s = System(_world2(seq.camera), device="cpu")
    s.track_monocular(seq.frames[0], 0.0)
    pids = list(s._driver.pids.values())
    killer = threading.Timer(0.05, os.kill, (pids[0], signal.SIGKILL))
    t0 = time.monotonic()
    killer.start()
    with pytest.raises(RuntimeError, match="rank 1 exited -9"):
        for t in range(1, N_FRAMES):
            s.track_monocular(seq.frames[t], float(t))
        s.flush()
    killer.join()
    assert time.monotonic() - t0 < RAISE_BOUND_S
    _gone(pids)


def test_a_worker_that_fails_at_start_makes_system_raise(seq, monkeypatch):
    monkeypatch.setattr(driver, "WORKER", ("-c", "raise SystemExit(7)"))
    with pytest.raises(RuntimeError, match="rank 1 exited 7"):
        System(_world2(seq.camera), device="cpu")
    assert _children() == [] and not torch.distributed.is_initialized()


def test_shutdown_leaves_no_process(seq):
    s = System(_world2(seq.camera), device="cpu")
    assert s._driver.devices == ["cpu", "cpu"] and s.group.size == 2
    s.track_monocular(seq.frames[0], 0.0)
    pids = list(s._driver.pids.values())
    s.shutdown()
    _gone(pids)
    assert _children() == []


EXIT_WITHOUT_SHUTDOWN = """\
from defslam_tpu_torch.config import Config, ParallelConfig
from defslam_tpu_torch.system import System
s = System(Config(parallel=ParallelConfig(enabled=True, n_devices=2)), device="cpu")
print(*s._driver.pids.values(), flush=True)
"""


def test_exit_without_shutdown_stops_the_workers():
    run = subprocess.run([sys.executable, "-c", EXIT_WITHOUT_SHUTDOWN], capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert run.returncode == 0, run.stderr[-3000:]
    pids = [int(p) for p in run.stdout.split()]
    assert len(pids) == 1
    _gone(pids)


# -------------------------------------------------------------- the apps --


def _video(seq, opened: list, tune: pathlib.Path | None = None, tuning: str = ""):
    """``load_video`` of the test's frames; writes ``tune`` just before
    yielding frame ``TUNE_AT``."""
    def video(src):
        opened.append(src)
        for t in range(N_FRAMES):
            if tune is not None and t == TUNE_AT:
                tune.write_text(tuning)
            yield np.asarray(seq.frames[t]), t / 7.0

    return video


def _reference(yaml: str, seq, interactive: bool, tuned_after: int | None = None,
               tuning: dict | None = None) -> None:
    """The in-process world-2 System on the app's frames, with the app's
    flushes (``cli._progress``) and, after frame ``tuned_after``, its
    ``apply_tuning``; then the app's files."""
    cfg = Config.from_yaml(yaml)
    s = System(cfg, device="cpu")
    assert s.group.size == 2
    for t in range(N_FRAMES):
        s.track_monocular(np.asarray(seq.frames[t]), t / 7.0)
        cli._progress(s, interactive=interactive, show=False)
        if t == tuned_after:
            s.apply_tuning(tuning)
    s.write_metrics()
    export.snapshot(s, cfg.output_dir)
    s.shutdown()


def _same_files(a: pathlib.Path, b: pathlib.Path) -> None:
    for name in APP_FILES:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    rows = (a / "Matches.txt").read_text().splitlines()
    assert len(rows) == N_FRAMES and all(r.endswith("OK") for r in rows)


@pytest.fixture(scope="module")
def camera_app(seq, tmp_path_factory):
    """``mono`` from camera "0" at world 2: its output directory and the
    sources ``load_video`` was asked for."""
    root = tmp_path_factory.mktemp("camera")
    opened = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(datasets, "load_video", _video(seq, opened))
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            rc = cli.main(["mono", _settings(root / "app.yaml", seq.camera, root / "app"), "0",
                           "--device", "cpu"])
        finally:
            torch.set_num_threads(threads)
    assert rc == 0
    return root, opened


def test_mono_from_a_camera_at_world_2(camera_app, seq):
    root, opened = camera_app
    assert opened == [0]  # rank 0 opened camera 0, once
    _reference(_settings(root / "ref.yaml", seq.camera, root / "ref"), seq, interactive=False)
    _same_files(root / "app", root / "ref")


def test_step_at_world_2_waits_on_rank_0(camera_app, seq, monkeypatch, tmp_path):
    prompts = []
    monkeypatch.setattr("builtins.input", lambda *a: prompts.append(a) or "")
    monkeypatch.setattr(datasets, "load_video", _video(seq, []))
    rc = cli.main(["mono", _settings(tmp_path / "app.yaml", seq.camera, tmp_path / "app"), "0",
                   "--step", "--device", "cpu"])
    assert rc == 0 and len(prompts) == N_FRAMES
    _same_files(tmp_path / "app", camera_app[0] / "app")


def test_tune_at_world_2_reaches_every_rank(seq, monkeypatch, tmp_path):
    tune = tmp_path / "tune.yaml"
    tuning = "sft.lm_iterations: 8\nRegularizer.laplacian: 0.5\n"
    monkeypatch.setattr(datasets, "load_video", _video(seq, [], tune, tuning))
    rc = cli.main(["mono", _settings(tmp_path / "app.yaml", seq.camera, tmp_path / "app"), "0",
                   "--tune", str(tune), "--device", "cpu"])
    assert rc == 0
    _reference(_settings(tmp_path / "ref.yaml", seq.camera, tmp_path / "ref"), seq,
               interactive=True, tuned_after=TUNE_AT, tuning=load_raw_yaml(str(tune)))
    _same_files(tmp_path / "app", tmp_path / "ref")
    # and the tuning changed the run: the untuned run's rows differ after it
    untuned = tmp_path / "untuned"
    _reference(_settings(tmp_path / "untuned.yaml", seq.camera, untuned), seq, interactive=True)
    assert (tmp_path / "app" / "Trajectory.txt").read_text() != (untuned / "Trajectory.txt").read_text()
