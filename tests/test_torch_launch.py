"""``parallel.launch`` and the rank's device, on the CPU.

- The rank-device rule (``parallel.rank_device``, ``parallel.place``,
  ``system.resolve_device``) as pure functions with a faked card count,
  for a launch on one host and for a coordinator's world over hosts.
- Supervision: a rank that fails ends the launch with its exit code, and
  no process of any rank is left; past its timeout the launch ends with
  124; a rank out of step in a gloo collective is stopped, not waited for.
- The apps at world 2: ``python -m defslam_tpu_torch.cli synth --device
  cpu --config <parallel.enabled, n_devices 2>`` makes a world of two
  ranks (the app's process is rank 0, ``parallel.driver``); its
  ``Matches.txt``, ``Trajectory.txt`` and ``trajectory.txt`` equal,
  byte for byte, those of a world-2 System run on the same frames (this
  file run as a script through the launcher: ``python
  tests/test_torch_launch.py system yaml frames outdir``), and rank 1
  writes nothing.
"""

import dataclasses
import os
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from defslam_tpu_torch import parallel
from defslam_tpu_torch.config import Config, ParallelConfig
from defslam_tpu_torch.parallel import Place, launch, rank_device

ROOT = pathlib.Path(__file__).resolve().parent.parent
FRAMES = 9
SMALL = """\
orb:
  n_features: 300
  n_levels: 3
  max_keypoints: 384
sft:
  lm_iterations: 15
tracking:
  keyframe_period: 4
capacity:
  max_map_points: 512
  max_keyframes: 8
parallel:
  enabled: true
  n_devices: 2
"""
LAUNCH_ENV = {"PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""),
              "OMP_NUM_THREADS": "1"}


# -------------------------------------------------------- the rank's device --


def _launched(rank: int, world: int, local_world: int | None = None) -> Place:
    return Place("file:///x", world, rank, rank, world if local_world is None else local_world)


@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_rank_takes_its_own_card(rank):
    assert rank_device("cuda", _launched(rank, 4), n_cards=4) == torch.device("cuda", rank)
    # a coordinator's rank without LOCAL_RANK: the rank modulo the cards
    where = Place("tcp://h:1", 2, rank % 2, -1, -1)
    assert rank_device("cuda", where, n_cards=4) == torch.device("cuda", rank % 2)


def test_explicit_device_wins_and_world_1_and_cpu_stay():
    assert rank_device("cuda:2", _launched(1, 4), n_cards=4) == torch.device("cuda", 2)
    assert rank_device("cuda", Place("", 1, 0, 0, 1), n_cards=4) == torch.device("cuda")
    assert rank_device("cpu", _launched(3, 4), n_cards=0) == torch.device("cpu")


def test_a_coordinator_world_spans_hosts():
    """A coordinator's world counts its ranks over every host: two hosts of
    one card each (world 2) put each rank on its host's cuda:0, two hosts
    of 4 cards (world 8) rank 5 on cuda:1; an explicit card wins."""
    for rank in (0, 1):
        assert rank_device("cuda", Place("tcp://h:1", 2, rank, -1, -1),
                           n_cards=1) == torch.device("cuda", 0)
    assert rank_device("cuda", Place("tcp://h:1", 8, 5, -1, -1),
                       n_cards=4) == torch.device("cuda", 1)
    assert rank_device("cuda:3", Place("tcp://h:1", 8, 5, -1, -1),
                       n_cards=1) == torch.device("cuda", 3)
    # LOCAL_RANK / LOCAL_WORLD_SIZE, where set, place the rank on its host
    assert rank_device("cuda", Place("tcp://h:1", 8, 5, 2, 4),
                       n_cards=4) == torch.device("cuda", 2)


def test_more_ranks_than_cards_raises():
    with pytest.raises(RuntimeError, match="NCCL puts no two ranks on one card"):
        rank_device("cuda", _launched(0, 4), n_cards=2)
    with pytest.raises(RuntimeError):
        rank_device("cuda:0", _launched(0, 4), n_cards=2)
    with pytest.raises(RuntimeError):  # a coordinator's host with LOCAL_WORLD_SIZE 8
        rank_device("cuda", Place("tcp://h:1", 16, 5, 5, 8), n_cards=4)
    with pytest.raises(RuntimeError, match="2 are visible"):
        parallel.check_cards(4, 2)
    parallel.check_cards(4, 4)


def test_place_reads_the_coordinator_then_the_launcher(monkeypatch):
    for k in (parallel.ENV_RENDEZVOUS, "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    cfg = Config(parallel=ParallelConfig(enabled=True))
    assert parallel.place(cfg) == Place("", 1, 0, 0, 1)
    coord = Config(parallel=ParallelConfig(enabled=True, coordinator="h:29500",
                                           num_processes=2, process_id=1))
    assert parallel.place(coord) == Place("tcp://h:29500", 2, 1, -1, -1)
    monkeypatch.setenv(parallel.ENV_RENDEZVOUS, "file:///tmp/r")
    for k, v in (("RANK", "3"), ("WORLD_SIZE", "4"), ("LOCAL_RANK", "3"),
                 ("LOCAL_WORLD_SIZE", "4")):
        monkeypatch.setenv(k, v)
    assert parallel.place(cfg) == Place("file:///tmp/r", 4, 3, 3, 4)
    # the coordinator wins; this host's ranks come from the environment
    assert parallel.place(coord) == Place("tcp://h:29500", 2, 1, 3, 4)


def test_resolve_device_gives_a_launched_rank_its_card(monkeypatch):
    """``System``'s device rule with a faked host of 4 cards: rank 3 of a
    launch takes cuda:3; outside parallel mode, or with an explicit card,
    the device stays as asked; a launch of 4 on 2 cards raises."""
    from defslam_tpu_torch.system import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv(parallel.ENV_RENDEZVOUS, "file:///tmp/r")
    for k, v in (("RANK", "3"), ("WORLD_SIZE", "4"), ("LOCAL_RANK", "3"),
                 ("LOCAL_WORLD_SIZE", "4")):
        monkeypatch.setenv(k, v)
    par = Config(parallel=ParallelConfig(enabled=True))
    assert resolve_device(None, par) == torch.device("cuda", 3)
    assert resolve_device("cuda", par) == torch.device("cuda", 3)
    assert resolve_device("cuda:1", par) == torch.device("cuda", 1)
    assert resolve_device(None, Config()) == torch.device("cuda")
    assert resolve_device("cpu", par) == torch.device("cpu")
    assert launch.target_world(0, "cuda") == 4 and launch.target_world(0, "cpu") == 1
    assert launch.target_world(2, "cpu") == 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError):
        resolve_device(None, par)
    with pytest.raises(RuntimeError, match="2 are visible"):
        launch.launch([sys.executable, "-c", "pass"], 4, "cuda")


# ---------------------------------------------------------------- supervision --


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] not in ("Z", "X")
    except FileNotFoundError:
        return False


RANK_THAT_FAILS = """\
import os, subprocess, sys, time
r = int(os.environ["RANK"])
child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(120)"])
with open(os.path.join(sys.argv[1], f"pids{r}"), "w") as f:
    f.write(f"{os.getpid()} {child.pid}")
time.sleep(1.0)
if r == 1:
    raise SystemExit(3)
time.sleep(120)
"""


def test_a_failing_rank_stops_the_launch(tmp_path):
    t0 = time.monotonic()
    rc = launch.launch([sys.executable, "-c", RANK_THAT_FAILS, str(tmp_path)], 3, "cpu",
                       timeout=60)
    assert rc == 3 and time.monotonic() - t0 < 30
    pids = [int(p) for r in range(3) for p in (tmp_path / f"pids{r}").read_text().split()]
    assert len(pids) == 6 and not any(_alive(p) for p in pids)


def test_a_launch_past_its_timeout_stops_every_rank(tmp_path):
    t0 = time.monotonic()
    code = RANK_THAT_FAILS.replace("if r == 1:", "if False:")
    assert launch.launch([sys.executable, "-c", code, str(tmp_path)], 2, "cpu",
                         timeout=3) == launch.TIMED_OUT
    assert time.monotonic() - t0 < 20
    pids = [int(p) for r in range(2) for p in (tmp_path / f"pids{r}").read_text().split()]
    assert not any(_alive(p) for p in pids)


RANK_OUT_OF_STEP = """\
import torch
from defslam_tpu_torch import parallel
from defslam_tpu_torch.config import Config, ParallelConfig
cfg = Config(parallel=ParallelConfig(enabled=True))
parallel.init_distributed(cfg, "cpu", timeout=600)
if parallel.place(cfg).rank == 1:
    raise RuntimeError("rank 1 fails before the collective")
torch.distributed.all_reduce(torch.ones(4))
"""


def test_a_rank_out_of_step_is_stopped_not_waited_for(tmp_path, capfd):
    """Rank 0 waits in a gloo all-reduce with a 600 s timeout; rank 1
    raises: the launch ends at once, non-zero, with rank 1's traceback
    under its prefix."""
    t0 = time.monotonic()
    rc = launch.launch([sys.executable, "-c", RANK_OUT_OF_STEP], 2, "cpu", timeout=120,
                       env=LAUNCH_ENV)
    assert rc != 0 and time.monotonic() - t0 < 60
    assert re.search(r"^\[rank 1\] .*RuntimeError: rank 1 fails before the collective$",
                     capfd.readouterr().err, re.M)


# ------------------------------------------------------------ the app, world 2 --


def _system_rank(yaml: str, frames: int, outdir: str) -> None:
    """A rank of a world-2 System on the synth app's frames and config;
    rank 0 writes the metrics files and the TUM trajectory."""
    from defslam_tpu_torch.io.synthetic import make_sequence
    from defslam_tpu_torch.system import System
    from defslam_tpu_torch.viewer.export import export_trajectory_tum

    seq = make_sequence(n_frames=frames, height=240, width=320)
    cfg = dataclasses.replace(Config.from_yaml(yaml), camera=seq.camera)
    s = System(cfg, device="cpu")
    for t in range(frames):
        s.track_monocular(seq.frames[t], float(t))
    s.flush()
    if s.group.rank == 0:
        s.write_metrics(outdir)
        export_trajectory_tum(os.path.join(outdir, "trajectory.txt"), s.trajectory)
    s.shutdown()


def test_synth_app_at_world_2_writes_rank_0s_files(tmp_path):
    """The app's rank-0 files equal, byte for byte, those of a world-2
    System launched on the same frames and config (one torch thread a
    rank in both)."""
    cfg_file = tmp_path / "world2.yaml"
    cfg_file.write_text(SMALL)
    out, ref, cwd = tmp_path / "out", tmp_path / "ref", tmp_path / "cwd"
    ref.mkdir()
    cwd.mkdir()
    run = subprocess.run(
        [sys.executable, "-m", "defslam_tpu_torch.cli", "synth", "--frames", str(FRAMES),
         "--device", "cpu", "--config", str(cfg_file), "--out", str(out)],
        cwd=cwd, env=dict(os.environ, **LAUNCH_ENV), capture_output=True, text=True,
        timeout=300)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    # rank 0 is the app's own process; rank 1 prints no progress line and no summary
    assert re.search(rf"^processed {FRAMES} frames", run.stdout, re.M)
    assert "[rank 1]" not in run.stdout
    assert list(cwd.iterdir()) == []  # nothing written beside rank 0's files
    assert {p.name for p in out.iterdir()} >= {"Matches.txt", "trajectory.txt", "Trajectory.txt"}

    rc = launch.launch([sys.executable, __file__, "system", str(cfg_file), str(FRAMES),
                        str(ref)], 2, "cpu", timeout=300, env=LAUNCH_ENV)
    assert rc == 0
    rows = [r.split() for r in (out / "Matches.txt").read_text().splitlines()]
    assert len(rows) == FRAMES and [r[-1] for r in rows] == ["OK"] * FRAMES
    for name in ("Matches.txt", "Trajectory.txt", "trajectory.txt"):
        assert (out / name).read_text() == (ref / name).read_text(), name
    tum = np.loadtxt(out / "trajectory.txt")  # TUM: t, position, quaternion
    assert tum.shape == (FRAMES, 8) and np.isfinite(tum).all()


@pytest.mark.parametrize("extra", [["synth", "--config", "{yaml}", "--device", "cuda:1"]],
                         ids=["card-index"])
def test_app_at_world_2_refuses_what_one_rank_would_act_on(tmp_path, extra):
    """A card index for every rank raises before any rank starts (a
    camera, ``--step`` and ``--tune`` run at world 2: they act on rank 0,
    the app's own process; tests/test_torch_driver.py)."""
    from defslam_tpu_torch import cli

    cfg_file = tmp_path / "world2.yaml"
    cfg_file.write_text(SMALL)
    argv = [a.format(yaml=cfg_file) for a in extra]
    if "--device" not in argv:
        argv += ["--device", "cpu"]
    with pytest.raises(SystemExit, match="world of 2"):
        cli.main(argv)


if __name__ == "__main__":
    if sys.argv[1] == "system":
        _system_rank(sys.argv[2], int(sys.argv[3]), sys.argv[4])
