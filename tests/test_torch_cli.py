"""The port's ``synth`` entry point, live tuning, restart and the offline
exports, on the CPU (``--device cpu``) at a small Config.

The CLI run is checked for the files the JAX package's ``synth`` app
writes (the metrics streams with ``--gt``, the snapshot) and their
formats; ``replace_path`` / ``reference_key_path`` must give the JAX
package's Config for the same overrides (equal field by field).
"""

import dataclasses

import numpy as np
import pytest
import torch

from defslam_tpu import config as jconfig
from defslam_tpu_torch import cli
from defslam_tpu_torch import config as tconfig
from defslam_tpu_torch.convert import config_from_dict
from defslam_tpu_torch.io.synthetic import make_sequence
from defslam_tpu_torch.system import System
from defslam_tpu_torch.viewer import export

torch.set_num_threads(2)

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
"""


def test_synth_cli_writes_metrics_and_snapshot(tmp_path, capsys):
    cfg_file = tmp_path / "small.yaml"
    cfg_file.write_text(SMALL)
    out = tmp_path / "out"
    rc = cli.main(["synth", "--frames", "6", "--gt", "--out", str(out), "--device", "cpu",
                   "--config", str(cfg_file)])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "frame     5 [             OK]" in printed and "processed 6 frames" in printed
    matches = [r.split() for r in (out / "Matches.txt").read_text().splitlines()]
    assert len(matches) == 6 and all(r[-1] == "OK" for r in matches)
    assert [int(r[3]) for r in matches] == [1, 0, 0, 0, 1, 0]  # keyframes at 0 and 4
    tum = np.loadtxt(out / "trajectory.txt")
    assert tum.shape == (6, 8) and np.isfinite(tum).all()
    np.testing.assert_allclose(np.linalg.norm(tum[:, 4:], axis=1), 1.0, atol=1e-5)
    assert len((out / "ErrorGTs0.txt").read_text().splitlines()) == 6
    for name in ("StatusTracking.txt", "MapPointUsage.txt", "Trajectory.txt",
                 "ScaleVariation.txt", "template.obj", "template_rest.obj",
                 "template_hist_000004.obj"):
        assert (out / name).exists(), name
    obj = (out / "template.obj").read_text().splitlines()
    assert sum(r.startswith("v ") for r in obj) == 100 and sum(r.startswith("f ") for r in obj) == 162


@pytest.mark.parametrize("key,value", [("Regularizer.laplacian", 0.25),
                                       ("sft.lm_iterations", 12.0),
                                       ("LocalMapping.pointsToTemplate", "80"),
                                       ("Viewer.SaveResults", 1)])
def test_replace_path_matches_reference(key, value):
    ref = jconfig.replace_path(jconfig.Config(), jconfig.reference_key_path(key), value)
    got = tconfig.replace_path(tconfig.Config(), tconfig.reference_key_path(key), value)
    assert got == config_from_dict(dataclasses.asdict(ref))
    with pytest.raises(KeyError):
        tconfig.replace_path(tconfig.Config(), tconfig.reference_key_path("sft.no_such"), 1)


def test_tuning_restart_and_exports(tmp_path):
    seq = make_sequence(n_frames=4, height=120, width=160, max_amp=0.05)
    cfg = dataclasses.replace(
        tconfig.Config(camera=seq.camera),
        orb=tconfig.OrbConfig(n_features=300, n_levels=3, max_keypoints=384),
        capacity=tconfig.CapacityConfig(max_map_points=512, max_keyframes=8),
    )
    s = System(cfg, device="cpu")
    for t in range(3):
        s.track_monocular(seq.frames[t], float(t))
    tune = tmp_path / "tune.yaml"
    tune.write_text("Regularizer.laplacian: 0.5\nsft.lm_iterations: 7\n")
    cli._TuneWatcher(str(tune)).poll(s)
    assert s.cfg.regularizer.laplacian == 0.5 and s.cfg.sft.lm_iterations == 7
    assert s.track_monocular(seq.frames[3], 3.0) is not None
    s.restart()
    assert torch.equal(s.template.nodes, s.template.nodes_rest)
    s.flush()
    s.shutdown()
    export.snapshot(s, str(tmp_path / "snap"), tag="_x")
    assert (tmp_path / "snap" / "template_x.obj").exists()
    tum = np.loadtxt(tmp_path / "snap" / "trajectory_x.txt")
    assert tum.shape == (4, 8)
