"""The port's apps (``cli.py``: ``stereo``, ``mono``, ``ct``), the annotated
frames (``viewer/frame_drawer.py``, ``System._maybe_draw_frame``),
``viewer/export.render_png`` and ``tools/autotune.py`` against the JAX
package, on the CPU (the port with ``--device cpu``), at 160x120 and a
small settings file (3 levels, 300 features, a keyframe every 4 frames).

Every JAX run of the module but two uses one Config, written to one
directory whose files are moved after each run: the JAX package compiles
per Config, and a compile costs more than the run.  The settings turn
``viewer.save_frames`` on, and the drawing is replaced by a capture of its
arguments in both packages, so the apps' runs check the annotated frames
too.

Tolerances and why (the rules of ``tests/test_torch_system.py`` and
``tests/test_torch_groundtruth.py``):

- ``Matches.txt``: one row per frame in both, timestamps, tracking states,
  keyframe and template flags equal; match counts within 2 and inlier
  counts within 3 (after a template swap both packages re-create the map
  points from their own surface).
- The GT rows (``ErrorGTs0.txt``'s RMSE, ``ScaleVariation.txt``'s scale)
  within 3x the largest gap that a 1e-7 relative perturbation of the
  template after frame 0 opens in the JAX package's own rows, or 1e-3:
  the RMSE measures the SfT's structure, which moves within that
  sensitivity.  The probe runs the JAX System on the frames its app read.
- The annotated frames: the same files, images, keypoint arrays and
  matched flags equal; the projected template within 3x the probe's gap,
  or 1e-3 px (it moves with the pose and the template, which are as
  sensitive as the SfT solve).
- The autotuner's objective (mean RMSE in mm minus 10x the inlier
  fraction, plus 1000 per LOST frame) within 3x the probe's gap, or 1 (the
  1e-3 of the RMSE rule, in mm).
"""

import dataclasses
import os
import shutil

import cv2
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import defslam_tpu.cli as jcli
from defslam_tpu import native
from defslam_tpu.config import Config as JConfig
from defslam_tpu.io import datasets as jdatasets
from defslam_tpu.system import System as JaxSystem
from defslam_tpu.tools import autotune as jautotune
from defslam_tpu.viewer import frame_drawer as jdrawer
from defslam_tpu_torch import cli
from defslam_tpu_torch.config import Config, ParallelConfig, ViewerConfig
from defslam_tpu_torch.convert import config_from_dict
from defslam_tpu_torch.io import datasets
from defslam_tpu_torch.io.synthetic import make_sequence
from defslam_tpu_torch.system import System
from defslam_tpu_torch.tools import autotune, make_synth_dataset
from defslam_tpu_torch.viewer import export, frame_drawer

torch.set_num_threads(2)

N_FRAMES = 6
CAMERA = make_sequence(n_frames=1, height=120, width=160).camera
DRAW_FRAME = frame_drawer.draw_frame  # the real one, for one PNG


def _settings(outdir) -> str:
    """A nested-schema settings file both packages read."""
    c = CAMERA
    return (f"camera:\n  fx: {c.fx}\n  fy: {c.fy}\n  cx: {c.cx}\n  cy: {c.cy}\n"
            f"  width: {c.width}\n  height: {c.height}\n"
            "orb:\n  n_features: 300\n  n_levels: 3\n  max_keypoints: 384\n"
            "sft:\n  lm_iterations: 10\n"
            "tracking:\n  keyframe_period: 4\n"
            "capacity:\n  max_map_points: 512\n  max_keyframes: 8\n"
            "viewer:\n  save_frames: true\n"
            f"output_dir: {outdir}\nsave_results: true\n")


@pytest.fixture(scope="module")
def jax_yaml(tmp_path_factory):
    """The one settings file of the module's JAX runs (results in its
    ``out`` directory, moved by :func:`_jax_done`)."""
    root = tmp_path_factory.mktemp("jax_settings")
    path = root / "settings.yaml"
    path.write_text(_settings(root / "out"))
    return path


def _jax_done(jax_yaml, dest):
    """Move the files of the JAX run just made to ``dest``."""
    shutil.move(str(jax_yaml.parent / "out"), str(dest))


def _port_yaml(root) -> str:
    path = root / "port.yaml"
    path.write_text(_settings(root / "port"))
    return str(path)


def _capture(mp) -> dict:
    """Replace both packages' ``draw_frame`` by a capture of its arguments
    (the path relative to the run's output directory)."""
    calls = {"jax": [], "port": []}
    for name, module in (("jax", jdrawer), ("port", frame_drawer)):
        def draw(img, kp_xy, kp_valid, matched_kp, mesh_uv, mesh_edges, state, path, name=name):
            calls[name].append(dict(
                img=np.array(img), kp_xy=np.array(kp_xy), kp_valid=np.array(kp_valid),
                matched=np.array(matched_kp), mesh_uv=np.array(mesh_uv),
                edges=np.array(mesh_edges), state=state,
                path=os.path.join(*path.split(os.sep)[-2:])))

        mp.setattr(module, "draw_frame", draw)
    return calls


@pytest.fixture(autouse=True)
def draws(monkeypatch):
    return _capture(monkeypatch)


def _perturb(s):
    noise = np.random.default_rng(1).normal(0, 1e-7, (s.cfg.mesh.n_nodes, 3))
    s.template = s.template._replace(nodes=s.template.nodes * (1 + jnp.asarray(noise, jnp.float32)))


def _probe(jax_yaml, dest, frames, track):
    """The JAX System on the frames its app read, the template perturbed by
    N(0, 1e-7) relative after frame 0; its files moved to ``dest``."""
    s = JaxSystem(JConfig.from_yaml(str(jax_yaml)))
    for t, args in enumerate(frames):
        getattr(s, track)(*args)
        if t == 0:
            _perturb(s)
    s.write_metrics()
    _jax_done(jax_yaml, dest)


def _rows(path):
    return [r.split() for r in path.read_text().splitlines()]


def _matches_alike(root):
    port, ref = _rows(root / "port" / "Matches.txt"), _rows(root / "jax" / "Matches.txt")
    assert len(port) == len(ref) == N_FRAMES
    for p, j in zip(port, ref):
        assert p[0] == j[0] and p[3:] == j[3:], (p, j)  # timestamp, kf, template, state
        assert abs(int(p[1]) - int(j[1])) <= 2 and abs(int(p[2]) - int(j[2])) <= 3, (p, j)
    assert all(r[-1] == "OK" for r in port)
    return port


def _gt_alike(root):
    errs = {k: np.loadtxt(root / k / "ErrorGTs0.txt") for k in ("port", "jax", "probe")}
    scale = {k: np.loadtxt(root / k / "ScaleVariation.txt") for k in ("port", "jax", "probe")}
    assert errs["port"].shape == errs["jax"].shape == (N_FRAMES,)
    np.testing.assert_array_equal(scale["port"][:, 0], scale["jax"][:, 0])
    assert np.abs(scale["port"][:, 2] - scale["jax"][:, 2]).max() <= 3  # inlier counts
    for v in (errs, {k: s[:, 1] for k, s in scale.items()}):
        gap, probe = np.abs(v["port"] - v["jax"]).max(), np.abs(v["probe"] - v["jax"]).max()
        assert gap <= max(1e-3, 3 * probe), (gap, probe)


def _frames_alike(port, ref, probe):
    """Annotated frames alike: ``probe`` holds the JAX probe's frames, or
    None where the projected template is held to the 1e-3 px floor."""
    assert len(port) == len(ref) > 0
    for i, (p, j) in enumerate(zip(port, ref)):
        assert p["path"] == j["path"] and p["state"] == j["state"], (p["path"], j["path"])
        np.testing.assert_array_equal(p["img"], j["img"])
        for k in ("kp_xy", "kp_valid", "matched", "edges"):
            np.testing.assert_array_equal(p[k], j[k], err_msg=k)
        gap = np.abs(p["mesh_uv"] - j["mesh_uv"]).max()
        bound = 1e-3 if probe is None else max(
            1e-3, 3 * np.abs(probe[i]["mesh_uv"] - j["mesh_uv"]).max())
        assert gap <= bound, (i, gap, bound)


# ------------------------------------------------------------------ stereo


@pytest.fixture(scope="module")
def stereo_runs(tmp_path_factory, jax_yaml):
    """tests/test_aux.py:158-187 in both packages: a reference-layout
    dataset, the stereo app on it, and the JAX package's probe."""
    root = tmp_path_factory.mktemp("stereo")
    data = root / "seq"
    make_synth_dataset.main([str(data), "--frames", str(N_FRAMES), "--width", "160",
                             "--height", "120"])
    assert native.available()  # the JAX app's native reader
    with pytest.MonkeyPatch.context() as mp:
        drawn = _capture(mp)
        assert cli.main(["stereo", _port_yaml(root), str(data), "--start", "0",
                         "--device", "cpu"]) == 0
        assert jcli.main(["stereo", str(jax_yaml), str(data), "--start", "0"]) == 0
        _jax_done(jax_yaml, root / "jax")
        lp, rp, ts = jdatasets.stereo_pair_paths(str(data))
        frames = [(cv2.imread(a, 0).astype(np.float32), cv2.imread(b, 0).astype(np.float32), t)
                  for a, b, t in zip(lp, rp, ts)]
        _probe(jax_yaml, root / "probe", frames, "track_monocular_gt")
    return root, drawn


def test_stereo_app_matches_reference(stereo_runs):
    root, drawn = stereo_runs
    rows = _matches_alike(root)
    assert [r[3] for r in rows] == ["1", "0", "0", "0", "1", "0"]
    _gt_alike(root)
    n = N_FRAMES - 1  # every tracked frame after the initialization is drawn
    _frames_alike(drawn["port"], drawn["jax"][:n], drawn["jax"][n:])


def test_stereo_app_writes_the_reference_files(stereo_runs):
    root, _ = stereo_runs
    names = {n for n in os.listdir(root / "jax") if n.endswith((".txt", ".obj"))}
    assert {"Matches.txt", "ErrorGTs0.txt", "ScaleVariation.txt", "StatusTracking.txt",
            "MapPointUsage.txt", "Trajectory.txt", "template.obj", "trajectory.txt"} <= names
    assert {n for n in os.listdir(root / "port") if n.endswith((".txt", ".obj"))} == names


# -------------------------------------------------------------------- mono


def test_mono_app_matches_reference(tmp_path, monkeypatch, jax_yaml, draws):
    """The mono app on the same frames through a patched ``load_video`` in
    each package (tests/test_rigid_system.py:264-271)."""
    seq = make_sequence(n_frames=N_FRAMES, height=120, width=160, max_amp=0.05)

    def video(_src):
        for t in range(N_FRAMES):
            yield np.asarray(seq.frames[t]), t / 7.0

    monkeypatch.setattr(datasets, "load_video", video)
    monkeypatch.setattr(jdatasets, "load_video", video)
    assert cli.main(["mono", _port_yaml(tmp_path), "0", "--device", "cpu"]) == 0
    assert jcli.main(["mono", str(jax_yaml), "0"]) == 0
    _jax_done(jax_yaml, tmp_path / "jax")
    rows = _matches_alike(tmp_path)
    assert sum(r[4] == "1" for r in rows) >= 1  # a template swap at the keyframe of frame 4
    assert not (tmp_path / "port" / "ErrorGTs0.txt").exists()
    assert [c["path"] for c in draws["port"]] == [c["path"] for c in draws["jax"]]


def test_mono_orbslam_and_parallel_raise(tmp_path, monkeypatch):
    """``mono --orbslam`` raised until the rigid mode was ported; it now
    runs the port's RigidSystem and writes ``Trajectory.txt`` (held to the
    JAX package in tests/test_torch_rigid_system.py).  ``parallel.enabled``
    raised until the multi-device path was ported; it now brings up a
    world of 1 (held to the JAX package in tests/test_torch_parallel.py),
    and ``shutdown`` takes it down."""
    seq = make_sequence(n_frames=3, height=120, width=160, max_amp=0.0)
    monkeypatch.setattr(datasets, "load_video",
                        lambda _src: ((np.asarray(f), t / 7.0) for t, f in enumerate(seq.frames)))
    assert cli.main(["mono", _port_yaml(tmp_path), "0", "--orbslam", "--device", "cpu"]) == 0
    assert (tmp_path / "port" / "Trajectory.txt").exists()
    s = System(Config(parallel=ParallelConfig(enabled=True)), device="cpu")
    try:
        assert s.group is not None and s.group.size == 1
    finally:
        s.shutdown()
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------- ct


def test_ct_app_matches_reference(tmp_path, jax_yaml):
    """The ct app on a real MJPG video that OpenCV writes here, read by
    both packages' ``load_video``, and depth text files."""
    seq = make_sequence(n_frames=N_FRAMES, height=120, width=160, max_amp=0.05)
    video = str(tmp_path / "seq.avi")
    vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 7.0, (160, 120), isColor=False)
    for f in seq.frames:
        vw.write(np.clip(f, 0, 255).astype(np.uint8))
    vw.release()
    depth_dir = tmp_path / "depth"
    depth_dir.mkdir()
    for t in range(N_FRAMES):
        np.savetxt(depth_dir / f"heartDepthMap_{t}.txt", seq.depths[t], fmt="%.6f")
    assert cli.main(["ct", _port_yaml(tmp_path), video, str(depth_dir), "--device", "cpu"]) == 0
    assert jcli.main(["ct", str(jax_yaml), video, str(depth_dir)]) == 0
    _jax_done(jax_yaml, tmp_path / "jax")
    frames = list(jdatasets.load_ct_sequence(video, str(depth_dir)))
    got = list(datasets.load_ct_sequence(video, str(depth_dir)))
    assert len(frames) == len(got) == N_FRAMES
    for (a, da, ta), (b, db, tb) in zip(frames, got):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(da, db)
        assert ta == tb
    _probe(jax_yaml, tmp_path / "probe", frames, "track_monocular_ct")
    _matches_alike(tmp_path)
    _gt_alike(tmp_path)


# ----------------------------------------------------------- annotated frames


@pytest.mark.parametrize("pipelined", [True, False])
def test_saved_frames_match_reference(tmp_path, jax_yaml, draws, pipelined):
    """The annotated frames of a tracking run in both packages and in the
    JAX package's probe, pipelined and synchronous; one drawn for real."""
    seq = make_sequence(n_frames=N_FRAMES, height=120, width=160, max_amp=0.05)
    jcfg = JConfig.from_yaml(str(jax_yaml))
    if not pipelined:
        jcfg = dataclasses.replace(jcfg, tracking=dataclasses.replace(jcfg.tracking,
                                                                       pipelined=False))
    n0 = {}
    for name in ("jax", "probe", "port"):
        s = (System(config_from_dict(dataclasses.asdict(jcfg)), device="cpu") if name == "port"
             else JaxSystem(jcfg))
        n0[name] = len(draws["jax"])
        for t in range(N_FRAMES):
            s.track_monocular(seq.frames[t], float(t))
            if t == 0 and name == "probe":
                _perturb(s)
        s.flush()
    ref, probe = draws["jax"][:n0["probe"]], draws["jax"][n0["probe"]:]
    assert len(draws["port"]) == N_FRAMES - 1  # every tracked frame after the initialization
    _frames_alike(draws["port"], ref, probe)
    assert os.path.dirname(draws["port"][0]["path"]) == "frames"
    c = draws["port"][-1]
    path = str(tmp_path / "frame.png")
    DRAW_FRAME(c["img"], c["kp_xy"], c["kp_valid"], c["matched"], c["mesh_uv"], c["edges"],
               c["state"], path)
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    assert img is not None and img.shape == (120, 160) and img.std() > 0


def test_render_png_writes_a_file(tmp_path):
    seq = make_sequence(n_frames=3, height=120, width=160, max_amp=0.05)
    s = System(Config.from_yaml(_port_yaml(tmp_path)), device="cpu")
    for t in range(3):
        s.track_monocular(seq.frames[t], float(t))
    s.flush()
    path = str(tmp_path / "map.png")
    export.render_png(s, path)
    assert cv2.imread(path) is not None


def test_save_frames_needs_matplotlib(monkeypatch):
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else real(name, *a))
    with pytest.raises(ImportError, match="matplotlib"):
        System(Config(viewer=ViewerConfig(save_frames=True)), device="cpu")


# --------------------------------------------------------------- autotune


def test_autotune_matches_reference(jax_yaml):
    """tests/test_aux.py:189-206: the objective on the same frames, in both
    packages and the JAX package's probe; then one twiddle iteration."""
    seq = make_sequence(n_frames=4, height=120, width=160, max_amp=0.04)
    jcfg = JConfig.from_yaml(str(jax_yaml))
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    got = autotune.evaluate(tcfg, seq.frames, seq.depths, device="cpu")
    want = jautotune.evaluate(jcfg, seq.frames, seq.depths)

    # the probe: jautotune.evaluate's loop with the template perturbed
    s = JaxSystem(dataclasses.replace(jcfg, save_results=True))
    for t in range(4):
        s.track_monocular_ct(seq.frames[t], seq.depths[t], float(t))
        if t == 0:
            _perturb(s)
    ok = [m for m in s._metrics if m["state"] == "OK"]
    probe = (1000.0 * float(np.mean([r[1] for r in s._gt_eval.rows]))
             - 10.0 * float(np.mean([m["inliers"] / max(m["matches"], 1) for m in ok[1:]]))
             + 1e3 * sum(m["state"] == "LOST" for m in s._metrics))
    assert np.isfinite(got) and got < 1e3
    assert abs(got - want) <= max(1.0, 3 * abs(probe - want)), (got, want, probe)

    shutil.rmtree(jax_yaml.parent / "out", ignore_errors=True)  # the runs' angle files
    params, best, history = autotune.twiddle(tcfg, seq.frames[:2], seq.depths[:2], n_iter=1,
                                             verbose=False, device="cpu")
    assert np.isfinite(best) and len(history) == 4
    assert set(params) == {"schwarp_regularizer", "bending", "chi_limit"}
