"""Command-line apps of the port: the reference's executables
(``CMakeLists.txt:103-113``: DefSLAM, DefSLAMGT, DefSLAMGTCT) and a demo.

    python -m defslam_tpu_torch.cli mono   <yaml> <video|camera-index>
    python -m defslam_tpu_torch.cli stereo <yaml> <sequence-dir> [--start 200] [--baseline 0.1]
    python -m defslam_tpu_torch.cli ct     <yaml> <video> <depth-dir>
    python -m defslam_tpu_torch.cli synth  [--frames N] [--gt] [--out DIR] [--config FILE]

Every mode takes ``--device cuda|cpu`` (default ``cuda``), ``--tune FILE``
and ``--step``.  Port of ``defslam_tpu/cli.py``:

- ``mono``: a video file or camera through ``io.datasets.load_video``
  (OpenCV's ``VideoCapture``) into ``System.track_monocular``.
  ``--orbslam``: the rigid ORB-SLAM2 comparison mode (the reference's
  ``#define ORBSLAM`` build) on the same input, through
  ``rigid.system.RigidSystem``; it writes ``Trajectory.txt`` only.
- ``stereo``: a DefSLAMGT-layout directory of ``stereo_im_{l,r}_<usec>.png``
  pairs, decoded (``io.png``, no OpenCV), rectified when the YAML carries a
  ``LEFT.``/``RIGHT.`` calibration, on the threads of two
  ``io.prefetch.FramePipeline`` readers, into
  ``System.track_monocular_gt`` (stereo-NCC ground truth).
- ``ct``: a video and per-frame depth text files
  (``io.datasets.load_ct_sequence``) into ``System.track_monocular_ct``.
- ``synth``: the synthetic deforming sequence (``io.synthetic``, 320x240);
  ``--gt`` evaluates each frame against its depth map, ``--config`` reads
  settings (the camera comes from the render).

The yaml is a settings file of the reference's flat keys or of the nested
schema (``Config.from_yaml``); its ``File.outputdir`` (``output_dir``) is
where the results go.  No vocabulary file: relocalization matches against
the stored keyframes' descriptors directly.

Every mode ends alike: the metrics files (``Matches.txt``,
``StatusTracking.txt``, ``MapPointUsage.txt``, ``Trajectory.txt``; with
ground truth also ``ErrorGTs0.txt``, ``ScaleVariation.txt`` and the
keyframes' ``ErrorAngIso*`` / ``ErrorAngSfN*``), the stage-time report
(with ``DEFSLAM_PROFILE=1``) and a snapshot (``template.obj``,
``template_rest.obj``, ``trajectory.txt`` in TUM format, the keyframe-time
templates).  ``--tune`` and ``--step`` are the reference viewer's live
regularizer sliders and its step-"Next" gating (DefViewer.cc:53-120,
System.cc:328-333).

The System runs its default pipelined protocol: the progress line shows
``?`` for counts not yet validated, and the pipeline is drained every 30
frames, every frame under ``--step`` / ``--tune`` (which want the
validated state), and before the metrics files are written.

With ``parallel.enabled`` the app's System spans the devices
``parallel.n_devices`` asks for (0: every visible card, ``parallel.driver``):
this process is rank 0, and it alone reads the input (a camera too), polls
``--tune``, waits at ``--step``, prints and writes; the other ranks get
each frame and each tuning from it.  Run as one rank of a world started by
hand (``parallel.launch``, a ``coordinator``), every rank reads the input
and rank 0 alone writes.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="defslam_tpu_torch")
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    common.add_argument("--step", action="store_true",
                        help="single-step mode: wait for Enter after every frame")
    common.add_argument("--tune", metavar="FILE", default=None,
                        help="poll FILE (YAML: reference keys like Regularizer.laplacian or "
                             "dotted config paths) every frame and apply changed parameters")
    sub = p.add_subparsers(dest="mode", required=True)

    mono = sub.add_parser("mono", parents=[common], help="monocular video/camera (DefSLAM app)")
    mono.add_argument("yaml")
    mono.add_argument("source")
    mono.add_argument("--orbslam", action="store_true",
                      help="rigid ORB-SLAM2 comparison mode (writes Trajectory.txt)")

    st = sub.add_parser("stereo", parents=[common], help="stereo GT sequence (DefSLAMGT app)")
    st.add_argument("yaml")
    st.add_argument("directory")
    st.add_argument("--start", type=int, default=200)
    st.add_argument("--baseline", type=float, default=0.1)

    ct = sub.add_parser("ct", parents=[common], help="video + depth-map GT (DefSLAMGTCT app)")
    ct.add_argument("yaml")
    ct.add_argument("video")
    ct.add_argument("depth_dir")

    sy = sub.add_parser("synth", parents=[common], help="synthetic demo sequence")
    sy.add_argument("--frames", type=int, default=30)
    sy.add_argument("--out", default="./out")
    sy.add_argument("--gt", action="store_true",
                    help="per-frame depth-map GT evaluation (writes ErrorGTs0.txt, "
                         "ScaleVariation.txt and the keyframes' angle files)")
    sy.add_argument("--config", metavar="FILE", default=None,
                    help="YAML settings (nested schema or the reference's flat keys); "
                         "the camera comes from the render")
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)

    from defslam_tpu_torch import parallel, profiling
    from defslam_tpu_torch.config import Config
    from defslam_tpu_torch.io import datasets
    from defslam_tpu_torch.parallel import driver
    from defslam_tpu_torch.system import System
    from defslam_tpu_torch.viewer import export

    t_start = time.perf_counter()
    if args.mode == "mono" and args.orbslam:
        return _orbslam(args, t_start)
    if args.mode == "synth":
        cfg = Config.from_yaml(args.config) if args.config else Config()
    else:
        cfg = Config.from_yaml(args.yaml)
    try:
        driver.spans(cfg, args.device)  # refuses a card index for a world of several ranks
    except ValueError as e:
        raise SystemExit(f"--device: {e}") from None
    here = parallel.place(cfg)
    # the one process that reads the input, writes and prints: this one,
    # which is rank 0 of the world its System makes, unless it is another
    # rank of a world started by hand (parallel.launch, a coordinator)
    lead = not cfg.parallel.enabled or here.rank == 0
    if not lead:
        cfg = driver.worker_config(cfg)
    if args.mode == "synth":
        from defslam_tpu_torch.io.synthetic import make_sequence

        seq = make_sequence(n_frames=args.frames, height=240, width=320)
        cfg = dataclasses.replace(cfg, camera=seq.camera, output_dir=args.out if lead else "",
                                  save_results=True)
    sys_ = System(cfg, device=args.device)
    loop = _Loop(sys_, args, lead)

    if args.mode == "synth":
        for t in range(args.frames):
            if args.gt:
                sys_.track_monocular_ct(seq.frames[t], seq.depths[t], float(t))
            else:
                sys_.track_monocular(seq.frames[t], float(t))
            loop.after_frame()
    elif args.mode == "mono":
        src = int(args.source) if args.source.isdigit() else args.source
        for img, ts in datasets.load_video(src):
            sys_.track_monocular(img, ts)
            loop.after_frame()
    elif args.mode == "stereo":
        _stereo(sys_, args, loop)
    else:  # ct
        for img, depth, ts in datasets.load_ct_sequence(args.video, args.depth_dir):
            sys_.track_monocular_ct(img, depth, ts)
            loop.after_frame()

    if lead:
        sys_.write_metrics()  # drains the pipeline first
        profiling.print_report()  # nothing unless DEFSLAM_PROFILE=1
        export.snapshot(sys_, sys_.cfg.output_dir)
        n = len(sys_._metrics)
        dt = time.perf_counter() - t_start
        print(f"\nprocessed {n} frames in {dt:.1f}s ({n / dt:.2f} fps); "
              f"results in {os.path.abspath(sys_.cfg.output_dir)}")
    sys_.shutdown()  # drains the pipeline; destroys the process group in parallel mode
    return 0


def _orbslam(args, t_start: float) -> int:
    """The A/B baseline: the rigid ORB-SLAM2 pipeline (tracking,
    triangulation, local BA, culling, loop closing) on the mono input."""
    from defslam_tpu_torch.config import Config
    from defslam_tpu_torch.io import datasets
    from defslam_tpu_torch.rigid.system import RigidSystem

    cfg = Config.from_yaml(args.yaml)
    rsys = RigidSystem(cfg, device=args.device)
    src = int(args.source) if args.source.isdigit() else args.source
    n = 0
    for img, ts in datasets.load_video(src):
        rsys.track_monocular(img, ts)
        n += 1
        print(f"\rframe {n - 1:5d} [{rsys.state.name:>15s}]", end="", flush=True)
    os.makedirs(cfg.output_dir, exist_ok=True)
    rsys.write_trajectory(os.path.join(cfg.output_dir, "Trajectory.txt"))
    dt = time.perf_counter() - t_start
    print(f"\nprocessed {n} frames in {dt:.1f}s ({n / max(dt, 1e-9):.2f} fps); "
          f"results in {cfg.output_dir}")
    return 0


def _stereo(sys_, args, loop: "_Loop") -> None:
    """The DefSLAMGT loop: raw pairs are rectified when the YAML carries a
    LEFT./RIGHT. stereo calibration (stereo_groundtruth.cc:56-94), else
    the sequence is taken as rectified.  Decoding and rectification run on
    the readers' threads, ahead of the tracking loop."""
    from defslam_tpu_torch.config import load_raw_yaml
    from defslam_tpu_torch.io import datasets, prefetch

    w, h = sys_.cfg.camera.width, sys_.cfg.camera.height
    maps = datasets.rectify_maps(load_raw_yaml(args.yaml), (w, h))
    lp, rp, ts = datasets.stereo_pair_paths(args.directory, start=args.start)
    pipe_l = prefetch.FramePipeline(lp, w, h, rectify_maps=maps["l"] if maps else None)
    pipe_r = prefetch.FramePipeline(rp, w, h, rectify_maps=maps["r"] if maps else None)
    try:
        for (i, left), (_, right) in zip(pipe_l, pipe_r):
            sys_.track_monocular_gt(left, right, ts[i], baseline=args.baseline)
            loop.after_frame()
    finally:
        pipe_l.close()
        pipe_r.close()


class _Loop:
    """What every app does after a frame: the progress line, the live
    tuning file (``--tune``) and the step gate (``--step``)."""

    def __init__(self, sys_, args, lead: bool = True):
        self.sys_ = sys_
        self.step = args.step
        self.tuner = _TuneWatcher(args.tune) if args.tune else None
        self.lead = lead

    def after_frame(self) -> None:
        _progress(self.sys_, interactive=self.step or self.tuner is not None, show=self.lead)
        if self.tuner is not None:
            self.tuner.poll(self.sys_)
        if self.step:
            input("\n[step] Enter for next frame... ")


def _progress(sys_, interactive: bool = False, every: int = 30, show: bool = True) -> None:
    """One progress line per frame, rewritten in place (printed where
    ``show``; every rank of a parallel run flushes at the same frames).
    The pipeline is not drained every frame (that would serialize the run
    at its keyframes): counts not yet validated print as ``?``, and it is
    flushed every ``every`` frames, or every frame when ``interactive``."""
    m = sys_._metrics[-1]
    if interactive or m["frame"] % every == 0:
        sys_.flush()
        m = sys_._metrics[-1]
    if not show:
        return
    matches = f"{m['matches']:4d}" if m["matches"] >= 0 else "   ?"
    inliers = f"{m['inliers']:4d}" if m["inliers"] >= 0 else "   ?"
    print(f"\rframe {m['frame']:5d} [{m['state']:>15s}] "
          f"matches {matches} inliers {inliers}"
          + (" KF" if m["keyframe"] else "   ")
          + (" TEMPLATE" if m["template"] else ""),
          end="", flush=True)


class _TuneWatcher:
    """Polls a parameter file and applies the values that changed to the
    running System (the DefViewer slider workflow)."""

    def __init__(self, path: str):
        self.path = path
        self.mtime = 0.0
        self.last: dict = {}

    def poll(self, sys_) -> None:
        import numpy as np

        from defslam_tpu_torch.config import load_raw_yaml

        try:
            m = os.stat(self.path).st_mtime
        except OSError:
            return
        if m == self.mtime:
            return
        self.mtime = m
        try:
            raw = load_raw_yaml(self.path)
        except Exception as e:  # keep tracking; report the bad file
            print(f"\n[tune] parse error in {self.path}: {e}")
            return

        def differs(a, b):
            # !!opencv-matrix nodes load as arrays, whose != is elementwise
            if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
                return not np.array_equal(a, b)
            return a != b

        changed = {k: v for k, v in raw.items() if differs(self.last.get(k), v)}
        self.last = raw
        if not changed:
            return
        try:
            sys_.apply_tuning(changed)
            print(f"\n[tune] applied {changed}")
        except KeyError as e:
            print(f"\n[tune] {e}")


if __name__ == "__main__":
    sys.exit(main())
