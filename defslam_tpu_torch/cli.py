"""Command-line entry point of the port: the ``synth`` demo app.

    python -m defslam_tpu_torch.cli synth [--frames N] [--gt] [--out DIR]
                                          [--config FILE] [--device cuda|cpu]
                                          [--tune FILE] [--step]

Port of the ``synth`` mode of ``defslam_tpu/cli.py``: a synthetic deforming
sequence (``io.synthetic.make_sequence``, 320x240) through the System, a
progress line per frame, then the metrics files (``Matches.txt``,
``StatusTracking.txt``, ``MapPointUsage.txt``, ``Trajectory.txt``; with
``--gt`` also ``ErrorGTs0.txt``, ``ScaleVariation.txt`` and the keyframes'
``ErrorAngIso*`` / ``ErrorAngSfN*``) and a snapshot (``template.obj``,
``template_rest.obj``, ``trajectory.txt`` in TUM format, the keyframe-time
templates).  ``--config`` reads a YAML of settings (the camera comes from
the render); ``--tune`` and ``--step`` are the reference viewer's live
regularizer sliders and its step-"Next" gating (DefViewer.cc:53-120,
System.cc:328-333).  Runs on the CUDA card unless ``--device cpu``.

The System runs its default pipelined protocol: the progress line shows
``?`` for counts not yet validated, and the pipeline is drained every 30
frames, every frame under ``--step`` / ``--tune`` (which want the
validated state), and before the metrics files are written.  With
``DEFSLAM_PROFILE=1`` a table of stage times ends the run.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="defslam_tpu_torch")
    sub = p.add_subparsers(dest="mode", required=True)
    sy = sub.add_parser("synth", help="synthetic demo sequence")
    sy.add_argument("--frames", type=int, default=30)
    sy.add_argument("--out", default="./out")
    sy.add_argument("--gt", action="store_true",
                    help="per-frame depth-map GT evaluation (writes ErrorGTs0.txt, "
                         "ScaleVariation.txt and the keyframes' angle files)")
    sy.add_argument("--config", metavar="FILE", default=None,
                    help="YAML settings (nested schema or the reference's flat keys); "
                         "the camera comes from the render")
    sy.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    sy.add_argument("--step", action="store_true",
                    help="single-step mode: wait for Enter after every frame")
    sy.add_argument("--tune", metavar="FILE", default=None,
                    help="poll FILE (YAML: reference keys like Regularizer.laplacian or "
                         "dotted config paths) every frame and apply changed parameters")
    args = p.parse_args(argv)

    from defslam_tpu_torch import profiling
    from defslam_tpu_torch.config import Config
    from defslam_tpu_torch.io.synthetic import make_sequence
    from defslam_tpu_torch.system import System
    from defslam_tpu_torch.viewer import export

    t_start = time.perf_counter()
    seq = make_sequence(n_frames=args.frames, height=240, width=320)
    base = Config.from_yaml(args.config) if args.config else Config()
    cfg = dataclasses.replace(base, camera=seq.camera, output_dir=args.out, save_results=True)
    sys_ = System(cfg, device=args.device)
    tuner = _TuneWatcher(args.tune) if args.tune else None
    for t in range(args.frames):
        if args.gt:
            sys_.track_monocular_ct(seq.frames[t], seq.depths[t], float(t))
        else:
            sys_.track_monocular(seq.frames[t], float(t))
        _progress(sys_, interactive=args.step or tuner is not None)
        if tuner is not None:
            tuner.poll(sys_)
        if args.step:
            input("\n[step] Enter for next frame... ")

    sys_.write_metrics()  # drains the pipeline first
    profiling.print_report()  # nothing unless DEFSLAM_PROFILE=1
    export.snapshot(sys_, sys_.cfg.output_dir)
    n = len(sys_._metrics)
    dt = time.perf_counter() - t_start
    print(f"\nprocessed {n} frames in {dt:.1f}s ({n / dt:.2f} fps); "
          f"results in {os.path.abspath(sys_.cfg.output_dir)}")
    return 0


def _progress(sys_, interactive: bool = False, every: int = 30) -> None:
    """One progress line per frame, rewritten in place.  The pipeline is
    not drained every frame (that would serialize the run at its
    keyframes): counts not yet validated print as ``?``, and it is flushed
    every ``every`` frames, or every frame when ``interactive``."""
    m = sys_._metrics[-1]
    if interactive or m["frame"] % every == 0:
        sys_.flush()
        m = sys_._metrics[-1]
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
