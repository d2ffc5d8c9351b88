"""Write a DefSLAMGT-layout synthetic stereo dataset to disk.

Port of ``defslam_tpu/tools/make_synth_dataset.py``, with the same
arguments and files.  The reference's GT app reads directories of
rectified stereo pairs named ``stereo_im_l_<t_usec>.png`` /
``stereo_im_r_<t_usec>.png`` with microsecond timestamps, starting at frame
200 (``Apps/stereo_groundtruth.cc:113, 156-188``), configured by a flat
``Camera.*``-key YAML (``scripts/stereo0_template.yaml``).  The Mandala
recordings are not redistributable; this tool renders the synthetic
deforming surface (``io.synthetic``) in that layout, so that ``python -m
defslam_tpu_torch.cli stereo`` runs the whole path: file reading, tracking,
stereo-NCC ground truth and the result files.  It writes the PNGs with the
port's own codec (``io.png``), so it needs no OpenCV.

    python -m defslam_tpu_torch.tools.make_synth_dataset <out_dir> \\
        [--frames 216] [--width 320] [--height 240] [--baseline 0.05]
"""

from __future__ import annotations

import argparse
import os


def write_dataset(out_dir: str, seq, baseline: float, fps: float = 7.0) -> str:
    """Write a rendered stereo sequence (``io.synthetic.make_sequence`` with
    ``baseline > 0``) in the DefSLAMGT layout: the PNG pairs, a
    ``settings.yaml`` of the reference's flat keys (results under
    ``<out_dir>/out``) and ``baseline.txt``.  Returns the yaml's path."""
    import numpy as np

    from defslam_tpu_torch.io import png

    os.makedirs(out_dir, exist_ok=True)
    for t in range(len(seq.frames)):
        usec = int(round(t / fps * 1e6))
        for side, img in (("l", seq.frames[t]), ("r", seq.frames_right[t])):
            png.write_png(os.path.join(out_dir, f"stereo_im_{side}_{usec}.png"),
                          np.clip(img, 0, 255).astype(np.uint8))
    cam = seq.camera
    yaml_path = os.path.join(out_dir, "settings.yaml")
    with open(yaml_path, "w") as f:
        f.write("\n".join([
            "# reference-style flat keys",
            f"Camera.fx: {cam.fx}",
            f"Camera.fy: {cam.fy}",
            f"Camera.cx: {cam.cx}",
            f"Camera.cy: {cam.cy}",
            f"Camera.width: {cam.width}",
            f"Camera.height: {cam.height}",
            f"Camera.fps: {fps}",
            "ORBextractor.nFeatures: 600",
            "ORBextractor.scaleFactor: 1.2",
            "ORBextractor.nLevels: 4",
            "ORBextractor.minThFAST: 7",
            "Regularizer.laplacian: 700.0",
            "Regularizer.Inextensibility: 12000.0",
            "Regularizer.temporal: 0.05",
            "Regularizer.LocalZone: 2",
            "LocalMapping.pointsToTemplate: 70",
            "LocalMapping.chiLimit: 0.07",
            "Viewer.SaveResults: 1",
            f"File.outputdir: {os.path.join(out_dir, 'out')}",
            "",
        ]))
    # the baseline, for the GT runner (the reference bakes it into the
    # rectified projection matrices)
    with open(os.path.join(out_dir, "baseline.txt"), "w") as f:
        f.write(f"{baseline}\n")
    return yaml_path


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("out_dir")
    p.add_argument("--frames", type=int, default=216)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--baseline", type=float, default=0.05)
    p.add_argument("--max-amp", type=float, default=0.06)
    p.add_argument("--fps", type=float, default=7.0)  # Camera.fps of Mandala
    args = p.parse_args(argv)

    from defslam_tpu_torch.io.synthetic import make_sequence

    seq = make_sequence(n_frames=args.frames, height=args.height, width=args.width,
                        max_amp=args.max_amp, baseline=args.baseline)
    yaml_path = write_dataset(args.out_dir, seq, args.baseline, args.fps)
    print(f"wrote {args.frames} stereo pairs + {yaml_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
