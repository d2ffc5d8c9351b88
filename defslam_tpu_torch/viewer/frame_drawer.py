"""Annotated frame export: the offline counterpart of the reference's
``DefFrameDrawer`` (``Modules/Viewer/DefFrameDrawer.{h,cc}``: keypoint and
match overlays on the current frame) and of the mesh projection the
Pangolin viewer draws (``DefMapDrawer``).

Port of ``defslam_tpu/viewer/frame_drawer.py``.  A headless host has no
display, so the annotated view is written as one PNG per tracked frame with
matplotlib (Agg), imported only when a frame is drawn.  Colours follow the
reference: tracked map points green, unmatched keypoints blue; the
template mesh is projected with the current pose and drawn as a wireframe.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def draw_frame(img: np.ndarray, kp_xy: np.ndarray, kp_valid: np.ndarray,
               matched_kp: np.ndarray, mesh_uv: np.ndarray | None,
               mesh_edges: np.ndarray | None, state: str, path: str) -> None:
    """Render one annotated frame to ``path`` (PNG): the (H, W) grey image,
    the (K, 2) keypoints (``kp_valid`` ones; ``matched_kp`` green), the
    (M, 2) projected template nodes joined by the (E, 2) ``mesh_edges``,
    and the tracking ``state``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    h, w = img.shape[:2]
    fig, ax = plt.subplots(figsize=(w / 80, h / 80), dpi=80)
    ax.imshow(img, cmap="gray", vmin=0, vmax=255)
    v = np.asarray(kp_valid, bool)
    m = np.asarray(matched_kp, bool) & v
    u = v & ~m
    xy = np.asarray(kp_xy)
    ax.scatter(xy[u, 0], xy[u, 1], s=6, c="#3b6fd4", marker="o",
               linewidths=0, label=f"keypoints ({int(u.sum())})")
    ax.scatter(xy[m, 0], xy[m, 1], s=8, c="#27a327", marker="o",
               linewidths=0, label=f"tracked ({int(m.sum())})")
    if mesh_uv is not None and mesh_edges is not None:
        uv = np.asarray(mesh_uv)
        for a, b in np.asarray(mesh_edges):
            ax.plot([uv[a, 0], uv[b, 0]], [uv[a, 1], uv[b, 1]], c="#d43b3b", lw=0.5, alpha=0.6)
    ax.text(6, 14, state, color="yellow", fontsize=10, weight="bold")
    ax.set_xlim(0, w)
    ax.set_ylim(h, 0)
    ax.axis("off")
    ax.legend(loc="lower right", fontsize=7, framealpha=0.6)
    fig.tight_layout(pad=0)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path)
    plt.close(fig)


def save_annotated(system, img, feats, matches, frame_id: int, outdir: str | None = None) -> None:
    """Export a tracked frame like DefFrameDrawer::Update, into
    ``<output_dir>/frames/frame_<frame_id>.png``: its keypoints, which of
    them matched a map point, and the template projected with the system's
    current pose.  Reads the device once (used only with
    ``viewer.save_frames``, a debugging mode)."""
    from defslam_tpu_torch.geometry import camera as cam
    from defslam_tpu_torch.geometry import se3

    outdir = outdir or os.path.join(system.cfg.output_dir, "frames")
    k_cap = feats.capacity
    kp_of_point = _numpy(matches.kp_of_point)
    matched_kp = np.zeros(k_cap, bool)
    ok = kp_of_point >= 0
    matched_kp[np.clip(kp_of_point[ok], 0, k_cap - 1)] = True
    mesh_uv = mesh_edges = None
    if system.template is not None:
        pc = se3.transform(system.pose, system.template.nodes)
        mesh_uv = _numpy(cam.project(system.K, pc))
        mesh_edges = np.asarray(system.topo.edges)
    draw_frame(_numpy(img), _numpy(feats.xy), _numpy(feats.valid), matched_kp, mesh_uv,
               mesh_edges, system.state.name, os.path.join(outdir, f"frame_{frame_id:06d}.png"))
