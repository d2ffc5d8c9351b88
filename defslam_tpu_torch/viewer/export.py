"""Offline visualization exports.

Port of ``defslam_tpu/viewer/export.py`` (the mesh and trajectory exports;
the matplotlib render and the annotated frames are not ported yet).  The
reference's Pangolin viewer (``Modules/Viewer/``) is an interactive debug
tool; a headless host gets files instead: the template now and at rest as
Wavefront OBJ, the trajectory in TUM format, and one OBJ per keyframe-time
template (DefMapDrawer's history view).
"""

from __future__ import annotations

import os

import numpy as np

from defslam_tpu_torch.template import mesh as meshmod


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def export_mesh_obj(path: str, nodes, topo: meshmod.MeshTopology):
    """Write a template as a Wavefront OBJ (MeshDrawer)."""
    with open(path, "w") as f:
        for x, y, z in _numpy(nodes):
            f.write(f"v {x:.6f} {y:.6f} {z:.6f}\n")
        for a, b, c in np.asarray(topo.faces):
            f.write(f"f {a + 1} {b + 1} {c + 1}\n")


def export_trajectory_tum(path: str, trajectory, timestamps=None):
    """World->camera 4x4 poses -> TUM 'timestamp tx ty tz qx qy qz qw' (the
    camera centre and the camera-to-world rotation).  ``trajectory`` is a
    ``System.trajectory`` list of (timestamp, pose) or a list of poses."""
    from scipy.spatial.transform import Rotation

    with open(path, "w") as f:
        for i, item in enumerate(trajectory):
            if isinstance(item, tuple):
                ts, T = item
            else:
                ts = timestamps[i] if timestamps is not None else float(i)
                T = item
            T = _numpy(T)
            R, t = T[:3, :3], T[:3, 3]
            c = -R.T @ t
            q = Rotation.from_matrix(R.T).as_quat()  # (x, y, z, w)
            f.write(f"{ts:.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} "
                    f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")


def snapshot(system, outdir: str, tag: str = ""):
    """The current template (deformed and at rest), the trajectory and the
    keyframe-time template history (DefMapDrawer's 'template now / at rest /
    history' views)."""
    os.makedirs(outdir, exist_ok=True)
    if system.template is not None:
        export_mesh_obj(os.path.join(outdir, f"template{tag}.obj"),
                        system.template.nodes, system.topo)
        export_mesh_obj(os.path.join(outdir, f"template_rest{tag}.obj"),
                        system.template.nodes_rest, system.topo)
    export_trajectory_tum(os.path.join(outdir, f"trajectory{tag}.txt"), system.trajectory)
    export_template_history(system, outdir)


def export_template_history(system, outdir: str):
    """One OBJ per recorded keyframe-time template
    (``DefMapDrawer::MeshDrawershist``)."""
    for frame_id, nodes in system.template_history:
        export_mesh_obj(os.path.join(outdir, f"template_hist_{frame_id:06d}.obj"),
                        nodes, system.topo)
