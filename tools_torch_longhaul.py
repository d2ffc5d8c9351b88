"""Where the port's long-haul run parts from the JAX package's, on the CPU.

    JAX_PLATFORMS=cpu python tools_torch_longhaul.py [--runs jax,probe:1,port:2]
        [--frames 240] [--out chiprun_out/longhaul] [--reuse] [--reference PATH]

The JAX package's long-haul stress run (tests/test_stress_longhaul.py at
its CPU scale: 320x240, 600 features, 4 levels, 768 keypoints, 2048
points, 25 LM iterations, a keyframe every 10 frames, 12 keyframe slots,
frames 117-121 blank, seed 9, the default pipelined protocol), through the
runs named in ``--runs``, each in its own process, all started together:

- ``jax``: the JAX package (on its own render);
- ``probe:SEED``: the JAX package with its template after frame 0 scaled
  by 1 + N(0, 1e-7) drawn from numpy seed SEED, the repo's measure of the
  reference's own sensitivity (ROADMAP section C);
- ``port:THREADS``: the port on the CPU with THREADS torch threads (on its
  own render, as tests/test_torch_stress_longhaul.py runs it).

Each run saves to ``--out`` (``--reuse`` loads the runs saved there
instead of running them again), per call, the keyframe store's frame ids
and valid flags and the live point count, and
at the end the metrics rows, the trajectory and its summary: ATE, the
final median depth error, the thirds' inliers, template swaps, evictions,
the anchor keyframe's frame, as tests/test_stress_longhaul.py computes
them.  The comparison prints per frame the JAX run's, the first port
run's and the first probe's state, matches, inliers, keyframe and template
flags, the slot a keyframe took, the live points, and the port's pose gap
to the JAX run beside the median of the probes' gaps, then the first frame
where the port leaves the JAX run by more than 3x what the probes do (``rows.txt`` in ``--out``), and every run's
summary.

``--reference PATH`` also writes, as JSON, the JAX run's rows up to the
first frame where any probe's row parts from it (state, keyframe and
template flags, the slot taken, the store's frame ids and valid flags),
each with its pose and 3x the median of the probes' pose gaps there: the
window that tests/test_torch_stress_longhaul.py holds the port to
(tests/data/longhaul_jax_window.json comes from
``--runs jax,probe:1,probe:2,probe:3,probe:4,port:4``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

N_FRAMES = 240
PERTURB = 1e-7
# the stress run's render at its CPU scale (either package's make_sequence)
STRESS_RENDER = dict(height=240, width=320, max_amp=0.07, camera_motion=0.9, seed=9,
                     occlusion=(117, 121), rotation_deg=16, deform_modes=3, brightness_drift=0.1)


def stress_config(pkg, camera):
    """tests/test_stress_longhaul.py's Config at its CPU scale, built from
    ``pkg``'s config module (either package's: the fields are the same)."""
    return pkg.Config(
        camera=camera,
        orb=pkg.OrbConfig(n_features=600, n_levels=4, max_keypoints=768),
        sft=pkg.SfTConfig(lm_iterations=25),
        tracking=pkg.TrackingConfig(keyframe_period=10),
        capacity=pkg.CapacityConfig(max_map_points=2048, max_keyframes=12),
        mapping=pkg.MappingConfig(points_to_template=70, chi_limit=0.5),
    )


def thirds_inliers(metrics):
    """Median inliers of the first and last third of the OK frames with
    inliers (test_matches_stay_healthy)."""
    ok = [m for m in metrics if m["state"] == "OK" and m["inliers"] > 0]
    return (float(np.median([m["inliers"] for m in ok[: len(ok) // 3]])),
            float(np.median([m["inliers"] for m in ok[-len(ok) // 3:]])))


def _run(name, save, n_frames):
    kind, _, arg = name.partition(":")
    if kind == "port":
        import torch

        from defslam_tpu_torch import config as pkg
        from defslam_tpu_torch.io.synthetic import make_sequence
        from defslam_tpu_torch.system import System

        torch.set_num_threads(int(arg or 2))
        seq = make_sequence(n_frames=n_frames, **STRESS_RENDER)
        s = System(stress_config(pkg, seq.camera), device="cpu")
    else:
        import jax
        import jax.numpy as jnp

        jax.config.update("jax_platforms", "cpu")
        from defslam_tpu import config as pkg
        from defslam_tpu.io.synthetic import make_sequence
        from defslam_tpu.system import System

        seq = make_sequence(n_frames=n_frames, **STRESS_RENDER)
        s = System(stress_config(pkg, seq.camera))
    snaps = {"kf_fid": [], "kf_valid": [], "n_points": []}
    t0 = time.perf_counter()
    for t in range(n_frames):
        s.track_monocular(seq.frames[t], timestamp=float(t))
        if t == 0 and kind == "probe":
            rng = np.random.default_rng(int(arg or 1))
            noise = rng.normal(0, PERTURB, (s.cfg.mesh.n_nodes, 3))
            s.template = s.template._replace(
                nodes=s.template.nodes * (1 + jnp.asarray(noise, jnp.float32)))
        snaps["kf_fid"].append(np.asarray(s.kfs.frame_id).copy())
        snaps["kf_valid"].append(np.asarray(s.kfs.valid).copy())
        snaps["n_points"].append(int(np.asarray(s.points.valid).sum()))
    s.flush()
    wall = time.perf_counter() - t0
    from defslam_tpu_torch.groundtruth import gt

    depth_gt = np.asarray(seq.depths[n_frames - 1])
    if kind == "port":
        med, n_med = gt.system_depth_error(s, depth_gt)
    else:
        # as the JAX package's test computes it, in JAX
        from defslam_tpu.geometry import camera as jcam
        from defslam_tpu.geometry import se3 as jse3

        pc = jse3.transform(s.pose, s.points.xyz)
        med, n_med = gt.median_depth_error(np.asarray(pc), np.asarray(jcam.project(s.K, pc)),
                                           np.asarray(s.points.valid),
                                           np.asarray(s.points.facet), depth_gt)
    ate = gt.ate_rmse_trajectory(s.trajectory, seq.poses)
    np.savez(save, **{k: np.asarray(v) for k, v in snaps.items()},
             traj_ts=np.asarray([ts for ts, _ in s.trajectory]),
             traj_T=np.stack([np.asarray(T) for _, T in s.trajectory]),
             final_kf_fid=np.asarray(s.kfs.frame_id), final_kf_valid=np.asarray(s.kfs.valid),
             metrics=np.frombuffer(json.dumps(s._metrics).encode(), np.uint8),
             summary=np.frombuffer(json.dumps(dict(
                 wall_s=wall, ate=ate, median_depth_error=med, n_depth_points=n_med,
                 template_ref_kf=int(s.template_ref_kf), n_rollbacks=getattr(s, "n_rollbacks", -1),
             )).encode(), np.uint8))


def _load(path):
    with np.load(path) as d:
        out = {k: d[k] for k in d.files}
    out["metrics"] = json.loads(bytes(out["metrics"]).decode())
    out["summary"] = json.loads(bytes(out["summary"]).decode())
    return out


def summary(r):
    m = r["metrics"]
    first, last = thirds_inliers(m)
    n_kf = sum(1 for x in m if x["keyframe"])
    anchor = int(r["final_kf_fid"][r["summary"]["template_ref_kf"]])
    return dict(r["summary"], first_third=first, last_third=last, keyframes=n_kf,
                evictions=n_kf - int(r["final_kf_valid"].shape[0]),
                swaps=sum(1 for x in m if x["template"]), anchor_frame=anchor,
                lost=[x["t"] for x in m if x["state"] != "OK"])


def slot_taken(r, t):
    """The slot a keyframe took at call t (-1: none), from the snapshots."""
    before = r["kf_fid"][t - 1] if t else np.full_like(r["kf_fid"][0], -1)
    vb = r["kf_valid"][t - 1] if t else np.zeros_like(r["kf_valid"][0])
    changed = np.nonzero((r["kf_fid"][t] != before) | (r["kf_valid"][t] != vb))[0]
    return int(changed[0]) if len(changed) else -1


def row_key(r, t):
    """What a run's call t must match exactly: state, keyframe and template
    flags, the slot a keyframe took, the store's frame ids and valid flags."""
    m = r["metrics"][t]
    return (m["state"], bool(m["keyframe"]), bool(m["template"]), slot_taken(r, t),
            r["kf_fid"][t].tolist(), r["kf_valid"][t].tolist())


def write_reference(runs, path):
    """The JAX run's rows before the first frame where a probe's
    ``row_key`` parts from it, with the pose and its bound (module
    docstring)."""
    jx = runs["jax"]
    probes = [r for name, r in runs.items() if name.startswith("probe")]
    n = len(jx["metrics"])
    end = min(next((t for t in range(n) if row_key(p, t) != row_key(jx, t)), n) for p in probes)
    pj = dict(zip(jx["traj_ts"].tolist(), jx["traj_T"]))
    rows = []
    for t in range(end):
        state, kf, tmpl, slot, fid, valid = row_key(jx, t)
        rows.append(dict(t=t, state=state, keyframe=kf, template=tmpl, slot=slot, kf_fid=fid,
                         kf_valid=valid, pose=pj[float(t)].tolist(),
                         pose_bound=3 * float(np.median([pose_gap(p, jx, t) for p in probes]))))
    names = [name for name in runs if name.startswith("probe")]
    with open(path, "w") as f:  # a row a line
        f.write('{"probes": ' + json.dumps(names) + ', "rows": [\n'
                + ",\n".join(json.dumps(r) for r in rows) + "\n]}\n")
    print(f"{path}: the JAX run's rows 0-{end - 1} (a probe parts from it at frame {end})")


def pose_gap(r, ref, t):
    """Max abs difference of run ``r``'s pose at call t from ``ref``'s
    (nan where either has none)."""
    pr = dict(zip(r["traj_ts"].tolist(), r["traj_T"]))
    pf = dict(zip(ref["traj_ts"].tolist(), ref["traj_T"]))
    if float(t) not in pr or float(t) not in pf:
        return float("nan")
    return float(np.abs(pr[float(t)] - pf[float(t)]).max())


def compare(runs, out_dir):
    """Per-frame rows of the JAX run, the first port run and the first
    probe, with the median of every probe's pose gap; the summary of every
    run."""
    jx = runs["jax"]
    port = next(r for n, r in runs.items() if n.startswith("port"))
    probes = [r for n, r in runs.items() if n.startswith("probe")]
    probe = probes[0]
    lines, first = [], None
    hdr = ("t | state j/p | matches j/p/probe | inliers j/p/probe | kf j/p | tmpl j/p | "
           "slot j/p/probe | points j/p/probe | gap port / median of the probes")
    lines.append(hdr)
    for t in range(len(jx["metrics"])):
        mj, mp, mq = jx["metrics"][t], port["metrics"][t], probe["metrics"][t]
        gp = pose_gap(port, jx, t)
        gq = float(np.median([pose_gap(q, jx, t) for q in probes]))
        flag = ""
        if first is None and (mj["state"] != mp["state"] or gp > 3 * max(gq, 1e-6)):
            first = t
            flag = "  <-- first"
        lines.append(
            f"{t} | {mj['state']}/{mp['state']} | "
            f"{mj['matches']}/{mp['matches']}/{mq['matches']} | "
            f"{mj['inliers']}/{mp['inliers']}/{mq['inliers']} | {int(mj['keyframe'])}/"
            f"{int(mp['keyframe'])} | {int(mj['template'])}/{int(mp['template'])} | "
            f"{slot_taken(jx, t)}/{slot_taken(port, t)}/{slot_taken(probe, t)} | "
            f"{jx['n_points'][t]}/{port['n_points'][t]}/{probe['n_points'][t]} | "
            f"{gp:.2e} / {gq:.2e}{flag}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "rows.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    print(f"first frame where the port leaves the JAX run by > 3x the probes: {first}")
    for name, r in runs.items():
        print(name, json.dumps(summary(r)))
    print(f"per-frame rows: {os.path.join(out_dir, 'rows.txt')}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=N_FRAMES)
    ap.add_argument("--runs", default="jax,probe:1,port:2",
                    help="comma-separated: jax, probe:SEED (the template scaled by 1 + "
                         "N(0, 1e-7) drawn from numpy seed SEED), port:THREADS")
    ap.add_argument("--out", default="chiprun_out/longhaul")
    ap.add_argument("--run", help="run one (what the parent spawns)")
    ap.add_argument("--save")
    ap.add_argument("--reuse", action="store_true",
                    help="load the runs already saved in --out instead of running them again")
    ap.add_argument("--reference", help="write the JAX run's window here (module docstring)")
    args = ap.parse_args()
    if args.run:
        _run(args.run, args.save, args.frames)
        return 0
    os.makedirs(args.out, exist_ok=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    path = {name: os.path.join(args.out, f"{name.replace(':', '_')}.npz")
            for name in args.runs.split(",")}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--run", name,
                               "--frames", str(args.frames), "--save", p], env=env)
             for name, p in path.items() if not (args.reuse and os.path.exists(p))]
    if any(p.wait() for p in procs):
        return 1
    runs = {name: _load(p) for name, p in path.items()}
    compare(runs, args.out)
    if args.reference:
        write_reference(runs, args.reference)
    return 0


if __name__ == "__main__":
    sys.exit(main())
