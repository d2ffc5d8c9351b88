"""Where the PyTorch port and the JAX package part, on the CPU.

    JAX_PLATFORMS=cpu python tools_torch_parity.py [--skip-full]

A diagnostic beside the parity tests (which assert; this prints the
numbers behind their tolerances).  It imports both packages, so it runs
where JAX is installed, not on the card.  Sections:

1. frontend: per pyramid level the share of pixels that differ from the
   JAX package's resize, then keypoint rows that differ and descriptor
   bits that differ on the rows both found; at 160x120 (3 levels, 512
   keypoints) and, unless --skip-full, 640x480 (the default Config);
2. SfT: the LM's accept/reject path, iteration by iteration, in both
   packages on a curved-template fixture (where rounding flips a decision);
3. System: an 8-frame 160x120 localization run, per frame the pose gap
   port vs JAX and JAX vs JAX with its template scaled by 1 + N(0, 1e-7);
4. unless --skip-full: frame 1 of a 12-frame full-size render of the bench
   motion, tracked from the frame-0 map in both packages.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import jax
import jax.numpy as jnp
import torch

from defslam_tpu import frontend as jf
from defslam_tpu.config import (CapacityConfig, Config, OrbConfig, SfTConfig,
                                TrackingConfig)
from defslam_tpu.geometry import camera as jcam
from defslam_tpu.geometry import se3 as jse3
from defslam_tpu.io.synthetic import make_sequence
from defslam_tpu.ops import pyramid as jpyr
from defslam_tpu.system import System as JaxSystem
from defslam_tpu.template import mesh as jmesh
from defslam_tpu.tracking import sft as jsft
from defslam_tpu.tracking import tracker as jtracker
from defslam_tpu_torch import frontend as tf
from defslam_tpu_torch.convert import (config_from_dict, namedtuple_from_numpy,
                                       state_from_numpy, to_numpy_dict)
from defslam_tpu_torch.geometry import se3 as tse3
from defslam_tpu_torch.ops import pyramid as tpyr
from defslam_tpu_torch.system import System
from defslam_tpu_torch.template import mesh as tmesh
from defslam_tpu_torch.tracking import sft as tsft
from defslam_tpu_torch.tracking import tracker as ttracker


def _port_cfg(cfg):
    return config_from_dict(dataclasses.asdict(cfg))


def frontend_section(seq, cfg, label, frames=4):
    tcfg = _port_cfg(cfg)
    oc = cfg.orb
    pyr_j = jax.jit(lambda x: jpyr.build_pyramid(x, oc.n_levels, oc.scale_factor))
    for t in range(frames):
        img = seq.frames[t]
        lj = pyr_j(jnp.asarray(img))
        lt = tpyr.build_pyramid(torch.from_numpy(img), oc.n_levels, oc.scale_factor)
        neq = [float((np.asarray(a) != b.numpy()).mean()) for a, b in zip(lj, lt)]
        a = jf.extract_features(jnp.asarray(img), cfg)
        b = tf.extract_features(torch.from_numpy(img), tcfg)
        same = ((np.asarray(a.xy) == b.xy.numpy()).all(1)
                & (np.asarray(a.level) == b.level.numpy())
                & (np.asarray(a.valid) == b.valid.numpy()))
        dj = np.asarray(a.desc).view(np.int32)[same]
        bits = np.unpackbits((dj ^ b.desc.numpy()[same]).view(np.uint8)).mean()
        print(f"frontend {label} frame {t}: level pixels differing "
              f"{['%.4f' % x for x in neq]}; keypoint rows differing "
              f"{int((~same).sum())}/{len(same)}; descriptor bits differing {bits:.2e}")


def sft_section():
    K = jnp.asarray([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1.0]])
    dom = jnp.asarray([-0.4, 0.4, -0.3, 0.3])
    topo = jmesh.grid_topology(10, 10)
    rest = jmesh.grid_nodes_from_surface(
        lambda u, v: jnp.stack([u, v, 1.0 + 0.15 * jnp.cos(3 * u) * jnp.cos(4 * v)], -1),
        dom, topo)
    tmpl = jmesh.make_template(rest, topo)
    rng = np.random.default_rng(2)
    uv = np.stack([rng.uniform(-0.38, 0.38, 200), rng.uniform(-0.28, 0.28, 200)], 1)
    facet, bary, _ = jmesh.embed_uv(jnp.asarray(uv, jnp.float32), dom, topo)
    U, V = np.meshgrid(np.linspace(-0.4, 0.4, 10), np.linspace(-0.3, 0.3, 10), indexing="ij")
    dz = 0.08 * np.sin(2 * np.pi * U / 0.8) * np.cos(np.pi * V / 0.6)
    nodes_true = rest + jnp.asarray(np.stack([0 * dz, 0 * dz, dz], -1).reshape(-1, 3), jnp.float32)
    T_true = jse3.se3_exp(jnp.asarray([0.02, -0.01, 0.03, 0.01, -0.02, 0.005], jnp.float32))
    obs = jcam.project(K, jse3.transform(T_true, jmesh.facet_positions(nodes_true, topo, facet, bary)))
    obs = obs + jnp.asarray(rng.normal(0, 0.3, obs.shape), jnp.float32)
    data = jsft.data_from_template(tmpl, K, jnp.eye(4), obs_uv=obs, obs_face=facet,
                                   obs_bary=bary, obs_invsigma2=jnp.ones(200),
                                   obs_mask=jnp.ones(200, bool), n_kp=200.0)
    cfg = Config(sft=SfTConfig(lm_iterations=25))
    tcfg = _port_cfg(cfg)
    td = namedtuple_from_numpy(tsft.SfTData, to_numpy_dict(d=data), "cpu", prefix="d.")
    ttopo = tmesh.grid_topology(10, 10)
    pj = jsft._prepare(data, topo, cfg, 0.05)
    pt = tsft._prepare(td, ttopo, tcfg, 0.05)
    hd = cfg.sft.huber_delta

    def step_j(T, n, lam):
        o = jsft._obs_normal_eq_impl(T, n, data, pj, hd, jnp.asarray(topo.faces), 162)
        r = jsft.reg_normal_eq(n, data, pj)
        H, g = jsft.dense_system(o[0], o[1], o[2] + r[0], o[3], o[4] + r[1], pj)
        A = H + lam * jnp.diag(jnp.diag(H) + 1e-9)
        dx = -jax.scipy.linalg.cho_solve((jnp.linalg.cholesky(A), True), g)
        T2, n2 = jse3.se3_exp(dx[:6]) @ T, n + dx[6:].reshape(100, 3)
        return T2, n2, float(jsft.obs_cost(T2, n2, data, pj, hd) + jsft.reg_cost(n2, data, pj))

    def step_t(T, n, lam):
        o = tsft._obs_normal_eq_impl(T, n, td, pt, hd)
        r = tsft.reg_normal_eq(n, td, pt)
        H, g = tsft.dense_system(o[0], o[1], o[2] + r[0], o[3], o[4] + r[1], pt)
        A = H + lam * torch.diag(torch.diagonal(H) + 1e-9)
        dx = -torch.cholesky_solve(g[:, None], torch.linalg.cholesky(A))[:, 0]
        T2, n2 = tse3.se3_exp(dx[:6]) @ T, n + dx[6:].reshape(100, 3)
        return T2, n2, float(tsft.obs_cost(T2, n2, td, pt, hd) + tsft.reg_cost(n2, td, pt))

    state = {
        "jax": [data.T0, data.nodes0, float(jsft.obs_cost(data.T0, data.nodes0, data, pj, hd)
                                            + jsft.reg_cost(data.nodes0, data, pj)), 1e-4, step_j],
        "port": [td.T0, td.nodes0, float(tsft.obs_cost(td.T0, td.nodes0, td, pt, hd)
                                         + tsft.reg_cost(td.nodes0, td, pt)), 1e-4, step_t],
    }
    for it in range(12):
        row = []
        for name, s in state.items():
            T, n, c, lam, step = s
            T2, n2, c2 = step(T, n, lam)
            accept = c2 < c
            row.append(f"{name} {'accept' if accept else 'reject'} {100 * (c2 / c - 1):+.2f}%")
            if accept:
                s[0], s[1], s[2] = T2, n2, c2
            s[3] = min(max(lam * (0.5 if accept else 4.0), 1e-10), 1e8)
        print(f"sft curved seed 2, LM iteration {it}: " + "; ".join(row))


def system_section():
    seq = make_sequence(n_frames=16, height=120, width=160, max_amp=0.08)
    cfg = Config(camera=seq.camera, orb=OrbConfig(n_features=300, n_levels=3, max_keypoints=384),
                 sft=SfTConfig(lm_iterations=15), tracking=TrackingConfig(keyframe_period=3),
                 capacity=CapacityConfig(max_map_points=512, max_keyframes=8))

    def run_jax(perturb):
        s = JaxSystem(cfg)
        for t in range(8):
            s.track_monocular(seq.frames[t], timestamp=float(t))
            if t == 0:
                s.activate_localization_mode()
                if perturb:
                    noise = np.random.default_rng(1).normal(0, perturb, (100, 3))
                    s.template = s.template._replace(
                        nodes=s.template.nodes * (1 + jnp.asarray(noise, jnp.float32)))
        s.flush()
        return s

    ref, probe = run_jax(0.0), run_jax(1e-7)
    port = System(_port_cfg(cfg), device="cpu")
    for t in range(8):
        port.track_monocular(seq.frames[t], timestamp=float(t))
        if t == 0:
            port.activate_localization_mode()
    port.flush()
    for i in range(8):
        Tj, Tp, Tt = (np.asarray(s.trajectory[i][1]) for s in (ref, probe, port))
        print(f"system frame {i}: inliers jax {ref._metrics[i]['inliers']} port "
              f"{port._metrics[i]['inliers']} jax' {probe._metrics[i]['inliers']}; "
              f"pose gap port-jax {np.abs(Tt - Tj).max():.2e}, jax'-jax {np.abs(Tp - Tj).max():.2e}")


def full_frame1_section():
    seq = make_sequence(n_frames=12, height=480, width=640, max_amp=0.08, camera_motion=0.35,
                        rotation_deg=20, deform_modes=3, brightness_drift=0.1)
    cfg = Config(camera=seq.camera, tracking=TrackingConfig(pipelined=False))
    tcfg = _port_cfg(cfg)
    js = JaxSystem(cfg)
    js.track_monocular(seq.frames[0])
    ms = state_from_numpy(to_numpy_dict(points=js.points, template=js.template,
                                        pose=js.pose, prev_pose=js.prev_pose), "cpu")
    sj = jtracker.track_frame(jnp.asarray(seq.frames[1]), js.points, js.pose, js.prev_pose,
                              js.template, js.K, cfg)[4]
    st = ttracker.track_frame(torch.from_numpy(seq.frames[1]), ms.points, ms.pose, ms.prev_pose,
                              ms.template, torch.as_tensor(tcfg.camera.K), tcfg)[4]
    print(f"12-frame full-size render, frame 1 [matches, inliers, candidates, dropped]: "
          f"jax {np.asarray(sj).tolist()} port {st.tolist()}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-full", action="store_true")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    small = make_sequence(n_frames=4, height=120, width=160, max_amp=0.08)
    frontend_section(small, Config(camera=small.camera, orb=OrbConfig(
        n_features=400, n_levels=3, max_keypoints=512)), "160x120")
    if not args.skip_full:
        full = make_sequence(n_frames=24, height=480, width=640, max_amp=0.08, camera_motion=0.35,
                             rotation_deg=20, deform_modes=3, brightness_drift=0.1)
        frontend_section(full, Config(camera=full.camera), "640x480")
    sft_section()
    system_section()
    if not args.skip_full:
        full_frame1_section()
    return 0


if __name__ == "__main__":
    sys.exit(main())
