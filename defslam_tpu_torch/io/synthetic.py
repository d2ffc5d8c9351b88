"""Synthetic deforming-surface sequence generator (host-side numpy).

The reference validates end-to-end on recorded datasets (Mandala, Hamlyn —
README.md section 5) which are not redistributable; this module provides a
procedurally generated stand-in with exact ground truth for tests and
benchmarks: a textured surface z = 1 + sum_i a_i(t) f_i(x, y) imaged by a
full-SE3 pinhole camera, with per-frame GT depth maps (the CT-style ground
truth of ``Apps/simple_CT.cc``) and GT camera poses.

The reference's evaluation sequences are handheld 6-DoF (a waving Mandala
cloth, Hamlyn endoscopy — README.md section 5, Apps/stereo_groundtruth.cc):
``rotation_deg`` reproduces that regime with an oscillating yaw/pitch/roll
sweep (bounded excursion keeps the surface in view like a handheld operator
does), and ``deform_modes`` superposes deformation harmonics at
incommensurate spatial/temporal frequencies.

This is the PyTorch port's numpy-only copy of ``defslam_tpu/io/synthetic.py``:
the texture blur is written in numpy instead of OpenCV, so frames agree with
the JAX package's generator to float rounding (not bit for bit).  Tests that
compare the two packages feed both the same frames.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from defslam_tpu_torch.config import CameraConfig


@dataclass
class SyntheticSequence:
    frames: np.ndarray  # (T, H, W) float32 grayscale
    depths: np.ndarray  # (T, H, W) float32 GT depth per pixel
    poses: np.ndarray  # (T, 4, 4) world->camera GT
    amps: np.ndarray  # (T,) first-mode deformation amplitude
    camera: CameraConfig
    frames_right: np.ndarray | None = None  # (T, H, W) rectified right view
    mode_amps: np.ndarray | None = None  # (T, 3) per-mode amplitudes


def _blur_axis(x: np.ndarray, k: np.ndarray, axis: int) -> np.ndarray:
    """Correlate ``x`` with the odd-length kernel ``k`` along ``axis`` with
    reflect-101 borders (OpenCV's default BORDER_REFLECT_101)."""
    r = len(k) // 2
    pad = [(0, 0), (0, 0)]
    pad[axis] = (r, r)
    xp = np.pad(x, pad, mode="reflect")
    n = x.shape[axis]
    out = np.zeros(x.shape, np.float64)
    for i, kv in enumerate(k):
        sl = [slice(None), slice(None)]
        sl[axis] = slice(i, i + n)
        out += kv * xp[tuple(sl)]
    return out


def _gaussian_blur(x: np.ndarray, sigma: float) -> np.ndarray:
    """numpy stand-in for ``cv2.GaussianBlur(x, (0, 0), sigma)`` on float32
    images: the same kernel size rule (round(8 sigma + 1) | 1), the same
    sampled-and-normalized Gaussian, the same reflect-101 border.  It agrees
    with OpenCV to float rounding, not bit for bit."""
    ks = int(round(sigma * 8 + 1)) | 1
    t = np.arange(ks) - (ks - 1) / 2.0
    k = np.exp(-0.5 * (t / sigma) ** 2)
    k /= k.sum()
    y = _blur_axis(x.astype(np.float64), k, axis=1)
    return _blur_axis(y, k, axis=0).astype(np.float32)


def _texture(h: int, w: int, seed: int) -> np.ndarray:
    """Multi-scale random texture: corner-rich but locally distinctive, so
    BRIEF descriptors stay matchable under the deformation's resampling
    (pure white noise decorrelates immediately)."""
    rng = np.random.default_rng(seed)
    t = np.zeros((h, w), np.float32)
    for sigma, amp in ((12.0, 1.0), (5.0, 0.8), (2.0, 0.5)):
        layer = rng.uniform(-1, 1, (h, w)).astype(np.float32)
        layer = _gaussian_blur(layer, sigma)
        t += amp * layer / (np.abs(layer).max() + 1e-9)
    t -= t.min()
    return (t / t.max() * 255.0).astype(np.float32)


def _surface_z(x, y, ma):
    """Surface height z(x, y) = 1 + sum_i ma[i] * f_i(x, y): three spatial
    harmonics at incommensurate frequencies/phases (mode 0 is the legacy
    single sinusoid)."""
    z = 1.0 + ma[0] * np.sin(2.0 * x) * np.cos(y)
    if ma[1]:
        z = z + ma[1] * np.sin(3.1 * x + 0.8) * np.cos(1.7 * y - 0.4)
    if ma[2]:
        z = z + ma[2] * np.cos(1.4 * x - 0.3) * np.sin(2.6 * y + 0.5)
    return z


def _euler_R(yaw, pitch, roll):
    """World-from-camera rotation R_wc = Ry(yaw) @ Rx(pitch) @ Rz(roll)."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    Rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
    return (Ry @ Rx @ Rz).astype(np.float32)


def make_sequence(
    n_frames: int = 30,
    height: int = 120,
    width: int = 160,
    max_amp: float = 0.10,
    seed: int = 0,
    fov_scale: float = 1.0,
    camera_motion: float = 0.0,
    baseline: float = 0.0,
    occlusion: tuple[int, int] | None = None,
    rotation_deg: float = 0.0,
    deform_modes: int = 1,
    brightness_drift: float = 0.0,
    start: int = 0,
    stop: int | None = None,
) -> SyntheticSequence:
    """Render a deforming textured surface.

    ``start`` / ``stop`` render only frames [start, stop) of the
    ``n_frames``-frame sequence (the arrays then hold those frames): each
    frame depends only on its index and the arguments, so the pieces are
    bit-equal to the same frames of one call.

    camera_motion > 0 adds a lateral camera translation of that total length
    (world units) over the sequence, exposing new surface area — the trigger
    for the reference's needNewTemplate/re-templating path
    (DefLocalMapping.cc:355-404).

    rotation_deg > 0 adds handheld-style 6-DoF attitude: an oscillating yaw
    sweep of that total peak-to-peak angle, plus pitch at half and roll at
    0.3x the amplitude on incommensurate temporal frequencies.  GT poses
    carry the full SE3 (world->camera); the render casts rotated rays.

    deform_modes in {1, 2, 3} superposes that many spatial deformation
    harmonics with different temporal frequencies (1 = legacy single mode).

    brightness_drift > 0 modulates frame gain by ±that fraction over the
    sequence (illumination change robustness).

    baseline > 0 additionally renders a rectified right view from a camera
    displaced by that distance along the LEFT camera's +x axis (the
    DefSLAMGT stereo-pair layout, Apps/stereo_groundtruth.cc).

    occlusion = (first, last) blanks frames [first, last] to near-uniform
    gray (a surgical-tool sweep / full occlusion): tracking must go LOST
    and recover by relocalization when the scene reappears.
    """
    cam = CameraConfig(
        fx=200.0 * fov_scale * width / 160.0,
        fy=200.0 * fov_scale * width / 160.0,
        cx=width / 2.0,
        cy=height / 2.0,
        width=width,
        height=height,
    )
    tex_h, tex_w = 1024, 1024
    tex = _texture(tex_h, tex_w, seed)
    # texture coords: surface (x, y) in [-L, L] -> texels
    L = 1.2 if (camera_motion > 0 or rotation_deg > 0) else 0.6

    px, py = np.meshgrid(np.arange(width), np.arange(height), indexing="xy")
    u = (px - cam.cx) / cam.fx
    v = (py - cam.cy) / cam.fy

    stop = n_frames if stop is None else stop
    frames = np.zeros((stop - start, height, width), np.float32)
    frames_r = np.zeros_like(frames) if baseline > 0 else None
    depths = np.zeros_like(frames)
    poses = np.tile(np.eye(4, dtype=np.float32), (stop - start, 1, 1))
    t_idx = np.arange(n_frames)
    mode_amps = np.zeros((n_frames, 3), np.float32)
    mode_amps[:, 0] = max_amp * np.sin(t_idx / 6.0)
    if deform_modes >= 2:
        mode_amps[:, 1] = 0.6 * max_amp * np.sin(t_idx / 2.7 + 1.0)
    if deform_modes >= 3:
        mode_amps[:, 2] = 0.4 * max_amp * np.sin(t_idx / 4.3 + 2.0)
    amps = mode_amps[start:stop, 0]

    yaw_max = 0.5 * np.deg2rad(rotation_deg)  # peak-to-peak -> amplitude

    def render(C, R_wc, ma):
        # ray: world point = C + lam * (R_wc @ [u, v, 1]); the camera-frame
        # point is lam * [u, v, 1], so lam is exactly the GT z-depth.
        # Intersect z = _surface_z(x, y) by fixed point on lam.
        d = (
            R_wc[:, 0:1, None] * u[None]
            + R_wc[:, 1:2, None] * v[None]
            + R_wc[:, 2:3, None]
        )  # (3, H, W)
        lam = np.ones_like(u)
        for _ in range(40):
            x = C[0] + lam * d[0]
            y = C[1] + lam * d[1]
            lam = (_surface_z(x, y, ma) - C[2]) / d[2]
        x, y = C[0] + lam * d[0], C[1] + lam * d[1]
        tx = np.clip((x + L) / (2 * L) * (tex_w - 1), 0, tex_w - 1.001)
        ty = np.clip((y + L) / (2 * L) * (tex_h - 1), 0, tex_h - 1.001)
        ix, iy = tx.astype(np.int64), ty.astype(np.int64)
        fx_, fy_ = tx - ix, ty - iy
        img = (
            tex[iy, ix] * (1 - fx_) * (1 - fy_)
            + tex[iy, ix + 1] * fx_ * (1 - fy_)
            + tex[iy + 1, ix] * (1 - fx_) * fy_
            + tex[iy + 1, ix + 1] * fx_ * fy_
        )
        return img, lam

    for i, t in enumerate(range(start, stop)):
        # camera center moves along +x in world; handheld attitude is an
        # oscillating yaw/pitch/roll on incommensurate frequencies
        cx_w = camera_motion * t / max(n_frames - 1, 1)
        C = np.asarray([cx_w, 0.0, 0.0], np.float32)
        if yaw_max > 0:
            ph = t / max(n_frames - 1, 1)
            R_wc = _euler_R(
                yaw_max * np.sin(2.0 * np.pi * 0.9 * ph),
                0.5 * yaw_max * np.sin(2.0 * np.pi * 1.4 * ph + 0.7),
                0.3 * yaw_max * np.sin(2.0 * np.pi * 0.6 * ph + 1.9),
            )
        else:
            R_wc = np.eye(3, dtype=np.float32)
        frames[i], depths[i] = render(C, R_wc, mode_amps[t])
        if brightness_drift > 0:
            gain = 1.0 + brightness_drift * np.sin(
                2.0 * np.pi * t / max(n_frames - 1, 1)
            )
            frames[i] = np.clip(frames[i] * gain, 0.0, 255.0)
        if frames_r is not None:
            frames_r[i], _ = render(
                C + R_wc @ np.asarray([baseline, 0.0, 0.0], np.float32),
                R_wc, mode_amps[t],
            )
            if brightness_drift > 0:
                frames_r[i] = np.clip(frames_r[i] * gain, 0.0, 255.0)
        # world->camera: R_cw = R_wc^T, t = -R_cw @ C
        poses[i, :3, :3] = R_wc.T
        poses[i, :3, 3] = -R_wc.T @ C
        if occlusion is not None and occlusion[0] <= t <= occlusion[1]:
            frames[i] = 128.0  # featureless: FAST finds nothing
            if frames_r is not None:
                frames_r[i] = 128.0
    return SyntheticSequence(
        frames=frames, depths=depths, poses=poses, amps=amps, camera=cam,
        frames_right=frames_r, mode_amps=mode_amps[start:stop],
    )
