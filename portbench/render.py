"""The benchmark's camera stream: a textured deforming surface ray-cast on
the device from ``--seed``, with its ground truth.

A torch copy of the port's numpy generator (``io/synthetic.make_sequence``:
the surface z = 1 + sum_i a_i(t) f_i(x, y), a handheld 6-DoF camera, the
brightness drift), so the stream's frames, poses and depths are the
benchmark's own.  Each frame depends only on its index and the mix's
parameters; :class:`Stream` renders a whole period ahead on the device, as
uint8 images as a camera gives them, and plays it forwards and back again
(0, 1, ..., N-1, N-2, ..., 1, 0, 1, ...), so the camera's path stays
continuous and on the texture however many frames a run feeds.

The texture is drawn by numpy's ``default_rng(seed)`` as in the port's
generator and blurred on the device in float64; the render runs in float64
too.  Its pixels agree with the numpy render's to float rounding.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

TEXTURE = 1024  # texels per side
FIXED_POINT_ITERS = 40  # ray / surface intersection


def camera(width: int, height: int, fov_scale: float = 1.0) -> dict:
    """The generator's pinhole camera for a ``width`` x ``height`` image."""
    f = 200.0 * fov_scale * width / 160.0
    return {"fx": f, "fy": f, "cx": width / 2.0, "cy": height / 2.0,
            "width": width, "height": height}


def _blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """``cv2.GaussianBlur(x, (0, 0), sigma)``'s kernel (size round(8 sigma +
    1) | 1, sampled and normalized) with reflect-101 borders, in float64."""
    ks = int(round(sigma * 8 + 1)) | 1
    t = torch.arange(ks, dtype=torch.float64, device=x.device) - (ks - 1) / 2.0
    k = torch.exp(-0.5 * (t / sigma) ** 2)
    k = k / k.sum()
    r = ks // 2
    y = x[None, None].to(torch.float64)
    y = F.conv2d(F.pad(y, (r, r, 0, 0), mode="reflect"), k.view(1, 1, 1, ks))
    y = F.conv2d(F.pad(y, (0, 0, r, r), mode="reflect"), k.view(1, 1, ks, 1))
    return y[0, 0].to(torch.float32)


def texture(seed: int, device) -> torch.Tensor:
    """The multi-scale random texture (TEXTURE x TEXTURE float32 in
    [0, 255]), the layers drawn as the port's generator draws them."""
    rng = np.random.default_rng(seed)
    t = torch.zeros((TEXTURE, TEXTURE), dtype=torch.float32, device=device)
    for sigma, amp in ((12.0, 1.0), (5.0, 0.8), (2.0, 0.5)):
        layer = rng.uniform(-1, 1, (TEXTURE, TEXTURE)).astype(np.float32)
        layer = _blur(torch.from_numpy(layer).to(device), sigma)
        t = t + amp * layer / (layer.abs().max() + 1e-9)
    t = t - t.min()
    return t / t.max() * 255.0


def _euler_R(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """World-from-camera rotation Ry(yaw) Rx(pitch) Rz(roll), float32."""
    cy, sy = math.cos(yaw), math.sin(yaw)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cr, sr = math.cos(roll), math.sin(roll)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    Rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
    return (Ry @ Rx @ Rz).astype(np.float32)


class Scene:
    """The mix's surface, camera path and texture.  ``mix`` holds the
    generator's parameters: ``n_frames``, ``width``, ``height``,
    ``max_amp``, ``camera_motion``, ``rotation_deg``, ``deform_modes``,
    ``brightness_drift`` and optionally ``fov_scale``."""

    def __init__(self, mix: dict, seed: int, device):
        self.n = int(mix["n_frames"])
        self.width, self.height = int(mix["width"]), int(mix["height"])
        self.max_amp = float(mix["max_amp"])
        self.motion = float(mix["camera_motion"])
        self.rotation = float(mix["rotation_deg"])
        self.modes = int(mix["deform_modes"])
        self.drift = float(mix["brightness_drift"])
        self.cam = camera(self.width, self.height, float(mix.get("fov_scale", 1.0)))
        self.device = torch.device(device)
        self.tex = texture(seed, self.device)
        self.extent = 1.2 if (self.motion > 0 or self.rotation > 0) else 0.6
        t = np.arange(self.n)
        ma = np.zeros((self.n, 3), np.float32)
        ma[:, 0] = self.max_amp * np.sin(t / 6.0)
        if self.modes >= 2:
            ma[:, 1] = 0.6 * self.max_amp * np.sin(t / 2.7 + 1.0)
        if self.modes >= 3:
            ma[:, 2] = 0.4 * self.max_amp * np.sin(t / 4.3 + 2.0)
        self.mode_amps = ma
        c = self.cam
        px = torch.arange(self.width, dtype=torch.float64, device=self.device)
        py = torch.arange(self.height, dtype=torch.float64, device=self.device)
        self.u = ((px - c["cx"]) / c["fx"])[None, :].expand(self.height, -1)
        self.v = ((py - c["cy"]) / c["fy"])[:, None].expand(-1, self.width)

    def rig(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """(camera centre C (3,), world-from-camera rotation R_wc (3, 3)) of
        frame ``i``, float32."""
        span = max(self.n - 1, 1)
        C = np.asarray([self.motion * i / span, 0.0, 0.0], np.float32)
        yaw_max = 0.5 * np.deg2rad(self.rotation)
        if yaw_max > 0:
            ph = i / span
            R = _euler_R(yaw_max * math.sin(2.0 * math.pi * 0.9 * ph),
                         0.5 * yaw_max * math.sin(2.0 * math.pi * 1.4 * ph + 0.7),
                         0.3 * yaw_max * math.sin(2.0 * math.pi * 0.6 * ph + 1.9))
        else:
            R = np.eye(3, dtype=np.float32)
        return C, R

    def pose(self, i: int) -> np.ndarray:
        """Ground-truth world -> camera pose of frame ``i`` (4, 4) float32."""
        C, R = self.rig(i)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R.T
        T[:3, 3] = -R.T @ C
        return T

    def _z(self, x, y, ma):
        z = 1.0 + float(ma[0]) * torch.sin(2.0 * x) * torch.cos(y)
        if ma[1]:
            z = z + float(ma[1]) * torch.sin(3.1 * x + 0.8) * torch.cos(1.7 * y - 0.4)
        if ma[2]:
            z = z + float(ma[2]) * torch.cos(1.4 * x - 0.3) * torch.sin(2.6 * y + 0.5)
        return z

    def render(self, i: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(image, depth) of frame ``i``: (H, W) float32 intensities in
        [0, 255] and the ground-truth z-depth of every pixel."""
        C, R = self.rig(i)
        C = [float(c) for c in C]
        R = torch.as_tensor(R, dtype=torch.float64, device=self.device)
        d = R[:, 0, None, None] * self.u + R[:, 1, None, None] * self.v + R[:, 2, None, None]
        ma = self.mode_amps[i]
        lam = torch.ones_like(self.u)
        for _ in range(FIXED_POINT_ITERS):
            x = C[0] + lam * d[0]
            y = C[1] + lam * d[1]
            lam = (self._z(x, y, ma) - C[2]) / d[2]
        x, y = C[0] + lam * d[0], C[1] + lam * d[1]
        L, n = self.extent, TEXTURE
        tx = torch.clamp((x + L) / (2 * L) * (n - 1), 0, n - 1.001)
        ty = torch.clamp((y + L) / (2 * L) * (n - 1), 0, n - 1.001)
        ix, iy = tx.long(), ty.long()
        fx, fy = tx - ix, ty - iy
        tex = self.tex.to(torch.float64)
        img = (tex[iy, ix] * (1 - fx) * (1 - fy) + tex[iy, ix + 1] * fx * (1 - fy)
               + tex[iy + 1, ix] * (1 - fx) * fy + tex[iy + 1, ix + 1] * fx * fy)
        img = img.to(torch.float32)
        if self.drift > 0:
            gain = 1.0 + self.drift * math.sin(2.0 * math.pi * i / max(self.n - 1, 1))
            img = torch.clamp(img * gain, 0.0, 255.0)
        return img, lam.to(torch.float32)


class Stream:
    """The scene's frames rendered ahead as uint8 on the device, played
    forwards and back: position ``k`` of the stream shows frame
    :meth:`index` ``(k)``."""

    def __init__(self, scene: Scene):
        self.scene = scene
        self.frames = torch.empty((scene.n, scene.height, scene.width), dtype=torch.uint8,
                                  device=scene.device)
        for i in range(scene.n):
            img, _ = scene.render(i)
            self.frames[i] = torch.round(img).to(torch.uint8)
        self.poses = np.stack([scene.pose(i) for i in range(scene.n)])

    def index(self, k: int) -> int:
        n = self.scene.n
        if n == 1:
            return 0
        r = k % (2 * (n - 1))
        return r if r < n else 2 * (n - 1) - r

    def frame(self, k: int) -> torch.Tensor:
        """The image at stream position ``k``, (H, W) float32 on the device."""
        return self.frames[self.index(k)].float()
