"""Dataset readers for the reference's app input layouts.

Port of ``defslam_tpu/io/datasets.py``.  Reference apps (``Apps/``):

- ``DefSLAM <vocab> <yaml> <video|camera>`` (simple_camera.cc:4-55);
- ``DefSLAMGT``: rectified stereo pairs named ``stereo_im_l_<t>.png`` /
  ``stereo_im_r_<t>.png`` with microsecond timestamps, starting at frame
  200 (stereo_groundtruth.cc:21-188, with cv::stereoRectify of raw pairs
  at 56-94);
- ``DefSLAMGTCT``: a video plus per-frame depth maps stored as text files
  (simple_CT.cc:8-115, ``loadCT`` at 97-115).

The JAX package reads images, rectifies and resizes with OpenCV.  The port
needs no OpenCV for a PNG dataset: PNGs decode with ``io.png`` and the
rectification maps, the remap and the resize are numpy ports of
``cv2.initUndistortRectifyMap``, ``cv2.remap`` and ``cv2.resize``
(bilinear).  Other image formats and video need ``cv2``, imported only
when they are read; there is no other route for them.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Iterator

import numpy as np

from defslam_tpu_torch.io import png

# cv2.remap's sub-pixel resolution: a map coordinate is rounded to 1/32 px
INTER_TAB_SIZE = 32


def _cv2(what: str):
    try:
        import cv2
    except ImportError:
        raise ImportError(
            f"{what} needs OpenCV (the cv2 module), which is not installed; "
            "PNG datasets are read without it") from None
    return cv2


def _imread_gray(path: str) -> np.ndarray:
    """An image file as float32 grey, as ``cv2.imread(path,
    IMREAD_GRAYSCALE)`` decodes it."""
    if path.lower().endswith(".png"):
        return png.read_png(path).astype(np.float32)
    cv2 = _cv2(f"reading {os.path.basename(path)}")
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(path)
    return img.astype(np.float32)


def _timestamp_of(path: str) -> float:
    m = re.search(r"_(\d+)\.(png|jpg|tiff?)$", os.path.basename(path))
    return float(m.group(1)) / 1e6 if m else 0.0


def load_stereo_sequence(directory: str, start: int = 0
                         ) -> Iterator[tuple[np.ndarray, np.ndarray, float]]:
    """Yield (left, right, timestamp) from a DefSLAMGT-layout directory.
    The reference starts at frame 200 of the Mandala sequences
    (stereo_groundtruth.cc:113); pass start=200 for parity."""
    lp, rp, ts = stereo_pair_paths(directory, start)
    for left, right, t in zip(lp, rp, ts):
        yield _imread_gray(left), _imread_gray(right), t


def stereo_pair_paths(directory: str, start: int = 0):
    """(left_paths, right_paths, timestamps) of a DefSLAMGT-layout
    directory, in timestamp order from the ``start``-th left image; a left
    image without its right one is skipped."""
    lefts = sorted(glob.glob(os.path.join(directory, "stereo_im_l_*.png")), key=_timestamp_of)
    lp, rp, ts = [], [], []
    for left in lefts[start:]:
        right = left.replace("stereo_im_l_", "stereo_im_r_")
        if not os.path.exists(right):
            continue
        lp.append(left)
        rp.append(right)
        ts.append(_timestamp_of(left))
    return lp, rp, ts


def undistort_rectify_map(K, D, R, P, size: tuple[int, int]):
    """``cv2.initUndistortRectifyMap(K, D, R, P, size, cv2.CV_32FC1)``:
    for each pixel of the rectified (width, height) image, where to sample
    the raw one.  ``D`` is ``k1 k2 p1 p2 [k3]``.  Computed in float64, as
    OpenCV does, and returned as float32 maps (x, y)."""
    K = np.asarray(K, np.float64).reshape(3, 3)
    D = np.asarray(D, np.float64).reshape(-1)
    if len(D) not in (4, 5):
        raise NotImplementedError(
            f"distortion with {len(D)} coefficients: only k1 k2 p1 p2 [k3] is covered")
    k1, k2, p1, p2 = D[:4]
    k3 = D[4] if len(D) == 5 else 0.0
    iR = np.linalg.inv(np.asarray(P, np.float64).reshape(3, 3)
                       @ np.asarray(R, np.float64).reshape(3, 3))
    w, h = size
    j = np.arange(w, dtype=np.float64)[None, :]
    i = np.arange(h, dtype=np.float64)[:, None]
    xs = j * iR[0, 0] + i * iR[0, 1] + iR[0, 2]
    ys = j * iR[1, 0] + i * iR[1, 1] + iR[1, 2]
    ws = j * iR[2, 0] + i * iR[2, 1] + iR[2, 2]
    x, y = xs / ws, ys / ws
    x2, y2 = x * x, y * y
    r2, xy2 = x2 + y2, 2.0 * x * y
    kr = 1.0 + ((k3 * r2 + k2) * r2 + k1) * r2
    u = K[0, 0] * (x * kr + p1 * xy2 + p2 * (r2 + 2.0 * x2)) + K[0, 2]
    v = K[1, 1] * (y * kr + p1 * (r2 + 2.0 * y2) + p2 * xy2) + K[1, 2]
    return u.astype(np.float32), v.astype(np.float32)


def rectify_maps(cfg_yaml: dict, size: tuple[int, int] | None = None):
    """Stereo rectification maps from the reference's YAML calibration
    (stereo_groundtruth.cc:56-94).  Accepts the reference's ``LEFT.K/D/R/P``
    and ``RIGHT.*`` opencv-matrix keys (as ``config.load_raw_yaml`` parses
    them) or flat ``Camera.K_l``-style lists; returns {"l": (map_x, map_y),
    "r": ...} for :func:`remap_linear`, or None when the file carries no
    stereo calibration (a pre-rectified sequence)."""

    def mat(key_ref, key_flat, rows, cols):
        v = cfg_yaml.get(key_ref, cfg_yaml.get(key_flat))
        if v is None:
            return None
        return np.asarray(v, np.float64).reshape(rows, cols)

    maps = {}
    for ref_side, side in (("LEFT", "l"), ("RIGHT", "r")):
        K = mat(f"{ref_side}.K", f"Camera.K_{side}", 3, 3)
        R = mat(f"{ref_side}.R", f"Camera.R_{side}", 3, 3)
        P = mat(f"{ref_side}.P", f"Camera.P_{side}", 3, 4)
        if K is None or R is None or P is None:
            return None
        D = cfg_yaml.get(f"{ref_side}.D", cfg_yaml.get(f"Camera.D_{side}", [0, 0, 0, 0]))
        hw = size
        if hw is None:
            hw = (int(cfg_yaml.get(f"{ref_side}.width", 0)),
                  int(cfg_yaml.get(f"{ref_side}.height", 0)))
            if not all(hw):
                raise ValueError("rectify_maps needs size= or LEFT/RIGHT.width/height")
        maps[side] = undistort_rectify_map(K, D, R, P[:3, :3], hw)
    return maps


def remap_table(map_x: np.ndarray, map_y: np.ndarray, src_shape: tuple[int, int]):
    """What :func:`remap_linear` gathers for a source image of ``src_shape``:
    per output pixel the flat source index of its four taps (the index
    ``h * w``, one past the image, for a tap outside it) and their float32
    weights, each (4, N).  A reader applies one table to every frame."""
    h, w = src_shape
    qx = np.rint(np.asarray(map_x, np.float32) * np.float32(INTER_TAB_SIZE)).astype(np.int64)
    qy = np.rint(np.asarray(map_y, np.float32) * np.float32(INTER_TAB_SIZE)).astype(np.int64)
    x0, y0 = (qx >> 5).ravel(), (qy >> 5).ravel()
    step = np.float32(1.0 / INTER_TAB_SIZE)
    fx = (qx & (INTER_TAB_SIZE - 1)).astype(np.float32).ravel() * step
    fy = (qy & (INTER_TAB_SIZE - 1)).astype(np.float32).ravel() * step
    one = np.float32(1.0)
    idx, wts = [], []
    for dy, dx, wt in ((0, 0, (one - fy) * (one - fx)), (0, 1, (one - fy) * fx),
                       (1, 0, fy * (one - fx)), (1, 1, fy * fx)):
        yy, xx = y0 + dy, x0 + dx
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx.append(np.where(inside, yy * w + xx, h * w))
        wts.append(wt)
    return np.stack(idx), np.stack(wts)


def remap_apply(src: np.ndarray, table, shape: tuple[int, int]) -> np.ndarray:
    """Sample ``src`` through a :func:`remap_table` into an image of
    ``shape``, summing the taps in OpenCV's order, in float32."""
    idx, wts = table
    flat = np.append(np.asarray(src, np.float32).ravel(), np.float32(0.0))
    v = flat[idx]
    out = v[0] * wts[0]
    for k in (1, 2, 3):
        out = out + v[k] * wts[k]
    return out.reshape(shape)


def remap_linear(src: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """``cv2.remap(src, map_x, map_y, cv2.INTER_LINEAR)`` of a float32
    image with float32 maps, as OpenCV up to 4.10 computes it (and the JAX
    package's native reader, on the system's OpenCV): each map coordinate is
    rounded to 1/32 px, the four weights are float32 products of the
    quantized fractions, and a sample outside the image counts as 0
    (``BORDER_CONSTANT``).  OpenCV 4.11 and later sample at the unrounded
    coordinate instead; the two agree where the maps are multiples of
    1/32."""
    src = np.asarray(src, np.float32)
    return remap_apply(src, remap_table(map_x, map_y, src.shape), np.shape(map_x))


def _linear_taps(n_out: int, n_in: int):
    """Source index and weight of each output position of a bilinear
    resize with half-pixel centres (cv2.resize's INTER_LINEAR): the
    position is computed in float64 and rounded to float32, clamped to the
    first and last sample at the borders."""
    scale = n_in / n_out
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    frac = f - i0.astype(np.float32)
    low = i0 < 0
    high = i0 >= n_in - 1
    i0 = np.where(low, 0, np.where(high, n_in - 1, i0))
    frac = np.where(low | high, np.float32(0.0), frac).astype(np.float32)
    return i0, np.minimum(i0 + 1, n_in - 1), frac


def resize_linear(src: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(src, (width, height))`` of a float32 image: bilinear
    with half-pixel centres, rows first, then columns."""
    src = np.asarray(src, np.float32)
    h, w = src.shape
    one = np.float32(1.0)
    x0, x1, fx = _linear_taps(width, w)
    rows = src[:, x0] * (one - fx) + src[:, x1] * fx
    y0, y1, fy = _linear_taps(height, h)
    return rows[y0] * (one - fy)[:, None] + rows[y1] * fy[:, None]


def load_video(path_or_index) -> Iterator[tuple[np.ndarray, float]]:
    """Yield (float32 grey frame, timestamp) from a video file or camera
    index (simple_camera.cc), through OpenCV's ``VideoCapture``."""
    cv2 = _cv2("reading video")
    cap = cv2.VideoCapture(path_or_index)
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        yield cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY).astype(np.float32), i / fps
        i += 1
    cap.release()


def load_ct_sequence(video_path: str, depth_dir: str, pattern: str = "heartDepthMap_{}.txt"
                     ) -> Iterator[tuple[np.ndarray, np.ndarray, float]]:
    """Yield (frame, depth map, timestamp): a video and per-frame depth text
    files (simple_CT.cc ``loadCT`` 97-115: whitespace-separated depths); a
    frame without its depth file is skipped."""
    for i, (gray, t) in enumerate(load_video(video_path)):
        dp = os.path.join(depth_dir, pattern.format(i))
        if not os.path.exists(dp):
            continue
        depth = np.loadtxt(dp, dtype=np.float32)
        if depth.ndim == 1:
            depth = depth.reshape(gray.shape)
        yield gray, depth, t
