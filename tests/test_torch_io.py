"""The port's input path (``io/png.py``, ``io/datasets.py``,
``io/prefetch.py``, ``tools/make_synth_dataset.py``) against OpenCV and
against the JAX package, on the CPU.

Tolerances and why:

- ``read_png`` equals ``cv2.imread(path, IMREAD_GRAYSCALE)`` bit for bit,
  for every colour type and row filter (integer decoding; colour to grey
  with libpng's integer weights).
- ``undistort_rectify_map`` / ``rectify_maps`` within 1e-3 px of
  ``cv2.initUndistortRectifyMap`` (both in float64, rounded to float32).
- ``remap_linear`` within 1e-3 grey levels of ``cv2.remap`` where the maps
  are multiples of 1/32 px.  Elsewhere the two differ by design: the port
  rounds each map coordinate to 1/32 px as OpenCV up to 4.10 does (and the
  JAX package's native reader, on the system's OpenCV), while the OpenCV of
  the Python module here (5.x) samples at the unrounded coordinate; against
  the JAX package's reader the port holds 1e-3 at any map.
- ``resize_linear`` within 1e-3 grey levels of ``cv2.resize`` with OpenCV's
  IPP route off (IPP computes the taps in another way, 1.7e-3 apart on
  255-level data), and of the JAX package's native reader.
- The synthetic datasets of the two packages: the two renders agree to
  float rounding (``io/synthetic.py``), not bit for bit, so after the
  truncation to 8 bits a pixel may differ by 1 where the two renders
  straddle an integer.  The test holds every decoded pixel to the
  truncation of its own package's render, and every differing pixel to a
  render gap across an integer (renders within 1e-3 of each other).
"""

import os
import struct
import sys
import threading
import time
import zlib

import cv2
import numpy as np
import pytest
import yaml

from defslam_tpu import native
from defslam_tpu.io import datasets as jdatasets
from defslam_tpu.io.synthetic import make_sequence as jax_make_sequence
from defslam_tpu.tools import make_synth_dataset as jmake
from defslam_tpu_torch.config import load_raw_yaml
from defslam_tpu_torch.io import datasets, png, prefetch
from defslam_tpu_torch.io.synthetic import make_sequence
from defslam_tpu_torch.tools import make_synth_dataset as tmake

COLOURS = {"grey": (0, 1), "RGB": (2, 3), "grey+alpha": (4, 2), "RGBA": (6, 4), "palette": (3, 1)}
FILTERS = {"none": [0], "sub": [1], "up": [2], "average": [3], "paeth": [4],
           "mixed": [0, 1, 2, 3, 4, 4, 3, 1], "none_sub_up": [2, 2, 1, 2, 0, 2, 2, 1, 1, 0]}


def _encode(path, px, colour, filters, palette=None, depth=8, interlace=0):
    """A PNG of (H, W, C) bytes, row y with filter ``filters[y % len]``,
    the image data split over two IDAT chunks."""
    h, w, _ = px.shape
    x = px.astype(np.int16)
    rows = []
    for y in range(h):
        ft = filters[y % len(filters)]
        a = np.zeros_like(x[y])
        a[1:] = x[y, :-1]
        b = x[y - 1] if y else np.zeros_like(x[y])
        c = np.zeros_like(x[y])
        if y:
            c[1:] = x[y - 1, :-1]
        pred = [np.zeros_like(a), a, b, (a + b) >> 1, png._paeth(a, b, c)][ft]
        rows.append(bytes([ft]) + ((x[y] - pred) & 0xFF).astype(np.uint8).tobytes())
    data = zlib.compress(b"".join(rows))
    out = png.SIGNATURE + png._chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace))
    if palette is not None:
        out += png._chunk(b"PLTE", palette.tobytes())
    out += png._chunk(b"IDAT", data[:len(data) // 2]) + png._chunk(b"IDAT", data[len(data) // 2:])
    with open(path, "wb") as f:
        f.write(out + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", FILTERS.values(), ids=FILTERS.keys())
@pytest.mark.parametrize("kind", COLOURS.keys())
def test_read_png_equals_cv2(tmp_path, kind, filters):
    colour, ch = COLOURS[kind]
    rng = np.random.default_rng(len(kind) * 10 + len(filters))
    palette = None
    if colour == 3:
        palette = rng.integers(0, 256, (200, 3), np.uint8)
        px = rng.integers(0, 200, (37, 53, 1), np.uint8)
    else:
        # a smooth ramp with noise, so the predictors matter
        yy, xx = np.mgrid[0:37, 0:53]
        base = (3 * xx + 2 * yy)[..., None] + np.arange(ch) * 40
        px = ((base + rng.integers(0, 30, (37, 53, ch))) % 256).astype(np.uint8)
    path = str(tmp_path / "img.png")
    _encode(path, px, colour, filters, palette)
    got = png.read_png(path)
    assert got.dtype == np.uint8 and got.shape == (37, 53)
    np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("filter_type", range(5))
def test_write_png_round_trip_through_cv2(tmp_path, filter_type):
    rng = np.random.default_rng(filter_type)
    img = rng.integers(0, 256, (41, 67), np.uint8)
    path = str(tmp_path / "w.png")
    png.write_png(path, img, filter_type=filter_type)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(png.read_png(path), img)


@pytest.mark.parametrize("depth,interlace,what", [(16, 0, "16-bit"), (8, 1, "interlaced")])
def test_read_png_names_formats_it_does_not_decode(tmp_path, depth, interlace, what):
    path = str(tmp_path / "x.png")
    _encode(path, np.zeros((4, 4, 1), np.uint8), 0, [0], depth=depth, interlace=interlace)
    with pytest.raises(NotImplementedError, match=what):
        png.read_png(path)


def test_read_png_rejects_corrupt_files(tmp_path):
    path = tmp_path / "c.png"
    png.write_png(str(path), np.zeros((8, 8), np.uint8))
    data = bytearray(path.read_bytes())
    data[40] ^= 0xFF  # inside the IDAT payload: the CRC no longer holds
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError):
        png.read_png(str(path))
    with pytest.raises(FileNotFoundError):
        png.read_png(str(tmp_path / "missing.png"))


# ------------------------------------------------------------------ geometry


def _calibration(size=(160, 120)):
    """A stereo calibration of two slightly rotated cameras with lens
    distortion, in the reference's LEFT./RIGHT. opencv-matrix keys."""
    K = np.array([[210.0, 0, 81.5], [0, 212.0, 59.0], [0, 0, 1]])
    sides = {}
    for side, ang, D in (("LEFT", 0.02, [0.08, -0.04, 0.001, -0.002, 0.01]),
                         ("RIGHT", -0.015, [-0.05, 0.02, -0.001, 0.0015])):
        c, s = np.cos(ang), np.sin(ang)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        P = np.array([[200.0, 0, 80.0, 0], [0, 200.0, 60.0, 0], [0, 0, 1, 0]])
        sides[side] = dict(K=K, D=np.array(D), R=R, P=P)
    return sides, size


def _matrix(m):
    m = np.atleast_2d(m)
    data = ", ".join(repr(float(v)) for v in m.ravel())
    return (f"!!opencv-matrix\n   rows: {m.shape[0]}\n   cols: {m.shape[1]}\n"
            f"   dt: d\n   data: [ {data} ]\n")


def test_rectify_maps_equal_opencv(tmp_path):
    sides, size = _calibration()
    text = "%YAML:1.0\n"
    for side, mats in sides.items():
        for name, m in mats.items():
            text += f"{side}.{name}: {_matrix(m)}"
    path = tmp_path / "calib.yaml"
    path.write_text(text)
    maps = datasets.rectify_maps(load_raw_yaml(str(path)), size)
    for side, key in (("LEFT", "l"), ("RIGHT", "r")):
        m = sides[side]
        rx, ry = cv2.initUndistortRectifyMap(m["K"], m["D"], m["R"], m["P"][:3, :3], size,
                                             cv2.CV_32FC1)
        assert maps[key][0].dtype == np.float32 and maps[key][0].shape == (120, 160)
        assert np.abs(maps[key][0] - rx).max() <= 1e-3
        assert np.abs(maps[key][1] - ry).max() <= 1e-3
    # the flat Camera.K_l-style keys give the same maps
    flat = {f"Camera.{n}_{k}": sides[s][n].ravel().tolist()
            for s, k in (("LEFT", "l"), ("RIGHT", "r")) for n in ("K", "D", "R", "P")}
    maps_flat = datasets.rectify_maps(flat, size)
    for key in "lr":
        np.testing.assert_array_equal(maps_flat[key][0], maps[key][0])
    # no stereo calibration: a pre-rectified sequence
    assert datasets.rectify_maps({"Camera.fx": 500.0}, size) is None


def test_remap_equals_opencv_on_maps_at_its_resolution():
    rng = np.random.default_rng(3)
    src = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    mx = rng.uniform(-3, 163, (120, 160)).astype(np.float32)
    my = rng.uniform(-3, 123, (120, 160)).astype(np.float32)
    qx, qy = (np.rint(m * 32) / 32 for m in (mx, my))
    want = cv2.remap(src, qx.astype(np.float32), qy.astype(np.float32), cv2.INTER_LINEAR)
    got = datasets.remap_linear(src, mx, my)
    assert np.abs(got - want).max() <= 1e-3
    assert (got[(mx < -1) | (mx > 160) | (my < -1) | (my > 120)] == 0).all()  # border 0


@pytest.mark.parametrize("size", [(80, 60), (100, 77), (161, 121), (320, 240)])
def test_resize_equals_opencv(size):
    rng = np.random.default_rng(4)
    src = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    use_ipp = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        want = cv2.resize(src, size)
    finally:
        cv2.ipp.setUseIPP(use_ipp)
    assert np.abs(datasets.resize_linear(src, *size) - want).max() <= 1e-3


# ------------------------------------------------------------------ datasets


@pytest.fixture(scope="module")
def stereo_dir(tmp_path_factory):
    """The port's synthetic dataset of 10 frames at 160x120, one right image
    removed."""
    d = tmp_path_factory.mktemp("seq")
    tmake.main([str(d), "--frames", "10", "--width", "160", "--height", "120"])
    os.remove(sorted(d.glob("stereo_im_r_*.png"))[3])
    return d


@pytest.mark.parametrize("start", [0, 2])
def test_stereo_pair_paths_equal_reference(stereo_dir, start):
    got = datasets.stereo_pair_paths(str(stereo_dir), start=start)
    assert got == jdatasets.stereo_pair_paths(str(stereo_dir), start=start)
    assert len(got[0]) == 10 - start - 1
    assert got[2] == sorted(got[2])
    assert [datasets._timestamp_of(p) for p in got[0]] == got[2]
    left, right, t = next(datasets.load_stereo_sequence(str(stereo_dir), start=start))
    assert left.dtype == np.float32 and t == got[2][0]
    np.testing.assert_array_equal(left, cv2.imread(got[0][0], cv2.IMREAD_GRAYSCALE))


def _frames(pipe):
    try:
        return list(pipe)
    finally:
        pipe.close()


@pytest.mark.parametrize("case", ["plain", "rectified", "resized"])
def test_frame_pipeline_equals_reference_reader(stereo_dir, case):
    assert native.available()
    lp, _, _ = datasets.stereo_pair_paths(str(stereo_dir))
    size = (160, 120) if case != "resized" else (100, 77)
    maps = None
    if case == "rectified":
        sides, _ = _calibration()
        m = sides["LEFT"]
        maps = datasets.undistort_rectify_map(m["K"], m["D"], m["R"], m["P"][:3, :3], size)
    got = _frames(prefetch.FramePipeline(lp, *size, rectify_maps=maps))
    jp = native.FramePipeline(lp, *size, rectify_maps=maps)
    want = [(i, f) for i, f in jp]
    jp.close()
    assert [i for i, _ in got] == [i for i, _ in want] == list(range(len(lp)))
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == np.float32 and a.shape == (size[1], size[0])
        assert np.abs(a - b).max() <= (0.0 if case == "plain" else 1e-3)


@pytest.mark.parametrize("n_threads", [3, 12])
def test_frame_pipeline_keeps_order_under_jitter(stereo_dir, monkeypatch, n_threads):
    """Random decode times, a small buffer, and (with 12 threads, more than
    the cores) a switch interval of 1 us: every frame comes out once, in
    order, with its own pixels."""
    lp, _, _ = datasets.stereo_pair_paths(str(stereo_dir))
    lp = lp * 3
    real = datasets._imread_gray
    delays = iter(np.random.default_rng(5).uniform(0.0, 0.02, len(lp)))
    lock = threading.Lock()

    def jittered(path):
        with lock:
            delay = next(delays)
        time.sleep(delay)
        return real(path)

    monkeypatch.setattr(datasets, "_imread_gray", jittered)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pipe = prefetch.FramePipeline(lp, 160, 120, n_threads=n_threads, capacity=4)
        got = _frames(pipe)
    finally:
        sys.setswitchinterval(interval)
    assert [i for i, _ in got] == list(range(len(lp)))
    for i, f in got:
        np.testing.assert_array_equal(f, real(lp[i]))
    assert sorted(x["index"] for x in pipe.stats) == list(range(len(lp)))
    assert len(pipe.wait_s) == len(lp)
    assert not any(t.is_alive() for t in pipe._workers)


def test_frame_pipeline_zero_frame_and_close(stereo_dir, monkeypatch):
    lp, _, _ = datasets.stereo_pair_paths(str(stereo_dir))
    paths = lp[:2] + [str(stereo_dir / "missing.png")] + lp[2:4]
    got = _frames(prefetch.FramePipeline(paths, 160, 120))
    assert [i for i, _ in got] == list(range(5))
    assert not got[2][1].any() and got[3][1].any()

    # close() in the middle of an iteration: the workers are blocked on a
    # full buffer (capacity 2) and a slow decode; close returns promptly
    real = datasets._imread_gray
    monkeypatch.setattr(datasets, "_imread_gray", lambda p: (time.sleep(0.05), real(p))[1])
    pipe = prefetch.FramePipeline(lp * 5, 160, 120, n_threads=3, capacity=2)
    it = iter(pipe)
    next(it)
    t0 = time.perf_counter()
    pipe.close()
    assert time.perf_counter() - t0 < 2.0
    assert list(it) == []
    assert not any(t.is_alive() for t in pipe._workers)


def test_frame_pipeline_raises_other_errors(stereo_dir, monkeypatch):
    lp, _, _ = datasets.stereo_pair_paths(str(stereo_dir))

    def fails(path):
        raise NotImplementedError("16-bit grey PNG")

    monkeypatch.setattr(datasets, "_imread_gray", fails)
    with pytest.raises(NotImplementedError):
        _frames(prefetch.FramePipeline(lp, 160, 120))


def test_imread_without_opencv_names_it(tmp_path, monkeypatch):
    png.write_png(str(tmp_path / "a.png"), np.full((4, 5), 7, np.uint8))
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now fails
    assert datasets._imread_gray(str(tmp_path / "a.png")).max() == 7.0  # PNG: no cv2
    with pytest.raises(ImportError, match="OpenCV"):
        datasets._imread_gray(str(tmp_path / "a.jpg"))
    with pytest.raises(ImportError, match="OpenCV"):
        next(datasets.load_video(str(tmp_path / "v.avi")))


# ------------------------------------------------------- make_synth_dataset


def test_make_synth_dataset_matches_reference(tmp_path):
    args = ["--frames", "4", "--width", "160", "--height", "120", "--baseline", "0.05"]
    tmake.main([str(tmp_path / "port")] + args)
    jmake.main([str(tmp_path / "jax")] + args)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 10
    kw = dict(n_frames=4, height=120, width=160, max_amp=0.06, baseline=0.05)
    renders = {"port": make_sequence(**kw), "jax": jax_make_sequence(**kw)}
    decoded = {}
    for pkg, seq in renders.items():
        for t, usec in enumerate(int(round(t / 7.0 * 1e6)) for t in range(4)):
            for side, img in (("l", seq.frames[t]), ("r", seq.frames_right[t])):
                px = png.read_png(str(tmp_path / pkg / f"stereo_im_{side}_{usec}.png"))
                np.testing.assert_array_equal(px, np.clip(img, 0, 255).astype(np.uint8))
                decoded[pkg, side, t] = (px, img)
    n_diff = 0
    for (pkg, side, t), (px, img) in decoded.items():
        if pkg != "port":
            continue
        jpx, jimg = decoded["jax", side, t]
        diff = px != jpx
        n_diff += int(diff.sum())
        assert np.abs(img - jimg).max() <= 1e-3
        assert (np.abs(px.astype(int) - jpx)[diff] == 1).all()
        # a differing pixel: the two renders lie on both sides of an integer
        lo, hi = np.minimum(img, jimg)[diff], np.maximum(img, jimg)[diff]
        assert (np.floor(lo) < np.floor(hi)).all()
    assert n_diff <= 0.0005 * 8 * 120 * 160
    cfg = {pkg: yaml.safe_load((tmp_path / pkg / "settings.yaml").read_text().replace(
        str(tmp_path / pkg), "DIR")) for pkg in ("port", "jax")}
    assert cfg["port"] == cfg["jax"] and cfg["port"]["File.outputdir"] == "DIR/out"
    assert ((tmp_path / "port" / "baseline.txt").read_text()
            == (tmp_path / "jax" / "baseline.txt").read_text())
