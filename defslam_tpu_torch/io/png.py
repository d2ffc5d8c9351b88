"""A lossless PNG codec on ``zlib`` and numpy: the port's stand-in for
OpenCV's PNG reader and writer (the card's host need not have OpenCV).

- :func:`read_png` decodes 8-bit non-interlaced PNGs of every colour type
  (grey, grey+alpha, RGB, RGBA, palette) to an 8-bit grey image, as
  ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` gives it: the alpha channel
  is dropped, a palette is expanded, and colour goes to grey with libpng's
  fixed-point weights, ``(9797 R + 19234 G + 3737 B) >> 15`` (truncated;
  OpenCV's decoder asks libpng for ``png_set_rgb_to_gray(.., 0.299,
  0.587)``, which libpng rounds to these integers).  Other formats
  (16-bit, bit depths under 8, Adam7 interlacing) raise
  ``NotImplementedError`` naming the format.
- :func:`write_png` writes an 8-bit grey image, every row with one filter
  type (None by default).

The reader runs on the threads of ``io.prefetch.FramePipeline`` beside the
tracking thread, which needs the GIL to launch its work.  ``zlib`` inflates
with the GIL released, and no step loops over pixels in Python: None, Sub
and Up rows are undone with a few whole-image numpy operations, and an
image with Average or Paeth rows (whose every byte depends on its left
neighbour) along the image's anti-diagonals, one numpy step per diagonal
(W + H - 1 steps), on a skewed copy of the image in which each diagonal is
one contiguous row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels per pixel of each colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_KIND = {0: "grey", 2: "RGB", 3: "palette", 4: "grey+alpha", 6: "RGBA"}
# libpng's png_set_rgb_to_gray(png_ptr, 1, 0.299, 0.587) in 1/32768 units
_GREY_WEIGHTS = (9797, 19234, 3737)


def _chunks(data: bytes):
    """(type, payload) of each chunk, checking lengths and CRCs."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if len(payload) != length:
            raise ValueError("truncated PNG chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("truncated PNG (no IEND chunk)")


def _unfilter(raw: np.ndarray, height: int, width: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of the inflated image data (``raw``: one
    filter-type byte, then ``width * bpp`` bytes, per row).  Returns
    (height, width, bpp) uint8."""
    rows = raw.reshape(height, 1 + width * bpp)
    ftype = rows[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"PNG: unknown row filter type {int(ftype.max())}")
    f = rows[:, 1:].reshape(height, width, bpp)
    if not ftype.any():
        return f
    if np.isin(ftype, (3, 4)).any():
        return _unfilter_diagonal(f, ftype)
    # None, Sub and Up only (cv2.imwrite writes Sub on every row): a few
    # whole-image steps, modulo 256 in uint8.  A Sub row is a running sum
    # along itself.
    out = f.copy()
    sub = ftype == 1
    out[sub] = np.cumsum(f[sub], axis=1, dtype=np.uint8)
    up = ftype == 2
    if up.any():
        # An Up row adds the row above, so a run of Up rows is a running sum
        # down the rows that starts at the decoded row s before the run
        # (none before row 0): out[y] = csum[y] - csum[s - 1].
        csum = np.cumsum(out, axis=0, dtype=np.uint8)
        before = np.concatenate([np.zeros_like(csum[:1]), csum[:-1]])  # csum[s - 1], 0 at s = 0
        s = np.maximum.accumulate(np.where(up, 0, np.arange(height)))
        out[up] = csum[up] - before[s[up]]
    return out


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor of int16 arrays: of a (left), b (up) and c
    (up-left), the one closest to a + b - c, ties in that order."""
    dab, dac = b - c, a - c  # p - a, p - b
    pa, pb, pc = np.abs(dab), np.abs(dac), np.abs(dab + dac)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_diagonal(f: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Undo any mix of the five filters along anti-diagonals.

    The byte at (y, x) depends on its left (y, x-1), up (y-1, x) and
    up-left (y-1, x-1) neighbours only, so all of the diagonal x + y = t
    follows from diagonals t-1 and t-2.  In the skewed copy ``s[t + 1, y +
    1] = image[y, t - y]`` (row 0 and column 0 are zero padding) diagonal
    t is row t + 1, and its left, up and up-left neighbours are the rows
    before it, shifted by one column or not.  Cells left of the image
    (x < 0) stay zero, as the filters' definition wants, since their filter
    bytes are zero and every predictor of zeros is zero; cells right of it
    (x >= width) fill with values that no cell of the image reads."""
    h, w, bpp = f.shape
    n = w + h - 1
    ys = np.arange(h)
    # the filter bytes, skewed: fs[t, y] = f[y, t - y] where 0 <= t - y < w
    fs = np.zeros((n, h, bpp), np.int16)
    t_of = ys[:, None] + np.arange(w)[None, :]
    fs[t_of, ys[:, None]] = f
    s = np.zeros((n + 1, h + 1, bpp), np.int16)
    kinds = set(np.unique(ftype).tolist())
    # one filter in every row (the usual case): no per-row selection
    only = kinds.pop() if len(kinds) == 1 else None
    m = [(ftype == k).astype(np.int16)[:, None] for k in range(5)]
    for t in range(n):
        a = s[t, 1:]  # left: diagonal t - 1, same row
        b = s[t, :-1]  # up: diagonal t - 1, row above
        c = s[t - 1, :-1]  # up-left: diagonal t - 2 (row n, still zero, at t = 0)
        if only == 4:
            pred = _paeth(a, b, c)
        elif only == 3:
            pred = (a + b) >> 1
        else:
            pred = a * m[1] + b * m[2] + ((a + b) >> 1) * m[3] + _paeth(a, b, c) * m[4]
        s[t + 1, 1:] = (fs[t] + pred) & 0xFF
    return s[t_of + 1, ys[:, None] + 1].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """The PNG at ``path`` as an (H, W) uint8 grey image, as
    ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` decodes it.  Raises
    ``FileNotFoundError`` for a missing file, ``ValueError`` for a corrupt
    one, ``NotImplementedError`` for a format it does not cover."""
    with open(path, "rb") as fh:
        data = fh.read()
    header = palette = None
    idat = []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if colour not in _CHANNELS:
        raise ValueError(f"PNG: unknown colour type {colour}")
    if depth != 8:
        raise NotImplementedError(
            f"{depth}-bit {_KIND[colour]} PNG: only 8-bit PNGs are decoded ({path})")
    if interlace:
        raise NotImplementedError(f"Adam7-interlaced PNG: not decoded ({path})")
    bpp = _CHANNELS[colour]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG: corrupt image data ({e})") from None
    if len(raw) < height * (1 + width * bpp):
        raise ValueError("PNG: truncated image data")
    raw = np.frombuffer(raw, np.uint8)[:height * (1 + width * bpp)]
    px = _unfilter(raw, height, width, bpp)
    if colour == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        px = palette[px[..., 0]]
    elif colour in (0, 4):
        return np.ascontiguousarray(px[..., 0])
    rgb = px[..., :3].astype(np.uint32)
    wr, wg, wb = _GREY_WEIGHTS
    return ((wr * rgb[..., 0] + wg * rgb[..., 1] + wb * rgb[..., 2]) >> 15).astype(np.uint8)


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def _filter_rows(img: np.ndarray, ftype: int) -> np.ndarray:
    """The filtered bytes of a grey image (one byte per pixel), every row
    with filter ``ftype``."""
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    if ftype == 0:
        pred = np.zeros_like(x)
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = b
    elif ftype == 3:
        pred = (a + b) >> 1
    else:
        pred = _paeth(a, b, c)
    return ((x - pred) & 0xFF).astype(np.uint8)


def write_png(path: str, img: np.ndarray, filter_type: int = 0) -> None:
    """Write an (H, W) uint8 grey image as a PNG, every row with filter
    ``filter_type`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"write_png takes an (H, W) uint8 image, not {img.dtype} {img.shape}")
    if filter_type not in range(5):
        raise ValueError(f"PNG filter type {filter_type} is not one of 0-4")
    h, w = img.shape
    rows = np.empty((h, w + 1), np.uint8)
    rows[:, 0] = filter_type
    rows[:, 1:] = _filter_rows(img, filter_type)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(SIGNATURE + _chunk(b"IHDR", ihdr)
                 + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                 + _chunk(b"IEND", b""))
