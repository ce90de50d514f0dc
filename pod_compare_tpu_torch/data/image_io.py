"""Image files and resizing without OpenCV.

The JAX package reads images with ``cv2.imread(IMREAD_COLOR)``, writes them
with ``cv2.imwrite`` and resizes them with ``cv2.resize(INTER_LINEAR)``
(``pod_compare_tpu/data/loader.py``, ``data/synthetic.py``). Neither the
port nor the card's machine has OpenCV, so this module does the three:

* ``imread_bgr``: PNG, 8-bit gray, RGB or RGBA, not interlaced,
  returned as (H, W, 3) uint8 BGR with the alpha dropped, as IMREAD_COLOR
  returns it. The IDAT stream is inflated with the standard library's
  zlib, and the scanline filters are undone by the port's C++ library
  (``native/png_unfilter.cpp``); ``unfilter_plain`` is the numpy version
  the tests hold it against. JPEG (BDD100k's format), 16-bit, palette,
  gray+alpha and interlaced PNGs raise NotImplementedError.
* ``write_png``: RGB or gray PNG, every row with filter 0.
* ``resize_bilinear``: cv2's INTER_LINEAR on uint8, from its half-pixel
  mapping, its 11-bit fixed-point coefficients and its rounding.
"""

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
# colour type -> samples per pixel (palette, 3, and gray+alpha, 4, are not read)
_CHANNELS = {0: 1, 2: 3, 6: 4}

# cv2's fixed point for INTER_LINEAR on 8-bit images (imgproc/resize.cpp).
RESIZE_COEF_BITS = 11
RESIZE_COEF_SCALE = 1 << RESIZE_COEF_BITS


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG ends before its IEND chunk")


def decode_png(data: bytes, unfilter=None) -> np.ndarray:
    """(H, W, C) uint8 samples in the file's order (gray, RGB or RGBA). `unfilter(raw, height, row_bytes, bpp)` undoes the filters; the
    default is the C++ one of the port's native library."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    width, height, depth, color, _compression, _filter, interlace = header
    if depth != 8:
        raise NotImplementedError(f"{depth}-bit PNG samples are not read, only 8-bit")
    if color not in _CHANNELS:
        raise NotImplementedError(f"PNG colour type {color} is not read")
    if interlace != 0:
        raise NotImplementedError("interlaced (Adam7) PNG is not read")
    channels = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if unfilter is None:
        from pod_compare_tpu_torch import native

        unfilter = native.png_unfilter
    rows = unfilter(raw, height, width * channels, channels)
    return rows.reshape(height, width, channels)


def unfilter_plain(raw: np.ndarray, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """The numpy version of ``native.png_unfilter``: each row at once for
    None and Up, one pixel column at a time (over its bytes) for Sub,
    Average and Paeth, whose prediction needs the pixel to the left."""
    raw = np.asarray(raw, np.uint8).reshape(height, row_bytes + 1)
    out = np.zeros((height, row_bytes), np.uint8)
    zero = np.zeros(row_bytes, np.int32)
    for y in range(height):
        kind, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        prev = out[y - 1].astype(np.int32) if y > 0 else zero
        cur = np.zeros(row_bytes, np.int32)
        if kind in (0, 2):
            cur = line + (prev if kind == 2 else 0)
        elif kind in (1, 3, 4):
            for i in range(0, row_bytes, bpp):
                px = slice(i, i + bpp)
                a = cur[i - bpp:i] if i >= bpp else zero[:bpp]
                b = prev[px]
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[i - bpp:i] if i >= bpp else zero[:bpp]
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
                cur[px] = (line[px] + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG filter type in row {y}")
        out[y] = cur & 0xFF
    return out


def to_bgr(samples: np.ndarray) -> np.ndarray:
    """IMREAD_COLOR's conversion: gray replicated, alpha dropped, RGB to BGR."""
    if samples.shape[-1] == 1:
        return np.repeat(samples, 3, axis=-1)
    return np.ascontiguousarray(samples[..., 2::-1])


def imread_bgr(path: str, unfilter=None) -> np.ndarray:
    """(H, W, 3) uint8 BGR pixels of the image file at `path`."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(JPEG_SIGNATURE):
        raise NotImplementedError(
            f"{path}: JPEG decoding is not ported yet (ROADMAP §3: nvJPEG through "
            "ctypes is the candidate); only PNG is read"
        )
    return to_bgr(decode_png(data, unfilter))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def encode_png(image_bgr: np.ndarray) -> bytes:
    """PNG bytes of an (H, W, 3) BGR or (H, W) gray uint8 image."""
    img = np.asarray(image_bgr)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG writer takes uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 3:
        samples, color = img[..., ::-1], 2
    elif img.ndim == 2:
        samples, color = img[..., None], 0
    else:
        raise ValueError(f"PNG writer takes (H, W, 3) or (H, W), got {img.shape}")
    h, w, c = samples.shape
    rows = np.zeros((h, 1 + w * c), np.uint8)  # filter byte 0 on every row
    rows[:, 1:] = samples.reshape(h, w * c)
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes())) + _chunk(b"IEND", b""))


def write_png(path: str, image_bgr: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image_bgr))


def _linear_taps(src: int, dst: int, clamp: bool):
    """cv2's source index and fixed-point weight pair of each destination
    index: f = float32((d + 0.5)·src/dst − 0.5), s = floor(f), weights
    round((1 − f + s)·2048) and round((f − s)·2048), half to even. Along x
    cv2 clamps s (and zeroes the fraction) at the borders; along y it keeps
    the weights and clamps only the rows read."""
    scale = 1.0 / (dst / src)  # cv2 inverts its dst/src ratio in double
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    frac = (f - s.astype(np.float32)).astype(np.float32)
    if clamp:
        low, high = s < 0, s >= src - 1
        frac = np.where(low | high, np.float32(0), frac)
        s = np.where(low, 0, np.where(high, src - 1, s))
    w0 = np.rint((np.float32(1) - frac) * np.float32(RESIZE_COEF_SCALE)).astype(np.int64)
    w1 = np.rint(frac * np.float32(RESIZE_COEF_SCALE)).astype(np.int64)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def resize_bilinear(image: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(image, (w, h), interpolation=cv2.INTER_LINEAR)`` for an
    (H, W, C) or (H, W) uint8 image; `size` is (w, h) as cv2 takes it.

    Rows are interpolated first into int32 sums of pixel x 2048 weights,
    then columns: ((b0·(r0 >> 4)) >> 16) + ((b1·(r1 >> 4)) >> 16), plus 2,
    shifted right by 2. An exact halving in both directions is the 2x2 mean
    rounded half up, as cv2 then takes its area path."""
    out_w, out_h = int(size[0]), int(size[1])
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"resize takes uint8, got {img.dtype}")
    h, w = img.shape[:2]
    if (out_h, out_w) == (h, w):
        return img.copy()
    if 2 * out_h == h and 2 * out_w == w:
        quads = img.astype(np.int32).reshape(out_h, 2, out_w, 2, *img.shape[2:])
        return ((quads.sum(axis=(1, 3)) + 2) >> 2).astype(np.uint8)
    x0, x1, a0, a1 = _linear_taps(w, out_w, clamp=True)
    y0, y1, b0, b1 = _linear_taps(h, out_h, clamp=False)
    extra = (1,) * (img.ndim - 2)
    # int32 holds every step: pixel x 2048 < 2^20, 2048 x (that >> 4) < 2^27
    rows = np.unique(np.concatenate([y0, y1]))
    src = img[rows].astype(np.int32)
    horiz = np.zeros((h, out_w, *img.shape[2:]), np.int32)
    horiz[rows] = (src[:, x0] * a0.reshape(1, -1, *extra).astype(np.int32)
                   + src[:, x1] * a1.reshape(1, -1, *extra).astype(np.int32))
    horiz >>= 4
    b0 = b0.reshape(-1, 1, *extra).astype(np.int32)
    b1 = b1.reshape(-1, 1, *extra).astype(np.int32)
    out = (((b0 * horiz[y0]) >> 16) + ((b1 * horiz[y1]) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)
