"""PNG read and write and the two image resizes of the data layer, in numpy
and the standard library's `zlib` (the port's stand-in for `cv2.imread`,
`cv2.imwrite` and `cv2.resize`, which the card's machine does not have).

- `imread` returns BGR uint8 [H, W, 3] as `cv2.imread(path)` does;
  `imread_depth` returns a grayscale image at its own depth (uint16 for a
  16-bit PNG) as `cv2.imread(path, cv2.IMREAD_ANYDEPTH)` does.
- PNG only: 8-bit gray, RGB and RGBA and 16-bit gray, non-interlaced, all
  five row filters. A JPEG path raises `NotImplementedError`.
- `imwrite` writes filter type 0 (None) on every row.
- `resize_linear_u8` is OpenCV's uint8 `INTER_LINEAR`: source coordinate
  (dst + 0.5) * in / out - 0.5, weights in 11-bit fixed point and its
  vector path's vertical rounding, bit for bit with `cv2.resize` on the
  sizes the tests cover. `resize_nearest` is OpenCV's `INTER_NEAREST`,
  floor(dst * in / out).
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Tuple

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel (gray, RGB, RGBA)
_CHANNELS = {0: 1, 2: 3, 6: 4}
_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _check_format(path: str) -> None:
    ext = os.path.splitext(path)[1].lower()
    if ext in (".jpg", ".jpeg"):
        raise NotImplementedError(
            f"{path}: JPEG is not supported by the port's image reader "
            f"(PNG only)")


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters of the decompressed stream."""
    data = np.frombuffer(raw, np.uint8)
    if data.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {data.size} bytes, expected "
                         f"{h * (stride + 1)}")
    rows = data.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:        # Sub: a running sum per byte lane
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:        # Up
            cur = line + prior
        elif ftype == 3:        # Average
            cur = line.astype(np.int32)
            up = prior.astype(np.int32)
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                cur[x] = (cur[x] + ((left + up[x]) >> 1)) & 0xFF
            cur = cur.astype(np.uint8)
        elif ftype == 4:        # Paeth
            cur = line.astype(np.int32)
            up = prior.astype(np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = up[x]
                c = up[x - bpp] if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
            cur = cur.astype(np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ftype}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """The PNG's samples as stored: [H, W] for gray, [H, W, C] in file
    channel order (RGB, RGBA) otherwise; uint8 or uint16."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, ihdr, idat = 8, None, []
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos:pos + 4])
        ctype = blob[pos + 4:pos + 8]
        body = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, _, _, interlace = ihdr
    if color not in _CHANNELS or depth not in (8, 16) or interlace \
            or (depth == 16 and color != 0):
        raise NotImplementedError(
            f"{path}: PNG colour type {color}, bit depth {depth}, interlace "
            f"{interlace}; the reader takes 8-bit gray, RGB and RGBA and "
            f"16-bit gray, not interlaced")
    ch = _CHANNELS[color]
    bpp = ch * depth // 8
    pix = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:
        img = pix.view(">u2").astype(np.uint16).reshape(h, w)
    else:
        img = pix.reshape(h, w, ch) if ch > 1 else pix.reshape(h, w)
    return img


def imread(path: str) -> np.ndarray:
    """A colour image as BGR uint8 [H, W, 3] (`cv2.imread(path)`): gray is
    repeated over the three channels, alpha dropped, 16 bits cut to 8."""
    _check_format(path)
    img = read_png(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return np.ascontiguousarray(img[..., 2::-1])


def imread_depth(path: str) -> np.ndarray:
    """A grayscale image at its own bit depth, [H, W] uint16 or uint8
    (`cv2.imread(path, cv2.IMREAD_ANYDEPTH)` of a gray PNG)."""
    _check_format(path)
    img = read_png(path)
    if img.ndim != 2:
        raise ValueError(f"{path}: expected a grayscale PNG, got "
                         f"{img.shape[2]} channels")
    return img


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def imwrite(path: str, img: np.ndarray) -> None:
    """Write uint8 gray [H, W], BGR [H, W, 3] or BGRA [H, W, 4], or uint16
    gray [H, W], as a PNG with filter type 0 on every row (zlib level 1,
    OpenCV's default)."""
    _check_format(path)
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        color, depth, rows = 0, 16, img.astype(">u2")
    elif img.dtype == np.uint8 and img.ndim == 2:
        color, depth, rows = 0, 8, img
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] in (3, 4):
        color = 2 if img.shape[2] == 3 else 6
        rgb = img[..., 2::-1]
        rows = rgb if img.shape[2] == 3 else np.concatenate(
            [rgb, img[..., 3:]], axis=2)
        depth = 8
    else:
        raise ValueError(f"imwrite: unsupported image {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    raw = np.ascontiguousarray(rows).view(np.uint8).reshape(h, -1)
    filtered = np.concatenate([np.zeros((h, 1), np.uint8), raw], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIG + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), 1))
                + _chunk(b"IEND", b""))


def _linear_taps(n_in: int, n_out: int, clamp_weights: bool):
    """OpenCV's two source indices and 11-bit weights per output index: fx
    = f32((d + 0.5) * scale - 0.5) with scale = 1 / (out / in) in double.
    Beyond the first and last sample the indices clamp; along x OpenCV also
    moves the whole weight onto the clamped sample, along y it keeps the
    fraction (both taps then read the same row)."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale
         - 0.5).astype(np.float32)
    s = np.floor(f)
    frac = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    if clamp_weights:
        frac[(s < 0) | (s >= n_in - 1)] = 0.0
    w0 = np.rint((np.float32(1) - frac) * np.float32(_COEF_SCALE))
    w1 = np.rint(frac * np.float32(_COEF_SCALE))
    return (np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1),
            w0.astype(np.int64), w1.astype(np.int64))


def resize_linear_u8(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """`cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)` of a uint8
    [H, W] or [H, W, C] image. The horizontal pass sums two taps with
    11-bit integer weights; the vertical pass rounds as OpenCV's vector
    path does, (((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16) + 2) >> 2.
    A scale of exactly 2 on both axes is OpenCV's area average, which these
    weights give too."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize_linear_u8: expected uint8, got {img.dtype}")
    H, W = img.shape[:2]
    h, w = hw
    if (h, w) == (H, W):
        return img.copy()
    xs0, xs1, a0, a1 = _linear_taps(W, w, True)
    ys0, ys1, b0, b1 = _linear_taps(H, h, False)
    src = img.astype(np.int64)
    if img.ndim == 2:
        src = src[..., None]
    hrow = (src[:, xs0] * a0[None, :, None] + src[:, xs1] * a1[None, :, None])
    s0, s1 = hrow[ys0] >> 4, hrow[ys1] >> 4
    v = ((s0 * b0[:, None, None]) >> 16) + ((s1 * b1[:, None, None]) >> 16)
    out = np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)
    return out[..., 0] if img.ndim == 2 else out


def resize_nearest(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """`cv2.resize(..., interpolation=cv2.INTER_NEAREST)` of [H, W, ...]:
    source index floor(dst * in / out) in double (OpenCV's 1 / (out / in)),
    capped at the last sample."""
    H, W = img.shape[:2]
    h, w = hw
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / H))).astype(np.int64),
                    H - 1)
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / W))).astype(np.int64),
                    W - 1)
    return img[ys[:, None], xs[None, :]]
