"""Minimal PNG codec (stdlib zlib only — the image has no PIL), and
the CLI's image files.

Used by the OpenAI-compatible HTTP API (`/v1/images/generations`
returns `b64_json` PNG payloads) and anywhere else a standard image
container is needed. Encodes 8-bit RGB / RGBA / grayscale with filter
type 0; the decoder handles all five standard filters so it can read
PNGs produced by other encoders too.

The port's copy of whisper_tensor_tpu/utils/image.py (`resize_bilinear`
fits an upload to a vision encoder's square input), with the reference
CLI's PPM reader and writer
(whisper_tensor_tpu/cli.py:255-289) beside it as `read_ppm` and
`write_ppm`, and `read_image`, which reads the init image and mask of
`cli image` from either format.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def png_bytes(pixels: np.ndarray) -> bytes:
    """uint8 array (H,W) / (H,W,1) / (H,W,3) / (H,W,4) -> PNG bytes."""
    a = np.asarray(pixels)
    if a.dtype != np.uint8:
        raise ValueError(f"png_bytes wants uint8, got {a.dtype}")
    if a.ndim == 2:
        a = a[:, :, None]
    if a.ndim != 3 or a.shape[2] not in (1, 3, 4):
        raise ValueError(f"unsupported pixel shape {a.shape}")
    h, w, c = a.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    # filter byte 0 (None) per scanline
    raw = b"".join(b"\x00" + a[y].tobytes() for y in range(h))
    return (_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))


def resize_bilinear(pixels: np.ndarray, out_h: int,
                    out_w: int) -> np.ndarray:
    """(H,W,C) uint8/float -> (out_h,out_w,C) bilinear resize
    (half-pixel centers, numpy only — the image has no PIL). Used to
    fit arbitrary uploads to a vision encoder's square input."""
    a = np.asarray(pixels)
    h, w = a.shape[:2]
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    af = a.astype(np.float32)
    top = af[y0][:, x0] * (1 - wx) + af[y0][:, x1] * wx
    bot = af[y1][:, x0] * (1 - wx) + af[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    if a.dtype == np.uint8:
        return np.clip(np.round(out), 0, 255).astype(np.uint8)
    return out.astype(a.dtype)


def _unfilter(kind: int, cur: np.ndarray, prev: np.ndarray,
              bpp: int) -> np.ndarray:
    """Undo one scanline's PNG filter in place (ints, per spec)."""
    n = cur.shape[0]
    if kind == 0:
        return cur
    if kind == 2:                       # Up
        return (cur.astype(np.uint16) + prev) % 256
    out = cur.astype(np.int32)
    for i in range(n):
        left = out[i - bpp] if i >= bpp else 0
        up = int(prev[i])
        ul = int(prev[i - bpp]) if i >= bpp else 0
        if kind == 1:                   # Sub
            out[i] = (out[i] + left) % 256
        elif kind == 3:                 # Average
            out[i] = (out[i] + (left + up) // 2) % 256
        elif kind == 4:                 # Paeth
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = left if (pa <= pb and pa <= pc) else (up if pb <= pc
                                                         else ul)
            out[i] = (out[i] + pred) % 256
        else:
            raise ValueError(f"unknown PNG filter {kind}")
    return out


def png_to_array(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 (H,W,C). 8-bit gray/RGB/RGBA, no interlace."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG")
    pos, w = 8, 0
    h = depth = color = interlace = 0
    idat = b""
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, depth, color, _, _, interlace = struct.unpack(
                ">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    if depth != 8 or interlace:
        raise ValueError("only 8-bit non-interlaced PNGs supported")
    c = {0: 1, 2: 3, 6: 4, 4: 2}.get(color)
    if c is None:
        raise ValueError(f"unsupported color type {color}")
    raw = zlib.decompress(idat)
    stride = w * c
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint16)
    for y in range(h):
        row = raw[y * (stride + 1):(y + 1) * (stride + 1)]
        cur = np.frombuffer(row[1:], np.uint8)
        line = _unfilter(row[0], cur.copy(), prev, c).astype(np.uint8)
        out[y] = line
        prev = line.astype(np.uint16)
    return out.reshape(h, w, c)


def write_ppm(path: str, pixels: np.ndarray) -> None:
    """Dependency-free image writer (PPM P6)."""
    h, w, _ = pixels.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(pixels.tobytes())


def read_ppm(path: str) -> np.ndarray:
    """Dependency-free PPM P6 reader -> (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    parts = []
    i = 0
    while len(parts) < 4:          # magic, w, h, maxval
        while i < len(data) and data[i:i + 1].isspace():
            i += 1
        if data[i:i + 1] == b"#":  # comment line
            while i < len(data) and data[i:i + 1] != b"\n":
                i += 1
            continue
        j = i
        while j < len(data) and not data[j:j + 1].isspace():
            j += 1
        parts.append(data[i:j])
        i = j
    if parts[0] != b"P6":
        raise ValueError(f"{path}: not a P6 PPM")
    w, h = int(parts[1]), int(parts[2])
    i += 1  # single whitespace after maxval
    return np.frombuffer(data[i:i + w * h * 3],
                         dtype=np.uint8).reshape(h, w, 3).copy()


def read_image(path: str) -> np.ndarray:
    """A PNG or PPM (P6) file -> (H, W, C) uint8, by its signature."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == _SIG:
        with open(path, "rb") as f:
            return png_to_array(f.read())
    return read_ppm(path)
