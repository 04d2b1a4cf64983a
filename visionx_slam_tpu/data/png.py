"""A small PNG codec on zlib + numpy (no image library needed).

Covers what the TUM RGB-D layout uses:

- ``write_png``: 8-bit gray [H,W] u8, 8-bit RGB [H,W,3] u8 and 16-bit gray
  [H,W] u16, every row with filter type 0 (None);
- ``read_png``: non-interlaced 8-bit gray/RGB/RGBA and 16-bit gray, with
  all five row filter types (files written by libpng or OpenCV choose
  filters per row). RGB comes back in R,G,B channel order.

``rgb_to_gray`` is OpenCV's fixed-point BGR2GRAY rule for 8-bit images
(15-bit weights, the same as native/vxs_io.cpp), so decoded frames are
bit-identical to ``cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2GRAY)`` (the
reference's decode, tracking.cpp:122; pinned by tests/test_png.py).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> channels, for the types this codec reads
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write u8 [H,W] / u8 [H,W,3] (RGB) / u16 [H,W] as a PNG file."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 2:
        color, depth = 0, 8
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        color, depth = 2, 8
    elif img.dtype == np.uint16 and img.ndim == 2:
        color, depth = 0, 16
        img = img.astype(">u2")
    else:
        raise ValueError(f"unsupported image {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), level)))
        f.write(_chunk(b"IEND", b""))


def _unfilter_row(ftype: int, row: np.ndarray, prior: np.ndarray,
                  bpp: int) -> np.ndarray:
    """Reverse one row's filter (PNG spec §9.2); arithmetic is mod 256."""
    if ftype == 0:
        return row
    if ftype == 1:    # Sub: running sum per byte lane of the pixel
        return np.cumsum(row.reshape(-1, bpp), axis=0,
                         dtype=np.uint8).reshape(-1)
    if ftype == 2:    # Up
        return row + prior
    if ftype not in (3, 4):
        raise ValueError(f"bad PNG filter type {ftype}")
    # Average and Paeth depend on the reconstructed left neighbour, so
    # they run byte by byte
    out = bytearray(row.tobytes())
    up = prior.tobytes()
    n = len(out)
    if ftype == 3:
        for i in range(n):
            left = out[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + ((left + up[i]) >> 1)) & 0xFF
    else:
        for i in range(n):
            if i >= bpp:
                a, c = out[i - bpp], up[i - bpp]
            else:
                a = c = 0
            b = up[i]
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file: u8 [H,W] gray, u8 [H,W,3] RGB, u8 [H,W,4] RGBA
    or u16 [H,W] gray."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"not a PNG file: {path}")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG CRC mismatch in {tag!r}: {path}")
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if hdr is None or not idat:
        raise ValueError(f"truncated PNG file: {path}")
    w, h, depth, color, _, _, interlace = hdr
    if interlace or color not in _CHANNELS or depth not in (8, 16) or (
            depth == 16 and color != 0):
        raise ValueError(
            f"unsupported PNG (depth {depth}, color {color}, interlace "
            f"{interlace}): {path}")
    ch = _CHANNELS[color]
    bpp = ch * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[: h * (stride + 1)].reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        prior = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prior, bpp)
        out[y] = prior
    if depth == 16:
        return out.view(">u2").reshape(h, w).astype(np.uint16)
    return out.reshape(h, w, ch) if ch > 1 else out.reshape(h, w)


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """u8 [...,3] RGB -> u8 gray with OpenCV's fixed-point BGR2GRAY rule,
    (R*9798 + G*19235 + B*3735 + 16384) >> 15. (The 14-bit weights
    4899/9617/1868 differ from cv2 by one level on ~0.3% of pixels.)"""
    c = rgb.astype(np.uint32)
    g = (c[..., 0] * 9798 + c[..., 1] * 19235 + c[..., 2] * 3735
         + 16384) >> 15
    return g.astype(np.uint8)
