"""The zlib/numpy PNG codec (data/png.py) against itself and against
OpenCV-written files."""

import numpy as np
import pytest

from visionx_slam_tpu.data import png


def _image(kind, rng):
    h, w = 37, 53  # odd sizes: no accidental alignment
    if kind == "gray8":
        return rng.integers(0, 256, (h, w), dtype=np.uint8)
    if kind == "rgb8":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return rng.integers(0, 65536, (h, w), dtype=np.uint16)


@pytest.mark.parametrize("kind", ["gray8", "rgb8", "depth16"])
def test_png_round_trip(tmp_path, rng, kind):
    img = _image(kind, rng)
    path = str(tmp_path / f"{kind}.png")
    png.write_png(path, img)
    out = png.read_png(path)
    assert out.dtype == img.dtype and out.shape == img.shape
    np.testing.assert_array_equal(out, img)


def test_png_decode_matches_opencv(tmp_path, rng):
    """Files written by cv2 (libpng) with each row filter, and with its
    adaptive per-row choice: decode and gray conversion must be
    bit-identical to cv2.imread + cvtColor(BGR2GRAY)."""
    import cv2

    yy, xx = np.mgrid[0:64, 0:96]
    base = np.stack([(xx * 2 + yy) % 256, (yy * 3) % 256,
                     (xx * yy) % 256], -1).astype(np.float64)
    base += rng.normal(0, 6, base.shape) * (xx[..., None] > 48)
    bgr = np.clip(base, 0, 255).astype(np.uint8)
    depth = (np.clip(yy * 700 + xx * 13 + rng.integers(0, 50, yy.shape),
                     0, 65535)).astype(np.uint16)
    gray8 = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    modes = [cv2.IMWRITE_PNG_FILTER_SUB, cv2.IMWRITE_PNG_FILTER_UP,
             cv2.IMWRITE_PNG_FILTER_AVG, cv2.IMWRITE_PNG_FILTER_PAETH,
             cv2.IMWRITE_PNG_ALL_FILTERS]
    filters = set()
    for mode in modes:
        for name, img in (("bgr", bgr), ("depth", depth), ("gray", gray8)):
            path = str(tmp_path / f"{name}_{mode}.png")
            assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER, mode])
            ours = png.read_png(path)
            theirs = cv2.imread(path, cv2.IMREAD_UNCHANGED)
            if ours.ndim == 3:
                ours = ours[..., ::-1]  # RGB -> cv2's BGR
            np.testing.assert_array_equal(ours, theirs)
            filters |= _row_filters(path)
    assert {1, 2, 3, 4} <= filters, filters

    path = str(tmp_path / "bgr.png")
    assert cv2.imwrite(path, bgr)  # cv2's default settings
    assert cv2.imwrite(str(tmp_path / "depth.png"), depth)
    from visionx_slam_tpu.data import tum

    path = str(tmp_path / "bgr.png")
    np.testing.assert_array_equal(
        tum.load_rgb_gray(path),
        cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2GRAY))
    np.testing.assert_array_equal(
        tum.load_depth_m(str(tmp_path / "depth.png")),
        depth.astype(np.float32) / tum.DEPTH_SCALE)


def _row_filters(path):
    """Filter-type bytes of every row of a (non-interlaced) PNG."""
    import struct
    import zlib

    data = open(path, "rb").read()
    pos, idat = 8, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        if tag == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", data[pos + 8:pos + 18])
        elif tag == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    ch = {0: 1, 2: 3, 6: 4}[color]
    stride = w * ch * depth // 8 + 1
    raw = zlib.decompress(idat)
    return {raw[y * stride] for y in range(h)}
