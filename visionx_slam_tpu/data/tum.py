"""TUM RGB-D dataset loader with reference-identical association semantics.

Re-implements core/common/dataset_tum_rgbd.{h,cpp}:
- ``read_list``: rgb.txt / depth.txt parsing (dataset_tum_rgbd.cpp:35-49);
- ``read_groundtruth``: groundtruth.txt parsing (:51-65);
- ``associate``: nearest-timestamp join of depth and GT to each RGB frame
  with the 0.02 s window (:67-122, threshold dataset_tum_rgbd.h:26);
- ``load_intrinsics``: freiburg1/2/3 selection by substring from
  ``color_camera_freiburgN.txt`` with 9 params fx fy cx cy k1 k2 p1 p2 k3
  (:124-165).

Host-side (numpy) by design: file IO and PNG decode (``data/png.py``)
never run on device.
Depth images follow the TUM convention: 16-bit PNG, value/5000 = meters
(reference tracking.cpp:603).
"""

from __future__ import annotations

import bisect
import logging
import os
from dataclasses import dataclass, field

import numpy as np

from . import png

log = logging.getLogger("vxs.data.tum")

ASSOCIATE_MAX_DIFF = 0.02  # seconds (reference dataset_tum_rgbd.h:26)
DEPTH_SCALE = 5000.0       # reference tracking.cpp:603

# Stock TUM RGB-D intrinsics per freiburg version, used when the dataset dir
# ships no color_camera_freiburgN.txt (values from the TUM benchmark site —
# the same numbers those files carry).
DEFAULT_INTRINSICS = {
    "1": (517.3, 516.5, 318.6, 255.3, 0.2624, -0.9531, -0.0054, 0.0026, 1.1633),
    "2": (520.9, 521.0, 325.1, 249.7, 0.2312, -0.7849, -0.0033, -0.0001, 0.9172),
    "3": (535.4, 539.2, 320.1, 247.6, 0.0, 0.0, 0.0, 0.0, 0.0),
}


@dataclass
class Intrinsics:
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0


@dataclass
class ImageEntry:
    """One associated frame (reference dataset.h:10-16)."""

    timestamp: float
    rgb_path: str
    depth_path: str
    gt_t: np.ndarray  # [3]
    gt_q: np.ndarray  # [4] xyzw (TUM file order qx qy qz qw)


@dataclass
class TumDataset:
    dataset_dir: str
    sequence: str
    entries: list[ImageEntry] = field(default_factory=list)
    intrinsics: Intrinsics | None = None

    def load(self) -> bool:
        self.intrinsics = load_intrinsics(self.dataset_dir, self.sequence)
        if self.intrinsics is None:
            log.error("Failed to load intrinsics for %s", self.sequence)
            return False
        seq_dir = os.path.join(self.dataset_dir, self.sequence)
        log.info("Loading TUM RGB-D sequence from: %s", seq_dir)
        rgb = read_list(os.path.join(seq_dir, "rgb.txt"))
        depth = read_list(os.path.join(seq_dir, "depth.txt"))
        gt = read_groundtruth(os.path.join(seq_dir, "groundtruth.txt"))
        self.entries = associate(rgb, depth, gt, seq_dir)
        log.info("Successfully associated %d frames.", len(self.entries))
        return bool(self.entries)


def read_list(filename: str) -> list[tuple[float, str]]:
    """Parse ``timestamp path`` lines, '#' comments skipped; sorted by ts."""
    out: list[tuple[float, str]] = []
    try:
        with open(filename, "r") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                if len(parts) < 2:
                    continue
                out.append((float(parts[0]), parts[1]))
    except OSError:
        log.warning("Cannot open list file: %s", filename)
    out.sort(key=lambda kv: kv[0])
    return out


def read_groundtruth(filename: str) -> list[tuple[float, np.ndarray, np.ndarray]]:
    """Parse ``ts tx ty tz qx qy qz qw`` lines; sorted by ts."""
    out: list[tuple[float, np.ndarray, np.ndarray]] = []
    try:
        with open(filename, "r") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                if len(parts) < 8:
                    continue
                v = [float(p) for p in parts[:8]]
                out.append(
                    (v[0], np.array(v[1:4]), np.array(v[4:8]))  # t, q (xyzw)
                )
    except OSError:
        log.warning("Cannot open groundtruth file: %s", filename)
    out.sort(key=lambda kv: kv[0])
    return out


def _nearest(sorted_ts: list[float], ts: float) -> int:
    """Index of element of sorted_ts nearest to ts (lower_bound + prev check,
    exactly the reference's std::map::lower_bound logic at :67-122)."""
    i = bisect.bisect_left(sorted_ts, ts)
    if i > 0 and (i == len(sorted_ts) or abs(sorted_ts[i - 1] - ts) < abs(sorted_ts[i] - ts)):
        return i - 1
    return min(i, len(sorted_ts) - 1)


def associate(
    rgb: list[tuple[float, str]],
    depth: list[tuple[float, str]],
    gt: list[tuple[float, np.ndarray, np.ndarray]],
    seq_dir: str,
    max_diff: float = ASSOCIATE_MAX_DIFF,
) -> list[ImageEntry]:
    """Nearest-timestamp join per RGB frame (dataset_tum_rgbd.cpp:67-122).

    A frame is kept only when both its depth and GT neighbors lie within
    ``max_diff`` seconds.
    """
    entries: list[ImageEntry] = []
    if not depth or not gt:
        return entries
    depth_ts = [d[0] for d in depth]
    gt_ts = [g[0] for g in gt]

    for ts_rgb, rgb_path in rgb:
        di = _nearest(depth_ts, ts_rgb)
        if abs(depth_ts[di] - ts_rgb) > max_diff:
            continue
        gi = _nearest(gt_ts, ts_rgb)
        if abs(gt_ts[gi] - ts_rgb) > max_diff:
            continue
        entries.append(
            ImageEntry(
                timestamp=ts_rgb,
                rgb_path=os.path.join(seq_dir, rgb_path),
                depth_path=os.path.join(seq_dir, depth[di][1]),
                gt_t=gt[gi][1],
                gt_q=gt[gi][2],
            )
        )
    return entries


def load_intrinsics(dataset_dir: str, sequence: str) -> Intrinsics | None:
    """freiburgN intrinsics file, 9 params (dataset_tum_rgbd.cpp:124-165).

    Falls back to the stock TUM calibration when the file is absent.
    """
    version = None
    for v in ("1", "2", "3"):
        if f"freiburg{v}" in sequence:
            version = v
            break
    if version is None:
        log.error("Unknown sequence version for: %s", sequence)
        return None

    path = os.path.join(dataset_dir, f"color_camera_freiburg{version}.txt")
    try:
        with open(path, "r") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                if len(parts) < 9:
                    log.warning("Failed to parse 9 parameters: %s", line)
                    return None
                v = [float(p) for p in parts[:9]]
                return Intrinsics(*v)
    except OSError:
        log.warning("No intrinsics file %s; using stock TUM freiburg%s calibration",
                    path, version)
        return Intrinsics(*DEFAULT_INTRINSICS[version])
    log.error("No valid intrinsics found in file: %s", path)
    return None


# ---------------------------------------------------------------------------
# image decode (host)
# ---------------------------------------------------------------------------

def load_rgb_gray(path: str) -> np.ndarray:
    """Decode an RGB PNG to grayscale uint8 [H,W] (OpenCV BGR2GRAY weights,
    matching the reference's cvtColor at tracking.cpp:122)."""
    img = png.read_png(path)
    if img.ndim == 3:
        return png.rgb_to_gray(img[..., :3])
    if img.dtype == np.uint16:
        return (img >> 8).astype(np.uint8)
    return img


def load_depth_m(path: str) -> np.ndarray:
    """Decode a 16-bit depth PNG to meters float32 [H,W]; 0 = invalid."""
    img = png.read_png(path)
    if img.dtype == np.uint16:
        return img.astype(np.float32) / DEPTH_SCALE
    return img.astype(np.float32)
