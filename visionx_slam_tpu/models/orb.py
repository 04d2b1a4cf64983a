"""Feature extraction front door.

The reference wraps cv::ORB behind a FeatureExtractor ABC
(core/feature/feature_extractor.h:10-16, orb_extractor.{h,cpp}). Here the
protocol is array-valued with FIXED capacity (SURVEY.md §2.1 row "Feature
extractor ABC"): ``image[H,W] -> (kpts[N,2], resp[N], desc[N,32],
valid[N])`` padded to ``n_slots``.

Two implementations:
- :class:`OpenCVExtractor` — the host oracle (the exact code path the
  reference delegates to at orb_extractor.cpp:13); used for fidelity
  baselines and as the matching/estimation test oracle.
- :class:`JaxOrbExtractor` (models/orb_jax.py) — the device ORB
  (pyramid -> FAST-9 -> Harris -> per-cell top-K -> orientation -> rBRIEF)
  running on device.

Defaults follow the reference: 1000 features, scale 1.2, 8 levels
(orb_extractor.h:11-13).
"""

from __future__ import annotations

import numpy as np


class OpenCVExtractor:
    """Host oracle extractor (cv::ORB::detectAndCompute)."""

    def __init__(self, n_features: int = 1000, scale_factor: float = 1.2,
                 n_levels: int = 8, n_slots: int = 1024):
        import cv2

        self._orb = cv2.ORB_create(
            nfeatures=n_features, scaleFactor=scale_factor, nlevels=n_levels
        )
        self.n_slots = n_slots

    def extract(self, gray: np.ndarray):
        """gray uint8 [H,W] -> (px [S,2] f32, resp [S] f32, desc [S,32] u8,
        valid [S] bool), S = n_slots."""
        kpts, desc = self._orb.detectAndCompute(gray, None)
        S = self.n_slots
        px = np.zeros((S, 2), np.float32)
        resp = np.zeros((S,), np.float32)
        d = np.zeros((S, 32), np.uint8)
        valid = np.zeros((S,), bool)
        n = min(len(kpts), S)
        if n:
            px[:n] = np.asarray([k.pt for k in kpts[:n]], np.float32)
            resp[:n] = np.asarray([k.response for k in kpts[:n]], np.float32)
            d[:n] = desc[:n]
            valid[:n] = True
        return px, resp, d, valid


def sample_depth_at(px: np.ndarray, valid: np.ndarray, depth_m: np.ndarray) -> np.ndarray:
    """Depth at nearest pixel of each keypoint (tracking.cpp:614-626
    rounding + bounds semantics); 0 where missing/out of bounds."""
    h, w = depth_m.shape
    u = np.round(px[:, 0]).astype(np.int64)
    v = np.round(px[:, 1]).astype(np.int64)
    ok = valid & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    out = np.zeros((px.shape[0],), np.float32)
    out[ok] = depth_m[v[ok], u[ok]]
    return out
