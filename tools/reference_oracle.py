"""Reference oracle: a line-faithful host-side re-execution of the
VisionX-SLAM reference pipeline, driving the ACTUAL OpenCV calls the
reference delegates to.

The reference C++ binary cannot run here (vcpkg/Pangolin/macOS build,
`/root/reference/build_mac.sh`), and it never writes its trajectory
(`apps/main.cpp:162-169` — the only sinks are glog and the GL window).
BASELINE.json's fidelity metric ("ATE RMSE within 5% of the reference
binary") therefore needs an executable stand-in. This module IS that
stand-in: every branch, threshold, and call order below transliterates
`core/frontend/tracking.cpp` + `core/backend/local_ba.cpp` +
`core/system/system.cpp` 1:1 (citations inline), and the numerics the
reference delegates to native libraries run through the SAME libraries:

- cv2.ORB_create(1000, 1.2, 8).detectAndCompute  (orb_extractor.cpp:5-28)
- cv2.BFMatcher(NORM_HAMMING).knnMatch k=2 + 0.8 ratio (orb_matcher.cpp:25-37)
- cv2.findEssentialMat / cv2.recoverPose          (tracking.cpp:521-528)
- cv2.solvePnPRansac + cv2.Rodrigues              (tracking.cpp:422-433)

This file intentionally mirrors reference control flow rather than being
device-idiomatic: it is a TEST TOOL (the fidelity baseline generator), not
part of the framework. Known reference quirks are preserved, not fixed:

- the init parallax gate compares a mean PIXEL distance against 1 degree
  in RADIANS (tracking.cpp:240-242 vs ComputeParallax:548-560);
- ProjectToPixel ignores distortion (projection.h:10) while
  Camera::cameraToPixel models it; the frontend only uses the former;
- TriangulateWithLastKeyFrame re-matches WITHOUT the min-dist filter
  (tracking.cpp:862-863) that Track*/Init apply;
- LocalBA's per-iteration cost accumulates during pose optimization only
  (local_ba.cpp:158) yet gates convergence for both halves.

Output: TUM-format trajectory (timestamp tx ty tz qx qy qz qw, T_wc) of
per-frame tracked poses, for ATE comparison against the JAX pipelines.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover - cv2 is present in this env
    cv2 = None


# ----------------------------------------------------------------------
# Minimal Sophus::SE3d stand-in (only the ops the reference uses)
# ----------------------------------------------------------------------

def so3_hat(w):
    return np.array([
        [0.0, -w[2], w[1]],
        [w[2], 0.0, -w[0]],
        [-w[1], w[0], 0.0],
    ])


class SE3:
    """T_cw as (R, t); mirrors the Sophus::SE3d ops used by the frontend:
    identity ctor, (R,t) ctor, inverse, composition, group action on
    points, and exp([upsilon, omega]) for the BA left-update
    (local_ba.cpp:172 ``SE3d::exp(dx) * pose``)."""

    __slots__ = ("R", "t")

    def __init__(self, R=None, t=None):
        self.R = np.eye(3) if R is None else np.asarray(R, np.float64)
        self.t = np.zeros(3) if t is None else np.asarray(t, np.float64).ravel()

    def inverse(self):
        return SE3(self.R.T, -self.R.T @ self.t)

    def __mul__(self, other):
        if isinstance(other, SE3):
            return SE3(self.R @ other.R, self.R @ other.t + self.t)
        p = np.asarray(other, np.float64)
        return self.R @ p + self.t

    def matrix4(self):
        T = np.eye(4)
        T[:3, :3] = self.R
        T[:3, 3] = self.t
        return T

    @staticmethod
    def exp(dx):
        """Sophus tangent convention: dx = [upsilon(3), omega(3)]."""
        u, w = np.asarray(dx[:3], np.float64), np.asarray(dx[3:], np.float64)
        th = np.linalg.norm(w)
        W = so3_hat(w)
        if th < 1e-10:
            R = np.eye(3) + W
            V = np.eye(3) + 0.5 * W
        else:
            R = (np.eye(3) + math.sin(th) / th * W
                 + (1 - math.cos(th)) / th**2 * (W @ W))
            V = (np.eye(3) + (1 - math.cos(th)) / th**2 * W
                 + (th - math.sin(th)) / th**3 * (W @ W))
        return SE3(R, V @ u)


# ----------------------------------------------------------------------
# Camera (camera/camera.cpp) + ProjectToPixel (common/projection.h)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class Camera:
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    def pixel_to_camera(self, px, depth=1.0):
        # camera.cpp:30-35 — no undistortion on the way up
        x = (px[0] - self.cx) / self.fx
        y = (px[1] - self.cy) / self.fy
        return np.array([x * depth, y * depth, depth])

    def K(self):
        return np.array([
            [self.fx, 0.0, self.cx],
            [0.0, self.fy, self.cy],
            [0.0, 0.0, 1.0],
        ])


def project_to_pixel(cam: Camera, T_cw: SE3, pw):
    """projection.h:10-32 — distortion-free pinhole, z > 1e-6 gate.
    Returns (ok, uv, pc)."""
    pc = T_cw * pw
    if pc[2] <= 1e-6:
        return False, None, pc
    inv_z = 1.0 / pc[2]
    uv = np.array([
        cam.fx * pc[0] * inv_z + cam.cx,
        cam.fy * pc[1] * inv_z + cam.cy,
    ])
    return True, uv, pc


# ----------------------------------------------------------------------
# Frame / Landmark / Map (frame/frame.h, map/landmark.h, map/map.cpp)
# ----------------------------------------------------------------------

class Feature:
    __slots__ = ("position", "response", "has_landmark", "landmark_id",
                 "is_outlier")

    def __init__(self, position, response):
        self.position = np.asarray(position, np.float64)
        self.response = response
        self.has_landmark = False   # frame.h Feature defaults
        self.landmark_id = 0
        self.is_outlier = False


class Frame:
    def __init__(self, fid, timestamp, camera, image, depth):
        self.id = fid
        self.timestamp = timestamp
        self.camera = camera
        self.image = image
        self.depth = depth
        self.T_cw = SE3()          # frame.cpp:12 — identity at construction
        self.features: list[Feature] = []
        self.descriptors = None    # np.uint8 [N,32]


class Landmark:
    def __init__(self, lid, pos):
        self.id = lid
        self.pos = np.asarray(pos, np.float64)
        self.observations: dict[int, int] = {}  # kf_id -> feature idx
        self.is_bad = False


class Map:
    """map/map.cpp — keyframes ordered by id (std::map), landmarks a
    hash map (iteration order is unspecified in C++; insertion order
    here — the frontend's results do not depend on it)."""

    def __init__(self):
        self.keyframes: dict[int, Frame] = {}
        self.landmarks: dict[int, Landmark] = {}

    def insert_keyframe(self, frame):
        self.keyframes[frame.id] = frame
        self.keyframes = dict(sorted(self.keyframes.items()))

    def insert_landmark(self, lm):
        self.landmarks[lm.id] = lm

    def remove_keyframe(self, fid):
        self.keyframes.pop(fid, None)

    def remove_landmark(self, lid):
        self.landmarks.pop(lid, None)

    def remove_all(self):
        self.keyframes.clear()
        self.landmarks.clear()

    def get_frame(self, fid):
        return self.keyframes.get(fid)

    def get_landmark(self, lid):
        return self.landmarks.get(lid)


# ----------------------------------------------------------------------
# ORB extractor / matcher (feature/orb_extractor.cpp, orb_matcher.cpp)
# ----------------------------------------------------------------------

class ORBExtractor:
    def __init__(self, n_features=1000, scale_factor=1.2, n_levels=8):
        # orb_extractor.h:11-13 defaults
        self.orb = cv2.ORB_create(n_features, scale_factor, n_levels)

    def extract(self, frame: Frame):
        # orb_extractor.cpp:10-28
        kps, desc = self.orb.detectAndCompute(frame.image, None)
        frame.features = [Feature((kp.pt[0], kp.pt[1]), kp.response)
                          for kp in (kps or [])]
        frame.descriptors = desc


class ORBMatcher:
    def __init__(self, nn_ratio=0.8, min_matches=50):
        # orb_matcher.h:13-16 defaults
        self.nn_ratio = nn_ratio
        self.min_matches = min_matches
        self.bf = cv2.BFMatcher(cv2.NORM_HAMMING)

    def match(self, last: Frame, curr: Frame):
        """orb_matcher.cpp:11-44: 2-NN + ratio test. Returns a list of
        (query_idx, train_idx, distance)."""
        d1, d2 = last.descriptors, curr.descriptors
        if d1 is None or d2 is None or len(d1) == 0 or len(d2) == 0:
            return []
        knn = self.bf.knnMatch(d1, d2, k=2)
        out = []
        for pair in knn:
            if len(pair) < 2:
                continue
            m1, m2 = pair
            if m1.distance < self.nn_ratio * m2.distance:
                out.append((m1.queryIdx, m1.trainIdx, m1.distance))
        return out


def min_dist_filter(matches):
    """tracking.cpp:211-222 / 291-303 / 342-355: keep matches with
    distance <= max(2*min_dist, 30)."""
    if not matches:
        return matches
    min_dist = 100.0
    for m in matches:
        if m[2] < min_dist:
            min_dist = m[2]
    return [m for m in matches if m[2] <= max(2 * min_dist, 30.0)]


# ----------------------------------------------------------------------
# Options (tracking.h:24-55 defaults overridden by apps/main.cpp flags)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class Options:
    # values = apps/main.cpp:21-48 gflags defaults (the stock run)
    min_matches: int = 20
    min_inliers: int = 15
    min_keyframe_inliers: int = 20
    min_parallax: float = 5.0
    max_reproj_error: float = 2.0
    min_keyframe_gap: int = 3
    enable_culling: bool = False
    min_landmark_observations: int = 2
    min_landmarks_for_culling: int = 200
    min_keyframes_for_culling: int = 3
    max_keyframes: int = 30
    kf_min_shared_observations: int = 3
    kf_redundant_ratio: float = 0.9
    landmark_max_reproj_error: float = 5.0
    triangulation_max_reproj_error: float = 5.0
    triangulation_min_angle_deg: float = 1.0
    enable_local_ba: bool = True
    ba_window_size: int = 5
    ba_iterations: int = 5
    ba_min_pose_observations: int = 20
    ba_min_point_observations: int = 2
    ba_huber_delta: float = 5.0
    ba_max_reproj_error: float = 5.0


# ----------------------------------------------------------------------
# LocalBA (backend/local_ba.cpp)
# ----------------------------------------------------------------------

class LocalBA:
    def __init__(self, opts: Options):
        self.o = opts

    @staticmethod
    def _projection_jacobian(cam, pc):
        # local_ba.cpp:15-24
        x, y, z = pc
        z2 = z * z
        return np.array([
            [cam.fx / z, 0.0, -cam.fx * x / z2],
            [0.0, cam.fy / z, -cam.fy * y / z2],
        ])

    def _pose_jacobian(self, cam, pc):
        # local_ba.cpp:26-33: J_se3 = [I | -hat(pc)]
        J_se3 = np.zeros((3, 6))
        J_se3[:, :3] = np.eye(3)
        J_se3[:, 3:] = -so3_hat(pc)
        return self._projection_jacobian(cam, pc) @ J_se3

    @staticmethod
    def _huber_weight(err, delta):
        # local_ba.cpp:36-41
        return 1.0 if err <= delta else delta / err

    def _select_keyframes(self, mp: Map, ref_kf):
        # local_ba.cpp:43-63: last window_size KFs with id <= ref id,
        # ascending order
        if not mp.keyframes:
            return []
        max_id = ref_kf.id if ref_kf else max(mp.keyframes)
        sel = []
        for kid in sorted(mp.keyframes, reverse=True):
            if kid > max_id:
                continue
            sel.append(mp.keyframes[kid])
            if len(sel) >= max(1, self.o.ba_window_size):
                break
        sel.reverse()
        return sel

    def optimize(self, mp: Map, ref_kf):
        # local_ba.cpp:66-249
        keyframes = self._select_keyframes(mp, ref_kf)
        if len(keyframes) < 2:
            return
        local_kf_ids = {kf.id for kf in keyframes}

        landmark_ids = []
        seen = set()
        for kf in keyframes:
            for feat in kf.features:
                if feat.has_landmark and feat.landmark_id not in seen:
                    seen.add(feat.landmark_id)
                    landmark_ids.append(feat.landmark_id)
        landmarks = []
        for lid in landmark_ids:
            lm = mp.get_landmark(lid)
            if lm is None or lm.is_bad:
                continue
            if len(lm.observations) < self.o.ba_min_point_observations:
                continue
            landmarks.append(lm)
        if not landmarks:
            return

        last_cost = float("inf")
        for _ in range(self.o.ba_iterations):
            total_cost = 0.0
            total_obs = 0

            # pose step (landmarks fixed) — local_ba.cpp:113-176
            for kf in keyframes:
                cam = kf.camera
                H = np.zeros((6, 6))
                b = np.zeros(6)
                obs = 0
                for feat in kf.features:
                    if not feat.has_landmark or feat.is_outlier:
                        continue
                    lm = mp.get_landmark(feat.landmark_id)
                    if lm is None or lm.is_bad:
                        continue
                    ok, proj, pc = project_to_pixel(cam, kf.T_cw, lm.pos)
                    if not ok:
                        continue
                    err = feat.position - proj
                    err_norm = np.linalg.norm(err)
                    if err_norm > self.o.ba_max_reproj_error:
                        continue
                    w = self._huber_weight(err_norm, self.o.ba_huber_delta)
                    J = self._pose_jacobian(cam, pc)
                    H += w * J.T @ J
                    b += w * (-J.T @ err)
                    total_cost += w * float(err @ err)
                    total_obs += 1
                    obs += 1
                if obs < self.o.ba_min_pose_observations:
                    continue
                H += 1e-6 * np.eye(6)
                dx = np.linalg.solve(H, b)
                if not np.all(np.isfinite(dx)):
                    continue
                kf.T_cw = SE3.exp(dx) * kf.T_cw

            # landmark step (poses fixed) — local_ba.cpp:178-232
            for lm in landmarks:
                if lm.is_bad:
                    continue
                H = np.zeros((3, 3))
                b = np.zeros(3)
                obs = 0
                for kf_id, feat_idx in lm.observations.items():
                    if kf_id not in local_kf_ids:
                        continue
                    kf = mp.get_frame(kf_id)
                    if kf is None or feat_idx >= len(kf.features):
                        continue
                    feat = kf.features[feat_idx]
                    if (not feat.has_landmark or feat.is_outlier
                            or feat.landmark_id != lm.id):
                        continue
                    ok, proj, pc = project_to_pixel(kf.camera, kf.T_cw, lm.pos)
                    if not ok:
                        continue
                    err = feat.position - proj
                    err_norm = np.linalg.norm(err)
                    if err_norm > self.o.ba_max_reproj_error:
                        continue
                    w = self._huber_weight(err_norm, self.o.ba_huber_delta)
                    J = (self._projection_jacobian(kf.camera, pc)
                         @ kf.T_cw.R)
                    H += w * J.T @ J
                    b += w * (-J.T @ err)
                    obs += 1
                if obs < self.o.ba_min_point_observations:
                    continue
                H += 1e-6 * np.eye(3)
                dp = np.linalg.solve(H, b)
                if not np.all(np.isfinite(dp)):
                    continue
                lm.pos = lm.pos + dp

            if total_obs == 0:
                break
            if abs(last_cost - total_cost) < 1e-6 * last_cost:
                break
            last_cost = total_cost


# ----------------------------------------------------------------------
# Tracking (frontend/tracking.cpp)
# ----------------------------------------------------------------------

INIT, TRACKING_GOOD, TRACKING_BAD, LOST = range(4)

K_DEPTH_SCALE = 5000.0   # tracking.cpp:603
K_MIN_DEPTH = 0.1        # tracking.cpp:604
K_MAX_DEPTH = 10.0       # tracking.cpp:605


class Tracking:
    def __init__(self, options: Options, extractor, matcher, mp: Map):
        self.o = options
        self.extractor = extractor
        self.matcher = matcher
        self.map = mp
        self.state = INIT
        self.init_frame = None
        self.current_frame = None
        self.last_frame = None
        self.last_keyframe = None
        self.last_inliers = 0
        self.last_parallax = 0.0
        self.landmark_id = 0
        self.local_ba = LocalBA(options) if options.enable_local_ba else None
        self.frame_tracked = False  # oracle-only: did this frame get a pose?

    # ---------------- main entry: tracking.cpp:39-89 ----------------
    def process_frame(self, frame: Frame):
        self.current_frame = frame
        self.frame_tracked = False
        self.extractor.extract(frame)
        just_initialized = False

        if self.state == INIT:
            if self.init_frame is None:
                if not self._init_with_first_frame():
                    return
                self.frame_tracked = True  # origin frame, pose = identity
                return
            else:
                if not self._init_with_second_frame():
                    return
                self._update_tracking_state()
                self.last_frame = self.current_frame
                just_initialized = True
                self.frame_tracked = True
        elif self.state == TRACKING_GOOD:
            if not self._track():
                self._handle_tracking_failure()
                return
            self.frame_tracked = True
        elif self.state == TRACKING_BAD:
            self._handle_tracking_bad()
            return
        elif self.state == LOST:
            self._handle_tracking_lost()
            return

        if not just_initialized and self._need_new_keyframe():
            self._create_keyframe()
            if self.o.enable_culling:
                self._cull_landmarks()
                self._cull_keyframes()
            if self.local_ba:
                self.local_ba.optimize(self.map, self.last_keyframe)

        self._update_tracking_state()
        self.last_frame = self.current_frame

    # ---------------- init: tracking.cpp:93-263 ----------------
    def _check_feature_distribution(self, features, width, height):
        # tracking.cpp:93-118: >= 50% of a 5x5 grid occupied
        grid = np.zeros((5, 5), bool)
        for feat in features:
            col = min(max(int(feat.position[0] / width * 5), 0), 4)
            row = min(max(int(feat.position[1] / height * 5), 0), 4)
            grid[col, row] = True
        return int(grid.sum()) >= 12  # 5*5*0.5 = 12.5, int compare >= 12.5

    def _check_image_quality(self, image):
        # tracking.cpp:120-139
        gray = cv2.cvtColor(image, cv2.COLOR_BGR2GRAY)
        mean, stddev = cv2.meanStdDev(gray)
        if mean[0][0] < 30 or mean[0][0] > 225:
            return False
        if stddev[0][0] < 20:
            return False
        return True

    def _init_with_first_frame(self):
        # tracking.cpp:177-204
        f = self.current_frame
        if len(f.features) < self.o.min_matches:
            return False
        if not self._check_feature_distribution(
                f.features, f.image.shape[1], f.image.shape[0]):
            return False
        if not self._check_image_quality(f.image):
            return False
        self.init_frame = f
        f.T_cw = SE3()
        return True

    def _init_with_second_frame(self):
        # tracking.cpp:206-263
        matches = self.matcher.match(self.init_frame, self.current_frame)
        matches = min_dist_filter(matches)
        if len(matches) < self.o.min_matches:
            return False

        ok, inliers = self._estimate_pose_by_essential(
            self.current_frame, self.init_frame, matches)
        if not ok or inliers < self.o.min_inliers:
            return False

        parallax = self._compute_parallax(
            self.init_frame, self.current_frame, matches)
        min_parallax = 1.0 * math.pi / 180.0  # the pixel-vs-radian quirk
        if parallax < min_parallax:
            return False

        self._create_landmarks_from_depth(self.init_frame)
        self._create_landmarks_from_depth(self.current_frame)
        self._triangulate_with_last_keyframe(
            self.init_frame, self.current_frame)

        self.map.insert_keyframe(self.init_frame)
        self.map.insert_keyframe(self.current_frame)
        self.last_keyframe = self.current_frame
        self.last_parallax = parallax
        self.last_inliers = inliers
        return True

    # ---------------- steady state: tracking.cpp:267-455 ----------------
    def _track(self):
        if self.last_keyframe is not None:
            if self._track_with_pnp():
                return True
        return self._track_last_frame()

    def _track_last_frame(self):
        # tracking.cpp:281-330
        if self.last_frame is None:
            return False
        matches = self.matcher.match(self.last_frame, self.current_frame)
        matches = min_dist_filter(matches)
        if len(matches) < self.o.min_matches:
            return False
        ok, inliers = self._estimate_pose_by_essential(
            self.current_frame, self.last_frame, matches)
        if not ok or inliers < self.o.min_inliers:
            return False
        self.last_inliers = inliers
        self.last_parallax = self._compute_parallax(
            self.last_frame, self.current_frame, matches)
        return True

    def _track_with_pnp(self):
        # tracking.cpp:332-455
        if self.last_keyframe is None:
            return False
        matches = self.matcher.match(self.last_keyframe, self.current_frame)
        matches = min_dist_filter(matches)
        if len(matches) < self.o.min_matches:
            return False

        pts_3d, pts_2d = [], []
        feats_last = self.last_keyframe.features
        feats_curr = self.current_frame.features
        for qi, ti, _dist in matches:
            feat_last = feats_last[qi]
            if not feat_last.has_landmark or feat_last.is_outlier:
                continue
            lm = self.map.get_landmark(feat_last.landmark_id)
            if lm is None or lm.is_bad:
                continue
            p = lm.pos
            if not np.all(np.isfinite(p)):
                continue
            if np.any(np.abs(p) > 1000):
                continue
            pts_3d.append(p)
            pts_2d.append(feats_curr[ti].position)

        if len(pts_3d) < self.o.min_inliers:
            return False

        cam = self.current_frame.camera
        max_iterations = min(100, len(pts_3d) * 2)
        ok, rvec, tvec, inl = cv2.solvePnPRansac(
            np.asarray(pts_3d, np.float64),
            np.asarray(pts_2d, np.float64),
            cam.K(), None, useExtrinsicGuess=False,
            iterationsCount=max_iterations,
            reprojectionError=self.o.max_reproj_error,
            confidence=0.99,
        )
        n_inl = 0 if inl is None else int(inl.shape[0])
        if not ok or n_inl < self.o.min_inliers:
            return False

        R, _ = cv2.Rodrigues(rvec)
        if not np.all(np.isfinite(R)):
            return False
        self.current_frame.T_cw = SE3(R, tvec)
        self.last_parallax = self._compute_parallax(
            self.last_keyframe, self.current_frame, matches)
        self.last_inliers = n_inl
        return True

    # ---------------- state machine: tracking.cpp:459-499 ----------------
    def _update_tracking_state(self):
        if self.last_inliers >= self.o.min_inliers:
            self.state = TRACKING_GOOD
        else:
            self.state = TRACKING_BAD

    def _handle_tracking_failure(self):
        if self.state == TRACKING_GOOD:
            self.state = TRACKING_BAD
        else:
            self.state = LOST

    def _reinit(self):
        self.state = INIT
        self.map.remove_all()
        self.init_frame = None
        self.last_frame = None
        self.last_keyframe = None
        self.last_inliers = 0
        self.last_parallax = 0.0

    _handle_tracking_bad = _reinit   # tracking.cpp:477-487
    _handle_tracking_lost = _reinit  # tracking.cpp:489-499

    # ---------------- essential: tracking.cpp:503-544 ----------------
    def _estimate_pose_by_essential(self, curr, last, matches):
        pts_last = np.array(
            [last.features[qi].position for qi, _, _ in matches], np.float64)
        pts_curr = np.array(
            [curr.features[ti].position for _, ti, _ in matches], np.float64)
        K = curr.camera.K()
        E, mask = cv2.findEssentialMat(
            pts_last, pts_curr, K, cv2.RANSAC, 0.999, 1.0)
        if E is None or E.shape[0] == 0:
            return False, 0
        if E.shape[0] != 3:  # multi-solution return: first candidate
            E = E[:3]
        inliers, R, t, _ = cv2.recoverPose(E, pts_last, pts_curr, K,
                                           mask=mask)
        if inliers < self.o.min_inliers:
            return False, int(inliers)
        T_cl = SE3(R, t)
        curr.T_cw = T_cl * last.T_cw
        return True, int(inliers)

    # ---------------- keyframes: tracking.cpp:548-584 ----------------
    def _compute_parallax(self, ref, curr, matches):
        if not matches:
            return 0.0
        s = 0.0
        for qi, ti, _ in matches:
            s += np.linalg.norm(
                ref.features[qi].position - curr.features[ti].position)
        return s / len(matches)

    def _need_new_keyframe(self):
        if self.state != TRACKING_GOOD:
            return False
        if self.current_frame is None or self.last_keyframe is None:
            return False
        if self.last_inliers < self.o.min_keyframe_inliers:
            return False
        if self.last_parallax < self.o.min_parallax:
            return False
        if (self.current_frame.id - self.last_keyframe.id
                < self.o.min_keyframe_gap):
            return False
        return True

    def _create_keyframe(self):
        self._create_landmarks_from_depth(self.current_frame)
        self._triangulate_with_last_keyframe(
            self.last_keyframe, self.current_frame)
        self.last_keyframe = self.current_frame
        self.map.insert_keyframe(self.current_frame)

    def _create_landmarks_from_depth(self, frame):
        # tracking.cpp:586-650
        if frame is None or frame.depth is None:
            return
        depth = frame.depth
        rows, cols = depth.shape[:2]
        cam = frame.camera
        T_wc = frame.T_cw.inverse()
        for i, feat in enumerate(frame.features):
            if feat.has_landmark:
                continue
            u = int(feat.position[0] + 0.5)
            v = int(feat.position[1] + 0.5)
            if u < 0 or u >= cols or v < 0 or v >= rows:
                continue
            if depth.dtype == np.uint16:
                d = depth[v, u]
                if d == 0:
                    continue
                depth_m = float(d) / K_DEPTH_SCALE
            elif depth.dtype in (np.float32, np.float64):
                depth_m = float(depth[v, u])
            else:
                continue
            if depth_m < K_MIN_DEPTH or depth_m > K_MAX_DEPTH:
                continue
            pc = cam.pixel_to_camera(feat.position, depth_m)
            pw = T_wc * pc
            lm = Landmark(self.landmark_id, pw)
            self.landmark_id += 1
            lm.observations[frame.id] = i
            self.map.insert_landmark(lm)
            feat.landmark_id = lm.id
            feat.has_landmark = True
            feat.is_outlier = False

    # ---------------- culling: tracking.cpp:652-840 ----------------
    def _cull_landmarks(self):
        if len(self.map.landmarks) < self.o.min_landmarks_for_culling:
            return
        to_remove = []
        for lm in list(self.map.landmarks.values()):
            if lm.is_bad:
                to_remove.append(lm.id)
                continue
            if len(lm.observations) < self.o.min_landmark_observations:
                lm.is_bad = True
                to_remove.append(lm.id)
                continue
            err_sum, cnt, large_error = 0.0, 0, False
            for kf_id, feat_idx in lm.observations.items():
                frame = self.map.get_frame(kf_id)
                if frame is None or feat_idx >= len(frame.features):
                    continue
                feat = frame.features[feat_idx]
                if not feat.has_landmark or feat.landmark_id != lm.id:
                    continue
                ok, proj, _ = project_to_pixel(frame.camera, frame.T_cw,
                                               lm.pos)
                if not ok:
                    continue
                err = np.linalg.norm(feat.position - proj)
                err_sum += err
                cnt += 1
                if err > self.o.landmark_max_reproj_error * 2.0:
                    large_error = True
                    break
            if cnt == 0:
                lm.is_bad = True
                to_remove.append(lm.id)
                continue
            if large_error or err_sum / cnt > self.o.landmark_max_reproj_error:
                lm.is_bad = True
                to_remove.append(lm.id)

        for lid in to_remove:
            lm = self.map.get_landmark(lid)
            if lm is None:
                continue
            for kf_id, feat_idx in lm.observations.items():
                frame = self.map.get_frame(kf_id)
                if frame is None or feat_idx >= len(frame.features):
                    continue
                feat = frame.features[feat_idx]
                if feat.landmark_id == lid:
                    feat.landmark_id = 0
                    feat.has_landmark = False
                    feat.is_outlier = True
            self.map.remove_landmark(lid)

    def _remove_keyframe(self, keyframe):
        # tracking.cpp:752-773
        kf_id = keyframe.id
        for feat in keyframe.features:
            if not feat.has_landmark:
                continue
            lm = self.map.get_landmark(feat.landmark_id)
            if lm is None:
                continue
            lm.observations.pop(kf_id, None)
            feat.landmark_id = 0
            feat.has_landmark = False
            feat.is_outlier = True
        self.map.remove_keyframe(kf_id)

    def _cull_keyframes(self):
        # tracking.cpp:775-840
        keyframes = self.map.keyframes
        if len(keyframes) <= self.o.min_keyframes_for_culling:
            return
        exceeded = (self.o.max_keyframes > 0
                    and len(keyframes) > self.o.max_keyframes)
        to_remove = None
        for kf in list(keyframes.values()):  # std::map: ascending id
            if kf is self.last_keyframe or kf is self.init_frame:
                continue
            if self.current_frame is not None \
                    and kf.id == self.current_frame.id:
                continue
            total, redundant = 0, 0
            for feat in kf.features:
                if not feat.has_landmark:
                    continue
                total += 1
                lm = self.map.get_landmark(feat.landmark_id)
                if lm is None or lm.is_bad:
                    continue
                if len(lm.observations) >= self.o.kf_min_shared_observations:
                    redundant += 1
            if total == 0:
                continue
            ratio = redundant / total
            if ratio > self.o.kf_redundant_ratio and (exceeded or ratio > 0.95):
                to_remove = kf
                break
        if to_remove is not None:
            self._remove_keyframe(to_remove)
            self._cull_landmarks()

    # ---------------- triangulation: tracking.cpp:844-945 ----------------
    def _projection_matrix(self, T_cw, cam):
        P = np.zeros((3, 4))
        P[:, :3] = T_cw.R
        P[:, 3] = T_cw.t
        return cam.K() @ P

    def _triangulate_with_last_keyframe(self, last_frame, curr_frame):
        if last_frame is None or curr_frame is None:
            return
        # NOTE: raw ratio-test matches — no min-dist filter here
        matches = self.matcher.match(last_frame, curr_frame)
        cam = curr_frame.camera
        P1 = self._projection_matrix(last_frame.T_cw, cam)
        P2 = self._projection_matrix(curr_frame.T_cw, cam)
        min_angle_rad = self.o.triangulation_min_angle_deg * math.pi / 180.0

        for qi, ti, _dist in matches:
            f_last = last_frame.features[qi]
            f_curr = curr_frame.features[ti]
            if f_last.has_landmark or f_curr.has_landmark:
                continue
            px1, px2 = f_last.position, f_curr.position

            f1 = cam_unit(last_frame.camera, px1)
            f2 = cam_unit(curr_frame.camera, px2)
            R1 = last_frame.T_cw.inverse().R
            R2 = curr_frame.T_cw.inverse().R
            f1w = R1 @ f1
            f2w = R2 @ f2
            cos_angle = float(f1w @ f2w
                              / (np.linalg.norm(f1w) * np.linalg.norm(f2w)))
            cos_angle = max(-1.0, min(1.0, cos_angle))
            if math.acos(cos_angle) < min_angle_rad:
                continue

            pw = triangulate_point(P1, P2, px1, px2)
            if not np.all(np.isfinite(pw)):
                continue
            ok1, reproj1, _ = project_to_pixel(last_frame.camera,
                                               last_frame.T_cw, pw)
            if not ok1:
                continue
            ok2, reproj2, _ = project_to_pixel(cam, curr_frame.T_cw, pw)
            if not ok2:
                continue
            if (np.linalg.norm(reproj1 - px1)
                    > self.o.triangulation_max_reproj_error
                    or np.linalg.norm(reproj2 - px2)
                    > self.o.triangulation_max_reproj_error):
                continue

            lm = Landmark(self.landmark_id, pw)
            self.landmark_id += 1
            lm.observations[last_frame.id] = qi
            lm.observations[curr_frame.id] = ti
            self.map.insert_landmark(lm)
            f_last.landmark_id = lm.id
            f_last.has_landmark = True
            f_last.is_outlier = False
            f_curr.landmark_id = lm.id
            f_curr.has_landmark = True
            f_curr.is_outlier = False


def cam_unit(cam, px):
    v = cam.pixel_to_camera(px, 1.0)
    return v / np.linalg.norm(v)


def triangulate_point(P1, P2, x1, x2):
    # tracking.cpp:931-945 (DLT via SVD)
    A = np.stack([
        x1[0] * P1[2] - P1[0],
        x1[1] * P1[2] - P1[1],
        x2[0] * P2[2] - P2[0],
        x2[1] * P2[2] - P2[1],
    ])
    _, _, Vt = np.linalg.svd(A)
    X = Vt[-1]
    return X[:3] / X[3]


# ----------------------------------------------------------------------
# System loop (system/system.cpp:38-67, minus the 100 ms pacing sleep
# and the viewer) + trajectory dump
# ----------------------------------------------------------------------

def run_sequence(dataset_dir, sequence, options=None, max_frames=None,
                 mono=False, frame_stride=1):
    """Run the reference pipeline over a TUM-layout sequence; returns
    (timestamps, tracked_flags, T_cw_mats).

    ``mono=True`` withholds the depth images — exactly the reference's
    monocular path (tracking.cpp: an empty depth Mat makes
    CreateLandmarksFromDepth a no-op at :600-607, so the map is built
    solely by two-view triangulation after the essential-matrix init, and
    TrackLastFrame's unit-norm translation fixes the arbitrary global
    scale). ``frame_stride`` subsamples frames (the bench's mono
    configs use stride 4: fr1-speed 15 mm steps starve the parallax
    gates; the reference behaves identically)."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from visionx_slam_tpu.data import tum

    ds = tum.TumDataset(dataset_dir, sequence)
    ds.load()
    intr = ds.intrinsics
    camera = Camera(intr.fx, intr.fy, intr.cx, intr.cy,
                    intr.k1, intr.k2, intr.p1, intr.p2)
    opts = options or Options()
    mp = Map()
    tracking = Tracking(opts, ORBExtractor(), ORBMatcher(), mp)

    entries = ds.entries if max_frames is None else ds.entries[:max_frames]
    entries = entries[::frame_stride]
    timestamps, tracked, mats = [], [], []
    for i, e in enumerate(entries):
        rgb = cv2.imread(e.rgb_path, cv2.IMREAD_COLOR)
        depth = (None if mono
                 else cv2.imread(e.depth_path, cv2.IMREAD_UNCHANGED))
        frame = Frame(i, e.timestamp, camera, rgb, depth)
        tracking.process_frame(frame)
        timestamps.append(e.timestamp)
        tracked.append(tracking.frame_tracked)
        mats.append(frame.T_cw.matrix4())
    return np.array(timestamps), np.array(tracked), np.stack(mats)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset_dir", required=True)
    ap.add_argument("--sequence", required=True)
    ap.add_argument("--out", default="oracle_trajectory.txt")
    ap.add_argument("--max_frames", type=int, default=None)
    ap.add_argument("--enable_culling", action="store_true")
    ap.add_argument("--mono", action="store_true",
                    help="withhold depth: the reference's monocular path")
    ap.add_argument("--frame_stride", type=int, default=1)
    args = ap.parse_args()

    opts = Options(enable_culling=args.enable_culling)
    ts, tracked, mats = run_sequence(
        args.dataset_dir, args.sequence, opts, args.max_frames,
        mono=args.mono, frame_stride=args.frame_stride)

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from visionx_slam_tpu.eval import trajectory as traj

    T_wc = [traj.tcw_to_twc(m) for m, tk in zip(mats, tracked) if tk]
    ts_t = [t for t, tk in zip(ts, tracked) if tk]
    traj.write_tum_trajectory(args.out, ts_t, T_wc)
    print(f"tracked {int(tracked.sum())}/{len(tracked)} frames -> {args.out}")


if __name__ == "__main__":
    main()
