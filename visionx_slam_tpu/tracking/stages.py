"""Jitted per-frame pipeline stages operating on the map state.

Each function here is the device-side counterpart of one block of the
reference frontend (core/frontend/tracking.cpp), reshaped for fixed-size
masked batches (SURVEY.md §7 design stance). The host state machine in
``frontend.py`` sequences them.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models import matching
from ..models.estimation import projection_matrix, triangulate_dlt
from ..ops.camera import CameraParams, backproject, project_pinhole
from ..ops.se3 import Pose, identity_pose, quat_rotate, se3_apply, se3_inverse
from . import mapstate as msl
from .mapstate import FREE, OUTLIER, MapState

# TUM depth conventions, reference tracking.cpp:603-605
MIN_DEPTH = 0.1
MAX_DEPTH = 10.0


class FrameObs(NamedTuple):
    """Fixed-size per-frame observation set (extractor output + depth).

    Replaces the reference's Frame/Feature objects (frame.h:16-64) with SoA
    arrays: ``depth`` holds the depth image sampled at each keypoint
    (rounded to nearest pixel, tracking.cpp:614-615), 0 where invalid.
    """

    px: jnp.ndarray      # [N,2] float32 keypoint pixels
    response: jnp.ndarray  # [N] float32
    desc: jnp.ndarray    # [N,32] uint8
    valid: jnp.ndarray   # [N] bool
    depth: jnp.ndarray   # [N] float32 meters (0 = missing)


def sample_depth_image(depth_img: jnp.ndarray, px: jnp.ndarray,
                       valid: jnp.ndarray) -> jnp.ndarray:
    """Depth at the rounded keypoint pixel (tracking.cpp:614-626); 0 where
    out of bounds or invalid."""
    H, W = depth_img.shape
    u = jnp.round(px[:, 0]).astype(jnp.int32)
    v = jnp.round(px[:, 1]).astype(jnp.int32)
    ok = valid & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    d = depth_img[jnp.clip(v, 0, H - 1), jnp.clip(u, 0, W - 1)]
    return jnp.where(ok, d, 0.0)


# ---------------------------------------------------------------------------
# feature quality gates (init path)
# ---------------------------------------------------------------------------

@jax.jit
def feature_distribution_ok(px: jnp.ndarray, valid: jnp.ndarray,
                            width: int, height: int) -> jnp.ndarray:
    """5x5 grid coverage >= 50% (reference CheckFeatureDistribution,
    tracking.cpp:93-118)."""
    gc = jnp.clip((px[:, 0] / width * 5).astype(jnp.int32), 0, 4)
    gr = jnp.clip((px[:, 1] / height * 5).astype(jnp.int32), 0, 4)
    cell = gc * 5 + gr
    hit = jnp.zeros((25,), bool).at[jnp.where(valid, cell, 25)].set(True, mode="drop")
    return jnp.sum(hit) >= 13  # ceil(25 * 0.5) — reference: >= 12.5


# ---------------------------------------------------------------------------
# matching + parallax
# ---------------------------------------------------------------------------

@jax.jit
def parallax_px(px_a: jnp.ndarray, px_b: jnp.ndarray, res: matching.MatchResult) -> jnp.ndarray:
    """Mean pixel displacement over matches (ComputeParallax,
    tracking.cpp:548-560 — pixels, not radians; the init gate compares this
    against a radian threshold, a reference quirk we reproduce)."""
    d = jnp.linalg.norm(px_a - px_b[res.idx], axis=-1)
    cnt = jnp.sum(res.valid)
    return jnp.where(cnt > 0, jnp.sum(jnp.where(res.valid, d, 0.0)) / cnt, 0.0)


# ---------------------------------------------------------------------------
# PnP correspondence gathering
# ---------------------------------------------------------------------------

@jax.jit
def pnp_correspondences(
    ms: MapState, kf_slot: jnp.ndarray, obs: FrameObs, res: matching.MatchResult
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Build 3D-2D pairs from keyframe features with landmarks
    (tracking.cpp:364-407). Row i refers to keyframe feature i (the match
    query); returns (pts3d [N,3], pts2d [N,2] current-frame pixels,
    valid [N])."""
    feat_lm = ms.kf_feat_lm[kf_slot]          # [N]
    has_lm = feat_lm >= 0                      # has_landmark && !is_outlier
    lm = jnp.clip(feat_lm, 0, ms.lm_physical - 1)
    p = ms.lm_pos[:, lm].T
    alive = ms.lm_alive[lm]
    finite = jnp.all(jnp.isfinite(p), axis=-1)
    in_range = jnp.all(jnp.abs(p) <= 1000.0, axis=-1)  # tracking.cpp:392
    pts2d = obs.px[res.idx]
    valid = res.valid & has_lm & alive & finite & in_range
    return p, pts2d, valid


# ---------------------------------------------------------------------------
# depth-backprojected landmark creation
# ---------------------------------------------------------------------------

@jax.jit
def depth_landmarks(
    ms: MapState,
    cam: CameraParams,
    kf_slot: jnp.ndarray,
    pose: Pose,  # T_cw of the keyframe
) -> MapState:
    """CreateLandmarksFromDepth (tracking.cpp:586-650) on an inserted
    keyframe slot: every valid feature without a landmark and with depth in
    [0.1, 10] m backprojects to a new world landmark; the slot's
    feature->landmark links are updated in place.

    The reference checks only ``has_landmark`` (tracking.cpp:610), so
    OUTLIER-flagged features are eligible again, and the new link clears
    the outlier flag (:646-648) — reproduced here.
    """
    px = ms.kf_px[kf_slot].T
    fvalid = ms.kf_fvalid[kf_slot]
    feat_lm = ms.kf_feat_lm[kf_slot]
    d = ms.kf_depth[kf_slot]
    want = fvalid & (feat_lm < 0) & (d >= MIN_DEPTH) & (d <= MAX_DEPTH)
    pc = backproject(cam, px, d)
    pw = se3_apply(se3_inverse(pose), pc)
    ms2, slots = msl.allocate_landmarks(ms, want, pw, obs_init=1)
    new_links = jnp.where(slots >= 0, slots, feat_lm)
    return ms2._replace(kf_feat_lm=ms2.kf_feat_lm.at[kf_slot].set(new_links))


# ---------------------------------------------------------------------------
# two-view triangulation
# ---------------------------------------------------------------------------

@jax.jit
def triangulable_count(
    cam: CameraParams,
    px_a: jnp.ndarray,        # [N,2] first-frame pixels (pose = identity)
    px_b: jnp.ndarray,        # [N,2] matched second-frame pixels
    valid: jnp.ndarray,       # [N] match mask
    pose_b: Pose,             # T_cw of the second frame
    min_angle_deg: float | jnp.ndarray,
    max_reproj: float | jnp.ndarray,
) -> jnp.ndarray:
    """How many matches would TRIANGULATE under triangulate_pair's angle +
    two-sided-reprojection gates (tracking.cpp:881-929), without touching
    the map. Drives the init viability gate (config min_init_landmarks):
    a near-pure-rotation init pair can carry a plausible recoverPose
    inlier count while almost no ray pair clears the angle gate."""
    pose_a = identity_pose()
    f_a = backproject(cam, px_a, jnp.ones_like(px_a[:, 0]))
    f_b = backproject(cam, px_b, jnp.ones_like(px_a[:, 0]))
    f_a = f_a / jnp.maximum(jnp.linalg.norm(f_a, axis=-1, keepdims=True), 1e-12)
    f_b = f_b / jnp.maximum(jnp.linalg.norm(f_b, axis=-1, keepdims=True), 1e-12)
    fw_a = quat_rotate(se3_inverse(pose_a).q, f_a)
    fw_b = quat_rotate(se3_inverse(pose_b).q, f_b)
    cos_ang = jnp.clip(jnp.sum(fw_a * fw_b, axis=-1), -1.0, 1.0)
    angle_ok = jnp.arccos(cos_ang) >= jnp.deg2rad(min_angle_deg)
    pw = triangulate_dlt(projection_matrix(cam, pose_a),
                         projection_matrix(cam, pose_b), px_a, px_b)
    finite = jnp.all(jnp.isfinite(pw), axis=-1)
    uv1, ok1, _ = project_pinhole(cam, pose_a, pw)
    uv2, ok2, _ = project_pinhole(cam, pose_b, pw)
    reproj_ok = (
        ok1 & ok2
        & (jnp.linalg.norm(uv1 - px_a, axis=-1) <= max_reproj)
        & (jnp.linalg.norm(uv2 - px_b, axis=-1) <= max_reproj)
    )
    return jnp.sum(valid & angle_ok & finite & reproj_ok).astype(jnp.int32)


def triangulate_pair(
    ms: MapState,
    cam: CameraParams,
    slot_a: jnp.ndarray,  # earlier keyframe (match query)
    slot_b: jnp.ndarray,  # newer keyframe (match train)
    min_angle_deg: float | jnp.ndarray,
    max_reproj: float | jnp.ndarray,
    res: matching.MatchResult | None = None,
) -> MapState:
    """TriangulateWithLastKeyFrame (tracking.cpp:856-929) between two
    keyframe slots: re-match descriptors (ratio test only — the reference
    does NOT apply the min-dist filter on this path), gate by triangulation
    angle and two-sided reprojection error, create landmarks and link both
    frames' features.

    ``res`` optionally supplies the precomputed knn2 ratio match between
    the two slots' descriptors (the scan's track stage already matched
    exactly this pair; re-matching costs a full Hamming GEMM)."""
    px_a, px_b = ms.kf_px[slot_a].T, ms.kf_px[slot_b].T
    if res is None:
        res = matching.knn2_ratio_match(
            ms.kf_desc[slot_a], ms.kf_fvalid[slot_a],
            ms.kf_desc[slot_b], ms.kf_fvalid[slot_b],
        )
    lm_a = ms.kf_feat_lm[slot_a]
    lm_b = ms.kf_feat_lm[slot_b]
    # neither side already has a landmark (has_landmark check only, :876-879)
    free = (lm_a < 0) & (lm_b[res.idx] < 0)

    pose_a = msl.map_pose(ms, slot_a)
    pose_b = msl.map_pose(ms, slot_b)

    # parallax-angle gate in world frame (:881-893)
    f_a = backproject(cam, px_a, jnp.ones_like(px_a[:, 0]))
    f_b = backproject(cam, px_b[res.idx], jnp.ones_like(px_a[:, 0]))
    f_a = f_a / jnp.maximum(jnp.linalg.norm(f_a, axis=-1, keepdims=True), 1e-12)
    f_b = f_b / jnp.maximum(jnp.linalg.norm(f_b, axis=-1, keepdims=True), 1e-12)
    qa_inv = se3_inverse(pose_a)
    qb_inv = se3_inverse(pose_b)
    fw_a = quat_rotate(qa_inv.q, f_a)
    fw_b = quat_rotate(qb_inv.q, f_b)
    cos_ang = jnp.clip(jnp.sum(fw_a * fw_b, axis=-1), -1.0, 1.0)
    angle_ok = jnp.arccos(cos_ang) >= jnp.deg2rad(min_angle_deg)

    P1 = projection_matrix(cam, pose_a)
    P2 = projection_matrix(cam, pose_b)
    pw = triangulate_dlt(P1, P2, px_a, px_b[res.idx])
    finite = jnp.all(jnp.isfinite(pw), axis=-1)

    uv1, ok1, _ = project_pinhole(cam, pose_a, pw)
    uv2, ok2, _ = project_pinhole(cam, pose_b, pw)
    err1 = jnp.linalg.norm(uv1 - px_a, axis=-1)
    err2 = jnp.linalg.norm(uv2 - px_b[res.idx], axis=-1)
    reproj_ok = ok1 & ok2 & (err1 <= max_reproj) & (err2 <= max_reproj)

    want = res.valid & free & angle_ok & finite & reproj_ok

    # dedupe the train side within the batch: the reference's sequential
    # has_landmark check (tracking.cpp:876-879) lets only the FIRST match
    # touching a train feature create a landmark; a batched `free` computed
    # from the pre-update table would let every query matching the same train
    # row allocate, and the losers (one real link but obs_init=2) could never
    # be reaped by compaction. Keep the best-(distance, query row) per train
    # feature via masked [N,N] segment-mins (chosen on the earlier accelerator,
    # where an [N] argsort cost far more than the dense mins; not yet measured
    # on the H100).
    N = ms.n_features
    eq = (res.idx[:, None] == jnp.arange(N, dtype=res.idx.dtype)[None, :])
    eq_w = eq & want[:, None]                         # [Nq, Nm]
    dist_c = jnp.minimum(res.dist, 511.0)
    best_d = jnp.min(jnp.where(eq_w, dist_c[:, None], jnp.inf), axis=0)
    tied = want & (dist_c == best_d[res.idx])
    rows = jnp.arange(N, dtype=jnp.int32)
    best_q = jnp.min(
        jnp.where(eq & tied[:, None], rows[:, None], N), axis=0
    )
    want = tied & (rows == best_q[res.idx])

    ms2, slots = msl.allocate_landmarks(ms, want, pw, obs_init=2)
    created = slots >= 0

    links_a = jnp.where(created, slots, lm_a)
    # train-side links: per train feature m, the created winner's slot id
    # (unique per m after dedupe) — a one-hot contraction, not a scatter
    eq_c = (eq & created[:, None]).astype(jnp.float32)
    val_m = jnp.einsum("qm,q->m", eq_c, (slots + 1).astype(jnp.float32))
    has_m = val_m > 0.5
    links_b = jnp.where(
        has_m, val_m.astype(jnp.int32) - 1, ms.kf_feat_lm[slot_b]
    )
    kf_feat_lm = ms2.kf_feat_lm.at[slot_a].set(links_a)
    kf_feat_lm = kf_feat_lm.at[slot_b].set(links_b)
    return ms2._replace(kf_feat_lm=kf_feat_lm)


# ---------------------------------------------------------------------------
# culling
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("min_obs",))
def cull_landmarks(
    ms: MapState,
    cam: CameraParams,
    max_reproj: float | jnp.ndarray,
    min_obs: int = 2,
) -> tuple[MapState, jnp.ndarray]:
    """CullLandmarks (tracking.cpp:652-750): kill landmarks with too few
    observations, zero measurable reprojections, any error > 2*threshold,
    or mean error > threshold. Returns (state, n_culled). The
    min_landmarks_for_culling gate is applied by the caller."""
    L = ms.lm_physical
    alive_kf = msl.kf_alive(ms)
    has = alive_kf[:, None] & ms.kf_fvalid & (ms.kf_feat_lm >= 0)
    lm = jnp.clip(ms.kf_feat_lm, 0, L - 1)
    pw = jnp.moveaxis(ms.lm_pos[:, lm], 0, -1)           # [K,N,3]
    pose = Pose(ms.kf_q[:, None, :], ms.kf_t[:, None, :])
    uv, ok, _ = project_pinhole(cam, pose, pw)
    err = jnp.linalg.norm(uv - jnp.swapaxes(ms.kf_px, 1, 2), axis=-1)
    measurable = has & ok                                 # ProjectToPixel fail -> skip

    # sorted packed segment reduction (unsorted scatters serialized on the
    # earlier accelerator, where this was designed; not yet measured on the
    # H100)
    flat = jnp.where(measurable, lm, L).reshape(-1)
    order = jnp.argsort(flat)
    sidx = flat[order]
    err_flat = jnp.where(measurable, err, 0.0).reshape(-1)[order]
    m_flat = measurable.reshape(-1).astype(jnp.float32)[order]
    packed = jnp.stack([err_flat, m_flat], axis=-1)
    table = jnp.zeros((L + 1, 2), jnp.float32).at[sidx].add(
        packed, indices_are_sorted=True, mode="drop"
    )
    err_sum = table[:L, 0]
    cnt = table[:L, 1]
    err_max = jnp.zeros((L + 1,), jnp.float32).at[sidx].max(
        err_flat, indices_are_sorted=True, mode="drop"
    )[:L]

    obs_count = msl.landmark_observation_counts(ms)
    mean_err = err_sum / jnp.maximum(cnt, 1)
    kill = ms.lm_alive & (
        (obs_count < min_obs)
        | (cnt == 0)
        | (err_max > 2.0 * max_reproj)
        | (mean_err > max_reproj)
    )
    return msl.remove_landmarks(ms, kill), jnp.sum(kill).astype(jnp.int32)


def cull_keyframes_device(
    ms: MapState,
    cam: CameraParams,
    last_kf_slot: jnp.ndarray,
    init_kf_slot: jnp.ndarray,
    current_frame_id: jnp.ndarray,
    *,
    min_keyframes_for_culling: int,
    max_keyframes: int,
    kf_min_shared_observations: int,
    kf_redundant_ratio: float,
    landmark_max_reproj_error: float,
    min_landmark_observations: int,
) -> MapState:
    """Device-side CullKeyFrames (tracking.cpp:775-840): remove at most ONE
    redundant keyframe — the first in ascending frame-id order, excluding
    the last keyframe, the init keyframe and the current frame — then cull
    landmarks again. Fully jittable for the fused scan pipeline."""
    n_kf = msl.n_keyframes(ms)
    ratio, total = keyframe_redundancy(
        ms, jnp.asarray(kf_min_shared_observations)
    )
    exceeded = (max_keyframes > 0) & (n_kf > max_keyframes)
    eligible = (
        msl.kf_alive(ms)
        & (total > 0)
        & (jnp.arange(ms.kf_capacity) != last_kf_slot)
        & (jnp.arange(ms.kf_capacity) != init_kf_slot)
        & (ms.kf_id != current_frame_id.astype(jnp.int32))
        & (ratio > kf_redundant_ratio)
        & (exceeded | (ratio > 0.95))
    )
    # first eligible in ascending frame-id order
    ids = jnp.where(eligible, ms.kf_id, jnp.iinfo(jnp.int32).max)
    slot = jnp.argmin(ids)
    do_cull = (n_kf > min_keyframes_for_culling) & jnp.any(eligible)

    def cull(ms):
        ms2 = msl.remove_keyframe_slot(ms, slot)
        ms2, _ = cull_landmarks(
            ms2, cam, landmark_max_reproj_error, min_landmark_observations
        )
        return ms2

    return jax.lax.cond(do_cull, cull, lambda m: m, ms)


@jax.jit
def keyframe_redundancy(
    ms: MapState, min_shared: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-keyframe redundancy ratio (CullKeyFrames, tracking.cpp:775-832):
    fraction of a keyframe's landmark-bearing features whose landmark is
    observed by >= min_shared keyframes. Returns (ratio [K], total [K])."""
    obs_count = msl.landmark_observation_counts(ms)
    has = msl.kf_alive(ms)[:, None] & ms.kf_fvalid & (ms.kf_feat_lm >= 0)
    lm = jnp.clip(ms.kf_feat_lm, 0, ms.lm_physical - 1)
    alive_lm = ms.lm_alive[lm]
    total = jnp.sum(has, axis=1)
    redundant = jnp.sum(has & alive_lm & (obs_count[lm] >= min_shared), axis=1)
    ratio = redundant / jnp.maximum(total, 1)
    return ratio, total
