"""Fully-fused on-device SLAM: the whole sequence as ONE ``lax.scan``.

This is the performance-critical realization of the SURVEY.md north star
("the inherently sequential track->match->optimize loop restructured into a
keyframe-windowed lax.scan so pose estimation, triangulation and local BA
all stay on device"). The host uploads the image/depth stacks once and
receives per-frame poses + stats once; NO host round trip happens inside
the loop, so no host sync sits between frames.

The scan body reproduces the reference state machine
(core/frontend/tracking.cpp) with device control flow:

- the INIT / TRACKING_GOOD / TRACKING_BAD / LOST dispatch is a
  ``lax.switch`` on an int32 state code;
- two-frame initialization, PnP-first tracking with an essential-matrix
  fallback (entered via ``lax.cond`` so the fallback only costs cycles
  when PnP fails), keyframe creation, culling and windowed BA are
  conditional branches over the same fixed-shape MapState;
- BAD/LOST recovery clears the map via mask resets (the reference's
  ``map_->removeAll()``, tracking.cpp:477-499) and re-enters INIT.

Semantics match the host frontend (``frontend.py``) — both share the same
stage functions; the host frontend remains the step-by-step/debug path,
this is the fast path used by the benchmark.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models import matching
from ..models.estimation import (
    essential_ransac,
    essential_scale_from_depth,
    pnp_prior,
    pnp_ransac,
)
from ..models.local_ba import BAOptions, local_ba
from ..models.orb_jax import orb_extract
from ..ops.camera import CameraParams, backproject, project_pinhole
from ..ops.se3 import Pose, identity_pose, matrix_to_quat, se3_compose, se3_matrix
from ..utils.config import TrackingOptions
from . import mapstate as msl
from . import stages
from .mapstate import FREE, MapState
from .stages import FrameObs

# state machine codes (reference tracking.h:22)
INIT, GOOD, BAD, LOST = 0, 1, 2, 3

DEG1_RAD = 0.017453292519943295  # the reference's 1-degree constant


class ScanState(NamedTuple):
    ms: MapState
    tstate: jnp.ndarray        # int32 state code
    have_init: jnp.ndarray     # bool: first init frame stored
    init_obs: FrameObs
    init_frame_id: jnp.ndarray
    init_kf_slot: jnp.ndarray
    last_obs: FrameObs
    last_pose: Pose
    cur_pose: Pose
    last_kf_slot: jnp.ndarray  # int32 (-1 = none)
    last_kf_id: jnp.ndarray
    last_inliers: jnp.ndarray
    last_parallax: jnp.ndarray
    # ---- reference-keyframe caches (pure derived data, refreshed at the
    # map-mutation points: init accept / keyframe event / reset). The
    # steady-state frame chain is latency-bound small ops, so everything
    # that depends only on (map, last_kf_slot) is hoisted out of it:
    # descriptor bit planes + popcounts (the matcher starts at the GEMM),
    # the landmark-linked 3D points with their validity gates
    # (pnp_correspondences reduced to a mask-AND), and the keyframe's
    # pixels (parallax). Bit-identical to re-deriving per frame. ----
    kf_bits: jnp.ndarray       # [N,256] int8 keyframe descriptor bit planes
    kf_pop: jnp.ndarray        # [N] f32 keyframe descriptor popcounts
    kf_fvalid: jnp.ndarray     # [N] bool keyframe feature validity
    kf_lm_pts: jnp.ndarray     # [N,3] f32 landmark position per feature
    kf_lm_valid: jnp.ndarray   # [N] bool feature has a live, sane landmark
    kf_px2: jnp.ndarray        # [N,2] f32 keyframe feature pixels


class FrameOut(NamedTuple):
    pose: jnp.ndarray       # [4,4] T_cw (identity when untracked)
    tracked: jnp.ndarray    # bool — pose valid this frame
    state: jnp.ndarray      # int32 state AFTER the frame
    n_matches: jnp.ndarray
    n_inliers: jnp.ndarray
    parallax: jnp.ndarray
    is_keyframe: jnp.ndarray
    n_keyframes: jnp.ndarray
    n_landmarks: jnp.ndarray


def _empty_obs(n: int) -> FrameObs:
    return FrameObs(
        px=jnp.zeros((n, 2), jnp.float32),
        response=jnp.zeros((n,), jnp.float32),
        desc=jnp.zeros((n, 32), jnp.uint8),
        valid=jnp.zeros((n,), bool),
        depth=jnp.zeros((n,), jnp.float32),
    )


def _empty_match(n: int) -> matching.MatchResult:
    return matching.MatchResult(
        idx=jnp.zeros((n,), jnp.int32),
        dist=jnp.full((n,), 1e9, jnp.float32),
        valid=jnp.zeros((n,), bool),
    )


def _clear_map(ms: MapState) -> MapState:
    """map_->removeAll() (map.cpp:40-47) as mask resets."""
    return ms._replace(
        kf_id=jnp.full_like(ms.kf_id, -1),
        kf_fvalid=jnp.zeros_like(ms.kf_fvalid),
        kf_feat_lm=jnp.full_like(ms.kf_feat_lm, FREE),
        lm_alive=jnp.zeros_like(ms.lm_alive),
        lm_obs=jnp.zeros_like(ms.lm_obs),
        next_kf=jnp.zeros_like(ms.next_kf),
        next_lm=jnp.zeros_like(ms.next_lm),
        lm_dropped=jnp.zeros_like(ms.lm_dropped),
    )


def _select(pred, a, b):
    return jax.tree.map(lambda x, y: jnp.where(pred, x, y), a, b)


def _kf_cache_fields(ms: MapState, slot: jnp.ndarray) -> dict:
    """Derive the reference-keyframe carry caches from the map (see
    ScanState): descriptor bit planes/popcounts, per-feature landmark
    points with the pnp_correspondences validity gates
    (tracking.cpp:364-407: has_landmark, alive, finite, |p| <= 1000), and
    the keyframe pixels."""
    bits, pop = matching.unpack_with_pop(ms.kf_desc[slot])
    feat_lm = ms.kf_feat_lm[slot]
    has = feat_lm >= 0
    lmc = jnp.clip(feat_lm, 0, ms.lm_physical - 1)
    p = ms.lm_pos[:, lmc].T
    lm_valid = (
        has & ms.lm_alive[lmc]
        & jnp.all(jnp.isfinite(p), axis=-1)
        & jnp.all(jnp.abs(p) <= 1000.0, axis=-1)
    )
    return dict(
        kf_bits=bits,
        kf_pop=pop,
        kf_fvalid=ms.kf_fvalid[slot],
        kf_lm_pts=jnp.where(lm_valid[:, None], p, 0.0),
        kf_lm_valid=lm_valid,
        kf_px2=ms.kf_px[slot].T,
    )


def _empty_kf_cache(n: int) -> dict:
    return dict(
        kf_bits=jnp.zeros((n, 256), jnp.int8),
        kf_pop=jnp.zeros((n,), jnp.float32),
        kf_fvalid=jnp.zeros((n,), bool),
        kf_lm_pts=jnp.zeros((n, 3), jnp.float32),
        kf_lm_valid=jnp.zeros((n,), bool),
        kf_px2=jnp.zeros((n, 2), jnp.float32),
    )


def build_scan_step(
    cam: CameraParams,
    opts: TrackingOptions,
    img_wh: tuple[int, int],
    *,
    n_features_cap: int = 1024,
    kf_capacity: int = 64,
    lm_capacity: int = 1 << 17,
    orb_kwargs: dict | None = None,
    stage_limit: int = 2,
    batched: bool = False,
):
    """Build the per-frame scan body, closed over static options.

    ``stage_limit`` is a profiling knob: 0 = extraction only, 1 =
    extraction + tracking (state machine and map growth disabled),
    2 = the full pipeline. ``batched`` marks that the step will run under
    a lane vmap (keeps data-dependent early exits out of the body).
    """
    orb_kwargs = dict(orb_kwargs or {})
    orb_kwargs.setdefault("n_slots", n_features_cap)
    W_IMG, H_IMG = img_wh

    ba_opts = BAOptions(
        window_size=opts.ba_window_size,
        max_iterations=opts.ba_iterations,
        min_pose_observations=opts.ba_min_pose_observations,
        min_point_observations=opts.ba_min_point_observations,
        huber_delta=opts.ba_huber_delta,
        max_reproj_error=opts.ba_max_reproj_error,
        rel_tol=opts.ba_rel_tol,
        # the scan body is not vmapped (config 1 is single-stream), so the
        # reference's convergence break genuinely skips iterations here;
        # the batched variant vmaps the step, where while_loop would run
        # to the lane max anyway — keep the masked scan there
        early_exit=not batched,
    )

    def mat_pose(R, t):
        return Pose(matrix_to_quat(R), t)

    # ------------------------------------------------------------------
    def track_branch(st: ScanState, obs, bits, pop, frame_id, k1, k2):
        """TRACKING_GOOD: PnP vs last keyframe; essential fallback entered
        only when PnP fails (tracking.cpp:267-330).

        Returns the RAW knn2 ratio match (pre distance-filter) alongside
        the tracking result: a keyframe event this frame triangulates
        exactly this (keyframe, current) pair, and the reference's
        TriangulateWithLastKeyFrame re-matches WITHOUT the min-dist filter
        (tracking.cpp:856-874) — so the raw match is reusable as-is and
        the event saves a full Hamming GEMM.

        The keyframe side comes entirely from the ScanState caches
        (bit planes, landmark table gathers, pixels) and the current
        frame's bit planes from the batched pre-extraction — the serial
        chain starts at the Hamming GEMM and the correspondence step is a
        mask-AND (pnp_correspondences semantics, tracking.cpp:364-407,
        precomputed at the last map mutation)."""
        m_raw = matching.knn2_from_bits(
            st.kf_bits, st.kf_pop, st.kf_fvalid, bits, pop, obs.valid
        )
        m = matching.reference_distance_filter(m_raw)
        n_matches = jnp.sum(m.valid).astype(jnp.int32)
        pts3d = st.kf_lm_pts
        pts2d = obs.px[m.idx]
        pvalid = m.valid & st.kf_lm_valid
        n_pairs = jnp.sum(pvalid).astype(jnp.int32)
        depth_curr = obs.depth[m.idx] if opts.pnp_use_depth else None

        # two-tier PnP, prior-first: in steady state the motion-prior IRLS
        # hypothesis wins pnp_ransac's consensus almost always
        # (utils/config.py calibration note), so tier 0 runs ONLY that
        # hypothesis (pnp_prior: IRLS from the previous pose + inlier-set
        # refine) and the full blind-budget hypothesis fan is ESCALATED to
        # under lax.cond only when the prior-only consensus is weak —
        # below 2x min_inliers or 30% of the candidate pairs, the regime
        # where recovery is hypothesis-bound. In the non-vmapped scan the
        # cond branch costs nothing unless taken, so steady-state frames
        # skip the sampling/minimal-solver/polish pipeline entirely while
        # hard frames get the full recovery budget.
        if batched:
            # under the lane vmap a cond becomes a select (every lane pays
            # both tiers): keep the flat configured budget there
            sol = pnp_ransac(
                cam, pts3d, pts2d, pvalid, k1, opts.max_reproj_error,
                n_hypotheses=opts.pnp_hypotheses,
                refine_iters=opts.pnp_refine_iters,
                init_pose=st.cur_pose, depth_curr=depth_curr,
            )
        else:
            sol = pnp_prior(
                cam, pts3d, pts2d, pvalid, st.cur_pose,
                opts.max_reproj_error,
                refine_iters=min(2, opts.pnp_refine_iters),
            )
            weak = sol.n_inliers < jnp.maximum(
                2 * opts.min_inliers, (3 * n_pairs) // 10
            )

            def escalate(_):
                return pnp_ransac(
                    cam, pts3d, pts2d, pvalid, k1, opts.max_reproj_error,
                    n_hypotheses=max(64, opts.pnp_hypotheses),
                    refine_iters=max(6, opts.pnp_refine_iters),
                    init_pose=st.cur_pose, depth_curr=depth_curr,
                )

            sol = jax.lax.cond(weak, escalate, lambda _: sol, None)
        pnp_ok = (
            (n_matches >= opts.min_matches)
            & (n_pairs >= opts.min_inliers)
            & sol.ok
            & (sol.n_inliers >= opts.min_inliers)
            & jnp.all(jnp.isfinite(sol.pose.q))
            & jnp.all(jnp.isfinite(sol.pose.t))
        )

        def pnp_result(_):
            par = stages.parallax_px(st.kf_px2, obs.px, m)
            return sol.pose, sol.n_inliers, par, n_matches, jnp.asarray(True)

        def fallback(_):
            mf = matching.match_frames(
                st.last_obs.desc, st.last_obs.valid, obs.desc, obs.valid
            )
            nf = jnp.sum(mf.valid).astype(jnp.int32)
            ess = essential_ransac(
                cam, st.last_obs.px, obs.px[mf.idx], mf.valid, k2
            )
            t_rel = ess.t
            if opts.fallback_scale_from_depth:
                t_rel = ess.t * essential_scale_from_depth(
                    cam, ess, st.last_obs.px, obs.px[mf.idx], st.last_obs.depth
                )
            pose_fb = se3_compose(mat_pose(ess.R, t_rel), st.last_pose)
            par = stages.parallax_px(st.last_obs.px, obs.px, mf)
            ok = (nf >= opts.min_matches) & ess.ok & (
                ess.n_inliers >= opts.min_inliers
            )
            return pose_fb, ess.n_inliers, par, nf, ok

        pose, inliers, parallax, n_matches_out, ok = jax.lax.cond(
            pnp_ok, pnp_result, fallback, None
        )

        st = st._replace(
            cur_pose=_select(ok, pose, st.cur_pose),
            last_inliers=jnp.where(ok, inliers, st.last_inliers),
            last_parallax=jnp.where(ok, parallax, st.last_parallax),
        )
        return st, n_matches_out, inliers, parallax, ok, m_raw

    # ------------------------------------------------------------------
    def init_first(st: ScanState, obs, frame_id, gray_mean, gray_std, k1, k2):
        """InitWithFirstFrame (tracking.cpp:177-204)."""
        n = jnp.sum(obs.valid)
        dist_ok = stages.feature_distribution_ok(obs.px, obs.valid, W_IMG, H_IMG)
        quality_ok = (gray_mean >= 30) & (gray_mean <= 225) & (gray_std >= 20)
        ok = (n >= opts.min_matches) & dist_ok & quality_ok

        st = jax.lax.cond(
            ok,
            lambda s: s._replace(
                have_init=jnp.asarray(True),
                init_obs=obs,
                init_frame_id=frame_id.astype(jnp.int32),
                cur_pose=identity_pose(),
            ),
            lambda s: s,
            st,
        )
        return (st, jnp.int32(0), jnp.int32(0), jnp.float32(0), ok,
                _empty_match(n_features_cap))

    # ------------------------------------------------------------------
    def init_second(st: ScanState, obs, frame_id, gray_mean, gray_std, k1, k2):
        """InitWithSecondFrame (tracking.cpp:206-263), with the RGB-D PnP
        init extension and the reference's pixel/radian parallax quirk."""
        m_raw = matching.knn2_ratio_match(
            st.init_obs.desc, st.init_obs.valid, obs.desc, obs.valid
        )
        m = matching.reference_distance_filter(m_raw)
        n_matches = jnp.sum(m.valid).astype(jnp.int32)
        parallax = stages.parallax_px(st.init_obs.px, obs.px, m)

        if opts.rgbd_init:
            d = st.init_obs.depth
            good_d = (d >= stages.MIN_DEPTH) & (d <= stages.MAX_DEPTH)
            pw = backproject(cam, st.init_obs.px, d)
            pvalid = m.valid & good_d
            # init runs BLIND (identity prior, possibly large baseline)
            # and only twice per sequence + after map wipes, so it keeps
            # the full 64-hypothesis budget regardless of the calibrated
            # steady-state pnp_hypotheses (whose safety argument is the
            # motion-prior hypothesis, absent here)
            sol = pnp_ransac(
                cam, pw, obs.px[m.idx], pvalid, k1, opts.max_reproj_error,
                n_hypotheses=max(64, opts.pnp_hypotheses),
                refine_iters=max(6, opts.pnp_refine_iters),
                init_pose=identity_pose(),
                depth_curr=obs.depth[m.idx] if opts.pnp_use_depth else None,
            )
            pnp_ok = (
                (jnp.sum(pvalid) >= opts.min_inliers)
                & sol.ok
                & (sol.n_inliers >= opts.min_inliers)
            )
        else:
            sol = None
            pnp_ok = jnp.asarray(False)

        ess = essential_ransac(cam, st.init_obs.px, obs.px[m.idx], m.valid, k2)
        t_init = ess.t
        if opts.init_scale_from_depth:
            t_init = ess.t * essential_scale_from_depth(
                cam, ess, st.init_obs.px, obs.px[m.idx], st.init_obs.depth
            )
        ess_ok = ess.ok & (ess.n_inliers >= opts.min_inliers)

        pose_e = mat_pose(ess.R, t_init)
        if opts.min_init_landmarks > 0:
            # init viability gate (extension, config.py min_init_landmarks):
            # accept the essential init only if the pair would actually
            # populate a map under the triangulation gates
            n_tri = stages.triangulable_count(
                cam, st.init_obs.px, obs.px[m_raw.idx], m_raw.valid, pose_e,
                opts.triangulation_min_angle_deg,
                opts.triangulation_max_reproj_error,
            )
            ess_ok = ess_ok & (n_tri >= opts.min_init_landmarks)
        if opts.rgbd_init:
            pose2 = _select(pnp_ok, sol.pose, pose_e)
            inliers = jnp.where(pnp_ok, sol.n_inliers, ess.n_inliers)
        else:
            pose2 = pose_e
            inliers = ess.n_inliers

        ok = (
            (n_matches >= opts.min_matches)
            & (pnp_ok | ess_ok)
            & (parallax >= DEG1_RAD)  # reference quirk: pixels vs radians
        )

        def accept(st):
            ms = st.ms
            ms, slot1 = msl.insert_keyframe(
                ms, st.init_frame_id, identity_pose(),
                st.init_obs.px, st.init_obs.desc, st.init_obs.valid,
                jnp.full((n_features_cap,), FREE, jnp.int32), st.init_obs.depth,
                fresh_links=True,
            )
            ms, slot2 = msl.insert_keyframe(
                ms, frame_id.astype(jnp.int32), pose2,
                obs.px, obs.desc, obs.valid,
                jnp.full((n_features_cap,), FREE, jnp.int32), obs.depth,
                fresh_links=True,
            )
            ms = stages.depth_landmarks(ms, cam, slot1, identity_pose())
            ms = stages.depth_landmarks(ms, cam, slot2, pose2)
            ms = stages.triangulate_pair(
                ms, cam, slot1, slot2,
                opts.triangulation_min_angle_deg,
                opts.triangulation_max_reproj_error,
                res=m_raw,  # this exact pair was just matched above
            )
            return st._replace(
                ms=ms,
                init_kf_slot=slot1.astype(jnp.int32),
                last_kf_slot=slot2.astype(jnp.int32),
                last_kf_id=frame_id.astype(jnp.int32),
                cur_pose=pose2,
                last_obs=obs,
                last_pose=pose2,
                last_inliers=inliers,
                last_parallax=parallax,
                **_kf_cache_fields(ms, slot2),
            )

        st = jax.lax.cond(ok, accept, lambda s: s, st)
        return st, n_matches, inliers, parallax, ok, m_raw

    # ------------------------------------------------------------------
    def create_keyframe(st: ScanState, obs, frame_id, kf_match=None):
        """CreateKeyFrame + culling + local BA (tracking.cpp:76-85, 577-584).

        ``kf_match``: the raw knn2 match (prev keyframe -> current obs)
        already computed by this frame's track stage; passing it saves the
        triangulation re-match (a full Hamming GEMM) on every event."""
        ms = st.ms
        # recycle dead landmark slots before the allocator runs dry (long
        # sequences: ring-evicted keyframes leave most of the table dead)
        ms = jax.lax.cond(
            ms.next_lm > lm_capacity - 3 * n_features_cap,
            msl.compact_landmarks, lambda m: m, ms,
        )
        prev_slot = jnp.maximum(st.last_kf_slot, 0)
        if opts.link_tracked_landmarks and kf_match is not None:
            # ORB-SLAM-style association (extension, config.py
            # link_tracked_landmarks): before inserting, the new keyframe's
            # features inherit the landmarks of the PREVIOUS keyframe
            # features they matched, reprojection-gated against the current
            # pose — without this (the reference's structure) a monocular
            # keyframe's links come solely from fresh triangulation and the
            # next PnP starves.
            prev_lm = ms.kf_feat_lm[prev_slot]                    # [Nq]
            lmc = jnp.clip(prev_lm, 0, ms.lm_pos.shape[1] - 1)
            pw = ms.lm_pos[:, lmc].T                              # [Nq,3]
            uv, okp, _ = project_pinhole(cam, st.cur_pose, pw)
            err = jnp.linalg.norm(uv - obs.px[kf_match.idx], axis=-1)
            good = (
                kf_match.valid & (prev_lm >= 0) & ms.lm_alive[lmc]
                & obs.valid[kf_match.idx] & okp
                & (err <= opts.max_reproj_error)
            )
            # scatter-max dedupes duplicate train rows (FREE = -1 loses to
            # any real landmark id)
            links = jnp.full((n_features_cap,), FREE, jnp.int32).at[
                kf_match.idx].max(jnp.where(good, lmc, FREE))
        else:
            links = jnp.full((n_features_cap,), FREE, jnp.int32)
        with jax.named_scope("kf_insert"):
            ms, slot = msl.insert_keyframe(
            ms, frame_id.astype(jnp.int32), st.cur_pose,
            obs.px, obs.desc, obs.valid,
            links, obs.depth,
            fresh_links=not (opts.link_tracked_landmarks
                             and kf_match is not None),
        )
        ms = stages.depth_landmarks(ms, cam, slot, st.cur_pose)
        ms = stages.triangulate_pair(
            ms, cam, prev_slot, slot,
            opts.triangulation_min_angle_deg,
            opts.triangulation_max_reproj_error,
            res=kf_match,
        )
        if opts.enable_culling:
            def cull(ms):
                ms2, _ = stages.cull_landmarks(
                    ms, cam, opts.landmark_max_reproj_error,
                    opts.min_landmark_observations,
                )
                return ms2

            ms = jax.lax.cond(
                msl.n_landmarks(ms) >= opts.min_landmarks_for_culling,
                cull, lambda m: m, ms,
            )
            ms = stages.cull_keyframes_device(
                ms, cam, slot, st.init_kf_slot, frame_id.astype(jnp.int32),
                min_keyframes_for_culling=opts.min_keyframes_for_culling,
                max_keyframes=opts.max_keyframes,
                kf_min_shared_observations=opts.kf_min_shared_observations,
                kf_redundant_ratio=opts.kf_redundant_ratio,
                landmark_max_reproj_error=opts.landmark_max_reproj_error,
                min_landmark_observations=opts.min_landmark_observations,
            )
        if opts.enable_local_ba:
            ms, _ = local_ba(ms, cam, ba_opts)
        new_pose = msl.map_pose(ms, slot)
        return st._replace(
            ms=ms,
            last_kf_slot=slot.astype(jnp.int32),
            last_kf_id=frame_id.astype(jnp.int32),
            cur_pose=new_pose,
            # refresh the reference-keyframe caches AFTER culling + BA so
            # they reflect the landmark positions/links the next frames
            # will PnP against
            **_kf_cache_fields(ms, slot),
        )

    # ------------------------------------------------------------------
    def step(st: ScanState, inp):
        """Scan body over PRE-EXTRACTED per-frame observations.

        Extraction depends only on the image — never on tracking state —
        so it is hoisted out of the serial chain and batched over all
        frames ahead of the scan (``extract_sequence``): semantically
        identical to the reference's in-loop extract (tracking.cpp:42),
        but the scan body now starts at the matcher, which roughly halves
        the serial per-frame critical path."""
        frame_id, obs, bits, pop, gray_mean, gray_std, k12 = inp
        # per-frame keys are precomputed OUTSIDE the scan (frame_keys):
        # bit-identical to fold_in+split here, but the two threefry
        # derivations leave the serial per-frame chain
        k1, k2 = k12[0], k12[1]
        fvalid = obs.valid

        if stage_limit == 0:  # profiling: extraction only
            out = FrameOut(
                pose=se3_matrix(st.cur_pose),
                tracked=jnp.any(fvalid),
                state=st.tstate,
                n_matches=jnp.sum(fvalid).astype(jnp.int32),
                n_inliers=jnp.int32(0), parallax=jnp.float32(0),
                is_keyframe=jnp.asarray(False),
                n_keyframes=jnp.int32(0), n_landmarks=jnp.int32(0),
            )
            return st, out
        if stage_limit == 1:  # profiling: extraction + tracking compute
            st2, n_matches, inliers, parallax, ok, _ = track_branch(
                st, obs, bits, pop, frame_id, k1, k2
            )
            out = FrameOut(
                pose=se3_matrix(st2.cur_pose), tracked=ok, state=st.tstate,
                n_matches=n_matches, n_inliers=inliers, parallax=parallax,
                is_keyframe=jnp.asarray(False),
                n_keyframes=jnp.int32(0), n_landmarks=jnp.int32(0),
            )
            return st._replace(cur_pose=st2.cur_pose), out
        if stage_limit in (3, 4):  # profiling: fixed op-graph sub-chains
            # 3 = extraction + matcher; 4 = + prior-tier PnP. No conds, no
            # state machine: the map stays empty, so the CONTENT is
            # meaningless, but the op graph per frame is exactly the
            # steady-state chain's — this isolates its serial cost without
            # the empty-map escalation pollution of stage_limit=1.
            m_raw = matching.knn2_from_bits(
                st.kf_bits, st.kf_pop, st.kf_fvalid, bits, pop, obs.valid
            )
            m = matching.reference_distance_filter(m_raw)
            n_matches = jnp.sum(m.valid).astype(jnp.int32)
            inliers = jnp.int32(0)
            st2 = st
            if stage_limit == 4:
                sol = pnp_prior(
                    cam, st.kf_lm_pts, obs.px[m.idx],
                    m.valid & st.kf_lm_valid, st.cur_pose,
                    opts.max_reproj_error,
                    refine_iters=min(2, opts.pnp_refine_iters),
                )
                inliers = sol.n_inliers
                st2 = st._replace(cur_pose=_select(
                    sol.ok, sol.pose, st.cur_pose))
            out = FrameOut(
                pose=se3_matrix(st2.cur_pose), tracked=jnp.any(fvalid),
                state=st.tstate, n_matches=n_matches, n_inliers=inliers,
                parallax=jnp.float32(0), is_keyframe=jnp.asarray(False),
                n_keyframes=jnp.int32(0), n_landmarks=jnp.int32(0),
            )
            return st2, out

        def do_init(st):
            return jax.lax.cond(
                st.have_init,
                lambda s: init_second(s, obs, frame_id, gray_mean, gray_std, k1, k2),
                lambda s: init_first(s, obs, frame_id, gray_mean, gray_std, k1, k2),
                st,
            )

        def do_good(st):
            st2, n_matches, inliers, parallax, ok, m_raw = track_branch(
                st, obs, bits, pop, frame_id, k1, k2
            )
            # HandleTrackingFailure (tracking.cpp:467-475): GOOD -> BAD
            st2 = st2._replace(
                tstate=jnp.where(ok, st2.tstate, jnp.int32(BAD))
            )
            return st2, n_matches, inliers, parallax, ok, m_raw

        def do_reset(st):
            # HandleTrackingBad/Lost (tracking.cpp:477-499)
            st2 = st._replace(
                ms=_clear_map(st.ms),
                tstate=jnp.int32(INIT),
                have_init=jnp.asarray(False),
                init_kf_slot=jnp.int32(-1),
                last_kf_slot=jnp.int32(-1),
                last_kf_id=jnp.int32(-1),
                last_inliers=jnp.int32(0),
                last_parallax=jnp.float32(0),
                **_empty_kf_cache(n_features_cap),
            )
            return (st2, jnp.int32(0), jnp.int32(0), jnp.float32(0),
                    jnp.asarray(False), _empty_match(n_features_cap))

        was_state = st.tstate
        was_init_first = (was_state == INIT) & ~st.have_init
        was_init_second = (was_state == INIT) & st.have_init

        branch = jnp.where(was_state == INIT, 0,
                           jnp.where(was_state == GOOD, 1, 2))
        with jax.named_scope("state_dispatch"):
            st2, n_matches, inliers, parallax, step_ok, kf_match = (
                jax.lax.switch(branch, [do_init, do_good, do_reset], st)
            )

        just_initialized = was_init_second & step_ok
        tracked_now = ((was_state == GOOD) & step_ok) | just_initialized

        # ---------------- keyframe policy (tracking.cpp:562-575) ----------
        need_kf = (
            (was_state == GOOD) & step_ok
            & (st2.last_kf_slot >= 0)
            & (st2.last_inliers >= opts.min_keyframe_inliers)
            & (st2.last_parallax >= opts.min_parallax)
            & ((frame_id.astype(jnp.int32) - st2.last_kf_id)
               >= opts.min_keyframe_gap)
        )
        with jax.named_scope("keyframe_event"):
            st3 = jax.lax.cond(
                need_kf,
                lambda s: create_keyframe(s, obs, frame_id, kf_match),
                lambda s: s,
                st2,
            )

        # ---------------- post-frame state update (tracking.cpp:87-88) ----
        new_tstate = jnp.where(
            tracked_now,
            jnp.where(st3.last_inliers >= opts.min_inliers,
                      jnp.int32(GOOD), jnp.int32(BAD)),
            st3.tstate,
        )
        st4 = st3._replace(
            tstate=new_tstate,
            last_obs=_select(tracked_now, obs, st3.last_obs),
            last_pose=_select(tracked_now, st3.cur_pose, st3.last_pose),
        )

        reports_pose = tracked_now | (was_init_first & step_ok)
        out = FrameOut(
            pose=se3_matrix(st4.cur_pose),
            tracked=reports_pose,
            state=st4.tstate,
            n_matches=n_matches,
            n_inliers=inliers,
            parallax=parallax,
            is_keyframe=need_kf | just_initialized,
            n_keyframes=msl.n_keyframes(st4.ms),
            n_landmarks=msl.n_landmarks(st4.ms),
        )
        return st4, out

    return step


def initial_state(n_features_cap=1024, kf_capacity=64, lm_capacity=1 << 17) -> ScanState:
    return ScanState(
        ms=msl.empty_map(kf_capacity, lm_capacity, n_features_cap),
        tstate=jnp.int32(INIT),
        have_init=jnp.asarray(False),
        init_obs=_empty_obs(n_features_cap),
        init_frame_id=jnp.int32(-1),
        init_kf_slot=jnp.int32(-1),
        last_obs=_empty_obs(n_features_cap),
        last_pose=identity_pose(),
        cur_pose=identity_pose(),
        last_kf_slot=jnp.int32(-1),
        last_kf_id=jnp.int32(-1),
        last_inliers=jnp.int32(0),
        last_parallax=jnp.float32(0),
        **_empty_kf_cache(n_features_cap),
    )


def resume_state(ms: MapState) -> ScanState:
    """Rebuild a ScanState from a restored MapState snapshot so a run can
    CONTINUE a sequence (SURVEY.md §5.4 — the checkpoint/resume subsystem
    the reference lacks entirely; its map lives only in RAM, map.h:30-33).

    The newest alive keyframe becomes the reference keyframe: tracking
    resumes in TRACKING_GOOD via PnP against its landmarks, exactly where
    the snapshotted run left off. ``last_obs`` is reconstructed from the
    keyframe tables (responses are not stored — they are unused after
    extraction). An empty snapshot resumes in INIT.
    """
    n = ms.n_features
    alive = msl.kf_alive(ms)
    have = jnp.any(alive)
    ids = jnp.where(alive, ms.kf_id, -1)
    slot = jnp.argmax(ids).astype(jnp.int32)
    ids_min = jnp.where(alive, ms.kf_id, jnp.iinfo(jnp.int32).max)
    init_slot = jnp.argmin(ids_min).astype(jnp.int32)
    pose = msl.map_pose(ms, slot)
    obs = FrameObs(
        px=ms.kf_px[slot].T,
        response=jnp.zeros((n,), jnp.float32),
        desc=ms.kf_desc[slot],
        valid=ms.kf_fvalid[slot],
        depth=ms.kf_depth[slot],
    )
    st = initial_state(n, ms.kf_capacity, ms.lm_capacity)
    cache = jax.tree.map(
        lambda live, empty: jnp.where(
            have.reshape((1,) * live.ndim), live, empty),
        _kf_cache_fields(ms, slot), _empty_kf_cache(n),
    )
    return st._replace(
        ms=ms,
        tstate=jnp.where(have, jnp.int32(GOOD), jnp.int32(INIT)),
        last_obs=obs,
        last_pose=pose,
        # distinct buffers: the scan donates its input state, and XLA
        # rejects donating the same buffer twice (last_pose aliasing
        # cur_pose would do exactly that)
        cur_pose=Pose(pose.q.copy(), pose.t.copy()),
        init_kf_slot=jnp.where(have, init_slot, jnp.int32(-1)),
        last_kf_slot=jnp.where(have, slot, jnp.int32(-1)),
        last_kf_id=jnp.where(have, ids[slot], jnp.int32(-1)).astype(jnp.int32),
        **cache,
    )


def extract_sequence(images_u8, depths_m, orb_kwargs, chunk: int = 8):
    """Batched pre-extraction for the scan pipeline: ORB + feature-depth +
    image-quality stats over ALL frames, vmapped in ``chunk``-size
    ``lax.map`` chunks (bounds peak memory; same pattern as the offline
    pipeline's stage 1). Returns (FrameObs [T,...], mean [T], std [T])."""
    T = images_u8.shape[0]
    H, W = images_u8.shape[1:]
    Tc = -(-T // chunk) * chunk

    def pad(x):
        p = Tc - T
        if p == 0:
            return x
        return jnp.concatenate([x, jnp.repeat(x[-1:], p, axis=0)])

    gi = pad(images_u8).reshape(Tc // chunk, chunk, H, W)
    di = pad(depths_m).reshape(Tc // chunk, chunk, H, W)

    def one(args):
        g, d = args
        px, resp, desc, valid = jax.vmap(
            lambda im: orb_extract(im, **orb_kwargs)
        )(g)
        dfeat = jax.vmap(stages.sample_depth_image)(d, px, valid)
        gf = g.astype(jnp.float32)
        mean = jnp.mean(gf, axis=(1, 2))
        # std via moments (vmapped jnp.std materializes a centered copy)
        std = jnp.sqrt(jnp.maximum(
            jnp.mean(gf * gf, axis=(1, 2)) - mean * mean, 0.0))
        # descriptor bit planes + popcounts, batched here so the scan's
        # serial matcher starts at the GEMM (see ScanState caches)
        bits, pop = matching.unpack_with_pop(desc)
        return px, resp, desc, valid, dfeat, mean, std, bits, pop

    px, resp, desc, valid, dfeat, mean, std, bits, pop = jax.lax.map(
        one, (gi, di))

    def unc(x):
        return x.reshape((Tc,) + x.shape[2:])[:T]

    obs = FrameObs(px=unc(px), response=unc(resp), desc=unc(desc),
                   valid=unc(valid), depth=unc(dfeat))
    return obs, unc(mean), unc(std), unc(bits), unc(pop)



def frame_keys(frame_ids):
    """Per-frame (k1, k2) PRNG keys, [T,2,2] uint32 — bit-identical to the
    in-body ``split(fold_in(PRNGKey(17), frame_id))`` the scan body used to
    derive serially; hoisting the two threefry calls out of the scan takes
    them off the per-frame critical path."""
    base = jax.random.PRNGKey(17)
    return jax.vmap(lambda fid: jax.random.split(jax.random.fold_in(base, fid)))(
        frame_ids
    )


@lru_cache(maxsize=8)
def _compiled_scan(opts_key, img_wh, n_features_cap, kf_capacity, lm_capacity,
                   orb_kwargs_tuple, stage_limit=2, batched=False):
    opts = TrackingOptions(**dict(opts_key))
    orb_kw = dict(orb_kwargs_tuple)
    orb_kw.setdefault("n_slots", n_features_cap)

    if not batched:
        def run(cam, st0, frame0, images_u8, depths_m):
            T = images_u8.shape[0]
            step = build_scan_step(
                cam, opts, img_wh,
                n_features_cap=n_features_cap,
                kf_capacity=kf_capacity,
                lm_capacity=lm_capacity,
                orb_kwargs=orb_kw,
                stage_limit=stage_limit,
            )
            obs, mean, std, bits, pop = extract_sequence(
                images_u8, depths_m, orb_kw)
            frame_ids = frame0 + jnp.arange(T, dtype=jnp.int32)
            return jax.lax.scan(
                step, st0,
                (frame_ids, obs, bits, pop, mean, std, frame_keys(frame_ids)),
            )

        return jax.jit(run, donate_argnums=(1,))

    def run_batched(cam, images_u8, depths_m):
        """Batched throughput mode (BASELINE config 5 on ONE chip): vmap the
        scan body over B independent sequences. Under vmap the keyframe
        conds become selects (all lanes pay the branch), but B-wide
        vectorization amortizes every op — the classic batching trade."""
        B, T = images_u8.shape[:2]
        step = build_scan_step(
            cam, opts, img_wh,
            n_features_cap=n_features_cap,
            kf_capacity=kf_capacity,
            lm_capacity=lm_capacity,
            orb_kwargs=orb_kw,
            stage_limit=stage_limit,
            batched=True,
        )
        obs, mean, std, bits, pop = jax.vmap(
            lambda g, d: extract_sequence(g, d, orb_kw, chunk=2)
        )(images_u8, depths_m)
        vstep = jax.vmap(step, in_axes=(0, (None, 0, 0, 0, 0, 0, None)))
        st0 = initial_state(n_features_cap, kf_capacity, lm_capacity)
        st0b = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), st0)
        frame_ids = jnp.arange(T, dtype=jnp.int32)
        obs_t = jax.tree.map(lambda x: jnp.swapaxes(x, 0, 1), obs)
        return jax.lax.scan(
            vstep, st0b,
            (frame_ids, obs_t, bits.swapaxes(0, 1), pop.swapaxes(0, 1),
             mean.swapaxes(0, 1), std.swapaxes(0, 1),
             frame_keys(frame_ids)),
        )

    return jax.jit(run_batched)


def run_scan_pipeline(
    cam: CameraParams,
    images_u8,            # [T,H,W] uint8
    depths_m,             # [T,H,W] float32
    opts: TrackingOptions,
    n_features_cap: int = 1024,
    kf_capacity: int = 64,
    lm_capacity: int = 1 << 17,
    orb_kwargs: dict | None = None,
    stage_limit: int = 2,
    st0: ScanState | None = None,
    frame0: int = 0,
) -> tuple[ScanState, FrameOut]:
    """Run a (chunk of a) sequence on device; returns (final state,
    per-frame outputs stacked along T). Pass the previous chunk's final
    state as ``st0`` (and its running ``frame0``) to stream a long
    sequence chunk-by-chunk — host decode of chunk k+1 then overlaps the
    device scan of chunk k."""
    T, H, W = images_u8.shape
    opts_key = tuple(sorted(dataclasses.asdict(opts).items()))
    fn = _compiled_scan(
        opts_key, (W, H), n_features_cap, kf_capacity, lm_capacity,
        tuple(sorted((orb_kwargs or {}).items())), stage_limit,
    )
    if st0 is None:
        st0 = initial_state(n_features_cap, kf_capacity, lm_capacity)
    return fn(cam, st0, jnp.asarray(frame0, jnp.int32),
              jnp.asarray(images_u8), jnp.asarray(depths_m))


def run_scan_pipeline_batched(
    cam: CameraParams,
    images_u8,            # [B,T,H,W] uint8
    depths_m,             # [B,T,H,W] float32
    opts: TrackingOptions,
    n_features_cap: int = 1024,
    kf_capacity: int = 64,
    lm_capacity: int = 1 << 17,
    orb_kwargs: dict | None = None,
) -> tuple[ScanState, FrameOut]:
    """Batched multi-sequence SLAM on one chip; leading axis = sequences.

    Returns (final states stacked over B, per-frame outputs [T, B, ...])."""
    B, T, H, W = images_u8.shape
    opts_key = tuple(sorted(dataclasses.asdict(opts).items()))
    fn = _compiled_scan(
        opts_key, (W, H), n_features_cap, kf_capacity, lm_capacity,
        tuple(sorted((orb_kwargs or {}).items())), 2, True,
    )
    return fn(cam, jnp.asarray(images_u8), jnp.asarray(depths_m))
