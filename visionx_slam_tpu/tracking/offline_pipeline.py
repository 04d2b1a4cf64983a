"""Offline high-throughput SLAM: the whole sequence as BATCHED stages.

The online pipeline (``scan_pipeline.py``) reproduces the reference's
frame-sequential state machine (core/frontend/tracking.cpp) as a fused
``lax.scan`` — correct, but its throughput is capped by the serial chain:
every frame's extraction waits for the previous frame's BA. This module is
the restructuring for offline/batched mapping (BASELINE configs
4 and 5): the sequential dependency is broken into embarrassingly parallel
stages plus one associative prefix composition, so the matrix units see large
batches instead of one frame at a time.

Stages (all inside ONE jit):

1. **Extract** — ORB over ALL frames, vmapped in fixed-size chunks
   (``lax.map`` over [T/C, C, H, W] bounds peak memory); the per-level
   FAST/Harris/BRIEF work that dominates the online frame budget becomes
   C-wide batches.
2. **Match** — consecutive-pair Hamming GEMMs, batched over pairs.
3. **Relative pose** — RGB-D PnP RANSAC per pair (3-point closed-form
   Procrustes hypotheses + GN polish, see estimation.pnp_ransac), batched
   over ALL pairs at once.
4. **Compose** — absolute poses by ``associative_scan`` over SE(3): the
   classic parallel-prefix treatment of a serial recurrence
   (T_cw[i+1] = T_rel[i] ∘ T_cw[i]).
5. **Keyframes** — the reference keyframe policy (tracking.cpp:562-575)
   as a scalar ``lax.scan`` over per-pair stats (inliers, accumulated
   parallax, frame gap): microseconds, not a bottleneck.

   DOCUMENTED DEVIATION (parallax proxy): the reference gates on
   ``last_parallax_`` = the current frame's mean match displacement
   AGAINST THE LAST KEYFRAME (ComputeParallax(last_keyframe_, current),
   tracking.cpp:449/:562-575). The batched pre stage only has
   frame-to-frame pair statistics, so this policy ACCUMULATES per-pair
   parallax since the last keyframe — an upper bound on the
   vs-keyframe displacement that coincides with it for smooth
   forward motion and overestimates it under direction reversals
   (keyframes then fire slightly earlier). The proxy is pinned against
   the scan pipeline's exact vs-keyframe policy by
   tests/test_offline_pipeline.py::test_keyframe_policy_matches_scan.
6. **Map build** — keyframes inserted in ONE batch (no ring sequencing)
   with depth-backprojected landmarks (tracking.cpp:586-650 semantics),
   allocation contiguous and scatter-sorted.
7. **Refine** — global Schur-complement BA (models/global_ba.py) over the
   built map; non-keyframe poses are re-anchored to their preceding
   keyframe's refined pose (relative pose preserved).

Tracking failure on a pair freezes that pair's relative pose at identity
(flagged untracked) rather than re-initializing — the right behavior for
offline mapping where later pairs are independent anyway.

**Monocular mode** (``monocular=True``, BASELINE config 2): stage 3 swaps
RGB-D PnP for essential-matrix RANSAC + two-view triangulation (the
reference's init semantics, tracking.cpp:206-263, applied to EVERY pair),
and the per-pair unit-baseline scale ambiguity is resolved by a scale
chain: consecutive pairs share frame i+1's features, so the ratio of
their triangulated depths for the shared features recovers s_{i+1}/s_i
(robust median); one ``cumsum`` of log-ratios propagates scale from pair
0 (the exact analog of the reference propagating scale through map
depth — tracking.cpp has no other mechanism, so like the reference the
chain accumulates scale drift). Triangulated depths then stand in for
sensor depth in the keyframe map build, and the re-track stage runs PnP
with DLT hypotheses (no depth). Pairs that are parallax-starved (< the
essential inlier gate) freeze at identity exactly like RGB-D tracking
failures. Everything downstream (keyframe policy, map build, pair_ba,
re-track) is the shared code path.
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
    pnp_ransac,
    triangulate_dlt,
)
from ..models.global_ba import GlobalBAOptions, global_ba
from ..models.orb_jax import orb_extract
from ..models.pair_ba import PairLinks
from ..ops.camera import CameraParams, backproject
from ..ops.se3 import (
    Pose,
    identity_pose,
    matrix_to_quat,
    se3_apply,
    se3_compose,
    se3_inverse,
    se3_matrix,
)
from ..utils.config import TrackingOptions
from . import mapstate as msl
from . import stages
from .mapstate import FREE, MapState


class OfflineOut(NamedTuple):
    pose: jnp.ndarray         # [T,4,4] T_cw
    tracked: jnp.ndarray      # [T] bool
    n_matches: jnp.ndarray    # [T] int32 (vs previous frame; 0 for frame 0)
    n_inliers: jnp.ndarray    # [T] int32
    parallax: jnp.ndarray     # [T] float32 (vs previous frame)
    is_keyframe: jnp.ndarray  # [T] bool
    n_keyframes: jnp.ndarray  # [] int32
    n_landmarks: jnp.ndarray  # [] int32


def _pad_to(x: jnp.ndarray, n: int):
    pad = n - x.shape[0]
    if pad <= 0:
        return x
    return jnp.concatenate([x, jnp.repeat(x[-1:], pad, axis=0)])


def _chunked_vmap(fn, chunk: int, *args):
    """``jax.vmap(fn)(*args)`` executed in ``lax.map`` chunks of the leading
    axis to bound peak memory: the matcher materializes an [N,N] distance
    matrix per pair (~4 MB at N=1024), so mapping ALL T-1 pairs at once
    costs O(T) x that in live intermediates — ~1 GB at T=240 and 8x more
    under a batched-lane vmap. Chunking keeps the GEMM batch large enough to
    amortize while capping the live set; the tail chunk repeats the last
    element (dropped on return)."""
    M = args[0].shape[0]
    if chunk <= 0 or M <= chunk:
        return jax.vmap(fn)(*args)
    Mc = -(-M // chunk) * chunk
    parts = tuple(
        _pad_to(a, Mc).reshape(Mc // chunk, chunk, *a.shape[1:]) for a in args
    )
    out = jax.lax.map(lambda xs: jax.vmap(fn)(*xs), parts)
    return jax.tree.map(
        lambda x: x.reshape(Mc, *x.shape[2:])[:M], out
    )


def _segmented_compose_scan(q: jnp.ndarray, t: jnp.ndarray,
                            flag: jnp.ndarray) -> Pose:
    """Parallel-prefix SE(3) composition with per-lane segment resets.

    ``prefix[i] = value[i]`` where ``flag[i]`` (a segment start: the value
    IS the absolute anchor) else ``value[i] ∘ prefix[i-1]``. The flagged
    combine is associative — the standard segmented-scan construction — so
    the whole thing stays one ``associative_scan``. With ``flag`` all
    False this is exactly the unsegmented composition (the selects reduce
    to identity on constant-False flags)."""

    def comb(a, b):
        aq, at, af = a
        bq, bt, bf = b
        c = se3_compose(Pose(bq, bt), Pose(aq, at))
        f = bf[..., None]
        return (jnp.where(f, bq, c.q), jnp.where(f, bt, c.t), af | bf)

    pq, pt, _ = jax.lax.associative_scan(comb, (q, t, flag))
    return Pose(pq, pt)


def build_offline_pipeline(
    cam_static_placeholder,
    opts: TrackingOptions,
    *,
    n_features_cap: int = 1024,
    kf_capacity: int = 128,
    lm_capacity: int | None = None,
    orb_kwargs: dict | None = None,
    extract_chunk: int = 8,
    pair_chunk: int = 32,
    pnp_hypotheses: int = 16,
    # ONE GN pass of global BA by default: the re-track stage re-estimates
    # every frame against the refined landmarks and dominates final ATE —
    # measured invariant across refine_iterations 1..3 (RGB-D at 1x/2x/3x
    # motion AND mono), while each extra pass costs ~10% of the frame
    # budget. Raise for noisy-depth data where landmark polish matters.
    refine_iterations: int = 1,
    gba_cg_iterations: int = 8,
    monocular: bool = False,
    retrack_refine_iters: int = 3,
    retrack_hypotheses: int = 8,
    mono_pair_hypotheses: int = 128,
    mono_lo_starts: int = 16,
    mono_polish_iters: int = 10,
    mono_score_top_k: int | None = None,  # tier-2 width of the essential
                                    # RANSAC (estimation.essential_ransac
                                    # score_top_k)
    mono_retrack_two_kf: bool = True,   # retrack vs the UNION of the
                                    # preceding AND following keyframes'
                                    # landmarks (offline-only leverage:
                                    # the future keyframe is known). ON
                                    # by default since r5: at bench
                                    # length (240 frames) it recovers
                                    # every otherwise-untracked frame
                                    # (tracked 0.9667 -> 1.0000 measured,
                                    # VERDICT r4 #3) at ~1% time cost;
                                    # ATE is neutral.
    mono_sample_bias: float = 0.0,  # > 0: PROSAC-style sampling, minimal
                                    # sets drawn ∝ exp(-dist/bias) (see
                                    # estimation.sample_minimal_sets)
    mono_link_strides: tuple[int, ...] = (1, 2),
    mono_loop_pairs: int = 0,       # loop-closure detection budget PER
                                    # LANE (0 = off, the r5 default after
                                    # measurement). Three closure
                                    # mechanisms were built and measured
                                    # on revisiting synthetic loops:
                                    # landmark-merge + wide BA (0.27 ->
                                    # 0.39 m), single-pair constant-rate
                                    # scale correction (neutral; the
                                    # chain's scale error is a random
                                    # walk, not a ramp), and per-frame
                                    # scale anchoring (0.33 -> 0.36 m —
                                    # median-depth deltas are noisier
                                    # than the drift they correct at
                                    # these feature densities). All ship
                                    # opt-in behind this budget for data
                                    # where drift dominates; the default
                                    # mono accuracy path is instead the
                                    # two-keyframe retrack
                                    # (mono_retrack_two_kf).
    mono_loop_merge: bool = False,  # ALSO merge revisited landmarks and
                                    # run the wide two-phase BA
                                    # (_close_loops). OFF by default:
                                    # measured to DEGRADE the solution on
                                    # revisiting trajectories (0.27 ->
                                    # 0.39 m scale-aligned — the chain's
                                    # dense observations resist the loop
                                    # links and BA settles on a bent
                                    # compromise); kept for maps where
                                    # cross-visit landmark identity
                                    # matters more than trajectory ATE.
    mono_loop_min_gap: int = 12,    # min frame separation of a loop pair
    mono_loop_min_inliers: int = 40,
    mono_gba_iterations: int = 10,  # GN budget of the WIDE first BA phase
                                    # that absorbs loop constraints (the
                                    # correction must diffuse through the
                                    # pose chain; global_ba's per-group
                                    # early exit makes surplus iterations
                                    # cheap once converged)
    mono_gba_max_reproj: float = 30.0,  # gate of the wide phase: loop
                                    # links START at the accumulated-drift
                                    # reprojection error (tens of px) and
                                    # must not be culled before BA can act;
                                    # Huber still downweights them. The
                                    # second phase re-polishes at the
                                    # standard 5 px gate.
    lanes: int = 1,
):
    """Returns run(cam, images[T,H,W]u8, depths[T,H,W]f32) -> (MapState,
    OfflineOut). All sizes static; jit-compatible and vmap-able over a
    leading sequence axis. With ``monocular=True`` the depth input is
    ignored (pass zeros) and poses/landmarks live in the VO scale frame
    (see module docstring).

    ``lanes=B > 1`` is the FOLDED multi-sequence mode (BASELINE config 5):
    the input's leading axis is B lanes concatenated frame-major
    ([B*T_lane, H, W]), and every stage runs over the single folded frame
    axis — no stage ever executes under a lane vmap (the round-3 batched
    mode's vmap penalty on irregular stages) and the refine is ONE merged
    ``global_ba`` gauge-grouped per lane instead of a per-lane ``lax.map``
    tail. Lane isolation is by construction: cross-lane frame pairs are
    masked invalid, the pose/keyframe/scale recurrences run as segmented
    scans resetting at lane starts, keyframe selection is per-lane
    (``kf_capacity`` means per-lane capacity), and all RANSAC keys derive
    from WITHIN-lane indices so each lane draws the same randomness as a
    single-stream run of itself. With ``lanes=1`` every mask is constant
    and the formulas reduce exactly to the single-stream path."""
    B_lanes = lanes
    if lm_capacity is None:
        # K*N is the exact worst case of the contiguous cumsum allocator in
        # build_keyframe_map: sized to it, lm_dropped == 0 is guaranteed at
        # any keyframe/feature occupancy (K = total keyframe slots across
        # all lanes in folded mode)
        lm_capacity = lanes * kf_capacity * n_features_cap
    orb_kwargs = dict(orb_kwargs or {})
    orb_kwargs.setdefault("n_slots", n_features_cap)
    N = n_features_cap
    K = kf_capacity            # per-lane keyframe capacity
    KT = lanes * kf_capacity   # total keyframe slots (== K when lanes == 1)
    C = extract_chunk

    def run_pre(cam: CameraParams, images_u8, depths_m):
        T = images_u8.shape[0]
        H, W = images_u8.shape[1:]
        # ---- lane segmentation (constants; all-False/identity at B=1) ----
        assert T % B_lanes == 0, (T, B_lanes)
        T_lane = T // B_lanes
        pair_ix = jnp.arange(T - 1)
        wl_pair = pair_ix % T_lane              # within-lane pair index
        # pair i connects frames (i, i+1); it crosses a lane boundary iff
        # frame i+1 is a lane start
        pair_xlane = (pair_ix % T_lane) == (T_lane - 1)
        lane_start_frame = (jnp.arange(T) % T_lane) == 0

        # ---- 1. extraction, chunked vmap ----
        Tc = -(-T // C) * C
        imgs = _pad_to(images_u8, Tc).reshape(Tc // C, C, H, W)
        deps = _pad_to(depths_m, Tc).reshape(Tc // C, C, H, W)

        def extract_chunk_fn(args):
            g, d = args
            px, resp, desc, valid = jax.vmap(
                lambda im: orb_extract(im, **orb_kwargs)
            )(g)
            dfeat = jax.vmap(stages.sample_depth_image)(d, px, valid)
            return px, resp, desc, valid, dfeat

        px, resp, desc, valid, dfeat = jax.lax.map(
            extract_chunk_fn, (imgs, deps)
        )
        px = px.reshape(Tc, N, 2)[:T]
        desc = desc.reshape(Tc, N, 32)[:T]
        valid = valid.reshape(Tc, N)[:T]
        dfeat = dfeat.reshape(Tc, N)[:T]

        # ---- 2+3. consecutive-pair matching + relative pose, one chunked
        # per-pair function (match -> gather -> RGB-D PnP); lax.map chunks
        # bound the live [N,N] distance matrices (see _chunked_vmap) ----
        keys = jax.vmap(jax.random.fold_in, (None, 0))(
            jax.random.PRNGKey(29), wl_pair
        )

        def pair_pose(pts3d, pts2d, vv, key, dcur, refine=4):
            sol = pnp_ransac(
                cam, pts3d, pts2d, vv, key, opts.max_reproj_error,
                n_hypotheses=pnp_hypotheses, refine_iters=refine,
                init_pose=identity_pose(), depth_curr=dcur,
            )
            ok = (
                sol.ok
                & (sol.n_inliers >= opts.min_inliers)
                & jnp.all(jnp.isfinite(sol.pose.q))
                & jnp.all(jnp.isfinite(sol.pose.t))
            )
            return sol.pose, sol.n_inliers, ok

        def pair_track(dq, vq, dt, vt, pxq, pxt, ddq, ddt, key):
            m = matching.match_frames(dq, vq, dt, vt)
            pc = backproject(cam, pxq, ddq)        # prev-frame camera points
            px_n = pxt[m.idx]
            d_n = ddt[m.idx]
            pvalid = (
                m.valid & (ddq >= stages.MIN_DEPTH) & (ddq <= stages.MAX_DEPTH)
            )
            # light GN polish: this pose only seeds the keyframe policy and
            # the VO fallback chain; the retrack stage re-estimates every
            # frame against the refined keyframe map with the full polish
            pose, n_i, ok_i = pair_pose(pc, px_n, pvalid, key, d_n, refine=2)
            n_m = jnp.sum(m.valid).astype(jnp.int32)
            par = stages.parallax_px(pxq, pxt, m)
            return pose.q, pose.t, n_i, ok_i, n_m, par

        def pair_track_mono(dq, vq, dt, vt, pxq, pxt, key):
            """Essential RANSAC + two-view triangulation for one pair.
            Returns the unit-baseline relative pose plus the triangulated
            depths feeding the scale chain (module docstring): zq = depth
            of query feature n in the QUERY frame, zn = depth of its match
            in the TRAIN frame (both in this pair's unit-baseline scale)."""
            from ..models.estimation import _normalize_px

            m = matching.match_frames(dq, vq, dt, vt)
            px_n = pxt[m.idx]
            # consecutive-frame pairs are high-inlier after the ratio +
            # distance filters, so a smaller raw budget than the online
            # fallback's 256 holds (measured: 128 -> +32% mono fps at
            # equal ATE), and the annealed-LO multi-start fan shrinks
            # 16 -> 4 (the fan exists for the blind low-inlier regime);
            # parallax-starved/low-inlier pairs freeze to identity
            # downstream either way (module docstring)
            logw = (None if mono_sample_bias <= 0.0
                    else -m.dist / mono_sample_bias)
            sol = essential_ransac(cam, pxq, px_n, m.valid, key,
                                   n_hypotheses=mono_pair_hypotheses,
                                   lo_starts=mono_lo_starts,
                                   polish_iters=mono_polish_iters,
                                   score_top_k=mono_score_top_k,
                                   sample_logw=logw)
            x1 = _normalize_px(cam, pxq)
            x2 = _normalize_px(cam, px_n)
            P1 = jnp.concatenate(
                [jnp.eye(3, dtype=jnp.float32), jnp.zeros((3, 1))], 1
            )
            P2 = jnp.concatenate([sol.R, sol.t[:, None]], 1)
            X = triangulate_dlt(P1, P2, x1, x2)       # [N,3] query camera
            zq_tri = X[:, 2]
            zn_tri = (X @ sol.R.T + sol.t[None, :])[:, 2]
            # cheirality + a RELATIVE far gate. The depths here are in
            # UNIT-BASELINE scale: an absolute cut (the reference's
            # 50-unit far gate, applied to its metric init) guillotines
            # perfectly good points whenever the inter-frame baseline is
            # small relative to scene depth — at the stride-4 bench
            # shape (60 mm steps, 2-3 m scene) the scene itself sits at
            # z ~ 33-50 baseline-units and the absolute gate left a
            # median of 34 valid depths/frame, starving the keyframe
            # maps mono PnP tracks against. Gating at 10x the robust
            # median keeps the scene and still drops near-infinity junk.
            zgood0 = (
                m.valid & sol.inlier_mask
                & (zq_tri > 1e-3) & (zn_tri > 1e-3)
                & jnp.all(jnp.isfinite(X), axis=-1)
            )
            zmed = jnp.nan_to_num(
                jnp.nanmedian(jnp.where(zgood0, zq_tri, jnp.nan)), nan=1.0)
            zcap = 10.0 * jnp.maximum(zmed, 1e-3)
            zgood = zgood0 & (zq_tri < zcap) & (zn_tri < zcap)
            q = matrix_to_quat(sol.R)
            ok_i = sol.ok & (sol.n_inliers >= opts.min_inliers)
            n_m = jnp.sum(m.valid).astype(jnp.int32)
            par = stages.parallax_px(pxq, pxt, m)
            return (q, sol.t, sol.n_inliers, ok_i, n_m, par,
                    jnp.where(zgood, zq_tri, 0.0),
                    jnp.where(zgood, zn_tri, 0.0), m.idx)

        if monocular:
            (rq, rt, n_inl, ok, n_matches, parallax, zq_u, zn_u,
             midx) = _chunked_vmap(
                pair_track_mono, pair_chunk,
                desc[:-1], valid[:-1], desc[1:], valid[1:],
                px[:-1], px[1:], keys,
            )  # rel = T_{i+1 <- i}, ||t|| = 1 per pair

            # cross-lane pairs relate unrelated frames: their triangulated
            # depths must not feed the scale chain or the frame-depth table
            zq_u = jnp.where(pair_xlane[:, None], 0.0, zq_u)
            zn_u = jnp.where(pair_xlane[:, None], 0.0, zn_u)

            # ---- scale chain: pair i-1 and pair i share frame i's
            # features. d_in = zn_u[i-1][n] (scale s_{i-1}), d_out =
            # zq_u[i][midx[i-1][n]] (scale s_i, gathered — no scatter);
            # median log-ratio -> s_i/s_{i-1}. Relations touching a
            # cross-lane pair vanish automatically (their depths are 0 ->
            # shared = 0 -> log_ratio = 0). ----
            d_in = zn_u[:-1]                               # [T-2,N]
            d_out = jnp.take_along_axis(zq_u[1:], midx[:-1], axis=1)
            shared = (d_in > 0.0) & (d_out > 0.0)
            logr = jnp.where(
                shared, jnp.log(jnp.maximum(d_in, 1e-9))
                - jnp.log(jnp.maximum(d_out, 1e-9)), jnp.nan,
            )
            n_shared = jnp.sum(shared, axis=1)
            med = jnp.nan_to_num(jnp.nanmedian(logr, axis=1))
            log_ratio = jnp.where(n_shared >= 8, med, 0.0)  # [T-2]
            # per-lane exclusive prefix sum: subtract the running sum at
            # each lane's first pair (a gather of constants; identity at
            # B=1 where first_pair == 0 and cs[0] == 0)
            cs = jnp.concatenate(
                [jnp.zeros((1,), jnp.float32), jnp.cumsum(log_ratio)]
            )                                               # [T-1]
            first_pair = (pair_ix // T_lane) * T_lane
            log_s = cs - cs[first_pair]
            # per-lane gauge: median depth of the lane's first pair -> 2 m
            # (the analog of the reference normalizing init median depth;
            # keeps depths inside the map build's MIN/MAX_DEPTH gates)
            zq0 = zq_u[jnp.arange(B_lanes) * T_lane]        # [B,N]
            med0 = jnp.nanmedian(jnp.where(zq0 > 0, zq0, jnp.nan), axis=1)
            c = 2.0 / jnp.maximum(jnp.nan_to_num(med0, nan=1.0), 1e-6)
            s = jnp.exp(log_s) * c[pair_ix // T_lane]       # [T-1]
            rt = rt * s[:, None]
            # synthesized per-feature depth (world scale) stands in for
            # sensor depth downstream; lane-last frames map to cross-lane
            # pairs (depths forced 0 above), the global last frame to the
            # appended zero row
            dfeat = jnp.concatenate(
                [zq_u * s[:, None], jnp.zeros((1, N), jnp.float32)]
            )
            if mono_loop_pairs > 0:
                # scale-drift redistribution on the chain itself (see
                # _scale_loop_correction): a verified revisit pair's
                # depth-ratio measures the accumulated drift, removed at
                # constant rate BEFORE the map is built. The rotation
                # gate needs only the rotation-only VO prefix, which is
                # scale-independent and cheap to compose here.
                rq_m = jnp.where((ok & ~pair_xlane)[:, None], rq,
                                 identity_pose().q[None])
                rot_pre = _segmented_compose_scan(
                    rq_m, jnp.zeros((T - 1, 3), jnp.float32), pair_xlane
                ).q
                frame_q = jnp.concatenate(
                    [identity_pose().q[None], rot_pre])
                factor, _ = _scale_loop_correction(
                    cam, opts, desc, valid, px, dfeat, frame_q, B_lanes,
                    min_gap=mono_loop_min_gap,
                    min_inliers=mono_loop_min_inliers,
                    key=jax.random.PRNGKey(59),
                )
                rt = rt * factor[:-1, None]
                dfeat = dfeat * factor[:, None]
        else:
            rq, rt, n_inl, ok, n_matches, parallax = _chunked_vmap(
                pair_track, pair_chunk,
                desc[:-1], valid[:-1], desc[1:], valid[1:],
                px[:-1], px[1:], dfeat[:-1], dfeat[1:], keys,
            )  # rel = T_{i+1 <- i}
        # cross-lane pairs never track; their stats must not leak into the
        # keyframe policy or the per-frame outputs
        ok = ok & ~pair_xlane
        n_inl = jnp.where(pair_xlane, 0, n_inl)
        n_matches = jnp.where(pair_xlane, 0, n_matches)
        parallax = jnp.where(pair_xlane, 0.0, parallax)
        ident = identity_pose()
        if monocular:
            # constant-velocity fallback (VERDICT r4 #3): a failed pair
            # freezing at IDENTITY breaks the VO chain by the missing
            # motion, which then poisons every downstream pose of the
            # segment and starves the re-track PnP of a usable init. A
            # failed pair instead inherits its PREDECESSOR's relative pose
            # (already in world scale — rt is post-scale-chain here); the
            # frame still reports untracked unless the re-track stage
            # verifies it against the keyframe map. Lane starts keep
            # identity (no predecessor within the lane).
            prev_ok = jnp.concatenate([jnp.zeros((1,), bool), ok[:-1]])
            prev_in_lane = jnp.concatenate(
                [jnp.zeros((1,), bool), ~pair_xlane[:-1]])
            use_prev = ~ok & prev_ok & prev_in_lane & ~pair_xlane
            rq = jnp.where(
                use_prev[:, None],
                jnp.concatenate([rq[:1], rq[:-1]]), rq)
            rt = jnp.where(
                use_prev[:, None],
                jnp.concatenate([rt[:1], rt[:-1]]), rt)
            rel_ok = ok | use_prev
        else:
            rel_ok = ok
        rel = Pose(
            jnp.where(rel_ok[:, None], rq, ident.q[None]),
            jnp.where(rel_ok[:, None], rt, ident.t[None]),
        )

        # ---- 4. absolute poses by parallel prefix over SE(3) ----
        # T_cw[i+1] = rel[i] ∘ rel[i-1] ∘ ... ∘ rel[0]; combine(a, b) = b∘a,
        # segmented per lane (each lane-start frame re-anchors at identity)
        prefix = _segmented_compose_scan(rel.q, rel.t, pair_xlane)
        # re-normalize quaternions (compounded float error over T)
        qn = prefix.q / jnp.maximum(
            jnp.linalg.norm(prefix.q, axis=-1, keepdims=True), 1e-12
        )
        poses = Pose(
            jnp.concatenate([ident.q[None], qn]),
            jnp.concatenate([ident.t[None], prefix.t]),
        )  # [T]
        tracked = jnp.concatenate([jnp.ones((1,), bool), ok]) | lane_start_frame

        # ---- 5. keyframe policy (scalar scan; tracking.cpp:562-575);
        # lane-start frames are each lane's frame 0: forced keyframes with
        # a fresh parallax/gap carry ----
        def kf_step(carry, x):
            acc_par, last_kf, i = carry
            inl_i, par_i, ok_i, ls_i = x
            acc = jnp.where(ls_i, 0.0, acc_par + par_i)
            need = ls_i | (
                ok_i
                & (inl_i >= opts.min_keyframe_inliers)
                & (acc >= opts.min_parallax)
                & ((i - last_kf) >= opts.min_keyframe_gap)
            )
            return (
                jnp.where(need, 0.0, acc),
                jnp.where(need, i, last_kf),
                i + 1,
            ), need

        _, need_kf = jax.lax.scan(
            kf_step,
            (jnp.float32(0), jnp.int32(0), jnp.int32(1)),
            (n_inl, parallax, ok, pair_xlane),
        )
        is_kf = jnp.concatenate([jnp.ones((1,), bool), need_kf])  # frame 0 = KF

        # ---- 6. map build: the LAST K keyframes PER LANE, one batched
        # insert into a single (lane-merged when B > 1) map ----
        frame_ids = jnp.arange(T, dtype=jnp.int32)
        kf_rank = jnp.where(is_kf, frame_ids, -1)
        k_sel = min(K, T_lane)                        # top_k needs k <= T
        sel = jax.vmap(lambda r: jax.lax.top_k(r, k_sel)[0])(
            kf_rank.reshape(B_lanes, T_lane)
        )[:, ::-1]                                    # [B,k_sel] ascending
        if k_sel < K:                                 # pad dead slots at front
            sel = jnp.concatenate(
                [jnp.full((B_lanes, K - k_sel), -1, jnp.int32), sel], axis=1
            )
        sel = sel.reshape(KT)
        kvalid = sel >= 0
        slot_frame = jnp.maximum(sel, 0)              # [KT] frame index

        kf_px = px[slot_frame]                        # [K,N,2]
        kf_desc = desc[slot_frame]
        kf_fvalid = valid[slot_frame] & kvalid[:, None]
        kf_depth = dfeat[slot_frame]

        # ---- 5b. keyframe chain: re-estimate relative poses directly
        # between consecutive keyframes (larger baselines -> better
        # per-hop SNR, and ~gap x fewer hops to compound than the
        # frame-to-frame VO chain), falling back to the VO-derived
        # relative pose where the direct estimate fails. Slot pairs that
        # cross a lane block are masked; the chain scan is segmented with
        # each lane's first slot as its anchor. ----
        kpair_ix = jnp.arange(KT - 1)
        kpair_xlane = (kpair_ix % K) == (K - 1)       # slot j+1 starts a lane
        keys_k = jax.vmap(jax.random.fold_in, (None, 0))(
            jax.random.PRNGKey(31), kpair_ix % K
        )

        def kf_pair_track(dq, vq, dt, vt, pxq, pxt, ddq, ddt, key):
            m = matching.match_frames(dq, vq, dt, vt)
            pc = backproject(cam, pxq, ddq)
            px_n = pxt[m.idx]
            d_n = ddt[m.idx]
            pvalid = (
                m.valid & (ddq >= stages.MIN_DEPTH) & (ddq <= stages.MAX_DEPTH)
            )
            pose, _, ok_i = pair_pose(pc, px_n, pvalid, key, d_n)
            return pose.q, pose.t, ok_i

        vo_kf_pose = Pose(poses.q[slot_frame], poses.t[slot_frame])  # [KT]
        vo_rel = jax.vmap(
            lambda a_q, a_t, b_q, b_t: se3_compose(
                Pose(b_q, b_t), se3_inverse(Pose(a_q, a_t)))
        )(vo_kf_pose.q[:-1], vo_kf_pose.t[:-1],
          vo_kf_pose.q[1:], vo_kf_pose.t[1:])
        if monocular:
            # mono keeps the composed VO-chain relative poses: a direct
            # keyframe-pair Procrustes hop on the chain-synthesized depths
            # was tried and REGRESSED (176 -> 260 mm scale-aligned at
            # T=60) — each hop inherits the query frame's LOCAL scale
            # estimate, noisier than the chain's per-pair median
            # composition it replaces
            rel_k = vo_rel
        else:
            rk_q, rk_t, ok_k = _chunked_vmap(
                kf_pair_track, pair_chunk,
                kf_desc[:-1], kf_fvalid[:-1], kf_desc[1:], kf_fvalid[1:],
                kf_px[:-1], kf_px[1:], kf_depth[:-1], kf_depth[1:], keys_k,
            )
            use_k = ok_k & kvalid[1:] & kvalid[:-1] & ~kpair_xlane
            rel_k = Pose(
                jnp.where(use_k[:, None], rk_q, vo_rel.q),
                jnp.where(use_k[:, None], rk_t, vo_rel.t),
            )
        # chain elements: each lane block's first slot carries its own VO
        # pose (the segment anchor — identity unless the lane's oldest
        # keyframes were evicted), element j>0 the relative pose
        # slot j-1 -> slot j; segmented scan resets at lane blocks
        kstart = (jnp.arange(KT) % K) == 0
        chain_q = jnp.concatenate([vo_kf_pose.q[:1], rel_k.q])
        chain_t = jnp.concatenate([vo_kf_pose.t[:1], rel_k.t])
        chain_q = jnp.where(kstart[:, None], vo_kf_pose.q, chain_q)
        chain_t = jnp.where(kstart[:, None], vo_kf_pose.t, chain_t)
        kf_abs = _segmented_compose_scan(chain_q, chain_t, kstart)
        kf_q = kf_abs.q / jnp.maximum(
            jnp.linalg.norm(kf_abs.q, axis=-1, keepdims=True), 1e-12
        )
        kf_t = kf_abs.t

        ms, links = build_keyframe_map(
            cam, opts, kf_q, kf_t, jnp.where(kvalid, sel, -1),
            kf_px, kf_desc, kf_fvalid, kf_depth, lm_capacity,
            pair_chunk=pair_chunk,
            pair_valid=None if B_lanes == 1 else ~kpair_xlane,
            # mono: a second stride-2 link pass gives landmarks a third
            # view; two-hop coupling lets global BA correct the scale
            # chain's relative-scale errors (RGB-D scale is metric from
            # depth — the extra pass buys nothing there)
            link_strides=mono_link_strides if monocular else (1,),
            # Mono map-structure experiments, both available but OFF by
            # default (measured on the strided synthetic at T=60,
            # scale-aligned ATE): retriangulate alone 149.7 mm vs 148.9
            # baseline (noise-level); takeover+retriangulate 159.4 mm
            # (fewer landmarks per keyframe outweigh the better-placed
            # shared ones). The mono error floor here is re-track PnP
            # noise, not landmark placement — the oracle (reference
            # behavior) sits at 299 mm on the same input.
            retriangulate=False,
            takeover=False,
        )

        if monocular and mono_loop_pairs > 0 and mono_loop_merge:
            # optional landmark-merge closure (see _close_loops and the
            # mono_loop_merge default rationale). Folded lanes get a
            # lane-gated candidate set and a budget scaled to the lane
            # count (r5: was single-lane only).
            ms, _, _ = _close_loops(
                ms, cam, opts, n_pairs=mono_loop_pairs * B_lanes,
                min_gap_frames=mono_loop_min_gap,
                min_inliers=mono_loop_min_inliers,
                key=jax.random.PRNGKey(61),
                slots_per_lane=None if B_lanes == 1 else K,
            )

        # per-lane landmark creation counts (for the split + per-lane
        # n_landmarks output); identical to the lane's own allocation
        lane_lm = jnp.sum(
            links.created.reshape(B_lanes, K * N), axis=1
        ).astype(jnp.int32)

        aux = dict(
            poses_q=poses.q, poses_t=poses.t, tracked=tracked,
            n_inl=n_inl, n_matches=n_matches, parallax=parallax,
            is_kf=is_kf, px=px, desc=desc, valid=valid, dfeat=dfeat,
            lane_lm=lane_lm,
        )
        return ms, links, aux

    gba_opts = GlobalBAOptions(
        max_iterations=max(refine_iterations, 1),
        cg_iterations=gba_cg_iterations,
    )
    # mono loop closure needs a two-phase refine: a WIDE phase whose gate
    # admits the drifted loop observations (mono_gba_max_reproj) and whose
    # GN budget lets the correction diffuse through the pose chain, then
    # the standard-gate polish phase
    mono_loop_gba = monocular and mono_loop_pairs > 0 and mono_loop_merge
    wide_gba_opts = GlobalBAOptions(
        max_iterations=mono_gba_iterations,
        cg_iterations=max(gba_cg_iterations, 16),
        max_reproj_error=mono_gba_max_reproj,
    )

    def run_refine(cam: CameraParams, ms: MapState,
                   links: PairLinks) -> MapState:
        # global_ba, NOT pair_ba, though pair_ba was faster as a standalone
        # dispatch on the earlier accelerator: compiled into the same XLA
        # program as run_pre (fused or vmapped), pair_ba's CG link-gathers
        # inherited pathological layouts on the earlier accelerator and lost
        # end to end (pinning every solver input with with_layout_constraint
        # did NOT recover it). pair_ba serves the standalone archive GBA
        # dispatch in system.py. Both routings were chosen on the earlier
        # accelerator and are not yet measured on the H100 (PERF.md open
        # questions).
        #
        # Folded multi-lane mode: ONE merged solve over the lane-merged map,
        # gauge-grouped per lane block — global_ba's per-group CG scalars make
        # it exactly B independent solves (pinned by
        # tests/test_offline_pipeline.py::test_refine_merged_matches_per_lane).
        gg = (None if B_lanes == 1 else
              jnp.repeat(jnp.arange(B_lanes, dtype=jnp.int32), K))
        if mono_loop_gba:
            ms, _ = global_ba(ms, cam, wide_gba_opts, gauge_group=gg)
        ms, _ = global_ba(ms, cam, gba_opts, gauge_group=gg)
        return ms

    def run_refine_merged(cam: CameraParams, ms_b: MapState) -> MapState:
        """Refine B lane maps (leading lane axis) as ONE merged global_ba
        solve. The per-lane ``lax.map`` refine was the batched mode's
        serial tail (both solvers degrade under a lane vmap — see
        run_refine); concatenating the lanes' keyframe/landmark tables
        with lane-offset links turns the B solves into one fully parallel
        sorted-segment-sum solve, gauge-fixed per lane via global_ba's
        gauge_group."""
        B, Kl = ms_b.kf_id.shape
        Lpl = ms_b.lm_pos.shape[-1]   # NOT the .lm_physical property: the
                                      # lane axis shifts its shape index
        flm = ms_b.kf_feat_lm
        lane = jnp.arange(B, dtype=jnp.int32)[:, None, None]
        merged = MapState(
            kf_q=ms_b.kf_q.reshape(B * Kl, 4),
            kf_t=ms_b.kf_t.reshape(B * Kl, 3),
            kf_id=ms_b.kf_id.reshape(B * Kl),
            kf_px=ms_b.kf_px.reshape(B * Kl, 2, N),
            kf_desc=ms_b.kf_desc.reshape(B * Kl, N, 32),
            kf_fvalid=ms_b.kf_fvalid.reshape(B * Kl, N),
            kf_feat_lm=jnp.where(flm >= 0, flm + lane * Lpl, flm).reshape(
                B * Kl, N
            ),
            kf_depth=ms_b.kf_depth.reshape(B * Kl, N),
            lm_pos=jnp.moveaxis(ms_b.lm_pos, 1, 0).reshape(3, B * Lpl),
            lm_alive=ms_b.lm_alive.reshape(B * Lpl),
            lm_obs=ms_b.lm_obs.reshape(B * Lpl),
            next_kf=jnp.sum(ms_b.next_kf),
            next_lm=jnp.sum(ms_b.next_lm),
            lm_dropped=jnp.sum(ms_b.lm_dropped),
        )
        gauge = jnp.repeat(jnp.arange(B, dtype=jnp.int32), Kl)
        out, _ = global_ba(merged, cam, gba_opts, gauge_group=gauge)
        return ms_b._replace(
            kf_q=out.kf_q.reshape(B, Kl, 4),
            kf_t=out.kf_t.reshape(B, Kl, 3),
            lm_pos=jnp.moveaxis(out.lm_pos.reshape(3, B, Lpl), 0, 1),
        )

    def run_post(cam: CameraParams, ms: MapState, aux: dict):
        poses = Pose(aux["poses_q"], aux["poses_t"])
        tracked = aux["tracked"]
        n_inl, n_matches = aux["n_inl"], aux["n_matches"]
        parallax, is_kf = aux["parallax"], aux["is_kf"]
        px, desc = aux["px"], aux["desc"]
        valid, dfeat = aux["valid"], aux["dfeat"]
        T = is_kf.shape[0]
        frame_ids = jnp.arange(T, dtype=jnp.int32)
        kvalid = ms.kf_id >= 0
        slot_frame = jnp.maximum(ms.kf_id, 0)

        # preceding keyframe of every frame (cummax over kf markers)
        prev_kf = jax.lax.associative_scan(
            jnp.maximum, jnp.where(is_kf, frame_ids, -1)
        )
        prev_kf = jnp.maximum(prev_kf, 0)              # [T] frame idx of kf
        write_idx = jnp.where(kvalid, slot_frame, T)   # drop dead slots
        slot_of_frame = jnp.zeros((T,), jnp.int32).at[write_idx].set(
            jnp.arange(KT, dtype=jnp.int32), mode="drop"
        )
        kf_slot_per_frame = slot_of_frame[prev_kf]     # [T]

        # fallback pose: re-anchor the VO chain to the (refined) keyframe:
        # T_cw'(f) = T_cw_vo(f) ∘ T_cw_vo(kf)^-1 ∘ T_cw_ref(kf)
        vo_kf = Pose(poses.q[prev_kf], poses.t[prev_kf])
        ref_kf = Pose(ms.kf_q[kf_slot_per_frame], ms.kf_t[kf_slot_per_frame])
        corr = jax.vmap(lambda a, b: se3_compose(se3_inverse(a), b))(
            vo_kf, ref_kf
        )
        poses = jax.vmap(lambda p, c: se3_compose(p, c))(poses, corr)

        # ---- 7b. re-track: every frame PnP'd against its preceding
        # keyframe's landmarks (the online pipeline's steady-state
        # semantics, tracking.cpp:332-455 — but batched over ALL frames at
        # once, since keyframe poses/landmarks are now known). Kills the
        # within-segment drift of the composed VO chain. ----
        kd = ms.kf_desc[kf_slot_per_frame]             # [T,N,32]
        kv = ms.kf_fvalid[kf_slot_per_frame]
        feat_lm_f = ms.kf_feat_lm[kf_slot_per_frame]   # [T,N]
        if monocular and mono_retrack_two_kf:
            # ---- mono: widen the retrack table with the FOLLOWING
            # keyframe's landmarks (min kf id >= f; reverse cummax over
            # negated ids). Offline-only leverage the reference's online
            # loop cannot have: the future keyframe is already refined, so
            # every frame PnPs against ~2x the landmarks and its pose is
            # interpolated between two anchors instead of extrapolated
            # from one — mono's error floor is this PnP step's noise (see
            # build_keyframe_map call). Frames past their lane's last
            # keyframe, or whose next keyframe was never stored, keep the
            # single-table behavior (use2 masks the copy). ----
            nk = -jax.lax.associative_scan(
                jnp.maximum, jnp.where(is_kf, -frame_ids, -(T + 1))[::-1]
            )[::-1]                                    # [T] or T+1 if none
            T_l = T // B_lanes
            has_next = (nk <= T - 1) & ((nk // T_l) == (frame_ids // T_l))
            nk_c = jnp.where(has_next, nk, prev_kf)
            slot2 = slot_of_frame[jnp.minimum(nk_c, T - 1)]
            use2 = (
                has_next
                & (slot2 != kf_slot_per_frame)
                & (ms.kf_id[slot2] == nk_c)            # evicted -> slot 0
            )
            kd = jnp.concatenate([kd, ms.kf_desc[slot2]], axis=1)
            kv = jnp.concatenate(
                [kv, ms.kf_fvalid[slot2] & use2[:, None]], axis=1
            )
            feat_lm_f = jnp.concatenate(
                [feat_lm_f, ms.kf_feat_lm[slot2]], axis=1
            )
        Lp = ms.lm_physical
        keys_rt = jax.vmap(jax.random.fold_in, (None, 0))(
            jax.random.PRNGKey(37), jnp.arange(T) % (T // B_lanes)
        )
        lm_pos, lm_alive = ms.lm_pos, ms.lm_alive      # closed over (gathered)

        def frame_retrack(kdi, kvi, flmi, di, vi, pxi, ddi, key, pq, pt):
            m = matching.match_frames(kdi, kvi, di, vi)
            lmf = jnp.clip(flmi, 0, Lp - 1)
            p3 = lm_pos[:, lmf].T                      # [N,3] world points
            pval = (
                m.valid & (flmi >= 0) & lm_alive[lmf]
                & jnp.all(jnp.isfinite(p3), axis=-1)
            )
            p2 = pxi[m.idx]
            d2 = ddi[m.idx]
            # fewer hypotheses than the blind pair stage: the VO-anchored
            # init pose competes as a motion-prior IRLS hypothesis, so the
            # raw budget only needs to cover gross VO failures (recovery
            # is hypothesis-bound only below ~30% inliers)
            sol = pnp_ransac(
                cam, p3, p2, pval, key, opts.max_reproj_error,
                n_hypotheses=retrack_hypotheses,
                refine_iters=retrack_refine_iters,
                init_pose=Pose(pq, pt),
                # mono: no sensor depth -> DLT hypothesis variant
                depth_curr=None if monocular else d2,
            )
            ok_i = (
                sol.ok
                & (sol.n_inliers >= opts.min_inliers)
                & jnp.all(jnp.isfinite(sol.pose.q))
                & jnp.all(jnp.isfinite(sol.pose.t))
            )
            return sol.pose.q, sol.pose.t, sol.n_inliers, ok_i

        rt_q, rt_t, rt_inl, rt_ok = _chunked_vmap(
            frame_retrack, pair_chunk,
            kd, kv, feat_lm_f, desc, valid, px, dfeat, keys_rt,
            poses.q, poses.t,
        )
        poses = Pose(
            jnp.where(rt_ok[:, None], rt_q, poses.q),
            jnp.where(rt_ok[:, None], rt_t, poses.t),
        )
        tracked = tracked | rt_ok

        pose_mats = jax.vmap(se3_matrix)(poses)
        pair_inl = jnp.concatenate([jnp.zeros((1,), jnp.int32), n_inl])
        if B_lanes == 1:
            n_kf, n_lm = msl.n_keyframes(ms), msl.n_landmarks(ms)
        else:  # per-lane counts [B]
            n_kf = jnp.sum(
                kvalid.reshape(B_lanes, K), axis=1
            ).astype(jnp.int32)
            n_lm = aux["lane_lm"]
        out = OfflineOut(
            pose=pose_mats,
            tracked=tracked,
            n_matches=jnp.concatenate([jnp.zeros((1,), jnp.int32), n_matches]),
            n_inliers=jnp.where(rt_ok, rt_inl, pair_inl),
            parallax=jnp.concatenate([jnp.zeros((1,), jnp.float32), parallax]),
            is_keyframe=is_kf,
            n_keyframes=n_kf,
            n_landmarks=n_lm,
        )
        return ms, out

    def run(cam: CameraParams, images_u8, depths_m):
        ms, links, aux = run_pre(cam, images_u8, depths_m)
        if refine_iterations > 0:
            ms = run_refine(cam, ms, links)
        return run_post(cam, ms, aux)

    def run_batched_lanes(cam: CameraParams, images_u8, depths_m):
        """THE batched multi-lane composition (leading lane axis [B,T,...]):
        FOLD the lanes into the frame axis and run the single folded
        pipeline built with ``lanes=B`` — no stage executes under a lane
        vmap (the round-3 vmap penalty on irregular stages) and the refine
        is one merged gauge-grouped global_ba instead of a per-lane
        ``lax.map`` tail (which serialized B solves). Single source of
        truth for the single-chip batched mode AND the mesh-sharded
        per-device body (parallel/batch.py) — they must not diverge or the
        sharded==unsharded invariant silently breaks. Returns per-lane
        (MapState [B,...], OfflineOut [B,T,...]), split out of the merged
        tables (bit-compatible with what per-lane builds would produce)."""
        B, T_lane = images_u8.shape[:2]
        folded = build_offline_pipeline(
            None, opts,
            n_features_cap=N, kf_capacity=K, lm_capacity=B * K * N,
            orb_kwargs=orb_kwargs, extract_chunk=extract_chunk,
            pair_chunk=pair_chunk, pnp_hypotheses=pnp_hypotheses,
            refine_iterations=refine_iterations,
            gba_cg_iterations=gba_cg_iterations, monocular=monocular,
            retrack_refine_iters=retrack_refine_iters,
            retrack_hypotheses=retrack_hypotheses,
            mono_pair_hypotheses=mono_pair_hypotheses,
            mono_lo_starts=mono_lo_starts,
            mono_polish_iters=mono_polish_iters,
            mono_score_top_k=mono_score_top_k,
            mono_sample_bias=mono_sample_bias,
            mono_link_strides=mono_link_strides,
            mono_loop_pairs=mono_loop_pairs,
            mono_loop_merge=mono_loop_merge,
            mono_loop_min_gap=mono_loop_min_gap,
            mono_loop_min_inliers=mono_loop_min_inliers,
            mono_gba_iterations=mono_gba_iterations,
            mono_gba_max_reproj=mono_gba_max_reproj,
            mono_retrack_two_kf=mono_retrack_two_kf,
            lanes=B,
        )
        flat = lambda x: x.reshape((B * T_lane,) + x.shape[2:])
        ms, out = folded(cam, flat(images_u8), flat(depths_m))
        # counts are per-lane [B] from the folded build, scalars when B==1
        # (a single lane per device happens under full mesh sharding)
        n_kf = out.n_keyframes.reshape(B)
        n_lm = out.n_landmarks.reshape(B)
        out_lanes = OfflineOut(
            pose=out.pose.reshape(B, T_lane, 4, 4),
            tracked=out.tracked.reshape(B, T_lane),
            n_matches=out.n_matches.reshape(B, T_lane),
            n_inliers=out.n_inliers.reshape(B, T_lane),
            parallax=out.parallax.reshape(B, T_lane),
            is_keyframe=out.is_keyframe.reshape(B, T_lane),
            n_keyframes=n_kf,
            n_landmarks=n_lm,
        )
        return (
            split_merged_lanes(ms, B, K, N, T_lane, n_lm),
            out_lanes,
        )

    run.pre, run.refine, run.post = run_pre, run_refine, run_post
    run.refine_merged = run_refine_merged
    run.batched_lanes = run_batched_lanes
    return run


def split_merged_lanes(ms: MapState, B: int, K: int, N: int, T_lane: int,
                       lane_lm: jnp.ndarray) -> MapState:
    """Split a lane-merged MapState (B*K keyframe slots, lane-major
    contiguous landmark allocation — what the ``lanes=B`` folded pipeline
    builds) into per-lane MapStates stacked on a leading [B] axis.

    Lane b's landmarks occupy merged rows [start_b, start_b + lane_lm[b])
    where start_b is the exclusive cumsum of ``lane_lm`` — the contiguous
    allocator runs lane-major, so a dynamic slice + link re-offset
    reproduces exactly the table a per-lane build would have produced
    (per-lane physical capacity K*N + N padding; the merged physical size
    B*K*N + N guarantees every slice fits without clamping)."""
    starts = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(lane_lm)]
    )[:B]
    Lp_lane = K * N + N
    row = jnp.arange(Lp_lane)

    def one(b, start, n_b):
        sl = lambda x: jax.lax.dynamic_slice_in_dim(x, b * K, K, axis=0)
        flm = sl(ms.kf_feat_lm)
        flm = jnp.where(flm >= 0, flm - start, flm)
        kf_id = sl(ms.kf_id)
        kf_id = jnp.where(kf_id >= 0, kf_id - b * T_lane, -1)  # within-lane
        alive = jax.lax.dynamic_slice(ms.lm_alive, (start,), (Lp_lane,))
        obs = jax.lax.dynamic_slice(ms.lm_obs, (start,), (Lp_lane,))
        return MapState(
            kf_q=sl(ms.kf_q), kf_t=sl(ms.kf_t), kf_id=kf_id,
            kf_px=sl(ms.kf_px), kf_desc=sl(ms.kf_desc),
            kf_fvalid=sl(ms.kf_fvalid), kf_feat_lm=flm,
            kf_depth=sl(ms.kf_depth),
            lm_pos=jax.lax.dynamic_slice(ms.lm_pos, (0, start),
                                         (3, Lp_lane)),
            lm_alive=alive & (row < n_b),
            lm_obs=jnp.where(row < n_b, obs, 0),
            next_kf=jnp.sum(kf_id >= 0).astype(jnp.int32),
            next_lm=n_b,
            lm_dropped=jnp.zeros((), jnp.int32),
        )

    return jax.vmap(one)(
        jnp.arange(B, dtype=jnp.int32), starts, lane_lm.astype(jnp.int32)
    )


def default_lane_kf_capacity(T: int) -> int:
    """Keyframe capacity for a T-frame lane: per-lane costs (map build,
    keyframe chain, GBA) are O(K) regardless of T, so an oversized K
    dilutes short lanes. The keyframe policy's min_keyframe_gap=3 bounds
    keyframes per lane at ceil(T/3)+1 for ANY data, so ceil(T/3)+8 never
    overflows at default options (overflow would only drop the OLDEST
    keyframes; affected frames fall back to VO-anchored poses). Measured
    on 8x120-frame folded lanes: K 76 -> 48 was +80 aggregate fps.
    Shared by the batched mode and the bench's short-input configs."""
    return max(16, min(128, -(-T // 3) + 8))


def build_keyframe_map(
    cam: CameraParams,
    opts: TrackingOptions,
    kf_q: jnp.ndarray,        # [K,4]
    kf_t: jnp.ndarray,        # [K,3]
    kf_id: jnp.ndarray,       # [K] int32, -1 = dead slot (ascending ids)
    kf_px: jnp.ndarray,       # [K,N,2]
    kf_desc: jnp.ndarray,     # [K,N,32] uint8
    kf_fvalid: jnp.ndarray,   # [K,N]
    kf_depth: jnp.ndarray,    # [K,N]
    lm_capacity: int,
    pair_chunk: int = 16,
    pair_valid: jnp.ndarray | None = None,  # [K-1] mask (lane-merged maps:
                                            # False across lane blocks)
    link_strides: tuple[int, ...] = (1,),   # extra passes (e.g. (1, 2))
                                            # give landmarks 3rd views —
                                            # see _link_consecutive_keyframes
    retriangulate: bool = False,            # re-triangulate adopted
                                            # landmarks from their two
                                            # KEYFRAME views (mono mode)
    takeover: bool = False,                 # adoption REPLACES the
                                            # target's own 1-obs landmark
                                            # (mono mode; parity passes)
) -> MapState:
    """Build a MapState from posed keyframe observations in ONE batch:
    depth-backprojected landmarks (tracking.cpp:586-650 semantics) with
    contiguous sorted-scatter allocation, then multi-view observation links
    from consecutive-pair matching. Shared by the offline pipeline and the
    archived-keyframe full-map global BA (BASELINE config 4)."""
    K, N = kf_fvalid.shape
    kvalid = kf_id >= 0
    kf_fvalid = kf_fvalid & kvalid[:, None]

    want = kf_fvalid & (kf_depth >= stages.MIN_DEPTH) & (
        kf_depth <= stages.MAX_DEPTH
    )
    pc = jax.vmap(lambda p, d: backproject(cam, p, d))(kf_px, kf_depth)
    pw = jax.vmap(lambda q, t, x: se3_apply(se3_inverse(Pose(q, t)), x))(
        kf_q, kf_t, pc
    )  # [K,N,3] world
    want_flat = want.reshape(-1)
    rank = jnp.cumsum(want_flat.astype(jnp.int32)) - 1
    L = lm_capacity
    ok_alloc = want_flat & (rank < L)
    slots_flat = jnp.where(ok_alloc, rank, FREE)
    n_created = jnp.sum(ok_alloc).astype(jnp.int32)

    Lp = L + N
    scatter_idx = jnp.where(ok_alloc, rank, Lp)
    # rows with ok_alloc carry ascending ranks but invalid rows (-> Lp)
    # interleave; one stable sort makes the scatter truly sorted
    order = jnp.argsort(scatter_idx)
    sidx = scatter_idx[order]
    pos_cm = jnp.zeros((3, Lp), jnp.float32).at[:, sidx].set(
        pw.reshape(-1, 3).T[:, order], indices_are_sorted=True, mode="drop"
    )
    lm_alive = jnp.zeros((Lp,), bool).at[sidx].set(
        True, indices_are_sorted=True, mode="drop"
    )
    lm_obs = jnp.zeros((Lp,), jnp.int32).at[sidx].set(
        1, indices_are_sorted=True, mode="drop"
    )

    ms = MapState(
        kf_q=kf_q,
        kf_t=kf_t,
        kf_id=kf_id,
        kf_px=kf_px.transpose(0, 2, 1),
        kf_desc=kf_desc,
        kf_fvalid=kf_fvalid,
        kf_feat_lm=slots_flat.reshape(K, N),
        kf_depth=kf_depth,
        lm_pos=pos_cm,
        lm_alive=lm_alive,
        lm_obs=lm_obs,
        next_kf=jnp.sum(kvalid).astype(jnp.int32),
        next_lm=jnp.minimum(n_created, L),
        lm_dropped=(jnp.sum(want_flat) - n_created).astype(jnp.int32),
    )

    # link keyframe pairs by descriptor matching so landmarks gain
    # multi-view observations for BA (two-view DLT creation is unnecessary
    # here — depth already fixes the geometry; what BA needs is the
    # observation links)
    if takeover:
        # mono: two parity sub-passes — even pairs (0-1, 2-3, ...) then
        # odd pairs (1-2, 3-4, ...) — so within a pass no keyframe is both
        # a query and a train (orphan kills are then safe), while the odd
        # pass re-exports landmarks adopted in the even pass, reproducing
        # the reference's sequential chain (3-view landmarks across
        # consecutive keyframe triples)
        parity = jnp.arange(K - 1) % 2
        base_pv = (pair_valid if pair_valid is not None
                   else jnp.ones((K - 1,), bool))
        adopter = jnp.full((K, N), -1, jnp.int32)
        creator = jnp.full((K, N), -1, jnp.int32)
        for p in (0, 1):
            ms, ad_p, cr_p = _link_consecutive_keyframes(
                ms, cam, opts, pair_chunk, base_pv & (parity == p),
                takeover=True,
            )
            adopter = jnp.where(ad_p >= 0, ad_p, adopter)
            creator = jnp.where(cr_p >= 0, cr_p, creator)
    else:
        ms, adopter, creator = _link_consecutive_keyframes(
            ms, cam, opts, pair_chunk, pair_valid
        )
    # additional stride passes enrich the map only (PairLinks stays the
    # stride-1 pairwise structure pair_ba consumes); each pass adopts into
    # features still FREE after the previous ones
    for s in link_strides:
        if s == 1:
            continue
        pv = None
        if pair_valid is not None:
            # same-lane for stride s: the stride-1 lane mask composed
            pv = jnp.ones((K - s,), bool)
            for j in range(s):
                pv = pv & pair_valid[j:j + K - s]
        ms, _, _ = _link_consecutive_keyframes(
            ms, cam, opts, pair_chunk, pv, stride=s
        )

    if retriangulate:
        # MONO landmark polish: positions were backprojected from the
        # scale chain's SYNTHESIZED depths — triangulated at ~1-frame
        # baselines, the dominant noise source of the mono re-track
        # (measured: per-frame log-scale jitter up to +-2, not smooth
        # drift). Landmarks with an adoption link are seen from TWO
        # KEYFRAMES (~min_keyframe_gap x the baseline): re-triangulating
        # those by DLT under the chained keyframe poses cuts depth noise
        # by the baseline ratio. Gated by two-sided reprojection; each
        # landmark has exactly one creating (k, n) row, so the update is
        # a collision-free sorted scatter. (RGB-D keeps sensor depth —
        # metric and already low-noise.)
        from ..models.estimation import projection_matrix, triangulate_dlt

        from ..ops.camera import project_pinhole

        pose_k = Pose(kf_q[:-1], kf_t[:-1])
        pose_n = Pose(kf_q[1:], kf_t[1:])
        P1 = jax.vmap(lambda q, t: projection_matrix(cam, Pose(q, t)))(
            pose_k.q, pose_k.t)
        P2 = jax.vmap(lambda q, t: projection_matrix(cam, Pose(q, t)))(
            pose_n.q, pose_n.t)
        px_a = jnp.swapaxes(ms.kf_px[:-1], 1, 2)          # [K-1,N,2]
        px_b_all = jnp.swapaxes(ms.kf_px[1:], 1, 2)
        ad = adopter[:-1]                                  # [K-1,N]
        px_b = jnp.take_along_axis(
            px_b_all, jnp.maximum(ad, 0)[..., None], axis=1
        )
        X = jax.vmap(triangulate_dlt)(P1, P2, px_a, px_b)  # [K-1,N,3]
        uv1, z1ok, _ = project_pinhole(
            cam, Pose(pose_k.q[:, None, :], pose_k.t[:, None, :]), X)
        uv2, z2ok, _ = project_pinhole(
            cam, Pose(pose_n.q[:, None, :], pose_n.t[:, None, :]), X)
        err1 = jnp.linalg.norm(uv1 - px_a, axis=-1)
        err2 = jnp.linalg.norm(uv2 - px_b, axis=-1)
        lm_here = ms.kf_feat_lm[:-1]
        good = (
            (ad >= 0) & (lm_here >= 0)
            & jnp.all(jnp.isfinite(X), axis=-1)
            & z1ok & z2ok
            & (err1 <= opts.triangulation_max_reproj_error)
            & (err2 <= opts.triangulation_max_reproj_error)
        )
        Lp = ms.lm_physical
        flat_lm = jnp.where(good, lm_here, Lp).reshape(-1)
        order2 = jnp.argsort(flat_lm)
        ms = ms._replace(lm_pos=ms.lm_pos.at[:, flat_lm[order2]].set(
            jnp.where(good[..., None], X, 0.0).reshape(-1, 3).T[:, order2],
            indices_are_sorted=True, mode="drop",
        ))

    links = PairLinks(
        created=ok_alloc.reshape(K, N),
        adopter=adopter,
        creator=creator,
        order=order,
        sidx=sidx,
    )
    return ms, links


def _link_consecutive_keyframes(ms: MapState, cam: CameraParams,
                                opts: TrackingOptions, pair_chunk: int = 16,
                                pair_valid: jnp.ndarray | None = None,
                                stride: int = 1, takeover: bool = False):
    """Give landmarks multi-view observation links: match each keyframe to
    the keyframe ``stride`` slots ahead and point the later frame's matched
    features at the earlier one's landmarks (the observation structure the
    reference builds via TriangulateWithLastKeyFrame + depth creation,
    tracking.cpp:856-929). One batched match over all such keyframe pairs.

    Because ``lm_prev`` is read from the PRE-adoption table, adoption never
    chains within a pass: every landmark gains at most one observation per
    pass. Returns ``(ms, adopter, creator)`` [K,N] int32 link tables
    exposing the pass's structure (see models/pair_ba.PairLinks):
    ``adopter[k,n]`` = the kf k+stride feature observing the landmark of
    slot (k,n), or -1; ``creator[k,m]`` = the kf k-stride slot whose
    landmark feature (k,m) adopted, or -1. A second ``stride=2`` pass on
    the remaining FREE features (build_keyframe_map ``link_strides``)
    gives landmarks a third view — two-hop coupling that stiffens global
    BA's relative-scale propagation, which is what bounds monocular
    drift (the chain's scale errors are otherwise only locally
    constrained). ``pair_valid``: [K-stride] mask (lane-merged maps mask
    cross-lane pairs)."""
    K = ms.kf_capacity
    s = stride

    res = _chunked_vmap(
        matching.match_frames, pair_chunk,
        ms.kf_desc[: K - s], ms.kf_fvalid[: K - s],
        ms.kf_desc[s:], ms.kf_fvalid[s:],
    )  # query = kf k, train = kf k+s

    lm_prev = ms.kf_feat_lm[: K - s]                  # [K-s,N]
    lm_next = ms.kf_feat_lm[s:]
    # adopt the predecessor's landmark where the successor's feature has
    # none; verify geometric consistency by reprojection into the successor
    L = ms.lm_physical
    lmi = jnp.clip(lm_prev, 0, L - 1)
    pw = jnp.moveaxis(ms.lm_pos[:, lmi], 0, -1)        # [K-s,N,3]
    pose_next = Pose(ms.kf_q[s:, None, :], ms.kf_t[s:, None, :])
    from ..ops.camera import project_pinhole

    uv, ok_z, _ = project_pinhole(cam, pose_next, pw)
    px_next = jnp.swapaxes(ms.kf_px[s:], 1, 2)         # [K-s,N,2]
    px_at = jnp.take_along_axis(px_next, res.idx[..., None], axis=1)
    err = jnp.linalg.norm(uv - px_at, axis=-1)
    adopt = (
        res.valid
        & (lm_prev >= 0)
        & ok_z
        & (err <= opts.triangulation_max_reproj_error)
    )
    if pair_valid is not None:  # lane-merged maps: no cross-lane adoption
        adopt = adopt & pair_valid[:, None]
    target_prev = jnp.take_along_axis(lm_next, res.idx, axis=1)
    if not takeover:
        # target feature of kf k+s gains the link only if currently FREE
        adopt = adopt & (target_prev < 0)
    # with ``takeover`` (mono): the target's own single-observation
    # synthesized-depth landmark is REPLACED by the matched predecessor's
    # — the reference's monocular map consists solely of shared two-view
    # landmarks (TriangulateWithLastKeyFrame), and global BA only
    # optimizes landmarks with >= 2 observations, so without takeover the
    # mono map is almost entirely 1-obs landmarks BA cannot touch.
    # Callers must sequence takeover passes so a pair's TRAIN keyframe is
    # not simultaneously another pair's QUERY (parity sub-passes): the
    # orphaned landmark's only observer is the train feature itself,
    # making the kill below safe.

    # dedupe: one query per train feature (best distance first)
    combo = jnp.where(adopt, res.idx.astype(jnp.float32) * 512.0
                      + jnp.minimum(res.dist, 511.0), jnp.inf)
    order = jnp.argsort(combo, axis=1)
    key_sorted = jnp.take_along_axis(
        jnp.where(adopt, res.idx, -1), order, axis=1
    )
    first = jnp.concatenate(
        [jnp.ones_like(key_sorted[:, :1], bool),
         key_sorted[:, 1:] != key_sorted[:, :-1]], axis=1,
    )
    winner_sorted = first & (key_sorted >= 0)
    inv = jnp.argsort(order, axis=1)
    adopt = adopt & jnp.take_along_axis(winner_sorted, inv, axis=1)

    N = ms.n_features
    rows = jnp.where(adopt, res.idx, N)
    row_order = jnp.argsort(rows, axis=1)
    links_sorted = jnp.take_along_axis(
        jnp.where(adopt, lm_prev, 0), row_order, axis=1
    )
    rows_sorted = jnp.take_along_axis(rows, row_order, axis=1)
    new_next = jax.vmap(
        lambda tbl, rr, vv: tbl.at[rr].set(
            vv, indices_are_sorted=True, mode="drop")
    )(lm_next, rows_sorted, links_sorted)
    kf_feat_lm = ms.kf_feat_lm.at[s:].set(new_next)

    # pairwise link tables (structure consumed by models/pair_ba): the
    # same row-sorted scatter, carrying the QUERY slot index instead of
    # the landmark id
    qidx = jnp.broadcast_to(
        jnp.arange(N, dtype=jnp.int32)[None, :], adopt.shape
    )
    qidx_sorted = jnp.take_along_axis(
        jnp.where(adopt, qidx, -1), row_order, axis=1
    )
    creator_rows = jax.vmap(
        lambda rr, vv: jnp.full((N,), -1, jnp.int32).at[rr].set(
            vv, indices_are_sorted=True, mode="drop")
    )(rows_sorted, qidx_sorted)
    creator = jnp.concatenate(
        [jnp.full((s, N), -1, jnp.int32), creator_rows]
    )
    adopter = jnp.concatenate(
        [jnp.where(adopt, res.idx, -1).astype(jnp.int32),
         jnp.full((s, N), -1, jnp.int32)]
    )

    # observation counts: +1 per adopted link
    flat = jnp.sort(jnp.where(adopt, lmi, L).reshape(-1))
    lm_obs = ms.lm_obs.at[flat].add(
        jnp.int32(1), indices_are_sorted=True, mode="drop"
    )
    lm_alive = ms.lm_alive
    if takeover:
        # kill the orphaned targets' previous landmarks (their only
        # observer just relinked — see parity note above)
        orphan = jnp.where(adopt & (target_prev >= 0),
                           jnp.clip(target_prev, 0, L - 1), L)
        oflat = jnp.sort(orphan.reshape(-1))
        lm_alive = lm_alive.at[oflat].set(
            False, indices_are_sorted=True, mode="drop")
        lm_obs = lm_obs.at[oflat].set(
            0, indices_are_sorted=True, mode="drop")
    return (ms._replace(kf_feat_lm=kf_feat_lm, lm_obs=lm_obs,
                        lm_alive=lm_alive), adopter, creator)


def _scale_loop_correction(
    cam: CameraParams,
    opts: TrackingOptions,
    desc: jnp.ndarray,      # [T,N,32] per-frame descriptors
    valid: jnp.ndarray,     # [T,N]
    px: jnp.ndarray,        # [T,N,2]
    dfeat: jnp.ndarray,     # [T,N] world-scale synthesized feature depths
    frame_q: jnp.ndarray,   # [T,4] rotation-only VO prefix (T_cw quats)
    B_lanes: int,
    min_gap: int,
    min_inliers: int,
    key: jax.Array,
    max_rot_deg: float = 35.0,
    min_sim: float = 0.55,
    min_depth_count: int = 16,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Monocular scale-drift anchoring (the mono analog of a Sim(3)
    pose-graph relaxation, reduced to the 1D scale mode that dominates
    the consecutive-pair chain).

    Two measured facts shape the design (VERDICT r4 #3 line of work):

    - raw landmark-merge + bundle adjustment CANNOT fix scale-chain
      drift: the chain's thousands of within-segment observations resist
      the few hundred loop links and BA settles on a bent compromise
      measurably WORSE than the drift it replaced (0.27 -> 0.39 m
      scale-aligned on an exact two-loop revisit);
    - the chain's scale error is a RANDOM WALK, not a ramp (measured
      per-loop scale ratios 1.70 / 0.87 / 2.28 / 0.34 on the four-loop
      bench shape), so a single-pair constant-rate correction is
      useless.

    The anchoring is therefore PER FRAME: every frame whose best earlier
    same-lane revisit candidate passes the gates snaps its log-scale to
    the partner's via the difference of the two frames' median log
    synthesized depths (a same-pose revisit sees the same scene, so the
    medians agree up to accumulated drift — and no per-feature
    intersection is needed, which matters because synthesized depths are
    sparse at small baselines). Verification is NOT epipolar — a true
    revisit has ~zero baseline, exactly where essential estimation
    degenerates (measured: 1 "inlier" on an exact revisit) — but
    similarity + the VO chain's own relative rotation: drift-small for a
    true revisit, large for a same-scene opposite-viewpoint pair whose
    depth ratio is real parallax. Corrections are smoothed over a
    5-frame window to keep sparse-depth median noise out of individual
    steps; unverified frames (all of them, on a loop-free scene) carry
    factor 1.

    Returns (factor [T] — per-frame scale multipliers, verified [B] —
    any frame verified per lane).
    """
    T, N = valid.shape
    T_lane = T // B_lanes

    # ---- global descriptors + within-lane earlier revisit partners ----
    bits = matching.unpack_bits(desc).astype(jnp.int8)          # [T,N,256]
    G = jnp.einsum("tnb,tn->tb", bits.astype(jnp.float32),
                   valid.astype(jnp.float32))
    G = G / jnp.maximum(
        jnp.sum(valid, axis=1).astype(jnp.float32)[:, None], 1.0) - 0.5
    Gn = G / jnp.maximum(jnp.linalg.norm(G, axis=1, keepdims=True), 1e-9)
    sim = Gn @ Gn.T                                             # [T,T]
    tl = jnp.arange(T) % T_lane
    lane = jnp.arange(T) // T_lane
    cand = (
        (lane[:, None] == lane[None, :])
        & ((tl[:, None] - tl[None, :]) >= min_gap)   # partner EARLIER
    )
    simm = jnp.where(cand, sim, -jnp.inf)
    part = jnp.argmax(simm, axis=1).astype(jnp.int32)           # [T]
    psim = jnp.max(simm, axis=1)

    # ---- per-frame gates: similarity floor, VO-rotation consistency,
    # enough valid depths on both ends, sane magnitude ----
    from ..ops.se3 import quat_to_matrix

    R = quat_to_matrix(frame_q)                                 # [T,3,3]
    R_rel = jnp.einsum("tij,tkj->tik", R, R[part])              # t <- partner
    cos_ang = jnp.clip(
        (jnp.einsum("tii->t", R_rel) - 1.0) * 0.5, -1.0, 1.0)
    dvalid = dfeat > 1e-6
    cnt = jnp.sum(dvalid, axis=1)                               # [T]
    ld = jnp.where(dvalid, jnp.log(jnp.maximum(dfeat, 1e-9)), jnp.nan)
    med = jnp.nan_to_num(jnp.nanmedian(ld, axis=1))             # [T]
    delta_raw = med - med[part]
    ver = (
        jnp.isfinite(psim) & (psim >= min_sim)
        & (cos_ang >= jnp.cos(jnp.deg2rad(max_rot_deg)))
        & (cnt >= min_depth_count) & (cnt[part] >= min_depth_count)
        & (jnp.abs(delta_raw) <= jnp.log(4.0))
    )
    delta = jnp.where(ver, delta_raw, 0.0)

    # ---- smooth within a 5-frame window (verified-weighted box),
    # PER LANE: a flat convolve would leak corrections across folded
    # lane boundaries and break folded == single-lane parity ----
    w = ver.astype(jnp.float32)
    kern = jnp.ones((5,), jnp.float32)
    conv = jax.vmap(lambda x: jnp.convolve(x, kern, mode="same"))
    num = conv((delta * w).reshape(B_lanes, T_lane)).reshape(T)
    den = conv(w.reshape(B_lanes, T_lane)).reshape(T)
    delta_s = jnp.where(den > 0, num / jnp.maximum(den, 1.0), 0.0)
    factor = jnp.exp(-delta_s)
    import os as _os

    if _os.environ.get("VXS_DEBUG_LOOPSCALE"):
        jax.debug.print(
            "loopscale verified={v}/{t} delta[min,max]=({a},{b})",
            v=jnp.sum(ver), t=T, a=jnp.min(delta_s), b=jnp.max(delta_s))
    return factor, jnp.any(ver.reshape(B_lanes, T_lane), axis=1)


def _close_loops(ms: MapState, cam: CameraParams, opts: TrackingOptions,
                 n_pairs: int, min_gap_frames: int, min_inliers: int,
                 key: jax.Array, ransac_hypotheses: int = 64,
                 slots_per_lane: int | None = None,
                 max_rot_deg: float = 35.0):
    """Monocular loop closure as LANDMARK MERGES: detect revisits by
    global-descriptor similarity, verify each candidate keyframe pair with
    pair-internal epipolar RANSAC (drift-independent — map reprojection
    would reject exactly the links loop closure exists to create), and
    merge the later keyframe's landmarks into the earlier one's. The merged
    landmarks carry observations from BOTH ends of the loop, so the wide
    first global-BA phase (see run_refine) can redistribute accumulated
    drift around the chain — the structural error mono's consecutive-pair
    scale chain cannot observe (module docstring). The reference has no
    loop closing (its mono drift is unbounded by design, tracking.cpp's
    chain is strictly sequential); this pass is an added capability in the
    spirit of SURVEY §2's global-BA addition.

    Mechanics, all fixed-shape:
      1. place recognition: per-keyframe bag-of-bits descriptor (mean ORB
         bit rate over valid features, centered), cosine similarity on the
         GEMM; candidates = pairs >= ``min_gap_frames`` apart (time-ordered:
         train strictly later).
      2. per-query best train + greedy top-``n_pairs`` with slot
         uniqueness (a tiny K-step scan) — no keyframe serves twice, so
         merges cannot chain through a shared endpoint's table.
      3. feature match (the standard knn2-ratio + distance filter) and
         essential RANSAC; a pair contributes only with >= ``min_inliers``
         verified correspondences.
      4. merge: remap[late_lm] = early_lm for every inlier correspondence
         where both features hold live landmarks. Chain-forming merges
         (a keep-target that is merged away elsewhere, or vice versa) are
         dropped so ONE gather remaps the whole table; observation counts
         are rebuilt by histogram and late landmarks die.

    Returns (ms, n_pairs_verified, n_links_merged)."""
    K, N = ms.kf_fvalid.shape
    Lp = ms.lm_physical
    kvalid = ms.kf_id >= 0
    fvalid = ms.kf_fvalid & kvalid[:, None]

    # ---- 1. place recognition ----
    bits = matching.unpack_bits(ms.kf_desc).astype(jnp.float32)  # [K,N,256]
    G = jnp.einsum("knb,kn->kb", bits, fvalid.astype(jnp.float32))
    G = G / jnp.maximum(
        jnp.sum(fvalid, axis=1).astype(jnp.float32)[:, None], 1.0) - 0.5
    Gn = G / jnp.maximum(jnp.linalg.norm(G, axis=1, keepdims=True), 1e-9)
    sim = Gn @ Gn.T                                              # [K,K]
    gap = ms.kf_id[None, :] - ms.kf_id[:, None]   # train - query, frames
    cand = kvalid[:, None] & kvalid[None, :] & (gap >= min_gap_frames)
    if slots_per_lane is not None and slots_per_lane < K:
        # folded multi-lane map (lanes concatenated along the slot axis):
        # loop candidates must stay WITHIN a lane block — cross-lane
        # keyframes image unrelated scenes, and a cross-lane merge would
        # couple two lanes' landmark tables (breaking the sharded ==
        # unsharded invariant). Within a lane, kf_id gaps are folded-axis
        # differences, which equal within-lane frame gaps.
        lane_of = jnp.arange(K) // slots_per_lane
        cand = cand & (lane_of[:, None] == lane_of[None, :])
    simm = jnp.where(cand, sim, -jnp.inf)
    best_t = jnp.argmax(simm, axis=1).astype(jnp.int32)         # [K]
    best_s = jnp.max(simm, axis=1)

    # ---- 2. greedy slot-unique top-n_pairs, budgeted PER LANE so a
    # folded run selects exactly the pairs each lane's single-lane run
    # would (the folded==single parity the sharded mode is pinned to) ----
    order = jnp.argsort(-best_s).astype(jnp.int32)

    def greedy(used, qi):
        ti = best_t[qi]
        ok = jnp.isfinite(best_s[qi]) & ~used[qi] & ~used[ti]
        used = used.at[qi].set(ok | used[qi])
        used = used.at[ti].set(ok | used[ti])
        return used, ok

    _, ok_seq = jax.lax.scan(greedy, jnp.zeros((K,), bool), order)
    spl = slots_per_lane if (slots_per_lane is not None) else K
    n_lanes = K // spl
    per_lane = n_pairs // n_lanes
    lane_sel = (order // spl)                               # lane of entry
    # rank within the entry's lane among accepted pairs (greedy order)
    onehot = (lane_sel[:, None] == jnp.arange(n_lanes)[None, :]) & \
        ok_seq[:, None]
    rank_lane = jnp.take_along_axis(
        jnp.cumsum(onehot.astype(jnp.int32), axis=0) - 1,
        lane_sel[:, None], axis=1)[:, 0]
    put = jnp.where(ok_seq & (rank_lane < per_lane),
                    lane_sel * per_lane + rank_lane, n_pairs)
    qs = jnp.full((n_pairs,), -1, jnp.int32).at[put].set(order, mode="drop")
    ts = jnp.full((n_pairs,), -1, jnp.int32).at[put].set(
        best_t[order], mode="drop")
    active = qs >= 0
    qc = jnp.maximum(qs, 0)
    tc = jnp.maximum(ts, 0)

    # ---- 3. match + MAP-rotation verification. NOT epipolar: a true
    # revisit pair has ~zero baseline — exactly where essential
    # estimation degenerates — while a same-scene OPPOSITE-viewpoint
    # pair (real parallax, not drift; merging it degrades the solution,
    # measured 0.27 -> 0.39 m) passes epipolar trivially. The map's own
    # relative rotation separates the two: drift-small for true
    # revisits, large for cross-orbit pairs. ----
    res = _chunked_vmap(
        matching.match_frames, n_pairs,
        ms.kf_desc[qc], fvalid[qc] & active[:, None],
        ms.kf_desc[tc], fvalid[tc],
    )
    inl = res.valid & active[:, None]                           # [P,N]
    pair_ok = active & (jnp.sum(inl, axis=1) >= min_inliers)

    from ..ops.se3 import quat_to_matrix

    Rq = quat_to_matrix(ms.kf_q[qc])                            # [P,3,3]
    Rt = quat_to_matrix(ms.kf_q[tc])
    R_map = jnp.einsum("pij,pkj->pik", Rt, Rq)                  # Rt Rq^T
    tr = jnp.einsum("pii->p", R_map)
    cos_ang = jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    pair_ok = pair_ok & (cos_ang >= jnp.cos(jnp.deg2rad(max_rot_deg)))

    # ---- 4. conflict-free landmark merge ----
    lmq = ms.kf_feat_lm[qc]                                     # [P,N]
    lmt = jnp.take_along_axis(ms.kf_feat_lm[tc], res.idx, axis=1)
    okl = (
        inl & pair_ok[:, None]
        & (lmq >= 0) & (lmt >= 0) & (lmq != lmt)
        & ms.lm_alive[jnp.clip(lmq, 0, Lp - 1)]
        & ms.lm_alive[jnp.clip(lmt, 0, Lp - 1)]
    )
    keep_f = jnp.where(okl, lmq, Lp).reshape(-1)   # early lm: survives
    die_f = jnp.where(okl, lmt, Lp).reshape(-1)    # late lm: merged away
    in_keep = jnp.zeros((Lp + 1,), bool).at[keep_f].set(True)[:Lp]
    in_die = jnp.zeros((Lp + 1,), bool).at[die_f].set(True)[:Lp]
    safe = (okl
            & ~in_die[jnp.clip(lmq, 0, Lp - 1)]    # keep-lm merged away?
            & ~in_keep[jnp.clip(lmt, 0, Lp - 1)])  # die-lm kept elsewhere?
    src = jnp.where(safe, lmt, Lp).reshape(-1)
    dst = jnp.where(safe, lmq, 0).reshape(-1).astype(jnp.int32)
    remap = jnp.arange(Lp, dtype=jnp.int32).at[src].set(dst, mode="drop")
    flm = ms.kf_feat_lm
    new_flm = jnp.where(flm >= 0, remap[jnp.clip(flm, 0, Lp - 1)], flm)
    killed = jnp.zeros((Lp + 1,), bool).at[src].set(True)[:Lp]
    lm_alive = ms.lm_alive & ~killed
    flat = jnp.sort(
        jnp.where(fvalid & (new_flm >= 0), new_flm, Lp).reshape(-1))
    hist = jnp.zeros((Lp,), jnp.int32).at[flat].add(
        jnp.int32(1), indices_are_sorted=True, mode="drop")
    lm_obs = jnp.where(lm_alive, hist, 0)
    ms = ms._replace(kf_feat_lm=new_flm, lm_alive=lm_alive, lm_obs=lm_obs)
    return ms, jnp.sum(pair_ok).astype(jnp.int32), \
        jnp.sum(safe).astype(jnp.int32)


@lru_cache(maxsize=4)
def _compiled_offline(opts_key, n_features_cap, kf_capacity, lm_capacity,
                      orb_kwargs_tuple, extract_chunk, pair_chunk,
                      pnp_hypotheses, refine_iterations, batched=False,
                      gba_cg_iterations=8, monocular=False,
                      mono_kw_tuple=()):
    opts = TrackingOptions(**dict(opts_key))
    run = build_offline_pipeline(
        None, opts,
        n_features_cap=n_features_cap, kf_capacity=kf_capacity,
        lm_capacity=lm_capacity, orb_kwargs=dict(orb_kwargs_tuple),
        extract_chunk=extract_chunk, pair_chunk=pair_chunk,
        pnp_hypotheses=pnp_hypotheses,
        refine_iterations=refine_iterations,
        gba_cg_iterations=gba_cg_iterations,
        monocular=monocular,
        **dict(mono_kw_tuple),
    )
    if batched:
        return jax.jit(run.batched_lanes)
    return jax.jit(run)


def run_offline_pipeline(
    cam: CameraParams,
    images_u8,            # [T,H,W] uint8
    depths_m,             # [T,H,W] float32
    opts: TrackingOptions,
    n_features_cap: int = 1024,
    kf_capacity: int = 128,
    lm_capacity: int | None = None,
    orb_kwargs: dict | None = None,
    extract_chunk: int = 8,
    pair_chunk: int = 32,
    pnp_hypotheses: int = 16,
    refine_iterations: int = 1,
    gba_cg_iterations: int = 8,
    monocular: bool = False,
    **mono_kw,            # mono budget knobs forwarded to
                          # build_offline_pipeline (mono_pair_hypotheses,
                          # mono_lo_starts, mono_link_strides, ...)
) -> tuple[MapState, OfflineOut]:
    opts_key = tuple(sorted(dataclasses.asdict(opts).items()))
    fn = _compiled_offline(
        opts_key, n_features_cap, kf_capacity, lm_capacity,
        tuple(sorted((orb_kwargs or {}).items())), extract_chunk,
        pair_chunk, pnp_hypotheses, refine_iterations,
        gba_cg_iterations=gba_cg_iterations, monocular=monocular,
        mono_kw_tuple=tuple(sorted(mono_kw.items())),
    )
    return fn(cam, jnp.asarray(images_u8), jnp.asarray(depths_m))


def run_offline_pipeline_batched(
    cam: CameraParams,
    images_u8,            # [B,T,H,W] uint8
    depths_m,             # [B,T,H,W] float32
    opts: TrackingOptions,
    **kw,
) -> tuple[MapState, OfflineOut]:
    """Batched multi-sequence offline mapping (BASELINE config 5 on one
    chip): every stage is already batched over frames, so the sequence
    axis simply vmaps on top — no per-lane branch divergence to pay (the
    reason the batched ONLINE mode lost to single-stream)."""
    opts_key = tuple(sorted(dataclasses.asdict(opts).items()))
    # folded lanes (round 4): the lane axis folds into the frame axis, so
    # chunk sizes are the single-stream ones — a chunk of c covers c
    # frames/pairs TOTAL regardless of B (no per-lane multiplication)
    kw.setdefault("extract_chunk", 8)
    kw.setdefault("pair_chunk", 32)
    T = images_u8.shape[1]
    kw.setdefault("kf_capacity", default_lane_kf_capacity(T))
    kw.setdefault("refine_iterations", 1)
    kw.setdefault("gba_cg_iterations", 8)
    kw.setdefault("n_features_cap", 1024)
    kw.setdefault("pnp_hypotheses", 16)
    # per-lane K*N is the allocator's exact worst case; batched_lanes sizes
    # the merged capacity to B*K*N itself, so lm_dropped == 0 is guaranteed
    kw.setdefault("lm_capacity", kw["kf_capacity"] * kw["n_features_cap"])
    kw.setdefault("monocular", False)
    # forward the mono/retrack budget knobs (anything not consumed above)
    # to build_offline_pipeline — silently dropping them would make the
    # batched mode diverge from the single-lane configuration it must
    # reproduce per lane
    consumed = {
        "extract_chunk", "pair_chunk", "kf_capacity", "refine_iterations",
        "gba_cg_iterations", "n_features_cap", "pnp_hypotheses",
        "lm_capacity", "monocular", "orb_kwargs",
    }
    extra = {k: v for k, v in kw.items() if k not in consumed}
    fn = _compiled_offline(
        opts_key,
        kw["n_features_cap"], kw["kf_capacity"], kw["lm_capacity"],
        tuple(sorted((kw.get("orb_kwargs") or {}).items())),
        kw["extract_chunk"], kw["pair_chunk"], kw["pnp_hypotheses"],
        kw["refine_iterations"], batched=True,
        gba_cg_iterations=kw["gba_cg_iterations"],
        monocular=kw["monocular"],
        mono_kw_tuple=tuple(sorted(extra.items())),
    )
    return fn(cam, jnp.asarray(images_u8), jnp.asarray(depths_m))
