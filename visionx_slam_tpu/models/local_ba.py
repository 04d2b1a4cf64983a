"""Sliding-window local bundle adjustment as batched block Gauss-Newton.

Replaces the reference ``LocalBA`` (core/backend/local_ba.cpp:66-249):
alternating pose/point passes over the last ``window_size`` keyframes with
Huber weighting, reprojection gating, 1e-6 Tikhonov damping, left-mult
SE(3) retraction and a relative-cost convergence test.

Device mapping (SURVEY.md §7.7):
- the pose pass is one vmapped batch over the window: per-keyframe 6x6
  normal equations built with einsum and solved as a [W,6,6] batched solve
  (poses are mutually independent within a pass, so the reference's
  sequential per-keyframe loop batches exactly);
- the point pass is COMPACT: the window's <= W*N observations are sorted
  by landmark once, consecutive runs become dense segment ids, and each
  iteration segment-sums 3x3/3x1 contributions into a [W*N]-bucket table
  and solves [W*N,3,3] systems — never touching the full landmark table
  (the reference iterates exactly the window's landmarks too,
  local_ba.cpp:83-104; an O(L) table pass at L=131k touches ~25x the
  window's actual observation count);
- the iteration loop is a ``lax.scan`` with a ``done`` flag implementing
  the reference's early convergence break (|last-cost|<1e-6*last,
  local_ba.cpp:244-246) as masked no-op iterations.

Semantics preserved: Huber weight delta/err beyond delta (:35-40), the
5 px reprojection gate (:147-150, :213-215), min_pose_observations /
min_point_observations gates (:163, :228), pose-pass cost accounting
(:158-159), landmark eligibility by GLOBAL observation count (:100), and
the z>1e-6 projection validity (projection.h).

DELIBERATE FIX (documented deviation, SURVEY.md §7 "preserve-or-document"):
the reference accumulates ``b += w * (-J^T err)`` with ``err = measured -
projected`` (local_ba.cpp:156, :224) and then applies ``exp(dx) * T``.
With J = d(proj)/d(xi), Gauss-Newton requires ``dx = +H^{-1} sum(w J^T
err)``; the reference's sign sends updates AWAY from the minimum, after
which its reprojection/min-observation gates freeze further updates. We
implement the correct sign — bundle adjustment then actually reduces
reprojection error (verified in tests/test_local_ba.py against synthetic
ground truth).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.camera import CameraParams
from ..ops.se3 import Pose, quat_to_matrix, se3_compose, se3_exp, so3_hat
from ..tracking import mapstate as msl
from ..tracking.mapstate import MapState


class BAOptions(NamedTuple):
    """Mirrors LocalBA::Options (core/backend/local_ba.h:12-19)."""

    window_size: int = 5
    max_iterations: int = 5
    min_pose_observations: int = 20
    min_point_observations: int = 2
    huber_delta: float = 5.0
    max_reproj_error: float = 5.0
    # Relative-cost convergence tolerance. The reference's break is
    # |last-cost| < 1e-6*last (local_ba.cpp:244-246) — in float32 GN the
    # cost virtually never settles that far, so the loop runs its full
    # budget doing noise-level updates. Callers on the latency-critical
    # online scan raise this to a plateau tolerance (1e-3: exits once an
    # iteration improves cost by less than 0.1%, 2-3 iterations on a
    # healthy window); the default keeps the reference rule.
    rel_tol: float = 1e-6
    # Run the GN loop as a lax.while_loop that STOPS at the reference's
    # convergence test (|last-cost| < 1e-6*last, local_ba.cpp:244-246)
    # instead of a fixed-length lax.scan with masked no-op iterations —
    # converged iterations then cost nothing. Semantically identical (the
    # masked scan applies no updates after convergence either); the scan
    # remains the default because under a lane vmap a while_loop runs to
    # the max over lanes anyway. The online scan pipeline (BASELINE
    # config 1, not vmapped) enables it: local BA is ~1/3 of its frame
    # budget and typically converges in 2-3 of the 5 budgeted iterations.
    early_exit: bool = False


class BAStats(NamedTuple):
    iterations: jnp.ndarray  # int32 — iterations actually applied
    final_cost: jnp.ndarray  # f32   — weighted squared-error cost
    total_obs: jnp.ndarray   # int32 — observations in the last pose pass


def _proj_jacobian(cam: CameraParams, pc: jnp.ndarray) -> jnp.ndarray:
    """d(pixel)/d(pc): [...,2,3] (reference ProjectionJacobian, local_ba.cpp:15-24)."""
    z = jnp.maximum(pc[..., 2], 1e-6)
    inv_z = 1.0 / z
    zeros = jnp.zeros_like(inv_z)
    return jnp.stack(
        [
            jnp.stack([cam.fx * inv_z, zeros, -cam.fx * pc[..., 0] * inv_z**2], -1),
            jnp.stack([zeros, cam.fy * inv_z, -cam.fy * pc[..., 1] * inv_z**2], -1),
        ],
        -2,
    )


def _huber_w(err_norm: jnp.ndarray, delta: float) -> jnp.ndarray:
    """HuberWeight (local_ba.cpp:35-40): 1 inside delta, delta/err outside."""
    return jnp.where(err_norm <= delta, 1.0, delta / jnp.maximum(err_norm, 1e-12))


@partial(jax.jit, static_argnames=("opts",))
def local_ba(ms: MapState, cam: CameraParams, opts: BAOptions = BAOptions()) -> tuple[MapState, BAStats]:
    """Run windowed alternating GN on the map state; returns updated state."""
    W = max(1, opts.window_size)
    slots, wvalid = msl.window_slots(ms, W)  # [W]
    n_kf = jnp.sum(wvalid)
    L = ms.lm_physical
    N = ms.n_features

    # gather the window's feature tables once (slots are static-shape)
    f_px = jnp.swapaxes(ms.kf_px[slots], 1, 2)  # [W,N,2]
    f_valid = ms.kf_fvalid[slots] & wvalid[:, None]
    f_lm = ms.kf_feat_lm[slots]     # [W,N]

    has_lm = f_valid & (f_lm >= 0)
    lm_idx = jnp.clip(f_lm, 0, L - 1)

    # ---- compact window-landmark index (built ONCE; links are fixed
    # inside BA). Sort the <= W*N observations by landmark id; runs of
    # equal ids become dense buckets. Everything downstream — residual
    # gathers, the per-iteration segment sums, the 3x3 solves — works on
    # the [S = W*N] bucket axis, never the full landmark table. ----
    S = W * N
    base_lm = jnp.where(has_lm, lm_idx, L).reshape(-1)       # [S]
    seg_order = jnp.argsort(base_lm)
    seg_idx = base_lm[seg_order]                             # ascending
    is_new = jnp.concatenate(
        [jnp.ones((1,), bool), seg_idx[1:] != seg_idx[:-1]]
    )
    loc_sorted = jnp.cumsum(is_new.astype(jnp.int32)) - 1    # [S] bucket id
    # bucket -> landmark id (duplicates write the same value; padding
    # buckets keep the drop sentinel so write-back can't clobber slot 0)
    uniq_lm = jnp.full((S,), ms.lm_physical, jnp.int32).at[loc_sorted].set(
        seg_idx.astype(jnp.int32), indices_are_sorted=True
    )                                                        # ascending
    uniq_real = uniq_lm < L
    uniq_clip = jnp.clip(uniq_lm, 0, ms.lm_physical - 1)
    loc_flat = loc_sorted[jnp.argsort(seg_order)].reshape(W, N)

    # landmark eligibility for the POINT pass (local_ba.cpp:93-104):
    # alive, observed in the window, global observation count >= min
    alive_u = ms.lm_alive[uniq_clip] & uniq_real
    lm_eligible_u = alive_u & (
        msl.landmark_observation_counts(ms)[uniq_clip]
        >= opts.min_point_observations
    )

    enabled = (n_kf >= 2) & jnp.any(lm_eligible_u)  # local_ba.cpp:73,106

    q0 = ms.kf_q[slots]
    t0 = ms.kf_t[slots]
    pos0 = ms.lm_pos[:, uniq_clip]  # [3,S] compact window positions

    def residuals(q, t, pos_c):
        """Per-observation projection residuals for the whole window.

        Returns err [W,N,2], pc [W,N,3], obs mask [W,N] after the
        validity + reprojection gates, and huber weights [W,N]."""
        pw = jnp.moveaxis(pos_c[:, loc_flat], 0, -1)  # [W,N,3]
        R = quat_to_matrix(q)                        # [W,3,3]
        pc = jnp.einsum("wij,wnj->wni", R, pw) + t[:, None, :]
        z_ok = pc[..., 2] > 1e-6
        zs = jnp.maximum(pc[..., 2], 1e-6)
        u = cam.fx * pc[..., 0] / zs + cam.cx
        v = cam.fy * pc[..., 1] / zs + cam.cy
        err = f_px - jnp.stack([u, v], -1)           # measured - projected
        err_n = jnp.linalg.norm(err, axis=-1)
        alive = alive_u[loc_flat]
        obs = has_lm & alive & z_ok & (err_n <= opts.max_reproj_error)
        w = _huber_w(err_n, opts.huber_delta)
        return err, pc, obs, w

    def iteration(carry, _):
        q, t, pos_c, last_cost, done, iters = carry

        # ============ POSE PASS (landmarks fixed; local_ba.cpp:117-174) ====
        err, pc, obs, w = residuals(q, t, pos_c)
        ww = jnp.where(obs, w, 0.0)

        cost = jnp.sum(ww * jnp.sum(err * err, -1))
        total_obs = jnp.sum(obs).astype(jnp.int32)

        Jp = _proj_jacobian(cam, pc)                 # [W,N,2,3]
        # rotational block row_i = pc x Jp_i (== Jp @ [I | -hat(pc)] without
        # materializing [W,N,3,6] and its tiny matmuls)
        J = jnp.concatenate([Jp, jnp.cross(pc[..., None, :], Jp)], -1)
        Jf = J.reshape(W, N * 2, 6)
        wf = jnp.repeat(ww, 2, axis=-1)               # [W,2N]
        rf = err.reshape(W, -1)
        Jw = Jf * wf[..., None]
        H = jnp.einsum("wni,wnj->wij", Jw, Jf) + 1e-6 * jnp.eye(6, dtype=pc.dtype)
        b = jnp.einsum("wni,wn->wi", Jw, rf)
        from ..ops.linalg import chol_solve6x6

        # damped SPD: unrolled scalar Cholesky fuses into one kernel —
        # jnp.linalg.solve lowered a [W,6,6] batch to LU loops on the earlier
        # accelerator (chosen there, not yet measured on the H100), and this
        # solve sits on the scan's keyframe-event path
        dx = chol_solve6x6(H, b)  # [W,6]

        pose_obs = jnp.sum(obs, axis=1)
        apply_pose = (
            (pose_obs >= opts.min_pose_observations)
            & wvalid & ~done & enabled
            & jnp.all(jnp.isfinite(dx), axis=-1)
        )
        dx = jnp.where(apply_pose[:, None], dx, 0.0)
        newp = se3_compose(se3_exp(dx), Pose(q, t))   # left retraction (:173)
        q2, t2 = newp.q, newp.t

        # ============ POINT PASS (poses fixed; local_ba.cpp:177-238) =======
        err2, pc2, obs2, w2 = residuals(q2, t2, pos_c)
        obs2 = obs2 & lm_eligible_u[loc_flat]
        ww2 = jnp.where(obs2, w2, 0.0)
        R2 = quat_to_matrix(q2)                       # [W,3,3]
        Jp2 = _proj_jacobian(cam, pc2)                # [W,N,2,3]
        Jpt = jnp.einsum("wnij,wjk->wnik", Jp2, R2)   # [W,N,2,3] J_proj @ R

        Hc = jnp.einsum("wnij,wnik,wn->wnjk", Jpt, Jpt, ww2)  # [W,N,3,3]
        bc = jnp.einsum("wnij,wni,wn->wnj", Jpt, err2, ww2)   # [W,N,3]

        # ONE packed sorted scatter-add into the COMPACT bucket table:
        # [H(9) | b(3) | count(1)] per obs
        contrib = jnp.concatenate(
            [
                Hc.reshape(-1, 9),
                bc.reshape(-1, 3),
                obs2.reshape(-1, 1).astype(pc2.dtype),
            ],
            axis=-1,
        )[seg_order]
        table = jnp.zeros((S, 13), pc2.dtype).at[loc_sorted].add(
            contrib, indices_are_sorted=True, mode="drop"
        )
        Hl = table[:, :9].reshape(S, 3, 3)
        bl = table[:, 9:12]
        cnt = table[:, 12]

        Hl = Hl + 1e-6 * jnp.eye(3, dtype=pc2.dtype)
        # closed-form batched solve: LU on a [S,3,3] batch was pathologically
        # slow on the earlier accelerator (chosen there, not yet measured on
        # the H100); the adjugate form is pure elementwise math
        from ..ops.linalg import solve3x3

        dp = solve3x3(Hl, bl)  # [S,3]
        apply_pt = (
            (cnt >= opts.min_point_observations)
            & lm_eligible_u & ~done & enabled
            & jnp.all(jnp.isfinite(dp), axis=-1)
        )
        pos_c2 = jnp.where(apply_pt[None, :], pos_c + dp.T, pos_c)

        # ============ convergence (local_ba.cpp:240-247) ===================
        converged = (total_obs == 0) | (
            jnp.abs(last_cost - cost) < opts.rel_tol * last_cost
        )
        iters = iters + jnp.where(done | ~enabled, 0, 1)
        done = done | converged

        return (q2, t2, pos_c2, cost, done, iters), (cost, total_obs)

    init = (
        q0, t0, pos0,
        jnp.asarray(jnp.finfo(jnp.float32).max, jnp.float32),
        ~enabled,
        jnp.zeros((), jnp.int32),
    )
    if opts.early_exit:
        # dynamic-trip-count variant: stop at convergence instead of
        # masking (see BAOptions.early_exit). total_obs rides the carry.
        def w_cond(c):
            (_, _, _, _, done, iters), _ = c
            return ~done & (iters < opts.max_iterations)

        def w_body(c):
            carry, _ = c
            carry2, (cost_i, obs_i) = iteration(carry, None)
            return carry2, obs_i

        (q, t, pos_c, cost, done, iters), last_obs = jax.lax.while_loop(
            w_cond, w_body, (init, jnp.zeros((), jnp.int32))
        )
        obs_hist = last_obs[None]
    else:
        (q, t, pos_c, cost, done, iters), (costs, obs_hist) = jax.lax.scan(
            iteration, init, None, length=opts.max_iterations
        )

    # write window poses back (masked by window validity)
    new_q = ms.kf_q.at[slots].set(jnp.where(wvalid[:, None], q, ms.kf_q[slots]))
    new_t = ms.kf_t.at[slots].set(jnp.where(wvalid[:, None], t, ms.kf_t[slots]))
    # scatter the compact window positions back (sorted; padding buckets
    # carry the lm_physical sentinel and drop)
    lm_pos = ms.lm_pos.at[:, uniq_lm].set(
        pos_c, indices_are_sorted=True, mode="drop"
    )
    out = ms._replace(kf_q=new_q, kf_t=new_t, lm_pos=lm_pos)
    return out, BAStats(iterations=iters, final_cost=cost, total_obs=obs_hist[-1])
