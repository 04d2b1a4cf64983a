"""Global bundle adjustment: matrix-free Schur-complement GN with PCG.

The reference has NO global BA (SURVEY.md §5.7: only the 5-keyframe local
window, no loop closure, no pose graph); BASELINE.json config 4 ("global
bundle adjustment over the full fr3 map") requires one. Design
(SURVEY.md §7.7), round-2 revision: the reduced camera system is never
materialized — the Schur complement is applied as an OPERATOR inside
preconditioned conjugate gradients, so the whole solve is gathers, k-major
reductions, and ONE pre-sorted segment scatter per matvec. (The round-1
version scattered per-landmark coupling blocks chunk-by-chunk into
[C,K,6,3] buffers; those 32 large unsorted scatters were 43% of the
offline pipeline's frame budget.)

Structure (K keyframes, L landmarks, observations = map-state links):

- Hll is block-diagonal [L,3,3]; Hpp is block-diagonal [K,6,6]; both built
  with one sorted segment-sum (observations pre-sorted by landmark once —
  the link table is constant across GN iterations).
- S v = (Hpp + λ) v − W Hll⁻¹ Wᵀ v, applied per matvec as:
    Wᵀv : per-obs einsum with a gather of v at the obs' keyframe, then a
          sorted segment-sum into landmarks;
    Hll⁻¹: closed-form batched 3×3 inverse (ops/linalg.py);
    W u : per-obs einsum with a gather of u at the obs' landmark, then a
          k-major [K,N,6] → [K,6] reduction (no scatter at all).
- PCG preconditioner: block-diagonal (Hpp + λ)⁻¹ (batched 6×6 solves, K is
  tiny). Fixed CG iteration count (static shape), converged components
  freeze via masking.
- dx_l back-substitutes landmark-wise.

Gauge freedom is fixed by freezing the OLDEST keyframe's pose (the
reference's local BA leaves the gauge loose inside its window; a global
solve must pin it — documented design choice).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.camera import CameraParams
from ..ops.linalg import inv3x3
from ..ops.se3 import Pose, quat_to_matrix, se3_compose, se3_exp, so3_hat
from ..tracking import mapstate as msl
from ..tracking.mapstate import MapState
from .local_ba import _huber_w, _proj_jacobian


class GlobalBAOptions(NamedTuple):
    max_iterations: int = 10
    huber_delta: float = 5.0
    max_reproj_error: float = 5.0
    min_point_observations: int = 2
    damping: float = 1e-6
    cg_iterations: int = 25


class GlobalBAStats(NamedTuple):
    iterations: jnp.ndarray
    final_cost: jnp.ndarray
    total_obs: jnp.ndarray


@jax.jit
def map_reproj_error(ms: MapState, cam: CameraParams) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(mean reprojection error [px], n_observations) over every live
    keyframe-feature -> landmark link of the map — the fitness metric
    global BA must reduce."""
    K = ms.kf_capacity
    L = ms.lm_physical
    alive_kf = msl.kf_alive(ms)
    f_lm = ms.kf_feat_lm
    has = alive_kf[:, None] & ms.kf_fvalid & (f_lm >= 0)
    lm_idx = jnp.clip(f_lm, 0, L - 1)
    pw = jnp.moveaxis(ms.lm_pos[:, lm_idx], 0, -1)
    R = quat_to_matrix(ms.kf_q)
    pc = jnp.einsum("kij,knj->kni", R, pw) + ms.kf_t[:, None, :]
    z_ok = pc[..., 2] > 1e-6
    zs = jnp.maximum(pc[..., 2], 1e-6)
    u = cam.fx * pc[..., 0] / zs + cam.cx
    v = cam.fy * pc[..., 1] / zs + cam.cy
    err = jnp.linalg.norm(
        jnp.swapaxes(ms.kf_px, 1, 2) - jnp.stack([u, v], -1), axis=-1
    )
    obs = has & ms.lm_alive[lm_idx] & z_ok
    n = jnp.sum(obs)
    mean = jnp.sum(jnp.where(obs, err, 0.0)) / jnp.maximum(n, 1)
    return mean, n.astype(jnp.int32)


@partial(jax.jit, static_argnames=("opts",))
def global_ba(
    ms: MapState, cam: CameraParams, opts: GlobalBAOptions = GlobalBAOptions(),
    gauge_group: jnp.ndarray | None = None,
) -> tuple[MapState, GlobalBAStats]:
    """``gauge_group``: optional [K] int32 lane label per keyframe slot for
    MERGED multi-map solves (the batched offline pipeline concatenates B
    independent lane maps into one MapState so the whole refine is ONE
    sorted-segment-sum solve instead of B serialized ones). Each group's
    oldest alive keyframe is gauge-frozen — B independent components need
    B gauge fixes or B-1 of them are determined only by the damping.
    Default (None): a single group, the plain full-map behavior."""
    K = ms.kf_capacity
    L = ms.lm_physical
    N = ms.n_features
    O = K * N

    alive_kf = msl.kf_alive(ms)                    # [K]
    f_valid = ms.kf_fvalid & alive_kf[:, None]
    f_lm = ms.kf_feat_lm
    has_lm = f_valid & (f_lm >= 0)
    lm_idx = jnp.clip(f_lm, 0, L - 1)

    obs_count = msl.landmark_observation_counts(ms)
    # landmarks below the observation threshold stay CONSTANT: their
    # residuals still constrain poses (as in the reference's pose pass,
    # local_ba.cpp:131-137) but they are excluded from the point update and
    # from the Schur reduction.
    lm_opt = ms.lm_alive & (obs_count >= opts.min_point_observations)

    # gauge fix: freeze the oldest alive keyframe (per gauge group)
    ids = jnp.where(alive_kf, ms.kf_id, jnp.iinfo(jnp.int32).max)
    if gauge_group is None:
        fixed_mask = jnp.arange(K) == jnp.argmin(ids)
    else:
        group_min = jax.ops.segment_min(ids, gauge_group, num_segments=K)
        is_min = alive_kf & (ids == group_min[gauge_group])
        # tie-break to ONE slot per group (ids are unique per lane in
        # practice; this guards merged maps with duplicate ids)
        first = jax.ops.segment_min(
            jnp.where(is_min, jnp.arange(K, dtype=jnp.int32), K),
            gauge_group, num_segments=K,
        )
        fixed_mask = is_min & (jnp.arange(K) == first[gauge_group])
    free_kf = alive_kf & ~fixed_mask
    free6 = free_kf[:, None]                      # [K,1] masks [K,6] vecs

    # Every scalar of the solve (CG step sizes, convergence, cost) is kept
    # PER GAUGE GROUP so a merged multi-lane solve is numerically
    # IDENTICAL to independent per-lane solves: the system is block-
    # diagonal across groups, so per-group alpha/beta make CG decompose
    # exactly (a single global alpha would couple the lanes' iterates).
    # The helpers collapse to plain scalar reductions at TRACE TIME when
    # gauge_group is None, so the common single-map path pays nothing.
    single = gauge_group is None
    grp = None if single else gauge_group.astype(jnp.int32)

    def seg_k(x_k):    # per-keyframe [K] -> per-group ([K] or scalar)
        if single:
            return jnp.sum(x_k)
        return jax.ops.segment_sum(x_k, grp, num_segments=K)

    def to_k(v_g):     # per-group -> per-keyframe (broadcast or gather)
        return v_g if single else v_g[grp]

    # the link table never changes during GBA: sort observations by landmark
    # ONCE, so every per-iteration landmark reduction is a sorted segment-sum
    # (unsorted scatters serialized per element on the earlier accelerator,
    # where this was chosen; not yet measured on the H100)
    flat_lm_all = lm_idx.reshape(-1)               # [O]
    kk = jnp.broadcast_to(jnp.arange(K)[:, None], (K, N)).reshape(-1)
    opt_obs_mask = (has_lm & lm_opt[lm_idx]).reshape(-1)
    perm = jnp.argsort(jnp.where(opt_obs_mask, flat_lm_all, L))  # dead last
    sorted_lm = jnp.where(opt_obs_mask, flat_lm_all, L)[perm]    # ascending
    kk_perm = kk[perm]

    # per-group enabled (>= 2 alive keyframes, any live observed landmark)
    has_any_obs = seg_k(
        jnp.sum(has_lm & ms.lm_alive[lm_idx], axis=1).astype(jnp.int32)
    ) > 0
    enabled_g = (seg_k(alive_kf.astype(jnp.int32)) >= 2) & has_any_obs
    if single:
        lm_grp = None
    else:
        # group of each landmark = group of (any of) its observations; all
        # of a landmark's observations share a lane by construction
        lm_grp = jnp.zeros((L + 1,), jnp.int32).at[sorted_lm].max(
            grp[kk_perm], indices_are_sorted=True, mode="drop"
        )[:L]

    def to_lm(v_g):    # per-group -> per-landmark (broadcast or gather)
        return v_g if single else v_g[lm_grp]

    def seg_sum_lm(per_obs):       # [O, d] -> [L, d], pre-sorted scatter
        d = per_obs.shape[-1]
        return jnp.zeros((L + 1, d), per_obs.dtype).at[sorted_lm].add(
            per_obs[perm], indices_are_sorted=True, mode="drop"
        )[:L]

    def residuals(q, t, lm_pos):
        pw = jnp.moveaxis(lm_pos[:, lm_idx], 0, -1)  # [K,N,3]
        R = quat_to_matrix(q)
        pc = jnp.einsum("kij,knj->kni", R, pw) + t[:, None, :]
        z_ok = pc[..., 2] > 1e-6
        zs = jnp.maximum(pc[..., 2], 1e-6)
        u = cam.fx * pc[..., 0] / zs + cam.cx
        v = cam.fy * pc[..., 1] / zs + cam.cy
        err = jnp.swapaxes(ms.kf_px, 1, 2) - jnp.stack([u, v], -1)
        err_n = jnp.linalg.norm(err, axis=-1)
        obs = (
            has_lm & ms.lm_alive[lm_idx] & z_ok
            & (err_n <= opts.max_reproj_error)
        )
        w = jnp.where(obs, _huber_w(err_n, opts.huber_delta), 0.0)
        return err, pc, obs, w

    def iteration(carry, _):
        q, t, lm_pos, last_cost_g, done_g, iters_g = carry
        err, pc, obs, w = residuals(q, t, lm_pos)

        cost_g = seg_k(jnp.sum(w * jnp.sum(err * err, -1), axis=1))
        total_obs_g = seg_k(jnp.sum(obs, axis=1).astype(jnp.int32))

        # --- per-observation Jacobians ---
        Jp_proj = _proj_jacobian(cam, pc)                       # [K,N,2,3]
        eye3 = jnp.broadcast_to(jnp.eye(3, dtype=pc.dtype), (K, N, 3, 3))
        Jse = jnp.concatenate([eye3, -so3_hat(pc)], -1)          # [K,N,3,6]
        Jpose = Jp_proj @ Jse                                    # [K,N,2,6]
        R = quat_to_matrix(q)
        Jpt = jnp.einsum("knij,kjl->knil", Jp_proj, R)           # [K,N,2,3]

        # --- block-diagonal pose system (k-major reductions, no scatter) --
        Hpp = jnp.einsum("knij,knil,kn->kjl", Jpose, Jpose, w)   # [K,6,6]
        bp = jnp.einsum("knij,kni,kn->kj", Jpose, err, w)        # [K,6]

        # --- landmark system + coupling (optimizable landmarks only) ---
        obs_opt = obs & lm_opt[lm_idx]
        w_opt = jnp.where(obs_opt, w, 0.0)
        Hll_c = jnp.einsum("knij,knil,kn->knjl", Jpt, Jpt, w_opt)  # [K,N,3,3]
        bl_c = jnp.einsum("knij,kni,kn->knj", Jpt, err, w_opt)     # [K,N,3]
        packed = jnp.concatenate(
            [Hll_c.reshape(O, 9), bl_c.reshape(O, 3)], axis=-1
        )
        table = seg_sum_lm(packed)                                 # [L,12]
        Hll = table[:, :9].reshape(L, 3, 3) + opts.damping * jnp.eye(
            3, dtype=pc.dtype
        )
        bl = table[:, 9:]
        Hll_inv = inv3x3(Hll)                                      # [L,3,3]
        Hll_inv_bl = jnp.einsum("lij,lj->li", Hll_inv, bl)         # [L,3]

        Wobs = jnp.einsum(
            "knij,knil,kn->knjl", Jpose, Jpt, w_opt
        ).reshape(O, 6, 3)                                         # W blocks

        def WT_v(v6):  # [K,6] -> [L,3]
            per_obs = jnp.einsum("oij,oi->oj", Wobs, v6[kk])       # [O,3]
            return seg_sum_lm(per_obs)

        def W_u(u3):   # [L,3] -> [K,6]
            u_pad = jnp.concatenate([u3, jnp.zeros((1, 3), u3.dtype)])
            u_at = u_pad[jnp.where(opt_obs_mask, flat_lm_all, L)]  # [O,3]
            per_obs = jnp.einsum("oij,oj->oi", Wobs, u_at)         # [O,6]
            return per_obs.reshape(K, N, 6).sum(axis=1)            # k-major

        lam = opts.damping

        def S_mv(v6):  # [K,6] -> [K,6], gauge rows pinned to identity
            v6 = jnp.where(free6, v6, 0.0)
            hv = jnp.einsum("kij,kj->ki", Hpp, v6) + lam * v6
            sv = hv - W_u(jnp.einsum("lij,lj->li", Hll_inv, WT_v(v6)))
            return jnp.where(free6, sv, v6)

        rhs = bp - W_u(Hll_inv_bl)
        rhs = jnp.where(free6, rhs, 0.0)

        # block-Jacobi preconditioner: (Hpp + λI)^-1 per keyframe
        Hpp_d = Hpp + lam * jnp.eye(6, dtype=pc.dtype)
        eyeK = jnp.broadcast_to(jnp.eye(6, dtype=pc.dtype), (K, 6, 6))
        Hpp_safe = jnp.where(free_kf[:, None, None], Hpp_d, eyeK)
        Pinv = jnp.linalg.inv(Hpp_safe)                            # [K,6,6]

        def prec(r):
            return jnp.where(free6, jnp.einsum("kij,kj->ki", Pinv, r), 0.0)

        # fixed-iteration PCG (static shapes; converged state freezes);
        # step sizes per gauge group (gathered back to [K,1]) — exact
        # per-lane CG on merged block-diagonal systems
        def gdot(a, b):
            s = to_k(seg_k(jnp.sum(a * b, axis=1)))
            return s if single else s[:, None]

        x0 = jnp.zeros_like(rhs)
        r0 = rhs
        z0 = prec(r0)
        p0 = z0
        rz0 = gdot(r0, z0)

        def cg_step(carry, _):
            x, r, p, rz = carry
            Ap = S_mv(p)
            pAp = gdot(p, Ap)
            ok = (pAp > 1e-30) & (rz > 1e-30)
            alpha = jnp.where(ok, rz / jnp.maximum(pAp, 1e-30), 0.0)
            x = x + alpha * p
            r = r - alpha * Ap
            z = prec(r)
            rz_new = gdot(r, z)
            beta = jnp.where(ok, rz_new / jnp.maximum(rz, 1e-30), 0.0)
            p = z + beta * p
            return (x, r, p, rz_new), None

        (dxp_k, _, _, _), _ = jax.lax.scan(
            cg_step, (x0, r0, p0, rz0), None, length=opts.cg_iterations
        )
        bad_g = seg_k(
            jnp.sum(~jnp.isfinite(dxp_k), axis=1).astype(jnp.int32)
        ) > 0
        bad_k = to_k(bad_g)
        dxp_k = jnp.where(bad_k if single else bad_k[:, None], 0.0, dxp_k)

        # back-substitute landmarks: dxl = Hll^-1 (bl - W^T dxp)
        dxl = jnp.einsum("lij,lj->li", Hll_inv, bl - WT_v(dxp_k))
        dxl = jnp.where(
            lm_opt[:, None] & jnp.all(jnp.isfinite(dxl), axis=-1, keepdims=True),
            dxl, 0.0,
        )

        apply_g = ~done_g & enabled_g                # per group
        apply_k = to_k(apply_g)
        dxp_k = jnp.where((free_kf & apply_k)[:, None], dxp_k, 0.0)
        newp = se3_compose(se3_exp(dxp_k), Pose(q, t))
        apply_lm = to_lm(apply_g)
        lm_new = jnp.where(apply_lm if single else apply_lm[None, :],
                           lm_pos + dxl.T, lm_pos)

        converged_g = (total_obs_g == 0) | (
            jnp.abs(last_cost_g - cost_g) < 1e-6 * last_cost_g
        )
        iters_g = iters_g + jnp.where(done_g | ~enabled_g, 0, 1)
        done_g = done_g | converged_g
        return (newp.q, newp.t, lm_new, cost_g, done_g, iters_g), (
            jnp.sum(cost_g), jnp.sum(total_obs_g),
        )

    gshape = () if single else (K,)
    init = (
        ms.kf_q, ms.kf_t, ms.lm_pos,
        jnp.full(gshape, jnp.finfo(jnp.float32).max, jnp.float32),
        ~enabled_g, jnp.zeros(gshape, jnp.int32),
    )
    (q, t, lm_pos, cost_g, done_g, iters_g), (costs, obs_hist) = jax.lax.scan(
        iteration, init, None, length=opts.max_iterations
    )

    out = ms._replace(kf_q=q, kf_t=t, lm_pos=lm_pos)
    return out, GlobalBAStats(iterations=jnp.max(iters_g),
                              final_cost=jnp.sum(cost_g),
                              total_obs=obs_hist[-1])
