"""Structured global BA for offline-built maps: the pairwise Schur solve.

``models/global_ba.py`` is the general solver: it handles ANY observation graph
via a landmark-sorted observation table, which costs one [K*N] argsort per call
plus one sorted scatter-add and one gather per PCG matvec (on the earlier
accelerator, where this was designed, the dominant cost of the offline
pipeline's refine stage; not yet measured on the H100).

Offline maps have more structure than that. ``build_keyframe_map`` +
``_link_consecutive_keyframes`` guarantee every landmark has AT MOST TWO
observations: its creating feature (keyframe k, slot n) and at most one
adopting feature in keyframe k+1 (the link pass reads the pre-adoption
table, so adoption never chains). The observation graph is therefore a
partial matching between consecutive keyframes, and every landmark-axis
reduction collapses to ONE ``take_along_axis`` pass along the feature
axis of the adjacent keyframe — no sort, no scatter, no landmark-major
table at all.

This module exploits that plus a component-major data layout: all per-
observation quantities live as [K, N] float32 arrays, and the tiny fixed-size
tensor algebra (2x6 Jacobians, 3x3/6x6 blocks) is unrolled into component
arithmetic. The general solver stores these as [K, N, 2, 6]-shaped arrays,
whose small trailing dims the earlier accelerator's tiling padded many times
over (the reason for this layout there; not yet measured on the H100).

Semantics match ``global_ba`` (same residuals, Huber weights, reproj
gate, Schur-complement GN with block-Jacobi PCG, gauge fixed at the
oldest keyframe, landmarks below 2 observations held constant but still
constraining poses); ``tests/test_pair_ba.py`` pins the two solvers to
each other on the same offline-built map.

Reference provenance: the reference has no global BA (its backend is a
5-keyframe local window, core/backend/local_ba.cpp:42-62); this solver
exists for BASELINE config 4 and the offline pipeline's refine stage.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.camera import CameraParams
from ..ops.se3 import Pose, quat_to_matrix, se3_compose, se3_exp
from ..tracking import mapstate as msl
from ..tracking.mapstate import MapState
from .global_ba import GlobalBAOptions, GlobalBAStats
from .local_ba import _huber_w


class PairLinks(NamedTuple):
    """The offline map's observation structure, from build_keyframe_map.

    created  [K,N] bool : feature (k,n) created its landmark
    adopter  [K,N] int32: feature index m in keyframe k+1 observing the
                          landmark created at (k,n), or -1 (last row -1)
    creator  [K,N] int32: feature index n in keyframe k-1 whose created
                          landmark feature (k,m) adopted, or -1 (row 0 -1)
    order    [K*N] int32: argsort of the creation scatter index (from the
                          builder; reused for the final landmark-table
                          write-back so no new sort is paid here)
    sidx     [K*N] int32: the sorted creation scatter index (rank, or Lp
                          for non-creating slots; ascending)
    """

    created: jnp.ndarray
    adopter: jnp.ndarray
    creator: jnp.ndarray
    order: jnp.ndarray
    sidx: jnp.ndarray


def _push_to_creator(x, adopter):
    """[d?,K,N] obs values -> per-creation-slot adopter contribution:
    out[..., k, n] = x[..., k+1, adopter[k,n]] (0 where no adopter).
    ONE take_along_axis along the feature axis — this is the entire
    landmark-axis segment-sum of the general solver."""
    K = adopter.shape[0]
    has = adopter >= 0
    idx = jnp.maximum(adopter, 0)
    nxt = x[..., 1:, :]                                   # [..., K-1, N]
    g = jnp.take_along_axis(
        nxt, jnp.broadcast_to(idx[:-1], nxt.shape[:-2] + idx[:-1].shape),
        axis=-1,
    )
    g = jnp.where(has[:-1], g, 0.0)
    pad = jnp.zeros(x.shape[:-2] + (1, x.shape[-1]), x.dtype)
    return jnp.concatenate([g, pad], axis=-2)


def _pull_from_creator(u, creator):
    """[d?,K,N] creation-slot values -> at adopting obs:
    out[..., k, m] = u[..., k-1, creator[k,m]] (0 where not adopting)."""
    has = creator >= 0
    idx = jnp.maximum(creator, 0)
    prev = u[..., :-1, :]
    g = jnp.take_along_axis(
        prev, jnp.broadcast_to(idx[1:], prev.shape[:-2] + idx[1:].shape),
        axis=-1,
    )
    g = jnp.where(has[1:], g, 0.0)
    pad = jnp.zeros(u.shape[:-2] + (1, u.shape[-1]), u.dtype)
    return jnp.concatenate([pad, g], axis=-2)


def _sym3_inv(m, damping):
    """Inverse of symmetric 3x3 given as components (a00,a01,a02,a11,a12,
    a22) each [...]: adjugate/det closed form with damping added to the
    diagonal. Returns 6 components of the (symmetric) inverse."""
    a00, a01, a02, a11, a12, a22 = m
    a00 = a00 + damping
    a11 = a11 + damping
    a22 = a22 + damping
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = jnp.where(jnp.abs(det) > 1e-30, 1.0 / det, 0.0)
    return (c00 * inv_det, c01 * inv_det, c02 * inv_det,
            c11 * inv_det, c12 * inv_det, c22 * inv_det)


def _sym3_apply(mi, v):
    """Symmetric 3x3 (6 comps) times vector (3 comps), componentwise."""
    i00, i01, i02, i11, i12, i22 = mi
    v0, v1, v2 = v
    return (i00 * v0 + i01 * v1 + i02 * v2,
            i01 * v0 + i11 * v1 + i12 * v2,
            i02 * v0 + i12 * v1 + i22 * v2)


@partial(jax.jit, static_argnames=("opts",))
def pair_ba(
    ms: MapState,
    cam: CameraParams,
    links: PairLinks,
    opts: GlobalBAOptions = GlobalBAOptions(),
) -> tuple[MapState, GlobalBAStats]:
    """Schur-complement GN over an offline-built pairwise map. Drop-in
    for ``global_ba`` when ``links`` is available (same options/stats)."""
    K = ms.kf_capacity
    N = ms.n_features
    Lp = ms.lm_physical
    f32 = jnp.float32

    created = links.created & ms.kf_fvalid
    # adopter validity requires the adopting feature itself to be valid
    adopt_ok = links.adopter >= 0
    nxt_valid = jnp.concatenate(
        [ms.kf_fvalid[1:], jnp.zeros((1, N), bool)], axis=0
    )
    adopter_valid = adopt_ok & jnp.take_along_axis(
        nxt_valid, jnp.maximum(links.adopter, 0), axis=1
    )
    is_adopt = (links.creator >= 0) & ms.kf_fvalid

    alive_kf = msl.kf_alive(ms)
    has_obs = (created | is_adopt) & alive_kf[:, None]

    # landmark optimizability (>= 2 observations), expressed at slots:
    # a creation slot is optimizable iff it has an adopter; an adoption
    # obs always belongs to a 2-observation landmark
    opt_created = created & adopter_valid
    opt_obs = (opt_created | is_adopt) & alive_kf[:, None]

    # gauge: freeze the oldest alive keyframe
    ids = jnp.where(alive_kf, ms.kf_id, jnp.iinfo(jnp.int32).max)
    fixed_kf = jnp.argmin(ids)
    free_kf = alive_kf & (jnp.arange(K) != fixed_kf)
    free6 = free_kf[:, None]
    enabled = (jnp.sum(alive_kf) >= 2) & jnp.any(created)

    # landmark positions at creation slots, component-major [3][K,N]
    # (world frame; non-creating slots hold garbage, masked by `created`)
    lm_slot = jnp.clip(ms.kf_feat_lm, 0, Lp - 1)
    pos0 = tuple(ms.lm_pos[c][lm_slot.reshape(-1)].reshape(K, N)
                 for c in range(3))

    obs_u = ms.kf_px[:, 0, :]                      # [K,N] observed pixels
    obs_v = ms.kf_px[:, 1, :]

    lam = opts.damping

    def iteration(carry, _):
        q, t, px_, py_, pz_, last_cost, done, iters = carry
        pos = (px_, py_, pz_)

        # --- world point per obs: own creation slot or the creator's ---
        pos_stack = jnp.stack(pos)                            # [3,K,N]
        pulled = _pull_from_creator(pos_stack, links.creator)
        Xo = tuple(
            jnp.where(created, pos_stack[c], pulled[c]) for c in range(3)
        )

        # --- residuals, componentwise ---
        R = quat_to_matrix(q)                                 # [K,3,3]

        def r_(i, j):                                         # [K,1] bcast N
            return R[:, i, j][:, None]

        def rot(c):
            return r_(c, 0) * Xo[0] + r_(c, 1) * Xo[1] + r_(c, 2) * Xo[2]

        pcx = rot(0) + t[:, 0, None]
        pcy = rot(1) + t[:, 1, None]
        pcz = rot(2) + t[:, 2, None]
        z_ok = pcz > 1e-6
        iz = 1.0 / jnp.maximum(pcz, 1e-6)
        eu = obs_u - (cam.fx * pcx * iz + cam.cx)
        ev = obs_v - (cam.fy * pcy * iz + cam.cy)
        en = jnp.sqrt(eu * eu + ev * ev)
        obs = has_obs & z_ok & (en <= opts.max_reproj_error)
        w = jnp.where(obs, _huber_w(en, opts.huber_delta), 0.0)

        cost = jnp.sum(w * (eu * eu + ev * ev))
        total_obs = jnp.sum(obs).astype(jnp.int32)

        # --- Jacobians as component tuples ---
        # J_proj rows: Ju = (fx iz, 0, -fx pcx iz^2); Jv = (0, fy iz, ...)
        fxiz = cam.fx * iz
        fyiz = cam.fy * iz
        ju = (fxiz, jnp.zeros_like(iz), -fxiz * pcx * iz)
        jv = (jnp.zeros_like(iz), fyiz, -fyiz * pcy * iz)

        # pose Jacobian [2,6]: translation block = J_proj, rotation block
        # row_i = pc x J_proj_i (matches _pose_gn_refine / global_ba)
        def cross_pc(j):
            jx, jy, jz = j
            return (pcy * jz - pcz * jy,
                    pcz * jx - pcx * jz,
                    pcx * jy - pcy * jx)

        Ju6 = ju + cross_pc(ju)                               # 6 comps
        Jv6 = jv + cross_pc(jv)

        # point Jacobian [2,3] = J_proj @ R
        def jpt(j):
            jx, jy, jz = j
            return tuple(
                jx * r_(0, l) + jy * r_(1, l) + jz * r_(2, l)
                for l in range(3)
            )

        Pu = jpt(ju)
        Pv = jpt(jv)

        # --- pose normal equations (dense reduces over N) ---
        Hpp = jnp.zeros((K, 6, 6), f32)
        for i in range(6):
            for j in range(i, 6):
                hij = jnp.sum(w * (Ju6[i] * Ju6[j] + Jv6[i] * Jv6[j]),
                              axis=1)
                Hpp = Hpp.at[:, i, j].set(hij)
                if i != j:
                    Hpp = Hpp.at[:, j, i].set(hij)
        bp = jnp.stack(
            [jnp.sum(w * (Ju6[i] * eu + Jv6[i] * ev), axis=1)
             for i in range(6)], axis=1,
        )                                                     # [K,6]

        # --- landmark system (optimizable obs only) ---
        w_opt = jnp.where(opt_obs, w, 0.0)
        C = [w_opt * (Pu[i] * Pu[j] + Pv[i] * Pv[j])
             for (i, j) in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))]
        Cb = [w_opt * (Pu[i] * eu + Pv[i] * ev) for i in range(3)]
        packed = jnp.stack(C + Cb)                            # [9,K,N]
        pushed = _push_to_creator(packed, links.adopter)
        own = jnp.where(opt_created, packed, 0.0)
        tot = own + pushed
        Hll = tuple(tot[i] for i in range(6))
        bl = tuple(tot[6 + i] for i in range(3))
        Hinv = _sym3_inv(Hll, lam)                            # 6 comps [K,N]
        Hinv = tuple(jnp.where(opt_created, h, 0.0) for h in Hinv)
        Hinv_bl = _sym3_apply(Hinv, bl)

        # --- W blocks [6,3] per obs ---
        W = [[w_opt * (Ju6[i] * Pu[l] + Jv6[i] * Pv[l]) for l in range(3)]
             for i in range(6)]

        def WT_v(v6):
            """[K,6] -> per-creation-slot 3-vector (the landmark-axis
            reduction of the general solver, via one link pass)."""
            tv = jnp.stack([
                sum(W[i][l] * v6[:, i, None] for i in range(6))
                for l in range(3)
            ])                                                # [3,K,N]
            pushed = _push_to_creator(tv, links.adopter)
            own = jnp.where(opt_created, tv, 0.0)
            g = own + pushed
            return (g[0], g[1], g[2])

        def W_u(u3):
            """per-creation-slot 3-vector -> [K,6]."""
            u = jnp.stack(u3)                                 # [3,K,N]
            at_obs = jnp.where(created, u, _pull_from_creator(
                u, links.creator))
            return jnp.stack([
                jnp.sum(sum(W[i][l] * at_obs[l] for l in range(3)), axis=1)
                for i in range(6)
            ], axis=1)

        def S_mv(v6):
            v6 = jnp.where(free6, v6, 0.0)
            hv = jnp.einsum("kij,kj->ki", Hpp, v6) + lam * v6
            sv = hv - W_u(_sym3_apply(Hinv, WT_v(v6)))
            return jnp.where(free6, sv, v6)

        rhs = bp - W_u(Hinv_bl)
        rhs = jnp.where(free6, rhs, 0.0)

        # block-Jacobi preconditioner
        Hpp_d = Hpp + lam * jnp.eye(6, dtype=f32)
        eyeK = jnp.broadcast_to(jnp.eye(6, dtype=f32), (K, 6, 6))
        Pinv = jnp.linalg.inv(
            jnp.where(free_kf[:, None, None], Hpp_d, eyeK))

        def prec(r):
            return jnp.where(free6, jnp.einsum("kij,kj->ki", Pinv, r), 0.0)

        x0 = jnp.zeros_like(rhs)
        z0 = prec(rhs)
        rz0 = jnp.sum(rhs * z0)

        def cg_step(c, _):
            x, r, p, rz = c
            Ap = S_mv(p)
            pAp = jnp.sum(p * Ap)
            ok = (pAp > 1e-30) & (rz > 1e-30)
            alpha = jnp.where(ok, rz / jnp.maximum(pAp, 1e-30), 0.0)
            x = x + alpha * p
            r = r - alpha * Ap
            z = prec(r)
            rz_new = jnp.sum(r * z)
            beta = jnp.where(ok, rz_new / jnp.maximum(rz, 1e-30), 0.0)
            return (x, r, z + beta * p, rz_new), None

        (dxp, _, _, _), _ = jax.lax.scan(
            cg_step, (x0, rhs, z0, rz0), None, length=opts.cg_iterations
        )
        dxp = jnp.where(jnp.all(jnp.isfinite(dxp)), dxp,
                        jnp.zeros_like(dxp))

        # back-substitute landmarks at creation slots
        wt = WT_v(dxp)
        dxl = _sym3_apply(Hinv, tuple(b - t_ for b, t_ in zip(bl, wt)))
        dxl = tuple(
            jnp.where(opt_created & jnp.isfinite(d), d, 0.0) for d in dxl
        )

        apply = ~done & enabled
        dxp = jnp.where((free_kf & apply)[:, None], dxp, 0.0)
        newp = se3_compose(se3_exp(dxp), Pose(q, t))
        scale = jnp.where(apply, 1.0, 0.0)
        px_n = px_ + scale * dxl[0]
        py_n = py_ + scale * dxl[1]
        pz_n = pz_ + scale * dxl[2]

        converged = (total_obs == 0) | (
            jnp.abs(last_cost - cost) < 1e-6 * last_cost)
        iters = iters + jnp.where(done | ~enabled, 0, 1)
        done = done | converged
        return (newp.q, newp.t, px_n, py_n, pz_n, cost, done, iters), (
            cost, total_obs)

    init = (
        ms.kf_q, ms.kf_t, pos0[0], pos0[1], pos0[2],
        jnp.asarray(jnp.finfo(f32).max, f32),
        ~enabled, jnp.zeros((), jnp.int32),
    )
    (q, t, px_, py_, pz_, cost, done, iters), (costs, obs_hist) = (
        jax.lax.scan(iteration, init, None, length=opts.max_iterations)
    )

    # write landmark positions back through the builder's sorted scatter
    flat = jnp.stack([px_, py_, pz_]).reshape(3, K * N)
    lm_pos = ms.lm_pos.at[:, links.sidx].set(
        flat[:, links.order], indices_are_sorted=True, mode="drop"
    )
    out = ms._replace(kf_q=q, kf_t=t, lm_pos=lm_pos)
    return out, GlobalBAStats(iterations=iters, final_cost=cost,
                              total_obs=obs_hist[-1])
