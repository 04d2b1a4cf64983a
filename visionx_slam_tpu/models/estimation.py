"""Batched, fixed-shape robust pose estimation: the device RANSAC stack.

Replaces the reference's delegated OpenCV calib3d calls (SURVEY.md §2.3):

- ``essential_ransac`` = cv::findEssentialMat(RANSAC, conf .999, 1 px)
  + cv::recoverPose cheirality voting (reference tracking.cpp:503-544);
- ``pnp_ransac``      = cv::solvePnPRansac(iters min(100, 2n), reproj 2 px,
  conf .99) + final refinement on inliers (reference tracking.cpp:409-447);
- ``triangulate_dlt`` = the per-match 4x4 DLT SVD (tracking.cpp:931-945).

Device-first shape of the algorithms (SURVEY.md §7.5): RANSAC is a FIXED
batch of hypotheses — minimal samples drawn with a Gumbel-top-k trick so
every hypothesis uses distinct, valid correspondences — solved in one
vmapped batch (nullspaces via eigh of the normal matrix, which lowers to
fast batched Jacobi on XLA), scored against all correspondences with
masked reductions, and reduced with a single argmax. No data-dependent
loops, no early exit: the adaptive-iteration semantics of OpenCV's
confidence parameter are replaced by a hypothesis budget chosen to exceed
the reference's cap (documented per function).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.camera import CameraParams
from ..ops.linalg import chol_solve6x6, solve6x6_spd
from ..ops.se3 import (
    Pose,
    matrix_to_quat,
    quat_to_matrix,
    se3_apply,
    se3_exp,
    se3_compose,
    so3_exp as _so3_exp_quat,
    so3_hat,
)

BIG = 1e9


# ---------------------------------------------------------------------------
# sampling: k distinct valid indices per hypothesis, fully batched
# ---------------------------------------------------------------------------

def sample_minimal_sets(
    key: jax.Array, valid: jnp.ndarray, n_hypotheses: int, k: int,
    log_weights: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """[H, k] int32 indices, distinct within a hypothesis, valid-only.

    Gumbel-top-k: per hypothesis add iid Gumbel noise to log(valid) and take
    the k largest — a uniform sample of k distinct valid indices with no
    rejection loop (a fixed-shape replacement for sequential RANSAC draws).
    If fewer than k valid entries exist, invalid indices leak in; callers
    gate on the overall inlier count, so such hypotheses lose the argmax.

    ``log_weights`` [N] (optional) biases the draw PROSAC-style: Gumbel +
    log w samples without replacement with probability ∝ w, so
    higher-quality correspondences (e.g. lower Hamming distance) seed the
    minimal sets more often — a smaller hypothesis budget then reaches the
    clean-sample quality of a larger uniform one. Scoring/consensus are
    unaffected (every correspondence still votes).
    """
    n = valid.shape[0]
    g = jax.random.gumbel(key, (n_hypotheses, n))
    scores = g + jnp.where(valid[None, :], 0.0, -jnp.inf)
    if log_weights is not None:
        scores = scores + log_weights[None, :]
    _, idx = jax.lax.top_k(scores, k)
    return idx.astype(jnp.int32)


def _normalize_px(cam: CameraParams, px: jnp.ndarray) -> jnp.ndarray:
    """Pixels -> normalized image coordinates (pinhole; matches the
    reference's use of K-only models in calib3d calls)."""
    x = (px[..., 0] - cam.cx) / cam.fx
    y = (px[..., 1] - cam.cy) / cam.fy
    return jnp.stack([x, y], axis=-1)


def _smallest_eigvec(M: jnp.ndarray) -> jnp.ndarray:
    """Eigenvector of the smallest eigenvalue of symmetric PSD M [..., d, d].

    jnp.linalg.eigh in float32 separates a near-null eigenvector poorly
    (orders of magnitude worse than LAPACK); two inverse-iteration steps on
    the shifted matrix shrink the error by the eigen-gap ratio per step,
    which is effectively exact for the well-gapped DLT normal matrices used
    here (rows are normalized by callers, so eigenvalues are O(1)).
    """
    d = M.shape[-1]
    if d == 4:
        # hot path (per-correspondence triangulation): NO eigh at all — on the
        # earlier accelerator a batched eigh on [N,4,4] cost several times this
        # closed-form route on the online scan's keyframe-event path (chosen
        # there, not yet measured on the H100). Start from the INHOMOGENEOUS
        # solution (minimize ||M^(1/2) [X;1]||, i.e. M3 X = -b3 with M =
        # [[M3,b3], [b3^T,c]]): for finite points the null vector has w != 0,
        # so the start already matches eigh to ~1e-1 and two shifted inverse
        # iterations close the rest (verified to 8e-3 vs eigh on noisy
        # wide-baseline geometry). Points at infinity degrade gracefully:
        # near-singular M3 blows X0 up and the normalized start [X0;1] is the
        # null direction itself.
        from ..ops.linalg import chol_solve4x4, solve3x3

        X0 = solve3x3(M[..., :3, :3], -M[..., :3, 3])
        X0 = jnp.where(jnp.isfinite(X0), X0, 0.0)
        v0 = jnp.concatenate(
            [X0, jnp.ones(X0.shape[:-1] + (1,), X0.dtype)], axis=-1
        )
        v0 = v0 / jnp.maximum(jnp.linalg.norm(v0, axis=-1, keepdims=True), 1e-30)
        tr = M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2] + M[..., 3, 3]
        shift = 1e-7 * jnp.maximum(tr, 1e-20)
        Ms = M + shift[..., None, None] * jnp.eye(4, dtype=M.dtype)
        # M is PSD (A^T A) and shifted -> SPD: the unrolled scalar Cholesky
        # fuses into one kernel where the 2x2-block-Schur solve4x4 lowered
        # its tiny matmuls to separate kernels (this runs on the online
        # scan's keyframe-event path)
        for _ in range(2):
            v0 = chol_solve4x4(Ms, v0)
            v0 = v0 / jnp.maximum(jnp.linalg.norm(v0, axis=-1, keepdims=True), 1e-30)
        return v0
    w, v = jnp.linalg.eigh(M)
    v0 = v[..., :, 0]
    # scale-aware tiny shift keeps the solve finite while amplifying the
    # null-space component
    shift = 1e-7 * jnp.maximum(w[..., -1], 1e-20)
    Ms = M + shift[..., None, None] * jnp.eye(d, dtype=M.dtype)
    for _ in range(2):
        v0 = jnp.linalg.solve(Ms, v0[..., :, None])[..., :, 0]
        n = jnp.linalg.norm(v0, axis=-1, keepdims=True)
        v0 = v0 / jnp.maximum(n, 1e-30)
    return v0


# ---------------------------------------------------------------------------
# essential matrix: batched 8-point + Sampson scoring + cheirality recovery
# ---------------------------------------------------------------------------

class EssentialResult(NamedTuple):
    R: jnp.ndarray          # [3,3] rotation of T_cl (last->current)
    t: jnp.ndarray          # [3] unit-norm translation (mono scale ambiguity)
    E: jnp.ndarray          # [3,3]
    inlier_mask: jnp.ndarray  # [N] bool (RANSAC inliers passing cheirality)
    n_inliers: jnp.ndarray    # int32
    ok: jnp.ndarray           # bool


def _eight_point_raw(x1: jnp.ndarray, x2: jnp.ndarray) -> jnp.ndarray:
    """x1,x2: [8,2] normalized coords -> RAW (unprojected) E [3,3].

    Deliberately NOT projected to the essential manifold: the projection
    costs a 3x3 SVD per hypothesis, and tiny batched SVDs scheduled
    pathologically on the earlier accelerator, where this was designed (not
    yet measured on the H100). The RANSAC stage ranks hypotheses by Sampson
    consensus at a LOOSE 4x gate, where the raw-vs-projected difference is
    far inside the gate; only the top-K surviving hypotheses get the SVD
    (see _project_essential / essential_ransac)."""
    ones = jnp.ones_like(x1[:, :1])
    h1 = jnp.concatenate([x1, ones], -1)  # [8,3]
    h2 = jnp.concatenate([x2, ones], -1)
    # row = kron(x2, x1): constraint x2^T E x1 = 0, E row-major
    A = (h2[:, :, None] * h1[:, None, :]).reshape(8, 9)
    e = _smallest_eigvec(A.T @ A)
    return e.reshape(3, 3)


def _project_essential(E: jnp.ndarray):
    """Project E to the essential manifold (singular values (1,1,0));
    returns (Ep, U, Vt) so callers can decompose into (R, t) candidates
    from the SAME factors without a second SVD."""
    U, _, Vt = jnp.linalg.svd(E)
    Ep = U @ jnp.diag(jnp.array([1.0, 1.0, 0.0], E.dtype)) @ Vt
    return Ep, U, Vt


def _sampson_sq(E: jnp.ndarray, h1: jnp.ndarray, h2: jnp.ndarray) -> jnp.ndarray:
    """Squared Sampson distance of correspondences [N,3]x[N,3] under E."""
    Ex1 = h1 @ E.T          # [N,3] = E @ x1
    Etx2 = h2 @ E           # [N,3] = E^T @ x2
    num = jnp.sum(h2 * Ex1, axis=-1) ** 2
    den = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
    return num / jnp.maximum(den, 1e-12)


def _triangulate_norm(R, t, x1, x2):
    """Midpoint-free DLT triangulation in normalized coords for cheirality:
    P1=[I|0], P2=[R|t]; returns (X [N,3], z1, z2)."""
    N = x1.shape[0]
    P1 = jnp.concatenate([jnp.eye(3, dtype=R.dtype), jnp.zeros((3, 1), R.dtype)], 1)
    P2 = jnp.concatenate([R, t[:, None]], 1)
    X = triangulate_dlt(P1, P2, x1, x2)
    z1 = X[:, 2]
    z2 = X @ R[2].T + t[2]
    return X, z1, z2


def _two_ray_depths(R, t, h1, h2):
    """Closed-form two-view depths: least-squares (z1, z2) of
    z1 R x1 + t = z2 x2 per correspondence (2x2 normal equations).
    Exact for cheirality sign / distance-gate tests at a fraction of the
    DLT cost; h1, h2: [N,3] homogeneous normalized coords."""
    a = h1 @ R.T                       # [N,3] rotated rays
    aa = jnp.sum(a * a, axis=-1)
    bb = jnp.sum(h2 * h2, axis=-1)
    ab = jnp.sum(a * h2, axis=-1)
    at = a @ t
    bt = h2 @ t
    # minimize ||z1 a - z2 b + t||^2:
    #   [aa -ab][z1]   [-at]
    #   [-ab bb][z2] = [-bt] * (-1 on second row sign bookkeeping)
    det = aa * bb - ab * ab
    inv_det = jnp.where(jnp.abs(det) > 1e-18, 1.0 / det, 0.0)
    z1 = (-bb * at + ab * bt) * inv_det
    z2 = (-ab * at + aa * bt) * inv_det
    return z1, z2


def _refine_essential_pose(R0, t0, h1, h2, w, iters: int = 10):
    """GN refinement of (R, t-direction) on the Sampson error.

    Why this exists: the 8-point solver's translation DIRECTION can be
    far off while its Sampson consensus stays large (at small baselines
    Sampson is nearly insensitive to t-direction error), and a bad
    direction sends triangulated depths past the cheirality distance
    gate — measured on synthetic fr-class pairs: 455-strong Sampson
    consensus collapsing to 20 cheirality inliers, where cv2's 5-point
    keeps 452. Refining on the essential manifold (3 rotation + 2
    t-tangent parameters, E = [t]x R) recovers the direction; OpenCV
    gets the same effect from Nister's exact minimal solver.

    w: [N] per-correspondence weights (the RANSAC consensus mask).
    Returns (R, t) with unit-norm t.
    """
    f32 = h1.dtype

    def tangent_basis(t):
        # any orthonormal pair spanning t^perp (branch-free pick)
        a = jnp.where(jnp.abs(t[0]) < 0.9,
                      jnp.array([1.0, 0.0, 0.0], f32),
                      jnp.array([0.0, 1.0, 0.0], f32))
        b1 = jnp.cross(t, a)
        b1 = b1 / jnp.maximum(jnp.linalg.norm(b1), 1e-12)
        b2 = jnp.cross(t, b1)
        return b1, b2

    def sampson(E):
        Ex1 = h1 @ E.T
        Etx2 = h2 @ E
        num = jnp.sum(h2 * Ex1, axis=-1)
        den = (Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2
               + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2)
        return num / jnp.sqrt(jnp.maximum(den, 1e-18))

    def step(carry, _):
        R, t = carry
        b1, b2 = tangent_basis(t)

        def res(p):
            Rp = quat_to_matrix(_so3_exp_quat(p[:3])) @ R
            tp = t + p[3] * b1 + p[4] * b2
            tp = tp / jnp.maximum(jnp.linalg.norm(tp), 1e-12)
            return sampson(so3_hat(tp) @ Rp)

        p0 = jnp.zeros((5,), f32)
        r = res(p0)
        J = jax.jacfwd(res)(p0)                       # [N,5]
        Jw = J * w[:, None]
        H = J.T @ Jw                                  # [5,5]
        g = Jw.T @ r
        H6 = jnp.eye(6, dtype=f32).at[:5, :5].set(
            H + 1e-8 * jnp.eye(5, dtype=f32))
        g6 = jnp.concatenate([g, jnp.zeros((1,), f32)])
        dp = -solve6x6_spd(H6, g6)[:5]
        dp = jnp.where(jnp.all(jnp.isfinite(dp)), dp, jnp.zeros_like(dp))
        Rn = quat_to_matrix(_so3_exp_quat(dp[:3])) @ R
        tn = t + dp[3] * b1 + dp[4] * b2
        tn = tn / jnp.maximum(jnp.linalg.norm(tn), 1e-12)
        return (Rn, tn), None

    (R, t), _ = jax.lax.scan(step, (R0, t0), None, length=iters)
    return R, t


@partial(jax.jit, static_argnames=("n_hypotheses", "lo_starts",
                                   "polish_iters", "score_top_k"))
def essential_ransac(
    cam: CameraParams,
    px_last: jnp.ndarray,   # [N,2] pixels in the LAST frame
    px_curr: jnp.ndarray,   # [N,2] pixels in the CURRENT frame
    valid: jnp.ndarray,     # [N] bool correspondence mask
    key: jax.Array,
    thresh_px: float = 1.0,      # reference tracking.cpp:521
    n_hypotheses: int = 256,
    lo_starts: int = 16,
    polish_iters: int = 10,  # GN manifold-polish budget (the winner's
                             # Sampson refine); high-inlier consecutive
                             # pairs converge in 3-4
    sample_logw: jnp.ndarray | None = None,  # [N] PROSAC-style sampling
                             # bias (see sample_minimal_sets); scoring is
                             # unaffected
    score_top_k: int | None = None,  # tier-2 width: how many Sampson-
                             # ranked hypotheses get the SVD + cheirality
                             # vote. None -> ALL hypotheses (the raw
                             # pre-selection pass is then dead code and
                             # XLA DCEs it, so default callers compile to
                             # the original one-tier program). Mono
                             # offline passes a narrow K explicitly.
) -> EssentialResult:
    """Essential-matrix RANSAC + pose recovery.

    Semantics follow cv::findEssentialMat(RANSAC, 0.999, 1.0) +
    cv::recoverPose as called at tracking.cpp:521-528: Sampson scoring with
    the pixel threshold scaled by mean focal length; pose disambiguation by
    positive-depth voting over the four (R, t) decompositions with
    OpenCV's 50-unit distance gate; returned t has unit norm (monocular
    scale ambiguity, SURVEY.md "known quirks"). The 8-point solver replaces
    Nister 5-point (SURVEY.md §7.5: per-hypothesis eigh batches better);
    the fixed 256-hypothesis budget exceeds the adaptive-iteration count
    the reference's 0.999 confidence typically settles at.

    Hypotheses are scored by SIGN-GATED consensus (Sampson inlier AND
    both two-ray depths positive), not by Sampson alone. This matters on
    plane-dominated views: a dominant
    homography H admits a 2-parameter family of essentials that all fit
    the plane's correspondences to sub-pixel Sampson error but differ
    wildly in translation direction — measured on synthetic fr-class
    pairs, Sampson-only selection picked a family member with t nearly
    orthogonal to the truth (455-strong Sampson consensus, 20 cheirality
    survivors, vs cv2's 452). Depth signs separate the family members;
    scoring with them recovers the cv2-grade consensus. A final GN
    Sampson polish on the essential manifold (_refine_essential_pose)
    sharpens the winner, accepted only if the gated consensus does not
    drop.
    """
    x1 = _normalize_px(cam, px_last)
    x2 = _normalize_px(cam, px_curr)
    ones = jnp.ones_like(x1[:, :1])
    h1 = jnp.concatenate([x1, ones], -1)
    h2 = jnp.concatenate([x2, ones], -1)

    idx = sample_minimal_sets(key, valid, n_hypotheses, 8,
                              log_weights=sample_logw)  # [H,8]
    Es_raw = jax.vmap(lambda ii: _eight_point_raw(x1[ii], x2[ii]))(idx)

    thresh_norm = thresh_px / (0.5 * (cam.fx + cam.fy))
    d2 = jax.vmap(lambda E: _sampson_sq(E, h1, h2))(Es_raw)  # [H,N]
    # hypothesis SELECTION happens at a loose 4x threshold: at low inlier
    # ratios no clean 8-sample exists (0.3^8 ~ 7e-5), and the best
    # partially-contaminated sample is near the truth only in the WIDE
    # basin — a tight gate rewards small locally-consistent junk models
    # instead. The LO loop below anneals back down to 1x.
    inl_raw = (d2 < (4.0 * thresh_norm) ** 2) & valid[None, :]

    # ---- two-tier scoring (opt-in): the H-wide stage pays ONLY the
    # Sampson count; manifold projection (3x3 SVD), decomposition and the
    # 4-way cheirality-gated scoring run on the TOP-K hypotheses by
    # Sampson consensus. The docstring's plane-degeneracy argument still
    # holds: the true model fits the plane PLUS the off-plane points, so
    # its Sampson count is never below a junk family member's — the family
    # is separated INSIDE the top-K by the cheirality gate exactly as
    # before. With K == H (the default) the selection is the identity and
    # the raw-Sampson pass is dead code, so default callers keep the
    # original one-tier program bit-for-bit.
    score_k = min(n_hypotheses, score_top_k) if score_top_k is not None \
        else n_hypotheses
    if score_k == n_hypotheses:
        hsel = jnp.arange(n_hypotheses, dtype=jnp.int32)
    else:
        n_sampson = jnp.sum(inl_raw, axis=1)              # [H]
        _, hsel = jax.lax.top_k(n_sampson, score_k)       # [K]
    Es, Us, Vts = jax.vmap(_project_essential)(Es_raw[hsel])
    # re-gate the projected models at the same loose threshold (projection
    # shifts E slightly; keeps consensus semantics identical to scoring
    # the projected model directly)
    d2_k = jax.vmap(lambda E: _sampson_sq(E, h1, h2))(Es)  # [K,N]
    inl = (d2_k < (4.0 * thresh_norm) ** 2) & valid[None, :]

    def decompose_uv(U, Vt):
        U = U * jnp.sign(jnp.linalg.det(U))
        Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
        W = jnp.array(
            [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], U.dtype
        )
        tu = U[:, 2]
        tu = tu / jnp.maximum(jnp.linalg.norm(tu), 1e-12)
        return U @ W @ Vt, U @ W.T @ Vt, tu

    Ras, Rbs, tus = jax.vmap(decompose_uv)(Us, Vts)

    def cheir_counts(R, t, inl_h):
        """SELECTION consensus for one (R, t) candidate: two-ray depth
        SIGNS only (closed-form 2x2 least squares of z1 R x1 + t = z2 x2
        — far cheaper than DLT, exact for sign purposes). Deliberately
        NOT the 50-unit distance gate: cv2 selects E by Sampson consensus
        (findEssentialMat) and only measures the distance gate afterwards
        (recoverPose). Selecting WITH the gate rewards wrong models at
        small baselines — a bad t-direction compresses triangulated
        depths UNDER the gate (measured: frame-1 pair, t.dot(gt)=0.08,
        418/509 gated inliers vs the true model's 7), which made init
        fire 8 frames before the oracle. Depth SIGNS still separate the
        plane-degenerate essential family (the docstring's homography
        case), so the selection keeps that robustness."""
        z1, z2 = _two_ray_depths(R, t, h1, h2)
        good = inl_h & (z1 > 0) & (z2 > 0)
        return jnp.sum(good), good

    def score_hyp(Ra, Rb, tu, inl_h):
        cands = ((Ra, tu), (Ra, -tu), (Rb, tu), (Rb, -tu))
        counts, goods = zip(*(cheir_counts(R, t, inl_h) for R, t in cands))
        counts = jnp.stack(counts)
        ci = jnp.argmax(counts)
        Rc = jnp.stack([c[0] for c in cands])[ci]
        tc = jnp.stack([c[1] for c in cands])[ci]
        return counts[ci], Rc, tc, jnp.stack(goods)[ci]

    scores, Rcs, tcs, goods = jax.vmap(score_hyp)(Ras, Rbs, tus, inl)

    # LO-RANSAC with threshold annealing (4x -> 1x), MULTI-START from the
    # top-16 hypotheses: refit E on the current gated consensus (weighted
    # 8-point LS), re-decompose, re-gate at the step's threshold, keep
    # whichever model holds more. At 30 % inliers no clean 8-sample
    # exists (0.3^8 ~ 7e-5 vs the reference Nister's 0.3^5 ~ 2.4e-3), so
    # the recovery path is a MOSTLY-clean sample (~0.33 expected in the
    # 256 budget) whose wide-basin consensus LO can walk to the truth —
    # 16 starts cover the chance that the single loose-gate winner is
    # junk. Each LO chain is a handful of [N,9] matmuls + one 3x3 SVD
    # per step: noise next to the 256-hypothesis stage.
    rows = (h2[:, :, None] * h1[:, None, :]).reshape(-1, 9)   # [N,9]
    anneal = jnp.array([2.0, 1.4, 1.0, 1.0], h1.dtype) * thresh_norm

    def gate_at(R_, t_, E_, thr):
        inl_ = (_sampson_sq(E_, h1, h2) < thr**2) & valid
        z1, z2 = _two_ray_depths(R_, t_, h1, h2)
        m_ = inl_ & (z1 > 0) & (z2 > 0)  # signs only; see cheir_counts
        return jnp.sum(m_), m_

    def lo_step(carry, thr):
        E_b, R_b, t_b, m_b = carry
        w_rows = jnp.where(m_b[:, None], rows, 0.0)
        e_fit = _smallest_eigvec(w_rows.T @ w_rows).reshape(3, 3)
        Uf, _, Vtf = jnp.linalg.svd(e_fit)
        E_f = Uf @ jnp.diag(jnp.array([1.0, 1.0, 0.0], e_fit.dtype)) @ Vtf
        Ra_f, Rb_f, tu_f = decompose_uv(Uf, Vtf)
        inl_f = (_sampson_sq(E_f, h1, h2) < thr**2) & valid
        n_f, R_f, t_f, m_f = score_hyp(Ra_f, Rb_f, tu_f, inl_f)
        # re-score the carried model at THIS threshold so the comparison
        # is apples-to-apples as the gate tightens
        n_b, m_b2 = gate_at(R_b, t_b, E_b, thr)
        take = n_f >= n_b
        return (
            jnp.where(take, E_f, E_b),
            jnp.where(take, R_f, R_b),
            jnp.where(take, t_f, t_b),
            jnp.where(take, m_f, m_b2),
        ), None

    def lo_chain(E0, R0, t0, m0):
        (E_, R_, t_, m_), _ = jax.lax.scan(
            lo_step, (E0, R0, t0, m0), anneal
        )
        n_, m_ = gate_at(R_, t_, E_, thresh_norm)
        return E_, R_, t_, m_, n_

    # ``lo_starts`` tunes the multi-start width: 16 covers the blind
    # low-inlier regime (tracking fallback / recovery); consecutive-frame
    # pairs in the offline mono pipeline are high-inlier after the ratio +
    # distance filters, where the loose-gate winner is almost never junk —
    # a smaller fan there trades nothing (measured at equal ATE).
    n_starts = min(lo_starts, n_hypotheses)
    _, topi = jax.lax.top_k(scores, n_starts)
    E_j, R_j, t_j, m_j, n_j = jax.vmap(lo_chain)(
        Es[topi], Rcs[topi], tcs[topi], goods[topi]
    )
    j = jnp.argmax(n_j)
    E, R, t, mask, n_best = E_j[j], R_j[j], t_j[j], m_j[j], n_j[j]

    # GN Sampson polish on the essential manifold (see
    # _refine_essential_pose), accepted only if the gated consensus holds
    Rr, tr = _refine_essential_pose(
        R0=R, t0=t, h1=h1, h2=h2, w=mask.astype(h1.dtype),
        iters=polish_iters)
    E_ref = so3_hat(tr) @ Rr
    inl_ref = (_sampson_sq(E_ref, h1, h2) < thresh_norm**2) & valid
    n_ref, m_ref = cheir_counts(Rr, tr, inl_ref)
    better = n_ref >= n_best
    R = jnp.where(better, Rr, R)
    t = jnp.where(better, tr, t)
    E = jnp.where(better, E_ref, E)
    # cv::recoverPose's 50-unit distance gate, applied POST-selection to
    # the chosen model exactly as cv2 applies it to findEssentialMat's
    # winner (both cameras' depths positive and within 50 baseline
    # units). At tiny baselines this count collapses for an accurate
    # model (true depth >> 50 x baseline), which is what defers the
    # reference's monocular init until real parallax exists
    # (tracking.cpp:232 via min_inliers on the recoverPose count).
    z1f, z2f = _two_ray_depths(R, t, h1, h2)
    inl_f = (_sampson_sq(E, h1, h2) < thresh_norm**2) & valid
    dist_mask = inl_f & (z1f > 0) & (z2f > 0) & (z1f < 50.0) & (z2f < 50.0)
    n_inliers = jnp.sum(dist_mask).astype(jnp.int32)

    ok = (n_inliers > 0) & jnp.all(jnp.isfinite(R)) & jnp.all(jnp.isfinite(t))
    return EssentialResult(R, t, E, dist_mask, n_inliers, ok)


@jax.jit
def essential_scale_from_depth(
    cam: CameraParams,
    res: EssentialResult,
    px_last: jnp.ndarray,
    px_curr: jnp.ndarray,
    depth_last: jnp.ndarray,  # [N] measured depth of the LAST frame's features (0 = none)
) -> jnp.ndarray:
    """Metric scale for the essential-matrix translation from RGB-D depth.

    The reference composes recoverPose's UNIT-norm translation directly
    (tracking.cpp:539-541), which leaves the two-frame initialization at an
    arbitrary scale while its depth-backprojected landmarks are metric —
    an internal inconsistency the reference carries. With RGB-D data the
    scale is observable: triangulate the essential inliers at unit scale
    and take the median ratio of measured to triangulated depth. Returns a
    scalar (1.0 when too few valid pairs), applied as ``t * scale``.
    Enabled by the (extension) option ``init_scale_from_depth``.
    """
    x1 = _normalize_px(cam, px_last)
    x2 = _normalize_px(cam, px_curr)
    X, z1, z2 = _triangulate_norm(res.R, res.t, x1, x2)
    good = (
        res.inlier_mask
        & (z1 > 1e-3) & (z2 > 1e-3)
        & (depth_last > 0.1) & (depth_last < 10.0)
        & jnp.all(jnp.isfinite(X), axis=-1)
    )
    ratio = jnp.where(good, depth_last / jnp.maximum(z1, 1e-6), jnp.nan)
    scale = jnp.nanmedian(ratio)
    enough = jnp.sum(good) >= 10
    ok = enough & jnp.isfinite(scale) & (scale > 1e-3) & (scale < 1e3)
    return jnp.where(ok, scale, 1.0)


# ---------------------------------------------------------------------------
# PnP: batched DLT hypotheses + reprojection scoring + GN refinement
# ---------------------------------------------------------------------------

class PnPResult(NamedTuple):
    pose: Pose               # T_cw
    inlier_mask: jnp.ndarray  # [N] bool
    n_inliers: jnp.ndarray    # int32
    ok: jnp.ndarray           # bool


def _dlt_pnp(X: jnp.ndarray, x: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Minimal DLT pose from 6 points: X [6,3] world, x [6,2] normalized.

    Returns (R [3,3], t [3]). Points are Hartley-normalized for
    conditioning; the projective P is snapped to SE(3) via SVD
    orthogonalization with positive-depth sign selection.
    """
    # normalize 3D points: centroid + isotropic scale
    c = jnp.mean(X, axis=0)
    s = jnp.mean(jnp.linalg.norm(X - c, axis=-1))
    s = jnp.maximum(s, 1e-9)
    Xn = (X - c) / s

    ones = jnp.ones((6, 1), X.dtype)
    Xh = jnp.concatenate([Xn, ones], -1)  # [6,4]
    zeros = jnp.zeros_like(Xh)
    u = x[:, 0:1]
    v = x[:, 1:2]
    rows_u = jnp.concatenate([Xh, zeros, -u * Xh], -1)  # [6,12]
    rows_v = jnp.concatenate([zeros, Xh, -v * Xh], -1)
    A = jnp.concatenate([rows_u, rows_v], 0)  # [12,12]
    p = _smallest_eigvec(A.T @ A)
    P = p.reshape(3, 4)

    # P is defined up to a global sign; build a proper-rotation candidate
    # from +P and from -P, keep whichever puts the sample in front.
    def snap_to_se3(P_signed):
        M = P_signed[:, :3]
        Um, Sm, Vmt = jnp.linalg.svd(M)
        d = jnp.linalg.det(Um) * jnp.linalg.det(Vmt)
        D = jnp.diag(jnp.array([1.0, 1.0, 0.0], M.dtype)) + jnp.diag(
            jnp.array([0.0, 0.0, 1.0], M.dtype)
        ) * d
        R = Um @ D @ Vmt
        t = P_signed[:, 3] / jnp.maximum(jnp.mean(Sm), 1e-12)
        return R, t

    Ra, ta = snap_to_se3(P)
    Rb, tb = snap_to_se3(-P)
    za = Xn @ Ra[2] + ta[2]
    zb = Xn @ Rb[2] + tb[2]
    pick_a = jnp.sum(za > 0) >= jnp.sum(zb > 0)
    R = jnp.where(pick_a, Ra, Rb)
    t = jnp.where(pick_a, ta, tb)

    # undo the 3D normalization: x ~ R (X - c)/s + t (homogeneous), so the
    # un-normalized pose is (R, s*t - R c) up to projective scale
    t_full = s * t - R @ c
    return R, t_full


def _kabsch3(P: jnp.ndarray, Q: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Closed-form rigid transform from 3 exact 3D-3D correspondences:
    R P_i + t = Q_i. Orthonormal-triad construction — no SVD/eigh (batched tiny
    decompositions scheduled pathologically on the earlier accelerator, where
    this was designed; this is a handful of elementwise ops). Degenerate
    (collinear) triples produce garbage poses that simply lose the RANSAC
    consensus vote.

    P, Q: [3,3] points (rows). Returns (R [3,3], t [3]).
    """

    def triad(X):
        e1 = X[1] - X[0]
        e1 = e1 / jnp.maximum(jnp.linalg.norm(e1), 1e-12)
        n = jnp.cross(e1, X[2] - X[0])
        e3 = n / jnp.maximum(jnp.linalg.norm(n), 1e-12)
        e2 = jnp.cross(e3, e1)
        return jnp.stack([e1, e2, e3], axis=1)  # columns

    Bp = triad(P)
    Bq = triad(Q)
    R = Bq @ Bp.T
    t = jnp.mean(Q, axis=0) - R @ jnp.mean(P, axis=0)
    return R, t


def _reproj_err_px(cam: CameraParams, R, t, X, px):
    pc = X @ R.T + t
    z = jnp.maximum(pc[..., 2], 1e-6)
    u = cam.fx * pc[..., 0] / z + cam.cx
    v = cam.fy * pc[..., 1] / z + cam.cy
    err = jnp.stack([u, v], -1) - px
    behind = pc[..., 2] <= 1e-6
    return jnp.where(behind, BIG, jnp.linalg.norm(err, axis=-1))


def _pose_gn_refine(
    cam: CameraParams,
    pose: Pose,
    X: jnp.ndarray,
    px: jnp.ndarray,
    w: jnp.ndarray,
    iters: int = 10,
    robust: bool = False,
    huber_delta=0.0,
    gate_px=0.0,
) -> Pose:
    """Pose-only Gauss-Newton on weighted reprojection (pinhole).

    Same Jacobian structure as the reference BA pose pass
    (local_ba.cpp:15-33): J = J_proj(pc) @ [I | -hat(pc)], left-mult update.
    With ``robust=True`` (static) the weights are Huber-reweighted and
    gated per iteration (IRLS), which lets a rough initial pose converge on
    data with outliers.
    """

    def step(pose, _):
        # This chain runs SERIALLY once per frame on the online scan, so
        # it is written for minimum fused-kernel count, not elegance: the
        # pose Jacobian's 12 entries are explicit column formulas (the
        # closed form of J_proj(pc) @ [I | -hat(pc)], local_ba.cpp:15-33),
        # the 6x6 normal equations AND the rhs come from ONE augmented
        # [7,2N]x[2N,7] contraction (G = [J | err] rows), and the
        # solve is the fully-unrolled scalar Cholesky (ops/linalg.py).
        pc = se3_apply(pose, X)
        x, y = pc[..., 0], pc[..., 1]
        z = jnp.maximum(pc[..., 2], 1e-6)
        iz = 1.0 / z
        xiz, yiz = x * iz, y * iz
        u_err = px[..., 0] - (cam.fx * xiz + cam.cx)
        v_err = px[..., 1] - (cam.fy * yiz + cam.cy)
        ww = w * (pc[..., 2] > 1e-6)
        if robust:
            en = jnp.sqrt(u_err * u_err + v_err * v_err)
            ww = ww * jnp.where(en <= huber_delta, 1.0,
                                huber_delta / jnp.maximum(en, 1e-9))
            ww = ww * (en <= gate_px)

        # row u: fx * [iz, 0, -x iz^2, -x y iz^2, 1 + x^2 iz^2, -y iz]
        # row v: fy * [0, iz, -y iz^2, -(1 + y^2 iz^2), x y iz^2, x iz]
        xyiz2 = xiz * yiz
        zero = jnp.zeros_like(iz)
        Gu = jnp.stack(
            [cam.fx * iz, zero, -cam.fx * xiz * iz,
             -cam.fx * xyiz2, cam.fx * (1.0 + xiz * xiz), -cam.fx * yiz,
             u_err], -1)                             # [N,7]
        Gv = jnp.stack(
            [zero, cam.fy * iz, -cam.fy * yiz * iz,
             -cam.fy * (1.0 + yiz * yiz), cam.fy * xyiz2, cam.fy * xiz,
             v_err], -1)                             # [N,7]
        G = jnp.concatenate([Gu, Gv], axis=0)        # [2N,7]
        wf = jnp.concatenate([ww, ww], axis=0)
        M = jax.lax.dot_general(
            G * wf[:, None], G, (((0,), (0,)), ((), ()))
        )                                            # [7,7]
        H = M[:6, :6] + 1e-6 * jnp.eye(6, dtype=pc.dtype)
        b = M[:6, 6]
        dx = chol_solve6x6(H, b)   # one fused scalar kernel (ops/linalg.py)
        dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx, jnp.zeros_like(dx))
        return se3_compose(se3_exp(dx), pose), None

    pose, _ = jax.lax.scan(step, pose, None, length=iters)
    return pose


@partial(jax.jit, static_argnames=("n_hypotheses", "refine_iters"))
def pnp_ransac(
    cam: CameraParams,
    pts3d: jnp.ndarray,     # [N,3] world landmarks
    pts2d: jnp.ndarray,     # [N,2] pixels in current frame
    valid: jnp.ndarray,     # [N] bool
    key: jax.Array,
    reproj_thresh: float = 2.0,   # reference max_reproj_error flag
    n_hypotheses: int = 64,
    refine_iters: int = 6,
    init_pose: Pose | None = None,
    depth_curr: jnp.ndarray | None = None,  # [N] current-frame depth (m)
) -> PnPResult:
    """PnP RANSAC with final GN refinement on inliers.

    Mirrors cv::solvePnPRansac as called at tracking.cpp:422-423
    (reprojection gate ``max_reproj_error``, conf 0.99) followed by
    refinement on the inlier set. The raw hypothesis budget is 64 — below
    OpenCV's typical min(100, 2n) iteration count — but each kept
    hypothesis gets a calibrated GN polish and a motion-prior IRLS
    hypothesis competes in the same consensus, which covers the smaller
    raw budget (validated against cv2.solvePnPRansac in
    tests/test_estimation.py).

    Minimal solver, two variants chosen statically:

    - ``depth_curr`` given (RGB-D): 3-point rigid Procrustes — the sampled
      world points against the current frame's depth-backprojected camera
      points, closed form (``_kabsch3``), NO eigh. Scoring stays pure-2D
      reprojection over ALL correspondences, so depth holes/noise only
      restrict sampling, never the consensus. Sampling prefers points with
      valid depth.
    - no depth (monocular): 6-point DLT (batched eigh). The
      projective DLT is degenerate on coplanar samples, but the calibrated
      6-DoF pose is NOT — the GN polish recovers planar-scene hypotheses
      the raw DLT cannot (planar-heavy frames are the norm indoors).

    When ``init_pose`` is given (the tracker's previous pose), one extra
    hypothesis runs robust IRLS from it over all correspondences — a
    motion-prior hypothesis competing in the same consensus scoring.
    """
    x_norm = _normalize_px(cam, pts2d)
    if depth_curr is not None:
        from ..ops.camera import backproject

        good_d = (depth_curr > 0.1) & (depth_curr < 10.0) & valid
        idx = sample_minimal_sets(key, good_d, n_hypotheses, 3)
        q_cam = backproject(cam, pts2d, depth_curr)  # [N,3] camera points
        Rs, ts = jax.vmap(lambda ii: _kabsch3(pts3d[ii], q_cam[ii]))(idx)
    else:
        idx = sample_minimal_sets(key, valid, n_hypotheses, 6)
        Rs, ts = jax.vmap(lambda ii: _dlt_pnp(pts3d[ii], x_norm[ii]))(idx)
    finite_h = jnp.all(jnp.isfinite(Rs), axis=(1, 2)) & jnp.all(
        jnp.isfinite(ts), axis=1
    )
    Rs = jnp.where(finite_h[:, None, None], Rs, jnp.eye(3, dtype=Rs.dtype))
    ts = jnp.where(finite_h[:, None], ts, 0.0)

    # pre-score the raw DLT hypotheses and keep the best few: the GN polish
    # is the expensive stage, and only competitive hypotheses can win the
    # final consensus anyway
    n_polish = min(16, n_hypotheses)
    raw_errs = jax.vmap(lambda R, t: _reproj_err_px(cam, R, t, pts3d, pts2d))(Rs, ts)
    raw_counts = jnp.sum((raw_errs < 4.0 * reproj_thresh) & valid[None, :], axis=1)
    _, keep = jax.lax.top_k(raw_counts, n_polish)
    Rs = Rs[keep]
    ts = ts[keep]
    idx = idx[keep]

    # calibrated GN polish of each kept hypothesis on its own minimal
    # sample; one-hot built by comparison (a scatter would serialize)
    n_pts = pts3d.shape[0]
    sample_w = (
        (idx[:, None, :] == jnp.arange(n_pts, dtype=idx.dtype)[None, :, None])
        .any(-1)
        .astype(pts3d.dtype)
    )  # [n_polish, N]
    poses_h = jax.vmap(
        lambda R, t, w: _pose_gn_refine(
            cam, Pose(matrix_to_quat(R), t), pts3d, pts2d, w, iters=2
        )
    )(Rs, ts, sample_w)

    if init_pose is not None:
        prior = _pose_gn_refine(
            cam, init_pose, pts3d, pts2d, valid.astype(pts3d.dtype),
            iters=4, robust=True,
            huber_delta=2.0 * reproj_thresh, gate_px=10.0 * reproj_thresh,
        )
        poses_h = jax.tree.map(
            lambda a, b: jnp.concatenate([a, b[None]]), poses_h, prior
        )

    Rh = quat_to_matrix(poses_h.q)
    errs = jax.vmap(lambda R, t: _reproj_err_px(cam, R, t, pts3d, pts2d))(
        Rh, poses_h.t
    )
    inl = (errs < reproj_thresh) & valid[None, :]
    counts = jnp.sum(inl, axis=1)
    best = jnp.argmax(counts)

    pose = jax.tree.map(lambda a: a[best], poses_h)
    finite = jnp.all(jnp.isfinite(pose.q)) & jnp.all(jnp.isfinite(pose.t))
    pose = Pose(
        jnp.where(finite, pose.q, jnp.array([1.0, 0, 0, 0], pose.q.dtype)),
        jnp.where(finite, pose.t, jnp.zeros_like(pose.t)),
    )
    mask0 = inl[best]

    pose = _pose_gn_refine(
        cam, pose, pts3d, pts2d, mask0.astype(pts3d.dtype), iters=refine_iters
    )

    # re-evaluate inliers after refinement (OpenCV returns the refined set)
    R = quat_to_matrix(pose.q)
    err = _reproj_err_px(cam, R, pose.t, pts3d, pts2d)
    mask = (err < reproj_thresh) & valid
    n_inliers = jnp.sum(mask).astype(jnp.int32)
    ok = finite & (n_inliers > 0)
    return PnPResult(pose, mask, n_inliers, ok)


@partial(jax.jit, static_argnames=("prior_iters", "refine_iters"))
def pnp_prior(
    cam: CameraParams,
    pts3d: jnp.ndarray,     # [N,3] world landmarks
    pts2d: jnp.ndarray,     # [N,2] pixels in current frame
    valid: jnp.ndarray,     # [N] bool
    init_pose: Pose,
    reproj_thresh: float = 2.0,
    prior_iters: int = 4,
    refine_iters: int = 2,
) -> PnPResult:
    """Motion-prior-only PnP: the steady-state tier of the online scan's
    two-tier tracking (scan_pipeline.track_branch).

    Runs ONLY the motion-prior robust-IRLS hypothesis of ``pnp_ransac``
    (the hypothesis that wins the consensus almost always once tracking is
    established — the utils/config.py budget-calibration note) followed by
    the same final inlier-set GN refinement and inlier re-count. Callers
    gate on ``n_inliers`` and fall back to the full ``pnp_ransac``
    hypothesis fan under ``lax.cond`` when the prior-only consensus is
    weak, so hard frames pay the full budget and steady-state frames skip
    the sampling/minimal-solver/polish pipeline entirely.
    """
    prior = _pose_gn_refine(
        cam, init_pose, pts3d, pts2d, valid.astype(pts3d.dtype),
        iters=prior_iters, robust=True,
        huber_delta=2.0 * reproj_thresh, gate_px=10.0 * reproj_thresh,
    )
    R = quat_to_matrix(prior.q)
    err = _reproj_err_px(cam, R, prior.t, pts3d, pts2d)
    mask0 = (err < reproj_thresh) & valid
    finite = jnp.all(jnp.isfinite(prior.q)) & jnp.all(jnp.isfinite(prior.t))
    pose = Pose(
        jnp.where(finite, prior.q, jnp.array([1.0, 0, 0, 0], prior.q.dtype)),
        jnp.where(finite, prior.t, jnp.zeros_like(prior.t)),
    )
    pose = _pose_gn_refine(
        cam, pose, pts3d, pts2d, mask0.astype(pts3d.dtype),
        iters=refine_iters,
    )
    R = quat_to_matrix(pose.q)
    err = _reproj_err_px(cam, R, pose.t, pts3d, pts2d)
    mask = (err < reproj_thresh) & valid
    n_inliers = jnp.sum(mask).astype(jnp.int32)
    ok = finite & (n_inliers > 0)
    return PnPResult(pose, mask, n_inliers, ok)


# ---------------------------------------------------------------------------
# triangulation
# ---------------------------------------------------------------------------

def triangulate_dlt(
    P1: jnp.ndarray, P2: jnp.ndarray, uv1: jnp.ndarray, uv2: jnp.ndarray
) -> jnp.ndarray:
    """Two-view DLT triangulation, batched over correspondences.

    P1, P2: [3,4] projection matrices (pixel-scale K[R|t] as built at
    tracking.cpp:844-854, or normalized [R|t]); uv1, uv2: [N,2].
    Solves the 4x4 system of tracking.cpp:931-945 via eigh of A^T A
    (equivalent to the smallest right singular vector) and dehomogenizes.
    """
    r0 = uv1[..., 0:1] * P1[2] - P1[0]  # [N,4]
    r1 = uv1[..., 1:2] * P1[2] - P1[1]
    r2 = uv2[..., 0:1] * P2[2] - P2[0]
    r3 = uv2[..., 1:2] * P2[2] - P2[1]
    A = jnp.stack([r0, r1, r2, r3], axis=-2)  # [N,4,4]
    # row-normalize: keeps the nullspace, conditions A^T A for float32
    A = A / jnp.maximum(jnp.linalg.norm(A, axis=-1, keepdims=True), 1e-12)
    AtA = jnp.einsum("...ki,...kj->...ij", A, A)
    X = _smallest_eigvec(AtA)  # [N,4]
    w = X[..., 3]
    safe_w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    return X[..., :3] / safe_w[..., None]


def projection_matrix(cam: CameraParams, T_cw: Pose) -> jnp.ndarray:
    """K [R|t] exactly as the reference's ProjectionMatrix (tracking.cpp:844-854)."""
    R = quat_to_matrix(T_cw.q)
    Rt = jnp.concatenate([R, T_cw.t[..., :, None]], axis=-1)
    K = jnp.array(
        [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], R.dtype
    )
    K = K.at[0, 0].set(cam.fx).at[1, 1].set(cam.fy).at[0, 2].set(cam.cx).at[1, 2].set(cam.cy)
    return K @ Rt
