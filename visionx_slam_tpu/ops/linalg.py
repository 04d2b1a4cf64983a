"""Small-matrix closed-form linear algebra as elementwise math.

``jnp.linalg.solve`` lowers batched tiny systems to LU kernels that
schedule poorly for huge batch counts (the landmark table solves are
[131072, 3, 3]); the adjugate/Cramer forms below are pure elementwise
arithmetic that XLA fuses into a handful of elementwise kernels.
"""

from __future__ import annotations

import jax.numpy as jnp


def det3x3(A: jnp.ndarray) -> jnp.ndarray:
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def inv3x3(A: jnp.ndarray, eps: float = 1e-20) -> jnp.ndarray:
    """Batched 3x3 inverse via the adjugate; singular inputs produce large
    but finite values (callers gate on their own validity masks)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    # clamp |det| >= eps, preserving sign; NOTE sign(det)*eps + eps would be
    # exactly 0 for small-negative det (the guard's failure mode)
    det_safe = jnp.where(jnp.abs(det) < eps, jnp.where(det < 0, -eps, eps), det)
    inv_det = 1.0 / det_safe
    adj = jnp.stack(
        [
            jnp.stack([A00, A01, A02], -1),
            jnp.stack([A10, A11, A12], -1),
            jnp.stack([A20, A21, A22], -1),
        ],
        -2,
    )
    return adj * inv_det[..., None, None]


def solve3x3(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched solve of A x = b for [..., 3, 3] x [..., 3]."""
    return jnp.einsum("...ij,...j->...i", inv3x3(A), b)


def inv2x2(A: jnp.ndarray, eps: float = 1e-30) -> jnp.ndarray:
    a, b = A[..., 0, 0], A[..., 0, 1]
    c, d = A[..., 1, 0], A[..., 1, 1]
    det = a * d - b * c
    det_safe = jnp.where(jnp.abs(det) < eps, jnp.where(det < 0, -eps, eps), det)
    inv_det = 1.0 / det_safe
    m = jnp.stack([jnp.stack([d, -b], -1), jnp.stack([-c, a], -1)], -2)
    return m * inv_det[..., None, None]


def solve4x4(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched solve of SPD-ish A x = b for [..., 4, 4] x [..., 4] via a
    2x2-block Schur complement (pivot-free; the leading 2x2 block must be
    invertible, true for the SPD normal matrices used here). Pure elementwise
    math — batched LU on [N,4,4] was pathologically slow on the earlier
    accelerator, where this was chosen (not yet measured on the H100)."""
    P = A[..., :2, :2]
    Q = A[..., :2, 2:]
    R = A[..., 2:, :2]
    S = A[..., 2:, 2:]
    b1 = b[..., :2]
    b2 = b[..., 2:]
    Pi = inv2x2(P)
    RPi = R @ Pi
    M = S - RPi @ Q
    Mi = inv2x2(M)
    y2 = jnp.einsum("...ij,...j->...i", Mi,
                    b2 - jnp.einsum("...ij,...j->...i", RPi, b1))
    y1 = jnp.einsum(
        "...ij,...j->...i", Pi, b1 - jnp.einsum("...ij,...j->...i", Q, y2)
    )
    return jnp.concatenate([y1, y2], axis=-1)


def chol_solve4x4(A: jnp.ndarray, b: jnp.ndarray,
                  eps: float = 1e-30) -> jnp.ndarray:
    """Solve SPD [..., 4, 4] x [..., 4] via fully UNROLLED scalar Cholesky
    (same rationale as ``chol_solve6x6``: the block-Schur ``solve4x4``
    contains [...,2,2] matmuls that lower to separate tiny dot kernels;
    this form is one fused elementwise kernel)."""
    a = [[A[..., i, j] for j in range(4)] for i in range(4)]
    L = [[None] * 4 for _ in range(4)]
    for i in range(4):
        for j in range(i + 1):
            s = a[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, eps))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * 4
    for i in range(4):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * 4
    for i in reversed(range(4)):
        s = y[i]
        for k in range(i + 1, 4):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)


def chol3x3(A: jnp.ndarray, eps: float = 1e-20) -> jnp.ndarray:
    """Batched lower-Cholesky of SPD [..., 3, 3] in closed form."""
    a00 = jnp.sqrt(jnp.maximum(A[..., 0, 0], eps))
    l10 = A[..., 1, 0] / a00
    l20 = A[..., 2, 0] / a00
    l11 = jnp.sqrt(jnp.maximum(A[..., 1, 1] - l10 * l10, eps))
    l21 = (A[..., 2, 1] - l20 * l10) / l11
    l22 = jnp.sqrt(jnp.maximum(A[..., 2, 2] - l20 * l20 - l21 * l21, eps))
    zero = jnp.zeros_like(a00)
    return jnp.stack(
        [
            jnp.stack([a00, zero, zero], -1),
            jnp.stack([l10, l11, zero], -1),
            jnp.stack([l20, l21, l22], -1),
        ],
        -2,
    )


def chol_solve6x6(A: jnp.ndarray, b: jnp.ndarray,
                  eps: float = 1e-12) -> jnp.ndarray:
    """Solve SPD [..., 6, 6] x [..., 6] via a fully UNROLLED scalar
    Cholesky + two triangular substitutions.

    Rationale vs ``solve6x6_spd`` (block-Schur): the Schur form contains
    3x3 matrix products that lower to separate tiny dot kernels — on the
    online scan's serial per-frame chain each kernel costs ~µs of fixed
    latency, and the solve runs once per GN iteration. This form is pure
    scalar elementwise arithmetic (slices, *, /, sqrt), which XLA fuses
    into a single kernel. Same damped-SPD domain; float32 rounding differs
    at epsilon level from the Schur form.
    """
    a = [[A[..., i, j] for j in range(6)] for i in range(6)]
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            s = a[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, eps))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * 6
    for i in range(6):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)


def solve6x6_spd(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched solve of SPD [..., 6, 6] x [..., 6] via a 3x3-block Schur
    complement (pivot-free; valid for the damped Gauss-Newton normal
    matrices used here). Pure elementwise math — ``jnp.linalg.solve``
    lowered batched tiny systems to LU loops that serialized on the earlier
    accelerator, where this was chosen (not yet measured on the H100)."""
    P = A[..., :3, :3]
    Q = A[..., :3, 3:]
    R = A[..., 3:, :3]
    S = A[..., 3:, 3:]
    b1 = b[..., :3]
    b2 = b[..., 3:]
    Pi = inv3x3(P)
    RPi = R @ Pi
    M = S - RPi @ Q
    Mi = inv3x3(M)
    y2 = jnp.einsum("...ij,...j->...i", Mi,
                    b2 - jnp.einsum("...ij,...j->...i", RPi, b1))
    y1 = jnp.einsum(
        "...ij,...j->...i", Pi, b1 - jnp.einsum("...ij,...j->...i", Q, y2)
    )
    return jnp.concatenate([y1, y2], axis=-1)
