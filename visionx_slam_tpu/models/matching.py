"""Brute-force 2-NN Hamming matching as a batched GEMM.

Replaces the reference's ``ORBMatcher`` (core/feature/orb_matcher.cpp:22-41:
cv::BFMatcher(NORM_HAMMING) 2-NN + Lowe ratio test, nn_ratio = 0.8) and the
match-quality distance filter applied at every call site
(tracking.cpp:212-222, :291-304, :343-355: keep d <= max(2*min_dist, 30)).

Design: for binary vectors a, b in {0,1}^256,

    hamming(a, b) = popcount(a XOR b) = |a| + |b| - 2 <a, b>

so the full N x M distance matrix is ONE [N,256]x[256,M] matmul (int8
0/1 bit planes, exact integer products), plus rank-1
row/col sum corrections — no bit twiddling on the vector unit. The top-2
selection is two masked min-reductions. Everything is fixed-shape and
masked: invalid descriptor slots get distance +BIG and can never match.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

BIG = 1e9
NN_RATIO = 0.8          # reference orb_matcher.h:14
MIN_DIST_FLOOR = 30.0   # reference tracking.cpp:218 max(2*min_dist, 30)
MIN_DIST_INIT = 100.0   # reference tracking.cpp:212/294 min_dist initialization


class MatchResult(NamedTuple):
    """Fixed-shape match table: row i describes query descriptor i."""

    idx: jnp.ndarray    # [N] int32, best-match index into the train set
    dist: jnp.ndarray   # [N] float32, Hamming distance of the best match
    valid: jnp.ndarray  # [N] bool, True where a ratio-test match exists


def unpack_bits(desc_u8: jnp.ndarray) -> jnp.ndarray:
    """uint8 [..., 32] -> {0,1} bit planes [..., 256] (LSB-first per byte)."""
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = (desc_u8[..., :, None] >> shifts) & jnp.uint8(1)
    return bits.reshape(*desc_u8.shape[:-1], desc_u8.shape[-1] * 8)


def hamming_matrix(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """Full Hamming distance matrix [N, M] (bf16) from uint8 descriptors
    [N,32]/[M,32].

    Computed as |a| + |b| - 2 a.b with the inner product as one GEMM of
    int8 bit planes with an int32 result (exact by construction; XLA:GPU
    has no int8 GEMM with a bf16 result). The matrix itself is bf16:
    every distance is an
    integer in [0, 256], which bf16 represents EXACTLY, so argmin/ratio
    decisions are bit-identical to f32 while the [N,M] intermediate (the
    matcher's bandwidth cost) halves.
    """
    a, pop_a = unpack_with_pop(desc_a)
    b, pop_b = unpack_with_pop(desc_b)
    return _hamming_from_bits(a, pop_a, b, pop_b)


def _hamming_from_bits(bits_a, pop_a, bits_b, pop_b) -> jnp.ndarray:
    dot = jax.lax.dot_general(
        bits_a, bits_b, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    # the correction arithmetic runs in f32 (pop_a+pop_b reaches 512 and
    # ODD intermediates above 256 are not bf16-exact); only the final
    # bf16 matrix is narrowed
    d = pop_a[:, None] + pop_b[None, :] - 2.0 * dot.astype(jnp.float32)
    return d.astype(jnp.bfloat16)


def unpack_with_pop(desc_u8: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(bit planes int8 [..., 256], popcounts f32 [...]) of descriptors.

    The scan pipeline precomputes these OUTSIDE its serial loop (for all
    frames batched) and carries the active keyframe's copy, so the
    per-frame matcher starts at the GEMM instead of re-unpacking both
    sides every frame."""
    bits = unpack_bits(desc_u8).astype(jnp.int8)
    pop = jnp.sum(bits, axis=-1, dtype=jnp.int32).astype(jnp.float32)
    return bits, pop


def knn2_from_bits(
    bits_a: jnp.ndarray,
    pop_a: jnp.ndarray,
    valid_a: jnp.ndarray,
    bits_b: jnp.ndarray,
    pop_b: jnp.ndarray,
    valid_b: jnp.ndarray,
    nn_ratio: float = NN_RATIO,
) -> MatchResult:
    """``knn2_ratio_match`` on pre-unpacked bit planes (bit-identical —
    the unpack/popcount hoist is pure refactoring)."""
    D = _hamming_from_bits(bits_a, pop_a, bits_b, pop_b)
    return _knn2_select(D, valid_a, valid_b, nn_ratio)


@partial(jax.jit, static_argnames=("nn_ratio",))
def knn2_ratio_match(
    desc_a: jnp.ndarray,
    valid_a: jnp.ndarray,
    desc_b: jnp.ndarray,
    valid_b: jnp.ndarray,
    nn_ratio: float = NN_RATIO,
) -> MatchResult:
    """2-NN + Lowe ratio matching (orb_matcher.cpp:22-36 semantics).

    A query keeps its best train match iff ``d1 < nn_ratio * d2`` where d2 is
    the second-best distance. Rows/cols with invalid descriptors are masked.
    """
    D = hamming_matrix(desc_a, desc_b)          # bf16, integer-exact
    return _knn2_select(D, valid_a, valid_b, nn_ratio)


def _knn2_select(
    D: jnp.ndarray,
    valid_a: jnp.ndarray,
    valid_b: jnp.ndarray,
    nn_ratio: float,
) -> MatchResult:
    """Top-2 + ratio selection over a bf16 distance matrix."""
    D = jnp.where(valid_b[None, :], D, jnp.bfloat16(BIG))

    idx1 = jnp.argmin(D, axis=1)
    d1 = jnp.take_along_axis(D, idx1[:, None], axis=1)[:, 0]
    # mask out the best column, find the runner-up
    cols = jnp.arange(D.shape[1], dtype=idx1.dtype)
    D2 = jnp.where(cols[None, :] == idx1[:, None], jnp.bfloat16(BIG), D)
    d2 = jnp.min(D2, axis=1)

    # decisions in f32: the distances are bf16-exact integers, but the
    # ratio product 0.8*d2 is not a bf16-exact value
    d1 = d1.astype(jnp.float32)
    d2 = d2.astype(jnp.float32)
    # real Hamming distances are <= 256; anything above is the BIG mask
    ok = (d1 < nn_ratio * d2) & valid_a & (d1 <= 256.0)
    return MatchResult(idx1.astype(jnp.int32), d1, ok)


def reference_distance_filter(res: MatchResult) -> MatchResult:
    """The per-call-site quality filter: keep d <= max(2*min_dist, 30).

    ``min_dist`` is the minimum matched distance, initialized at 100
    (tracking.cpp:212-222 / :291-304 / :343-355 — identical logic at each
    site).
    """
    dmin = jnp.min(jnp.where(res.valid, res.dist, MIN_DIST_INIT))
    dmin = jnp.minimum(dmin, MIN_DIST_INIT)
    thresh = jnp.maximum(2.0 * dmin, MIN_DIST_FLOOR)
    return MatchResult(res.idx, res.dist, res.valid & (res.dist <= thresh))


@partial(jax.jit, static_argnames=("nn_ratio",))
def match_frames(
    desc_a: jnp.ndarray,
    valid_a: jnp.ndarray,
    desc_b: jnp.ndarray,
    valid_b: jnp.ndarray,
    nn_ratio: float = NN_RATIO,
) -> MatchResult:
    """knn2 ratio match followed by the reference distance filter — the exact
    match pipeline every tracking stage uses."""
    return reference_distance_filter(
        knn2_ratio_match(desc_a, valid_a, desc_b, valid_b, nn_ratio)
    )


# Batched variant for throughput mode: leading batch dim over frame pairs.
match_frames_batched = jax.jit(
    jax.vmap(match_frames, in_axes=(0, 0, 0, 0, None)), static_argnames=("nn_ratio",)
)
