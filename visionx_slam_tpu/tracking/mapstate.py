"""Immutable fixed-capacity map state: the device-side replacement for
the reference's mutex-guarded object graph.

The reference stores the map as ``std::map<id, Frame::Ptr>`` +
``unordered_map<id, Landmark::Ptr>`` guarded by mutexes, with per-feature
``landmark_id/has_landmark/is_outlier`` flags on each Frame
(core/map/map.h:13-34, core/map/landmark.h:12-68, core/frame/frame.h:16-64).
Here the whole map is ONE pytree of fixed-capacity SoA tables threaded
functionally through the pipeline (SURVEY.md §7.6) — no locks, no object
identity, no dynamic allocation:

- keyframes live in a ring of ``K`` slots (pose, feature pixels,
  descriptors, validity, feature->landmark links);
- landmarks live in a table with an alive mask and a monotone allocation
  cursor ("removal" = mask clear);
- the observation relation is the ``feat_lm`` table: ``feat_lm[k, i] = j``
  encodes landmark j observed by keyframe slot k at feature i — exactly
  the information the reference scatters across Landmark::observations_
  maps and Feature flags. Sentinels: FREE (-1) = no landmark,
  OUTLIER (-2) = reference's ``is_outlier`` feature flag.
- per-landmark observation COUNTS (Landmark::ObservationCount,
  landmark.h:44) are maintained INCREMENTALLY in ``lm_obs``: on the earlier
  accelerator, where this was designed, scatters serialized per update and
  recomputing the counts as a 64k-element histogram cost more than an entire
  tracked frame (not yet measured on the H100); counts only change at landmark
  creation / landmark removal / keyframe removal, all of which are cheap to
  account for at the point of mutation.

Scatter avoidance: allocation is CONTIGUOUS (slots issue sequentially
from ``next_lm``), so new-landmark writes are a sort + one
``dynamic_update_slice`` instead of a scatter. The landmark tables carry
``n_features`` physical padding rows past the logical capacity so the
update window never clamps; padding rows can never become alive.

Capacity semantics vs the reference: the reference's keyframe store grows
without bound (with culling off, its default); our ring evicts the oldest
keyframe once ``K`` slots are exhausted. Only the last ``ba_window_size``
keyframes influence tracking/BA, so eviction is behavior-preserving for
the estimated trajectory; landmark overflow drops new landmarks (counted
in stats so it is observable).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.se3 import Pose

FREE = -1      # feature has no landmark (reference has_landmark == false)
OUTLIER = -2   # feature marked outlier  (reference is_outlier == true)


class MapState(NamedTuple):
    # --- keyframe ring [K, ...] ---
    kf_q: jnp.ndarray        # [K,4] T_cw rotation (wxyz)
    kf_t: jnp.ndarray        # [K,3] T_cw translation
    kf_id: jnp.ndarray       # [K] int32 frame id, -1 = empty slot
    kf_px: jnp.ndarray       # [K,2,N] feature pixels (coordinate-major,
                             # as lm_pos)
    kf_desc: jnp.ndarray     # [K,N,32] uint8 descriptors
    kf_fvalid: jnp.ndarray   # [K,N] feature validity
    kf_feat_lm: jnp.ndarray  # [K,N] int32 landmark slot / FREE / OUTLIER
    kf_depth: jnp.ndarray    # [K,N] depth (m) sampled at the feature, 0 = none
    # --- landmark table [Lp = L + N padding, ...] ---
    lm_pos: jnp.ndarray      # [3,Lp] (coordinate-major: chosen for the
                             # earlier accelerator, whose tiling padded a
                             # small trailing dim; not yet measured on the
                             # H100)
    lm_alive: jnp.ndarray    # [Lp] bool
    lm_obs: jnp.ndarray      # [Lp] int32 incremental observation counts
    # --- cursors ---
    next_kf: jnp.ndarray     # [] int32 ring cursor (monotone; slot = next_kf % K)
    next_lm: jnp.ndarray     # [] int32 allocation cursor (monotone, drops at L)
    lm_dropped: jnp.ndarray  # [] int32 landmarks lost to capacity overflow

    @property
    def kf_capacity(self) -> int:
        return self.kf_id.shape[0]

    @property
    def n_features(self) -> int:
        return self.kf_px.shape[2]

    @property
    def lm_capacity(self) -> int:
        """LOGICAL landmark capacity (allocation limit)."""
        return self.lm_pos.shape[1] - self.n_features

    @property
    def lm_physical(self) -> int:
        """Physical table size (logical capacity + padding rows)."""
        return self.lm_pos.shape[1]


def empty_map(
    kf_capacity: int = 64, lm_capacity: int = 1 << 17, n_features: int = 1024
) -> MapState:
    K, N = kf_capacity, n_features
    Lp = lm_capacity + n_features
    return MapState(
        kf_q=jnp.zeros((K, 4), jnp.float32).at[:, 0].set(1.0),
        kf_t=jnp.zeros((K, 3), jnp.float32),
        kf_id=jnp.full((K,), -1, jnp.int32),
        kf_px=jnp.zeros((K, 2, N), jnp.float32),
        kf_desc=jnp.zeros((K, N, 32), jnp.uint8),
        kf_fvalid=jnp.zeros((K, N), bool),
        kf_feat_lm=jnp.full((K, N), FREE, jnp.int32),
        kf_depth=jnp.zeros((K, N), jnp.float32),
        lm_pos=jnp.zeros((3, Lp), jnp.float32),
        lm_alive=jnp.zeros((Lp,), bool),
        lm_obs=jnp.zeros((Lp,), jnp.int32),
        next_kf=jnp.zeros((), jnp.int32),
        next_lm=jnp.zeros((), jnp.int32),
        lm_dropped=jnp.zeros((), jnp.int32),
    )


def kf_alive(ms: MapState) -> jnp.ndarray:
    return ms.kf_id >= 0


def n_keyframes(ms: MapState) -> jnp.ndarray:
    return jnp.sum(kf_alive(ms)).astype(jnp.int32)


def n_landmarks(ms: MapState) -> jnp.ndarray:
    return jnp.sum(ms.lm_alive).astype(jnp.int32)


def _links_delta(ms: MapState, links: jnp.ndarray, active: jnp.ndarray,
                 delta: int) -> jnp.ndarray:
    """lm_obs +/- 1 for every valid link in ``links`` (sorted scatter of
    <= N updates; used only on the insert/remove paths)."""
    idx = jnp.sort(jnp.where(active & (links >= 0), links, ms.lm_physical))
    return ms.lm_obs.at[idx].add(jnp.int32(delta), indices_are_sorted=True,
                                 mode="drop")


def insert_keyframe(
    ms: MapState,
    frame_id: jnp.ndarray,
    pose: Pose,
    px: jnp.ndarray,
    desc: jnp.ndarray,
    fvalid: jnp.ndarray,
    feat_lm: jnp.ndarray,
    depth: jnp.ndarray,
    *,
    fresh_links: bool = False,
) -> tuple[MapState, jnp.ndarray]:
    """Insert a keyframe into the ring; returns (state, slot).

    Replaces Map::InsertKeyFrame (map.cpp). Evicting a previous occupant
    removes its observations (lm_obs decremented), the moral equivalent of
    RemoveKeyFrame on the oldest. ``fresh_links=True`` (static) asserts
    ``feat_lm`` is all-FREE — the scan's insert always is — and skips the
    observation-count scatter for the incoming links (a sort + scatter
    that would add nothing).
    """
    slot = ms.next_kf % ms.kf_capacity
    old_links = ms.kf_feat_lm[slot]
    was_alive = ms.kf_id[slot] >= 0
    # the eviction decrement only matters once the ring has wrapped; the
    # cond skips its sort+scatter for the first K inserts of a
    # sequence (under vmap it becomes a select — the false branch is the
    # identity, so batched callers lose nothing)
    lm_obs = jax.lax.cond(
        was_alive,
        lambda m: _links_delta(
            m, old_links, jnp.ones_like(old_links, bool), -1),
        lambda m: m.lm_obs,
        ms,
    )
    ms = ms._replace(lm_obs=lm_obs)
    if fresh_links:
        lm_obs = ms.lm_obs
    else:
        lm_obs = _links_delta(ms, feat_lm, jnp.ones_like(feat_lm, bool), +1)
    return (
        ms._replace(
            kf_q=ms.kf_q.at[slot].set(pose.q),
            kf_t=ms.kf_t.at[slot].set(pose.t),
            kf_id=ms.kf_id.at[slot].set(frame_id.astype(jnp.int32)),
            kf_px=ms.kf_px.at[slot].set(px.T),
            kf_desc=ms.kf_desc.at[slot].set(desc),
            kf_fvalid=ms.kf_fvalid.at[slot].set(fvalid),
            kf_feat_lm=ms.kf_feat_lm.at[slot].set(feat_lm),
            kf_depth=ms.kf_depth.at[slot].set(depth),
            lm_obs=lm_obs,
            next_kf=ms.next_kf + 1,
        ),
        slot,
    )


def allocate_landmarks(
    ms: MapState, want: jnp.ndarray, pos: jnp.ndarray, obs_init: int = 1
) -> tuple[MapState, jnp.ndarray]:
    """Allocate landmark slots for a batch of candidates — scatter-free.

    ``want``: [N] bool — which candidates to create; ``pos``: [N,3] world
    positions; ``obs_init``: observation count each new landmark starts
    with (1 for depth backprojection, 2 for two-view triangulation).
    Returns (state, slots [N] int32 with FREE where not created/dropped).

    Slots issue contiguously from ``next_lm``, so the writes are a compaction
    (created rows first, original order — matching the slot order) followed by
    a dynamic_update_slice into the padded table. This replaces the reference's
    per-feature ``new Landmark(id++, pw)`` loops (tracking.cpp:640-644,
    :915-918) without any serializing scatter. The compaction itself is a
    one-hot matmul, NOT a sort: on the earlier accelerator an [N] argsort cost
    far more than the [N,N]x[N,3] contraction (chosen there, not yet measured
    on the H100; this runs on the per-keyframe event path of the online scan).
    """
    N = want.shape[0]
    L = ms.lm_capacity
    offs = jnp.cumsum(want.astype(jnp.int32)) - 1   # rank among wanted
    slots = ms.next_lm + offs
    ok = want & (slots < L)
    slots = jnp.where(ok, slots, FREE)
    n_created = jnp.sum(ok).astype(jnp.int32)

    # created rows first, original order preserved: pos_sorted[j] = pos[i]
    # where rank(i) == j (one-hot contraction; f32 is exact for these
    # coordinate payloads)
    onehot = (
        jnp.where(ok, offs, N)[:, None]
        == jnp.arange(N, dtype=offs.dtype)[None, :]
    ).astype(pos.dtype)                              # [N rows, N dest]
    # zero non-created rows: 0 * NaN would poison the contraction (the
    # rejected rows of triangulated batches are routinely non-finite)
    pos_clean = jnp.where(ok[:, None], pos, 0.0)
    pos_sorted = jnp.einsum("ij,ic->jc", onehot, pos_clean)

    start = ms.next_lm  # < L <= Lp - N, so the N-row window always fits
    iota = jnp.arange(N)
    created_row = iota < n_created

    pos_win = jax.lax.dynamic_slice(ms.lm_pos, (0, start), (3, N))
    pos_win = jnp.where(created_row[None, :], pos_sorted.T, pos_win)
    lm_pos = jax.lax.dynamic_update_slice(ms.lm_pos, pos_win, (0, start))

    alive_win = jax.lax.dynamic_slice(ms.lm_alive, (start,), (N,))
    alive_win = jnp.where(created_row, True, alive_win)
    lm_alive = jax.lax.dynamic_update_slice(ms.lm_alive, alive_win, (start,))

    obs_win = jax.lax.dynamic_slice(ms.lm_obs, (start,), (N,))
    obs_win = jnp.where(created_row, jnp.int32(obs_init), obs_win)
    lm_obs = jax.lax.dynamic_update_slice(ms.lm_obs, obs_win, (start,))

    n_wanted = jnp.sum(want).astype(jnp.int32)
    return (
        ms._replace(
            lm_pos=lm_pos,
            lm_alive=lm_alive,
            lm_obs=lm_obs,
            next_lm=jnp.minimum(ms.next_lm + n_wanted, L),
            lm_dropped=ms.lm_dropped + (n_wanted - n_created),
        ),
        slots,
    )


def landmark_observation_counts(ms: MapState) -> jnp.ndarray:
    """[Lp] int32 observation counts (incremental field; the batched
    equivalent of Landmark::ObservationCount, landmark.h:44)."""
    return ms.lm_obs


def remove_landmarks(ms: MapState, kill: jnp.ndarray) -> MapState:
    """Kill landmarks (mask clear) and detach their feature links, marking
    those features as outliers — mirroring the removal loop at
    tracking.cpp:729-747 (feat.has_landmark=false, is_outlier=true).

    ``kill``: [Lp] bool.
    """
    lm = ms.kf_feat_lm
    pointed = (lm >= 0) & kill[jnp.clip(lm, 0, ms.lm_physical - 1)]
    new_links = jnp.where(pointed, OUTLIER, lm)
    return ms._replace(
        lm_alive=ms.lm_alive & ~kill,
        lm_obs=jnp.where(kill, 0, ms.lm_obs),
        kf_feat_lm=new_links,
    )


def remove_keyframe_slot(ms: MapState, slot: jnp.ndarray) -> MapState:
    """Remove one keyframe (RemoveKeyFrame, tracking.cpp:752-773): clear the
    slot and decrement the observation counts of its landmarks."""
    links = ms.kf_feat_lm[slot]
    was_alive = ms.kf_id[slot] >= 0
    lm_obs = _links_delta(ms, links, jnp.broadcast_to(was_alive, links.shape), -1)
    return ms._replace(
        kf_id=ms.kf_id.at[slot].set(-1),
        kf_fvalid=ms.kf_fvalid.at[slot].set(False),
        kf_feat_lm=ms.kf_feat_lm.at[slot].set(FREE),
        lm_obs=lm_obs,
    )


def compact_landmarks(ms: MapState) -> MapState:
    """Compact alive landmarks to the front of the table and remap links.

    The allocator is monotone (contiguous slots, scatter-free); long
    sequences exhaust the logical capacity even though most old landmarks
    are unreachable (their keyframes were ring-evicted; with culling off —
    the reference default — nothing ever marks them dead). A landmark with
    ZERO live observations cannot be referenced by any feat->lm link, so
    it is reaped here. Compaction = one stable sort moving the kept rows
    to the front (relative order preserved) + a gather remap of every
    link. Runs rarely (guarded by the caller when the cursor approaches
    capacity), costs two argsorts of the table.
    """
    Lp = ms.lm_physical
    keep = ms.lm_alive & (ms.lm_obs > 0)
    order = jnp.argsort(jnp.where(keep, 0, 1), stable=True)  # kept rows first
    inv = jnp.argsort(order)  # old slot -> new slot
    n_keep = jnp.sum(keep).astype(jnp.int32)

    links = ms.kf_feat_lm
    remapped = jnp.where(
        links >= 0, inv[jnp.clip(links, 0, Lp - 1)].astype(jnp.int32), links
    )
    return ms._replace(
        lm_pos=ms.lm_pos[:, order],
        lm_alive=ms.lm_alive[order] & (ms.lm_obs[order] > 0),
        lm_obs=jnp.where(keep[order], ms.lm_obs[order], 0),
        kf_feat_lm=remapped,
        next_lm=n_keep,
    )


def window_slots(ms: MapState, window_size: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Slots of the most recent ``window_size`` alive keyframes, ascending
    by frame id (SelectKeyFrames, local_ba.cpp:42-62). Returns
    (slots [window_size] int32, valid [window_size] bool); invalid entries
    point at slot 0 and must be masked by callers."""
    ids = jnp.where(kf_alive(ms), ms.kf_id, jnp.int32(-1))
    order = jnp.argsort(-ids)  # descending id; dead (-1) sink to the end
    top = order[:window_size][::-1]  # ascending among the newest
    valid = ids[top] >= 0
    return top.astype(jnp.int32), valid


def map_pose(ms: MapState, slot: jnp.ndarray) -> Pose:
    return Pose(ms.kf_q[slot], ms.kf_t[slot])
