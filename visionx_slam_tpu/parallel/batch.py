"""Throughput mode: batched multi-sequence mapping over a device mesh.

The reference has NO data parallelism (SURVEY.md §2.2: its only parallelism
is three host threads + mutexes). Here independent sequences map in
parallel across a ``jax.sharding.Mesh`` ("seq" axis = data parallelism
over the device interconnect, NVLink between GPUs), one SPMD-jitted SLAM
step per frame batch, with XLA collectives (psum) for fleet-level
statistics — BASELINE.json config 5 (all fr1 sequences in parallel
across several chips).

``slam_step`` is the fully-fused, host-sync-free device step: match
against the newest keyframe -> PnP RANSAC -> keyframe insert -> depth +
triangulated landmark creation -> windowed local BA. It is the "training
step" analog the multi-chip dry run compiles (see __graft_entry__.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..models import matching
from ..models.estimation import pnp_ransac
from ..models.local_ba import BAOptions, local_ba
from ..ops.camera import CameraParams
from ..tracking import mapstate as msl
from ..tracking import stages
from ..tracking.mapstate import FREE, MapState
from ..tracking.stages import FrameObs


def make_mesh(n_devices: int | None = None, axis: str = "seq") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    import numpy as np

    return Mesh(np.array(devs), (axis,))


def slam_step(
    ms: MapState,
    obs: FrameObs,
    frame_id: jnp.ndarray,
    cam: CameraParams,
    key: jax.Array,
    n_hypotheses: int = 64,
    ba_opts: BAOptions = BAOptions(max_iterations=2),
) -> tuple[MapState, jnp.ndarray, dict]:
    """One fused mapping step (no host round trips): track the frame
    against the newest keyframe, insert it as a keyframe, grow the map,
    run windowed BA. Returns (state, T_cw 4x4, stats)."""
    from ..ops.se3 import se3_matrix

    slots, svalid = msl.window_slots(ms, 1)
    slot = slots[0]
    m = matching.match_frames(
        ms.kf_desc[slot], ms.kf_fvalid[slot] & svalid[0], obs.desc, obs.valid
    )
    pts3d, pts2d, valid = stages.pnp_correspondences(ms, slot, obs, m)
    sol = pnp_ransac(cam, pts3d, pts2d, valid, key, 2.0, n_hypotheses, 5)
    # fall back to the previous keyframe pose when PnP is degenerate
    prev_pose = msl.map_pose(ms, slot)
    use = sol.ok & (sol.n_inliers >= 4)
    pose = jax.tree.map(
        lambda a, b: jnp.where(use, a, b), sol.pose, prev_pose
    )

    ms, new_slot = msl.insert_keyframe(
        ms, frame_id, pose, obs.px, obs.desc, obs.valid,
        jnp.full((ms.n_features,), FREE, jnp.int32), obs.depth,
    )
    ms = stages.depth_landmarks(ms, cam, new_slot, pose)
    ms = stages.triangulate_pair(ms, cam, slot, new_slot, 1.0, 5.0)
    ms, ba = local_ba(ms, cam, ba_opts)
    stats = {
        "inliers": sol.n_inliers,
        "matches": jnp.sum(m.valid).astype(jnp.int32),
        "ba_cost": ba.final_cost,
    }
    return ms, se3_matrix(pose), stats


def batched_slam_step(mesh: Mesh, cam: CameraParams, **step_kw):
    """Build the SPMD batched step: leading axis = sequences, sharded over
    the mesh; per-fleet totals are aggregated with one psum."""
    axis = mesh.axis_names[0]

    vstep = jax.vmap(
        lambda ms, obs, fid, key: slam_step(ms, obs, fid, cam, key, **step_kw)
    )

    def _step(mss, obss, fids, keys):
        mss2, poses, stats = vstep(mss, obss, fids, keys)
        fleet = {
            "total_inliers": jax.lax.psum(jnp.sum(stats["inliers"]), axis),
            "total_matches": jax.lax.psum(jnp.sum(stats["matches"]), axis),
        }
        return mss2, poses, fleet

    sharded = shard_map(
        _step,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def sharded_offline_pipeline(mesh: Mesh, cam: CameraParams, opts,
                             refine_iterations: int = 1, **kw):
    """Batched offline mapping over a device mesh (BASELINE config 5 on
    several chips): the lane axis of the batched offline pipeline
    (tracking/offline_pipeline.py) shards over the mesh's "seq" axis, each
    device runs its local lanes (the same folded composition the
    single-chip batched mode uses), and fleet totals ride one psum.
    Lanes are fully independent, so
    sharded results match the unsharded vmap to float-reassociation
    tolerance (pinned by
    tests/test_multichip.py::test_sharded_offline_equals_unsharded).

    Returns jit(f(images[B,T,H,W] u8, depths[B,T,H,W] f32) ->
    (MapState [B,...], OfflineOut [B,...], fleet dict)); B must be a
    multiple of the mesh size.
    """
    from ..tracking.offline_pipeline import build_offline_pipeline

    axis = mesh.axis_names[0]
    run = build_offline_pipeline(
        None, opts, refine_iterations=refine_iterations, **kw
    )

    def local(g, d):                        # [B_local, T, H, W]
        # run.batched_lanes is the single source of truth for the batched
        # composition — the per-device body here is EXACTLY the
        # single-chip batched mode, so sharded == unsharded by shape
        ms, out = run.batched_lanes(cam, g, d)
        fleet = {
            "total_tracked": jax.lax.psum(
                jnp.sum(out.tracked.astype(jnp.int32)), axis),
            "total_keyframes": jax.lax.psum(jnp.sum(out.n_keyframes), axis),
            "total_landmarks": jax.lax.psum(jnp.sum(out.n_landmarks), axis),
        }
        return ms, out, fleet

    sharded = shard_map(
        local, mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def stack_states(states: list[MapState]) -> MapState:
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def stack_obs(obs: list[FrameObs]) -> FrameObs:
    return jax.tree.map(lambda *xs: jnp.stack(xs), *obs)


def make_rendered_fleet(
    cam: CameraParams, dataset_root: str, n_seq: int,
    n_features: int = 1024, kf_capacity: int = 8,
    lm_capacity: int = 1 << 14,
    sequence: str = "rgbd_dataset_freiburg3_synthetic",
):
    """Fleet built from REAL rendered 640x480 frames through the real
    extractor (VERDICT r4 #5: correctness at bench shapes, not the 64x48
    toy scene): lane b's keyframe is frame b (depth-backprojected
    landmarks from its ORB features), its observation frame b+1. Returns
    (states, obs, frame_ids, keys, gt_rel) where ``gt_rel`` is the list
    of ground-truth [4,4] relative camera transforms T_{c1<-c0} each
    lane's PnP must recover."""
    import numpy as np
    from scipy.spatial.transform import Rotation

    from ..data import tum
    from ..models.orb_jax import orb_extract
    from ..ops.se3 import identity_pose

    ds = tum.TumDataset(dataset_root, sequence)
    assert ds.load()
    entries = ds.entries[: n_seq + 1]
    assert len(entries) == n_seq + 1, "dataset too short for fleet"

    ext = jax.jit(partial(orb_extract, n_slots=n_features))
    feats, depths = [], []
    for e in entries:
        gray = tum.load_rgb_gray(e.rgb_path)
        d_img = tum.load_depth_m(e.depth_path)
        px, resp, desc, valid = ext(gray)
        d = stages.sample_depth_image(jnp.asarray(d_img), px, valid)
        feats.append((px, resp, desc, valid))
        depths.append(d)

    def w_mat(e):
        T = np.eye(4)
        T[:3, :3] = Rotation.from_quat(e.gt_q).as_matrix()
        T[:3, 3] = e.gt_t
        return T                       # T_wc (camera-to-world, TUM GT)

    states, obss, gt_rel = [], [], []
    for b in range(n_seq):
        px, resp, desc, valid = feats[b]
        ms = msl.empty_map(kf_capacity=kf_capacity,
                           lm_capacity=lm_capacity,
                           n_features=n_features)
        ms, slot = msl.insert_keyframe(
            ms, jnp.asarray(0), identity_pose(), px, desc, valid,
            jnp.full((n_features,), FREE, jnp.int32), depths[b],
        )
        ms = stages.depth_landmarks(ms, cam, slot, identity_pose())
        px1, resp1, desc1, valid1 = feats[b + 1]
        obss.append(FrameObs(px=px1, response=resp1, desc=desc1,
                             valid=valid1, depth=depths[b + 1]))
        states.append(ms)
        # world = lane keyframe's camera frame: T_cw of the obs frame is
        # the GT relative transform c_{b+1} <- c_b
        gt_rel.append(np.linalg.inv(w_mat(entries[b + 1])) @ w_mat(entries[b]))

    fids = jnp.ones((n_seq,), jnp.int32)
    keys = jax.random.split(jax.random.PRNGKey(7), n_seq)
    return stack_states(states), stack_obs(obss), fids, keys, gt_rel


def make_correlated_fleet(
    cam: CameraParams, n_seq: int, n_features: int = 64, seed: int = 0,
    kf_capacity: int = 8, lm_capacity: int = 256,
):
    """Per-sequence synthetic scenes with GEOMETRICALLY CONSISTENT second
    frames: each lane's current observation is the keyframe's landmarks
    re-projected under a known small motion with IDENTICAL descriptors, so
    matching and PnP genuinely succeed on every lane (fleet inliers > 0 —
    a dry run over iid noise only proves compilation).

    Returns (states [D,...], obs [D,...], frame_ids [D], keys [D],
    gt_poses: list of (R, t) per lane).
    """
    import numpy as np

    from ..ops.camera import backproject, project_pinhole
    from ..ops.se3 import Pose, identity_pose, matrix_to_quat

    N = n_features
    states, obss, gts = [], [], []
    for i in range(n_seq):
        rng = np.random.default_rng(seed + 1000 * i)
        ms = msl.empty_map(kf_capacity=kf_capacity, lm_capacity=lm_capacity,
                           n_features=N)
        # keyframe at identity observing a random 3D cloud in view
        px = jnp.asarray(
            np.stack([rng.uniform(4, 2 * cam.cx - 4, N),
                      rng.uniform(4, 2 * cam.cy - 4, N)], -1), jnp.float32)
        depth = jnp.asarray(rng.uniform(1.0, 4.0, N), jnp.float32)
        desc = jnp.asarray(rng.integers(0, 256, (N, 32)), jnp.uint8)
        valid = jnp.ones((N,), bool)
        ms, slot = msl.insert_keyframe(
            ms, jnp.asarray(0), identity_pose(), px, desc, valid,
            jnp.full((N,), FREE, jnp.int32), depth,
        )
        ms = stages.depth_landmarks(ms, cam, slot, identity_pose())

        # second frame: small known motion; observations = exact
        # projections of the SAME points with the SAME descriptors
        angle = 0.01 * (1 + i % 3)
        ca, sa = np.cos(angle), np.sin(angle)
        R = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]], np.float32)
        t = np.array([0.02 * (i % 4 + 1), -0.01, 0.015], np.float32)
        pose1 = Pose(matrix_to_quat(jnp.asarray(R)), jnp.asarray(t))
        pw = backproject(cam, px, depth)  # world (kf at identity)
        uv, ok, pc = project_pinhole(cam, pose1, pw)
        obss.append(FrameObs(
            px=uv.astype(jnp.float32),
            response=jnp.zeros((N,), jnp.float32),
            desc=desc,
            valid=valid & ok,
            depth=jnp.where(ok, pc[..., 2], 0.0).astype(jnp.float32),
        ))
        states.append(ms)
        gts.append((R, t))

    fids = jnp.ones((n_seq,), jnp.int32)
    keys = jax.random.split(jax.random.PRNGKey(seed), n_seq)
    return (stack_states(states), stack_obs(obss), fids, keys, gts)
