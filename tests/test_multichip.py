"""Multi-chip correctness on the virtual 8-device CPU mesh (SURVEY.md §4:
the analog of fake-backend multi-node testing).

Round-2 mandate: the dry run must prove CORRECTNESS, not compilation —
each lane gets geometrically consistent observations (so it genuinely
tracks: inliers > 0), and the sharded shard_map execution must produce the
same per-sequence results as the unsharded vmap of the same step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.slow

from visionx_slam_tpu.models.local_ba import BAOptions
from visionx_slam_tpu.ops.camera import make_camera
from visionx_slam_tpu.parallel import batch as pb


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """Fleet at BENCH shapes (VERDICT r4 #5): real rendered 640x480
    frames through the real ORB extractor, N=1024 features, fr-class
    intrinsics — not the round-3 64x48 toy scene."""
    import os
    import tempfile

    from visionx_slam_tpu.data import synthetic

    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX,
                      synthetic.CY)
    D = 8
    root = os.path.join(tempfile.gettempdir(), "vxs_mc_fleet")
    seq = "rgbd_dataset_freiburg3_synthetic"
    if not os.path.isdir(os.path.join(root, seq)):
        synthetic.generate_sequence(root, sequence=seq, n_frames=D + 1,
                                    seed=3)
    mss, obss, fids, keys, gt_rel = pb.make_rendered_fleet(cam, root, D)
    return cam, D, mss, obss, fids, keys, gt_rel


def test_fleet_actually_tracks(fleet):
    cam, D, mss, obss, fids, keys, gt_rel = fleet
    mesh = pb.make_mesh(D)
    step = pb.batched_slam_step(
        mesh, cam, n_hypotheses=16, ba_opts=BAOptions(max_iterations=2)
    )
    mss2, poses, stats = step(mss, obss, fids, keys)
    jax.block_until_ready(poses)
    assert int(stats["total_matches"]) >= D * 200, int(stats["total_matches"])
    assert int(stats["total_inliers"]) >= D * 100, int(stats["total_inliers"])

    # every lane's recovered pose matches its ground-truth motion (real
    # extraction/matching noise: mm/sub-degree tolerance, not exact)
    poses = np.asarray(poses)  # [D,4,4] T_cw of the new frame
    for i, T_gt in enumerate(gt_rel):
        np.testing.assert_allclose(poses[i][:3, :3], T_gt[:3, :3], atol=5e-3)
        np.testing.assert_allclose(poses[i][:3, 3], T_gt[:3, 3], atol=8e-3)


def test_sharded_equals_unsharded(fleet):
    """shard_map over the mesh vs plain vmap on one device: identical
    per-sequence outputs (the psum totals equal the host-side sums)."""
    cam, D, mss, obss, fids, keys, gts = fleet
    mesh = pb.make_mesh(D)
    kw = dict(n_hypotheses=16, ba_opts=BAOptions(max_iterations=2))

    step = pb.batched_slam_step(mesh, cam, **kw)
    mss_s, poses_s, fleet_s = step(mss, obss, fids, keys)

    vstep = jax.jit(jax.vmap(
        lambda ms, obs, fid, key: pb.slam_step(ms, obs, fid, cam, key, **kw)
    ))
    mss_u, poses_u, stats_u = vstep(mss, obss, fids, keys)

    # Not bitwise: XLA fuses/reorders float reductions differently when the
    # batch axis is a shard_map mesh axis vs a plain vmap axis, so results
    # differ at the ~1e-7 level.  Assert tight numerical agreement instead.
    np.testing.assert_allclose(
        np.asarray(poses_s), np.asarray(poses_u), atol=1e-5, rtol=1e-5
    )
    for a, b in zip(jax.tree.leaves(mss_s), jax.tree.leaves(mss_u)):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)
        else:
            np.testing.assert_array_equal(a, b)
    assert int(fleet_s["total_inliers"]) == int(jnp.sum(stats_u["inliers"]))
    assert int(fleet_s["total_matches"]) == int(jnp.sum(stats_u["matches"]))


def test_sharded_offline_equals_unsharded():
    """The batched OFFLINE pipeline sharded over the 8-device mesh must
    match the unsharded single-device composition per lane: lanes are
    independent, shard_map only partitions them, but the two compilations
    reassociate floats differently, which can flip a RANSAC hypothesis
    pick on isolated frames (observed: <1% of pose entries, ~2 cm) — so
    the pinned invariants are tracking decisions, keyframe counts, and
    centimeter-level trajectory agreement, not element equality. Every
    lane must genuinely track (BASELINE config 5 at slice scale, not
    just a compile check)."""
    import os
    import tempfile

    from visionx_slam_tpu.data import synthetic, tum
    from visionx_slam_tpu.parallel.batch import sharded_offline_pipeline
    from visionx_slam_tpu.tracking.offline_pipeline import (
        build_offline_pipeline,
    )
    from visionx_slam_tpu.utils.config import TrackingOptions

    root = os.path.join(tempfile.gettempdir(), "vxs_mc_seq40")
    seq = "rgbd_dataset_freiburg3_synthetic"
    T = 40          # VERDICT r4 #5: >= 40 frames/lane x 8 lanes
    if not os.path.isdir(os.path.join(root, seq)):
        # one COMPLETE trajectory loop: rolled lane starts then contain no
        # motion discontinuity (frame T-1 -> 0 is contiguous)
        synthetic.generate_sequence(root, sequence=seq, n_frames=T, seed=11,
                                    frames_per_loop=T)
    ds = tum.TumDataset(root, seq)
    ds.load()
    grays = np.stack([tum.load_rgb_gray(e.rgb_path) for e in ds.entries])
    depths = np.stack([tum.load_depth_m(e.depth_path) for e in ds.entries])
    gts = np.stack([e.gt_t for e in ds.entries])
    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    D = 8
    # 8 distinct lanes from one rendered sequence (rolled starts)
    g = jnp.asarray(np.stack([np.roll(grays, b, axis=0) for b in range(D)]))
    d = jnp.asarray(np.stack([np.roll(depths, b, axis=0) for b in range(D)]))

    opts = TrackingOptions()
    kw = dict(kf_capacity=16, extract_chunk=4, pair_chunk=8,
              refine_iterations=1)
    mesh = pb.make_mesh(D)
    f = sharded_offline_pipeline(mesh, cam, opts, **kw)
    ms_s, out_s, fleet = f(g, d)
    jax.block_until_ready(out_s.pose)

    assert int(fleet["total_tracked"]) == D * T
    assert int(fleet["total_keyframes"]) >= D * 2

    # per-lane ATE at bench shapes: every lane's trajectory must be
    # centimeter-accurate against its rolled ground truth
    from visionx_slam_tpu.eval import trajectory as traj

    poses_s = np.asarray(out_s.pose)
    tracked_s = np.asarray(out_s.tracked)
    for b in range(D):
        sel = tracked_s[b]
        est = np.asarray([traj.tcw_to_twc(poses_s[b, t])[:3, 3]
                          for t in range(T) if sel[t]])
        gt_b = np.roll(gts, b, axis=0)[sel]
        ate = traj.ate_rmse(est, gt_b)
        assert ate < 0.03, (b, ate)

    run = build_offline_pipeline(None, opts, **kw)
    ms_u, out_u = jax.jit(
        lambda g, d: run.batched_lanes(cam, g, d))(g, d)
    np.testing.assert_array_equal(
        np.asarray(out_s.tracked), np.asarray(out_u.tracked))
    np.testing.assert_array_equal(
        np.asarray(out_s.is_keyframe), np.asarray(out_u.is_keyframe))
    dp = np.abs(np.asarray(out_s.pose) - np.asarray(out_u.pose))
    assert dp.max() < 5e-2, dp.max()   # cm-level: RANSAC pick flips only
