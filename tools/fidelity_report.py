"""Generate the FIDELITY.md results table: oracle vs strict-config JAX
pipeline over the round-4 coverage grid (3 seeds x 120 frames RGB-D, the
fr1 distorted-optics row, and the monocular row).

Runs the same comparisons tests/test_fidelity.py pins, but prints the
numbers as a markdown table instead of asserting bands.

Usage: python tools/fidelity_report.py [--out FIDELITY_table.md]
(CPU-friendly; ~30 min on this box — the oracle is cv2-bound, ours is
jit-bound on first compile per shape.)
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

from visionx_slam_tpu.data import synthetic, tum  # noqa: E402
from visionx_slam_tpu.eval import trajectory as traj  # noqa: E402


def gt_mats(entries, tracked):
    from scipy.spatial.transform import Rotation

    mats = []
    for e, tk in zip(entries, tracked):
        if not tk:
            continue
        T = np.eye(4)
        T[:3, :3] = Rotation.from_quat(e.gt_q).as_matrix()
        T[:3, 3] = e.gt_t
        mats.append(T)
    return np.stack(mats)


def oracle_metrics(root, seq, n_frames, mono=False, stride=1):
    import reference_oracle as ro

    ts, tracked, mats = ro.run_sequence(
        root, seq, ro.Options(enable_local_ba=False), max_frames=n_frames,
        mono=mono, frame_stride=stride)
    ds = tum.TumDataset(root, seq)
    ds.load()
    entries = ds.entries[:n_frames][::stride]
    est_T = np.stack([traj.tcw_to_twc(m) for m in mats[tracked]])
    gt_t = np.stack([e.gt_t for e, tk in zip(entries, tracked) if tk])
    ate = traj.ate_rmse(est_T[:, :3, 3], gt_t, with_scale=mono)
    rpe_t, _ = traj.rpe_rmse(est_T, gt_mats(entries, tracked))
    return dict(ate=ate, rpe=rpe_t, tracked=int(tracked.sum()),
                n=len(entries))


def ours_metrics(root, seq, n_frames, out_dir):
    from visionx_slam_tpu.system.system import System
    from visionx_slam_tpu.utils.config import (
        SystemConfig, apply_config_if_default, parse_config_file,
    )

    cfg = SystemConfig()
    overlay = parse_config_file(
        os.path.join(os.path.dirname(__file__), "..", "config",
                     "reference_strict.cfg"))
    apply_config_if_default(cfg, overlay, set())
    cfg.dataset_dir = root
    cfg.sequence = seq
    cfg.output_dir = out_dir
    cfg.max_frames = n_frames
    s = System(cfg).run()
    return dict(ate=s["ate_rmse"], rpe=s["rpe_trans_rmse"],
                tracked=s["n_tracked"])


def ours_mono_metrics(root, seq, n_frames, stride):
    import jax.numpy as jnp

    from visionx_slam_tpu.ops.camera import make_camera
    from visionx_slam_tpu.tracking.offline_pipeline import (
        default_lane_kf_capacity, run_offline_pipeline,
    )
    from visionx_slam_tpu.utils.config import TrackingOptions

    ds = tum.TumDataset(root, seq)
    ds.load()
    entries = ds.entries[:n_frames][::stride]
    grays = np.stack([tum.load_rgb_gray(e.rgb_path) for e in entries])
    cam = make_camera(ds.intrinsics.fx, ds.intrinsics.fy,
                      ds.intrinsics.cx, ds.intrinsics.cy)
    ms, out = run_offline_pipeline(
        cam, grays, np.zeros(grays.shape, np.float32), TrackingOptions(),
        monocular=True, kf_capacity=default_lane_kf_capacity(len(entries)))
    tracked = np.asarray(out.tracked)
    poses = np.asarray(out.pose)
    est_T = np.stack([traj.tcw_to_twc(poses[i])
                      for i in range(len(entries)) if tracked[i]])
    gt_t = np.stack([e.gt_t for e, tk in zip(entries, tracked) if tk])
    ate = traj.ate_rmse(est_T[:, :3, 3], gt_t, with_scale=True)
    rpe_t, _ = traj.rpe_rmse(est_T, gt_mats(entries, tracked))
    return dict(ate=ate, rpe=rpe_t, tracked=int(tracked.sum()))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    from visionx_slam_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    rows = []

    def emit(label, oracle, ours, n):
        d = (ours["ate"] / oracle["ate"] - 1.0) * 100.0
        rows.append(
            f"| {label} | {oracle['tracked']}/{n} | {oracle['ate']:.4f} m "
            f"/ {oracle['rpe']:.4f} m | {ours['tracked']}/{n} | "
            f"{ours['ate']:.4f} m / {ours['rpe']:.4f} m | {d:+.1f}% |"
        )
        print(rows[-1], flush=True)

    print("| Row | Oracle tracked | Oracle ATE / RPE | Ours tracked | "
          "Ours ATE / RPE | ATE delta |")
    print("|---|---|---|---|---|---|")

    for seed in (5, 11, 17):
        root = os.path.join(tempfile.gettempdir(), f"vxs_fid_{seed}_120")
        seq = "rgbd_dataset_freiburg3_synthetic"
        if not os.path.isdir(os.path.join(root, seq)):
            synthetic.generate_sequence(root, sequence=seq, n_frames=120,
                                        seed=seed)
        o = oracle_metrics(root, seq, 120)
        u = ours_metrics(root, seq, 120,
                         os.path.join(root, "strict_out"))
        emit(f"fr3 seed {seed}, 120f", o, u, 120)

    root = os.path.join(tempfile.gettempdir(), "vxs_fid_fr1_60")
    seq = "rgbd_dataset_freiburg1_synthetic"
    if not os.path.isdir(os.path.join(root, seq)):
        synthetic.generate_sequence(root, sequence=seq, n_frames=60,
                                    seed=5, camera="fr1")
    o = oracle_metrics(root, seq, 60)
    u = ours_metrics(root, seq, 60, os.path.join(root, "strict_out"))
    emit("fr1 DISTORTED optics, seed 5, 60f", o, u, 60)

    root = os.path.join(tempfile.gettempdir(), "vxs_fid_mono_240")
    seq = "rgbd_dataset_freiburg3_synthetic"
    if not os.path.isdir(os.path.join(root, seq)):
        synthetic.generate_sequence(root, sequence=seq, n_frames=240,
                                    seed=5)
    o = oracle_metrics(root, seq, 240, mono=True, stride=4)
    u = ours_mono_metrics(root, seq, 240, stride=4)
    emit("MONOCULAR (scale-aligned), seed 5, stride 4 of 240f", o, u, 60)

    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(rows) + "\n")


if __name__ == "__main__":
    main()
