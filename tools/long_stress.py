"""Long-sequence stress (VERDICT r3 item: 2000-frame scan with culling).

Runs N frames (default 2000) of continuous synthetic motion through the
online scan pipeline — keyframe ring eviction, landmark culling and
compaction active throughout — and reports tracking rate, ATE, landmark
allocator state, and fps. Frames are tiled ON DEVICE from one 240-frame
trajectory loop (the loop is exactly periodic, so tiling is continuous
motion), so only 240 frames are uploaded.

Usage: python tools/long_stress.py [--frames 2000] [--resume-split 1200]
With --resume-split, the run is split at that frame via snapshot/resume
(scan_pipeline st0/frame0) and the split trajectory is checked against
the single-run trajectory — checkpoint/resume at scale.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=2000)
    p.add_argument("--resume-split", type=int, default=0)
    args = p.parse_args()

    from visionx_slam_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from visionx_slam_tpu.data import synthetic
    from visionx_slam_tpu.eval import trajectory as traj
    from visionx_slam_tpu.ops.camera import make_camera
    from visionx_slam_tpu.tracking.scan_pipeline import run_scan_pipeline
    from visionx_slam_tpu.utils.config import TrackingOptions

    T0 = 240
    _, _, entries, grays, depths, gts = bench._load_sequence(T0)
    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    opts = TrackingOptions()

    reps = -(-args.frames // T0)
    T = reps * T0
    gd = jnp.tile(jax.device_put(jnp.asarray(grays)), (reps, 1, 1))
    dd = jnp.tile(jax.device_put(jnp.asarray(depths)), (reps, 1, 1))
    gt = np.tile(gts, (reps, 1))

    t0 = time.perf_counter()
    st, outs = run_scan_pipeline(cam, gd, dd, opts)
    jax.block_until_ready(outs.n_inliers)
    wall = time.perf_counter() - t0

    tracked = np.asarray(outs.tracked)
    poses = np.asarray(outs.pose)
    est = np.asarray([traj.tcw_to_twc(poses[i])[:3, 3]
                      for i in range(T) if tracked[i]])
    ate = traj.ate_rmse(est, gt[tracked])
    nl = np.asarray(outs.n_landmarks)
    print(f"frames={T} tracked={tracked.sum()} ({tracked.mean():.1%}) "
          f"ate={ate * 1e3:.1f}mm wall={wall:.1f}s "
          f"({T / wall:.1f} fps incl. compile)")
    print(f"keyframes(final)={int(np.asarray(outs.n_keyframes)[-1])} "
          f"landmarks: final={int(nl[-1])} peak={int(nl.max())} "
          f"capacity={1 << 17}")
    from visionx_slam_tpu.tracking import mapstate as msl
    ms = st.ms
    print(f"map: n_kf={int(msl.n_keyframes(ms))} "
          f"n_lm={int(msl.n_landmarks(ms))} "
          f"lm_dropped={int(ms.lm_dropped)}")
    ok = tracked.mean() >= 0.99 and int(ms.lm_dropped) == 0
    print("STRESS", "PASS" if ok else "FAIL")

    if args.resume_split:
        s = args.resume_split
        st1, o1 = run_scan_pipeline(cam, gd[:s], dd[:s], opts)
        st2, o2 = run_scan_pipeline(cam, gd[s:], dd[s:], opts,
                                    st0=st1, frame0=s)
        p_split = np.concatenate(
            [np.asarray(o1.pose), np.asarray(o2.pose)])
        dp = np.abs(p_split - poses).max()
        print(f"resume split@{s}: max pose delta {dp:.2e} "
              f"({'OK' if dp < 1e-4 else 'MISMATCH'})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
