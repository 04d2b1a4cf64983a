"""Real-data readiness harness (VERDICT r4 #6).

Two modes:

1. ``--dataset_dir D --sequence S``: run the native loader + the full
   pipeline on a REAL user-supplied TUM RGB-D directory (fr1/fr2/fr3
   layout: rgb.txt/depth.txt/groundtruth.txt + the freiburgN intrinsics
   selection, data/tum.py) and report ATE/RPE/tracked. This is the
   guarded entry point for when actual TUM data is available — nothing
   here assumes synthetic input.

2. flagless: sensor-degradation matrix on the synthetic renderer — the
   next-best thing to real data in this offline environment. Each row
   runs the ONLINE scan pipeline on the bench sequence degraded with one
   sensor model from data/degrade.py (TUM 5000-scale depth quantization,
   blob depth holes, range-dependent depth noise, per-frame exposure
   jitter, motion blur), plus all combined; prints a markdown table for
   FIDELITY.md and exits nonzero if any row leaves the acceptance band
   (tracked >= 0.9, ATE <= max(3x clean, 20 mm)).

Usage:
    python tools/real_data_check.py [--frames 120] [--pipeline scan]
    python tools/real_data_check.py --dataset_dir ~/tum --sequence \
        rgbd_dataset_freiburg1_desk
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def run_real(args) -> int:
    from visionx_slam_tpu.system.system import System
    from visionx_slam_tpu.utils.config import SystemConfig

    cfg = SystemConfig(
        dataset_dir=args.dataset_dir,
        sequence=args.sequence,
        output_dir=args.output_dir,
        pipeline=args.pipeline,
        max_frames=args.frames if args.frames > 0 else -1,
        loader="native",
    )
    summary = System(cfg).run()
    print(
        f"REAL DATA: tracked {summary['n_tracked']}/{summary['n_frames']}, "
        f"ATE {summary.get('ate_rmse', float('nan')):.4f} m, "
        f"RPE {summary.get('rpe_trans_rmse', float('nan')):.4f} m, "
        f"{summary['n_keyframes']} keyframes, "
        f"{summary['n_landmarks']} landmarks"
    )
    return 0


def run_degradation_matrix(args) -> int:
    from visionx_slam_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from visionx_slam_tpu.data import degrade, synthetic
    from visionx_slam_tpu.ops.camera import make_camera
    from visionx_slam_tpu.tracking.scan_pipeline import run_scan_pipeline
    from visionx_slam_tpu.utils.config import TrackingOptions

    T = args.frames
    _, _, entries, grays, depths, gts = bench._load_sequence(T)
    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    opts = TrackingOptions()

    def measure(g, d):
        _, outs = run_scan_pipeline(cam, jnp.asarray(g), jnp.asarray(d),
                                    opts)
        ate, n = bench._ate_from_outs(outs, gts)
        return (float("nan") if ate is None else ate,
                float(np.asarray(outs.tracked).mean()))

    rows = []
    ate0, trk0 = measure(grays, depths)
    rows.append(("clean", ate0, trk0))
    for name, fn in degrade.DEGRADATIONS.items():
        rng = np.random.default_rng(7)
        g, d = fn(grays, depths, rng)
        rows.append((name, *measure(g, d)))
    rng = np.random.default_rng(7)
    g, d = degrade.degrade_all(grays, depths, rng)
    rows.append(("all_combined", *measure(g, d)))

    band_ate = max(3.0 * ate0, 0.020)
    print("\n| degradation | ATE (m) | tracked | in band |")
    print("|---|---|---|---|")
    ok_all = True
    for name, ate, trk in rows:
        ok = (trk >= 0.90) and (ate <= band_ate or name == "clean")
        ok_all &= ok
        print(f"| {name} | {ate:.4f} | {trk:.3f} | "
              f"{'yes' if ok else 'NO'} |")
    print(f"\nband: tracked >= 0.90, ATE <= {band_ate:.4f} m "
          f"(max(3x clean, 20 mm))")
    return 0 if ok_all else 1


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset_dir", default="")
    p.add_argument("--sequence", default="rgbd_dataset_freiburg1_desk")
    p.add_argument("--output_dir", default="/tmp/vxs_real_out")
    p.add_argument("--pipeline", default="scan",
                   choices=["scan", "offline", "host"])
    p.add_argument("--frames", type=int, default=120)
    args = p.parse_args()
    if args.dataset_dir:
        return run_real(args)
    return run_degradation_matrix(args)


if __name__ == "__main__":
    sys.exit(main())
