"""Chip smoke: the SLAM pipeline end to end on NVIDIA GPUs, in one process.

    python chip_smoke.py               # one card: phases 1-7 below
    python chip_smoke.py --devices 4   # four cards: the sharded offline path

One card, at the repo's full width (640x480 RGB-D, 1000 ORB features, 8
levels, 1024 slots, 240-frame sequences, default TrackingOptions, a
1 << 17 landmark table):

1. card and environment (nvidia-smi name + power limit, JAX version,
   device kind, compile-cache directory);
2. kernel parity at real widths: ``orb_extract`` and the 1024x1024
   Hamming GEMM on the card against the same functions on the CPU backend
   of this process (and the Hamming matrix against a numpy popcount);
3. the CLI (``cli.main.entrypoint``, called in-process) with
   ``--pipeline offline`` on a rendered 240-frame sequence;
4. the same sequence with ``--pipeline scan``;
5. timing lines for ``run_offline_pipeline`` / ``run_scan_pipeline`` on
   device-staged inputs (printed, not claimed);
6. run-to-run variation of the offline pipeline (float atomics);
7. the last line: {"ok": true, "device": {...}}.

Every phase raises on failure: the process then exits non-zero and prints
no ``ok`` line. Without a GPU the script exits non-zero before any phase.
Everything runs in this one process: a second JAX process on the card
would find most of its memory reserved by the first.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

SEQ = "rgbd_dataset_freiburg3_synthetic"
SEED = 5
N_FRAMES = 240
# accuracy bands of the CPU tests (tests/test_offline_pipeline.py,
# tests/test_scan_pipeline.py); scatter-adds use float atomics on the GPU,
# so poses vary run to run (phase 6 prints by how much) — the bands hold
# with a wide margin over that variation
OFFLINE_ATE_M = 0.02
SCAN_ATE_M = 0.03
SCAN_MIN_TRACKED = 0.95
# cm-level pose agreement between two runs or two compilations: a float
# reassociation can flip one RANSAC pick on an isolated frame
# (tests/test_multichip.py pins the same bound)
POSE_DIFF_MAX = 5e-2
PARITY_MIN = 0.99


class SmokeFailure(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


# ---------------------------------------------------------------- helpers
def render_sequence(root: str, n_frames: int, seed: int = SEED,
                    frames_per_loop: int = 240) -> None:
    from visionx_slam_tpu.data import synthetic

    t0 = time.perf_counter()
    synthetic.generate_sequence(root, sequence=SEQ, n_frames=n_frames,
                                seed=seed, frames_per_loop=frames_per_loop)
    print(f"rendered {n_frames} frames in {time.perf_counter() - t0:.1f} s")


def load_sequence(root: str):
    import numpy as np

    from visionx_slam_tpu.data import tum

    ds = tum.TumDataset(root, SEQ)
    check(ds.load(), f"dataset at {root} does not load")
    grays = np.stack([tum.load_rgb_gray(e.rgb_path) for e in ds.entries])
    depths = np.stack([tum.load_depth_m(e.depth_path) for e in ds.entries])
    gts = np.stack([e.gt_t for e in ds.entries])
    return ds, grays, depths, gts


def lane_ate(poses, tracked, gts) -> float:
    import numpy as np

    from visionx_slam_tpu.eval import trajectory as traj

    est = np.asarray([traj.tcw_to_twc(poses[t])[:3, 3]
                      for t in range(len(tracked)) if tracked[t]])
    return traj.ate_rmse(est, gts[tracked])


def card_label() -> str:
    from visionx_slam_tpu.utils.device import gpu_name_and_power_limit

    return gpu_name_and_power_limit() or "unknown card"


# ------------------------------------------------------------------ phases
def phase_environment(cache_dir: str) -> str:
    import jax

    from visionx_slam_tpu.utils.device import gpu_name_and_power_limit

    phase("1 card and environment")
    smi = gpu_name_and_power_limit()
    check(bool(smi), "nvidia-smi reported no card")
    print(smi)
    d = jax.devices()[0]
    print(f"jax {jax.__version__}, device_kind {d.device_kind!r}, "
          f"{len(jax.devices())} device(s), compile cache {cache_dir}")
    return smi


def orb_parity(gray, cpu) -> tuple[float, float]:
    """(keypoint-set agreement, descriptor-bit agreement on common
    keypoints) of ``orb_extract`` on the default device vs ``cpu``."""
    import jax
    import numpy as np

    from visionx_slam_tpu.models.orb_jax import orb_extract

    def run(x):
        px, _, desc, valid = jax.device_get(orb_extract(x))
        keys = {(round(float(p[0]), 2), round(float(p[1]), 2)): i
                for i, p in enumerate(px) if valid[i]}
        return keys, desc

    kg, dg = run(jax.device_put(gray))
    kc, dc = run(jax.device_put(gray, cpu))
    check(len(kg) > 500 and len(kc) > 500,
          f"too few keypoints: {len(kg)} on the card, {len(kc)} on the CPU")
    common = sorted(set(kg) & set(kc))
    kp_agree = len(common) / max(len(kg), len(kc))
    bits_g = np.unpackbits(dg[[kg[k] for k in common]], axis=1)
    bits_c = np.unpackbits(dc[[kc[k] for k in common]], axis=1)
    return kp_agree, float((bits_g == bits_c).mean())


def hamming_exactness(cpu, n: int = 1024) -> tuple[bool, bool]:
    """(card == numpy popcount, card == CPU backend) for an n x n Hamming
    matrix of seeded random descriptors."""
    import jax
    import numpy as np

    from visionx_slam_tpu.models.matching import hamming_matrix

    rng = np.random.default_rng(SEED)
    a = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    ref = np.unpackbits(a[:, None, :] ^ b[None, :, :], axis=-1).sum(-1)
    ham = jax.jit(hamming_matrix)
    on_card = np.asarray(ham(a, b)).astype(np.int32)
    on_cpu = np.asarray(ham(jax.device_put(a, cpu),
                            jax.device_put(b, cpu))).astype(np.int32)
    return (bool(np.array_equal(on_card, ref)),
            bool(np.array_equal(on_card, on_cpu)))


def phase_parity() -> None:
    import jax

    from visionx_slam_tpu.data import synthetic

    phase("2 kernel parity at real widths (card vs CPU backend)")
    cpu = jax.devices("cpu")[0]
    R, t = synthetic.trajectory_pose(17, N_FRAMES)
    gray, _ = synthetic.render_frame(synthetic.make_scene(SEED), R, t)
    kp, bits = orb_parity(gray, cpu)
    print(f"orb_extract 640x480: keypoint-set agreement {kp:.4f}, "
          f"descriptor-bit agreement on common keypoints {bits:.4f}")
    check(kp >= PARITY_MIN, f"keypoint agreement {kp:.4f} < {PARITY_MIN}")
    check(bits >= PARITY_MIN, f"descriptor agreement {bits:.4f} < {PARITY_MIN}")
    exact_np, exact_cpu = hamming_exactness(cpu)
    print(f"hamming 1024x1024: bit-exact vs numpy popcount {exact_np}, "
          f"vs CPU backend {exact_cpu}")
    check(exact_np and exact_cpu, "Hamming matrix is not bit-exact")


def run_cli(root: str, out: str, pipeline: str) -> dict:
    from visionx_slam_tpu.cli.main import entrypoint

    t0 = time.perf_counter()
    rc = entrypoint([
        "--dataset_dir", root, "--sequence", SEQ, "--output_dir", out,
        "--pipeline", pipeline, "--export_ply", "false",
    ])
    wall = time.perf_counter() - t0
    check(rc == 0, f"CLI --pipeline {pipeline} returned {rc}")
    for name in ("trajectory.txt", "metrics.json"):
        check(os.path.isfile(os.path.join(out, name)),
              f"CLI --pipeline {pipeline} wrote no {name}")
    with open(os.path.join(out, "metrics.json")) as f:
        m = json.load(f)
    print(f"cli {pipeline}: {m['n_tracked']}/{m['n_frames']} tracked, "
          f"ATE {m.get('ate_rmse')} m, {m['n_keyframes']} keyframes, "
          f"{m['n_landmarks']} landmarks, wall {wall:.1f} s "
          f"(decode + compile + run)")
    return m


def phase_cli(root: str, work: str, n_frames: int) -> None:
    phase("3 CLI --pipeline offline")
    m = run_cli(root, os.path.join(work, "out_offline"), "offline")
    check(m["n_frames"] == n_frames and m["n_tracked"] == n_frames,
          f"offline tracked {m['n_tracked']}/{m['n_frames']}")
    check(m.get("ate_rmse", 1e9) < OFFLINE_ATE_M,
          f"offline ATE {m.get('ate_rmse')} >= {OFFLINE_ATE_M}")

    phase("4 CLI --pipeline scan")
    m = run_cli(root, os.path.join(work, "out_scan"), "scan")
    check(m["n_frames"] == n_frames
          and m["n_tracked"] >= SCAN_MIN_TRACKED * n_frames,
          f"scan tracked {m['n_tracked']}/{m['n_frames']}")
    check(m.get("ate_rmse", 1e9) < SCAN_ATE_M,
          f"scan ATE {m.get('ate_rmse')} >= {SCAN_ATE_M}")


def time_pipeline(label: str, run_fn, gd, dd, runs: int = 3) -> None:
    """First-call seconds, median warm frames/s over ``runs`` runs with
    varied inputs and a dependent scalar fence, and peak device memory."""
    import jax
    import jax.numpy as jnp

    T = int(gd.shape[0])
    t0 = time.perf_counter()
    _ = float(jnp.sum(run_fn(gd, dd).n_inliers))
    first = time.perf_counter() - t0
    times = []
    for i in range(runs):
        g_i = gd.at[0, 0, 0].set(jnp.uint8(i + 1))
        g_i.block_until_ready()
        t0 = time.perf_counter()
        _ = float(jnp.sum(run_fn(g_i, dd).n_inliers))
        times.append(time.perf_counter() - t0)
    warm = statistics.median(times)
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    print(f"[{card_label()}] {label}: T={T}, first call {first:.2f} s "
          f"(compile ~{first - warm:.2f} s; persistent cache may be warm), "
          f"median of {runs} warm runs {T / warm:.2f} frames/s "
          f"({warm * 1e3:.1f} ms/run), peak_bytes_in_use {peak}")


def phase_timing(cam, gd, dd) -> None:
    from visionx_slam_tpu.tracking.offline_pipeline import run_offline_pipeline
    from visionx_slam_tpu.tracking.scan_pipeline import run_scan_pipeline
    from visionx_slam_tpu.utils.config import TrackingOptions

    phase("5 timing on device-staged inputs (printed, not claimed)")
    opts = TrackingOptions()
    time_pipeline("run_offline_pipeline",
                  lambda g, d: run_offline_pipeline(cam, g, d, opts)[1],
                  gd, dd)
    time_pipeline("run_scan_pipeline",
                  lambda g, d: run_scan_pipeline(cam, g, d, opts)[1],
                  gd, dd)


def phase_variation(cam, gd, dd) -> None:
    import numpy as np

    from visionx_slam_tpu.tracking.offline_pipeline import run_offline_pipeline
    from visionx_slam_tpu.utils.config import TrackingOptions

    phase("6 run-to-run variation (offline pipeline, same input twice)")
    opts = TrackingOptions()
    a = run_offline_pipeline(cam, gd, dd, opts)[1]
    b = run_offline_pipeline(cam, gd, dd, opts)[1]
    dp = float(np.abs(np.asarray(a.pose) - np.asarray(b.pose)).max())
    same_tracked = bool(np.array_equal(np.asarray(a.tracked),
                                       np.asarray(b.tracked)))
    print(f"largest pose-entry difference between two runs: {dp:.3e} "
          f"(tracked flags equal: {same_tracked}); the ATE bands "
          f"{OFFLINE_ATE_M} m / {SCAN_ATE_M} m of phases 3-4 hold with "
          f"margin over this float-atomics variation")
    check(np.isfinite(dp) and dp < POSE_DIFF_MAX,
          f"run-to-run pose difference {dp} >= {POSE_DIFF_MAX}")


def single_card(cache_dir: str) -> None:
    import jax

    from visionx_slam_tpu.data import synthetic
    from visionx_slam_tpu.ops.camera import make_camera

    phase_environment(cache_dir)
    phase_parity()
    with tempfile.TemporaryDirectory(prefix="vxs_smoke_") as work:
        root = os.path.join(work, "data")
        render_sequence(root, N_FRAMES)
        phase_cli(root, work, N_FRAMES)
        _, grays, depths, _ = load_sequence(root)
    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    gd = jax.device_put(grays)
    dd = jax.device_put(depths)
    phase_timing(cam, gd, dd)
    phase_variation(cam, gd, dd)


def sharded_offline(n_devices: int, lane_frames: int = 120) -> None:
    """``sharded_offline_pipeline`` over a 1-D ``seq`` mesh of
    ``n_devices`` cards, one lane per card, against ``run.batched_lanes``
    on one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from visionx_slam_tpu.data import synthetic
    from visionx_slam_tpu.ops.camera import make_camera
    from visionx_slam_tpu.parallel import batch as pb
    from visionx_slam_tpu.tracking.offline_pipeline import (
        build_offline_pipeline, default_lane_kf_capacity,
    )
    from visionx_slam_tpu.utils.config import TrackingOptions

    phase(f"sharded offline pipeline: {n_devices} lanes x {lane_frames} "
          f"frames over a {n_devices}-card seq mesh vs one card")
    check(len(jax.devices()) >= n_devices,
          f"need {n_devices} cards, JAX sees {len(jax.devices())}")
    with tempfile.TemporaryDirectory(prefix="vxs_smoke_") as work:
        root = os.path.join(work, "data")
        # one complete trajectory loop: rolled lane starts stay continuous
        render_sequence(root, lane_frames, seed=11,
                        frames_per_loop=lane_frames)
        _, grays, depths, gts = load_sequence(root)
    shift = lane_frames // n_devices
    g = np.stack([np.roll(grays, b * shift, axis=0) for b in range(n_devices)])
    d = np.stack([np.roll(depths, b * shift, axis=0)
                  for b in range(n_devices)])
    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    opts = TrackingOptions()
    kw = dict(kf_capacity=default_lane_kf_capacity(lane_frames))

    mesh = pb.make_mesh(n_devices)
    f = pb.sharded_offline_pipeline(mesh, cam, opts, **kw)
    t0 = time.perf_counter()
    _, out_s, fleet = f(jnp.asarray(g), jnp.asarray(d))
    tracked_s = np.asarray(out_s.tracked)
    print(f"sharded: first call {time.perf_counter() - t0:.1f} s, "
          f"fleet tracked {int(fleet['total_tracked'])}/"
          f"{n_devices * lane_frames}, keyframes "
          f"{int(fleet['total_keyframes'])}, landmarks "
          f"{int(fleet['total_landmarks'])}")

    run = build_offline_pipeline(None, opts, **kw)
    one = jax.devices()[0]
    t0 = time.perf_counter()
    _, out_u = jax.jit(lambda g, d: run.batched_lanes(cam, g, d))(
        jax.device_put(g, one), jax.device_put(d, one))
    tracked_u = np.asarray(out_u.tracked)
    print(f"one card (run.batched_lanes): first call "
          f"{time.perf_counter() - t0:.1f} s")

    poses_s = np.asarray(out_s.pose)
    ates = [lane_ate(poses_s[b], tracked_s[b],
                     np.roll(gts, b * shift, axis=0))
            for b in range(n_devices)]
    dp = float(np.abs(poses_s - np.asarray(out_u.pose)).max())
    same_tracked = bool(np.array_equal(tracked_s, tracked_u))
    same_kf = bool(np.array_equal(np.asarray(out_s.is_keyframe),
                                  np.asarray(out_u.is_keyframe)))
    print(f"per-lane tracked {tracked_s.sum(axis=1).tolist()}, per-lane ATE "
          f"m {[round(a, 5) for a in ates]}, tracked equal {same_tracked}, "
          f"is_keyframe equal {same_kf}, largest pose difference {dp:.3e}")
    check(int(fleet["total_tracked"]) == int(tracked_s.sum()),
          "fleet psum disagrees with the per-lane tracked flags")
    check(same_tracked, "tracked differs between sharded and one card")
    check(same_kf, "is_keyframe differs between sharded and one card")
    check(all(np.isfinite(a) and a < SCAN_ATE_M for a in ates),
          f"per-lane ATE {ates} not below {SCAN_ATE_M} m")
    check(dp < POSE_DIFF_MAX, f"pose difference {dp} >= {POSE_DIFF_MAX}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", type=int, default=1,
                   help="1: phases 1-7 on one card; N > 1: only the "
                        "sharded offline path on an N-card mesh")
    args = p.parse_args(argv)

    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {platform!r}",
              file=sys.stderr)
        return 2

    from visionx_slam_tpu.utils.cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    if args.devices > 1:
        phase_environment(cache_dir)
        sharded_offline(args.devices)
    else:
        single_card(cache_dir)
    d = jax.devices()[0]
    print(card_label())
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
