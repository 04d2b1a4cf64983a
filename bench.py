"""Benchmark: frames/sec/chip on a synthetic fr1_desk-class sequence.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
``vs_baseline`` is value / 500 — the BASELINE.json north-star target
(>= 500 frames/sec/chip on TUM fr1_desk; the reference C++ build paces
itself to <= 10 FPS by construction, system.cpp:49). No TUM download
exists in this environment, so the bench renders a TUM-layout synthetic
sequence at fr1 geometry (640x480 RGB-D) and runs the REAL full SLAM
pipeline on it: device ORB -> GEMM matching -> PnP RANSAC -> keyframes /
triangulation -> windowed BA -> trajectory, with ATE reported.

Measurement rules:

- the headline is the DEVICE loop: inputs pre-staged in device memory.
  End-to-end fps of the first run (decode + transfer + compile + compute)
  is reported in detail.
- every timed run VARIES the input on device and fences with a dependent
  scalar readback, so no run can be served from a result cache and none
  ends before the device does.
- best/median/worst of N timed runs are all reported; the headline is the
  MEDIAN.
- every result names the device it ran on (``device``: platform, kind,
  count, and nvidia-smi's name and power limit). MFU/roofline shares are
  printed only on a device with published peaks (utils/flops.py), never
  on the CPU.

Flags: --quick (CPU smoke), --frames N, --runs N, --extractor jax|opencv,
--pipeline scan|host, --batch B (multi-sequence throughput mode),
--no-configs (headline only: skip the per-BASELINE-config blocks).

The default (flagless) invocation — what the round driver runs — emits the
headline offline number PLUS a ``detail.configs`` block with one entry per
BASELINE.json evaluation config:

1. stock online run   (scan pipeline — the reference's own loop shape,
                       system.cpp:38-53)
2. monocular          (zero-depth scan: essential init + triangulation)
3. long sequence      (1200 frames through the scan path, culling active)
4. full-map global BA (pair_ba + general global_ba ms/solve on a K=128 map)
5. batched offline    (8 x 120-frame sequences vmapped on one chip)

Each config is fault-isolated: an exception in one records an "error"
entry, the others still run, and the process exits non-zero after
printing.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time


def _median_stats(times, n_frames):
    fps = sorted(n_frames / t for t in times)
    return {
        "fps_median": round(statistics.median(fps), 2),
        "fps_best": round(fps[-1], 2),
        "fps_worst": round(fps[0], 2),
        "spread": round(fps[-1] / max(fps[0], 1e-9), 3),
        "n_runs": len(times),
    }


def _load_sequence(n_frames, seed=5):
    from visionx_slam_tpu.data import synthetic, tum

    import numpy as np

    cache_root = os.path.join(
        tempfile.gettempdir(), f"vxs_bench_{n_frames}_{seed}"
    )
    seq = "rgbd_dataset_freiburg3_synthetic"
    if not os.path.isdir(os.path.join(cache_root, seq)):
        synthetic.generate_sequence(
            cache_root, sequence=seq, n_frames=n_frames, seed=seed
        )
    ds = tum.TumDataset(cache_root, seq)
    ds.load()
    entries = ds.entries[:n_frames]
    grays = np.stack([tum.load_rgb_gray(e.rgb_path) for e in entries])
    depths = np.stack([tum.load_depth_m(e.depth_path) for e in entries])
    gts = np.stack([e.gt_t for e in entries])
    return cache_root, seq, entries, grays, depths, gts


def _ate_from_outs(outs, gts):
    import numpy as np

    from visionx_slam_tpu.eval import trajectory as traj

    tracked = np.asarray(outs.tracked)
    poses = np.asarray(outs.pose)
    if tracked.sum() < 3:
        return None, int(tracked.sum())
    est = np.asarray(
        [traj.tcw_to_twc(poses[i])[:3, 3] for i in range(len(tracked)) if tracked[i]]
    )
    return traj.ate_rmse(est, gts[tracked]), int(tracked.sum())


def _time_device_loop(run_fn, fence_of, gd, dd, n_frames, runs):
    """Median-of-N device-loop timing with varied staged inputs and a
    dependent scalar fence (see module docstring measurement rules)."""
    import jax.numpy as jnp

    outs = run_fn(gd, dd)                       # warmup / compile
    _ = float(fence_of(outs))
    times = []
    for i in range(runs):
        g_i = gd.at[(0,) * (gd.ndim - 2) + (0, 0)].set(jnp.uint8(i + 1))
        g_i.block_until_ready()
        t0 = time.perf_counter()
        outs = run_fn(g_i, dd)
        _ = float(fence_of(outs))
        times.append(time.perf_counter() - t0)
    return _median_stats(times, n_frames), outs


def _bench_configs(cam, opts, gd, dd, gts, runs):
    """The five BASELINE.json evaluation configs, each fault-isolated.

    All inputs derive ON DEVICE from the already-staged 240-frame sequence
    (one exact trajectory loop, so tiling is continuous motion), so no
    config times a host upload.

    A wall-clock budget (VXS_BENCH_BUDGET_S, default 900 s measured from
    entry) guards the artifact: on a cold compile cache the config blocks
    can take tens of minutes, and a driver-side timeout would sink the
    WHOLE bench line — once the budget is spent, remaining configs record
    a "skipped" entry instead (the headline is already measured)."""
    import jax
    import numpy as np
    import jax.numpy as jnp

    budget_s = float(os.environ.get("VXS_BENCH_BUDGET_S", "900"))
    t_start = time.perf_counter()

    class _BudgetExhausted(Exception):
        pass

    def _check_budget():
        if time.perf_counter() - t_start > budget_s:
            raise _BudgetExhausted(
                f"bench budget {budget_s:.0f}s exhausted before this config"
            )

    def _record_error(key, e):
        configs[key] = ({"skipped": str(e)}
                        if isinstance(e, _BudgetExhausted)
                        else {"error": repr(e)[:200]})

    from visionx_slam_tpu.eval import trajectory as traj
    from visionx_slam_tpu.tracking.scan_pipeline import (
        run_scan_pipeline, run_scan_pipeline_batched,
    )
    from visionx_slam_tpu.tracking.offline_pipeline import (
        run_offline_pipeline_batched,
    )

    T = int(gd.shape[0])
    configs = {}

    def scan_ate(outs, gt, with_scale=False):
        tracked = np.asarray(outs.tracked)
        poses = np.asarray(outs.pose)
        if tracked.sum() < 3:
            return None
        est = np.asarray([traj.tcw_to_twc(poses[i])[:3, 3]
                          for i in range(len(tracked)) if tracked[i]])
        return traj.ate_rmse(est, gt[tracked], with_scale=with_scale)

    # ---- 1. stock online run: the reference's own loop shape ----
    try:
        _check_budget()
        def run1(g, d):
            _, outs = run_scan_pipeline(cam, g, d, opts)
            return outs
        stats, outs = _time_device_loop(
            run1, lambda o: jnp.sum(o.n_inliers), gd, dd, T, runs)
        configs["1_online_scan"] = {
            "fps": stats["fps_median"], "n_frames": T,
            "tracked_frac": float(np.asarray(outs.tracked).mean()),
            "ate_rmse_m": scan_ate(outs, gts),
        }
        # per-frame latency of the STREAMING shape (what a real-time
        # deployment dispatches): the same scan in 8-frame chunks with the
        # state threaded through, per-chunk wall time / chunk size.
        # p50/p99 over chunks — keyframe-event chunks are the tail.
        chunk = 8
        st = None
        lat = []
        for rep in range(2):                 # rep 0 warms the T=8 compile
            st = None
            lat = []
            for s in range(0, T, chunk):
                g_i = jax.lax.dynamic_slice_in_dim(gd, s, chunk)
                d_i = jax.lax.dynamic_slice_in_dim(dd, s, chunk)
                jax.block_until_ready((g_i, d_i))
                t0 = time.perf_counter()
                st, outs_c = run_scan_pipeline(
                    cam, g_i, d_i, opts, st0=st, frame0=s)
                _ = float(jnp.sum(outs_c.n_inliers))
                lat.append((time.perf_counter() - t0) / chunk * 1e3)
        configs["1_online_scan"].update(
            latency_ms_p50=round(float(np.percentile(lat, 50)), 3),
            latency_ms_p99=round(float(np.percentile(lat, 99)), 3),
            latency_chunk=chunk,
        )
        # MFU / roofline accounting: XLA per-stage cost analysis x
        # measured time (utils/flops.py), only on a device with peaks
        from visionx_slam_tpu.utils import flops as fl

        if jax.devices()[0].device_kind in fl.DEVICE_PEAKS:
            H, W = int(gd.shape[1]), int(gd.shape[2])
            events_pf = float(np.asarray(outs.is_keyframe).mean())
            costs = fl.scan_stage_costs(
                cam, opts, (H, W), events_per_frame=events_pf,
                ba_iters_avg=3.0)
            configs["1_online_scan"].update(
                _roofline(fl.summarize(costs, 1.0 / stats["fps_median"])))
    except Exception as e:  # one config's fault must not sink the others
        _record_error("1_online_scan", e)

    # ---- 2. monocular: zero depth -> essential init + triangulation.
    # Every 4th frame: fr1-speed 15 mm steps starve the parallax gate
    # (the reference behaves identically); 4x stride gives real baselines.
    # Runs the mono OPTION SET (config.py extensions): keyframes inherit
    # tracked landmarks and rotation-only init pairs are rejected — the
    # measured difference is 0.199 -> 0.078 m scale-aligned ATE (the
    # reference-faithful oracle reads 0.362 m on the same frames).
    try:
        _check_budget()
        import dataclasses

        g2 = gd[::4]
        d2 = jnp.zeros(g2.shape, jnp.float32)
        T2 = int(g2.shape[0])
        opts2 = dataclasses.replace(
            opts, link_tracked_landmarks=True, min_init_landmarks=25)

        def run2(g, d):
            _, outs = run_scan_pipeline(cam, g, d, opts2)
            return outs
        stats, outs = _time_device_loop(
            run2, lambda o: jnp.sum(o.n_inliers), g2, d2, T2, runs)
        configs["2_monocular"] = {
            "fps": stats["fps_median"], "n_frames": T2,
            "tracked_frac": float(np.asarray(outs.tracked).mean()),
            "ate_rmse_m_scale_aligned": scan_ate(outs, gts[::4],
                                                 with_scale=True),
            "note": "mono scale is unobservable: ATE after similarity "
                    "alignment (reference has no scale correction either)",
        }
    except Exception as e:
        _record_error("2_monocular", e)

    # ---- 2b. monocular on the FAST path: the offline pipeline's
    # essential + scale-chain variant. T=240 strided frames spanning FOUR
    # trajectory loops (VERDICT r3 #7: fixed costs — map build, keyframe
    # chain, GBA — amortize honestly at real sequence length; T=60 was
    # fixed-cost-bound) ----
    try:
        _check_budget()
        from visionx_slam_tpu.tracking.offline_pipeline import (
            default_lane_kf_capacity,
            run_offline_pipeline,
        )

        g2 = jnp.tile(gd, (4, 1, 1))[::4]     # 4 loops, stride 4 -> T=240
        d2 = jnp.zeros(g2.shape, jnp.float32)
        T2 = int(g2.shape[0])
        gt2b = np.tile(gts, (4, 1))[::4]

        def run2b(g, d):
            # consecutive-pair budget: 64 PROSAC-biased hypotheses + 2 LO
            # starts + 32-wide tier-2 scoring — ATE-neutral vs the 128/4
            # uniform budget on this config (341 vs 344 mm); chosen for
            # speed on the earlier accelerator, not yet measured on the H100
            _, outs = run_offline_pipeline(
                cam, g, d, opts, monocular=True,
                kf_capacity=default_lane_kf_capacity(T2),
                mono_pair_hypotheses=64, mono_lo_starts=2,
                mono_sample_bias=64.0, mono_score_top_k=32,
            )
            return outs
        stats, outs = _time_device_loop(
            run2b, lambda o: jnp.sum(o.n_inliers), g2, d2, T2, runs)
        configs["2b_monocular_offline"] = {
            "fps": stats["fps_median"], "n_frames": T2,
            "tracked_frac": float(np.asarray(outs.tracked).mean()),
            "ate_rmse_m_scale_aligned": scan_ate(outs, gt2b,
                                                 with_scale=True),
            "note": "fast-path mono (essential + scale chain), 4x-stride "
                    "over four trajectory loops",
        }
    except Exception as e:
        _record_error("2b_monocular_offline", e)

    # ---- 3. long sequence: 5 continuous loops = 1200 frames through the
    # online scan (keyframe ring eviction + landmark culling/compaction
    # active throughout) ----
    try:
        _check_budget()
        reps = 5
        g3 = jnp.tile(gd, (reps, 1, 1))
        d3 = jnp.tile(dd, (reps, 1, 1))
        T3 = T * reps
        gt3 = np.tile(gts, (reps, 1))

        def run3(g, d):
            _, outs = run_scan_pipeline(cam, g, d, opts)
            return outs
        stats, outs = _time_device_loop(
            run3, lambda o: jnp.sum(o.n_inliers), g3, d3, T3,
            max(2, runs - 1))
        configs["3_long_sequence"] = {
            "fps": stats["fps_median"], "n_frames": T3,
            "tracked_frac": float(np.asarray(outs.tracked).mean()),
            "ate_rmse_m": scan_ate(outs, gt3),
            "n_keyframes": int(np.asarray(outs.n_keyframes)[-1]),
            "n_landmarks": int(np.asarray(outs.n_landmarks)[-1]),
        }
    except Exception as e:
        _record_error("3_long_sequence", e)

    # ---- 4. full-map global BA: ms/solve of both solvers on the offline-
    # built K=128 map (pair_ba = structured pairwise Schur; global_ba =
    # general sorted-scatter PCG Schur) ----
    try:
        _check_budget()
        import jax

        from visionx_slam_tpu.models.global_ba import (
            GlobalBAOptions, global_ba,
        )
        from visionx_slam_tpu.models.pair_ba import pair_ba
        from visionx_slam_tpu.tracking import mapstate as msl
        from visionx_slam_tpu.tracking.offline_pipeline import (
            build_offline_pipeline,
        )

        run = build_offline_pipeline(None, opts)
        pre = jax.jit(lambda g, d: run.pre(cam, g, d))
        ms, links, _aux = pre(gd, dd)
        jax.block_until_ready(ms.kf_t)
        gba_opts = GlobalBAOptions(max_iterations=2, cg_iterations=12)
        entry = {}
        for name, fn in (
            ("pair_ba", jax.jit(lambda m: pair_ba(m, cam, links,
                                                  gba_opts))),
            ("global_ba", jax.jit(lambda m: global_ba(m, cam, gba_opts))),
        ):
            out0, _ = fn(ms)                    # compile
            jax.block_until_ready(out0.kf_t)
            ts = []
            for i in range(runs):
                m_i = ms._replace(kf_t=ms.kf_t + jnp.float32(i) * 1e-7)
                jax.block_until_ready(m_i.kf_t)
                t0 = time.perf_counter()
                out, stats_ba = fn(m_i)
                _ = float(jnp.sum(out.kf_t))
                ts.append(time.perf_counter() - t0)
            entry[name + "_ms_per_solve"] = round(
                statistics.median(ts) * 1e3, 2)
        entry.update(
            n_keyframes=int(msl.n_keyframes(ms)),
            n_landmarks=int(msl.n_landmarks(ms)),
            gn_iterations=2, cg_iterations=12,
        )
        configs["4_fullmap_gba"] = entry
    except Exception as e:
        _record_error("4_fullmap_gba", e)

    # ---- 5. batched offline mapping: 8 staggered 120-frame windows of
    # the loop, vmapped on one chip; aggregate fps is the metric ----
    try:
        _check_budget()
        import jax

        B, Tw = 8, 120
        starts = [(k * T) // B for k in range(B)]
        g2x = jnp.tile(gd, (2, 1, 1))           # windows may wrap the loop
        d2x = jnp.tile(dd, (2, 1, 1))
        g5 = jnp.stack([jax.lax.dynamic_slice_in_dim(g2x, s, Tw)
                        for s in starts])
        d5 = jnp.stack([jax.lax.dynamic_slice_in_dim(d2x, s, Tw)
                        for s in starts])

        def run5(g, d):
            _, outs = run_offline_pipeline_batched(cam, g, d, opts)
            return outs
        stats, outs = _time_device_loop(
            run5, lambda o: jnp.sum(o.n_inliers), g5, d5, B * Tw, runs)
        tracked = np.asarray(outs.tracked)
        poses = np.asarray(outs.pose)
        gt2 = np.tile(gts, (2, 1))
        ates = []
        for b in range(B):
            sel = tracked[b]
            if sel.sum() >= 3:
                est = np.asarray([traj.tcw_to_twc(poses[b, t])[:3, 3]
                                  for t in range(Tw) if sel[t]])
                ates.append(traj.ate_rmse(
                    est, gt2[starts[b]:starts[b] + Tw][sel]))
        configs["5_batched_offline"] = {
            "aggregate_fps": stats["fps_median"], "batch": B,
            "frames_per_seq": Tw,
            "per_stream_fps": round(stats["fps_median"] / B, 2),
            "tracked_frac": float(tracked.mean()),
            "ate_rmse_m_mean": float(np.mean(ates)) if ates else None,
        }
    except Exception as e:
        _record_error("5_batched_offline", e)

    return configs


def main(argv=None) -> int:
    p = argparse.ArgumentParser("bench")
    p.add_argument("--quick", action="store_true", help="tiny CPU smoke run")
    p.add_argument("--frames", type=int, default=0)
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--extractor", default="jax", choices=["jax", "opencv"])
    p.add_argument("--pipeline", default="offline",
                   choices=["offline", "scan", "host"])
    p.add_argument("--batch", type=int, default=0,
                   help="batched throughput mode: B sequences in parallel on one chip")
    p.add_argument("--no-configs", action="store_true",
                   help="headline only; skip the per-BASELINE-config blocks")
    args = p.parse_args(argv)

    from visionx_slam_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    if args.batch:
        return bench_batched(args)
    if args.pipeline == "host" or args.extractor == "opencv":
        return bench_host(args)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from visionx_slam_tpu.ops.camera import make_camera
    from visionx_slam_tpu.data import synthetic
    from visionx_slam_tpu.utils.device import device_info
    from visionx_slam_tpu.tracking.offline_pipeline import run_offline_pipeline
    from visionx_slam_tpu.tracking.scan_pipeline import run_scan_pipeline
    from visionx_slam_tpu.utils.config import TrackingOptions

    n_frames = args.frames or (20 if args.quick else 240)
    runs = max(2, args.runs if not args.quick else 2)

    _, _, entries, grays, depths, gts = _load_sequence(n_frames)
    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)
    opts = TrackingOptions()

    if args.pipeline == "offline":
        def run_fn(g, d):
            ms, outs = run_offline_pipeline(cam, g, d, opts)
            return ms, outs
    else:
        def run_fn(g, d):
            st, outs = run_scan_pipeline(cam, g, d, opts)
            return st.ms, outs

    def measure_headline():
        # ---- end-to-end once (decode + transfer + compute) + warmup ----
        t0 = time.perf_counter()
        _, outs = run_fn(grays, depths)
        _ = float(jnp.sum(outs.n_inliers))
        e2e_first = time.perf_counter() - t0  # includes compile, cold cache

        # ---- device-loop timing: inputs staged on device, varied per run ----
        gd = jax.device_put(jnp.asarray(grays))
        dd = jax.device_put(jnp.asarray(depths))
        times = []
        outs = None
        for i in range(runs):
            g_i = gd.at[0, 0, 0].set(jnp.uint8(i + 1))  # bust the run cache
            g_i.block_until_ready()
            t0 = time.perf_counter()
            ms, outs = run_fn(g_i, dd)
            fence = float(jnp.sum(outs.n_inliers))  # dependent scalar fence
            times.append(time.perf_counter() - t0)
            del fence
        return e2e_first, gd, dd, ms, outs, _median_stats(times, n_frames)

    e2e_first, gd, dd, ms, outs, stats = measure_headline()
    ate, n_tracked = _ate_from_outs(outs, gts)
    from visionx_slam_tpu.tracking import mapstate as msl

    fps = stats["fps_median"]
    result = {
        "metric": ("frames/sec/chip, full SLAM device loop (640x480 RGB-D, "
                   "synthetic fr1-class)" if jax.devices()[0].platform != "cpu"
                   else "frames/sec on the CPU (smoke run, not a device "
                        "metric)"),
        "value": fps,
        "unit": "frames/sec",
        "vs_baseline": round(fps / 500.0, 4),
        "device": device_info(),
        "detail": {
            "n_frames": n_frames,
            "n_tracked": n_tracked,
            "n_keyframes": int(msl.n_keyframes(ms)),
            "n_landmarks": int(msl.n_landmarks(ms)),
            "ate_rmse_m": ate,
            "extractor": args.extractor,
            "pipeline": args.pipeline,
            **stats,
            "e2e_fps_first_run": round(n_frames / e2e_first, 2),
            "note": "device loop (inputs staged in device memory); the "
                    "first run adds decode, transfer and compile",
        },
    }
    # headline MFU (offline pipeline): per-stage XLA cost analysis x the
    # measured frame time; a LOWER BOUND (loop-body trip counts for the
    # GBA solver are not expanded — utils/flops.py docstring). Only on a
    # device with published peaks: never under a CPU run's numbers.
    from visionx_slam_tpu.utils import flops as fl

    if jax.devices()[0].device_kind in fl.DEVICE_PEAKS:
        H, W = grays.shape[1:]
        costs = (fl.offline_stage_costs(cam, opts, (H, W))
                 if args.pipeline == "offline"
                 else fl.scan_stage_costs(cam, opts, (H, W)))
        result["detail"].update(_roofline(fl.summarize(costs, 1.0 / fps)))
    failed = []
    if not args.quick and not args.no_configs and args.pipeline == "offline":
        configs = _bench_configs(cam, opts, gd, dd, gts,
                                 runs=max(2, min(runs, 3)))
        result["detail"]["configs"] = configs
        failed = [k for k, v in configs.items() if "error" in v]
    print(json.dumps(result))
    if failed:
        print(f"bench: configs failed: {failed}", file=sys.stderr)
        return 1
    return 0


def _roofline(summary: dict) -> dict:
    """``mfu`` + rounded ``roofline`` entries from flops.summarize."""
    return {
        "mfu": round(summary["mfu_vs_bf16_peak"], 5),
        "roofline": {k: (round(v, 4) if isinstance(v, float) else v)
                     for k, v in summary.items()},
    }


def bench_host(args) -> int:
    """Host-pipeline / opencv-extractor variant via the System driver."""
    from visionx_slam_tpu.system.system import System
    from visionx_slam_tpu.utils.config import SystemConfig
    from visionx_slam_tpu.utils.device import device_info

    n_frames = args.frames or (20 if args.quick else 240)
    cache_root, seq, *_ = _load_sequence(n_frames)
    out_dir = os.path.join(tempfile.gettempdir(), "vxs_bench_out")
    cfg = SystemConfig(
        dataset_dir=cache_root, sequence=seq, output_dir=out_dir,
        extractor=args.extractor, pipeline=args.pipeline,
        metrics_jsonl=False, max_frames=n_frames,
    )
    System(cfg).run()  # warmup/compile
    system = System(cfg)
    t0 = time.perf_counter()
    summary = system.run()
    wall = time.perf_counter() - t0
    fps = summary.get("scan_fps", summary["n_frames"] / wall)
    print(json.dumps({
        "metric": "frames/sec/chip end-to-end via System driver",
        "value": round(fps, 2),
        "unit": "frames/sec",
        "vs_baseline": round(fps / 500.0, 4),
        "device": device_info(),
        "detail": {
            "n_frames": summary["n_frames"],
            "n_tracked": summary["n_tracked"],
            "ate_rmse_m": summary.get("ate_rmse"),
            "extractor": args.extractor, "pipeline": args.pipeline,
        },
    }))
    return 0


def bench_batched(args) -> int:
    """Batched throughput mode (BASELINE config 5 on one chip): B synthetic
    sequences mapped in parallel; the metric is aggregate frames/sec/chip,
    measured on the device loop with varied staged inputs. Uses the
    offline pipeline (every stage already frame-parallel, so the sequence
    axis vmaps with no per-lane branch divergence); pass --pipeline scan
    to measure the online scan's vmapped variant instead."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from visionx_slam_tpu.data import synthetic
    from visionx_slam_tpu.eval import trajectory as traj
    from visionx_slam_tpu.ops.camera import make_camera
    from visionx_slam_tpu.tracking.offline_pipeline import (
        run_offline_pipeline_batched,
    )
    from visionx_slam_tpu.tracking.scan_pipeline import run_scan_pipeline_batched
    from visionx_slam_tpu.utils.config import TrackingOptions
    from visionx_slam_tpu.utils.device import device_info

    B = args.batch
    T = args.frames or (20 if args.quick else 120)
    runs = max(2, args.runs if not args.quick else 2)
    grays, depths, gts = [], [], []
    for b in range(B):
        _, _, entries, g, d, gt = _load_sequence(T, seed=100 + b)
        grays.append(g)
        depths.append(d)
        gts.append(gt)
    grays = np.stack(grays)
    depths = np.stack(depths)
    cam = make_camera(synthetic.FX, synthetic.FY, synthetic.CX, synthetic.CY)

    opts = TrackingOptions()
    if args.pipeline == "scan":
        def run_fn(g, d):
            st, outs = run_scan_pipeline_batched(cam, g, d, opts)
            # scan outputs are [T,B,...]; normalize to [B,T,...]
            return jax.tree.map(lambda x: jnp.swapaxes(x, 0, 1), outs)
    else:
        def run_fn(g, d):
            _, outs = run_offline_pipeline_batched(cam, g, d, opts)
            return outs

    outs = run_fn(grays, depths)
    _ = float(jnp.sum(outs.n_inliers))

    gd = jax.device_put(jnp.asarray(grays))
    dd = jax.device_put(jnp.asarray(depths))
    times = []
    for i in range(runs):
        g_i = gd.at[:, 0, 0, 0].set(jnp.uint8(i + 1))
        g_i.block_until_ready()
        t0 = time.perf_counter()
        outs = run_fn(g_i, dd)
        _ = float(jnp.sum(outs.n_inliers))
        times.append(time.perf_counter() - t0)
    stats = _median_stats(times, B * T)

    tracked = np.asarray(outs.tracked)  # [B,T]
    poses = np.asarray(outs.pose)       # [B,T,4,4]
    ates = []
    for b in range(B):
        sel = tracked[b]
        if sel.sum() >= 3:
            est = np.asarray([traj.tcw_to_twc(poses[b, t])[:3, 3]
                              for t in range(T) if sel[t]])
            ates.append(traj.ate_rmse(est, gts[b][sel]))
    fps = stats["fps_median"]
    print(json.dumps({
        "metric": "aggregate frames/sec/chip, batched multi-sequence SLAM (640x480 RGB-D)",
        "value": fps,
        "unit": "frames/sec",
        "vs_baseline": round(fps / 500.0, 4),
        "device": device_info(),
        "detail": {
            "batch": B, "frames_per_seq": T,
            "pipeline": args.pipeline,
            "per_stream_fps": round(fps / B, 2),
            "tracked_frac": float(tracked.mean()),
            "ate_rmse_m_mean": float(np.mean(ates)) if ates else None,
            **stats,
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
