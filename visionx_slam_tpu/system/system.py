"""System driver: dataset -> extractor -> tracker -> trajectory/metrics.

Replaces core/system/system.{h,cpp}: the reference spawns a tracking
thread that imreads RGB+depth and sleeps 100 ms per frame
(system.cpp:38-53); here the loop is a straight host pipeline with NO
pacing sleep (SURVEY.md §2.1 "System" row), and the Pangolin viewer is
replaced by the mandated host-side sinks (SURVEY.md §5.4): a TUM-format
trajectory dump, per-frame JSONL metrics, and a map snapshot (poses +
landmarks npz) for checkpoint/resume.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import asdict

import jax.numpy as jnp
import numpy as np

from ..data import tum
from ..eval import trajectory as traj
from ..models.orb import OpenCVExtractor, sample_depth_at
from ..ops.camera import make_camera
from ..tracking import mapstate as msl
from ..tracking.frontend import Tracker
from ..tracking.stages import FrameObs
from ..utils.config import SystemConfig
from ..utils.logging import JsonlWriter, StageTimer

log = logging.getLogger("vxs.system")


class System:
    """End-to-end runner for one sequence."""

    def __init__(self, cfg: SystemConfig):
        self.cfg = cfg
        self.dataset = tum.TumDataset(cfg.dataset_dir, cfg.sequence)
        if not self.dataset.load():
            raise RuntimeError(
                f"Failed to load dataset: {cfg.dataset_dir}/{cfg.sequence}"
            )
        intr = self.dataset.intrinsics
        self.cam = make_camera(
            intr.fx, intr.fy, intr.cx, intr.cy, intr.k1, intr.k2, intr.p1, intr.p2
        )
        if cfg.extractor == "opencv":
            self.extractor = OpenCVExtractor(n_features=cfg.n_features)
        else:
            from ..models.orb_jax import JaxOrbExtractor

            self.extractor = JaxOrbExtractor(
                n_features=cfg.n_features, resize_f32=cfg.orb_resize_f32)
        self.tracker = Tracker(self.cam, cfg.tracking)
        self.results = []
        self.timer = StageTimer()
        self._prefetcher = None  # live NativePrefetcher (for decode stats)
        self._frame0 = 0         # id offset when resuming from a snapshot
        # archived keyframes harvested at chunk boundaries of the scan path
        # (the 64-slot ring evicts; the archive keeps EVERY keyframe so
        # --run_global_ba can cover the full map, BASELINE config 4)
        self._archive: dict[int, dict] = {}
        if cfg.resume_from and cfg.pipeline != "scan":
            raise ValueError("--resume_from requires --pipeline scan")

    def run(self) -> dict:
        cfg = self.cfg
        os.makedirs(cfg.output_dir, exist_ok=True)
        entries = self.dataset.entries
        if cfg.max_frames > 0:
            entries = entries[: cfg.max_frames]

        if cfg.debug_nans:
            # NaN-checking mode — the functional analog of the sanitizers
            # the reference lacks (SURVEY.md §5.2)
            import jax

            jax.config.update("jax_debug_nans", True)

        if cfg.profile_dir:
            import jax

            with jax.profiler.trace(cfg.profile_dir):
                return self._dispatch(entries)
        return self._dispatch(entries)

    def _dispatch(self, entries) -> dict:
        if self.cfg.pipeline == "scan":
            return self._run_scan(entries)
        if self.cfg.pipeline == "offline":
            return self._run_offline(entries)
        return self._run_host(entries)

    # ------------------------------------------------------------------
    def _run_offline(self, entries) -> dict:
        """Batched offline mapping (tracking/offline_pipeline.py): every
        stage runs as frame-parallel batches; highest throughput. RGB-D
        by default; ``cfg.monocular`` switches to the essential +
        scale-chain variant. See the module docstring for the design."""
        import jax.numpy as jnp

        from ..tracking.frontend import FrameResult
        from ..tracking.offline_pipeline import run_offline_pipeline

        cfg = self.cfg
        with self.timer.stage("decode"):
            frames = list(self._frames(entries))
        grays = np.stack([g for g, _ in frames])
        depths = np.stack([d for _, d in frames])

        t0 = time.perf_counter()
        with self.timer.stage("offline_pipeline"):
            ms, outs = run_offline_pipeline(
                self.cam, grays, depths, cfg.tracking,
                orb_kwargs={"n_features": cfg.n_features,
                            "resize_f32": int(cfg.orb_resize_f32)},
                monocular=cfg.monocular,
            )
            _ = float(jnp.sum(outs.n_inliers))
        t_scan = time.perf_counter() - t0
        self.tracker.ms = ms

        tracked = np.asarray(outs.tracked)
        poses = np.asarray(outs.pose)
        self.results = []
        for i, e in enumerate(entries):
            self.results.append(
                FrameResult(
                    frame_id=i,
                    timestamp=e.timestamp,
                    state="TRACKING_GOOD" if tracked[i] else "LOST",
                    pose_T_cw=poses[i] if tracked[i] else None,
                    n_matches=int(np.asarray(outs.n_matches)[i]),
                    n_inliers=int(np.asarray(outs.n_inliers)[i]),
                    parallax=float(np.asarray(outs.parallax)[i]),
                    is_keyframe=bool(np.asarray(outs.is_keyframe)[i]),
                    n_keyframes=int(outs.n_keyframes),
                    n_landmarks=int(outs.n_landmarks),
                )
            )
        summary = self._write_outputs(entries, t_scan)
        summary["scan_time_s"] = t_scan
        summary["scan_fps"] = len(entries) / max(t_scan, 1e-9)
        summary["stage_timings"] = self.timer.summary()
        with open(os.path.join(cfg.output_dir, "metrics.json"), "w") as f:
            json.dump(summary, f, indent=2)
        return summary

    # ------------------------------------------------------------------
    def _run_host(self, entries) -> dict:
        """Per-frame host state machine (reference-parity path)."""
        cfg = self.cfg
        jsonl_path = os.path.join(cfg.output_dir, "frames.jsonl")
        jsonl = JsonlWriter(jsonl_path) if cfg.metrics_jsonl else None

        t_start = time.perf_counter()
        for fid, (e, (gray, depth)) in enumerate(zip(entries, self._frames(entries))):
            with self.timer.stage("extract"):
                px, resp, desc, valid = self.extractor.extract(gray)
            d = sample_depth_at(px, valid, depth)
            obs = FrameObs(
                px=jnp.asarray(px), response=jnp.asarray(resp),
                desc=jnp.asarray(desc), valid=jnp.asarray(valid),
                depth=jnp.asarray(d),
            )
            with self.timer.stage("track"):
                res = self.tracker.process(fid, e.timestamp, gray, obs)
            self.results.append(res)
            if jsonl:
                rec = asdict(res)
                rec["pose_T_cw"] = None if res.pose_T_cw is None else res.pose_T_cw.tolist()
                jsonl.write(rec)
        wall = time.perf_counter() - t_start
        if jsonl:
            jsonl.close()

        summary = self._write_outputs(entries, wall)
        summary["stage_timings"] = self.timer.summary()
        with open(os.path.join(cfg.output_dir, "metrics.json"), "w") as f:
            json.dump(summary, f, indent=2)
        return summary

    # ------------------------------------------------------------------
    def _run_scan(self, entries) -> dict:
        """Fused on-device lax.scan over the whole sequence (fast path).

        Host work = decode + one upload; the tracker loop never touches the
        host. Frame results are reconstructed from the stacked outputs so
        downstream reporting is identical to the host path.
        """
        import jax

        from ..tracking.frontend import FrameResult, State
        from ..tracking.scan_pipeline import resume_state, run_scan_pipeline

        cfg = self.cfg
        # streaming: decode chunk k+1 (C++ prefetch threads, no GIL) while
        # the device scans chunk k — the pipeline-parallelism analog of the
        # reference's producer thread (SURVEY.md §2.2 row "PP")
        # chunk must not exceed the keyframe ring, or the archive harvest
        # at chunk boundaries could miss a created-then-evicted keyframe
        CHUNK = min(64, cfg.kf_capacity) if cfg.run_global_ba else 64
        st = None
        frame0 = 0
        if cfg.resume_from:
            ms0, meta = self.load_snapshot_full(cfg.resume_from)
            st = resume_state(ms0)
            frame0 = int(meta.get("next_frame_id", 0))
            self._frame0 = frame0
            log.info("Resuming from %s at frame id %d", cfg.resume_from, frame0)
        chunk_outs = []
        buf_g, buf_d = [], []

        def flush(pad_to=None):
            nonlocal st, frame0
            if not buf_g:
                return
            g = np.stack(buf_g)
            d = np.stack(buf_d)
            n_pad = 0
            if pad_to is not None and len(buf_g) < pad_to:
                n_pad = pad_to - len(buf_g)
                g = np.concatenate([g, np.repeat(g[-1:], n_pad, 0)])
                d = np.concatenate([d, np.repeat(d[-1:], n_pad, 0)])
            with self.timer.stage("scan_dispatch"):
                st_new, outs = run_scan_pipeline(
                    self.cam, g, d, cfg.tracking,
                    kf_capacity=cfg.kf_capacity,
                    orb_kwargs={"n_features": cfg.n_features,
                            "resize_f32": int(cfg.orb_resize_f32)},
                    st0=st, frame0=frame0,
                )
            st = st_new
            frame0 += len(buf_g)  # padded duplicates get ids past the end
            chunk_outs.append((outs, len(buf_g)))
            buf_g.clear()
            buf_d.clear()
            if cfg.run_global_ba:
                # chunk <= ring capacity, so a boundary harvest sees every
                # keyframe before eviction (forces a sync; only when the
                # full-map GBA was requested)
                self._harvest_keyframes(st.ms)

        t0 = time.perf_counter()
        for gray, depth in self._frames(entries):
            buf_g.append(gray)
            buf_d.append(depth)
            if len(buf_g) == CHUNK:
                flush()  # async dispatch; decode continues immediately
        flush(pad_to=CHUNK if len(entries) > CHUNK else None)

        # stitch per-chunk outputs (dropping padded tail frames)
        with self.timer.stage("scan_wait"):
            outs = jax.tree.map(
                lambda *xs: jnp.concatenate(xs),
                *[jax.tree.map(lambda x: x[:n], o) for o, n in chunk_outs],
            )
            # fence: a dependent scalar readback waits for the whole scan
            _ = float(jnp.sum(outs.n_inliers))
        t_scan = time.perf_counter() - t0  # decode is overlapped inside this
        # worker-thread decode time (overlapped with the scan; informational)
        t_load = (self._prefetcher.decode_seconds()
                  if self._prefetcher is not None else 0.0)
        self.tracker.ms = st.ms  # adopt the final map (global BA / snapshot)

        tracked = np.asarray(outs.tracked)
        poses = np.asarray(outs.pose)
        states = np.asarray(outs.state)
        state_names = {0: "INIT", 1: "TRACKING_GOOD", 2: "TRACKING_BAD", 3: "LOST"}
        self.results = []
        for i, e in enumerate(entries):
            self.results.append(
                FrameResult(
                    frame_id=self._frame0 + i,
                    timestamp=e.timestamp,
                    state=state_names[int(states[i])],
                    pose_T_cw=poses[i] if tracked[i] else None,
                    n_matches=int(np.asarray(outs.n_matches)[i]),
                    n_inliers=int(np.asarray(outs.n_inliers)[i]),
                    parallax=float(np.asarray(outs.parallax)[i]),
                    is_keyframe=bool(np.asarray(outs.is_keyframe)[i]),
                    n_keyframes=int(np.asarray(outs.n_keyframes)[i]),
                    n_landmarks=int(np.asarray(outs.n_landmarks)[i]),
                )
            )
        if cfg.metrics_jsonl:
            jsonl = JsonlWriter(os.path.join(cfg.output_dir, "frames.jsonl"))
            for r in self.results:
                rec = asdict(r)
                rec["pose_T_cw"] = (None if r.pose_T_cw is None
                                    else np.asarray(r.pose_T_cw).tolist())
                jsonl.write(rec)
            jsonl.close()

        summary = self._write_outputs(entries, t_scan)
        summary["scan_time_s"] = t_scan
        summary["decode_time_s"] = t_load  # overlapped with the scan
        summary["scan_fps"] = len(entries) / max(t_scan, 1e-9)
        summary["stage_timings"] = self.timer.summary()
        with open(os.path.join(cfg.output_dir, "metrics.json"), "w") as f:
            json.dump(summary, f, indent=2)
        return summary

    # ------------------------------------------------------------------
    def _frames(self, entries):
        """Yield (gray, depth_m) per entry — through the native C++ decode +
        prefetch pipeline when available (decode overlaps compute), else the
        Python loader (data/png.py codec)."""
        if self.cfg.loader == "native":
            from ..data import native_loader

            if native_loader.available():
                pf = native_loader.NativePrefetcher(
                    [e.rgb_path for e in entries],
                    [e.depth_path for e in entries],
                    queue_depth=4, n_threads=2,
                )
                self._prefetcher = pf
                try:
                    yield from pf
                finally:
                    pf.close()
                return
            log.warning("native loader unavailable; falling back to python")
        for e in entries:
            yield tum.load_rgb_gray(e.rgb_path), tum.load_depth_m(e.depth_path)

    # ------------------------------------------------------------------
    def _write_outputs(self, entries, wall: float) -> dict:
        cfg = self.cfg
        ts, mats, gt_t = [], [], []
        for e, r in zip(entries, self.results):
            if r.pose_T_cw is None:
                continue
            ts.append(r.timestamp)
            mats.append(traj.tcw_to_twc(r.pose_T_cw))
            gt_t.append(e.gt_t)
        traj_path = os.path.join(cfg.output_dir, "trajectory.txt")
        traj.write_tum_trajectory(traj_path, ts, mats)

        summary = {
            "sequence": cfg.sequence,
            "n_frames": len(self.results),
            "n_tracked": len(mats),
            "n_keyframes": int(msl.n_keyframes(self.tracker.ms)),
            "n_landmarks": int(msl.n_landmarks(self.tracker.ms)),
            "wall_time_s": wall,
            "fps": len(self.results) / max(wall, 1e-9),
            "trajectory": traj_path,
        }
        if len(mats) >= 3:
            est_t = np.asarray([m[:3, 3] for m in mats])
            summary["ate_rmse"] = traj.ate_rmse(est_t, np.asarray(gt_t))
            T_est = np.asarray(mats)
            T_gt = np.stack([_gt_mat(e) for e, r in zip(entries, self.results)
                             if r.pose_T_cw is not None])
            rpe_t, rpe_r = traj.rpe_rmse(T_est, T_gt)
            summary["rpe_trans_rmse"] = rpe_t
            summary["rpe_rot_rmse"] = rpe_r

        if cfg.run_global_ba:
            summary["global_ba"] = self._run_global_ba()

        if cfg.dump_overlays > 0:
            from ..eval.overlay import dump_run_overlays

            paths = dump_run_overlays(
                self, entries, cfg.dump_overlays,
                os.path.join(cfg.output_dir, "overlays"),
            )
            summary["overlays"] = len(paths)

        snap_path = os.path.join(cfg.output_dir, "map_snapshot.npz")
        self.save_snapshot(snap_path)
        if cfg.export_ply:
            from ..eval.export import export_snapshot_ply

            ply_path = os.path.join(cfg.output_dir, "map.ply")
            summary["map_ply_points"] = export_snapshot_ply(snap_path, ply_path)
            summary["map_ply"] = ply_path
        with open(os.path.join(cfg.output_dir, "metrics.json"), "w") as f:
            json.dump(summary, f, indent=2)
        log.info("Summary: %s", summary)
        return summary

    # ------------------------------------------------------------------
    def _harvest_keyframes(self, ms):
        """Copy any not-yet-archived alive keyframes to the host archive.
        Called at chunk boundaries of the scan path (before ring eviction
        can drop them) when the full-map GBA is requested."""
        ids = np.asarray(ms.kf_id)
        for slot in np.nonzero(ids >= 0)[0]:
            fid = int(ids[slot])
            if fid in self._archive:
                continue
            self._archive[fid] = {
                "q": np.asarray(ms.kf_q[slot]),
                "t": np.asarray(ms.kf_t[slot]),
                "px": np.asarray(ms.kf_px[slot]).T,   # [N,2]
                "desc": np.asarray(ms.kf_desc[slot]),
                "fvalid": np.asarray(ms.kf_fvalid[slot]),
                "depth": np.asarray(ms.kf_depth[slot]),
            }

    # ------------------------------------------------------------------
    def _run_global_ba(self) -> dict:
        """Full-map Schur-complement BA (BASELINE config 4); refines the
        map in place and dumps the refined keyframe trajectory. When the
        scan path archived ring-evicted keyframes, the solve covers the
        UNION of every keyframe ever created (the reference keeps all
        keyframes, map.h:30-33 — this matches that reach offline)."""
        import jax.numpy as jnp

        from ..models.global_ba import GlobalBAOptions, global_ba, map_reproj_error
        from ..ops.se3 import se3_matrix
        from ..tracking import mapstate as msl_  # noqa: F401

        ms = self.tracker.ms
        extra = {}
        links = None
        if len(self._archive) > int(msl.n_keyframes(ms)):
            self._harvest_keyframes(ms)  # catch the final chunk
            ms, links = self._archive_union_map()
            extra["archived_keyframes"] = len(self._archive)
        err0, n_obs = map_reproj_error(ms, self.cam)
        gba_opts = GlobalBAOptions(
            max_iterations=self.cfg.global_ba_iterations)
        if links is not None:
            # archive maps come from build_keyframe_map, whose pairwise
            # observation structure enables the fast structured solver
            from ..models.pair_ba import pair_ba

            ms2, stats = pair_ba(ms, self.cam, links, gba_opts)
        else:
            # the online ring map has a general observation graph
            # (re-tracked features point at landmarks across many
            # keyframes) — use the general solver
            ms2, stats = global_ba(ms, self.cam, gba_opts)
        err1, _ = map_reproj_error(ms2, self.cam)
        extra["mean_reproj_before_px"] = float(err0)
        extra["mean_reproj_after_px"] = float(err1)
        self.tracker.ms = ms2

        kf_alive = np.asarray(msl.kf_alive(ms2))
        kf_ids = np.asarray(ms2.kf_id)
        order = np.argsort(np.where(kf_alive, kf_ids, np.iinfo(np.int32).max))
        ts_by_id = {r.frame_id: r.timestamp for r in self.results}
        ts, mats = [], []
        for slot in order:
            if not kf_alive[slot]:
                continue
            fid = int(kf_ids[slot])
            pose = msl.map_pose(ms2, jnp.asarray(slot))
            ts.append(ts_by_id.get(fid, float(fid)))
            mats.append(traj.tcw_to_twc(np.asarray(se3_matrix(pose))))
        path = os.path.join(self.cfg.output_dir, "trajectory_keyframes_gba.txt")
        traj.write_tum_trajectory(path, ts, mats)
        return {
            "iterations": int(stats.iterations),
            "final_cost": float(stats.final_cost),
            "total_obs": int(stats.total_obs),
            "keyframe_trajectory": path,
            **extra,
        }

    # ------------------------------------------------------------------
    def _archive_union_map(self):
        """Rebuild a (MapState, PairLinks) over EVERY archived keyframe
        (ids ascending) via the batched keyframe-map builder shared with
        the offline pipeline: depth landmarks + consecutive-pair
        observation links."""
        import jax.numpy as jnp

        from ..tracking.offline_pipeline import build_keyframe_map

        fids = sorted(self._archive)
        K = max(8, 1 << (len(fids) - 1).bit_length())  # pad to pow2 slots
        a = self._archive
        N = a[fids[0]]["px"].shape[0]

        def pad(arrs, fill=0.0, dtype=np.float32):
            out = np.full((K,) + arrs[0].shape, fill, dtype)
            out[: len(arrs)] = np.stack(arrs)
            return out

        kf_q = pad([a[f]["q"] for f in fids])
        kf_q[len(fids):, 0] = 1.0
        kf_t = pad([a[f]["t"] for f in fids])
        kf_id = np.full((K,), -1, np.int32)
        kf_id[: len(fids)] = fids
        kf_px = pad([a[f]["px"] for f in fids])
        kf_desc = pad([a[f]["desc"] for f in fids], 0, np.uint8)
        kf_fvalid = pad([a[f]["fvalid"] for f in fids], False, bool)
        kf_depth = pad([a[f]["depth"] for f in fids])

        lm_capacity = 1 << max(17, (K * N - 1).bit_length())
        return build_keyframe_map(
            self.cam, self.cfg.tracking,
            jnp.asarray(kf_q), jnp.asarray(kf_t), jnp.asarray(kf_id),
            jnp.asarray(kf_px), jnp.asarray(kf_desc),
            jnp.asarray(kf_fvalid), jnp.asarray(kf_depth), lm_capacity,
        )

    # ------------------------------------------------------------------
    def save_snapshot(self, path: str):
        """Map-state checkpoint (SURVEY.md §5.4: the reference has none; the
        map is a pytree so the snapshot is a flat npz). ``_meta_*`` keys
        carry resume metadata (next frame id) alongside the MapState."""
        ms = self.tracker.ms
        np.savez_compressed(
            path,
            _meta_next_frame_id=np.asarray(
                self._frame0 + len(self.results), np.int64),
            **{k: np.asarray(v) for k, v in ms._asdict().items()},
        )

    @staticmethod
    def load_snapshot(path: str):
        ms, _ = System.load_snapshot_full(path)
        return ms

    @staticmethod
    def load_snapshot_full(path: str):
        """Returns (MapState, meta dict) from a snapshot npz."""
        from ..tracking.mapstate import MapState

        z = np.load(path)
        meta = {
            k[len("_meta_"):]: z[k].item()
            for k in z.files if k.startswith("_meta_")
        }
        ms = MapState(
            **{k: jnp.asarray(z[k]) for k in z.files
               if not k.startswith("_meta_")}
        )
        return ms, meta


def _gt_mat(e) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    T = np.eye(4)
    T[:3, :3] = Rotation.from_quat(e.gt_q).as_matrix()
    T[:3, 3] = e.gt_t
    return T
