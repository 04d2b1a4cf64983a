"""Native (C++) decode/prefetch runtime vs the Python PNG codec loader."""

import numpy as np
import pytest

from visionx_slam_tpu.data import native_loader, synthetic, tum


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nat"))
    synthetic.generate_sequence(root, n_frames=6, seed=21)
    ds = tum.TumDataset(root, "rgbd_dataset_freiburg3_synthetic")
    assert ds.load()
    return ds


needs_native = pytest.mark.skipif(
    not native_loader.available(), reason="native library unavailable"
)


@needs_native
def test_native_gray_matches_cv2(seq):
    for e in seq.entries[:3]:
        ours = native_loader.decode_gray(e.rgb_path)
        oracle = tum.load_rgb_gray(e.rgb_path)
        assert ours.shape == oracle.shape
        # identical up to +-1 LSB (integer gray conversion rounding)
        assert np.abs(ours.astype(int) - oracle.astype(int)).max() <= 1


@needs_native
def test_native_depth_matches_cv2(seq):
    for e in seq.entries[:3]:
        ours = native_loader.decode_depth(e.depth_path)
        oracle = tum.load_depth_m(e.depth_path)
        np.testing.assert_allclose(ours, oracle, atol=1e-6)


@needs_native
def test_prefetcher_in_order_and_complete(seq):
    rgb = [e.rgb_path for e in seq.entries]
    dep = [e.depth_path for e in seq.entries]
    pf = native_loader.NativePrefetcher(rgb, dep, queue_depth=3, n_threads=2)
    frames = list(pf)
    pf.close()
    assert len(frames) == len(seq.entries)
    for (g, d), e in zip(frames, seq.entries):
        og = tum.load_rgb_gray(e.rgb_path)
        assert np.abs(g.astype(int) - og.astype(int)).max() <= 1
        od = tum.load_depth_m(e.depth_path)
        np.testing.assert_allclose(d, od, atol=1e-6)


@needs_native
def test_native_decode_missing_file(seq):
    with pytest.raises(IOError):
        native_loader.decode_gray("/nonexistent/x.png")
