"""Device ORB validated statistically against the OpenCV oracle
(SURVEY.md §7.3: corner/descriptor agreement stats, not bitwise equality —
the BRIEF pattern differs by design, see models/orb_jax.py).

Small image + few levels keep single-core-CPU compile times sane; the
semantics are scale-free.
"""

import cv2
import numpy as np
import jax.numpy as jnp
import pytest

from visionx_slam_tpu.models import matching
from visionx_slam_tpu.models.orb_jax import JaxOrbExtractor

H, W = 240, 320
EXT_KW = dict(n_features=300, n_levels=4, n_slots=512)


@pytest.fixture(scope="module")
def test_image(rng=None):
    rng = np.random.default_rng(7)
    # blocky texture (sharp corners) + gradient, like the synthetic scenes
    cells = rng.uniform(40, 220, size=(24, 32))
    img = np.kron(cells, np.ones((10, 10)))[:H, :W]
    img += np.linspace(0, 20, W)[None, :]
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def extractor():
    return JaxOrbExtractor(**EXT_KW)


def test_keypoints_near_opencv_corners(test_image, extractor):
    px, resp, desc, valid = extractor.extract(test_image)
    n = int(valid.sum())
    assert n > 100, f"too few keypoints: {n}"

    orb = cv2.ORB_create(nfeatures=300, nlevels=4)
    cv_kpts = orb.detect(test_image, None)
    cv_xy = np.asarray([k.pt for k in cv_kpts])
    assert len(cv_xy) > 50

    # most of our keypoints lie within a few px of some OpenCV keypoint
    ours = px[valid]
    d = np.linalg.norm(ours[:, None, :] - cv_xy[None, :, :], axis=-1).min(axis=1)
    frac_near = (d < 4.0).mean()
    assert frac_near > 0.5, f"only {frac_near:.2f} of keypoints near cv corners"


def test_descriptors_match_under_translation(test_image, extractor):
    # shift the image; descriptors of the same physical corners must match
    shift = 7
    moved = np.roll(test_image, shift, axis=1)
    px1, _, d1, v1 = extractor.extract(test_image)
    px2, _, d2, v2 = extractor.extract(moved)

    res = matching.knn2_ratio_match(
        jnp.asarray(d1), jnp.asarray(v1), jnp.asarray(d2), jnp.asarray(v2)
    )
    idx = np.asarray(res.idx)
    mvalid = np.asarray(res.valid)
    n_matches = mvalid.sum()
    assert n_matches > 40, f"too few matches: {n_matches}"

    dx = px2[idx[mvalid], 0] - px1[mvalid, 0]
    dy = px2[idx[mvalid], 1] - px1[mvalid, 1]
    good = (np.abs(dx - shift) < 2.0) & (np.abs(dy) < 2.0)
    assert good.mean() > 0.8, f"match displacement consistency {good.mean():.2f}"


def test_descriptors_match_under_rotation(test_image, extractor):
    # steered BRIEF must survive a 15-degree in-plane rotation
    M = cv2.getRotationMatrix2D((W / 2, H / 2), 15.0, 1.0)
    rot = cv2.warpAffine(test_image, M, (W, H))
    px1, _, d1, v1 = extractor.extract(test_image)
    px2, _, d2, v2 = extractor.extract(rot)

    res = matching.knn2_ratio_match(
        jnp.asarray(d1), jnp.asarray(v1), jnp.asarray(d2), jnp.asarray(v2)
    )
    idx = np.asarray(res.idx)
    mvalid = np.asarray(res.valid)
    assert mvalid.sum() > 25, f"too few matches under rotation: {mvalid.sum()}"

    # matched points must obey the known rotation
    ones = np.ones((mvalid.sum(), 1))
    pred = np.hstack([px1[mvalid], ones]) @ M.T
    err = np.linalg.norm(pred - px2[idx[mvalid]], axis=-1)
    assert (err < 3.0).mean() > 0.7, f"rotation consistency {(err < 3.0).mean():.2f}"


def test_fixed_shapes_and_determinism(test_image, extractor):
    px1, r1, d1, v1 = extractor.extract(test_image)
    px2, r2, d2, v2 = extractor.extract(test_image)
    assert px1.shape == (EXT_KW["n_slots"], 2)
    assert d1.shape == (EXT_KW["n_slots"], 32)
    np.testing.assert_array_equal(px1, px2)
    np.testing.assert_array_equal(d1, d2)
