"""orb_extract's dense passes (FAST-9 + Harris + 3x3 NMS detection, 7-tap
Gaussian blur) against plain numpy references written independently of
the bit-packed / padded-slice formulations in models/orb_jax.py."""

import jax.numpy as jnp
import numpy as np
import pytest

from visionx_slam_tpu.models import orb_jax as OJ

B = 8  # compare away from the image edge (padding conventions differ)


@pytest.fixture(scope="module")
def img():
    rng = np.random.default_rng(3)
    cells = rng.uniform(30, 220, size=(16, 20))
    im = np.kron(cells, np.ones((8, 8)))[:120, :160]
    im = im + rng.uniform(-1, 1, size=im.shape)  # break exact NMS ties
    # integer intensities, like decoded frames: exact in bf16, and every
    # FAST threshold sum stays below 256 (also exact)
    return np.clip(np.round(im), 0, 235).astype(np.float64)


def _shift(a, dy, dx):
    return np.roll(a, (-dy, -dx), axis=(0, 1))


def np_fast9(img, t):
    """Boolean mask: 9 contiguous circle pixels all brighter than img+t or
    all darker than img-t (cyclic over the 16-pixel Bresenham circle)."""
    taps = np.stack([_shift(img, int(dy), int(dx)) for dy, dx in OJ.FAST_CIRCLE])
    out = np.zeros(img.shape, bool)
    for cmp in (taps > img + t, taps < img - t):
        for start in range(16):
            run = np.ones(img.shape, bool)
            for k in range(9):
                run &= cmp[(start + k) % 16]
            out |= run
    return out


def np_harris(img, k=OJ.HARRIS_K):
    p = np.pad(img, 1, mode="edge")
    H, W = img.shape
    s = lambda dy, dx: p[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
    gx = 0.25 * sum(w * (s(dy, 1) - s(dy, -1)) for dy, w in ((-1, 1), (0, 2), (1, 1)))
    gy = 0.25 * sum(w * (s(1, dx) - s(-1, dx)) for dx, w in ((-1, 1), (0, 2), (1, 1)))

    def box7(a):
        q = np.pad(a, 3, mode="edge")
        return sum(q[i:i + H, j:j + W] for i in range(7) for j in range(7))

    sxx, syy, sxy = box7(gx * gx), box7(gy * gy), box7(gx * gy)
    return sxx * syy - sxy * sxy - k * (sxx + syy) ** 2


def np_detect(img, t, allowed):
    corners = np_fast9(img, t)
    harris = np.where(corners, np_harris(img), -np.inf)
    neigh = np.max([_shift(harris, dy, dx) for dy in (-1, 0, 1)
                    for dx in (-1, 0, 1) if (dy, dx) != (0, 0)], axis=0)
    return corners & allowed & (harris >= neigh), np_harris(img)


def test_detect_matches_numpy_reference(img):
    allowed = np.zeros(img.shape, bool)
    allowed[B:-B, B:-B] = True
    score = np.asarray(OJ._detect_score(
        jnp.asarray(img, jnp.bfloat16), jnp.asarray(allowed), 20.0))
    mask_ref, harris_ref = np_detect(img, 20.0, allowed)
    mask = np.isfinite(score)
    assert mask_ref.sum() > 100, mask_ref.sum()
    # the FAST test is integer-exact and Harris is f32 (f64 here), so only
    # an NMS near-tie could flip a pixel
    agree = (mask == mask_ref)[B:-B, B:-B].mean()
    assert agree > 0.999, agree
    both = mask & mask_ref
    # f32 sums of ~100 terms ahead of the det/trace cancellation
    scale = np.abs(harris_ref[both]).max()
    np.testing.assert_allclose(score[both], harris_ref[both],
                               rtol=1e-4, atol=1e-5 * scale)


def test_blur_matches_numpy_separable_conv(img):
    k = OJ._gaussian_kernel1d().astype(np.float64)
    H, W = img.shape
    p = np.pad(img, ((3, 3), (0, 0)), mode="edge")
    rows = sum(k[i] * p[i:i + H] for i in range(7))
    p = np.pad(rows, ((0, 0), (3, 3)), mode="edge")
    ref = sum(k[i] * p[:, i:i + W] for i in range(7))
    out = np.asarray(OJ._sep_conv(jnp.asarray(img, jnp.bfloat16), k),
                     np.float64)
    assert abs(k.sum() - 1.0) < 1e-6 and len(k) == 7
    # bf16 accumulation over 14 taps of values <= 255
    np.testing.assert_allclose(out, ref, rtol=2e-2, atol=2.0)
