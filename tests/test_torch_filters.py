"""PyTorch port vs the JAX package: the registration lock's preprocessing
(INTER_NEAREST downscale, median, sharpen, CLAHE, the whole chain).

Inputs are integer-valued images made with numpy (smooth shading, blobs and
noise, so CLAHE's clip limit binds), fed to both packages as numpy arrays.
One shape divides CLAHE's 8x8 tile grid and one does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stabilization_tpu.ops import filters as jfil
from video_stabilization_tpu.ops.image import resize_nearest as j_resize_nearest
from video_stabilization_tpu_torch.ops import filters as tfil
from video_stabilization_tpu_torch.ops.image import resize_nearest as t_resize_nearest

SHAPES = [(120, 160), (101, 133)]   # tile-divisible, and not
CLAHE_WITHIN = 1.0      # gray levels: rounding ties of the tile blend
CLAHE_EQUAL = 0.999     # share of pixels exactly equal


def gray_image(shape, seed=0):
    rng = np.random.default_rng(seed)
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 60 + 80 * (xx / w) + 40 * np.sin(yy / 9.0)
    for _ in range(12):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(3, 15)
        img += rng.uniform(-90, 90) * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
    img += rng.normal(0, 6, shape)
    return np.clip(np.round(img), 0, 255).astype(np.float32)


@pytest.mark.parametrize("src,out", [((240, 320, 3), (120, 160)),
                                     ((75, 101, 3), (40, 57)),
                                     ((97, 131), (36, 50))])
def test_resize_nearest(src, out):
    img = np.random.default_rng(1).uniform(0, 255, src).astype(np.float32)
    a = np.asarray(j_resize_nearest(jnp.asarray(img), *out))
    b = t_resize_nearest(torch.from_numpy(img), *out).numpy()
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("shape", SHAPES)
def test_median_blur(shape):
    img = gray_image(shape)
    a = np.asarray(jfil.median_blur(jnp.asarray(img), 5, assume_u8=True))
    b = tfil.median_blur(torch.from_numpy(img), 5).numpy()
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("shape", SHAPES)
def test_sharpen3(shape):
    img = gray_image(shape, seed=2)
    a = np.asarray(jfil.sharpen3(jnp.asarray(img)))
    b = tfil.sharpen3(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(b, a)


def assert_gray_levels_agree(a, b):
    a, b = np.round(a), np.round(b)
    assert np.abs(a - b).max() <= CLAHE_WITHIN
    assert (a == b).mean() >= CLAHE_EQUAL


@pytest.mark.parametrize("shape", SHAPES)
def test_clahe(shape):
    img = gray_image(shape, seed=3)
    a = np.asarray(jax.jit(jfil.clahe)(jnp.asarray(img)))
    b = tfil.clahe(torch.from_numpy(img)).numpy()
    assert_gray_levels_agree(a, b)


@pytest.mark.parametrize("shape", SHAPES)
def test_preprocess_for_registration(shape):
    img = gray_image(shape, seed=4) + 0.3          # rounds on entry
    a = np.asarray(jax.jit(jfil.preprocess_for_registration)(jnp.asarray(img)))
    b = tfil.preprocess_for_registration(torch.from_numpy(img)).numpy()
    assert_gray_levels_agree(a, b)
    assert np.array_equal(b, np.round(b)) and b.min() >= 0 and b.max() <= 255
