"""PyTorch port vs the JAX package: image ops, pyramid, gradients, warps.

The same numpy inputs go through both packages on the CPU (the JAX Pallas
warp in interpret mode, the port's warp in its plain version).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stabilization_tpu.ops import gradients as jgrad
from video_stabilization_tpu.ops import image as jimage
from video_stabilization_tpu.ops import pyramid as jpyr
from video_stabilization_tpu.ops.pallas_warp import affine_envelope_ok as j_envelope_ok
from video_stabilization_tpu.ops.pallas_warp import warp_affine as j_warp_affine
from video_stabilization_tpu.ops.warp import warp_perspective as j_warp_perspective
from video_stabilization_tpu_torch.ops import affine_warp as taw
from video_stabilization_tpu_torch.ops import gradients as tgrad
from video_stabilization_tpu_torch.ops import image as timage
from video_stabilization_tpu_torch.ops import pyramid as tpyr
from video_stabilization_tpu_torch.ops.warp import warp_perspective as t_warp_perspective
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-4       # f32 ops on 0-255 content, same op order in both packages
WARP_ATOL = 1e-2  # 2-pass resample, position rounding differs (pad offset)


def content(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)


def smooth_content(h, w, c=None):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.sin(xx / 7) * np.cos(yy / 9) * 80 + 120
    if c:
        img = np.stack([img * (0.6 + 0.2 * k) for k in range(c)], -1)
    return img.astype(np.float32)


def rigid(theta_deg, tx=0.0, ty=0.0, s=1.0):
    t = np.deg2rad(theta_deg)
    m = np.eye(3, dtype=np.float32)
    m[:2, :2] = s * np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]])
    m[0, 2], m[1, 2] = tx, ty
    return m


def close(a_jax, b_torch, atol):
    np.testing.assert_allclose(np.asarray(a_jax), b_torch.numpy(), atol=atol, rtol=0)


@pytest.mark.parametrize("shape,out", [((90, 120, 3), (30, 40)),     # k = 3 strides
                                       ((240, 320, 3), (120, 160)),  # k = 2 pairs
                                       ((100, 130, 3), (70, 97))])   # general lerp
def test_resize_bilinear(shape, out):
    x = content(shape)
    close(jimage.resize_bilinear(jnp.asarray(x), *out),
          timage.resize_bilinear(torch.from_numpy(x), *out), ATOL)


def test_bgr_to_gray():
    x = content((40, 50, 3)).round()
    close(jimage.bgr_to_gray(jnp.asarray(x)), timage.bgr_to_gray(torch.from_numpy(x)), ATOL)


@pytest.mark.parametrize("shape", [(120, 160), (45, 83)])
def test_build_pyramid(shape):
    x = content(shape, 1)
    for a, b in zip(jpyr.build_pyramid(jnp.asarray(x), 3),
                    tpyr.build_pyramid(torch.from_numpy(x), 3)):
        assert a.shape == tuple(b.shape)
        close(a, b, ATOL)


@pytest.mark.parametrize("name", ["sobel_xy", "scharr_xy"])
def test_gradients(name):
    x = content((37, 53), 2)
    for a, b in zip(getattr(jgrad, name)(jnp.asarray(x)),
                    getattr(tgrad, name)(torch.from_numpy(x))):
        close(a, b, ATOL)


@pytest.mark.parametrize("k", [3, 5])
def test_box_sum(k):
    x = content((37, 53), 3)
    close(jgrad.box_sum(jnp.asarray(x), k), tgrad.box_sum(torch.from_numpy(x), k), 1e-3)


@pytest.mark.parametrize("channels", [None, 3])
def test_warp_perspective(channels):
    shape = (60, 90) if channels is None else (60, 90, 3)
    x = content(shape, 4)
    h = np.array([[0.98, 0.05, 3.3], [-0.04, 1.01, -2.2], [1e-4, -2e-4, 1.0]], np.float32)
    border = 17.0 if channels is None else np.array([10.0, 20.0, 30.0], np.float32)
    a = j_warp_perspective(jnp.asarray(x), jnp.asarray(h), None, jnp.asarray(border))
    b = t_warp_perspective(torch.from_numpy(x), torch.from_numpy(h), None,
                           torch.as_tensor(border))
    close(a, b, ATOL)


WARP_CASES = [(0.0, 0.0, 0.0), (0.0, 7.3, -4.2), (0.3, 1.1, -0.4), (1.2, -2.5, 0.7),
              (2.0, 3.3, -2.7), (5.0, -4.0, 2.0), (-5.0, -10.0, 6.0), (-8.0, 0.6, -1.3),
              (8.0, 0.0, 0.0)]


@pytest.mark.parametrize("theta,tx,ty", WARP_CASES)
def test_warp_affine_matches_jax(theta, tx, ty):
    """Plain 2-pass warp vs the JAX Pallas warp (interpret mode), border
    fill on, 0-255 content, rotations up to 8 degrees."""
    x = content((72, 150, 3), 5)
    h = rigid(theta, tx, ty)
    border = np.array([11.0, 127.0, 240.0], np.float32)
    a = j_warp_affine(jnp.asarray(x), jnp.asarray(h), jnp.asarray(border))
    before = taw.gather_fallbacks
    b = taw.warp_affine(torch.from_numpy(x), torch.from_numpy(h), torch.from_numpy(border))
    assert taw.gather_fallbacks == before          # inside the envelope
    close(a, b, WARP_ATOL)


def test_warp_affine_single_plane_matches_jax():
    x = smooth_content(90, 160)
    h = rigid(1.7, -3.2, 2.4)
    close(j_warp_affine(jnp.asarray(x), jnp.asarray(h), 0.0),
          taw.warp_affine(torch.from_numpy(x), torch.from_numpy(h), 0.0), WARP_ATOL)


def test_warp_affine_outside_envelope_takes_gather():
    """A 20 degree rotation leaves the envelope: both packages take the
    projective gather, and agree at the gather's tolerance."""
    x = content((72, 150, 3), 6)
    h = rigid(20.0, 4.0, -3.0)
    border = np.array([5.0, 6.0, 7.0], np.float32)
    assert not bool(taw.affine_envelope_ok(torch.from_numpy(h)))
    before = taw.gather_fallbacks
    b = taw.warp_affine(torch.from_numpy(x), torch.from_numpy(h), torch.from_numpy(border))
    assert taw.gather_fallbacks == before + 1
    a = j_warp_affine(jnp.asarray(x), jnp.asarray(h), jnp.asarray(border))
    close(a, b, 1e-3)


@pytest.mark.parametrize("theta,tx,ty", [(3.0, -2.5, 0.7), (20.0, 4.0, -3.0)])
def test_warp_affine_strided_hwc_matches_jax(theta, tx, ty):
    """An (H, W, C) view of planar (C, H, W) memory, as the warp takes it
    without a copy, inside (3 degrees) and outside (20 degrees) the
    envelope, against the JAX warp of the same values."""
    planar = content((3, 72, 150), 8)
    x = torch.from_numpy(planar).permute(1, 2, 0)
    assert not x.is_contiguous()
    h = rigid(theta, tx, ty)
    border = np.array([3.0, 90.0, 200.0], np.float32)
    inside = bool(taw.affine_envelope_ok(torch.from_numpy(h)))
    assert inside == (theta < 9)
    before = taw.gather_fallbacks
    b = taw.warp_affine(x, torch.from_numpy(h), torch.from_numpy(border))
    assert taw.gather_fallbacks == before + (not inside)
    assert tuple(b.shape) == (72, 150, 3)
    a = j_warp_affine(jnp.asarray(np.ascontiguousarray(planar.transpose(1, 2, 0))),
                      jnp.asarray(h), jnp.asarray(border))
    close(a, b, WARP_ATOL if inside else 1e-3)


# a batch that mixes items inside (0 and 3 degrees) and outside (12 and 20
# degrees) the envelope
BATCH_CASES = [(0.0, 1.5, -2.0), (12.0, 2.0, -1.0), (3.0, -2.6, 1.9), (20.0, 4.0, -3.0)]


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("border", ["number", "shared", "per_item"])
def test_batched_warp_equals_per_item(channels, border):
    """One batched ``warp_affine`` (the plain version on the CPU) equals its
    items' own warps bit for bit, each item's branch decided on its own, with
    a border that is a number, one (C,) for all, or (B, C) per item."""
    b = len(BATCH_CASES)
    x = torch.from_numpy(content((b, 40, 56, channels), 9))
    if channels == 1:
        x = x[..., 0]
    h = torch.from_numpy(np.stack([rigid(*case) for case in BATCH_CASES]))
    per_item = torch.from_numpy(content((b, channels), 10))
    bv = {"number": 17.0, "shared": per_item[0], "per_item": per_item}[border]
    before = taw.gather_fallbacks
    out = taw.warp_affine(x, h, bv)
    assert taw.gather_fallbacks == before + 2
    assert out.shape == x.shape
    for i in range(b):
        one = taw.warp_affine(x[i], h[i], per_item[i] if border == "per_item" else bv)
        assert torch.equal(out[i], one), i


def test_batched_warp_shapes():
    """``h``'s shape tells a batch from one image: a (3, 3) ``h`` takes a
    3-dim ``src`` as (H, W, C), a (B, 3, 3) one as (B, H, W) and refuses a
    leading size other than B or a per-item border of another shape."""
    x = torch.from_numpy(content((3, 10, 12), 11))
    assert taw.warp_affine(x, torch.eye(3)).shape == (3, 10, 12)
    assert torch.equal(taw.warp_affine(x, torch.eye(3).expand(3, 3, 3)), x)
    with pytest.raises(ValueError, match="B = 4"):
        taw.warp_affine(x, torch.eye(3).expand(4, 3, 3))
    with pytest.raises(ValueError, match="per-item border"):
        taw.warp_affine(x[..., None], torch.eye(3).expand(3, 3, 3), torch.zeros(2, 1))


@pytest.mark.parametrize("theta,s", [(0.0, 1.0), (3.0, 1.0), (8.5, 1.0), (9.5, 1.0),
                                     (-12.0, 1.0), (20.0, 1.0), (2.0, 1.2), (0.0, 3.0),
                                     (90.0, 1.0)])
def test_affine_envelope_ok_matches_jax(theta, s):
    h = rigid(theta, 5.0, -2.0, s)
    assert bool(j_envelope_ok(jnp.asarray(h))) == bool(
        taw.affine_envelope_ok(torch.from_numpy(h)))


@pytest.mark.parametrize("axis", [0, 1])
def test_resample_plain_is_bilinear_with_zero_extension(axis):
    """The plain resample against a direct float64 evaluation of its
    definition, including taps that fall outside the source."""
    x = content((2, 9, 11), 7)
    abg = np.array([1.03, 0.07, -1.6], np.float32)
    n_out = 12
    out = taw.resample_plain(torch.from_numpy(x), torch.from_numpy(abg), n_out,
                             axis).numpy()
    src = x if axis == 0 else x.transpose(0, 2, 1)          # (C, n_in, L)
    n_in, n_l = src.shape[1], src.shape[2]
    ref = np.zeros((2, n_out, n_l))
    for r in range(n_out):
        for l in range(n_l):
            p = abg[0] * r + abg[1] * l + abg[2]
            i0 = int(np.floor(p))
            w = p - i0
            for i, wt in ((i0, 1 - w), (i0 + 1, w)):
                if 0 <= i < n_in:
                    ref[:, r, l] += wt * src[:, i, l]
    if axis == 1:
        ref = ref.transpose(0, 2, 1)
    np.testing.assert_allclose(out, ref, atol=1e-3)
