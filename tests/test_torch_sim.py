"""PyTorch port vs the JAX package: the camera simulator and its truth."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stabilization_tpu import sim as jsim
from video_stabilization_tpu_torch import sim as tsim
from torch_threads import one_torch_thread  # noqa: F401


def jax_traj(n=8, key=5):
    """A JAX shake trajectory and the standard-normal noise it was built from."""
    traj = jsim.shake_trajectory(jax.random.key(key), n, jsim.DEFAULT_APP_PARAMS,
                                 pos_amplitude=0.004, roll_amplitude=0.3)
    kp, kr = jax.random.split(jax.random.key(key))
    noise = (np.asarray(jax.random.normal(kp, (n, 3))),
             np.asarray(jax.random.normal(kr, (n,))))
    return traj, noise


def torch_params(jp, i):
    return tsim.CameraParams(*(torch.tensor(np.array(getattr(jp, k)[i])) for k in
                               ("position", "pan", "tilt", "roll", "focal_length")))


def test_shake_trajectory_from_jax_noise():
    traj, (pos, roll) = jax_traj()
    t = tsim.shake_trajectory(pos, roll, tsim.DEFAULT_APP_PARAMS, pos_amplitude=0.004,
                              roll_amplitude=0.3)
    for k in ("position", "pan", "tilt", "roll", "focal_length"):
        np.testing.assert_allclose(getattr(t, k).numpy(), np.asarray(getattr(traj, k)),
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("i", [0, 4, 7])
def test_render_frame(i):
    tex = tsim.make_default_texture(np.random.default_rng(0), 256)
    traj, _ = jax_traj()
    jp = jax.tree.map(lambda x: x[i], traj)
    a = np.asarray(jsim.render_frame(jnp.asarray(tex), jp, 120, 200))
    b = tsim.render_frame(torch.from_numpy(tex), torch_params(traj, i), 120, 200).numpy()
    assert a.shape == b.shape and b.dtype == np.uint8
    # a floor() at a texel edge may flip between the two packages
    assert np.all(a == b, -1).mean() >= 0.999


@pytest.mark.parametrize("i", [0, 3, 6])
def test_inter_frame_homography(i):
    traj, _ = jax_traj()
    a = jsim.inter_frame_homography(jax.tree.map(lambda x: x[i], traj),
                                    jax.tree.map(lambda x: x[i + 1], traj), 360, 640)
    b = tsim.inter_frame_homography(torch_params(traj, i), torch_params(traj, i + 1),
                                    360, 640)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)


def test_plane_to_pixel_and_rotation():
    p = jsim.CameraParams.create(position=(0.2, -0.1, 0.9), pan=3.0, tilt=170.0,
                                 roll=185.0)
    tp = tsim.CameraParams.create(position=(0.2, -0.1, 0.9), pan=3.0, tilt=170.0,
                                  roll=185.0)
    np.testing.assert_allclose(tsim.rotation_matrix(tp.pan, tp.tilt, tp.roll).numpy(),
                               np.asarray(jsim.rotation_matrix(p.pan, p.tilt, p.roll)),
                               atol=1e-6)
    g_j = np.asarray(jsim.plane_to_pixel_homography(p, 360, 640))
    g_t = tsim.plane_to_pixel_homography(tp, 360, 640).numpy()
    np.testing.assert_allclose(g_t, g_j, rtol=1e-5, atol=1e-3)


def test_make_default_texture_is_seeded():
    a = tsim.make_default_texture(np.random.default_rng(3), 128)
    b = tsim.make_default_texture(np.random.default_rng(3), 128)
    assert a.shape == (128, 128, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    assert a.std() > 20          # corner-rich: the mosaic spans most of 0-255
