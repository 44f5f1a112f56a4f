"""PyTorch port vs the JAX package: corner response, cell GFTT, dense LK.

Inputs are simulator frames rendered by the JAX package (the shaky footage
of tests/test_engine.py), reduced to working-resolution gray once and fed
to both packages as numpy arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stabilization_tpu.config import GFTTConfig, LKConfig, RansacConfig
from video_stabilization_tpu.motion.ransac import estimate_similarity_ransac as j_ransac
from video_stabilization_tpu.ops.gftt import good_features_to_track as j_gftt
from video_stabilization_tpu.ops.gftt import min_eig_response as j_min_eig
from video_stabilization_tpu.ops.image import bgr_to_gray, resize_bilinear
from video_stabilization_tpu.ops.lk_dense import lk_track_dense as j_lk
from video_stabilization_tpu.ops.pyramid import build_pyramid as j_pyr
from video_stabilization_tpu.sim import (
    DEFAULT_APP_PARAMS, make_default_texture, render_frame, shake_trajectory)
from video_stabilization_tpu_torch import config as tconfig
from video_stabilization_tpu_torch.motion.ransac import estimate_similarity_ransac as t_ransac
from video_stabilization_tpu_torch.ops.gftt import good_features_to_track as t_gftt
from video_stabilization_tpu_torch.ops.gftt import min_eig_response as t_min_eig
from video_stabilization_tpu_torch.ops.lk_dense import lk_track_dense as t_lk
from video_stabilization_tpu_torch.ops.pyramid import build_pyramid as t_pyr
from video_stabilization_tpu_torch.utils import prng
from torch_threads import one_torch_thread  # noqa: F401

FH, FW, WH, WW = 240, 320, 120, 160
_j_lk = jax.jit(j_lk, static_argnames="config")
_j_min_eig = jax.jit(j_min_eig)


@pytest.fixture(scope="module")
def grays():
    """Working-resolution gray of 6 consecutive shaky frames, (6, 120, 160)."""
    tex = make_default_texture(jax.random.key(0), size=256)
    traj = shake_trajectory(jax.random.key(5), 6, DEFAULT_APP_PARAMS,
                            pos_amplitude=0.004, roll_amplitude=0.3)
    frames = jax.vmap(lambda p: render_frame(tex, p, FH, FW))(traj)
    # an owned copy: no later JAX array aliases the buffer it came from
    return np.array(bgr_to_gray(resize_bilinear(frames.astype(jnp.float32), WH, WW)))


def corner_drift(ha, hb, w=WW, h=WH):
    c = np.array([[0, 0, 1], [w, 0, 1], [w, h, 1], [0, h, 1]], float).T
    pa, pb = ha @ c, hb @ c
    return np.abs(pa[:2] / pa[2] - pb[:2] / pb[2]).mean()


@pytest.mark.parametrize("i", [0, 3])
def test_min_eig_response(grays, i):
    """Compiled once, run to completion on its own copy of the frame: the
    worst difference is 0.03 against a tolerance of 3 (values up to 3e5)."""
    a = np.asarray(_j_min_eig(jnp.array(grays[i])).block_until_ready())
    b = t_min_eig(torch.tensor(grays[i])).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * np.abs(a).max())


@pytest.mark.parametrize("i", [0, 2, 5])
def test_cell_gftt_same_corners(grays, i):
    cfg = GFTTConfig(max_features=256)
    a = j_gftt(jnp.asarray(grays[i]), cfg)
    b = t_gftt(torch.tensor(grays[i]), tconfig.GFTTConfig(max_features=256))
    same = (np.all(np.asarray(a.points) == b.points.numpy(), -1)
            & (np.asarray(a.mask) == b.mask.numpy()))
    assert same.mean() >= 0.99
    assert np.asarray(a.mask).sum() == b.mask.numpy().sum()


@pytest.mark.parametrize("pair", [(0, 1), (2, 3), (4, 5)])
def test_lk_track_dense(grays, pair):
    """Dense LK on a rendered pair, held at the level of tracked points,
    status and the fitted similarity (not bitwise maps)."""
    gftt_cfg = GFTTConfig(max_features=256)
    lk_cfg = LKConfig()
    corners = j_gftt(jnp.asarray(grays[pair[0]]), gftt_cfg)
    pts, mask = np.asarray(corners.points), np.asarray(corners.mask)
    ja = _j_lk(j_pyr(jnp.asarray(grays[pair[0]]), 3), j_pyr(jnp.asarray(grays[pair[1]]), 3),
               jnp.asarray(pts), jnp.asarray(mask), config=lk_cfg)
    tb = t_lk(t_pyr(torch.tensor(grays[pair[0]]), 3),
              t_pyr(torch.tensor(grays[pair[1]]), 3),
              torch.tensor(pts), torch.tensor(mask), tconfig.LKConfig())
    js, ts = np.asarray(ja.status), tb.status.numpy()
    assert js.sum() > 50
    assert (js == ts).mean() >= 0.98
    both = js & ts
    assert np.abs(np.asarray(ja.points)[both] - tb.points.numpy()[both]).max() < 0.1

    cfg = RansacConfig(num_hypotheses=128)
    hj = j_ransac(jnp.asarray(pts), ja.points, ja.status, jax.random.key(1), cfg).h
    ht = t_ransac(torch.tensor(pts), tb.points, tb.status, prng.key(1),
                  tconfig.RansacConfig(num_hypotheses=128)).h
    assert corner_drift(np.asarray(hj, float), ht.double().numpy()) < 0.05
