"""The port's motion models, RANSAC refit, shear warp, trail compositor and
panning trajectory (models/motion_models.py, motion/ransac.py,
ops/warp.py::warp_affine_shear, ops/compositing.py,
sim/trajectory.py::smooth_pan_trajectory), and the affine and homography
models through the step and the offline chunk, against the JAX package.

Mirrors tests/test_models_extras.py's TestMotionModels and TestCompositing.
Each JAX reference function is compiled once per module (``jax.jit``): its
CPU code rounds differently from eager JAX.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stabilization_tpu.config import RansacConfig, StabilizationMode
from video_stabilization_tpu.engine import Stabilizer as JStabilizer
from video_stabilization_tpu.engine import init_carry as j_init_carry
from video_stabilization_tpu.engine import make_offline_fn as j_make_offline_fn
from video_stabilization_tpu.models import motion_models as jmm
from video_stabilization_tpu.motion.ransac import estimate_similarity_ransac as j_ransac
from video_stabilization_tpu.motion.similarity import transform_points as j_transform
from video_stabilization_tpu.ops import compositing as jcomp
from video_stabilization_tpu.ops.warp import warp_affine_shear as j_shear
from video_stabilization_tpu.sim import DEFAULT_APP_PARAMS as J_APP_PARAMS
from video_stabilization_tpu.sim.trajectory import smooth_pan_trajectory as j_smooth_pan
from video_stabilization_tpu_torch.config import RansacConfig as TRansacConfig
from video_stabilization_tpu_torch.config import config_from_fields
from video_stabilization_tpu_torch.engine import (
    Stabilizer, init_carry, stabilize_clip_offline)
from video_stabilization_tpu_torch.engine import offline as t_offline
from video_stabilization_tpu_torch.models import (
    MotionModel, fit_affine_masked, fit_homography_dlt, fit_motion)
from video_stabilization_tpu_torch.motion.ransac import estimate_similarity_ransac
from video_stabilization_tpu_torch.ops import compositing as tcomp
from video_stabilization_tpu_torch.ops import lk_dense as t_lk_dense
from video_stabilization_tpu_torch.ops.warp import warp_affine_shear
from video_stabilization_tpu_torch.sim import (
    DEFAULT_APP_PARAMS, make_default_texture, render_frame, shake_trajectory,
    smooth_pan_trajectory)
from video_stabilization_tpu_torch.utils import prng
from test_engine import FH, FW, small_config
from test_torch_offline import assert_frames_close_gather
from test_torch_engine import assert_step_agrees
from torch_threads import one_torch_thread  # noqa: F401

M = StabilizationMode
H_PERSP = np.array([[1.05, 0.02, -8.0], [-0.03, 0.98, 5.0], [1e-4, -5e-5, 1.0]], np.float32)
H_SHEAR = np.array([[1.02, 0.08, 2.0], [0.01, 0.97, -1.0], [0, 0, 1]], np.float32)
FIT_TOL = 2e-3          # |h - JAX's h|, per entry, on noisy correspondences
SHEAR_TOL = 0.05        # |warp - JAX's warp| on 0-255 values (rounding of the lerps)
SHEAR_WITHIN = 0.999    # share of pixels within 1e-2 of JAX's


def corr(rng, h_true, n=100, noise=0.0):
    src = rng.uniform(20, 300, (n, 2)).astype(np.float32)
    dst = np.asarray(j_transform(jnp.asarray(h_true), jnp.asarray(src)))
    dst = (dst + rng.normal(0.0, noise, dst.shape)).astype(np.float32)
    return src, dst


def tt(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


# -- the motion models (TestMotionModels) --------------------------------------

J_FITS = {"affine": jax.jit(jmm.fit_affine_masked), "homography": jax.jit(jmm.fit_homography_dlt)}
T_FITS = {"affine": fit_affine_masked, "homography": fit_homography_dlt}


def test_homography_dlt_exact(rng):
    src, dst = corr(rng, H_PERSP)
    h, ok = fit_homography_dlt(*tt(src, dst, np.ones(100, np.float32)))
    assert bool(ok)
    np.testing.assert_allclose(h.numpy(), H_PERSP, atol=2e-3)


def test_homography_masked_outliers(rng):
    h_true = np.array([[0.99, -0.05, 4.0], [0.05, 1.01, -2.0], [0, 0, 1.0]], np.float32)
    src, dst = corr(rng, h_true, n=80)
    dst[60:] += 50.0
    w = np.ones(80, np.float32)
    w[60:] = 0.0
    h, ok = fit_homography_dlt(*tt(src, dst, w))
    assert bool(ok)
    np.testing.assert_allclose(h.numpy(), h_true, atol=5e-3)


@pytest.mark.parametrize("model", list(MotionModel))
def test_all_models_fit_rigid_motion(rng, model):
    ang = 0.04
    c, s = np.cos(ang), np.sin(ang)
    h_true = np.array([[c, -s, 6.0], [s, c, -3.0], [0, 0, 1]], np.float32)
    src, dst = corr(rng, h_true)
    center = torch.tensor([160.0, 120.0])
    h, ok = fit_motion(model, *tt(src, dst, np.ones(100, np.float32)), center)
    assert bool(ok)
    np.testing.assert_allclose(h.numpy(), h_true, atol=5e-3)


def test_affine_recovers_shear(rng):
    src, dst = corr(rng, H_SHEAR)
    h, ok = fit_motion(MotionModel.AFFINE, *tt(src, dst, np.ones(100, np.float32)),
                       torch.zeros(2))
    assert bool(ok)
    np.testing.assert_allclose(h.numpy(), H_SHEAR, atol=1e-3)


@pytest.mark.parametrize("name", ["affine", "homography"])
@pytest.mark.parametrize("h_true", [H_PERSP, H_SHEAR])
def test_fit_matches_jax(rng, name, h_true):
    """Noisy correspondences with a random mask: each fit within FIT_TOL of
    the compiled JAX fit, the same validity; too few points are invalid
    (identity) in both."""
    src, dst = corr(rng, h_true, noise=0.3)
    w = (rng.uniform(size=100) > 0.2).astype(np.float32)
    for weights in (w, np.where(np.arange(100) < 2, 1.0, 0.0).astype(np.float32)):
        hj, okj = J_FITS[name](jnp.asarray(src), jnp.asarray(dst), jnp.asarray(weights))
        ht, okt = T_FITS[name](*tt(src, dst, weights))
        assert bool(okt) == bool(okj)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=FIT_TOL)


@pytest.mark.parametrize("name", ["affine", "homography"])
def test_fits_over_leading_dims(rng, name):
    """A (2, 3) batch of problems gives what each problem alone gives
    (within f32 rounding: reductions group differently by position)."""
    problems = [corr(rng, h, noise=0.2) for h in (H_PERSP, H_SHEAR) for _ in range(3)]
    src = np.stack([p[0] for p in problems]).reshape(2, 3, 100, 2)
    dst = np.stack([p[1] for p in problems]).reshape(2, 3, 100, 2)
    w = (rng.uniform(size=(2, 3, 100)) > 0.1).astype(np.float32)
    hb, okb = T_FITS[name](*tt(src, dst, w))
    assert hb.shape == (2, 3, 3, 3) and okb.shape == (2, 3)
    for i in range(2):
        for j in range(3):
            h1, ok1 = T_FITS[name](*tt(src[i, j], dst[i, j], w[i, j]))
            assert bool(ok1) == bool(okb[i, j])
            np.testing.assert_allclose(hb[i, j].numpy(), h1.numpy(), atol=1e-4)


@pytest.mark.parametrize("model", ["affine", "homography"])
def test_ransac_refit_matches_jax(rng, model):
    """LO-RANSAC: similarity hypotheses from the same threefry key, the
    configured model refit on their inliers.  Inlier masks equal JAX's bit
    for bit; the model within FIT_TOL."""
    src, dst = corr(rng, H_PERSP if model == "homography" else H_SHEAR, n=200, noise=0.2)
    dst[150:] += rng.uniform(-40, 40, (50, 2)).astype(np.float32)
    mask = np.ones(200, bool)
    mask[:10] = False
    cfg = RansacConfig(num_hypotheses=128)
    center = np.array([160.0, 120.0], np.float32)
    jm = jmm.MotionModel(model)

    @jax.jit
    def jfit(s, d, m, key):
        return j_ransac(s, d, m, key, cfg,
                        refit_fn=lambda a, b, w: jmm.fit_motion(jm, a, b, w, jnp.asarray(center)))

    rj = jfit(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask), jax.random.key(3))
    tm = MotionModel(model)
    tcenter = torch.from_numpy(center)
    rt = estimate_similarity_ransac(
        *tt(src, dst, mask), prng.key(3), TRansacConfig(num_hypotheses=128),
        refit_fn=lambda a, b, w: fit_motion(tm, a, b, w, tcenter))
    assert bool(rt.valid) and bool(rj.valid)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.num_inliers) == int(rj.num_inliers)
    np.testing.assert_allclose(rt.h.numpy(), np.asarray(rj.h), atol=FIT_TOL)


# -- the shear warp and the trail compositor (TestCompositing) ------------------

SHEARS = [(0.0, 10.0, 0.0, 1.0), (0.05, 3.3, -2.7, 1.01), (-0.1, -20.5, 7.25, 0.98)]


@pytest.mark.parametrize("ang,tx,ty,s", SHEARS)
def test_warp_affine_shear_matches_jax(rng, ang, tx, ty, s):
    img = rng.uniform(0, 255, (64, 80, 3)).astype(np.float32)
    c, sn = np.cos(ang), np.sin(ang)
    h = np.array([[s * c, -sn, tx], [sn, c / s, ty], [0, 0, 1]], np.float32)
    border = np.array([1.0, 2.0, 3.0], np.float32)
    want = np.asarray(jax.jit(j_shear)(jnp.asarray(img), jnp.asarray(h), jnp.asarray(border)))
    got = warp_affine_shear(*tt(img, h, border)).numpy()
    d = np.abs(got - want)
    assert d.max() <= SHEAR_TOL, d.max()
    assert (d <= 1e-2).mean() >= SHEAR_WITHIN


def test_warp_affine_shear_identity_and_gray(rng):
    img = rng.uniform(0, 255, (40, 56)).astype(np.float32)
    out = warp_affine_shear(torch.from_numpy(img), torch.eye(3), 7.0)
    np.testing.assert_allclose(out.numpy(), img, atol=1e-4)


def test_translation_shift_identity_rotation():
    t = tcomp.compute_translation_shift(torch.tensor(1.0), torch.tensor(0.0),
                                        torch.tensor([100.0, 50.0]))
    np.testing.assert_allclose(t.numpy(), [0.0, 0.0], atol=1e-6)
    args = (1.1, 0.2, np.array([100.0, 50.0], np.float32))
    want = np.asarray(jcomp.compute_translation_shift(
        jnp.float32(args[0]), jnp.float32(args[1]), jnp.asarray(args[2])))
    got = tcomp.compute_translation_shift(torch.tensor(args[0]), torch.tensor(args[1]),
                                          torch.from_numpy(args[2])).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("h", [np.eye(3, dtype=np.float32),
                               np.array([[1, 0, 20.0], [0, 1, 0], [0, 0, 1]], np.float32),
                               np.array([[0.99, -0.1, 5.0], [0.1, 0.99, -3.0], [0, 0, 1]],
                                        np.float32)])
def test_warped_mask_matches_jax(h):
    got = tcomp.warped_mask(torch.from_numpy(h), 40, 60).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcomp.warped_mask(jnp.asarray(h), 40, 60)))
    if h[0, 2] == 20.0:
        assert not got[20, 5] and got[20, 40]     # the left strip is outside now
    if np.array_equal(h, np.eye(3)):
        assert got[20, 30] and got[0, 0] and got[39, 59]


def test_copy_feathered_composites(rng):
    frame = rng.uniform(100, 200, (64, 80)).astype(np.float32)
    h = np.array([[1, 0, 10.0], [0, 1, 0], [0, 0, 1]], np.float32)
    out = tcomp.copy_feathered(torch.from_numpy(frame), torch.zeros(64, 80),
                               torch.from_numpy(h)).numpy()
    # the warped interior carries frame content; the evacuated strip stays ~bg
    assert out[32, 50] > 50.0
    assert out[32, 2] < 30.0
    out2 = tcomp.copy_feathered(torch.from_numpy(frame), torch.from_numpy(out), torch.eye(3))
    assert torch.isfinite(out2).all()


def test_copy_feathered_matches_jax(rng):
    """Two frames of a colour trail against the compiled JAX compositor."""
    frame = rng.uniform(0, 255, (48, 64, 3)).astype(np.float32)
    bg = rng.uniform(0, 255, (48, 64, 3)).astype(np.float32)
    h = np.array([[0.995, -0.05, 3.5], [0.05, 0.995, -2.25], [0, 0, 1]], np.float32)
    jfn = jax.jit(jcomp.copy_feathered)
    want = jfn(jnp.asarray(frame), jnp.asarray(bg), jnp.asarray(h))
    want = np.asarray(jfn(jnp.asarray(frame), want, jnp.eye(3)))
    got = tcomp.copy_feathered(*tt(frame, bg, h))
    got = tcomp.copy_feathered(torch.from_numpy(frame), got, torch.eye(3)).numpy()
    d = np.abs(got - want)
    assert d.max() <= SHEAR_TOL, d.max()


# -- the panning trajectory -----------------------------------------------------

def test_smooth_pan_trajectory_matches_jax():
    """Given JAX's own noise draws, the port's trajectory is JAX's."""
    n = 12
    key = jax.random.key(4)
    kp, kr = jax.random.split(key)
    pos_noise = np.asarray(jax.random.normal(kp, (n, 3)))
    roll_noise = np.asarray(jax.random.normal(kr, (n,)))
    want = j_smooth_pan(key, n, J_APP_PARAMS, pan_per_frame=0.2)
    got = smooth_pan_trajectory(pos_noise, roll_noise, DEFAULT_APP_PARAMS, pan_per_frame=0.2)
    for name in ("position", "pan", "tilt", "roll", "focal_length"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=1e-6, err_msg=name)
    drift = got.position[:, 0].numpy()
    assert drift[-1] - drift[0] > 0.015        # the intentional pan is there


# -- the affine and homography models through the step and the chunk ----------

@pytest.fixture(scope="module")
def footage():
    """14 shaky frames of the small configuration's size, rendered by the
    port's simulator."""
    rng = np.random.default_rng(11)
    tex = torch.from_numpy(make_default_texture(rng, 256))
    n = 14
    traj = shake_trajectory(rng.standard_normal((n, 3)), rng.standard_normal(n),
                            DEFAULT_APP_PARAMS, pos_amplitude=0.004, roll_amplitude=0.3)
    return np.stack([render_frame(tex, traj[i], FH, FW).numpy() for i in range(n)])


def model_config(model: str, **kw):
    cfg = small_config(**kw)
    return dataclasses.replace(cfg, ransac=dataclasses.replace(cfg.ransac, motion_model=model))


@pytest.mark.parametrize("model", ["affine", "homography"])
def test_step_matches_jax(footage, model):
    """Frame by frame, both packages' Stabilizer (JAX's compiled step) in
    GLOBAL_SMOOTHING: last_h within 0.05 px at the corners, outputs within
    one level on 99% of pixels, equal inlier counts and corner masks; the
    homography model leaves the envelope count alone."""
    cfg = model_config(model)
    js = JStabilizer(cfg)
    ts = Stabilizer(config_from_fields(cfg), device="cpu")
    for i, frame in enumerate(footage):
        jout = js.stabilize_frame(frame)
        tout = ts.stabilize_frame(frame)
        assert_step_agrees(js.carry, jout, ts.carry, tout, cfg, f"{model} frame {i}")
        assert int(js.carry.last_inliers) == int(ts.carry.last_inliers), f"frame {i}"
        np.testing.assert_array_equal(np.asarray(js.carry.corners_mask),
                                      ts.carry.corners_mask.numpy())
    assert bool(np.any(np.abs(ts.carry.last_h.numpy() - np.eye(3)) > 1e-4))


@pytest.mark.parametrize("model,warps_per_frame", [("similarity", 5), ("affine", 5),
                                                   ("homography", 4)])
def test_warp_calls_per_frame(footage, model, warps_per_frame):
    """The warp kernel's wrapper is called 5 times per frame (dense LK's four
    and the output), 4 with the homography model, whose output goes through
    ``warp_perspective``."""
    ts = Stabilizer(config_from_fields(model_config(model)), device="cpu")
    calls = {"lk": 0, "out": 0, "persp": 0}

    def counting(key, fn):
        def run(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return run

    with mock.patch.object(t_lk_dense, "warp_affine", counting("lk", t_lk_dense.warp_affine)), \
            mock.patch.object(t_offline, "warp_affine", counting("out", t_offline.warp_affine)), \
            mock.patch.object(t_offline, "warp_perspective",
                              counting("persp", t_offline.warp_perspective)):
        for frame in footage[:3]:
            ts.stabilize_frame(frame)
    assert calls["lk"] + calls["out"] == warps_per_frame * 3
    assert calls["persp"] == (3 if model == "homography" else 0)


@pytest.fixture(scope="module")
def j_offline_fns():
    """The JAX offline chunk per model, compiled once."""
    return {m: j_make_offline_fn(dataclasses.replace(model_config(m, past=6, future=3),
                                                     static_mode=int(M.GLOBAL_SMOOTHING)))
            for m in ("affine", "homography")}


@pytest.mark.parametrize("model", ["affine", "homography"])
def test_offline_chunk_matches_jax(footage, j_offline_fns, model):
    """K = 4 over 8 frames in GLOBAL_SMOOTHING: the port's offline chunks
    against the JAX package's ``make_offline_fn``: at most 2% of pixels
    differ and at most 0.1% by more than one level (PERF.md §2's offline
    bound; a border pixel flips where the f32 normal equations of the
    affine fit round differently, measured 15 values of 230,400 off by more
    than one), equal inlier counts, transforms within 1e-3."""
    cfg = dataclasses.replace(model_config(model, past=6, future=3),
                              static_mode=int(M.GLOBAL_SMOOTHING))
    jc = j_init_carry(cfg, int(M.GLOBAL_SMOOTHING), jax.random.key(7))
    outs_j = []
    for i in range(0, 8, 4):
        jc, (out, _) = j_offline_fns[model](jc, jnp.asarray(footage[i:i + 4]))
        outs_j.append(np.asarray(out))
    tcfg = config_from_fields(cfg)
    tc, outs_t = stabilize_clip_offline(
        init_carry(tcfg, int(M.GLOBAL_SMOOTHING), prng.key(7), "cpu"), footage[:8], tcfg, 4)
    assert_frames_close_gather(outs_t.numpy(), np.concatenate(outs_j))
    assert int(tc.last_inliers) == int(jc.last_inliers)
    assert int(tc.envelope_violations) == int(jc.envelope_violations)
    np.testing.assert_allclose(tc.transforms.numpy(), np.asarray(jc.transforms), atol=1e-3)
