"""The port's fidelity referee and per-point trackers against the JAX
package: cv2's exact u8 gray (ops/image.py::gray_u8_cv2exact), cv2's exact
corner list (ops/gftt.py, selection="cv2exact", and the host copy
ops/gftt_host.py), the cv2 RANSAC replica (motion/cv2_ransac.py), the
sweep and cv2exact LK (ops/lk.py::lk_track_sweep), the dense tracker's
per-point polish, and ``reference_compat`` through the step, the offline
chunk, the batched step and the host-split ``Stabilizer``.

Mirrors tests/test_cv2_fidelity.py, tests/test_reference_compat.py,
tests/test_cv2_ransac.py and tests/test_features.py's TestCv2Exact*.
Held bit for bit: the u8 gray, the cv2exact and host corner lists, the
RANSAC replica's models and masks, LK status masks and the steps' inlier
counts and corner masks.  Float results are held to the compiled JAX
function within the tolerances below.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stabilization_tpu.config import (
    GFTTConfig, LKConfig, RansacConfig, StabilizationMode)
from video_stabilization_tpu.engine import Stabilizer as JStabilizer
from video_stabilization_tpu.engine import init_carry as j_init_carry
from video_stabilization_tpu.engine import make_offline_fn as j_make_offline_fn
from video_stabilization_tpu.motion import cv2_ransac as j_cv2r
from video_stabilization_tpu.ops import gftt as jgftt
from video_stabilization_tpu.ops import gftt_host as j_host
from video_stabilization_tpu.ops.image import gray_u8_cv2exact as j_gray
from video_stabilization_tpu.ops.lk import lk_track as j_lk_track
from video_stabilization_tpu.ops.pyramid import build_pyramid as j_build_pyramid
from video_stabilization_tpu.parallel import init_batched_carry as j_init_batched_carry
from video_stabilization_tpu.parallel import make_batched_step_fn as j_make_batched_step_fn
from video_stabilization_tpu_torch.config import GFTTConfig as TGFTTConfig
from video_stabilization_tpu_torch.config import LKConfig as TLKConfig
from video_stabilization_tpu_torch.config import config_from_fields
from video_stabilization_tpu_torch.engine import (
    Stabilizer, init_carry, stabilize_clip_offline)
from video_stabilization_tpu_torch.motion import cv2_ransac as t_cv2r
from video_stabilization_tpu_torch.ops import gftt as tgftt
from video_stabilization_tpu_torch.ops import gftt_host as t_host
from video_stabilization_tpu_torch.ops.image import gray_u8_cv2exact
from video_stabilization_tpu_torch.ops.lk import lk_track
from video_stabilization_tpu_torch.ops.pyramid import build_pyramid
from video_stabilization_tpu_torch.parallel import init_batched_carry, make_batched_step_fn
from video_stabilization_tpu_torch.sim import (
    DEFAULT_APP_PARAMS, make_default_texture, render_frame, shake_trajectory)
from video_stabilization_tpu_torch.utils import prng
from test_engine import FH, FW, small_config
from test_torch_engine import assert_step_agrees, corner_drift
from test_torch_offline import assert_frames_close_gather
from torch_threads import one_torch_thread  # noqa: F401

M = StabilizationMode
SWEEP_PTS_TOL = 2e-3     # px, sweep LK endpoints vs compiled JAX (measured 3e-4)
CV2EXACT_PTS_TOL = 1e-3  # px, cv2exact LK endpoints (measured 2e-5)
POLISH_PTS_TOL = 1e-3    # px, dense LK with the per-point polish (measured 8e-5)
ERR_TOL = 2e-3           # mean |residual| per window, 0-255 levels
HOST_SPLIT_DRIFT = 1e-3  # px, last_h at the corners: the host split (measured 4e-6)


def pyr_pair(a, b, levels=3):
    return (build_pyramid(torch.from_numpy(a), levels), build_pyramid(torch.from_numpy(b), levels),
            j_build_pyramid(jnp.asarray(a), levels), j_build_pyramid(jnp.asarray(b), levels))


@pytest.fixture(scope="module")
def footage():
    """14 shaky frames of the small configuration's size (240x320, an
    integer downscale to working height 120), rendered by the port's
    simulator."""
    rng = np.random.default_rng(21)
    tex = torch.from_numpy(make_default_texture(rng, 256))
    n = 14
    traj = shake_trajectory(rng.standard_normal((n, 3)), rng.standard_normal(n),
                            DEFAULT_APP_PARAMS, pos_amplitude=0.004, roll_amplitude=0.3)
    return np.stack([render_frame(tex, traj[i], FH, FW).numpy() for i in range(n)])


# -- cv2's exact u8 gray ---------------------------------------------------------

@pytest.mark.parametrize("shape", [(240, 320, 120, 160), (360, 480, 120, 160),
                                   (720, 1280, 180, 320), (120, 160, 120, 160),
                                   (720, 1280, 360, 640)])
def test_gray_u8_matches_jax_and_host(shape):
    """Bit for bit: the compiled JAX function, and the numpy twin of the
    port's host copy; a leading batch gives each frame's own."""
    h, w, oh, ow = shape
    frames = np.random.default_rng(h + w).integers(0, 256, (2, h, w, 3), np.uint8)
    got = gray_u8_cv2exact(torch.from_numpy(frames), oh, ow).numpy()
    want = np.asarray(jax.jit(j_gray, static_argnums=(1, 2))(jnp.asarray(frames), oh, ow))
    np.testing.assert_array_equal(got, want)
    for i in range(2):
        np.testing.assert_array_equal(got[i], t_host.gray_u8_cv2exact_np(frames[i], oh, ow))
    assert got.dtype == np.float32 and got.min() >= 0 and got.max() <= 255


def test_gray_u8_rejects_other_ratios():
    with pytest.raises(ValueError, match="integer downscales"):
        gray_u8_cv2exact(torch.zeros(120, 160, 3, dtype=torch.uint8), 100, 133)


def test_gray_u8_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(3).integers(0, 256, (1080, 1920, 3), np.uint8)
    want = cv2.cvtColor(cv2.resize(img, (640, 360), interpolation=cv2.INTER_LINEAR),
                        cv2.COLOR_BGR2GRAY)
    got = gray_u8_cv2exact(torch.from_numpy(img), 360, 640).numpy()
    np.testing.assert_array_equal(got.astype(np.uint8), want)


# -- cv2's exact corner list --------------------------------------------------------

def gray_images():
    rng = np.random.default_rng(3)
    tile = rng.integers(0, 256, (60, 80), np.uint8)
    return {"random": rng.integers(0, 256, (120, 160)).astype(np.float32),
            # distant pixels with identical responses: exact ties
            "tiled": np.tile(tile, (2, 2)).astype(np.float32)}


@pytest.mark.parametrize("image", ["random", "tiled", "simulator"])
@pytest.mark.parametrize("k", [256, 1300])
def test_cv2exact_gftt_matches_jax(footage, image, k):
    """The corner list (points, order, mask) equals the compiled JAX
    function's bit for bit, on noise, on a tiled image (exact response
    ties) and on a simulator frame's exact gray."""
    imgs = gray_images()
    imgs["simulator"] = gray_u8_cv2exact(torch.from_numpy(footage[0]), 120, 160).numpy()
    g = imgs[image]
    jc = jax.jit(lambda x: jgftt.good_features_to_track(
        x, GFTTConfig(max_features=k, selection="cv2exact")))(jnp.asarray(g))
    tc = tgftt.good_features_to_track(torch.from_numpy(g),
                                      TGFTTConfig(max_features=k, selection="cv2exact"))
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    np.testing.assert_array_equal(tc.points.numpy(), np.asarray(jc.points))
    assert int(tc.mask.sum()) > 100


def sequential_greedy(pts, min_dist, k):
    """cv2's loop: a grid of round(minDistance) cells, the 3x3 neighbourhood,
    strict < minDistance² rejection."""
    cell = int(round(min_dist))
    accepted = []
    for i in range(len(pts)):
        cx, cy = int(pts[i, 0]) // cell, int(pts[i, 1]) // cell
        ok = True
        for j in accepted:
            jx, jy = int(pts[j, 0]) // cell, int(pts[j, 1]) // cell
            if abs(jx - cx) <= 1 and abs(jy - cy) <= 1:
                if ((pts[i] - pts[j]) ** 2).sum() < min_dist * min_dist:
                    ok = False
                    break
        if ok:
            accepted.append(i)
            if len(accepted) == k:
                break
    return pts[accepted]


@pytest.mark.parametrize("ties", [False, True])
def test_greedy_fixpoint_equals_sequential(ties):
    """The priority-MIS fixpoint reproduces cv2's sequential greedy
    decisions (including the rounded-cell quirk) on adversarial input, and
    equals the JAX function bit for bit; with exact response ties too."""
    rng = np.random.default_rng(7)
    m, k, min_dist = 500, 120, 7.3
    pts = rng.integers(0, 120, size=(m, 2)).astype(np.float32)
    resp = (rng.integers(0, 40, m) if ties else rng.permutation(m)).astype(np.float32) + 1.0
    order = np.argsort(-resp, kind="stable")
    pts, resp = pts[order], resp[order]
    valid = np.ones(m, bool)
    valid[-5:] = False
    want = sequential_greedy(pts[valid], min_dist, k)
    got = tgftt._greedy_cv2exact(*[torch.from_numpy(x) for x in (pts, resp, valid)],
                                 min_dist, k)
    np.testing.assert_array_equal(got.points.numpy()[got.mask.numpy()], want)
    jg = jgftt._greedy_cv2exact(jnp.asarray(pts), jnp.asarray(resp), jnp.asarray(valid),
                                min_dist, k)
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(jg.points))
    np.testing.assert_array_equal(got.response.numpy(), np.asarray(jg.response))


@pytest.mark.parametrize("every", [1, 3, 40])
def test_greedy_check_interval_does_not_change_the_list(monkeypatch, every):
    """Rounds past the fixpoint change nothing: any interval between the
    host checks gives the same list."""
    g = torch.from_numpy(gray_images()["random"])
    cfg = TGFTTConfig(max_features=300, selection="cv2exact")
    want = tgftt.good_features_to_track(g, cfg)
    monkeypatch.setattr(tgftt, "GREEDY_CHECK_EVERY", every)
    got = tgftt.good_features_to_track(g, cfg)
    np.testing.assert_array_equal(got.points.numpy(), want.points.numpy())
    np.testing.assert_array_equal(got.mask.numpy(), want.mask.numpy())


def test_cv2exact_gftt_over_leading_dims():
    imgs = gray_images()
    batch = torch.from_numpy(np.stack([imgs["random"], imgs["tiled"]]))
    cfg = TGFTTConfig(max_features=256, selection="cv2exact")
    got = tgftt.good_features_to_track(batch, cfg)
    assert got.points.shape == (2, 256, 2)
    for i in range(2):
        one = tgftt.good_features_to_track(batch[i], cfg)
        np.testing.assert_array_equal(got.points[i].numpy(), one.points.numpy())
        np.testing.assert_array_equal(got.mask[i].numpy(), one.mask.numpy())


# -- the host stages: own copies equal to the JAX package's ------------------------

@pytest.mark.parametrize("image", ["random", "tiled", "simulator"])
def test_gftt_host_equals_jax_copy(footage, image):
    """The port's numpy copy of the host corner stage gives the JAX
    package's arrays (``np.array_equal``)."""
    if image == "simulator":
        frame = footage[3]
        want = j_host.detect_corners_host(frame, (120, 160), 256, 0.01, 10.0 * 120 / 720)
        got = t_host.detect_corners_host(frame, (120, 160), 256, 0.01, 10.0 * 120 / 720)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        return
    g = gray_images()[image].astype(np.uint8)
    assert np.array_equal(t_host.min_eig_response_np(g), j_host.min_eig_response_np(g))
    assert np.array_equal(t_host.good_features_to_track_np(g, 1300, 0.01, 5.0),
                          j_host.good_features_to_track_np(g, 1300, 0.01, 5.0))


def test_gftt_host_matches_cv2_with_exact_ties():
    cv2 = pytest.importorskip("cv2")
    tile = np.random.default_rng(3).integers(0, 256, (90, 160), np.uint8)
    g = np.tile(tile, (4, 4))
    want = cv2.goodFeaturesToTrack(g, maxCorners=1300, qualityLevel=0.01, minDistance=5.0,
                                   blockSize=3).reshape(-1, 2)
    np.testing.assert_array_equal(t_host.good_features_to_track_np(g, 1300, 0.01, 5.0), want)


def ransac_case(rng, n, noise=0.8, outlier_frac=0.25, outlier_mag=80.0):
    src = rng.uniform(0, 640, (n, 2)).astype(np.float32)
    th = rng.uniform(-0.1, 0.1)
    a, b = np.cos(th), np.sin(th)
    dst = (src @ np.array([[a, b], [-b, a]], np.float32)) + rng.uniform(-20, 20, 2).astype(
        np.float32)
    dst += rng.normal(0, noise, dst.shape).astype(np.float32)
    n_out = int(n * outlier_frac)
    dst[:n_out] += rng.uniform(-outlier_mag, outlier_mag, (n_out, 2)).astype(np.float32)
    return src, dst


@pytest.mark.parametrize("n,thresh,outliers", [(2, 3.0, 0.0), (12, 3.0, 0.25),
                                               (200, 3.0, 0.25), (800, 5.0, 0.25),
                                               (300, 3.0, 0.6)])
def test_cv2_ransac_equals_jax_copy(n, thresh, outliers):
    """The port's copy of the replica gives the JAX package's model and
    mask (``np.array_equal``), and the same host estimator result."""
    rng = np.random.default_rng(n)
    src, dst = ransac_case(rng, n, outlier_frac=outliers)
    m_t, mask_t = t_cv2r.estimate_affine_partial_2d_cv2(src, dst, ransac_reproj_threshold=thresh)
    m_j, mask_j = j_cv2r.estimate_affine_partial_2d_cv2(src, dst, ransac_reproj_threshold=thresh)
    assert np.array_equal(m_t, m_j) and np.array_equal(mask_t, mask_j)
    status = rng.uniform(size=n) > 0.1
    got = t_cv2r.estimate_rigid_cv2_host(src, dst, status, (320.0, 180.0))
    want = j_cv2r.estimate_rigid_cv2_host(src, dst, status, (320.0, 180.0))
    assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]


def test_cv_rng_stream_equals_jax_copy():
    a, b = t_cv2r.CvRNG(), j_cv2r.CvRNG()
    assert [a.next() for _ in range(64)] == [b.next() for _ in range(64)]


def test_cv2_ransac_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    src, dst = ransac_case(np.random.default_rng(5), 300)
    m_cv, mask_cv = cv2.estimateAffinePartial2D(src, dst, method=cv2.RANSAC,
                                                ransacReprojThreshold=3.0)
    m, mask = t_cv2r.estimate_affine_partial_2d_cv2(src, dst, ransac_reproj_threshold=3.0)
    np.testing.assert_array_equal(mask.reshape(-1), mask_cv.reshape(-1))
    assert np.abs(m - m_cv).max() < 5e-6


# -- the per-point trackers --------------------------------------------------------

def border_pair():
    """A smooth random image and its (+1, +2) shift, 120x160, with points
    near every border (tests/test_cv2_fidelity.py's), two inside, one
    masked lane."""
    import scipy.ndimage as nd

    rng = np.random.default_rng(4)
    big = nd.gaussian_filter(rng.integers(0, 256, (140, 180)).astype(np.float32), 1.5)
    a, b = big[4:124, 6:166].copy(), big[2:122, 5:165].copy()
    pts = [(x, y) for y in [1.0, 2.0, 3.0, 60.0, 116.0, 118.0]
           for x in [1.0, 2.0, 80.0, 157.0, 158.0]]
    pts = np.array(pts + [(40.3, 50.7), (100.2, 30.1), (0.0, 0.0)], np.float32)
    mask = np.ones(len(pts), bool)
    mask[-1] = False
    return a, b, pts, mask


@pytest.mark.parametrize("method,tol", [("sweep", SWEEP_PTS_TOL),
                                        ("cv2exact", CV2EXACT_PTS_TOL)])
def test_per_point_lk_matches_jax(method, tol):
    """Border points included: status equal bit for bit, endpoints and
    errors within the stated tolerances of the compiled JAX tracker."""
    a, b, pts, mask = border_pair()
    ta, tb, ja, jb = pyr_pair(a, b)
    jr = jax.jit(lambda pa, pb, p, m: j_lk_track(pa, pb, p, m, LKConfig(method=method)))(
        ja, jb, jnp.asarray(pts), jnp.asarray(mask))
    tr = lk_track(ta, tb, torch.from_numpy(pts), torch.from_numpy(mask),
                  TLKConfig(method=method))
    np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
    np.testing.assert_allclose(tr.points.numpy(), np.asarray(jr.points), atol=tol)
    st = tr.status.numpy()
    np.testing.assert_allclose(tr.error.numpy()[st], np.asarray(jr.error)[st], atol=ERR_TOL)
    assert st.sum() >= 25


def test_cv2exact_lk_border_points_match_cv2():
    cv2 = pytest.importorskip("cv2")
    a, b, pts, mask = border_pair()
    a8, b8 = np.round(a).astype(np.uint8), np.round(b).astype(np.uint8)
    nxt, st, _ = cv2.calcOpticalFlowPyrLK(
        a8, b8, pts.reshape(-1, 1, 2), None, winSize=(21, 21), maxLevel=3,
        criteria=(cv2.TERM_CRITERIA_COUNT | cv2.TERM_CRITERIA_EPS, 50, 0.01),
        minEigThreshold=1e-4)
    ta, tb, _, _ = pyr_pair(a8.astype(np.float32), b8.astype(np.float32))
    tr = lk_track(ta, tb, torch.from_numpy(pts), torch.ones(len(pts), dtype=torch.bool),
                  TLKConfig(method="cv2exact"))
    common = st.reshape(-1).astype(bool) & tr.status.numpy()
    assert common.sum() >= 0.8 * len(pts)
    d = np.linalg.norm(nxt.reshape(-1, 2)[common] - tr.points.numpy()[common], axis=1)
    assert d.max() < 2e-2


@pytest.mark.parametrize("method", ["sweep", "cv2exact"])
def test_per_point_lk_over_a_batch_of_pairs(method):
    """Levels (B, h, w) and points (B, N, 2): each pair's own result."""
    a, b, pts, mask = border_pair()
    ta, tb, _, _ = pyr_pair(a, b)
    tb2 = build_pyramid(torch.from_numpy(np.roll(b, 1, axis=1)), 3)
    cfg = TLKConfig(method=method)
    batch = lk_track([torch.stack([x, x]) for x in ta], [torch.stack([x, y]) for x, y in
                                                       zip(tb, tb2)],
                     torch.from_numpy(np.stack([pts, pts])),
                     torch.from_numpy(np.stack([mask, mask])), cfg)
    for i, nxt in enumerate((tb, tb2)):
        one = lk_track(ta, nxt, torch.from_numpy(pts), torch.from_numpy(mask), cfg)
        assert torch.equal(batch.points[i], one.points)
        assert torch.equal(batch.status[i], one.status)


@pytest.mark.parametrize("iters", [1, 2])
def test_dense_polish_matches_jax(footage, iters):
    """Dense LK with ``corner_polish_iters``: status equal, endpoints within
    POLISH_PTS_TOL of the compiled JAX tracker; a batch of two pairs gives
    each pair's own."""
    from video_stabilization_tpu_torch.ops.image import bgr_to_gray

    grays = [bgr_to_gray(torch.from_numpy(f[::2, ::2])).numpy() for f in footage[:3]]
    ta, tb, ja, jb = pyr_pair(grays[0], grays[1])
    rng = np.random.default_rng(iters)
    pts = (rng.uniform(5, 115, (96, 2)) * np.array([160 / 120, 1.0])).astype(np.float32)
    mask = np.ones(96, bool)
    jr = jax.jit(lambda pa, pb, p, m: j_lk_track(
        pa, pb, p, m, LKConfig(corner_polish_iters=iters)))(ja, jb, jnp.asarray(pts),
                                                           jnp.asarray(mask))
    cfg = TLKConfig(corner_polish_iters=iters)
    tr = lk_track(ta, tb, torch.from_numpy(pts), torch.from_numpy(mask), cfg)
    np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
    np.testing.assert_allclose(tr.points.numpy(), np.asarray(jr.points), atol=POLISH_PTS_TOL)
    assert tr.status.sum() > 60

    tc = build_pyramid(torch.from_numpy(grays[2]), 3)
    batch = lk_track([torch.stack([x, y]) for x, y in zip(ta, tb)],
                     [torch.stack([x, y]) for x, y in zip(tb, tc)],
                     torch.from_numpy(np.stack([pts, pts])),
                     torch.from_numpy(np.stack([mask, mask])), cfg)
    one = lk_track(tb, tc, torch.from_numpy(pts), torch.from_numpy(mask), cfg)
    np.testing.assert_allclose(batch.points[0].numpy(), tr.points.numpy(), atol=1e-4)
    np.testing.assert_allclose(batch.points[1].numpy(), one.points.numpy(), atol=1e-4)
    np.testing.assert_array_equal(batch.status[1].numpy(), one.status.numpy())


# -- reference_compat through the step, the chunk and the batched step -----------

COMPAT_DRIFT = dict(reference_compat=True, lk=LKConfig(method="cv2exact", max_iters=30),
                    gftt=GFTTConfig(max_features=256, selection="host"),
                    ransac=RansacConfig(method="cv2exact"))


def compat_config(**kw):
    return dataclasses.replace(small_config(compat=True), **kw)


def assert_same_lists(jcarry, tcarry, where):
    np.testing.assert_array_equal(tcarry.corners_mask.numpy(), np.asarray(jcarry.corners_mask),
                                  err_msg=where)
    np.testing.assert_array_equal(tcarry.corners_prev.numpy(), np.asarray(jcarry.corners_prev),
                                  err_msg=where)
    assert int(tcarry.last_inliers) == int(jcarry.last_inliers), where


@pytest.mark.parametrize("mode", [M.GLOBAL_SMOOTHING, M.ACCUMULATED_FULL_LOCK])
def test_reference_compat_step_matches_jax(footage, mode):
    """``bench.py::production_drift``'s configuration (reference_compat
    only) frame by frame against JAX's Stabilizer: corner lists (cv2exact)
    and inlier counts equal, last_h within 0.05 px at the corners."""
    cfg = compat_config()
    js = JStabilizer(cfg, mode)
    ts = Stabilizer(config_from_fields(cfg), mode, device="cpu")
    for i, frame in enumerate(footage[:10]):
        jout = js.stabilize_frame(frame)
        tout = ts.stabilize_frame(frame)
        assert_step_agrees(js.carry, jout, ts.carry, tout, cfg, f"frame {i}")
        assert_same_lists(js.carry, ts.carry, f"frame {i}")


def test_host_split_stabilizer_matches_jax(footage):
    """``bench.py::compat_drift``'s configuration (reference_compat, cv2exact
    LK, host GFTT, cv2exact RANSAC) through the host-split Stabilizer, frame
    by frame against JAX's: the host corner list and the replica's inlier
    count equal, last_h within HOST_SPLIT_DRIFT, outputs as the step's; one
    host read per frame (the frames are numpy)."""
    cfg = compat_config(**COMPAT_DRIFT)
    js = JStabilizer(cfg)
    ts = Stabilizer(config_from_fields(cfg), device="cpu")
    for i, frame in enumerate(footage):
        jout = js.stabilize_frame(frame)
        tout = ts.stabilize_frame(frame)
        assert_same_lists(js.carry, ts.carry, f"frame {i}")
        drift = corner_drift(np.asarray(js.carry.last_h, float),
                             ts.carry.last_h.double().numpy(), cfg)
        assert drift <= HOST_SPLIT_DRIFT, f"frame {i}: {drift}"
        assert_step_agrees(js.carry, jout, ts.carry, tout, cfg, f"frame {i}")
    assert ts.host_reads == len(footage)
    assert int(ts.carry.last_inliers) >= 100


def test_track_and_ext_step_factories_make_the_host_split(footage):
    """``make_track_fn`` and ``make_step_ext_fn`` with the host estimator
    between them (the JAX package's split, by hand) give the host-split
    ``Stabilizer``'s carry and outputs bit for bit."""
    from video_stabilization_tpu_torch.engine import make_step_ext_fn, make_track_fn

    cfg = config_from_fields(compat_config(**dict(COMPAT_DRIFT, gftt=GFTTConfig(
        max_features=256)), static_mode=int(M.GLOBAL_SMOOTHING)))
    stab = Stabilizer(cfg, device="cpu")
    carry = init_carry(cfg, int(M.GLOBAL_SMOOTHING), prng.key(0), "cpu")
    track, step = make_track_fn(cfg), make_step_ext_fn(cfg)
    for frame in footage[:6]:
        f = torch.from_numpy(frame)
        pts, status = track(carry, f)
        h, valid, n = t_cv2r.estimate_rigid_cv2_host(
            carry.corners_prev.numpy(), pts.numpy(), status.numpy(), center=(80.0, 60.0),
            min_points=cfg.ransac.min_points,
            ransac_reproj_threshold=cfg.ransac.inlier_threshold)
        carry, (out, _) = step(carry, f, (torch.tensor(h, dtype=torch.float32),
                                          torch.tensor(valid), torch.tensor(n, dtype=torch.int32)))
        want = stab.stabilize_frame(frame)
        assert torch.equal(out, want)
        assert torch.equal(carry.last_h, stab.carry.last_h)
    assert int(carry.last_inliers) == int(stab.carry.last_inliers) > 50


def test_compat_translation_and_rotation_locks_are_noops(footage):
    """tests/test_reference_compat.py's quirk 4: under reference_compat the
    translation and rotation locks present frame n - future unwarped (H
    identity), and the first frame passes through (quirk 1)."""
    for mode in (M.TRANSLATION_LOCK, M.ROTATION_LOCK):
        ts = Stabilizer(config_from_fields(compat_config()), mode, device="cpu")
        outs = [ts.stabilize_frame(f).numpy() for f in footage[:8]]
        np.testing.assert_array_equal(outs[0], footage[0])
        future = ts.config.future_frames
        np.testing.assert_allclose(outs[7].astype(np.float32),
                                   footage[7 - future].astype(np.float32), atol=1.0)
        assert not bool(ts.carry.accum_active)


def test_compat_and_fixed_smoothing_differ(footage):
    sc = Stabilizer(config_from_fields(compat_config()), device="cpu")
    sf = Stabilizer(config_from_fields(small_config()), device="cpu")
    diff = sum(np.abs(sc.stabilize_frame(f).numpy().astype(np.float32)
                      - sf.stabilize_frame(f).numpy().astype(np.float32)).mean()
               for f in footage[:10])
    assert diff > 0.0


def test_offline_reference_compat_matches_jax(footage):
    """The offline chunk under reference_compat (the JAX chunk's float gray,
    cv2's exact corner list, the accumulated-only lock), K = 4 over 8
    frames, against the JAX package's ``make_offline_fn``."""
    cfg = dataclasses.replace(compat_config(), past_frames=6, future_frames=3,
                              static_mode=int(M.ACCUMULATED_FULL_LOCK))
    step = j_make_offline_fn(cfg)
    jc = j_init_carry(cfg, int(M.ACCUMULATED_FULL_LOCK), jax.random.key(7))
    outs_j = []
    for i in range(0, 8, 4):
        jc, (out, _) = step(jc, jnp.asarray(footage[i:i + 4]))
        outs_j.append(np.asarray(out))
    tcfg = config_from_fields(cfg)
    tc, outs_t = stabilize_clip_offline(
        init_carry(tcfg, int(M.ACCUMULATED_FULL_LOCK), prng.key(7), "cpu"), footage[:8],
        tcfg, 4)
    assert_frames_close_gather(outs_t.numpy(), np.concatenate(outs_j))
    assert_same_lists(jc, tc, "offline")
    np.testing.assert_allclose(tc.accum_h.numpy(), np.asarray(jc.accum_h), atol=1e-4)


def test_batched_step_reference_compat_matches_jax(footage):
    """The batched step (JAX: a vmap of the streaming step) under
    reference_compat with host-GFTT lanes, two streams: the streaming
    step's u8 gray and empty corner lanes, as JAX's; inlier counts equal,
    outputs within one level on 2% of the pixels."""
    cfg = dataclasses.replace(compat_config(), static_mode=int(M.GLOBAL_SMOOTHING),
                              gftt=GFTTConfig(max_features=256, selection="host"))
    frames = np.stack([footage[:5], footage[1:6]], 1)             # (T, S, H, W, 3)
    jstep = j_make_batched_step_fn(cfg)
    jc = j_init_batched_carry(cfg, 2, 0, jax.random.key(3))
    tstep = make_batched_step_fn(config_from_fields(cfg))
    tc = init_batched_carry(config_from_fields(cfg), 2, 0, prng.key(3), "cpu")
    for i, f in enumerate(frames):
        jc, (jout, _) = jstep(jc, jnp.asarray(f))
        tc, (tout, _) = tstep(tc, torch.from_numpy(f))
        assert_frames_close_gather(tout.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(tc.last_inliers.numpy(), np.asarray(jc.last_inliers))
        assert not tc.corners_mask.any() and not np.asarray(jc.corners_mask).any()
