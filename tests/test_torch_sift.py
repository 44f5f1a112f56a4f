"""PyTorch port vs the JAX package: SIFT detect + describe, its map helpers,
and L2 matching; and the JAX package's SIFT tests mirrored on the port.

The JAX side is the compiled function (``jax.jit``), as the step runs it.
The port's Gaussian blur and input scaling reproduce the compiled
function's rounding (fused multiply-adds, a reciprocal multiply), so
keypoint masks and positions agree; orientations and descriptors go through
``atan2``, ``exp``, ``sin`` and ``cos``, which round differently between
XLA:CPU and torch, and are held at the tolerances below.
"""

import dataclasses

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stabilization_tpu.config import SIFTConfig as JSIFTConfig
from video_stabilization_tpu.ops import sift as jsift
from video_stabilization_tpu.ops.match import match_l2 as j_match_l2
from video_stabilization_tpu_torch.config import RansacConfig, SIFTConfig
from video_stabilization_tpu_torch.motion.homography import decompose_homography
from video_stabilization_tpu_torch.motion.ransac import estimate_similarity_ransac
from video_stabilization_tpu_torch.ops import sift as tsift
from video_stabilization_tpu_torch.ops.filters import preprocess_for_registration
from video_stabilization_tpu_torch.ops.image import bgr_to_gray, resize_nearest
from video_stabilization_tpu_torch.ops.match import match_l2
from video_stabilization_tpu_torch.sim import (
    DEFAULT_APP_PARAMS, inter_frame_homography, make_default_texture, render_frame,
    rotation_matrix, shake_trajectory)
from video_stabilization_tpu_torch.utils import prng
from test_engine import FH, FW, small_config
from test_sift import CFG as J_CFG, H, W
from torch_threads import one_torch_thread  # noqa: F401

SAME_POS = 1e-3        # px: a keypoint at the same position
SAME_SHARE = 0.98      # share of JAX's keypoints at the same position
DESC_TOL = 2e-3        # max |Δ| of a keypoint's descriptor entries
DESC_SHARE = 0.98      # share of same-position keypoints within DESC_TOL
# Measured (torch 2.13 CPU vs jax.jit on XLA:CPU): masks equal in all four
# cases (89 to 248 keypoints), every JAX keypoint within 1.2e-4 px of the
# port's, descriptor max |Δ| 1.1e-4, angle max |Δ| 7.4e-5 rad.


@pytest.fixture(scope="module")
def texture():
    return torch.from_numpy(make_default_texture(np.random.default_rng(0), 512))


@pytest.fixture(scope="module")
def clip_frame(texture):
    """Frame 3 of a small shaky clip (tests/test_engine.py's 240x320 frame
    size and shake), rendered by the port's simulator."""
    rng = np.random.default_rng(5)
    traj = shake_trajectory(rng.standard_normal((4, 3)), rng.standard_normal(4),
                            DEFAULT_APP_PARAMS, pos_amplitude=0.004, roll_amplitude=0.3)
    return render_frame(texture, traj[3], FH, FW).numpy()


_j_sift = jax.jit(jsift.sift_detect_and_compute, static_argnames="config")
CFG = small_config().sift          # max_features 256, size ratio 0.5


def preprocessed(frame_u8: np.ndarray, h: int, w: int) -> np.ndarray:
    """The SIFT lock's input: nearest downscale to (h, w), gray, the
    median/sharpen/CLAHE chain."""
    f = torch.from_numpy(np.ascontiguousarray(frame_u8)).float()
    return preprocess_for_registration(bgr_to_gray(resize_nearest(f, h, w))).numpy()


CASES = {"working_120x160": ((120, 160), {}),
         "full_240x320": ((240, 320), {}),
         "upsample_2x": ((120, 160), dict(upsample_2x=True)),
         "multi_orientation": ((120, 160), dict(multi_orientation=True))}


@pytest.mark.parametrize("case", list(CASES))
def test_sift_matches_jax(clip_frame, case):
    (h, w), kw = CASES[case]
    img = preprocessed(clip_frame, h, w)
    cfg = dataclasses.replace(CFG, **kw)
    j = _j_sift(jnp.asarray(img), config=JSIFTConfig(**dataclasses.asdict(cfg)))
    t = tsift.sift_detect_and_compute(torch.from_numpy(img), cfg)

    jm = np.asarray(j.mask)
    np.testing.assert_array_equal(t.mask.numpy(), jm)
    assert jm.sum() >= 50, jm.sum()
    same = (np.abs(np.asarray(j.points) - t.points.numpy()).max(1) <= SAME_POS) & jm
    assert same.sum() >= SAME_SHARE * jm.sum(), (same.sum(), jm.sum())
    d = np.abs(np.asarray(j.desc) - t.desc.numpy()).max(1)[same]
    assert (d <= DESC_TOL).mean() >= DESC_SHARE, np.sort(d)[-5:]
    np.testing.assert_allclose(t.size.numpy(), np.asarray(j.size), rtol=1e-6)
    np.testing.assert_allclose(t.response.numpy()[same], np.asarray(j.response)[same],
                               atol=1e-6)
    # masked-out slots hold zero descriptors in both packages
    assert not t.desc.numpy()[~jm].any() and not np.asarray(j.desc)[~jm].any()


@pytest.mark.parametrize("sigma", [1.2, 1.9, 3.07])
def test_gauss_blur_matches_jax(sigma):
    """Bit for bit: the port rounds its taps as the compiled function fuses
    them (fma(k0, x0, k1·x1), then fma(k_i, x_i, acc))."""
    img = np.random.default_rng(7).uniform(0, 1, (45, 70)).astype(np.float32)
    j = jax.jit(jsift._gauss_blur, static_argnums=1)(jnp.asarray(img), sigma)
    t = tsift._gauss_blur(torch.from_numpy(img), sigma)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def dog_maps(seed: int, shape=(40, 56)):
    rng = np.random.default_rng(seed)
    maps = [rng.normal(0, 0.05, shape).astype(np.float32) for _ in range(3)]
    # plant a strong, blob-like minimum on the wrapped corner: the edge
    # test's rolled neighbours of (0, 0) come from the opposite edges
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    ry = np.minimum(yy, shape[0] - yy)
    rx = np.minimum(xx, shape[1] - xx)
    blob = -0.5 * np.exp(-(ry ** 2 + rx ** 2) / 4.0).astype(np.float32)
    maps[1] = maps[1] + blob
    return maps


@pytest.mark.parametrize("seed", [0, 1])
def test_extrema_mask_matches_jax(seed):
    """Equal masks on random DoG maps, including an extremum on the wrapped
    corner; the contrast threshold is that of the default SIFTConfig."""
    maps = dog_maps(seed)
    contrast = 0.5 * 0.04 / 3
    j = jax.jit(jsift._extrema_mask, static_argnums=(3, 4))(
        *[jnp.asarray(m) for m in maps], contrast, 5.0)
    t = tsift._extrema_mask(*[torch.from_numpy(m) for m in maps], contrast, 5.0)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert bool(t[0, 0]), "the corner minimum is detected"
    assert int(t.sum()) >= 5


def test_subpixel_xy_matches_jax():
    """Offsets within 1e-6 px at every pixel, borders (clamped gathers)
    included."""
    dog = dog_maps(3)[1]
    ys, xs = np.mgrid[:dog.shape[0], :dog.shape[1]]
    ys, xs = ys.reshape(-1).astype(np.int32), xs.reshape(-1).astype(np.int32)
    jx, jy = jax.jit(jsift._subpixel_xy)(jnp.asarray(dog), jnp.asarray(ys), jnp.asarray(xs))
    tx, ty = tsift._subpixel_xy(torch.from_numpy(dog), torch.from_numpy(ys).long(),
                                torch.from_numpy(xs).long())
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6)


@pytest.mark.parametrize("n1,n2", [(200, 150), (64, 256)])
def test_match_l2_matches_jax(n1, n2):
    """Random unit descriptors (and near-duplicates, so the distance filter
    keeps some): ``idx`` equal where the best and second-best squared
    distances are more than 1e-4 apart, distances within 1e-5, ``valid``
    equal."""
    rng = np.random.default_rng(n1 + n2)
    d2 = rng.normal(size=(n2, 128)).astype(np.float32)
    d1 = rng.normal(size=(n1, 128)).astype(np.float32)
    d1[: n1 // 3] = d2[rng.choice(n2, n1 // 3)] + 0.05 * d1[: n1 // 3]
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    m1 = rng.uniform(size=n1) < 0.9
    m2 = rng.uniform(size=n2) < 0.9
    j = jax.jit(j_match_l2)(jnp.asarray(d1), jnp.asarray(m1), jnp.asarray(d2),
                            jnp.asarray(m2))
    t = match_l2(*[torch.from_numpy(x) for x in (d1, m1, d2, m2)])

    sq = ((d1[:, None, :].astype(np.float64) - d2[None]) ** 2).sum(-1)
    sq[:, ~m2] = np.inf
    two = np.sort(sq, 1)[:, :2]
    clear = (two[:, 1] - two[:, 0]) > 1e-4
    np.testing.assert_array_equal(t.idx.numpy()[clear], np.asarray(j.idx)[clear])
    np.testing.assert_allclose(t.distance.numpy(), np.asarray(j.distance), atol=1e-5)
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    assert 0 < int(t.valid.sum()) < int((m1).sum())


# -- the JAX package's tests/test_sift.py, on the port alone (the port's
# simulator renders the frames) ----------------------------------------------

PORT_CFG = SIFTConfig(**dataclasses.asdict(J_CFG))     # max_features 512


def sim_gray(texture, params) -> np.ndarray:
    """cv2's gray of a 360x640 simulator frame, as tests/test_sift.py feeds."""
    f = render_frame(texture, params, H, W).numpy()
    return cv2.cvtColor(f, cv2.COLOR_BGR2GRAY).astype(np.float32)


def moved(params, right: float = 0.0, roll: float = 0.0):
    """tests/test_sift.py's ``roll_clockwise(move_right(p, right), roll)``
    (move speed 0.1, roll speed 2 degrees)."""
    axis = rotation_matrix(params.pan, params.tilt, params.roll)[:, 0]
    return dataclasses.replace(params, position=params.position + axis * (right * 0.1),
                               roll=params.roll - roll * 2.0)


@pytest.fixture(scope="module")
def registration_pair(texture):
    pa = DEFAULT_APP_PARAMS
    pb = moved(pa, right=0.15, roll=0.5)
    return pa, pb, sim_gray(texture, pa), sim_gray(texture, pb)


def sift(gray: np.ndarray):
    return tsift.sift_detect_and_compute(torch.from_numpy(gray), PORT_CFG)


def test_detects_enough(registration_pair):
    feats = sift(registration_pair[2])
    n = int(feats.mask.sum())
    assert n > 100
    norms = torch.linalg.vector_norm(feats.desc[feats.mask], dim=1).numpy()
    np.testing.assert_allclose(norms, 1.0, atol=1e-3)


def test_flat_image_no_keypoints():
    feats = tsift.sift_detect_and_compute(torch.full((128, 128), 100.0), PORT_CFG)
    assert int(feats.mask.sum()) == 0
    assert feats.desc.shape == (PORT_CFG.max_features, 128)


def register(fa, fb, seed: int):
    m = match_l2(fa.desc, fa.mask, fb.desc, fb.mask, avg_ratio=0.75)
    res = estimate_similarity_ransac(fa.points, fb.points[m.idx], m.valid, prng.key(seed),
                                     RansacConfig(num_hypotheses=256, inlier_threshold=5.0))
    return m, res


def test_recovers_motion(registration_pair):
    pa, pb, ga, gb = registration_pair
    m, res = register(sift(ga), sift(gb), 0)
    assert int(m.valid.sum()) > 25
    assert bool(res.valid)
    h_true = inter_frame_homography(pa, pb, H, W).double().numpy()
    c = np.array([[0, 0, 1], [W, 0, 1], [W, H, 1], [0, H, 1]], float).T
    pe = res.h.double().numpy() @ c
    pt = h_true @ c
    assert np.abs(pe[:2] / pe[2] - pt[:2] / pt[2]).mean() < 2.5


def test_rotation_invariance(texture):
    """A 20° roll is recovered within ±2°."""
    pa = DEFAULT_APP_PARAMS
    pb = moved(pa, roll=-10.0)                  # roll + 20 degrees
    _, res = register(sift(sim_gray(texture, pa)), sift(sim_gray(texture, pb)), 1)
    assert bool(res.valid)
    params, ok = decompose_homography(res.h, torch.tensor([W / 2, H / 2]))
    assert bool(ok)
    np.testing.assert_allclose(np.rad2deg(float(params.theta)), 20.0, atol=2.0)



# -- the SIFT cases of tests/test_parity.py, on the port alone ----------------

def test_descriptor_parity_with_cv2(texture):
    """Keypoints that coincide with cv::SIFT's (within 2 px) carry
    descriptors far above chance cosine similarity (random unit pairs sit
    near 0.45)."""
    gray = sim_gray(texture, DEFAULT_APP_PARAMS).astype(np.uint8)
    sift_cv = cv2.SIFT_create(nfeatures=300, nOctaveLayers=3, contrastThreshold=0.04,
                              edgeThreshold=5, sigma=1.2)
    kps, desc_cv = sift_cv.detectAndCompute(gray, None)
    assert desc_cv is not None and len(kps) > 30
    pts_cv = np.array([kp.pt for kp in kps], np.float32)
    d_cv = desc_cv / (np.linalg.norm(desc_cv, axis=1, keepdims=True) + 1e-7)
    ours = tsift.sift_detect_and_compute(
        torch.from_numpy(gray.astype(np.float32)),
        SIFTConfig(max_features=1024, upsample_2x=True, multi_orientation=True))
    pts_o = ours.points[ours.mask].numpy()
    d_o = ours.desc[ours.mask].numpy()
    d_o = d_o / (np.linalg.norm(d_o, axis=1, keepdims=True) + 1e-7)
    d2 = ((pts_cv[:, None, :] - pts_o[None, :, :]) ** 2).sum(-1)
    sims = [float(np.max(d_o[near] @ d_cv[i])) for i in range(len(pts_cv))
            if len(near := np.where(d2[i] <= 4.0)[0])]
    assert len(sims) / len(pts_cv) >= 0.35
    assert float(np.median(sims)) >= 0.70


def test_upsample_adds_fine_scales(registration_pair):
    gray = torch.from_numpy(registration_pair[2])
    base = tsift.sift_detect_and_compute(gray, SIFTConfig(max_features=512))
    up = tsift.sift_detect_and_compute(gray, SIFTConfig(max_features=512, upsample_2x=True))
    s_base, s_up = base.size[base.mask], up.size[up.mask]
    assert len(s_up) > 0 and len(s_base) > 0
    # the -1 octave contributes keypoints at half the smallest base size
    assert float(s_up.min()) < 0.75 * float(s_base.min())


def test_multi_orientation_emits_secondary_lanes(registration_pair):
    """Some positions carry two keypoints whose orientations differ."""
    f = tsift.sift_detect_and_compute(torch.from_numpy(registration_pair[2]),
                                      SIFTConfig(max_features=1024, multi_orientation=True))
    pts = f.points[f.mask].numpy()
    ang = np.mod(f.angle[f.mask].numpy(), 2 * np.pi)
    _, inv, counts = np.unique(np.round(pts * 8).astype(np.int64), axis=0,
                               return_inverse=True, return_counts=True)
    inv = inv.reshape(-1)
    spreads = [np.ptp(ang[inv == g]) for g in np.where(counts > 1)[0]]
    assert spreads and max(spreads) > 0.3
