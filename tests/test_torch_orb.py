"""PyTorch port vs the JAX package: FAST, patch extraction, Hamming matching
and ORB detect + describe.

JAX's ``fast_score`` runs its Pallas kernel in interpret mode on the CPU;
the port's ``fast_score`` runs its plain version on a CPU tensor.  The ORB
inputs are floor-texture frames rendered by the port's simulator and
preprocessed as the lock does, handed to both packages as numpy arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stabilization_tpu.config import ORBConfig, StabilizerConfig
from video_stabilization_tpu.ops import fast as jfast
from video_stabilization_tpu.ops import orb as jorb
from video_stabilization_tpu.ops.match import match_hamming_knn as j_match
from video_stabilization_tpu.ops.patches import extract_patches_mxu
from video_stabilization_tpu_torch.config import config_from_fields
from video_stabilization_tpu_torch.ops import fast as tfast
from video_stabilization_tpu_torch.ops import orb as torb
from video_stabilization_tpu_torch.ops.filters import preprocess_for_registration
from video_stabilization_tpu_torch.ops.image import resize_bilinear
from video_stabilization_tpu_torch.ops.match import match_hamming_knn as t_match
from video_stabilization_tpu_torch.ops.patches import extract_patches
from video_stabilization_tpu_torch.sim import (
    DEFAULT_APP_PARAMS, make_default_texture, render_frame)
from test_engine import small_config
from test_orb import CFG as ORB_CFG

# the ten level shapes of a 360x640 working image (ops/orb.py level loop)
LEVEL_SHAPES = [(360, 640), (300, 533), (250, 444), (208, 370), (174, 309),
                (145, 257), (121, 214), (100, 179), (84, 149), (70, 124)]
SAME_KEYPOINTS = 0.99   # share of valid keypoints identical in both packages
SAME_BITS = 0.99        # share of descriptor bits equal on shared keypoints

_j_orb = jax.jit(jorb.orb_detect_and_compute, static_argnames="config")


def test_level_shapes_are_the_orb_loops():
    h, w = LEVEL_SHAPES[0]
    cfg = ORBConfig()
    shapes, lh, lw, level = [], h, w, 0
    while lh > 2 * cfg.edge_threshold and lw > 2 * cfg.edge_threshold:
        shapes.append((lh, lw))
        level += 1
        lh = int(round(h / cfg.scale_factor ** level))
        lw = int(round(w / cfg.scale_factor ** level))
    assert shapes == LEVEL_SHAPES


@pytest.mark.parametrize("shape", [(47, 133), (64, 80)])
@pytest.mark.parametrize("kind", ["integer", "float"])
def test_fast_plain_matches_pallas(shape, kind):
    rng = np.random.default_rng(sum(shape))
    img = rng.uniform(0, 255, shape).astype(np.float32)
    if kind == "integer":
        img = np.round(img)
    a = np.asarray(jfast.fast_score(jnp.asarray(img), 20.0)[0])
    score, corner = tfast.fast_score(torch.from_numpy(img), 20.0)
    np.testing.assert_array_equal(score.numpy(), a)
    np.testing.assert_array_equal(corner.numpy(), a > 0)
    assert (a > 0).sum() > 0


@pytest.mark.parametrize("shape", LEVEL_SHAPES)
def test_fast_plain_matches_xla(shape):
    rng = np.random.default_rng(shape[0])
    img = np.round(rng.uniform(0, 255, shape)).astype(np.float32)
    sj, cj = jax.jit(jfast.fast_score_xla, static_argnums=1)(jnp.asarray(img), 20.0)
    st, ct = tfast.fast_score_plain(torch.from_numpy(img), 20.0)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


@pytest.mark.parametrize("shape,n", [((90, 130), 37), ((130, 90), 5)])
def test_extract_patches_matches_mxu(shape, n):
    rng = np.random.default_rng(n)
    planes = rng.uniform(0, 255, (2,) + shape).astype(np.float32)
    size = 49
    iy = rng.integers(0, shape[0] - size + 1, n).astype(np.int32)
    ix = rng.integers(0, shape[1] - size + 1, n).astype(np.int32)
    a = np.asarray(extract_patches_mxu(jnp.asarray(planes), jnp.asarray(iy),
                                       jnp.asarray(ix), size))
    b = extract_patches(torch.from_numpy(planes), torch.from_numpy(iy),
                        torch.from_numpy(ix), size).numpy()
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("seed", [0, 1])
def test_hamming_knn_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n1, n2 = 96, 128
    d1 = rng.choice(np.array([-1, 1], np.int8), (n1, 256))
    d2 = rng.choice(np.array([-1, 1], np.int8), (n2, 256))
    d2[:40] = d1[:40]                       # exact matches ...
    d2[40:60] = d1[:20]                     # ... with duplicates: tied distances
    d2[60:70, :12] *= -1
    d2[60:70, 12:] = d1[20:30, 12:]         # near matches at distance 12
    m1 = rng.random(n1) > 0.1
    m2 = rng.random(n2) > 0.1
    d1 = np.where(m1[:, None], d1, 0).astype(np.int8)
    d2 = np.where(m2[:, None], d2, 0).astype(np.int8)
    a = j_match(jnp.asarray(d1), jnp.asarray(m1), jnp.asarray(d2), jnp.asarray(m2), 0.6)
    b = t_match(torch.from_numpy(d1), torch.from_numpy(m1), torch.from_numpy(d2),
                torch.from_numpy(m2), 0.6)
    np.testing.assert_array_equal(b.idx.numpy(), np.asarray(a.idx))
    np.testing.assert_array_equal(b.distance.numpy(), np.asarray(a.distance))
    np.testing.assert_array_equal(b.valid.numpy(), np.asarray(a.valid))
    assert 0 < int(b.valid.sum()) < n1


@pytest.mark.parametrize("pattern", ["cv2", "brief"])
def test_pattern_tables_match_jax(pattern):
    for a, b in zip(jorb._pattern_tables(pattern), torb._pattern_tables(pattern)):
        np.testing.assert_array_equal(b, a)


def _j_detect_maps(imgs, threshold, edge):
    """The JAX package's per-level detection map (``orb._detect_level``):
    ``where(valid_region, _nms3(fast_score(level)), 0)``.  Its FAST is
    ``fast_score_xla``, which the JAX package's tests hold equal to the
    Pallas kernel on every production pyramid shape."""
    out = []
    for img in imgs:
        h, w = img.shape
        score, _ = jfast.fast_score_xla(img, threshold)
        valid = jnp.zeros((h, w), bool).at[edge:h - edge, edge:w - edge].set(True)
        out.append(jnp.where(valid, jorb._nms3(score), 0.0))
    return out


_j_detect = jax.jit(_j_detect_maps, static_argnums=(1, 2))


@pytest.mark.parametrize("shape", LEVEL_SHAPES)
def test_fast_levels_plain_matches_jax(shape):
    """Score, NMS and edge mask of one level, exact against compiled JAX."""
    rng = np.random.default_rng(shape[1])
    img = np.round(rng.uniform(0, 255, shape)).astype(np.float32)
    e = ORBConfig().edge_threshold
    (a,) = _j_detect([jnp.asarray(img)], 20.0, e)
    (b,) = tfast.fast_levels_plain([torch.from_numpy(img)], 20.0, e)
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert (b > 0).sum() > 0


def lock_image(h, w):
    """A rendered frame at (h, w), gray and preprocessed as the lock does."""
    tex = torch.from_numpy(make_default_texture(np.random.default_rng(0), 256))
    frame = render_frame(tex, DEFAULT_APP_PARAMS, h, w).float()
    gray = 0.114 * frame[..., 0] + 0.587 * frame[..., 1] + 0.299 * frame[..., 2]
    return preprocess_for_registration(gray).numpy()


def test_fast_levels_on_orb_levels_matches_jax():
    """All ten levels of a preprocessed frame in one call of the port (as
    ``orb_detect_and_compute`` makes it) against JAX per level, exact."""
    img = torch.from_numpy(lock_image(*LEVEL_SHAPES[0]))
    levels = [img] + [resize_bilinear(img, h, w).contiguous() for h, w in LEVEL_SHAPES[1:]]
    cfg = ORBConfig()
    a = _j_detect([jnp.asarray(x.numpy()) for x in levels], float(cfg.fast_threshold),
                  cfg.edge_threshold)
    b = tfast.fast_levels(levels, cfg.fast_threshold, cfg.edge_threshold)
    for level, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x), err_msg=f"level {level}")
    assert sum(int((y > 0).sum()) for y in b) > 100


def angle_bins(angle):
    return np.mod(np.round(angle * (torb.N_ANGLE_BINS / (2 * np.pi))).astype(np.int64),
                  torb.N_ANGLE_BINS)


@pytest.mark.parametrize("name,shape,jcfg", [
    ("small_config", (120, 160), small_config().orb),
    ("test_orb_cfg", (360, 640), ORB_CFG),
])
def test_orb_detect_and_compute_matches_jax(name, shape, jcfg):
    img = lock_image(*shape)
    j = _j_orb(jnp.asarray(img), config=jcfg)
    t = torb.orb_detect_and_compute(torch.from_numpy(img),
                                    config_from_fields(StabilizerConfig(orb=jcfg)).orb)
    jp, tp = np.asarray(j.points), t.points.numpy()
    jm, tm = np.asarray(j.mask), t.mask.numpy()
    jr, tr = np.asarray(j.response), t.response.numpy()
    jd, td = np.asarray(j.desc), t.desc.numpy()
    assert jm.sum() >= 50, f"{name}: too few keypoints to compare"

    # level 0: points, responses and mask exact
    level0 = np.asarray(j.size) == jcfg.patch_size
    np.testing.assert_array_equal(t.size.numpy() == jcfg.patch_size, level0)
    np.testing.assert_array_equal(tp[level0], jp[level0])
    np.testing.assert_array_equal(tr[level0], jr[level0])
    np.testing.assert_array_equal(tm[level0], jm[level0])

    # levels >= 1 are bilinear resizes, which the compiled JAX step rounds
    # with fused multiply-adds: responses there may differ in the last bits
    same = (jp == tp).all(1) & jm & tm
    assert same.sum() >= SAME_KEYPOINTS * max(jm.sum(), tm.sum())
    assert (jd[same] == td[same]).mean() >= SAME_BITS
    # a descriptor differs only where the keypoint's angle changed bin
    differs = (jd[same] != td[same]).any(1)
    flipped = angle_bins(np.asarray(j.angle)[same]) != angle_bins(t.angle.numpy()[same])
    assert not (differs & ~flipped).any()

