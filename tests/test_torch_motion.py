"""PyTorch port vs the JAX package: PRNG, homography math, similarity, RANSAC."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stabilization_tpu.config import RansacConfig, StabilizerConfig
from video_stabilization_tpu.motion import homography as jh
from video_stabilization_tpu.motion.ransac import estimate_similarity_ransac as j_ransac
from video_stabilization_tpu.motion.similarity import fit_similarity_masked as j_fit
from video_stabilization_tpu_torch.config import config_from_fields
from video_stabilization_tpu_torch.motion import homography as th
from video_stabilization_tpu_torch.motion.ransac import estimate_similarity_ransac as t_ransac
from video_stabilization_tpu_torch.motion.similarity import fit_similarity_masked as t_fit
from video_stabilization_tpu_torch.utils import prng


@pytest.mark.parametrize("seed", [0, 7, 123456789, 2**32 - 1])
def test_prng_fold_in_and_bits_bit_equal(seed):
    jkey = jax.random.key(seed)
    tkey = prng.key(seed)
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(jkey)), tkey.numpy())
    for data in (0, 1, 2, 1000, 2**31 - 1):
        jk = jax.random.fold_in(jkey, data)
        tk = prng.fold_in(tkey, data)
        np.testing.assert_array_equal(np.asarray(jax.random.key_data(jk)), tk.numpy())
        for n in (7, 256):
            jb = np.asarray(jax.random.bits(jk, (n,), jnp.uint32)).astype(np.int64)
            np.testing.assert_array_equal(jb, prng.bits(tk, n).numpy())


def test_prng_fold_in_tensor_counter():
    """The engine folds in a device counter (2n); same words as JAX."""
    tkey = prng.key(3)
    got = prng.fold_in(tkey, torch.tensor(21, dtype=torch.int32) * 2)
    want = jax.random.key_data(jax.random.fold_in(jax.random.key(3), 42))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def random_homographies(rng, n):
    hs = []
    for _ in range(n):
        th_ = rng.uniform(-0.3, 0.3)
        s = rng.uniform(0.8, 1.25)
        m = np.eye(3)
        m[:2, :2] = s * np.array([[np.cos(th_), -np.sin(th_)], [np.sin(th_), np.cos(th_)]])
        m[:2, :2] = m[:2, :2] @ np.array([[rng.uniform(0.9, 1.1), rng.uniform(-0.1, 0.1)],
                                          [0.0, 1.0]])
        m[:2, 2] = rng.uniform(-20, 20, 2)
        m[2, :2] = rng.uniform(-1e-4, 1e-4, 2)
        hs.append(m)
    return np.stack(hs).astype(np.float32)


def test_decompose_compose_remove_scale(rng):
    hs = random_homographies(rng, 16)
    hs[3] = 0.0                                        # degenerate lane
    center = np.array([160.0, 90.0], np.float32)
    jp, jv = jh.decompose_homography(jnp.asarray(hs), jnp.asarray(center))
    tp, tv = th.decompose_homography(torch.from_numpy(hs), torch.from_numpy(center))
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    for name in ("scale", "theta", "k", "delta", "t", "v"):
        np.testing.assert_allclose(np.asarray(getattr(jp, name)), getattr(tp, name).numpy(),
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(np.asarray(jh.compose_homography(jp, jnp.asarray(center))),
                               th.compose_homography(tp, torch.from_numpy(center)).numpy(),
                               atol=1e-5)
    jr, jrv = jh.remove_isotropic_scale(jnp.asarray(hs), jnp.asarray(center))
    tr, trv = th.remove_isotropic_scale(torch.from_numpy(hs), torch.from_numpy(center))
    np.testing.assert_array_equal(np.asarray(jrv), trv.numpy())
    np.testing.assert_allclose(np.asarray(jr), tr.numpy(), atol=1e-5)


def test_qr_2x2(rng):
    a = rng.uniform(-2, 2, (32, 2, 2)).astype(np.float32)
    a[0] = 0.0
    for x, y in zip(jh.qr_2x2(jnp.asarray(a)), th.qr_2x2(torch.from_numpy(a))):
        np.testing.assert_allclose(np.asarray(x), y.numpy(), atol=1e-5)


def correspondences(rng, n=200, outliers=0.3, masked=0.1):
    src = rng.uniform(0, 320, (n, 2)).astype(np.float32)
    t = np.deg2rad(1.5)
    a = 1.02 * np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]])
    dst = src @ a.T + np.array([4.0, -2.5]) + rng.normal(0, 0.3, (n, 2))
    bad = rng.uniform(size=n) < outliers
    dst[bad] += rng.uniform(-40, 40, (int(bad.sum()), 2))
    mask = rng.uniform(size=n) >= masked
    return src, dst.astype(np.float32), mask


def test_fit_similarity_masked(rng):
    src, dst, mask = correspondences(rng, outliers=0.0)
    w = mask.astype(np.float32) * rng.uniform(0.5, 1.0, mask.shape).astype(np.float32)
    jhm, jv = j_fit(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
    thm, tv = t_fit(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w))
    assert bool(jv) == bool(tv)
    jhm = np.asarray(jhm)
    np.testing.assert_allclose(jhm[:, :2], thm.numpy()[:, :2], atol=1e-5)
    # translation: measured 1.5e-5 px at 0-320 px coordinates, the f32
    # centroid sums reduce in another order (ROADMAP Queue 3)
    np.testing.assert_allclose(jhm[:, 2], thm.numpy()[:, 2], atol=2e-5)


@pytest.mark.parametrize("seed,key", [(0, 0), (1, 5), (2, 99)])
def test_ransac_same_hypotheses(seed, key):
    """Same key -> the same hypothesis stream -> the same inlier mask."""
    rng = np.random.default_rng(seed)
    src, dst, mask = correspondences(rng)
    cfg = RansacConfig(num_hypotheses=256)
    jkey = jax.random.fold_in(jax.random.key(key), 2 * seed)
    tkey = prng.fold_in(prng.key(key), 2 * seed)
    jr = j_ransac(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask), jkey, cfg)
    tr = t_ransac(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(mask),
                  tkey, config_from_fields(StabilizerConfig(ransac=cfg)).ransac)
    assert bool(jr.valid) and bool(tr.valid)
    np.testing.assert_array_equal(np.asarray(jr.inliers), tr.inliers.numpy())
    assert int(jr.num_inliers) == int(tr.num_inliers)
    np.testing.assert_allclose(np.asarray(jr.h), tr.h.numpy(), atol=1e-4)


def test_ransac_too_few_points_is_identity(rng):
    src, dst, _ = correspondences(rng, n=40)
    mask = np.zeros(40, bool)
    mask[:5] = True
    tr = t_ransac(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(mask),
                  prng.key(0))
    assert not bool(tr.valid)
    np.testing.assert_array_equal(tr.h.numpy(), np.eye(3, dtype=np.float32))
