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
from torch_threads import one_torch_thread  # noqa: F401


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


# f32 epsilons per unit of term size that ``t`` may be off float64: measured
# at most 0.42 (jax.jit) and 0.59 (port) for t on this test's inputs, 0.16
# and 0.35 for the rigid translation
T_ULPS = 4.0


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


def assert_near_float64(side: str, got, want64, terms) -> None:
    """``got`` (f32) within ``T_ULPS`` f32 epsilons of ``terms`` of the
    float64 value, element by element."""
    err = np.abs(np.asarray(got, np.float64) - want64)
    bound = T_ULPS * np.finfo(np.float32).eps * terms
    assert (err <= bound).all(), (f"{side}: off float64 by {err.max():.3g}, "
                                  f"{(err / bound).max():.3f} of the bound")


def test_decompose_compose_remove_scale(rng):
    """Both packages against each other (the compiled JAX functions), and
    their translations against float64.

    ``t = t⁺ − (I − sR)c`` subtracts f32 terms of size |c| ≈ 183 (c = (160,
    90)), whose rounding (ulp(160) = 1.5e-5) exceeds 1e-5, and XLA:CPU
    contracts the product differently under ``jax.jit`` and eagerly (2.7e-5
    apart here).  So ``t``, and the translation column of the rigid
    transform (which composes ``t + (I − R)c`` on top), are held to the
    float64 result of the same f32 inputs within ``T_ULPS`` f32 epsilons of
    the size of their terms per element: |t⁺| + (1 + ‖sR‖)·‖c‖ with ‖sR‖ =
    s, plus |t| + 2‖c‖ for the rigid one (ROADMAP Queue 3).  Everything else
    stays at 1e-5, compose on the same parameters in both packages."""
    hs = random_homographies(rng, 16)
    hs[3] = 0.0                                        # degenerate lane
    center = np.array([160.0, 90.0], np.float32)
    jc = jnp.asarray(center)
    tc = torch.from_numpy(center)
    jp, jv = jax.jit(jh.decompose_homography)(jnp.asarray(hs), jc)
    tp, tv = th.decompose_homography(torch.from_numpy(hs), tc)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    for name in ("scale", "theta", "k", "delta", "v"):
        np.testing.assert_allclose(np.asarray(getattr(jp, name)), getattr(tp, name).numpy(),
                                   atol=1e-5, err_msg=name)

    dp, dv = th.decompose_homography(torch.from_numpy(hs).double(), tc.double())
    np.testing.assert_array_equal(dv.numpy(), tv.numpy())
    h33 = np.where(np.abs(hs[:, 2, 2]) > 1e-9, hs[:, 2, 2], 1.0).astype(np.float64)
    t_plus = np.abs(hs[:, 0:2, 2] / h33[:, None])
    norm_c = float(np.linalg.norm(center))
    terms = t_plus + (1.0 + dp.scale.numpy()[:, None]) * norm_c
    t64 = dp.t.numpy()
    assert_near_float64("jax.jit t", jp.t, t64, terms)
    assert_near_float64("port t", tp.t, t64, terms)

    same = th.HomographyParams(*(torch.from_numpy(np.array(x)) for x in jp))
    np.testing.assert_allclose(np.asarray(jax.jit(jh.compose_homography)(jp, jc)),
                               th.compose_homography(same, tc).numpy(), atol=1e-5)

    jr, jrv = jax.jit(jh.remove_isotropic_scale)(jnp.asarray(hs), jc)
    tr, trv = th.remove_isotropic_scale(torch.from_numpy(hs), tc)
    np.testing.assert_array_equal(np.asarray(jrv), trv.numpy())
    jr, tr = np.asarray(jr), tr.numpy()
    np.testing.assert_allclose(jr[:, :, :2], tr[:, :, :2], atol=1e-5)
    np.testing.assert_allclose(jr[:, 2], tr[:, 2], atol=1e-5)
    r64 = th.remove_isotropic_scale(torch.from_numpy(hs).double(), tc.double())[0].numpy()
    rigid_terms = terms + np.abs(t64) + 2.0 * norm_c
    assert_near_float64("jax.jit rigid translation", jr[:, :2, 2], r64[:, :2, 2], rigid_terms)
    assert_near_float64("port rigid translation", tr[:, :2, 2], r64[:, :2, 2], rigid_terms)


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
