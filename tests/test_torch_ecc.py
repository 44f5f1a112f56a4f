"""PyTorch port vs the JAX package: ECC Euclidean refinement.

The cases of tests/test_ecc.py (a coarse start is refined, identity stays
identity) and a start outside the warp's ~9° envelope (12°), whose warps
take the projective gather while the estimate stays outside it.  The JAX side is compiled once
(``jax.jit``, its Pallas warp in interpret mode); the port warps with its
plain version on the CPU.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stabilization_tpu.ops.ecc import ecc_refine_euclidean as j_ecc
from video_stabilization_tpu_torch.ops import affine_warp as aw
from video_stabilization_tpu_torch.ops.ecc import ecc_refine_euclidean
from test_ecc import H, W, euclidean, sim_gray
from torch_threads import one_torch_thread  # noqa: F401

MAX_ITERS = 30     # bench config 4's ECCConfig
EPS = 1e-3         # ECCConfig.epsilon
RHO_TOL = 1e-4
# θ, tx, ty: the convergence freeze can stop one iteration apart between
# the packages, so each may differ by up to two steps below EPS
PARAM_TOL = 2 * EPS
# Measured (torch 2.13 CPU vs jax.jit on XLA:CPU): rho within 2.4e-7, θ
# within 1.5e-8 rad, tx, ty within 1.5e-5 px, valid equal in all three cases.

_j_ecc = jax.jit(j_ecc, static_argnames=("max_iters", "eps", "warp_fallback"))


def about_center(theta_deg: float, tx: float, ty: float) -> np.ndarray:
    """A rigid transform rotating by ``theta_deg`` about the image centre,
    then translating."""
    c = np.array([[1, 0, W / 2], [0, 1, H / 2], [0, 0, 1]], np.float64)
    r = euclidean(np.deg2rad(theta_deg), tx, ty).astype(np.float64)
    return (c @ r @ np.linalg.inv(c)).astype(np.float32)


@pytest.fixture(scope="module")
def ref():
    return sim_gray()


CASES = {
    # tests/test_ecc.py::test_refines_coarse_estimate
    "coarse": (euclidean(0.02, 3.0, -2.0), euclidean(0.02 + 0.008, 3.9, -1.2)),
    # tests/test_ecc.py::test_identity_stays_near_identity
    "identity": (None, np.eye(3, dtype=np.float32)),
    # a start outside the envelope: the projective gather; the estimate
    # drifts towards 10° (the zero border of a 12° warp biases rho)
    "rot12": (about_center(12.0, 1.0, -1.0), about_center(12.4, 1.6, -0.5)),
}


def params(h: np.ndarray):
    return np.array([np.arctan2(h[1, 0], h[0, 0]), h[0, 2], h[1, 2]])


@pytest.mark.parametrize("case", list(CASES))
def test_ecc_matches_jax(ref, case):
    h_true, h_init = CASES[case]
    cur = ref if h_true is None else cv2.warpPerspective(ref, h_true.astype(np.float64),
                                                         (W, H))
    j = _j_ecc(jnp.asarray(ref), jnp.asarray(cur), jnp.asarray(h_init),
               max_iters=MAX_ITERS, eps=EPS)
    fallbacks = aw.gather_fallbacks
    t = ecc_refine_euclidean(torch.from_numpy(ref), torch.from_numpy(np.ascontiguousarray(cur)),
                             torch.from_numpy(h_init), max_iters=MAX_ITERS, eps=EPS)
    # of the port's MAX_ITERS + 2 warps, at least the first iteration's and
    # the initial transform's (12.4°) take the gather at rot12
    gathered = aw.gather_fallbacks - fallbacks
    assert (gathered >= 2) if case == "rot12" else (gathered == 0)

    assert bool(t.valid) == bool(j.valid)
    assert abs(float(t.rho) - float(j.rho)) <= RHO_TOL
    np.testing.assert_allclose(params(t.h.numpy()), params(np.asarray(j.h)), atol=PARAM_TOL)
    assert bool(t.valid)
    if h_true is not None and case == "coarse":
        # and it did refine (tests/test_ecc.py's criteria)
        c = np.array([[0, 0, 1], [W, 0, 1], [W, H, 1], [0, H, 1]], float).T
        err = np.abs((t.h.double().numpy() @ c - h_true.astype(float) @ c)[:2]).mean()
        assert err < 0.3 and float(t.rho) > 0.95
        # rho_init (the port's own field) is the start's correlation, below
        assert float(t.rho_init) < float(t.rho)
    if case == "identity":
        np.testing.assert_allclose(t.h.numpy(), np.eye(3), atol=5e-2)
        assert float(t.rho) > 0.999


def test_warp_fallback_off(ref):
    """``warp_fallback=False`` (the JAX package's batched paths): inside the
    envelope the same 2-pass warps, so the same bits as with the fallback;
    outside it no warp takes the projective gather."""
    for case in ("coarse", "rot12"):
        h_true, h_init = CASES[case]
        cur = torch.from_numpy(np.ascontiguousarray(
            cv2.warpPerspective(ref, h_true.astype(np.float64), (W, H))))
        args = (torch.from_numpy(ref), cur, torch.from_numpy(h_init))
        fallbacks = aw.gather_fallbacks
        off = ecc_refine_euclidean(*args, max_iters=MAX_ITERS, eps=EPS, warp_fallback=False)
        assert aw.gather_fallbacks == fallbacks
        assert torch.isfinite(off.h).all()
        if case == "coarse":
            on = ecc_refine_euclidean(*args, max_iters=MAX_ITERS, eps=EPS)
            assert torch.equal(off.h, on.h) and torch.equal(off.rho, on.rho)
            assert bool(off.valid) and bool(on.valid)


def test_zero_reference_is_finite(ref):
    """ECC against an all-zero reference (what the lock's register side sees
    on a capture frame) returns finite values, which the lock then discards."""
    t = ecc_refine_euclidean(torch.zeros(H, W), torch.from_numpy(ref),
                             torch.from_numpy(euclidean(0.01, 1.0, -1.0)), max_iters=10)
    assert torch.isfinite(t.h).all() and torch.isfinite(t.rho)
