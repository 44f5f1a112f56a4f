"""Bit-exact replica of ``cv2.estimateAffinePartial2D``'s RANSAC (numpy).

The port's own copy of ``video_stabilization_tpu/motion/cv2_ransac.py``
(the port imports nothing of the JAX package): OpenCV's multiply-with-carry
``cv::RNG`` seeded with ``(uint64)-1``, ``getSubset``'s two distinct draws
with rejection, the double-precision 2-point similarity kernel, float32
``findInliers``, the adaptive ``RANSACUpdateNumIters`` bound (confidence
0.99) and the Levenberg-Marquardt polish on the inlier set.  It runs on the
host: the reference-compat referee injects it between the track prefix and
the step (``engine/stabilizer.py::Stabilizer``, ``make_track_fn``,
``make_step_ext_fn``).  ``tests/test_torch_referee.py`` holds it equal to
the JAX package's copy with ``np.array_equal``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

_CV_RNG_COEFF = np.uint64(4164903690)
_RNG_SEED = np.uint64(0xFFFFFFFFFFFFFFFF)     # RNG rng((uint64)-1)
_U32 = np.uint64(0xFFFFFFFF)


class CvRNG:
    """cv::RNG (multiply-with-carry), 64-bit state."""

    def __init__(self, state: int = int(_RNG_SEED)):
        self.state = np.uint64(state) if state else np.uint64(0xFFFFFFFF)

    def next(self) -> int:
        s = self.state
        lo = s & _U32
        self.state = lo * _CV_RNG_COEFF + (s >> np.uint64(32))
        return int(self.state & _U32)

    def uniform_int(self, a: int, b: int) -> int:
        """cv::RNG::uniform(int a, int b) = a + next() % (b - a)."""
        if a == b:
            return a
        return a + self.next() % (b - a)


def _run_kernel_2pt(p1, p2, q1, q2) -> Optional[np.ndarray]:
    """AffinePartial2DEstimatorCallback::runKernel — closed-form similarity
    from 2 point pairs, double precision.  The fp expression ORDER matches
    OpenCV's (ptsetreg.cpp) so inlier decisions at the threshold boundary
    agree bit-for-bit.  Returns 2x3 [S0,-S1,S2; S1,S0,S3]."""
    x1, y1 = float(p1[0]), float(p1[1])
    x2, y2 = float(p2[0]), float(p2[1])
    X1, Y1 = float(q1[0]), float(q1[1])
    X2, Y2 = float(q2[0]), float(q2[1])
    denom = (x1 - x2) * (x1 - x2) + (y1 - y2) * (y1 - y2)
    if denom == 0.0:
        return None
    d = 1.0 / denom
    s0 = d * ((X1 - X2) * (x1 - x2) + (Y1 - Y2) * (y1 - y2))
    s1 = d * ((Y1 - Y2) * (x1 - x2) - (X1 - X2) * (y1 - y2))
    s2 = d * ((Y1 - Y2) * (x1 * y2 - x2 * y1)
              - (X1 * y2 - X2 * y1) * (y1 - y2)
              - (X1 * x2 - X2 * x1) * (x1 - x2))
    s3 = d * (-(X1 - X2) * (x1 * y2 - x2 * y1)
              - (Y1 * x2 - Y2 * x1) * (x1 - x2)
              - (Y1 * y2 - Y2 * y1) * (y1 - y2))
    return np.array([[s0, -s1, s2], [s1, s0, s3]], np.float64)


def _find_inliers(src32, dst32, model, thresh) -> Tuple[np.ndarray, int]:
    """findInliers: per-point squared reprojection error computed in DOUBLE
    (Affine2DEstimatorCallback::computeError), cast to float32, compared
    against float32 thresh² — exactly OpenCV's arithmetic."""
    m = model                                        # float64
    s = src32.astype(np.float64)
    a = m[0, 0] * s[:, 0] + m[0, 1] * s[:, 1] + m[0, 2] - dst32[:, 0].astype(np.float64)
    b = m[1, 0] * s[:, 0] + m[1, 1] * s[:, 1] + m[1, 2] - dst32[:, 1].astype(np.float64)
    err = (a * a + b * b).astype(np.float32)
    t = np.float32(thresh * thresh)
    mask = err <= t
    return mask, int(mask.sum())


def ransac_update_num_iters(p: float, ep: float, model_points: int,
                            max_iters: int) -> int:
    """cv::RANSACUpdateNumIters."""
    p = min(max(p, 0.0), 1.0)
    ep = min(max(ep, 0.0), 1.0)
    num = max(1.0 - p, np.finfo(np.float64).tiny)
    denom = 1.0 - (1.0 - ep) ** model_points
    if denom < np.finfo(np.float64).tiny:
        return 0
    num = np.log(num)
    denom = np.log(denom)
    if denom >= 0 or -num >= max_iters * (-denom):
        return max_iters
    return int(round(num / denom))


def _get_subset(rng: CvRNG, count: int, max_attempts: int = 10000):
    """RANSACPointSetRegistrator::getSubset for modelPoints=2.

    Draws 2 distinct indices; the AffinePartial callback has no effective
    checkSubset constraint for 2 points (haveCollinearPoints needs triples).
    """
    idx = [0, 0]
    for _ in range(max_attempts):
        ok = True
        for i in range(2):
            while True:
                v = rng.uniform_int(0, count)
                if all(v != idx[j] for j in range(i)):
                    idx[i] = v
                    break
        if ok:
            return idx
    return None


def _lm_compute(src64, dst64, par, want_jac):
    """AffinePartial2DRefineCallback::compute — residuals (2N,) and
    jacobian (2N, 4) in double, params (a, b, tx, ty)."""
    a, b, tx, ty = par
    x = src64[:, 0]
    y = src64[:, 1]
    rx = (a * x - b * y + tx) - dst64[:, 0]
    ry = (b * x + a * y + ty) - dst64[:, 1]
    r = np.empty(2 * len(x))
    r[0::2] = rx
    r[1::2] = ry
    if not want_jac:
        return r, None
    j = np.zeros((2 * len(x), 4))
    j[0::2, 0] = x
    j[0::2, 1] = -y
    j[0::2, 2] = 1.0
    j[1::2, 0] = y
    j[1::2, 1] = x
    j[1::2, 3] = 1.0
    return r, j


def _lm_refine(src64, dst64, model, refine_iters: int) -> np.ndarray:
    """cv::LMSolver polish of (a, b, tx, ty) on the inlier set —
    a faithful replica of levmarq.cpp's LMSolverImpl::run: trust-ratio
    lambda schedule (Rlo=0.25/Rhi=0.75, lambda=1, lc=0.75 start),
    termination on ``|d|_inf < epsx`` / ``|r|_inf < epsf`` with
    epsx = epsf = FLT_EPSILON, maxIters = refineIters.  Agreement with
    cv2 is ~1e-9 absolute (validated in tests/test_cv2_ransac.py; the
    residual is DECOMP_EIG-vs-LU solver rounding, both within epsx of
    the same optimum)."""
    epsx = epsf = float(np.finfo(np.float32).eps)
    x = np.array([model[0, 0], model[1, 0], model[0, 2], model[1, 2]])
    r, jac = _lm_compute(src64, dst64, x, True)
    s = float(r @ r)
    a_mat = jac.T @ jac
    v = jac.T @ r
    d_diag = np.diag(a_mat).copy()
    rlo, rhi = 0.25, 0.75
    lam, lc = 1.0, 0.75
    it = 0
    while True:
        ap = a_mat + lam * np.diag(d_diag)
        try:
            d = np.linalg.solve(ap, v)
        except np.linalg.LinAlgError:
            break
        xd = x - d
        rd, _ = _lm_compute(src64, dst64, xd, False)
        sd = float(rd @ rd)
        temp_d = a_mat @ d * -1.0 + 2.0 * v
        ds = float(d @ temp_d)
        ratio = (s - sd) / (ds if abs(ds) > np.finfo(np.float64).eps else 1.0)
        if sd < s:
            s = sd
            x = xd
            r, jac = _lm_compute(src64, dst64, x, True)
            a_mat = jac.T @ jac
            v = jac.T @ r
        it += 1
        proceed = (it < refine_iters
                   and np.abs(d).max() >= epsx
                   and np.abs(r).max() >= epsf)
        if ratio > rhi:
            lam *= 0.5
            if lam < lc:
                lam = 0.0
        elif ratio < rlo:
            t = float(d @ v)
            nu = (sd - s) / (t if abs(t) > np.finfo(np.float64).eps else 1.0) + 2.0
            nu = min(max(nu, 2.0), 10.0)
            if lam == 0.0:
                ainv = np.linalg.pinv(a_mat)
                maxval = max(np.abs(np.diag(ainv)).max(),
                             np.finfo(np.float64).eps)
                lam = lc = 1.0 / maxval
                nu *= 0.5
            lam *= nu
        if not proceed:
            break
    return np.array([[x[0], -x[1], x[2]],
                     [x[1], x[0], x[3]]], np.float64)


def estimate_affine_partial_2d_cv2(
    src: np.ndarray,
    dst: np.ndarray,
    ransac_reproj_threshold: float = 3.0,
    max_iters: int = 2000,
    confidence: float = 0.99,
    refine_iters: int = 10,
) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """numpy replica of cv2.estimateAffinePartial2D(method=RANSAC).

    Returns (2x3 float64 model or None, (N,) uint8 inlier mask).
    """
    src32 = np.ascontiguousarray(src, np.float32).reshape(-1, 2)
    dst32 = np.ascontiguousarray(dst, np.float32).reshape(-1, 2)
    count = len(src32)
    model_points = 2
    mask = np.zeros(count, np.uint8)
    if count < model_points:
        return None, mask

    if count == model_points:
        m = _run_kernel_2pt(src32[0], src32[1], dst32[0], dst32[1])
        if m is None:
            return None, mask
        mask[:] = 1
        return m, mask

    rng = CvRNG()
    niters = max(max_iters, 1)
    best_model = None
    best_mask = np.zeros(count, bool)
    max_good = 0

    it = 0
    while it < niters:
        idx = _get_subset(rng, count)
        if idx is None:
            if it == 0:
                return None, mask
            break
        m = _run_kernel_2pt(src32[idx[0]], src32[idx[1]],
                            dst32[idx[0]], dst32[idx[1]])
        if m is None:
            it += 1
            continue
        good_mask, good = _find_inliers(src32, dst32, m,
                                        ransac_reproj_threshold)
        if good > max(max_good, model_points - 1):
            best_model = m
            best_mask = good_mask
            max_good = good
            niters = ransac_update_num_iters(
                confidence, (count - good) / count, model_points, niters)
        it += 1

    if best_model is None or max_good < model_points:
        return None, mask

    mask = best_mask.astype(np.uint8)
    if count > model_points and refine_iters > 0 and max_good > 0:
        src_in = src32[best_mask].astype(np.float64)
        dst_in = dst32[best_mask].astype(np.float64)
        best_model = _lm_refine(src_in, dst_in, best_model, refine_iters)
    return best_model, mask


def estimate_rigid_cv2_host(
    src: np.ndarray,
    dst: np.ndarray,
    status: np.ndarray,
    center: Tuple[float, float],
    min_points: int = 10,
    ransac_reproj_threshold: float = 3.0,
) -> Tuple[np.ndarray, bool, int]:
    """Host-side estimateMotion replica for the engine's cv2exact path.

    Compacts the fixed-capacity masked lanes exactly the way the reference
    filters tracked points (src/stabilizer.cpp:203-208: status==1 pairs, lane
    order preserved), enforces MIN_POINTS_FOR_MOTION_ESTIMATION (:215-216),
    runs the bit-exact estimateAffinePartial2D replica, then kills the
    isotropic scale about ``center`` in float64 (:261-267 — s=1 recompose;
    for a similarity the decompose/compose round trip reduces to A/s with a
    translation re-centering).  Returns ``(H_rigid 3x3 float64, valid,
    n_inliers)``; H is identity when invalid.
    """
    st = np.asarray(status, bool).reshape(-1)
    s = np.asarray(src, np.float32).reshape(-1, 2)[st]
    d = np.asarray(dst, np.float32).reshape(-1, 2)[st]
    eye = np.eye(3, dtype=np.float64)
    if len(s) < min_points:
        return eye, False, 0
    m, mask = estimate_affine_partial_2d_cv2(
        s, d, ransac_reproj_threshold=ransac_reproj_threshold)
    if m is None or not np.isfinite(m).all():
        return eye, False, 0
    a = m[:, :2]
    scale = np.sqrt(max(np.linalg.det(a), 1e-9))
    r = a / scale
    c = np.asarray(center, np.float64)
    t = m[:, 2] + (np.eye(2) - a) @ c - (np.eye(2) - r) @ c
    h = eye.copy()
    h[:2, :2] = r
    h[:2, 2] = t
    return h, True, int(mask.sum())
