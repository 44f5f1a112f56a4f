"""The port's offline chunked pipeline (engine/offline.py) against the JAX
package's ``make_offline_fn`` and against the port's own streaming step.

The streaming step is held to the JAX package's in tests/test_torch_engine.py;
these tests mirror tests/test_offline.py case for case on the port, hold two
cases to the JAX offline function directly (compiled once each), and add the
ring-window case where the JAX offline function goes wrong (ROADMAP Queue 3),
the batched ops against their per-frame calls, and the warp arguments of
each offline mode.
"""

import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stabilization_tpu.config import ECCConfig, StabilizationMode
from video_stabilization_tpu.engine import init_carry as j_init_carry
from video_stabilization_tpu.engine import make_offline_fn as j_make_offline_fn
from video_stabilization_tpu_torch.config import config_from_fields
from video_stabilization_tpu_torch.engine import (
    Stabilizer, carry_from_numpy, init_carry, make_offline_fn, offline_chunk_step,
    stabilize_clip_offline)
from video_stabilization_tpu_torch.engine import lock as t_lock
from video_stabilization_tpu_torch.engine import offline as t_offline
from video_stabilization_tpu_torch.sim import (
    DEFAULT_APP_PARAMS, make_default_texture, render_frame, shake_trajectory)
from video_stabilization_tpu_torch.motion.ransac import estimate_similarity_ransac
from video_stabilization_tpu_torch.ops import lk_dense as t_lk_dense
from video_stabilization_tpu_torch.ops.gftt import good_features_to_track
from video_stabilization_tpu_torch.utils import prng
from test_engine import FH, FW, small_config
from test_offline import _assert_frames_close
from test_torch_engine import jax_carry_arrays
from torch_threads import one_torch_thread  # noqa: F401

M = StabilizationMode
SEED = 7


@pytest.fixture(scope="module")
def footage():
    """17 shaky frames of the small configuration's size, rendered by the
    port's simulator (both packages take the same uint8 frames)."""
    rng = np.random.default_rng(5)
    tex = torch.from_numpy(make_default_texture(rng, 256))
    n = 17
    traj = shake_trajectory(rng.standard_normal((n, 3)), rng.standard_normal(n),
                            DEFAULT_APP_PARAMS, pos_amplitude=0.004, roll_amplitude=0.3)
    return np.stack([render_frame(tex, traj[i], FH, FW).numpy() for i in range(n)])


def pinned(cfg, mode):
    return dataclasses.replace(cfg, static_mode=int(mode))


def streaming(cfg, mode, frames, carry=None):
    """The port's streaming step frame by frame: (carry, outputs)."""
    s = Stabilizer(config_from_fields(cfg), mode, seed=SEED, device="cpu")
    if carry is not None:
        s.carry = carry
    outs = s.stabilize_clip(frames).numpy()
    return s.carry, outs


def offline(cfg, mode, frames, chunk, carry=None):
    tcfg = config_from_fields(pinned(cfg, mode))
    if carry is None:
        carry = init_carry(tcfg, int(mode), prng.key(SEED), "cpu")
    c, outs = stabilize_clip_offline(carry, frames, tcfg, chunk)
    return c, outs.numpy()


def j_offline(cfg, mode, frames, chunk, carry=None):
    cfg = pinned(cfg, mode)
    step = j_make_offline_fn(cfg)
    if carry is None:
        carry = j_init_carry(cfg, int(mode), jax.random.key(SEED))
    outs = []
    for i in range(0, len(frames), chunk):
        carry, (out, _) = step(carry, jnp.asarray(frames[i:i + chunk]))
        outs.append(np.asarray(out))
    return carry, np.concatenate(outs)


def t(x):
    return x.numpy()


def assert_frames_close_gather(a, b):
    """u8 outputs of the projective gather: at most 2% of pixels differ, at
    most 0.1% by more than one level.  The gather's in-bounds test flips a
    border pixel between border colour and content when the transform
    differs in its last bits (measured: 1 of 76,800 pixels of one frame)."""
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    assert (diff > 0).mean() <= 0.02, f"{(diff > 0).mean():.4f} of pixels differ"
    assert (diff > 1).mean() <= 0.001, f"{(diff > 1).mean():.5f} of pixels differ by > 1"


def assert_carries_close(a, b, jax_side=False):
    """Offline carry ``a`` (port) against ``b`` (port, or JAX with
    ``jax_side``): the tolerances of tests/test_offline.py."""
    get = (lambda x: np.asarray(x)) if jax_side else t
    for name in ("transforms", "last_h", "accum_h"):
        np.testing.assert_allclose(t(getattr(a, name)), get(getattr(b, name)), atol=1e-4,
                                   err_msg=name)
    np.testing.assert_array_equal(t(a.tvalid), get(b.tvalid))
    np.testing.assert_allclose(t(a.corners_prev), get(b.corners_prev), atol=1e-3)
    assert int(a.n) == int(b.n)


# -- held against the JAX package's offline function --------------------------

def test_offline_matches_jax_offline(footage):
    """GLOBAL_SMOOTHING, K = 4 over 8 frames: the port's chunks against the
    JAX package's ``make_offline_fn``."""
    cfg = small_config(past=6, future=3)
    mode = M.GLOBAL_SMOOTHING
    c_j, outs_j = j_offline(cfg, mode, footage[:8], 4)
    c_t, outs_t = offline(cfg, mode, footage[:8], 4)
    _assert_frames_close(outs_t, outs_j)
    assert_carries_close(c_t, c_j, jax_side=True)


def rotated_carry(cfg, mode):
    """A JAX carry 8 frames in whose accumulated lock is rotated 25° past the
    warp's ~9° envelope (tests/test_offline.py's telemetry case, one stream)."""
    th = np.deg2rad(25.0)
    big_rot = np.array([[np.cos(th), -np.sin(th), 0.0], [np.sin(th), np.cos(th), 0.0],
                        [0.0, 0.0, 1.0]], np.float32)
    carry = j_init_carry(pinned(cfg, mode), int(mode), jax.random.key(0))
    return carry._replace(accum_h=jnp.asarray(big_rot), accum_active=jnp.ones((), bool),
                          n=jnp.asarray(8, jnp.int32))


def test_envelope_violation_telemetry(footage):
    """ACCUMULATED_FULL_LOCK beyond the envelope, K = 4: the port's output
    warp takes the per-frame projective fallback, as the JAX offline
    function's ``lax.map`` branch does, and counts each frame as a
    violation.  With ``warp_projective_fallback=False`` it runs the 2-pass
    warp beyond the envelope, as the port's streaming step then does.  The
    window is 3 + 1 + 1: with the JAX test's past 2, K = 4 reaches the JAX
    offline function's ring fault (ROADMAP Queue 3)."""
    mode = M.ACCUMULATED_FULL_LOCK
    cfg = small_config(past=3, future=1)
    jc = rotated_carry(cfg, mode)
    arrays = jax_carry_arrays(jc)
    c_j, outs_j = j_offline(cfg, mode, footage[:4], 4, carry=jc)
    c_t, outs_t = offline(cfg, mode, footage[:4], 4, carry=carry_from_numpy(arrays, "cpu"))
    assert_frames_close_gather(outs_t, outs_j)
    assert int(c_t.envelope_violations) == int(c_j.envelope_violations) >= 4
    np.testing.assert_allclose(t(c_t.accum_h), np.asarray(c_j.accum_h), atol=1e-4)

    cfg_2pass = dataclasses.replace(cfg, warp_projective_fallback=False)
    c_o, outs_o = offline(cfg_2pass, mode, footage[:4], 4,
                          carry=carry_from_numpy(arrays, "cpu"))
    c_s, outs_s = streaming(cfg_2pass, mode, footage[:4], carry=carry_from_numpy(arrays, "cpu"))
    _assert_frames_close(outs_o, outs_s)
    assert int(c_o.envelope_violations) == int(c_s.envelope_violations) >= 4
    # the 2-pass result beyond the envelope is not the projective one
    assert np.abs(outs_o.astype(int) - outs_t.astype(int)).max() > 1


# -- held against the port's streaming step (tests/test_offline.py) ------------

@pytest.mark.parametrize("mode,chunk", [
    (M.GLOBAL_SMOOTHING, 5),
    (M.ACCUMULATED_FULL_LOCK, 6),
    (M.TRANSLATION_LOCK, 4),
])
def test_offline_matches_streaming(footage, mode, chunk):
    cfg = small_config(past=6, future=3)
    n = 17   # not a chunk multiple: the trailing partial chunk
    c_s, outs_s = streaming(cfg, mode, footage[:n])
    c_o, outs_o = offline(cfg, mode, footage[:n], chunk)
    _assert_frames_close(outs_o, outs_s)
    assert_carries_close(c_o, c_s)


def assert_lock_close(c_o, c_s, ref_of: str):
    """The registration-lock criteria of tests/test_offline.py: lock corner
    displacement under 0.5 px, the same captured reference points."""
    ha, hb = t(c_o.last_h).astype(float), t(c_s.last_h).astype(float)
    corners = np.array([[0, 0, 1], [FW, 0, 1], [FW, FH, 1], [0, FH, 1]], float).T
    pa = (ha @ corners)[:2] / (ha @ corners)[2]
    pb = (hb @ corners)[:2] / (hb @ corners)[2]
    assert np.abs(pa - pb).max() < 0.5, f"lock corner mismatch\n{ha}\n{hb}"
    ra, rb = getattr(c_o, ref_of), getattr(c_s, ref_of)
    assert bool(ra.is_set) and bool(rb.is_set)
    np.testing.assert_allclose(t(ra.points), t(rb.points), atol=1e-3)


def test_offline_orb_lock_matches_streaming(footage):
    cfg = small_config(past=4, future=2)
    mode = M.ORB_FULL_LOCK
    c_s, _ = streaming(cfg, mode, footage[:10])
    c_o, _ = offline(cfg, mode, footage[:10], 4)
    assert_lock_close(c_o, c_s, "orb_ref")


def test_offline_sift_ecc_lock_matches_streaming(footage):
    """The SIFT lock refined by ECC: offline ECC warps without the
    projective fallback, streaming ECC with it; inside the envelope both
    give the 2-pass result."""
    cfg = dataclasses.replace(small_config(past=4, future=2),
                              ecc=ECCConfig(enabled=True, max_iters=5))
    mode = M.SIFT_FULL_LOCK
    c_s, outs_s = streaming(cfg, mode, footage[:8])
    c_o, outs_o = offline(cfg, mode, footage[:8], 4)
    assert_lock_close(c_o, c_s, "sift_ref")
    assert int(c_o.last_lock_matches) == int(c_s.last_lock_matches) >= 10
    _assert_frames_close(outs_o, outs_s)


def test_offline_requires_static_mode(footage):
    cfg = config_from_fields(small_config())
    carry = init_carry(cfg, 0, prng.key(0), "cpu")
    with pytest.raises(ValueError, match="requires config.static_mode"):
        stabilize_clip_offline(carry, footage[:4], cfg)


def test_offline_chunk_exceeding_window_raises(footage):
    cfg = config_from_fields(pinned(small_config(past=2, future=1), M.GLOBAL_SMOOTHING))
    carry = init_carry(cfg, 0, prng.key(0), "cpu")
    with pytest.raises(ValueError, match="chunk size 6 exceeds temporal window 4"):
        make_offline_fn(cfg)(carry, torch.from_numpy(footage[:6]))


def test_chunk_of_one_equals_streaming(footage):
    """K = 1 takes the streaming step's ``fold_in`` keys frame for frame:
    outputs and carry equal bit for bit."""
    cfg = small_config(past=4, future=2)
    mode = M.GLOBAL_SMOOTHING
    c_s, outs_s = streaming(cfg, mode, footage[:8])
    c_o, outs_o = offline(cfg, mode, footage[:8], 1)
    np.testing.assert_array_equal(outs_o, outs_s)
    for name in ("transforms", "last_h", "corners_prev", "last_inliers", "key"):
        np.testing.assert_array_equal(t(getattr(c_o, name)), t(getattr(c_s, name)), name)


def test_chunk_of_the_whole_window_matches_streaming(footage):
    """W = 4 (past 2, future 1) and K = 4: presentation frames 1 and 2 of
    the second chunk precede the chunk, and frames of the chunk itself
    reuse their ring slots.  The JAX offline function reads all four from
    the ring after the chunk's write and gets 24.6% of frame 4's pixels
    wrong (ROADMAP Queue 3); the port takes them from before the write."""
    cfg = small_config(past=2, future=1)
    mode = M.GLOBAL_SMOOTHING
    c_s, outs_s = streaming(cfg, mode, footage[:8])
    c_o, outs_o = offline(cfg, mode, footage[:8], 4)
    _assert_frames_close(outs_o, outs_s)
    assert_carries_close(c_o, c_s)
    np.testing.assert_array_equal(t(c_o.frames), t(c_s.frames))


# -- batched ops against their per-frame calls ---------------------------------

def test_batched_gftt_matches_per_frame(footage):
    """One GFTT call on K = 4 working images equals four calls: the quality
    threshold and the top-k are per image (corner lists bit for bit)."""
    from video_stabilization_tpu_torch.ops.image import bgr_to_gray, resize_bilinear

    cfg = config_from_fields(small_config())
    grays = bgr_to_gray(resize_bilinear(torch.from_numpy(footage[:4]).float(),
                                        *cfg.working_size))
    grays[2] *= 0.25                # another dynamic range: another threshold
    batched = good_features_to_track(grays, cfg.gftt)
    assert batched.points.shape == (4, cfg.gftt.max_features, 2)
    for j in range(4):
        one = good_features_to_track(grays[j], cfg.gftt)
        for name in ("points", "response", "mask"):
            assert torch.equal(getattr(batched, name)[j], getattr(one, name)), (j, name)


def test_batched_ransac_matches_per_frame():
    """One RANSAC call over K = 4 problems with their own keys equals four
    calls: hypothesis indices (so inlier masks and counts) exact, ``h`` to
    1e-6."""
    rng = np.random.default_rng(3)
    cfg = config_from_fields(small_config()).ransac
    n = 200
    src = rng.uniform(0, 320, (4, n, 2)).astype(np.float32)
    dst = np.empty_like(src)
    for j, (th, tx, ty) in enumerate([(0.02, 3, -2), (-0.05, -1, 4), (0.0, 0.5, 0.5),
                                      (0.1, 8, 1)]):
        r = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]], np.float32)
        dst[j] = src[j] @ r.T + np.float32([tx, ty])
    dst += rng.normal(0, 0.3, dst.shape).astype(np.float32)
    dst[:, :40] = rng.uniform(0, 320, (4, 40, 2))           # outliers
    mask = rng.uniform(size=(4, n)) > 0.2
    mask[3, 12:] = False                                    # too few: invalid
    keys = prng.fold_in(prng.key(9), torch.arange(4) * 2)   # (4, 2)
    src_t, dst_t, mask_t = (torch.from_numpy(x) for x in (src, dst, mask))
    batched = estimate_similarity_ransac(src_t, dst_t, mask_t, keys, cfg)
    assert batched.h.shape == (4, 3, 3)
    for j in range(4):
        one = estimate_similarity_ransac(src_t[j], dst_t[j], mask_t[j], keys[j], cfg)
        assert torch.equal(batched.inliers[j], one.inliers), j
        assert int(batched.num_inliers[j]) == int(one.num_inliers), j
        assert bool(batched.valid[j]) == bool(one.valid), j
        np.testing.assert_allclose(t(batched.h[j]), t(one.h), atol=1e-6)
    assert batched.valid.tolist() == [True, True, True, False]
    assert torch.equal(prng.bits(keys, 16)[2], prng.bits(keys[2], 16))


# -- warp arguments of each offline mode ---------------------------------------

WARP_CASES = {
    "smoothing": (M.GLOBAL_SMOOTHING, True, False),
    "translation": (M.TRANSLATION_LOCK, True, False),
    "accumulated": (M.ACCUMULATED_FULL_LOCK, True, True),
    "rotation": (M.ROTATION_LOCK, True, True),
    "accumulated_no_fallback": (M.ACCUMULATED_FULL_LOCK, False, False),
    "orb": (M.ORB_FULL_LOCK, True, True),
    "sift_ecc": (M.SIFT_FULL_LOCK, True, True),
}


@pytest.mark.parametrize("case", list(WARP_CASES))
def test_offline_warp_arguments(footage, case):
    """The arguments each offline mode passes, as the JAX offline path
    does: LK's warps and ECC without the fallback; the output warp without
    it in the bounded modes and with ``warp_projective_fallback`` in the
    others.  One chunk of two frames: four LK warps and one output warp,
    each over the chunk's batch, and ECC per frame."""
    mode, wpf, want_output = WARP_CASES[case]
    cfg = dataclasses.replace(small_config(past=2, future=1), warp_projective_fallback=wpf,
                              ecc=ECCConfig(enabled=mode == M.SIFT_FULL_LOCK, max_iters=2))
    seen = {"output": [], "lk": [], "ecc": []}

    def recorder(key, fn, arg):
        def wrapped(*a, **kw):
            seen[key].append(kw[arg])
            return fn(*a, **kw)
        return wrapped

    with mock.patch.object(t_offline, "warp_affine",
                           recorder("output", t_offline.warp_affine, "projective_fallback")), \
            mock.patch.object(t_lk_dense, "warp_affine",
                              recorder("lk", t_lk_dense.warp_affine, "projective_fallback")), \
            mock.patch.object(t_lock, "ecc_refine_euclidean",
                              recorder("ecc", t_lock.ecc_refine_euclidean, "warp_fallback")):
        offline(cfg, mode, footage[:2], 2)
    assert seen["output"] == [want_output]
    assert seen["lk"] == [False] * 4
    assert seen["ecc"] == ([False] * 2 if mode == M.SIFT_FULL_LOCK else [])


# form: (LK's warp_fallback, the output warp's projective_fallback in
# GLOBAL_SMOOTHING and in ORB_FULL_LOCK, ECC's warp_fallback), with both of
# the config's fallbacks on: each form's JAX function's own arguments
FORM_ARGUMENTS = {
    "step": (True, (True, True), True),
    "batched": (False, (False, True), True),
    "batched_mixed": (False, (True, True), True),
    "offline": (False, (False, True), False),
    "offline_batched": (False, (False, False), False),
    "chunk": (True, (False, True), False),
}


def run_form(form, mode, frames):
    """Two frames of one stream in ``mode`` through ``form``'s entry point,
    with ECC on."""
    from video_stabilization_tpu_torch.engine import make_offline_batched_fn
    from video_stabilization_tpu_torch.parallel import init_batched_carry, make_batched_step_fn

    cfg = config_from_fields(dataclasses.replace(small_config(past=2, future=1),
                                                 ecc=ECCConfig(enabled=True, max_iters=2)))
    tcfg = dataclasses.replace(cfg, static_mode=int(mode))
    frames = torch.from_numpy(frames[:2])
    if form == "step":
        stab = Stabilizer(cfg, mode, device="cpu")
        for f in frames:
            stab.stabilize_frame(f)
    elif form in ("batched", "batched_mixed"):
        step = make_batched_step_fn(tcfg if form == "batched" else cfg)
        carry = init_batched_carry(cfg, 1, int(mode), prng.key(SEED), "cpu")
        for f in frames:
            carry, _ = step(carry, f[None])
    elif form == "offline_batched":
        make_offline_batched_fn(tcfg)(init_batched_carry(cfg, 1, int(mode), prng.key(SEED),
                                                         "cpu"), frames[None])
    else:
        fn = make_offline_fn(tcfg) if form == "offline" else functools.partial(
            offline_chunk_step, config=tcfg)
        fn(init_carry(tcfg, int(mode), prng.key(SEED), "cpu"), frames)


@pytest.mark.parametrize("form", list(FORM_ARGUMENTS))
def test_form_warp_arguments(footage, form):
    """Each row of ``engine/offline.py::FORMS``, through its entry point in
    a bounded mode and in a registration lock: the ``warp_fallback`` of
    LK's warps and of ECC and the output warp's ``projective_fallback``."""
    assert set(t_offline.FORMS) == set(FORM_ARGUMENTS)
    want_lk, want_output, want_ecc = FORM_ARGUMENTS[form]
    for mode, want_out in zip((M.GLOBAL_SMOOTHING, M.ORB_FULL_LOCK), want_output):
        seen = {"output": [], "lk": [], "ecc": []}

        def recorder(key, fn, arg):
            def wrapped(*a, **kw):
                seen[key].append(kw[arg])
                return fn(*a, **kw)
            return wrapped

        with mock.patch.object(t_offline, "warp_affine",
                               recorder("output", t_offline.warp_affine, "projective_fallback")), \
                mock.patch.object(t_lk_dense, "warp_affine",
                                  recorder("lk", t_lk_dense.warp_affine, "projective_fallback")), \
                mock.patch.object(t_lock, "ecc_refine_euclidean",
                                  recorder("ecc", t_lock.ecc_refine_euclidean, "warp_fallback")):
            run_form(form, mode, footage)
        calls = 2 if form in ("step", "batched", "batched_mixed") else 1     # a call a frame
        assert seen["output"] == [want_out] * calls, mode
        assert seen["lk"] == [want_lk] * 4 * calls, mode
        assert seen["ecc"] == ([want_ecc] * 2 if mode == M.ORB_FULL_LOCK else []), mode


def test_offline_chunk_step_follows_the_carry(footage):
    """The offline step computes on the carry's device and returns u8
    frames of the input's shape with one valid flag each."""
    cfg = config_from_fields(pinned(small_config(past=2, future=1), M.GLOBAL_SMOOTHING))
    carry = init_carry(cfg, 0, prng.key(0), "cpu")
    carry, (outs, valid) = offline_chunk_step(carry, torch.from_numpy(footage[:3]), cfg)
    assert outs.shape == (3, FH, FW, 3) and outs.dtype == torch.uint8
    assert valid.tolist() == [True] * 3 and int(carry.n) == 3
    np.testing.assert_array_equal(outs[0].numpy(), footage[0])


def test_offline_chunk_step_refuses_frames_off_the_carry_device():
    """Frames on another device than the carry's are refused before any
    stage runs, rather than computed where they lie."""
    cfg = config_from_fields(pinned(small_config(past=2, future=1), M.GLOBAL_SMOOTHING))
    carry = init_carry(cfg, 0, prng.key(0), "cpu")
    frames = torch.empty((2, FH, FW, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="carry's device"):
        offline_chunk_step(carry, frames, cfg)
