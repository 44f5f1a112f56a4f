"""The CUDA kernels on the card (affine warp, one image or a batch; FAST
levels): each against its plain version, its input checks and its launch
count; ECC, the offline chunk step and the stream-batched step on the
warp kernel against the same on the plain warp; and each configuration
the port once refused (the motion models, the per-point trackers, the
referee) on the card with its warp launches counted, the step's host
syncs with the non-rigid fits, the exact u8 gray, cv2's greedy corner
fixpoint and the trail compositor against the CPU; the live step and the
stream-batched chunk replayed as CUDA graphs against the same run eagerly.
Marked ``gpu``:
skipped without a CUDA card (run on one with
``python -m pytest tests/test_torch_cuda.py -m gpu -q --noconftest``)."""

import numpy as np
import pytest
import torch

from video_stabilization_tpu_torch.ops import affine_warp as aw
from video_stabilization_tpu_torch.ops import fast

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def last_dev():
    """The last of two or more cards; the thread's current card stays 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs two CUDA cards, found {torch.cuda.device_count()}")
    torch.cuda.set_device(0)
    return torch.device("cuda", torch.cuda.device_count() - 1)


def rigid(theta_deg, tx, ty):
    t = np.deg2rad(theta_deg)
    return np.array([[np.cos(t), -np.sin(t), tx], [np.sin(t), np.cos(t), ty], [0, 0, 1]],
                    np.float32)


def frame(shape, layout, dev, seed=0):
    """(H, W, C) view of random 0-255 content in the given memory layout:
    "hwc" contiguous, "planar" a permuted (C, H, W) array; one-channel
    shapes are (H, W) when planar."""
    c, h, w = shape
    x = torch.from_numpy(np.random.default_rng(seed).uniform(0, 255, shape)
                         .astype(np.float32)).to(dev)
    if layout == "planar":
        return x[0] if c == 1 else x.permute(1, 2, 0)
    return x.permute(1, 2, 0).contiguous()


# rot12 and rot20 leave the envelope and take the gather on the device
TRANSFORMS = [(0, 0, 0), (0, 7, -4), (0.5, 1.3, -0.7), (3, -2.6, 1.9), (8, 0.4, -3.3),
              (12, 2.1, -1.4), (20, 4.0, -3.0)]


@pytest.mark.parametrize("shape", [(1, 90, 160), (1, 180, 320), (1, 360, 640),
                                   (3, 720, 1280), (3, 1080, 1920)])
@pytest.mark.parametrize("theta,tx,ty", TRANSFORMS)
@pytest.mark.parametrize("layout", ["hwc", "planar"])
def test_kernel_matches_plain(dev, shape, theta, tx, ty, layout):
    src = frame(shape, layout, dev)
    border = torch.from_numpy(np.random.default_rng(1).uniform(0, 255, shape[0])
                              .astype(np.float32)).to(dev)
    h = torch.from_numpy(rigid(theta, tx, ty)).to(dev)
    counter = aw.fallback_counter(dev)
    counter.zero_()
    before = aw.launches
    k = aw.warp_affine(src, h, border if shape[0] == 3 else 17.0)
    assert aw.launches == before + 1
    p = aw.warp_affine_plain(src, h, border if shape[0] == 3 else 17.0)
    assert k.shape == src.shape and k.is_contiguous()
    assert torch.equal(k, p)
    assert int(counter) == (0 if bool(aw.affine_envelope_ok(h)) else 1)


@pytest.mark.parametrize("shape", [(1, 360, 640), (3, 1080, 1920)])
def test_kernel_forced_2pass_matches_plain(dev, shape):
    """projective_fallback=False runs the 2-pass resample far outside the
    envelope and counts no fallback: wide spans, channels in rounds through
    the shared buffer (scale 0.2), and a span wider than the buffer, whose
    taps come from device memory (scale 0.1)."""
    src = frame(shape, "hwc", dev, seed=2)
    counter = aw.fallback_counter(dev)
    counter.zero_()
    for theta, s in ((20.0, 1.0), (0.0, 0.2), (35.0, 0.5), (0.0, 0.1)):
        m = rigid(theta, 3.0, -2.0)
        m[:2, :2] *= s
        h = torch.from_numpy(m).to(dev)
        k = aw.warp_affine(src, h, 5.0, projective_fallback=False)
        p = aw.warp_affine_plain(src, h, 5.0, projective_fallback=False)
        assert torch.equal(k, p)
    assert int(counter) == 0


@pytest.mark.parametrize("shape", [(2, 90, 160), (4, 180, 320)])
@pytest.mark.parametrize("theta", [3.0, 20.0])
@pytest.mark.parametrize("layout", ["hwc", "planar"])
def test_kernel_any_channel_count(dev, shape, theta, layout):
    """Channel counts other than the step's 1 and 3 take the kernel's
    generic instance."""
    src = frame(shape, layout, dev, seed=3)
    border = torch.arange(shape[0], dtype=torch.float32, device=dev) * 40.0
    h = torch.from_numpy(rigid(theta, 1.5, -2.5)).to(dev)
    assert torch.equal(aw.warp_affine(src, h, border), aw.warp_affine_plain(src, h, border))


def test_kernel_reads_nothing_back(dev):
    src = frame((3, 180, 320), "hwc", dev)
    border = torch.full((3,), 9.0, device=dev)
    for theta in (3.0, 20.0):
        h = torch.from_numpy(rigid(theta, 1.0, 2.0)).to(dev)
        aw.warp_affine(src, h, border)          # build and load first
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            aw.warp_affine(src, h, border)
        finally:
            torch.cuda.set_sync_debug_mode("default")


def test_kernel_rejects_bad_inputs(dev):
    x = torch.rand(16, 32, device=dev)
    h = torch.eye(3, device=dev)
    with pytest.raises(ValueError):
        aw.warp_affine(x[None, None], h)
    with pytest.raises(ValueError):
        aw.warp_affine(x, h[:2])
    with pytest.raises(ValueError):
        aw.warp_affine(x, h.cpu())


def mixed_batch(b, dev, seed=0):
    """(B, 3, 3) transforms of the step's size, every fourth item 12 or 20
    degrees outside the envelope."""
    rng = np.random.default_rng(seed)
    hs = []
    for i in range(b):
        theta = (12.0 if i % 8 == 3 else 20.0) if i % 4 == 3 else rng.uniform(-6, 6)
        hs.append(rigid(theta, *rng.uniform(-4, 4, 2)))
    return torch.from_numpy(np.stack(hs)).to(dev)


@pytest.mark.parametrize("shape", [(8, 3, 1080, 1920), (64, 1, 360, 640), (64, 1, 90, 160)])
def test_batched_kernel_matches_plain(dev, shape):
    """A batch at config 5's shapes (8 streams' output frames; 64 LK pairs
    of an 8 x 8 chunk at levels 0 and 2) in one launch equals the plain
    version item by item, per-item borders; the device counter rises by the
    number of items outside the envelope."""
    b, c, h, w = shape
    rng = np.random.default_rng(4)
    src = torch.from_numpy(rng.uniform(0, 255, (b, h, w, c)).astype(np.float32)).to(dev)
    if c == 1:
        src = src[..., 0]
    hs = mixed_batch(b, dev)
    border = (torch.from_numpy(rng.uniform(0, 255, (b, c)).astype(np.float32)).to(dev)
              if c == 3 else 0.0)
    counter = aw.fallback_counter(dev)
    counter.zero_()
    before = aw.launches
    k = aw.warp_affine(src, hs, border)
    assert aw.launches == before + 1
    outside = int((~aw.affine_envelope_ok(hs)).sum())
    assert outside == b // 4
    assert int(counter) == outside
    p = aw.warp_affine_plain(src, hs, border)
    assert k.shape == src.shape and k.is_contiguous()
    assert torch.equal(k, p)


def test_batched_kernel_strided_input(dev):
    """A batch of (H, W, C) views of planar (B, C, H, W) memory, a shared
    (C,) border, and the forced 2-pass far outside the envelope."""
    x = torch.from_numpy(np.random.default_rng(5).uniform(0, 255, (4, 3, 180, 320))
                         .astype(np.float32)).to(dev)
    src = x.permute(0, 2, 3, 1)
    assert not src.is_contiguous()
    hs = mixed_batch(4, dev, seed=1)
    border = torch.tensor([3.0, 90.0, 200.0], device=dev)
    for fallback in (True, False):
        assert torch.equal(aw.warp_affine(src, hs, border, projective_fallback=fallback),
                           aw.warp_affine_plain(src, hs, border,
                                                projective_fallback=fallback))


@pytest.mark.parametrize("shape", [(1, 360, 640), (3, 1080, 1920)])
def test_batch_of_one_equals_one_image(dev, shape):
    """B = 1 is today's unbatched launch: equal outputs, one launch each."""
    src = frame(shape, "hwc", dev, seed=6)
    if shape[0] == 1:
        src = src[..., 0]
    h = torch.from_numpy(rigid(3.0, -2.6, 1.9)).to(dev)
    before = aw.launches
    one = aw.warp_affine(src, h, 7.0)
    batch = aw.warp_affine(src[None], h[None], 7.0)
    assert aw.launches == before + 2
    assert torch.equal(batch[0], one)


def test_batched_kernel_rejects_bad_inputs(dev):
    x = torch.rand(3, 16, 32, device=dev)
    hs = torch.eye(3, device=dev).expand(3, 3, 3)
    with pytest.raises(ValueError, match="B = 4"):
        aw.warp_affine(x, torch.eye(3, device=dev).expand(4, 3, 3))
    with pytest.raises(ValueError, match="per-item border"):
        aw.warp_affine(x[..., None], hs, torch.zeros(2, 1, device=dev))
    big = torch.eye(3, device=dev).expand(aw.MAX_BATCH + 1, 3, 3)
    with pytest.raises(ValueError, match="exceeds"):
        aw.warp_affine(torch.zeros(aw.MAX_BATCH + 1, 1, 1, device=dev), big)
    # an image whose elements lie 2^31 or more apart: the kernel's offsets
    # within an item are 32-bit
    wide = torch.empty_strided((2, 2), (2 ** 31, 1), device=dev)
    with pytest.raises(ValueError, match="2\\^31"):
        aw.warp_affine(wide, torch.eye(3, device=dev))


# the ten level shapes of a 360x640 working image (tests/test_torch_orb.py)
LEVEL_SHAPES = [(360, 640), (300, 533), (250, 444), (208, 370), (174, 309),
                (145, 257), (121, 214), (100, 179), (84, 149), (70, 124)]


@pytest.mark.parametrize("shape", LEVEL_SHAPES + [(7, 7), (33, 65)])
@pytest.mark.parametrize("kind", ["integer", "float"])
def test_fast_kernel_matches_plain(dev, shape, kind):
    rng = np.random.default_rng(shape[0])
    img = rng.uniform(0, 255, shape).astype(np.float32)
    if kind == "integer":
        img = np.round(img)
    x = torch.from_numpy(img).to(dev)
    before = fast.launches
    score, corner = fast.fast_score(x, 20.0)
    assert fast.launches == before + 1
    plain, _ = fast.fast_score_plain(x, 20.0)
    torch.cuda.synchronize()
    assert torch.equal(score, plain)
    assert torch.equal(corner, plain > 0)


@pytest.mark.parametrize("kind", ["integer", "float"])
@pytest.mark.parametrize("edge", [31, 0])
def test_fast_levels_matches_plain(dev, kind, edge):
    rng = np.random.default_rng(7)
    imgs = []
    for shape in LEVEL_SHAPES + [(7, 7)]:
        img = rng.uniform(0, 255, shape).astype(np.float32)
        imgs.append(torch.from_numpy(np.round(img) if kind == "integer" else img).to(dev))
    before = fast.launches
    out = fast.fast_levels(imgs, 20.0, edge)
    assert fast.launches == before + 1
    plain = fast.fast_levels_plain(imgs, 20.0, edge)
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    assert sum(int((a > 0).sum()) for a in out) > 0


def test_fast_kernel_rejects_bad_inputs(dev):
    x = torch.rand(32, 48, device=dev) * 255
    with pytest.raises(ValueError):
        fast.fast_score(x.double(), 20.0)
    with pytest.raises(ValueError):
        fast.fast_score(x.t(), 20.0)
    with pytest.raises(ValueError):
        fast.fast_score(x[None], 20.0)
    with pytest.raises(ValueError):
        fast.fast_levels([x] * (fast.MAX_LEVELS + 1), 20.0, 3)
    with pytest.raises(ValueError):
        fast.fast_levels([x, x.cpu()], 20.0, 3)


@pytest.mark.parametrize("theta,tx,ty", [(0.3, 1.5, -0.8), (12, 2.0, -1.0)])
def test_ecc_kernel_matches_plain_warp(dev, theta, tx, ty):
    """ECC with the warp kernel equals ECC with the plain warp on the card
    (``h``, ``rho`` and ``valid`` bit for bit), at 360x640 inside the
    envelope and from a start outside it; the kernel runs once per warp."""
    from unittest import mock

    from video_stabilization_tpu_torch.ops import ecc

    ref = frame((1, 360, 640), "planar", dev, seed=3)
    ref = ref + torch.roll(ref, 1, 0) + torch.roll(ref, 1, 1)     # some smoothness
    h = torch.from_numpy(rigid(theta, tx, ty)).to(dev)
    cur = aw.warp_affine_plain(ref, h)
    h_init = torch.from_numpy(rigid(theta + 0.2, tx + 0.5, ty - 0.5)).to(dev)
    before = aw.launches
    k = ecc.ecc_refine_euclidean(ref, cur, h_init, max_iters=30)
    assert aw.launches == before + 32
    with mock.patch.object(ecc, "warp_affine", aw.warp_affine_plain):
        p = ecc.ecc_refine_euclidean(ref, cur, h_init, max_iters=30)
    assert aw.launches == before + 32
    assert torch.equal(k.h, p.h) and torch.equal(k.rho, p.rho) and torch.equal(k.valid, p.valid)


@pytest.mark.parametrize("mode", ["GLOBAL_SMOOTHING", "SIFT_FULL_LOCK"])
def test_offline_kernel_matches_plain_warp(dev, mode):
    """The offline chunk step on the card with the warp kernel equals the
    same step on the card with the plain warp in its place (LK, ECC and the
    output warp), outputs and carry bit for bit; K = 4 over 8 frames of a
    240x320 clip, SIFT with 5 ECC iterations.  Each chunk launches the
    kernel 5 times (4 LK warps and the output warp, each over the chunk),
    and SIFT 7 ECC warps per frame on top."""
    from unittest import mock

    from video_stabilization_tpu_torch.config import (
        ECCConfig, SIFTConfig, StabilizationMode, StabilizerConfig)
    from video_stabilization_tpu_torch.engine import (
        init_carry, offline, stabilize_clip_offline)
    from video_stabilization_tpu_torch.ops import ecc, lk_dense
    from video_stabilization_tpu_torch.sim import (
        DEFAULT_APP_PARAMS, make_default_texture, render_frame, shake_trajectory)
    from video_stabilization_tpu_torch.utils import prng

    m = StabilizationMode[mode]
    cfg = StabilizerConfig(past_frames=4, future_frames=2, working_height=120,
                           frame_height=240, frame_width=320,
                           sift=SIFTConfig(max_features=256, max_keypoint_size_ratio=0.5),
                           ecc=ECCConfig(enabled=m == StabilizationMode.SIFT_FULL_LOCK,
                                         max_iters=5),
                           static_mode=int(m))
    rng = np.random.default_rng(0)
    tex = torch.from_numpy(make_default_texture(rng, 256)).to(dev)
    traj = shake_trajectory(rng.standard_normal((8, 3)), rng.standard_normal(8),
                            DEFAULT_APP_PARAMS, pos_amplitude=0.004, roll_amplitude=0.3,
                            device=dev)
    frames = torch.stack([render_frame(tex, traj[i], 240, 320) for i in range(8)])

    def run():
        carry = init_carry(cfg, int(m), prng.key(3), dev)
        return stabilize_clip_offline(carry, frames, cfg, chunk=4)

    before = aw.launches
    c_k, out_k = run()
    launches = 2 * 5 + (cfg.ecc.max_iters + 2 if cfg.ecc.enabled else 0) * 8
    assert aw.launches - before == launches
    with mock.patch.object(offline, "warp_affine", aw.warp_affine_plain), \
            mock.patch.object(lk_dense, "warp_affine", aw.warp_affine_plain), \
            mock.patch.object(ecc, "warp_affine", aw.warp_affine_plain):
        c_p, out_p = run()
    assert aw.launches - before == launches
    assert torch.equal(out_k, out_p)
    for name in ("last_h", "transforms", "lock_prev_h", "corners_prev"):
        assert torch.equal(getattr(c_k, name), getattr(c_p, name)), name


def test_batched_step_kernel_matches_plain_warp(dev):
    """The stream-batched step (4 streams) and offline chunk (K = 3) on the
    card with the warp kernel equal the same with the plain warp in its
    place, bit for bit; each call launches the kernel 5 times."""
    from unittest import mock

    from video_stabilization_tpu_torch.config import StabilizationMode, StabilizerConfig
    from video_stabilization_tpu_torch.engine import make_offline_batched_fn, offline
    from video_stabilization_tpu_torch.ops import lk_dense
    from video_stabilization_tpu_torch.parallel import init_batched_carry, make_batched_step_fn
    from video_stabilization_tpu_torch.sim import (
        DEFAULT_APP_PARAMS, make_default_texture, render_frame, shake_trajectory)
    from video_stabilization_tpu_torch.utils import prng

    m = StabilizationMode.TRANSLATION_LOCK
    cfg = StabilizerConfig(past_frames=4, future_frames=2, working_height=120,
                           frame_height=240, frame_width=320, static_mode=int(m))
    rng = np.random.default_rng(0)
    tex = torch.from_numpy(make_default_texture(rng, 256)).to(dev)
    streams = []
    for _ in range(4):
        traj = shake_trajectory(rng.standard_normal((6, 3)), rng.standard_normal(6),
                                DEFAULT_APP_PARAMS, pos_amplitude=0.004, roll_amplitude=0.3,
                                device=dev)
        streams.append(torch.stack([render_frame(tex, traj[i], 240, 320) for i in range(6)]))
    frames = torch.stack(streams)                       # (S, T, H, W, C)

    def run():
        step, chunk = make_batched_step_fn(cfg), make_offline_batched_fn(cfg)
        a = init_batched_carry(cfg, 4, int(m), prng.key(3), dev)
        b = init_batched_carry(cfg, 4, int(m), prng.key(3), dev)
        outs = []
        for t in range(6):
            a, (out, _) = step(a, frames[:, t])
            outs.append(out)
        for i in (0, 3):
            b, (out, _) = chunk(b, frames[:, i:i + 3])
            outs.append(out)
        return a, b, outs

    before = aw.launches
    a_k, b_k, outs_k = run()
    assert aw.launches - before == 5 * (6 + 2)
    with mock.patch.object(offline, "warp_affine", aw.warp_affine_plain), \
            mock.patch.object(lk_dense, "warp_affine", aw.warp_affine_plain):
        a_p, b_p, outs_p = run()
    for k, p in zip(outs_k, outs_p):
        assert torch.equal(k, p)
    for name in ("last_h", "transforms", "accum_h", "corners_prev"):
        assert torch.equal(getattr(a_k, name), getattr(a_p, name)), name
        assert torch.equal(getattr(b_k, name), getattr(b_p, name)), name


@pytest.mark.parametrize("c420", [True, False])
def test_yuv_decode_on_the_card_matches_cpu(dev, c420):
    """The YUV decode on the card equals the CPU's (and so the native
    reader's) bit for bit, a batch of frames at 1080x1920."""
    from video_stabilization_tpu_torch.ops.image import yuv_flat_to_bgr

    h, w = 1080, 1920
    n = h * w * 3 // 2 if c420 else h * w * 3
    buf = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 3, n),
                                                             dtype=np.uint8))
    got = yuv_flat_to_bgr(buf.to(dev), h, w, c420)
    assert got.shape == (2, 3, h, w, 3) and got.device.type == "cuda"
    assert torch.equal(got.cpu(), yuv_flat_to_bgr(buf, h, w, c420))


def test_serve_on_the_card(dev, tmp_path):
    """``serve_files`` on the card: 4 streams of 8 frames of 240x320 in
    chunks of 4 equal the in-memory path on the card byte for byte (through
    the C420 encode), launch the warp 5 times per chunk, wait on one event
    per chunk, and stay within half a level on average of the same run on
    the CPU (the card rounds its reductions differently)."""
    import os

    from video_stabilization_tpu_torch import serve
    from video_stabilization_tpu_torch.config import StabilizationMode, StabilizerConfig
    from video_stabilization_tpu_torch.io.native import NativeY4MReader
    from video_stabilization_tpu_torch.io.video import encode_y4m_planes
    from video_stabilization_tpu_torch.ops.image import yuv_flat_to_bgr

    cfg = StabilizerConfig(past_frames=4, future_frames=2, working_height=120,
                           frame_height=240, frame_width=320,
                           static_mode=int(StabilizationMode.GLOBAL_SMOOTHING))
    def raw_frames(path):
        r = NativeY4MReader(path)
        frames = []
        while (raw := r.read_yuv()) is not None:
            frames.append(raw)
        r.close()
        return np.stack(frames)

    paths = serve._render_sim_streams(4, 8, 240, 320, str(tmp_path), dev, log=lambda *a: None)
    outs = {}
    for where in ("cuda", "cpu"):
        before = aw.launches
        done, _ = serve.serve_files(paths, str(tmp_path / where), "smoothing", chunk=4,
                                    config=cfg, devices=[where], log=lambda *a: None)
        assert done == 8
        if where == "cuda":
            assert aw.launches - before == 5 * 2
            assert serve.last_run["event_waits"] == 2
        outs[where] = [raw_frames(str(tmp_path / where / f"stabilized_{os.path.basename(p)}"))
                       for p in paths]
    footage = []
    for p in paths:
        r = NativeY4MReader(p)
        footage.append(yuv_flat_to_bgr(torch.from_numpy(r.read_yuv_block(8)).to(dev),
                                       240, 320, True))
        r.close()
    mem, valid, _ = serve.stabilize_streams_sharded(torch.stack(footage), cfg, [dev], chunk=4)
    assert bool(valid.all())
    for s in range(4):
        want = np.stack([np.frombuffer(encode_y4m_planes(f, True), np.uint8)
                         for f in mem[s].cpu().numpy()])
        assert np.array_equal(outs["cuda"][s], want), f"stream {s}"
        diff = np.abs(outs["cuda"][s].astype(np.int16) - outs["cpu"][s].astype(np.int16))
        assert diff.mean() <= 0.5, f"stream {s}: mean |card - CPU| {diff.mean()}"


def small_clip(dev, n=4, seed=0):
    """n shaky 240x320 frames rendered on ``dev``."""
    from video_stabilization_tpu_torch.sim import (
        DEFAULT_APP_PARAMS, make_default_texture, render_frame, shake_trajectory)

    rng = np.random.default_rng(seed)
    tex = torch.from_numpy(make_default_texture(rng, 256)).to(dev)
    traj = shake_trajectory(rng.standard_normal((n, 3)), rng.standard_normal(n),
                            DEFAULT_APP_PARAMS, pos_amplitude=0.004, roll_amplitude=0.3,
                            device=dev)
    return torch.stack([render_frame(tex, traj[i], 240, 320) for i in range(n)])


# each configuration the port once refused, and the warp launches per frame
# it makes: dense LK's four and the output warp, the output alone with a
# per-point tracker, dense LK's alone with the homography model
FORMERLY_REFUSED = {
    "homography": (dict(ransac="homography"), 4),
    "affine": (dict(ransac="affine"), 5),
    "similarity": (dict(ransac="similarity"), 5),
    "cv2exact_ransac": (dict(ransac_method="cv2exact"), 5),
    "reference_compat": (dict(reference_compat=True), 5),
    "compat_drift": (dict(reference_compat=True, lk="cv2exact", gftt="host",
                          ransac_method="cv2exact"), 1),
    "sweep_lk": (dict(lk="sweep"), 1),
    "cv2exact_lk": (dict(lk="cv2exact"), 1),
    "cv2exact_gftt": (dict(gftt="cv2exact"), 5),
    "corner_polish": (dict(polish=2), 5),
}


def formerly_refused_config(name):
    from video_stabilization_tpu_torch.config import (
        GFTTConfig, LKConfig, RansacConfig, StabilizerConfig)

    kw, _ = FORMERLY_REFUSED[name]
    return StabilizerConfig(
        past_frames=4, future_frames=2, working_height=120, frame_height=240,
        frame_width=320, reference_compat=kw.get("reference_compat", False),
        lk=LKConfig(method=kw.get("lk", "dense"), corner_polish_iters=kw.get("polish", 0)),
        gftt=GFTTConfig(max_features=256, selection=kw.get("gftt", "cell")),
        ransac=RansacConfig(motion_model=kw.get("ransac", "rigid"),
                            method=kw.get("ransac_method", "vmapped")))


@pytest.mark.parametrize("name", list(FORMERLY_REFUSED))
def test_formerly_refused_configs_on_the_card(dev, name):
    """Each configuration the port once refused runs 6 frames on the card
    with its warp launches per frame counted, and stays within a level on
    average of the same run on the CPU (the card rounds its reductions
    differently); the transforms within 0.05 px at the corners."""
    from video_stabilization_tpu_torch.engine import Stabilizer

    cfg = formerly_refused_config(name)
    frames = small_clip(dev, 6)
    stab = Stabilizer(cfg, device=dev)
    before = aw.launches
    outs = [stab.stabilize_frame(f) for f in frames]
    assert aw.launches - before == FORMERLY_REFUSED[name][1] * 6
    ref = Stabilizer(cfg, device="cpu")
    want = [ref.stabilize_frame(f.cpu()) for f in frames]
    for o, w in zip(outs, want):
        assert o.device == frames.device
        assert (o.cpu().float() - w.float()).abs().mean() <= 1.0
    wh, ww = cfg.working_size
    c = torch.tensor([[0, 0, 1], [ww, 0, 1], [ww, wh, 1], [0, wh, 1]], dtype=torch.float64).T
    pa, pb = stab.carry.last_h.cpu().double() @ c, ref.carry.last_h.double() @ c
    assert (pa[:2] / pa[2] - pb[:2] / pb[2]).abs().mean() <= 0.05
    assert stab.host_reads == ref.host_reads


@pytest.mark.parametrize("model", ["similarity", "affine", "homography"])
def test_motion_models_step_reads_nothing_back(dev, model):
    """The non-rigid fits (closed-form 3x3 solves, the DLT's eigenvector by
    repeated squaring) keep the step free of host syncs: a steady frame
    under ``set_sync_debug_mode("error")``."""
    from video_stabilization_tpu_torch.engine import Stabilizer

    stab = Stabilizer(formerly_refused_config(model), device=dev)
    frames = small_clip(dev, 3)
    stab.stabilize_frame(frames[0])
    stab.stabilize_frame(frames[1])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        stab.stabilize_frame(frames[2])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_gray_u8_on_the_card_equals_cpu(dev):
    from video_stabilization_tpu_torch.ops.image import gray_u8_cv2exact

    frames = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 1080, 1920, 3),
                                                                dtype=np.uint8))
    for oh, ow in ((360, 640), (540, 960), (1080, 1920)):
        got = gray_u8_cv2exact(frames.to(dev), oh, ow)
        assert torch.equal(got.cpu(), gray_u8_cv2exact(frames, oh, ow))


def test_greedy_on_the_card_equals_cpu(dev):
    """Given one response map (the CPU's), cv2's exact corner list from the
    card's candidate selection and greedy fixpoint equals the CPU's."""
    from video_stabilization_tpu_torch.ops import gftt
    from video_stabilization_tpu_torch.ops.image import gray_u8_cv2exact

    frame = small_clip(dev, 1, seed=3)[0]
    gray = gray_u8_cv2exact(frame.cpu(), 240, 320)
    resp = gftt.min_eig_response(gray)
    flat = torch.where(resp > 0.01 * resp.max(), gftt._nms3(resp), -torch.inf)
    flat[0, :] = flat[-1, :] = flat[:, 0] = flat[:, -1] = -torch.inf
    top, idx = gftt.top_k_stable(flat.flatten(), 4096)
    pts = torch.stack([(idx % 320).float(), (idx // 320).float()], -1)
    valid = torch.isfinite(top)
    for k, md in ((1280, 10.0 * 240 / 720), (300, 7.3)):
        want = gftt._greedy_cv2exact(pts, top, valid, md, k)
        got = gftt._greedy_cv2exact(pts.to(dev), top.to(dev), valid.to(dev), md, k)
        assert torch.equal(got.points.cpu(), want.points)
        assert torch.equal(got.mask.cpu(), want.mask)
        assert int(want.mask.sum()) > 100


def test_trail_compositor_on_the_card(dev):
    """``copy_feathered`` (the shear warp and the feather) on the card
    within 0.05 levels of the CPU's on a 1080x1920 frame."""
    from video_stabilization_tpu_torch.ops.compositing import copy_feathered

    frame = small_clip(dev, 1)[0]
    big = torch.nn.functional.interpolate(frame.permute(2, 0, 1)[None].float(),
                                          size=(1080, 1920))[0].permute(1, 2, 0)
    h = torch.tensor([[0.998, -0.03, 6.5], [0.03, 0.998, -4.25], [0, 0, 1]])
    bg = torch.full((1080, 1920, 3), 40.0)
    got = copy_feathered(big, bg.to(dev), h.to(dev))
    want = copy_feathered(big.cpu(), bg, h)
    assert (got.cpu() - want).abs().max() <= 0.05


def test_warp_kernel_on_another_card(last_dev):
    """The warp kernel on the last card, launched while card 0 is the
    thread's current one: one image and a batch that mixes items inside and
    outside the envelope, equal to the plain version there, with that
    card's count of warps outside the envelope."""
    assert torch.cuda.current_device() == 0
    counter = aw.fallback_counter(last_dev)
    counter.zero_()
    src = frame((3, 1080, 1920), "hwc", last_dev)
    border = torch.tensor([10.0, 20.0, 30.0], device=last_dev)
    for theta in (3.0, 12.0):
        h = torch.from_numpy(rigid(theta, 2.1, -1.4)).to(last_dev)
        got = aw.warp_affine(src, h, border)
        assert got.device == last_dev
        assert torch.equal(got, aw.warp_affine_plain(src, h, border))
    hs = mixed_batch(8, last_dev)
    batch = torch.from_numpy(np.random.default_rng(1).uniform(0, 255, (8, 360, 640))
                             .astype(np.float32)).to(last_dev)
    assert torch.equal(aw.warp_affine(batch, hs, 0.0), aw.warp_affine_plain(batch, hs, 0.0))
    assert int(counter) == 1 + 2
    assert torch.cuda.current_device() == 0


def test_fast_kernel_on_another_card(last_dev):
    """FAST's levels on the last card, launched while card 0 is current,
    equal to the plain version there."""
    rng = np.random.default_rng(7)
    imgs = [torch.from_numpy(np.round(rng.uniform(0, 255, shape)).astype(np.float32))
            .to(last_dev) for shape in LEVEL_SHAPES]
    out = fast.fast_levels(imgs, 20.0, 31)
    for a, b in zip(out, fast.fast_levels_plain(imgs, 20.0, 31)):
        assert a.device == last_dev and torch.equal(a, b)
    assert torch.cuda.current_device() == 0


@pytest.mark.parametrize("cards", ["one card twice", "two cards"])
def test_sharded_chunk_matches_each_slot(dev, cards):
    """The sharded offline chunk of 4 streams over two slots (card 0 twice,
    or cards 0 and 1) equals each slot's own sub-batch of 2 streams through
    the one-device stream-batched chunk, outputs and carry bit for bit; the
    carry stays on its slots' cards, and each call launches the warp 5
    times per slot."""
    from video_stabilization_tpu_torch.config import StabilizationMode, StabilizerConfig
    from video_stabilization_tpu_torch.engine import make_offline_batched_fn, map_carry
    from video_stabilization_tpu_torch.parallel import (
        Sharded, init_batched_carry, make_sharded_offline_fn, make_stream_mesh, shard_carry)
    from video_stabilization_tpu_torch.utils import prng

    if cards == "two cards" and torch.cuda.device_count() < 2:
        pytest.skip(f"needs two CUDA cards, found {torch.cuda.device_count()}")
    mesh = make_stream_mesh([dev, dev] if cards == "one card twice" else ["cuda:0", "cuda:1"])
    m = StabilizationMode.TRANSLATION_LOCK
    cfg = StabilizerConfig(past_frames=4, future_frames=2, working_height=120,
                           frame_height=240, frame_width=320, static_mode=int(m))
    clips = torch.stack([small_clip(dev, 6, seed=s) for s in range(4)])   # (S, T, H, W, C)
    sharded = make_sharded_offline_fn(cfg, mesh)
    carry = shard_carry(init_batched_carry(cfg, 4, int(m), prng.key(3), dev), mesh)
    parts = [clips[2 * d:2 * d + 2].to(d_) for d, d_ in enumerate(mesh)]
    chunk = make_offline_batched_fn(cfg)
    alone = [map_carry(torch.clone, c) for c in carry.parts]
    for i in (0, 3):
        before = aw.launches
        carry, (out, _) = sharded(carry, Sharded(tuple(p[:, i:i + 3] for p in parts)))
        assert aw.launches - before == 5 * len(mesh)
        for d, d_ in enumerate(mesh):
            alone[d], (want, _) = chunk(alone[d], parts[d][:, i:i + 3])
            assert out.parts[d].device == d_ and torch.equal(out.parts[d], want)
            devices = set()
            map_carry(lambda x: devices.add(x.device), carry.parts[d])
            assert devices == {d_}
    for d in range(len(mesh)):
        for name in ("last_h", "transforms", "accum_h", "corners_prev", "frames"):
            assert torch.equal(getattr(carry.parts[d], name), getattr(alone[d], name)), name


def test_chunk_and_step_ignore_the_callers_tf32(dev):
    """A caller that turned TF32 on (``torch.set_float32_matmul_precision
    ("high")``) gets from the sharded chunk (serving's chunk) and the
    batched step what it gets with TF32 off, outputs and carry bit for bit,
    and its setting back after every call."""
    from video_stabilization_tpu_torch.config import StabilizationMode, StabilizerConfig
    from video_stabilization_tpu_torch.parallel import (
        init_batched_carry, make_batched_step_fn, make_sharded_offline_fn, make_stream_mesh)
    from video_stabilization_tpu_torch.utils import prng

    m = StabilizationMode.GLOBAL_SMOOTHING
    cfg = StabilizerConfig(past_frames=4, future_frames=2, working_height=120,
                           frame_height=240, frame_width=320, static_mode=int(m))
    clips = torch.stack([small_clip(dev, 6, seed=s) for s in range(2)])   # (S, T, H, W, C)

    def run(precision):
        torch.set_float32_matmul_precision(precision)
        chunk = make_sharded_offline_fn(cfg, make_stream_mesh([dev]))
        step = make_batched_step_fn(cfg)
        a = init_batched_carry(cfg, 2, int(m), prng.key(3), dev)
        b = init_batched_carry(cfg, 2, int(m), prng.key(3), dev)
        outs = []
        for i in (0, 3):
            a, (out, _) = chunk(a, clips[:, i:i + 3])
            outs.append(out)
            assert torch.get_float32_matmul_precision() == precision
        for t in range(6):
            b, (out, _) = step(b, clips[:, t])
            outs.append(out)
            assert torch.get_float32_matmul_precision() == precision
        return a, b, outs

    try:
        want = run("highest")
        got = run("high")
    finally:
        torch.set_float32_matmul_precision("highest")
    for g, w in zip(got[2], want[2]):
        assert torch.equal(g, w)
    for name in ("last_h", "transforms", "corners_prev"):
        for g, w in zip(got[:2], want[:2]):
            assert torch.equal(getattr(g, name), getattr(w, name)), name


def replay_config(**kw):
    from video_stabilization_tpu_torch.config import GFTTConfig, StabilizerConfig

    return StabilizerConfig(past_frames=30, future_frames=15, working_height=120,
                            frame_height=240, frame_width=320,
                            gftt=GFTTConfig(max_features=256), **kw)


def carries_equal(a, b):
    from video_stabilization_tpu_torch.engine import map_carry

    names = []
    map_carry(lambda x, y: names.append(torch.equal(x, y)), a, b)
    return all(names)


@pytest.mark.parametrize("scenario", ["steady", "switch and resume"])
def test_step_replay_equals_eager(dev, scenario, tmp_path):
    """Over 130 frames, past the window's fill of 46, the Stabilizer that
    replays its step as a CUDA graph equals an eager one bit for bit, in
    every output and every carry field; with a switch to the accumulated
    lock at frame 50 and back at 90, and a resume from a carry saved at
    frame 100, too.  Each replay counts the warp's 5 launches a frame."""
    from video_stabilization_tpu_torch.config import StabilizationMode
    from video_stabilization_tpu_torch.engine import Stabilizer, save_carry
    from video_stabilization_tpu_torch.engine import stabilizer as stab_mod

    cfg = replay_config()
    frames = small_clip(dev, 130, seed=5)
    eager = Stabilizer(cfg, seed=9, device=dev)
    eager._graphs = None
    graphed = Stabilizer(cfg, seed=9, device=dev)
    saved = str(tmp_path / "carry.npz")
    stab_mod.reset_step_counters()
    launches = 0
    for i, f in enumerate(frames):
        if scenario == "switch and resume":
            if i in (50, 90):
                mode = (StabilizationMode.ACCUMULATED_FULL_LOCK if i == 50
                        else StabilizationMode.GLOBAL_SMOOTHING)
                eager.set_stabilization_mode(mode)
                graphed.set_stabilization_mode(mode)
            if i == 100:
                save_carry(saved, eager.carry)
            if i == 110:
                eager.resume(saved)
                graphed.resume(saved)
        want = eager.stabilize_frame(f)
        before = aw.launches
        got = graphed.stabilize_frame(f)
        launches += aw.launches - before
        assert torch.equal(got, want), f"frame {i}"
        assert carries_equal(graphed.carry, eager.carry), f"frame {i}"
    assert launches == 5 * len(frames)
    eager_calls = 1 if scenario == "steady" else 2
    assert stab_mod.step_counters["replays"] == len(frames) - eager_calls
    assert stab_mod.step_counters["captures"] == eager_calls


def test_step_replay_clip_counts_and_syncs(dev):
    """One mode and shape: ``stabilize_clip`` returns distinct fresh
    outputs, equal to the eager clip's; the counters show 1 capture and a
    replay of every call but the first; and a replayed frame of a frame
    already on the card runs under ``set_sync_debug_mode("error")``."""
    from video_stabilization_tpu_torch.engine import Stabilizer
    from video_stabilization_tpu_torch.engine import stabilizer as stab_mod

    cfg = replay_config()
    frames = small_clip(dev, 12, seed=6)
    eager = Stabilizer(cfg, device=dev)
    eager._graphs = None
    graphed = Stabilizer(cfg, device=dev)
    stab_mod.reset_step_counters()
    got = graphed.stabilize_clip(frames[:10])
    assert stab_mod.step_counters == {"calls": 10, "replays": 9, "captures": 1}
    assert torch.equal(got, eager.stabilize_clip(frames[:10]))
    outs = [graphed.stabilize_frame(frames[10])]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs.append(graphed.stabilize_frame(frames[11]))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert outs[0].data_ptr() != outs[1].data_ptr()
    assert not torch.equal(outs[0], outs[1])
    calls = stab_mod.step_counters["calls"] - 10      # the eager clip's calls
    assert stab_mod.step_counters["captures"] == 1
    assert stab_mod.step_counters["replays"] >= calls - 2


def chunk_config():
    from video_stabilization_tpu_torch.config import StabilizationMode, StabilizerConfig

    return StabilizerConfig(past_frames=4, future_frames=2, working_height=120,
                            frame_height=240, frame_width=320,
                            static_mode=int(StabilizationMode.GLOBAL_SMOOTHING))


@pytest.mark.parametrize("cards", ["one slot", "one card twice", "two cards"])
def test_chunk_replay_equals_eager(dev, cards):
    """The stream-batched chunk over a mesh (one slot; card 0 twice; cards 0
    and 1) replays a CUDA graph per slot from its second call, and over 5
    chunks of 3, past the window's fill, equals each slot's streams through
    the eager body bit for bit, outputs, ``valid`` and carry; 5 warp
    launches a slot and call; a replay makes no host sync; a call's outputs
    survive the next; the graphs go with their slot's ring."""
    import gc

    from video_stabilization_tpu_torch.engine import map_carry, offline
    from video_stabilization_tpu_torch.parallel import (
        Sharded, init_batched_carry, make_sharded_offline_fn, make_stream_mesh, shard_carry)
    from video_stabilization_tpu_torch.utils import prng

    if cards == "two cards" and torch.cuda.device_count() < 2:
        pytest.skip(f"needs two CUDA cards, found {torch.cuda.device_count()}")
    mesh = make_stream_mesh({"one slot": [dev], "one card twice": [dev, dev],
                             "two cards": ["cuda:0", "cuda:1"]}[cards])
    cfg = chunk_config()
    n = len(mesh)
    clips = torch.stack([small_clip(dev, 15, seed=s) for s in range(2 * n)])
    parts = [clips[2 * d:2 * d + 2].to(d_) for d, d_ in enumerate(mesh)]
    sharded = make_sharded_offline_fn(cfg, mesh)
    fn = offline.make_offline_batched_fn(cfg)
    carry = shard_carry(init_batched_carry(cfg, 2 * n, int(cfg.static_mode), prng.key(3), dev),
                        mesh)
    slots = carry.parts if n > 1 else (carry,)
    alone = [map_carry(torch.clone, c) for c in slots]
    offline.reset_chunk_counters()
    kept = []
    for c in range(5):
        frames = Sharded(tuple(p[:, 3 * c:3 * c + 3] for p in parts))
        before = aw.launches
        if c == 4:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            carry, (out, valid) = sharded(carry, frames)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert aw.launches - before == 5 * n
        outs = out.parts if n > 1 else (out,)
        valids = valid.parts if n > 1 else (valid,)
        slots = carry.parts if n > 1 else (carry,)
        for d in range(n):
            alone[d], (want, want_valid) = fn.body(alone[d], frames.parts[d])
            assert outs[d].device == mesh[d]
            assert torch.equal(outs[d], want) and torch.equal(valids[d], want_valid), (c, d)
            assert carries_equal(slots[d], alone[d]), (c, d)
        kept.append([(o, o.clone()) for o in outs])
    assert offline.chunk_counters == {"calls": 5 * n, "replays": 4 * n, "captures": n}
    for c, pairs in enumerate(kept):
        for o, snapshot in pairs:
            assert torch.equal(o, snapshot), f"chunk {c} overwritten"
    rings = {id(c.frames) for c in slots}
    assert rings <= set(fn._rings)
    del carry, slots, kept, out, outs, valid, valids
    gc.collect()
    assert not rings & set(fn._rings)


def test_serve_writes_the_same_bytes_replayed(dev, tmp_path, monkeypatch):
    """``serve_files`` on the card writes the same bytes with the chunk
    replayed as a CUDA graph (3 of its 4 calls) as with the chunk eager."""
    import os

    from video_stabilization_tpu_torch import serve
    from video_stabilization_tpu_torch.engine import offline

    cfg = chunk_config()
    paths = serve._render_sim_streams(4, 16, 240, 320, str(tmp_path), dev, log=lambda *a: None)
    written = {}
    for how in ("replayed", "eager"):
        if how == "eager":
            monkeypatch.setattr(offline, "step_replays", lambda config, device: False)
        offline.make_offline_batched_fn.cache_clear()
        offline.reset_chunk_counters()
        done, _ = serve.serve_files(paths, str(tmp_path / how), "smoothing", chunk=4,
                                    config=cfg, devices=[dev], log=lambda *a: None)
        assert done == 16
        assert offline.chunk_counters["replays"] == (3 if how == "replayed" else 0)
        written[how] = [(tmp_path / how / f"stabilized_{os.path.basename(p)}").read_bytes()
                        for p in paths]
    offline.make_offline_batched_fn.cache_clear()
    assert written["replayed"] == written["eager"]
