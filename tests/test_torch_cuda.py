"""The CUDA kernels on the card (affine warp, FAST levels): each against its
plain version, its input checks and its launch count; and ECC on the warp
kernel against ECC on the plain warp.  Marked ``gpu``:
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
