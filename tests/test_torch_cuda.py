"""The CUDA kernels on the card (affine resample, FAST score): each against
its plain version, its input checks and its launch count.  Marked ``gpu``:
skipped without a CUDA card (run on one with
``python -m pytest tests/test_torch_cuda.py -m gpu``)."""

import numpy as np
import pytest
import torch

from video_stabilization_tpu_torch.ops import affine_warp as aw
from video_stabilization_tpu_torch.ops import fast
from video_stabilization_tpu_torch.ops.warp import _inv3x3

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


@pytest.mark.parametrize("shape", [(1, 90, 160), (1, 180, 320), (1, 360, 640),
                                   (3, 720, 1280), (3, 1080, 1920)])
@pytest.mark.parametrize("theta,tx,ty", [(0, 0, 0), (0, 7, -4), (0.5, 1.3, -0.7),
                                         (3, -2.6, 1.9), (8, 0.4, -3.3)])
def test_kernel_matches_plain(dev, shape, theta, tx, ty):
    rng = np.random.default_rng(0)
    planes = torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32)).to(dev)
    border = torch.from_numpy(rng.uniform(0, 255, shape[0]).astype(np.float32)).to(dev)
    hinv = _inv3x3(torch.from_numpy(rigid(theta, tx, ty)).to(dev))
    before = aw.launches
    k = aw.warp_planes_2pass(planes, hinv, border)
    assert aw.launches == before + 2
    p = aw.warp_planes_2pass(planes, hinv, border, aw.resample_plain)
    torch.cuda.synchronize()
    assert float((k - p).abs().max()) <= 1e-3


def test_kernel_rejects_bad_inputs(dev):
    x = torch.rand(1, 16, 32, device=dev)
    abg = torch.tensor([1.0, 0.0, 0.0], device=dev)
    with pytest.raises(ValueError):
        aw.resample(x.double(), abg.double(), 16, 0)
    with pytest.raises(ValueError):
        aw.resample(x.transpose(1, 2), abg, 16, 0)
    with pytest.raises(ValueError):
        aw.resample(x, abg.cpu(), 16, 0)


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


def test_fast_kernel_rejects_bad_inputs(dev):
    x = torch.rand(32, 48, device=dev) * 255
    with pytest.raises(ValueError):
        fast.fast_score(x.double(), 20.0)
    with pytest.raises(ValueError):
        fast.fast_score(x.t(), 20.0)
    with pytest.raises(ValueError):
        fast.fast_score(x[None], 20.0)
