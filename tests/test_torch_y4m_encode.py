"""The Y4M encode of ``ops/y4m.py``: its plain version against the numpy
encode of ``io/video.py::encode_y4m_planes`` byte for byte (random frames,
and frames driven to saturation, where the clip and the truncation decide
the byte), numpy's 2x2 mean against the order the kernel and the plain
version write out, ``VideoWriter.write_planes`` against ``write``, and
(marked ``gpu``, skipped without a card) the CUDA kernel against the plain
version at serving's shape."""

import numpy as np
import pytest
import torch

from video_stabilization_tpu_torch.io import VideoWriter
from video_stabilization_tpu_torch.io.video import encode_y4m_planes
from video_stabilization_tpu_torch.ops import y4m


def numpy_planes(frames: np.ndarray, c420: bool) -> np.ndarray:
    return np.stack([np.frombuffer(encode_y4m_planes(f, c420), np.uint8) for f in frames])


def saturated_frames(h: int = 8, w: int = 12) -> np.ndarray:
    """All 0, all 255, pure B, G and R, and 2x2 blocks that mix 0 and 255."""
    pure = [np.zeros((h, w, 3), np.uint8), np.full((h, w, 3), 255, np.uint8)]
    for c in range(3):
        f = np.zeros((h, w, 3), np.uint8)
        f[..., c] = 255
        pure.append(f)
    checker = ((np.arange(h)[:, None] + np.arange(w)[None]) % 2 * 255).astype(np.uint8)
    pure.append(np.repeat(checker[..., None], 3, 2))
    rgb = np.zeros((h, w, 3), np.uint8)
    rgb[0::2, 0::2, 0] = rgb[0::2, 1::2, 1] = rgb[1::2, 0::2, 2] = 255
    pure.append(rgb)
    return np.stack(pure)


@pytest.mark.parametrize("c420", [True, False], ids=["c420", "c444"])
def test_plain_matches_numpy_on_random_frames(c420):
    frames = np.random.default_rng(3).integers(0, 256, (4, 64, 96, 3), dtype=np.uint8)
    got = y4m.encode_y4m_plain(torch.from_numpy(frames), c420)
    assert got.shape == (4, y4m.frame_bytes(64, 96, c420)) and got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), numpy_planes(frames, c420))


@pytest.mark.parametrize("c420", [True, False], ids=["c420", "c444"])
def test_plain_matches_numpy_at_saturation(c420):
    frames = saturated_frames()
    want = numpy_planes(frames, c420)
    assert np.array_equal(y4m.encode_y4m_plain(torch.from_numpy(frames), c420).numpy(), want)
    # the clip decides: pure blue drives U above 255 and pure red V, their
    # complements below 0
    assert want.max() == 255 and want.min() == 0


def test_numpy_mean_is_the_written_out_order():
    """``mean(axis=(1, 3))`` of numpy's encode equals ((top-left +
    top-right) + (bottom-left + bottom-right)) / 4 in float32 on every
    chroma sample of random U planes, where another order differs; and
    the benchmark's plain-torch C420 footage encode gives numpy's bytes."""
    from portbench.traffic.footage import encode_c420

    rng = np.random.default_rng(7)
    f = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8).astype(np.float32)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    u = (128.0 + 0.564 * (b - (0.299 * r + 0.587 * g + 0.114 * b))).reshape(32, 2, 48, 2)
    tl, tr, bl, br = u[:, 0, :, 0], u[:, 0, :, 1], u[:, 1, :, 0], u[:, 1, :, 1]
    assert np.array_equal(u.mean(axis=(1, 3)), ((tl + tr) + (bl + br)) / np.float32(4))
    assert not np.array_equal(u.mean(axis=(1, 3)), (((tl + tr) + bl) + br) / np.float32(4))
    frames = rng.integers(0, 256, (3, 64, 96, 3), dtype=np.uint8)
    assert np.array_equal(encode_c420(torch.from_numpy(frames)).numpy(),
                          numpy_planes(frames, True))


def test_encode_on_the_cpu_takes_the_plain_version():
    frames = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 6, 10, 3),
                                                               dtype=np.uint8))
    before = y4m.launches
    assert torch.equal(y4m.encode_y4m(frames, True), y4m.encode_y4m_plain(frames, True))
    assert y4m.launches == before


def test_encode_refuses_what_it_cannot_encode():
    with pytest.raises(ValueError, match="uint8"):
        y4m.encode_y4m(torch.zeros((1, 4, 4, 3), dtype=torch.float32), True)
    with pytest.raises(ValueError, match=r"\(N, H, W, 3\)"):
        y4m.encode_y4m(torch.zeros((4, 4, 3), dtype=torch.uint8), True)
    with pytest.raises(ValueError, match="even"):
        y4m.encode_y4m(torch.zeros((1, 5, 4, 3), dtype=torch.uint8), True)
    with pytest.raises(ValueError, match="device"):
        y4m._launch(torch.zeros((1, 4, 4, 3), dtype=torch.uint8), True)


@pytest.mark.parametrize("c420", [True, False], ids=["c420", "c444"])
def test_write_planes_writes_what_write_writes(tmp_path, c420):
    """A Y4M file written from encoded planes equals the one written from
    the BGR frames, byte for byte; planes of another size are refused."""
    frames = np.random.default_rng(2).integers(0, 256, (3, 8, 12, 3), dtype=np.uint8)
    planes = y4m.encode_y4m(torch.from_numpy(frames), c420).numpy()
    sub = "420" if c420 else "444"
    paths = [str(tmp_path / "bgr.y4m"), str(tmp_path / "planes.y4m")]
    writers = [VideoWriter(p, 30.0, (8, 12), subsampling=sub) for p in paths]
    for f, p in zip(frames, planes):
        writers[0].write(f)
        writers[1].write_planes(p)
    with pytest.raises(ValueError, match="bytes"):
        writers[1].write_planes(planes[0, :-1])
    for wr in writers:
        wr.close()
    assert [wr.frames for wr in writers] == [3, 3] and writers[1].encode_s == 0.0
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.gpu
@pytest.mark.parametrize("c420", [True, False], ids=["c420", "c444"])
def test_kernel_matches_plain_on_the_card(c420):
    """The kernel equals the plain version bit for bit at serving's shape
    (8 frames of 1080x1920) and at a width that is no multiple of 4, and at
    saturation; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(11)
    cases = [rng.integers(0, 256, (8, 1080, 1920, 3), dtype=np.uint8),
             rng.integers(0, 256, (3, 66, 98, 3), dtype=np.uint8), saturated_frames()]
    for frames in cases:
        host = torch.from_numpy(frames)
        before = y4m.launches
        got = y4m.encode_y4m(host.to(dev), c420)
        assert y4m.launches == before + 1
        assert got.device == dev
        assert torch.equal(got.cpu(), y4m.encode_y4m_plain(host, c420)), frames.shape
