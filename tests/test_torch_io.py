"""The port's frame IO (io/video.py, io/native.py), its YUV decode
(ops/image.py), the simulator's movement controls, its timing utilities and
its checkpoint files, against the JAX package's.

Mirrors tests/test_io_cli.py's TestNative and TestSimulatorSource and the
engine's checkpoint round trip.  The port's YUV decode equals the native
reader's C++ conversion bit for bit; the compiled JAX function differs
from both by one level on a few pixels, where XLA:CPU fuses the BT.601
products into fused multiply-adds (ROADMAP Queue 3), and equals them
everywhere else.
"""

import dataclasses
import hashlib
import json
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stabilization_tpu.io.video import SimulatorSource as JSimulatorSource
from video_stabilization_tpu.io.video import VideoWriter as JVideoWriter
from video_stabilization_tpu.ops.image import yuv_flat_to_bgr as j_yuv_flat_to_bgr
import video_stabilization_tpu.sim as jsim
from video_stabilization_tpu_torch.io import SimulatorSource, VideoWriter, open_source
from video_stabilization_tpu_torch.io import native
from video_stabilization_tpu_torch.io.native import (
    NativeFrameRing, NativeY4MReader, PrefetchingFileSource, PrefetchingYUVSource)
from video_stabilization_tpu_torch.io.video import encode_y4m_planes
from video_stabilization_tpu_torch.ops.image import yuv_flat_to_bgr, yuv_planes_to_bgr
import video_stabilization_tpu_torch.sim as tsim
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
FH, FW = 48, 64


def random_frames(n, h=FH, w=FW, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


def write_clip(path, frames, subsampling="444", writer=VideoWriter):
    wr = writer(str(path), 30.0, frames[0].shape[:2], subsampling=subsampling)
    for f in frames:
        wr.write(f)
    wr.close()
    return str(path)


@pytest.fixture(scope="module")
def j_decode():
    """The compiled JAX decode, one compile per shape and chroma mode."""
    return jax.jit(j_yuv_flat_to_bgr, static_argnums=(1, 2, 3))


@pytest.mark.parametrize("subsampling", ["444", "420"])
def test_yuv_decode_matches_native_and_jax(tmp_path, j_decode, subsampling):
    """Raw planes from ``read_yuv_block`` decoded by the port equal the
    native reader's host conversion bit for bit; the compiled JAX decode
    equals them except on the pixels where its fused multiply-adds round to
    the next level."""
    path = write_clip(tmp_path / "clip.y4m", random_frames(3), subsampling)
    host = NativeY4MReader(path)
    raw = NativeY4MReader(path)
    c420 = subsampling == "420"
    assert raw.is_c420 == c420
    block = raw.read_yuv_block(4)
    assert block.shape == (3, raw.yuv_bytes) and raw.read_yuv_block(4) is None
    want = np.stack([host.read() for _ in range(3)])
    assert host.read() is None
    got = yuv_flat_to_bgr(torch.from_numpy(block), FH, FW, c420).numpy()
    np.testing.assert_array_equal(got, want)
    jx = np.asarray(j_decode(jnp.asarray(block), FH, FW, c420))
    diff = np.abs(jx.astype(np.int16) - got.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3, f"{(diff > 0).mean():.5f} of the values differ from JAX"
    host.close()
    raw.close()


def test_yuv_planes_upsample_and_odd_refusal():
    """C420 chroma repeats each sample over its 2x2 block; odd C420 sizes
    are refused."""
    y = torch.full((4, 6), 100, dtype=torch.uint8)
    u = torch.arange(6, dtype=torch.uint8).reshape(2, 3) + 126
    v = torch.full((2, 3), 128, dtype=torch.uint8)
    bgr = yuv_planes_to_bgr(y, u, v)
    assert bgr.shape == (4, 6, 3)
    for yy in range(4):
        for xx in range(6):
            assert int(bgr[yy, xx, 0]) == int(bgr[yy // 2 * 2, xx // 2 * 2, 0])
    with pytest.raises(ValueError, match="even"):
        yuv_flat_to_bgr(torch.zeros(5 * 6 * 3 // 2, dtype=torch.uint8), 5, 6, True)


@pytest.mark.parametrize("subsampling", ["444", "420"])
def test_video_writer_bytes_match_jax(tmp_path, subsampling):
    frames = random_frames(3, seed=4)
    a = write_clip(tmp_path / "port.y4m", frames, subsampling)
    b = write_clip(tmp_path / "jax.y4m", frames, subsampling, writer=JVideoWriter)
    assert Path(a).read_bytes() == Path(b).read_bytes()
    header = Path(a).read_bytes().split(b"\n", 1)[0]
    assert header == f"YUV4MPEG2 W{FW} H{FH} F30:1 Ip A1:1 C{subsampling}".encode()
    with open(a, "rb") as f:
        f.readline()
        assert f.read(6) == b"FRAME\n"
        assert f.read(len(encode_y4m_planes(frames[0], subsampling == "420"))) \
            == encode_y4m_planes(frames[0], subsampling == "420")


def test_video_writer_refuses_odd_c420(tmp_path):
    with pytest.raises(ValueError, match="even"):
        VideoWriter(str(tmp_path / "x.y4m"), 30.0, (5, 8), subsampling="420")


def test_ring_fifo_order():
    ring = NativeFrameRing(4, (4, 4, 3))
    frames = [np.full((4, 4, 3), i, np.uint8) for i in range(4)]
    for f in frames:
        assert ring.push(f)
    assert ring.size() == 4
    for f in frames:
        np.testing.assert_array_equal(ring.pop(), f)
    ring.close()
    assert ring.pop(timeout_ms=50) is None


def test_ring_blocking_timeout():
    ring = NativeFrameRing(1, (2, 2, 3))
    assert ring.pop(timeout_ms=20) is None                # empty: pop times out
    assert ring.push(np.zeros((2, 2, 3), np.uint8))
    assert not ring.push(np.zeros((2, 2, 3), np.uint8), timeout_ms=50)   # full
    with pytest.raises(ValueError, match="bytes"):
        ring.push(np.zeros((3, 3, 3), np.uint8))
    ring.close()
    assert not ring.push(np.zeros((2, 2, 3), np.uint8), timeout_ms=50)   # closed
    assert ring.pop() is not None and ring.pop() is None  # drained, then EOF


def test_y4m_roundtrip(tmp_path):
    frames = random_frames(3, 16, 24)
    r = NativeY4MReader(write_clip(tmp_path / "clip.y4m", frames))
    assert r.frame_size == (16, 24) and r.fps == 30.0 and not r.is_c420
    for f in frames:
        got = r.read()
        assert np.abs(got.astype(int) - f.astype(int)).mean() < 4.0
    assert r.read() is None
    r.close()


def test_read_yuv_block_into_a_given_buffer(tmp_path):
    path = write_clip(tmp_path / "clip.y4m", random_frames(5), "420")
    a, b = NativeY4MReader(path), NativeY4MReader(path)
    buf = torch.zeros((2, a.yuv_bytes), dtype=torch.uint8)
    got = a.read_yuv_block(2, out=buf.numpy())
    assert np.shares_memory(got, buf.numpy())
    np.testing.assert_array_equal(buf.numpy(), np.stack([b.read_yuv(), b.read_yuv()]))
    assert a.read_yuv_block(4).shape == (3, a.yuv_bytes)
    with pytest.raises(ValueError, match="C-contiguous"):
        a.read_yuv_block(2, out=np.zeros((3, a.yuv_bytes), np.uint8))
    a.close()
    b.close()


def test_prefetching_yuv_source(tmp_path):
    path = write_clip(tmp_path / "clip.y4m",
                      [np.full((12, 16, 3), i * 10, np.uint8) for i in range(5)], "420")
    src = PrefetchingYUVSource(NativeY4MReader(path), depth=3)
    assert src.is_c420
    want = NativeY4MReader(path)
    got = []
    while (f := src.read()) is not None:
        got.append(f)
    assert len(got) == 5
    for g in got:
        np.testing.assert_array_equal(g, want.read_yuv())
    src.close()
    want.close()


def test_prefetching_file_source(tmp_path):
    frames = [np.full((12, 16, 3), i * 10, np.uint8) for i in range(6)]
    src = PrefetchingFileSource(NativeY4MReader(write_clip(tmp_path / "clip.y4m", frames)),
                                depth=3)
    got = []
    while (f := src.read()) is not None:
        got.append(f)
    assert len(got) == 6
    src.close()


def native_snapshot():
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((REPO / "native").iterdir())}


def test_native_library_built_outside_native(tmp_path):
    """A fresh process builds the library from native/framebuf.cpp into the
    build directory (here a temporary one) and loads it from there;
    native/, and the library committed in it, stay untouched."""
    before = native_snapshot()
    code = (
        "from pathlib import Path\n"
        "from video_stabilization_tpu_torch.io import native\n"
        f"native.BUILD_DIR = Path({str(tmp_path)!r})\n"
        "lib = native._load()\n"
        "assert Path(lib._name) == native.lib_path(), lib._name\n"
        "assert Path(lib._name).parent == Path(native.BUILD_DIR)\n"
        "ring = native.NativeFrameRing(2, (3,))\n"
        "print(Path(lib._name).name)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    name = proc.stdout.strip()
    assert name.startswith("libframebuf-") and (tmp_path / name).exists()
    assert [p.name for p in tmp_path.iterdir()] == [name]      # no temporary left
    assert native_snapshot() == before
    assert native.lib_path().parent == REPO / "build" / "native"


MOVES = ["move_forward", "move_backward", "move_left", "move_right", "move_up", "move_down",
         "roll_clockwise", "roll_counterclockwise"]


@pytest.mark.parametrize("name", MOVES)
def test_movement_matches_jax(name):
    """Each movement function, applied three times from the demo pose
    (between other moves), gives JAX's pose."""
    jp, tp = jsim.DEFAULT_APP_PARAMS, tsim.DEFAULT_APP_PARAMS
    for i, step in enumerate([name, "roll_clockwise", name, "move_left", name]):
        amount = 0.5 + 0.25 * i
        jp = getattr(jsim, step)(jp, amount)
        tp = getattr(tsim, step)(tp, amount)
    np.testing.assert_allclose(tp.position.numpy(), np.asarray(jp.position), atol=1e-6)
    for field in ("pan", "tilt", "roll", "focal_length"):
        np.testing.assert_allclose(float(getattr(tp, field)), float(getattr(jp, field)),
                                   atol=1e-5, err_msg=field)


def test_simulator_source_render_move_and_pose_text():
    """The port's source: frames of the requested size, a move changes the
    view, "p" resets it; its pose lines equal JAX's after the same keys."""
    src = SimulatorSource(frame_size=(60, 80), device="cpu")
    jsrc = JSimulatorSource.__new__(JSimulatorSource)   # pose only: no texture, no compile
    jsrc.params = jsim.DEFAULT_APP_PARAMS
    f0 = src.read()
    assert f0.shape == (60, 80, 3) and f0.dtype == np.uint8
    assert torch.equal(src.read_tensor(), torch.from_numpy(f0))
    for key in "dw qe c":
        src.move(key)
        jsrc.move(key)
        assert src.pose_text() == jsrc.pose_text()
    assert not np.array_equal(src.read(), f0)
    src.move("p")
    np.testing.assert_array_equal(src.read(), f0)
    assert open_source("simulator", frame_size=(60, 80), device="cpu").fps == 30.0
    with pytest.raises(ValueError, match="unknown input mode"):
        open_source("tape")


def test_simulator_source_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this checks the refusal without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        SimulatorSource(frame_size=(60, 80))


def test_honest_time_and_stage_timer():
    """``honest_time`` on the CPU times the calls; ``StageTimer`` keeps the
    JAX package's rolling average."""
    from video_stabilization_tpu.utils.timing import StageTimer as JStageTimer
    from video_stabilization_tpu_torch.utils.timing import StageTimer, honest_time

    calls = []
    ms = honest_time(lambda x: calls.append(x.sum()), torch.ones(4), iters=3, warmup=2)
    assert len(calls) == 5 and ms >= 0.0
    a, b = StageTimer(), JStageTimer()
    for i, x in enumerate([3.0, 5.0, 10.0, 1.5]):
        for t in (a, b):
            t.record("frame", x)
            t.record("warp", 2 * x + i)
    assert a.averages() == b.averages()


# --- checkpoint files --------------------------------------------------------

def small_config():
    from video_stabilization_tpu.config import StabilizerConfig

    return StabilizerConfig(frame_height=120, frame_width=160, working_height=100,
                            past_frames=2, future_frames=1)


def _filled_port_carry(cfg, mode, seed, s=None):
    from video_stabilization_tpu_torch.config import config_from_fields
    from video_stabilization_tpu_torch.engine import init_carry
    from video_stabilization_tpu_torch.parallel import init_batched_carry
    from video_stabilization_tpu_torch.utils import prng

    tcfg = config_from_fields(cfg)
    if s is None:
        carry = init_carry(tcfg, mode, prng.key(seed), "cpu")
    else:
        carry = init_batched_carry(tcfg, s, mode, prng.key(seed), "cpu")
    rng = np.random.default_rng(seed)
    carry.frames.copy_(torch.from_numpy(rng.integers(0, 256, carry.frames.shape,
                                                     dtype=np.uint8)))
    carry.n.fill_(7)
    carry.orb_ref.desc.copy_(torch.from_numpy(rng.integers(-128, 128, carry.orb_ref.desc.shape,
                                                           dtype=np.int8)))
    carry.sift_ref.is_set.fill_(True)
    carry.last_h.copy_(torch.from_numpy(rng.normal(size=carry.last_h.shape).astype(np.float32)))
    return carry


def _jax_template(cfg, mode, seed, s=None):
    if s is None:
        from video_stabilization_tpu.engine.state import init_carry

        return init_carry(cfg, mode, jax.random.key(seed))
    from video_stabilization_tpu.parallel import init_batched_carry

    return init_batched_carry(cfg, s, mode, jax.random.key(seed))


@pytest.mark.parametrize("streams", [None, 2])
def test_checkpoint_port_file_loads_in_jax(tmp_path, streams):
    """A file the port saves loads in the JAX package with equal leaves (the
    key as its words), one stream or two."""
    from video_stabilization_tpu.engine.checkpoint import load_carry as j_load
    from video_stabilization_tpu_torch.engine import carry_to_numpy, save_carry
    from test_torch_engine import jax_carry_arrays

    cfg = small_config()
    carry = _filled_port_carry(cfg, 1, 3, streams)
    path = str(tmp_path / "port.npz")
    save_carry(path, carry)
    meta = json.loads(bytes(np.load(path)["__meta__"]).decode())
    assert meta[0] == {"kind": "array", "name": ".frames"}
    assert meta[-1] == {"kind": "prng_key", "name": ".key"}
    loaded = j_load(path, _jax_template(cfg, 0, 0, streams))
    want = carry_to_numpy(carry)
    got = jax_carry_arrays(loaded)
    assert set(got) == set(want)
    for name, arr in want.items():
        assert got[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(got[name], arr, err_msg=name)


@pytest.mark.parametrize("streams", [None, 2])
def test_checkpoint_jax_file_loads_in_port(tmp_path, streams):
    """A file the JAX package saves loads in the port with equal leaves, and
    a ``Stabilizer`` that resumes from it takes its host mode from it."""
    from video_stabilization_tpu.engine.checkpoint import load_carry as j_load
    from video_stabilization_tpu.engine.checkpoint import save_carry as j_save
    from video_stabilization_tpu_torch.config import StabilizationMode, config_from_fields
    from video_stabilization_tpu_torch.engine import (
        Stabilizer, carry_to_numpy, load_carry, save_carry)
    from test_torch_engine import jax_carry_arrays

    cfg = small_config()
    # a JAX carry with content: the port's filled carry through JAX's loader
    src = str(tmp_path / "seed.npz")
    save_carry(src, _filled_port_carry(cfg, int(StabilizationMode.ROTATION_LOCK), 5, streams))
    jcarry = j_load(src, _jax_template(cfg, 0, 0, streams))
    path = str(tmp_path / "jax.npz")
    j_save(path, jcarry)
    template = _filled_port_carry(cfg, 0, 0, streams)
    got = carry_to_numpy(load_carry(path, template))
    want = jax_carry_arrays(jcarry)
    assert set(got) == set(want)
    for name, arr in want.items():
        assert got[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(got[name], arr, err_msg=name)
    if streams is None:
        stab = Stabilizer(config_from_fields(cfg), device="cpu")
        assert stab.mode == int(StabilizationMode.GLOBAL_SMOOTHING)
        stab.resume(path)
        assert stab.mode == int(StabilizationMode.ROTATION_LOCK)
        assert int(stab.carry.n) == 7


def test_checkpoint_template_checks(tmp_path):
    """Another configuration's shapes raise; a field the file lacks keeps
    the template's value and a field the template lacks is ignored, each
    with a warning."""
    from video_stabilization_tpu_torch.config import config_from_fields
    from video_stabilization_tpu_torch.engine import init_carry, load_carry, save_carry
    from video_stabilization_tpu_torch.utils import prng

    cfg = small_config()
    carry = _filled_port_carry(cfg, 0, 1)
    path = str(tmp_path / "c.npz")
    save_carry(path, carry)
    other = dataclasses.replace(cfg, past_frames=3)
    with pytest.raises(ValueError, match="shape"):
        load_carry(path, init_carry(config_from_fields(other), 0, prng.key(0), "cpu"))

    data = dict(np.load(path))
    meta = json.loads(bytes(data["__meta__"]).decode())
    i_n = next(i for i, m in enumerate(meta) if m["name"] == ".n")
    meta[i_n]["name"] = ".retired"
    data["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    drifted = str(tmp_path / "drifted.npz")
    np.savez(drifted, **data)
    template = init_carry(config_from_fields(cfg), 0, prng.key(0), "cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        loaded = load_carry(drifted, template)
    messages = " ".join(str(w.message) for w in caught)
    assert "no entry for carry field .n" in messages and ".retired" in messages
    assert int(loaded.n) == 0 and torch.equal(loaded.frames, carry.frames)
