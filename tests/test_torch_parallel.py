"""The port's stream-batched forms (parallel/streams.py,
engine/offline.py::make_offline_batched_fn) against the JAX package's and
against the port's own single-stream step.

Mirrors tests/test_parallel.py (TestBatchedStep, TestShardedStep on
one-device meshes and on meshes of 2, 4 and 8 "cpu" slots, bit for bit
against the one-device batched forms) and the batched parts of
tests/test_offline.py at
``tiny_config()``'s size.  Two JAX functions are compiled, once each: the
batched step in GLOBAL_SMOOTHING and the stream-batched offline chunk in
ACCUMULATED_FULL_LOCK (two streams, K = 3), which serves both the offline
comparison and the envelope telemetry.

Tolerances are the JAX tests' own, with equal inlier counts throughout:
- the port's batched forms against its single-stream step,
  tests/test_parallel.py's: u8 outputs off by at most one level on fewer
  than 1e-3 of the pixels;
- the port against the JAX package, tests/test_offline.py's
  ``_assert_frames_close`` (at most one level on at most 2% of the pixels,
  as tests/test_torch_offline.py holds the offline chunk to JAX's) and the
  step's corner drift of tests/test_torch_engine.py.  The single-stream
  steps of the two packages already differ there: on stream 1's frame 5
  below, 0.137% of the pixels by one level, ``last_h`` by 8e-4, while the
  port's batched step equals its single-stream step on that frame.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stabilization_tpu.config import StabilizationMode
from video_stabilization_tpu.engine import make_offline_batched_fn as j_make_offline_batched_fn
from video_stabilization_tpu.parallel import init_batched_carry as j_init_batched_carry
from video_stabilization_tpu.parallel import make_batched_step_fn as j_make_batched_step_fn
from video_stabilization_tpu_torch.config import config_from_fields
from video_stabilization_tpu_torch.engine import (
    Stabilizer, carry_to_numpy, map_carry, offline_batched_chunk_step, offline_chunk_step)
from video_stabilization_tpu_torch.parallel import (
    Sharded, carry_stream, init_batched_carry, init_sharded_carry, make_batched_scan_fn,
    make_batched_step_fn, make_sharded_offline_fn, make_sharded_step_fn, make_stream_mesh,
    shard_carry, unshard)
from video_stabilization_tpu_torch.engine import make_offline_batched_fn
from video_stabilization_tpu_torch.sim import (
    DEFAULT_APP_PARAMS, make_default_texture, render_frame, shake_trajectory)
from video_stabilization_tpu_torch.utils import prng
from test_offline import _assert_frames_close
from test_parallel import FH, FW, tiny_config
from test_torch_engine import LAST_H_DRIFT, corner_drift, jax_carry_arrays
from torch_threads import one_torch_thread  # noqa: F401

M = StabilizationMode
N_STREAMS, N_FRAMES = 4, 6
ACCUM = dataclasses.replace(tiny_config(), static_mode=int(M.ACCUMULATED_FULL_LOCK))
MAX_DIFFER = 1e-3        # share of pixels off by one level (tests/test_parallel.py)
SHARDED_STREAMS = 8      # streams of the sharded tests: one per slot on 8 slots
SLOTS = [2, 4, 8]        # mesh sizes of the sharded tests, "cpu" repeated


def assert_frames_close(a, b, where=""):
    """u8 frames off by at most one level on fewer than ``MAX_DIFFER`` of
    the pixels: vmap and batching change float order, so a pixel on a .5
    rounding boundary may flip."""
    diff = np.abs(np.asarray(a).astype(np.int16) - np.asarray(b).astype(np.int16))
    assert diff.max() <= 1, f"{where}: max diff {diff.max()}"
    assert (diff > 0).mean() < MAX_DIFFER, f"{where}: {(diff > 0).mean():.5f} of pixels differ"


def render_streams(n_streams, n_frames=N_FRAMES):
    """(T, S, H, W, 3) u8: ``n_streams`` streams of shaky frames, stream s
    from trajectory seed 10 + s, over one texture (the port's simulator;
    both packages take the same frames)."""
    tex = torch.from_numpy(make_default_texture(np.random.default_rng(0), 128))
    streams = []
    for s in range(n_streams):
        rng = np.random.default_rng(10 + s)
        traj = shake_trajectory(rng.standard_normal((n_frames, 3)),
                                rng.standard_normal(n_frames), DEFAULT_APP_PARAMS,
                                pos_amplitude=0.003, roll_amplitude=0.3)
        streams.append(np.stack([render_frame(tex, traj[i], FH, FW).numpy()
                                 for i in range(n_frames)]))
    return np.stack(streams, 1)


@pytest.fixture(scope="module")
def stream_frames():
    """Four streams of six frames (:func:`render_streams`)."""
    return render_streams(N_STREAMS)


@pytest.fixture(scope="module")
def eight_streams():
    """Eight streams of six frames, as the JAX tests' 8-device mesh takes."""
    return render_streams(SHARDED_STREAMS)


@pytest.fixture(scope="module")
def j_offline_accum():
    """The JAX stream-batched offline chunk, ACCUMULATED_FULL_LOCK, compiled
    once for two streams and K = 3."""
    return j_make_offline_batched_fn(ACCUM)


def port_carry(cfg, n, mode, seed):
    return init_batched_carry(config_from_fields(cfg), n, int(mode), prng.key(seed), "cpu")


@pytest.mark.parametrize("seed,n", [(7, 4), (0, 8), (2 ** 32 - 1, 3)])
def test_split_matches_jax(seed, n):
    want = np.asarray(jax.random.key_data(jax.random.split(jax.random.key(seed), n)))
    got = prng.split(prng.key(seed), n).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_init_batched_carry_matches_jax():
    """Every tensor of the port's batched carry equals the JAX one's."""
    cfg = tiny_config()
    want = jax_carry_arrays(j_init_batched_carry(cfg, 3, 0, jax.random.key(7)))
    got = carry_to_numpy(port_carry(cfg, 3, 0, 7))
    assert set(got) == set(want)
    for name, arr in want.items():
        np.testing.assert_array_equal(got[name], arr, err_msg=name)


def test_batched_step_matches_jax(stream_frames):
    """Four streams, six frames: the port's batched step against the JAX
    package's ``make_batched_step_fn`` from carries made from one seed."""
    cfg = tiny_config()
    jstep = j_make_batched_step_fn(cfg)
    tstep = make_batched_step_fn(config_from_fields(cfg))
    jc = j_init_batched_carry(cfg, N_STREAMS, 0, jax.random.key(7))
    tc = port_carry(cfg, N_STREAMS, 0, 7)
    for t in range(N_FRAMES):
        jc, (jout, _) = jstep(jc, jnp.asarray(stream_frames[t]))
        tc, (tout, valid) = tstep(tc, torch.from_numpy(stream_frames[t]))
        assert tout.shape == (N_STREAMS, FH, FW, 3) and valid.all()
        for s in range(N_STREAMS):
            _assert_frames_close(tout[s].numpy(), np.asarray(jout[s]))
            drift = corner_drift(np.asarray(jc.last_h[s], float),
                                 tc.last_h[s].double().numpy(), cfg)
            assert drift <= LAST_H_DRIFT, f"stream {s} frame {t}: last_h drift {drift}"
        np.testing.assert_array_equal(tc.last_inliers.numpy(), np.asarray(jc.last_inliers))
        np.testing.assert_array_equal(tc.n.numpy(), np.asarray(jc.n))
        np.testing.assert_array_equal(tc.envelope_violations.numpy(),
                                      np.asarray(jc.envelope_violations))


def test_batched_matches_single(stream_frames):
    """TestBatchedStep::test_batched_matches_single on the port: each
    stream of the batched step against the single-stream step on its own
    slice of the batched carry (the slices are copies: the single steps
    leave the batched ring alone)."""
    cfg = config_from_fields(tiny_config())
    bstep = make_batched_step_fn(cfg)
    bcarry = port_carry(tiny_config(), N_STREAMS, 0, 7)
    singles = []
    for s in range(N_STREAMS):
        one = Stabilizer(cfg, M.GLOBAL_SMOOTHING, device="cpu")
        one.carry = carry_stream(bcarry, s)
        singles.append(one)
    for t in range(N_FRAMES):
        bcarry, (bout, _) = bstep(bcarry, torch.from_numpy(stream_frames[t]))
        for s, one in enumerate(singles):
            sout = one.stabilize_frame(stream_frames[t, s])
            assert_frames_close(bout[s].numpy(), sout.numpy(), f"stream {s} frame {t}")
            assert int(bcarry.last_inliers[s]) == int(one.carry.last_inliers)
    for s, one in enumerate(singles):
        assert torch.equal(bcarry.frames[s], one.carry.frames)
        assert torch.equal(bcarry.key[s], one.carry.key)


def test_batched_scan_matches_step(stream_frames):
    """The scan over T frames is T batched steps (bit for bit)."""
    cfg = config_from_fields(tiny_config())
    c_scan, (outs, valid) = make_batched_scan_fn(cfg)(
        port_carry(tiny_config(), N_STREAMS, 0, 3), torch.from_numpy(stream_frames[:3]))
    assert outs.shape == (3, N_STREAMS, FH, FW, 3) and valid.shape == (3, N_STREAMS)
    step = make_batched_step_fn(cfg)
    c = port_carry(tiny_config(), N_STREAMS, 0, 3)
    for t in range(3):
        c, (out, _) = step(c, torch.from_numpy(stream_frames[t]))
        assert torch.equal(out, outs[t])
    assert torch.equal(c.last_h, c_scan.last_h)


def test_streams_keep_their_own_frame_counters(stream_frames):
    """Streams at different frame counts in one batched chunk: each keeps
    its own ``fold_in`` keys, ring slots and window.  Stream 1 has already
    taken four frames; each stream of the batched chunk against its own
    single-stream chunk."""
    cfg = config_from_fields(tiny_config())
    fresh = port_carry(tiny_config(), 2, 0, 5)
    ahead, _ = offline_chunk_step(carry_stream(fresh, 1),
                                  torch.from_numpy(stream_frames[:4, 1]), cfg)
    starts = [carry_stream(fresh, 0), ahead]
    batched = map_carry(lambda *xs: torch.stack(xs), *starts)      # copies
    assert batched.n.tolist() == [0, 4]
    chunk = torch.from_numpy(np.stack([stream_frames[:3, 0], stream_frames[3:6, 1]]))
    batched, (outs, _) = offline_batched_chunk_step(batched, chunk, cfg)
    for s, c in enumerate(starts):
        c, (out, _) = offline_chunk_step(c, chunk[s], cfg)
        assert_frames_close(outs[s].numpy(), out.numpy(), f"stream {s}")
        assert torch.equal(batched.frames[s], c.frames)
        np.testing.assert_allclose(batched.transforms[s].numpy(), c.transforms.numpy(),
                                   atol=1e-6)
    assert batched.n.tolist() == [3, 7]


def test_offline_batched_matches_jax(stream_frames, j_offline_accum):
    """Two streams, two chunks of K = 3, ACCUMULATED_FULL_LOCK: the port's
    ``make_offline_batched_fn`` against the JAX package's (K below the JAX
    ring fault of ROADMAP Queue 3, which needs K >= past_frames + 2)."""
    fn = make_offline_batched_fn(config_from_fields(ACCUM))
    jc = j_init_batched_carry(ACCUM, 2, int(M.ACCUMULATED_FULL_LOCK), jax.random.key(4))
    tc = port_carry(ACCUM, 2, M.ACCUMULATED_FULL_LOCK, 4)
    for i in (0, 3):
        chunk = np.swapaxes(stream_frames[i:i + 3, :2], 0, 1)      # (S, K, H, W, C)
        jc, (jout, _) = j_offline_accum(jc, jnp.asarray(chunk))
        tc, (tout, valid) = fn(tc, torch.from_numpy(chunk))
        assert tout.shape == chunk.shape and valid.shape == (2, 3)
        for s in range(2):
            _assert_frames_close(tout[s].numpy(), np.asarray(jout[s]))
        np.testing.assert_array_equal(tc.last_inliers.numpy(), np.asarray(jc.last_inliers))
    for s in range(2):
        for name in ("accum_h", "last_h"):
            drift = corner_drift(np.asarray(getattr(jc, name)[s], float),
                                 getattr(tc, name)[s].double().numpy(), ACCUM)
            assert drift <= LAST_H_DRIFT, f"stream {s} {name} drift {drift}"
    assert tc.n.tolist() == [6, 6]


def test_envelope_violation_telemetry(stream_frames, j_offline_accum):
    """tests/test_offline.py::test_envelope_violation_telemetry with the JAX
    function's counts: stream 1's accumulated lock turned 25° past the
    warp's ~9° envelope, 8 frames in; the stream-batched chunk (no output
    fallback) counts each of its frames, stream 0 none.  Two chunks of
    K = 3 (the JAX test's K = 4 at past 2 meets the JAX ring fault, and
    pixels outside the envelope differ between the JAX Pallas copy budget
    and the port's 2-pass warp, so only the counts are compared)."""
    th = np.deg2rad(25.0)
    big_rot = np.array([[np.cos(th), -np.sin(th), 0.0], [np.sin(th), np.cos(th), 0.0],
                        [0.0, 0.0, 1.0]], np.float32)
    accum = np.stack([np.eye(3, dtype=np.float32), big_rot])
    mode = int(M.ACCUMULATED_FULL_LOCK)
    jc = j_init_batched_carry(ACCUM, 2, mode, jax.random.key(0))
    jc = jc._replace(accum_h=jnp.asarray(accum), accum_active=jnp.ones((2,), bool),
                     n=jnp.full((2,), 8, jnp.int32))
    tc = port_carry(ACCUM, 2, mode, 0)
    tc = dataclasses.replace(tc, accum_h=torch.from_numpy(accum),
                             accum_active=torch.ones(2, dtype=torch.bool),
                             n=torch.full((2,), 8, dtype=torch.int32))
    fn = make_offline_batched_fn(config_from_fields(ACCUM))
    for i in (0, 3):
        chunk = np.swapaxes(stream_frames[i:i + 3, :1].repeat(2, 1), 0, 1)
        jc, _ = j_offline_accum(jc, jnp.asarray(chunk))
        tc, _ = fn(tc, torch.from_numpy(chunk))
    viol = tc.envelope_violations.tolist()
    assert viol[0] == 0 and viol[1] >= 4, viol
    assert viol == np.asarray(jc.envelope_violations).tolist()


def test_sharded_matches_batched(stream_frames):
    """TestShardedStep::test_sharded_matches_batched on a one-device mesh:
    equal outputs."""
    cfg = config_from_fields(tiny_config())
    mesh = make_stream_mesh(["cpu"])
    sstep = make_sharded_step_fn(cfg, mesh)
    bstep = make_batched_step_fn(cfg)
    cs = shard_carry(port_carry(tiny_config(), N_STREAMS, 0, 2), mesh)
    cb = port_carry(tiny_config(), N_STREAMS, 0, 2)
    frames = torch.from_numpy(np.repeat(stream_frames[0, :1], N_STREAMS, 0))
    for _ in range(2):
        cs, (outs, _) = sstep(cs, frames)
        cb, (outb, _) = bstep(cb, frames)
    assert torch.equal(outs, outb)


def test_sharded_offline_matches_streaming(stream_frames):
    """TestShardedStep::test_sharded_offline_matches_streaming on a
    one-device mesh: a K = 3 chunk of every stream against stream 0's
    streaming step."""
    cfg = config_from_fields(tiny_config())
    mesh = make_stream_mesh(["cpu"])
    k = 3
    frames = np.repeat(stream_frames[:k, :1], N_STREAMS, 1)
    co = shard_carry(port_carry(tiny_config(), N_STREAMS, 0, 3), mesh)
    co, (outs_o, _) = make_sharded_offline_fn(cfg, mesh)(
        co, torch.from_numpy(np.swapaxes(frames, 0, 1)))
    one = Stabilizer(cfg, M.GLOBAL_SMOOTHING, device="cpu")
    one.carry = carry_stream(port_carry(tiny_config(), N_STREAMS, 0, 3), 0)
    outs_s = np.stack([one.stabilize_frame(frames[t, 0]).numpy() for t in range(k)])
    diff = np.abs(outs_o[0].numpy().astype(np.int16) - outs_s.astype(np.int16))
    assert diff.max() <= 1
    assert co.n.tolist() == [k] * N_STREAMS


def carries_equal(a, b):
    """Every tensor of two (unsharded) carries equal, bit for bit."""
    same = []
    map_carry(lambda x, y: same.append(torch.equal(x, y)), a, b)
    return all(same)


@pytest.mark.parametrize("n_slots", SLOTS)
def test_sharded_step_matches_batched_on_slots(eight_streams, n_slots):
    """TestShardedStep::test_sharded_matches_batched on meshes of 2, 4 and 8
    "cpu" slots: the sharded step of eight streams equals the one-device
    batched step of all eight bit for bit, outputs, validity and carry, on
    every frame; the carry stays ``Sharded`` on its slots."""
    cfg = config_from_fields(tiny_config())
    mesh = make_stream_mesh(["cpu"] * n_slots)
    sstep, bstep = make_sharded_step_fn(cfg, mesh), make_batched_step_fn(cfg)
    cs = shard_carry(port_carry(tiny_config(), SHARDED_STREAMS, 0, 2), mesh)
    cb = port_carry(tiny_config(), SHARDED_STREAMS, 0, 2)
    for t in range(4):
        frames = torch.from_numpy(eight_streams[t])
        cs, (outs, valid_s) = sstep(cs, frames)
        cb, (outb, valid_b) = bstep(cb, frames)
        assert isinstance(cs, Sharded) and len(cs.parts) == n_slots
        assert [tuple(o.shape) for o in outs.parts] == \
            [(SHARDED_STREAMS // n_slots, FH, FW, 3)] * n_slots
        assert torch.equal(unshard(outs), outb), f"frame {t}"
        assert torch.equal(unshard(valid_s), valid_b)
    assert carries_equal(unshard(cs), cb)


@pytest.mark.parametrize("n_slots", SLOTS)
def test_sharded_offline_matches_batched_on_slots(eight_streams, n_slots):
    """TestShardedStep's offline case on meshes of 2, 4 and 8 "cpu" slots:
    two K = 3 chunks of eight streams through the sharded chunk equal the
    one-device stream-batched chunk of all eight bit for bit."""
    cfg = config_from_fields(tiny_config())
    mesh = make_stream_mesh(["cpu"] * n_slots)
    soff, boff = make_sharded_offline_fn(cfg, mesh), make_offline_batched_fn(cfg)
    cs = shard_carry(port_carry(tiny_config(), SHARDED_STREAMS, 0, 3), mesh)
    cb = port_carry(tiny_config(), SHARDED_STREAMS, 0, 3)
    for i in (0, 3):
        chunk = torch.from_numpy(np.swapaxes(eight_streams[i:i + 3], 0, 1))
        cs, (outs, valid_s) = soff(cs, chunk)
        cb, (outb, valid_b) = boff(cb, chunk)
        assert torch.equal(unshard(outs), outb), f"chunk at {i}"
        assert torch.equal(unshard(valid_s), valid_b)
    assert carries_equal(unshard(cs), cb)
    assert unshard(cs.parts[0].n).tolist() == [6] * (SHARDED_STREAMS // n_slots)


@pytest.mark.parametrize("n_slots", SLOTS)
def test_shard_carry_on_slots(n_slots):
    """``shard_carry`` gives slot d streams d·S/D to (d+1)·S/D − 1 as
    copies; ``unshard`` joins them back, ``carry_stream`` finds stream s in
    its slot, and ``map_carry`` maps part by part; ``init_sharded_carry``,
    which makes each part on its slot's device, equals it."""
    carry = port_carry(tiny_config(), SHARDED_STREAMS, 0, 9)
    mesh = make_stream_mesh(["cpu"] * n_slots)
    sharded = shard_carry(carry, mesh)
    per = SHARDED_STREAMS // n_slots
    assert isinstance(sharded, Sharded) and len(sharded.parts) == n_slots
    for d, part in enumerate(sharded.parts):
        assert torch.equal(part.key, carry.key[d * per:(d + 1) * per])
        assert part.frames.data_ptr() != carry.frames.data_ptr()
    assert carries_equal(unshard(sharded), carry)
    for s in (0, per, SHARDED_STREAMS - 1):
        assert carries_equal(carry_stream(sharded, s), carry_stream(carry, s))
    doubled = map_carry(lambda x: x * 2 if x.is_floating_point() else x, sharded)
    assert isinstance(doubled, Sharded)
    assert torch.equal(unshard(doubled).last_h, carry.last_h * 2)
    made = init_sharded_carry(config_from_fields(tiny_config()), SHARDED_STREAMS, 0,
                              prng.key(9), mesh)
    assert all(carries_equal(a, b) for a, b in zip(made.parts, sharded.parts))


def test_sharding_refuses_uneven_streams_and_wrong_placement():
    """Streams that do not split evenly over the slots raise ``ValueError``
    (as JAX's ``NamedSharding`` does), in ``shard_carry`` and for frames;
    so do a plain carry on a mesh of several slots, a sharded carry on a
    mesh of another size, and a slot's carry off its device."""
    cfg = config_from_fields(tiny_config())
    carry = port_carry(tiny_config(), 6, 0, 0)
    with pytest.raises(ValueError, match="6 streams do not split evenly over a mesh of 4"):
        shard_carry(carry, ["cpu"] * 4)
    mesh = make_stream_mesh(["cpu"] * 3)
    step = make_sharded_step_fn(cfg, mesh)
    sharded = shard_carry(carry, mesh)
    with pytest.raises(ValueError, match="4 streams do not split evenly over a mesh of 3"):
        step(sharded, torch.zeros((4, FH, FW, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="shard_carry it"):
        step(carry, torch.zeros((6, FH, FW, 3), dtype=torch.uint8))
    with pytest.raises(ValueError, match="shard_carry it"):
        make_sharded_step_fn(cfg, ["cpu"] * 2)(sharded, torch.zeros((6, FH, FW, 3),
                                                                    dtype=torch.uint8))
    moved = Sharded(sharded.parts[:2] + (map_carry(lambda x: x.to("meta"), sharded.parts[2]),))
    with pytest.raises(ValueError, match="slot 2: carry on meta"):
        step(moved, torch.zeros((6, FH, FW, 3), dtype=torch.uint8))


@pytest.mark.parametrize("make", [make_batched_step_fn, make_batched_scan_fn,
                                  make_offline_batched_fn, "sharded_step", "sharded_offline",
                                  "offline_chunk_step", "stabilize_clip_offline",
                                  "stabilize_streams_sharded"])
def test_batched_forms_require_static_mode(make, stream_frames):
    """Without a pinned mode the offline chunk forms and serving are
    refused, as the JAX package refuses them; the batched step, its scan and
    the sharded step run each stream in its own ``carry.mode``
    (tests/test_torch_mixed_modes.py holds them to JAX): here two streams in
    GLOBAL_SMOOTHING and ACCUMULATED_FULL_LOCK, two frames."""
    from video_stabilization_tpu_torch.engine import stabilize_clip_offline
    from video_stabilization_tpu_torch.serve import stabilize_streams_sharded

    cfg = config_from_fields(dataclasses.replace(tiny_config(), static_mode=None))
    mesh = make_stream_mesh(["cpu"])
    runs = {make_batched_step_fn: lambda: make_batched_step_fn(cfg),
            "sharded_step": lambda: make_sharded_step_fn(cfg, mesh)}
    if make in runs or make == make_batched_scan_fn:
        carry = port_carry(tiny_config(), 2, M.GLOBAL_SMOOTHING, 1)
        carry.mode[1] = int(M.ACCUMULATED_FULL_LOCK)
        frames = torch.from_numpy(stream_frames[:2, :2])
        if make in runs:
            step = runs[make]()
            for f in frames:
                carry, (out, valid) = step(carry, f)
        else:
            carry, (out, valid) = make_batched_scan_fn(cfg)(carry, frames)
        assert out.shape[-4:] == (2, FH, FW, 3) and bool(valid.all())
        assert carry.accum_active.tolist() == [False, True]
        assert carry.mode.tolist() == [int(M.GLOBAL_SMOOTHING), int(M.ACCUMULATED_FULL_LOCK)]
        return
    one = port_carry(tiny_config(), 1, M.GLOBAL_SMOOTHING, 0)
    clip = torch.from_numpy(stream_frames[:2, 0])
    with pytest.raises(ValueError, match="requires config.static_mode"):
        if make == "sharded_offline":
            make_sharded_offline_fn(cfg, mesh)
        elif make == "offline_chunk_step":
            offline_chunk_step(map_carry(lambda x: x[0], one), clip, cfg)
        elif make == "stabilize_clip_offline":
            stabilize_clip_offline(map_carry(lambda x: x[0], one), clip, cfg, chunk=2)
        elif make == "stabilize_streams_sharded":
            stabilize_streams_sharded(clip[None], cfg, mesh, chunk=2)
        else:
            make(cfg)


def test_batched_chunk_refuses_frames_off_the_carry_device():
    """Frames on another device than the batched carry's are refused before
    any stage runs; so is a frame batch of another stream count."""
    cfg = config_from_fields(tiny_config())
    carry = port_carry(tiny_config(), 2, 0, 0)
    step = make_batched_step_fn(cfg)
    with pytest.raises(ValueError, match="carry's device"):
        step(carry, torch.empty((2, FH, FW, 3), dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError, match="frames of 3 streams for a carry of 2"):
        step(carry, torch.zeros((3, FH, FW, 3), dtype=torch.uint8))
