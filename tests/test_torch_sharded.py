"""The port's stream-sharded forms (parallel/streams.py over a mesh of
several slots) against the JAX package's on its virtual 8-device CPU mesh
(tests/conftest.py), and a sharded carry's checkpoint file.

Mirrors tests/test_parallel.py's TestShardedStep on meshes of 2, 4 and 8
"cpu" slots, at ``tiny_config()``'s size on eight streams of the port's
simulator.  Two JAX functions are compiled, once each: the sharded step
(GLOBAL_SMOOTHING) and the sharded offline chunk (K = 3, below the JAX ring
fault of ROADMAP Queue 3, which needs K >= past_frames + 2).  Against the
JAX package: equal inlier counts, the step's corner drift, and PERF.md §2's
offline bound per frame (at most 2% of the pixels differ, at most 0.1% by
more than one level; tests/test_torch_offline.py's
``assert_frames_close_gather``).  tests/test_torch_parallel.py's
one-level bound does not hold on these eight streams: on stream 7
(trajectory seed 17) the port's transform differs from JAX's by 3e-3 px at
frames 2 and 3 (f32 sums in another order), and one pixel on the image's
edge flips between the border colour and content (3 and 6 values of 57,600
off by up to 158).  The port's one-device batched step does the same
against JAX's batched step; sharding changes nothing there.  Against the
port's own one-device batched forms the sharded ones are equal bit for bit
(tests/test_torch_parallel.py).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stabilization_tpu import serve as jserve
from video_stabilization_tpu.engine.checkpoint import load_carry as j_load_carry
from video_stabilization_tpu.parallel import init_batched_carry as j_init_batched_carry
from video_stabilization_tpu.parallel import make_sharded_offline_fn as j_make_sharded_offline_fn
from video_stabilization_tpu.parallel import make_sharded_step_fn as j_make_sharded_step_fn
from video_stabilization_tpu.parallel import make_stream_mesh as j_make_stream_mesh
from video_stabilization_tpu.parallel.streams import shard_carry as j_shard_carry
from video_stabilization_tpu_torch import serve
from video_stabilization_tpu_torch.config import config_from_fields
from video_stabilization_tpu_torch.engine import carry_to_numpy, load_carry, save_carry
from video_stabilization_tpu_torch.parallel import (
    init_batched_carry, make_sharded_offline_fn, make_sharded_step_fn, make_stream_mesh,
    shard_carry, unshard)
from video_stabilization_tpu_torch.utils import prng
from test_parallel import tiny_config
from test_torch_engine import LAST_H_DRIFT, corner_drift, jax_carry_arrays
from test_torch_offline import assert_frames_close_gather
from test_torch_parallel import SHARDED_STREAMS, SLOTS, carries_equal, port_carry, render_streams
from torch_threads import one_torch_thread  # noqa: F401

N_FRAMES, K = 6, 3


@pytest.fixture(scope="module")
def frames():
    """(T, S, H, W, 3) u8: eight streams of six frames."""
    return render_streams(SHARDED_STREAMS, N_FRAMES)


def run_jax(make, frames_of, n_calls, seed):
    """The JAX function ``make(cfg, mesh)`` on the 8-device mesh from
    carries of ``seed``: per call its outputs and inlier counts, and the
    final carry."""
    cfg = tiny_config()
    mesh = j_make_stream_mesh()
    assert len(mesh.devices) == SHARDED_STREAMS
    fn = make(cfg, mesh)
    carry = j_shard_carry(j_init_batched_carry(cfg, SHARDED_STREAMS, 0, jax.random.key(seed)),
                          mesh)
    calls = []
    for i in range(n_calls):
        carry, (out, _) = fn(carry, jnp.asarray(frames_of(i)))
        calls.append((np.asarray(out), np.asarray(carry.last_inliers)))
    return calls, carry


@pytest.fixture(scope="module")
def jax_step_run(frames):
    """JAX's sharded step over the six frames, compiled once."""
    return run_jax(j_make_sharded_step_fn, lambda t: frames[t], N_FRAMES, 2)


@pytest.fixture(scope="module")
def jax_offline_run(frames):
    """JAX's sharded offline chunk over two chunks of K = 3, compiled once."""
    return run_jax(j_make_sharded_offline_fn,
                   lambda i: np.swapaxes(frames[i * K:(i + 1) * K], 0, 1), N_FRAMES // K, 3)


def check_against_jax(port_calls, jax_calls, port_carry_, jax_carry):
    for i, ((tout, tinl), (jout, jinl)) in enumerate(zip(port_calls, jax_calls)):
        assert tout.shape == jout.shape
        frame = tout.shape[-3:]             # per frame of each stream (K of a chunk)
        for a, b in zip(tout.reshape((-1,) + frame), jout.reshape((-1,) + frame)):
            assert_frames_close_gather(a, b)
        np.testing.assert_array_equal(tinl, jinl, err_msg=f"call {i}: inlier counts")
    cfg = tiny_config()
    for s in range(SHARDED_STREAMS):
        drift = corner_drift(np.asarray(jax_carry.last_h[s], float),
                             port_carry_.last_h[s].double().numpy(), cfg)
        assert drift <= LAST_H_DRIFT, f"stream {s}: last_h drift {drift}"
    np.testing.assert_array_equal(port_carry_.n.numpy(), np.asarray(jax_carry.n))


@pytest.mark.parametrize("n_slots", SLOTS)
def test_sharded_step_matches_jax(frames, jax_step_run, n_slots):
    """The port's sharded step on 2, 4 and 8 "cpu" slots against JAX's
    ``make_sharded_step_fn`` on its 8-device mesh, frame by frame."""
    mesh = make_stream_mesh(["cpu"] * n_slots)
    step = make_sharded_step_fn(config_from_fields(tiny_config()), mesh)
    carry = shard_carry(port_carry(tiny_config(), SHARDED_STREAMS, 0, 2), mesh)
    calls = []
    for t in range(N_FRAMES):
        carry, (out, _) = step(carry, torch.from_numpy(frames[t]))
        calls.append((unshard(out).numpy(), unshard(carry).last_inliers.numpy()))
    check_against_jax(calls, jax_step_run[0], unshard(carry), jax_step_run[1])


@pytest.mark.parametrize("n_slots", SLOTS)
def test_sharded_offline_matches_jax(frames, jax_offline_run, n_slots):
    """The port's sharded offline chunk on 2, 4 and 8 "cpu" slots against
    JAX's ``make_sharded_offline_fn`` on its 8-device mesh, chunk by
    chunk."""
    mesh = make_stream_mesh(["cpu"] * n_slots)
    fn = make_sharded_offline_fn(config_from_fields(tiny_config()), mesh)
    carry = shard_carry(port_carry(tiny_config(), SHARDED_STREAMS, 0, 3), mesh)
    calls = []
    for i in range(N_FRAMES // K):
        chunk = np.swapaxes(frames[i * K:(i + 1) * K], 0, 1)
        carry, (out, valid) = fn(carry, torch.from_numpy(chunk))
        assert bool(unshard(valid).all())
        calls.append((unshard(out).numpy(), unshard(carry).last_inliers.numpy()))
    check_against_jax(calls, jax_offline_run[0], unshard(carry), jax_offline_run[1])


@pytest.mark.parametrize("n_devices,n_streams", [(8, 8), (8, 6), (4, 2), (2, 3)])
def test_pick_serving_devices_on_meshes(n_devices, n_streams):
    """The port picks as many mesh slots as JAX picks devices of its 8-device
    mesh, the first of the given ones, repeated entries included."""
    mesh = make_stream_mesh(["cpu"] * n_devices)
    got = serve.pick_serving_devices(mesh, n_streams)
    want = jserve.pick_serving_devices(jax.devices()[:n_devices], n_streams)
    assert len(got) == len(want) and got == mesh[:len(got)]


@pytest.mark.parametrize("n_slots", [2, 4])
def test_sharded_checkpoint(frames, tmp_path, n_slots):
    """A sharded carry's checkpoint equals the file of the same carry
    unsharded, array for array, in leaf order; it loads in the JAX
    package's ``load_carry`` with equal leaves; and ``load_carry`` then
    ``shard_carry`` restores it, so a chunk after the restore equals one
    after the save."""
    cfg = config_from_fields(tiny_config())
    mesh = make_stream_mesh(["cpu"] * n_slots)
    fn = make_sharded_offline_fn(cfg, mesh)
    carry = shard_carry(port_carry(tiny_config(), SHARDED_STREAMS, 0, 4), mesh)
    carry, _ = fn(carry, torch.from_numpy(np.swapaxes(frames[:K], 0, 1)))
    sharded_path, plain_path = str(tmp_path / "sharded.npz"), str(tmp_path / "plain.npz")
    save_carry(sharded_path, carry)
    save_carry(plain_path, unshard(carry))
    a, b = np.load(sharded_path), np.load(plain_path)
    assert sorted(a.files) == sorted(b.files)
    for name in a.files:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    meta = json.loads(bytes(a["__meta__"]).decode())
    assert meta[0]["name"] == ".frames" and meta[-1]["name"] == ".key"

    loaded = j_load_carry(sharded_path, j_init_batched_carry(tiny_config(), SHARDED_STREAMS, 0,
                                                             jax.random.key(0)))
    want, got = carry_to_numpy(unshard(carry)), jax_carry_arrays(loaded)
    assert set(got) == set(want)
    for name, arr in want.items():
        np.testing.assert_array_equal(got[name], arr, err_msg=name)

    template = init_batched_carry(cfg, SHARDED_STREAMS, 0, prng.key(0), "cpu")
    restored = shard_carry(load_carry(sharded_path, template), mesh)
    assert carries_equal(unshard(restored), unshard(carry))
    nxt = torch.from_numpy(np.swapaxes(frames[K:2 * K], 0, 1))
    _, (out_a, _) = fn(carry, nxt)
    _, (out_b, _) = fn(restored, nxt)
    assert torch.equal(unshard(out_a), unshard(out_b))


@pytest.mark.parametrize("form", ["offline", "step", "step_mixed_modes"])
def test_slot_ranges_over_two_slots(frames, form):
    """Over a mesh of two "cpu" slots, ``stage:slot0`` and ``stage:slot1``
    each show once per call (around the slot's enqueue), and once more per
    call where the modes are read (no static mode), only while
    ``stage_profile.enabled`` is set."""
    import dataclasses

    from video_stabilization_tpu_torch.utils import stage_profile

    cfg = config_from_fields(tiny_config())
    if form == "step_mixed_modes":
        cfg = dataclasses.replace(cfg, static_mode=None)
    mesh = make_stream_mesh(["cpu", "cpu"])
    make = make_sharded_offline_fn if form == "offline" else make_sharded_step_fn
    fn = make(cfg, mesh)
    carry = shard_carry(port_carry(tiny_config(), 2, 0, 4), mesh)
    clip = np.swapaxes(frames[:K, :2], 0, 1)                 # (2, K, H, W, 3)
    calls = [torch.from_numpy(clip)] if form == "offline" else \
        [torch.from_numpy(clip[:, i]) for i in range(2)]
    seen = {}
    for on in (False, True):
        stage_profile.enabled = on
        try:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                for x in calls:
                    carry, _ = fn(carry, x)
        finally:
            stage_profile.enabled = False
        seen[on] = {e.key[6:]: e.count for e in prof.key_averages()
                    if e.key.startswith("stage:slot")}
    per_call = 2 if form == "step_mixed_modes" else 1
    assert seen[False] == {}
    assert seen[True] == {"slot0": per_call * len(calls), "slot1": per_call * len(calls)}


class _Clock:
    """A ``time`` stand-in whose ``perf_counter`` moves by one a read."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1.0
        return self.t


@pytest.mark.parametrize("n_slots", [4, 1])
def test_mesh_counters(frames, monkeypatch, n_slots):
    """``parallel.streams.mesh_counters`` over ``["cpu"] * n_slots``: each
    call adds one to ``calls``, its wall to ``dispatch_s`` (at least the
    sum of its slots' enqueues) and one enqueue to each slot's entry (two
    clock reads a slot, two a call); a reset clears them; each slot's
    outputs of a counted call equal its streams through the one-device
    chunk, which no counter sees."""
    from video_stabilization_tpu_torch.engine import make_offline_batched_fn, map_carry
    from video_stabilization_tpu_torch.parallel import Sharded, streams

    cfg = config_from_fields(tiny_config())
    mesh = make_stream_mesh(["cpu"] * n_slots)
    per = SHARDED_STREAMS // n_slots
    fn = make_sharded_offline_fn(cfg, mesh)
    chunk = make_offline_batched_fn(cfg)
    carry = shard_carry(port_carry(tiny_config(), SHARDED_STREAMS, 0, 5), mesh)
    alone = [map_carry(torch.clone, c)
             for c in (carry.parts if isinstance(carry, Sharded) else (carry,))]

    def call(i):
        nonlocal carry
        clip = torch.from_numpy(np.swapaxes(frames[i * K:(i + 1) * K], 0, 1))
        carry, (out, valid) = fn(carry, clip)
        outs, valids = (out.parts, valid.parts) if n_slots > 1 else ((out,), (valid,))
        for d in range(n_slots):
            alone[d], (want, ok) = chunk(alone[d], clip[d * per:(d + 1) * per])
            assert torch.equal(outs[d], want) and torch.equal(valids[d], ok), f"slot {d}"

    streams.reset_mesh_counters()
    call(0)
    got = streams.mesh_counters
    assert got["calls"] == 1 and len(got["enqueue_s"]) == n_slots
    assert min(got["enqueue_s"]) > 0
    assert got["dispatch_s"] >= sum(got["enqueue_s"]) >= max(got["enqueue_s"])
    streams.reset_mesh_counters()
    assert streams.mesh_counters == {"calls": 0, "dispatch_s": 0.0, "enqueue_s": []}
    monkeypatch.setattr(streams, "time", _Clock())
    call(1)
    assert streams.mesh_counters == {"calls": 1, "dispatch_s": 2.0 * n_slots + 1,
                                     "enqueue_s": [1.0] * n_slots}


@pytest.mark.parametrize("form", ["sharded offline", "batched step"])
def test_entry_points_compute_in_float32(frames, monkeypatch, form):
    """With TF32 turned on by the caller, either way torch offers, dense
    LK's box sums run with cuBLAS in float32 ("ieee") inside a call, and
    the caller's setting reads as it was after it."""
    from video_stabilization_tpu_torch.ops import lk_dense
    from video_stabilization_tpu_torch.parallel import make_batched_step_fn

    seen = []
    box_same = lk_dense._box_same

    def spy(*args, **kwargs):
        seen.append(torch.backends.cuda.matmul.fp32_precision)
        return box_same(*args, **kwargs)

    monkeypatch.setattr(lk_dense, "_box_same", spy)
    cfg = config_from_fields(tiny_config())
    clip = torch.from_numpy(np.swapaxes(frames[:K, :2], 0, 1))     # (2, K, H, W, 3)
    matmul = torch.backends.cuda.matmul
    before = matmul.fp32_precision
    try:
        for turn_on, reads in [(lambda: setattr(matmul, "allow_tf32", True),
                                lambda: matmul.allow_tf32),
                               (lambda: setattr(matmul, "fp32_precision", "tf32"),
                                lambda: matmul.fp32_precision)]:
            turn_on()
            want = reads()
            carry = port_carry(tiny_config(), 2, 0, 6)
            if form == "sharded offline":
                mesh = make_stream_mesh(["cpu"] * 2)
                make_sharded_offline_fn(cfg, mesh)(shard_carry(carry, mesh), clip)
            else:
                make_batched_step_fn(cfg)(carry, clip[:, 0])
            assert reads() == want
            assert seen and set(seen) == {"ieee"}
            seen.clear()
    finally:
        matmul.fp32_precision = before
