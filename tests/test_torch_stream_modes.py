"""A mode switch on one stream of a batch (``parallel.set_stream_mode``, the
batched form of the reference app's G/T/R keys) and the batched step's
counters and stage ranges, on the CPU at a small size.

The switch is held to ``Stabilizer.set_stabilization_mode`` on that
stream alone; the mixed batched step through a switch is held bit for bit
to each stream's own body run in its own mode through the same switch (on
the CPU a batch of one rounds as the whole batch does).  No JAX here: the
mixed step's parity with the JAX package is tests/test_torch_mixed_modes.py's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from video_stabilization_tpu_torch.config import GFTTConfig, StabilizationMode, StabilizerConfig
from video_stabilization_tpu_torch.engine import Stabilizer, map_carry
from video_stabilization_tpu_torch.engine.offline import one_stream
from video_stabilization_tpu_torch.parallel import (
    Sharded, batched_counters, carry_stream, init_batched_carry, make_batched_step_fn,
    make_stream_mesh, reset_batched_counters, set_stream_mode, shard_carry, unshard)
from video_stabilization_tpu_torch.sim import (
    DEFAULT_APP_PARAMS, make_default_texture, render_frame, shake_trajectory)
from video_stabilization_tpu_torch.utils import prng
from torch_threads import one_torch_thread  # noqa: F401

M = StabilizationMode
# stream s's mode, and the switches made before a frame: {frame: [(stream, mode)]}
MODES = [M.GLOBAL_SMOOTHING, M.TRANSLATION_LOCK, M.ROTATION_LOCK]
SWITCHES = {3: [(1, M.ROTATION_LOCK), (2, M.GLOBAL_SMOOTHING)], 5: [(0, M.TRANSLATION_LOCK)]}
N_FRAMES = 7
LOCK_STATE = ("accum_h", "accum_active", "lock_prev_h", "last_lock_matches")


def tiny_config():
    return StabilizerConfig(past_frames=4, future_frames=1, working_height=96,
                            frame_height=120, frame_width=160,
                            gftt=GFTTConfig(max_features=64))


def clips(streams, n):
    """(n, streams, 120, 160, 3) u8: shaky simulator footage, stream s from
    trajectory seed 10 + s over one texture."""
    tex = torch.from_numpy(make_default_texture(np.random.default_rng(0), 128))
    out = []
    for s in range(streams):
        rng = np.random.default_rng(10 + s)
        traj = shake_trajectory(rng.standard_normal((n, 3)), rng.standard_normal(n),
                                DEFAULT_APP_PARAMS, pos_amplitude=0.003, roll_amplitude=0.3)
        out.append(torch.stack([render_frame(tex, traj[i], 120, 160) for i in range(n)]))
    return torch.stack(out, 1)


@pytest.fixture(scope="module")
def frames():
    return clips(len(MODES), N_FRAMES)


def filled_carry(n=4, seed=3):
    """A batched carry of ``n`` streams whose every tensor holds random
    values (lock state, references and window alike)."""
    gen = torch.Generator().manual_seed(seed)
    carry = init_batched_carry(tiny_config(), n, 0, prng.key(seed), "cpu")

    def fill(x):
        if x.dtype == torch.bool:
            return torch.rand(x.shape, generator=gen) > 0.5
        if x.dtype.is_floating_point:
            return torch.rand(x.shape, generator=gen).to(x.dtype)
        return torch.randint(0, 6, x.shape, generator=gen).to(x.dtype)

    return map_carry(fill, carry)


def carries_equal(a, b):
    same = []
    map_carry(lambda x, y: same.append(torch.equal(x, y)), a, b)
    return all(same)


def switched_alone(stream_carry, mode):
    """``Stabilizer.set_stabilization_mode`` on one stream's carry."""
    stab = Stabilizer(tiny_config(), device="cpu")
    stab.carry = stream_carry
    stab.set_stabilization_mode(mode)
    return stab.carry


@pytest.mark.parametrize("s, mode", [(0, M.ROTATION_LOCK), (2, M.GLOBAL_SMOOTHING),
                                     (3, M.ORB_FULL_LOCK)])
def test_switch_equals_the_stabilizers_on_that_stream(s, mode):
    """Stream s of the switched carry is ``set_stabilization_mode`` of
    stream s alone; every other stream, and stream s's window, frames and
    key, stay bit for bit; the given carry is left as it was."""
    carry = filled_carry()
    before = map_carry(torch.clone, carry)
    new = set_stream_mode(carry, s, int(mode))
    assert carries_equal(carry, before)
    assert carries_equal(carry_stream(new, s), switched_alone(carry_stream(before, s), mode))
    for other in range(4):
        if other != s:
            assert carries_equal(carry_stream(new, other), carry_stream(before, other))
    kept = dataclasses.replace(carry_stream(new, s), **{
        f: getattr(carry_stream(before, s), f)
        for f in ("mode", "orb_ref", "sift_ref") + LOCK_STATE})
    assert carries_equal(kept, carry_stream(before, s))


def test_switch_lands_on_the_right_slot():
    """On a two-slot ``Sharded`` carry of four streams, stream 3's switch
    changes slot 1's part alone and equals the switch of the unsharded
    carry."""
    carry = filled_carry()
    mesh = make_stream_mesh(["cpu", "cpu"])
    sharded = shard_carry(carry, mesh)
    new = set_stream_mode(sharded, 3, int(M.TRANSLATION_LOCK))
    assert isinstance(new, Sharded) and new.parts[0] is sharded.parts[0]
    assert not carries_equal(new.parts[1], sharded.parts[1])
    assert carries_equal(unshard(new), set_stream_mode(carry, 3, int(M.TRANSLATION_LOCK)))


def batched_run(frames, config):
    """The mixed batched step over ``frames`` from streams in ``MODES``,
    with ``SWITCHES`` made through ``set_stream_mode``: each frame's
    outputs and lock state."""
    carry = init_batched_carry(config, len(MODES), 0, prng.key(5), "cpu")
    for s, m in enumerate(MODES):
        carry = set_stream_mode(carry, s, int(m))
    step = make_batched_step_fn(config)
    got = []
    for t, f in enumerate(frames):
        for s, m in SWITCHES.get(t, ()):
            carry = set_stream_mode(carry, s, int(m))
        carry, (out, valid) = step(carry, f)
        assert bool(valid.all())
        got.append((out, {k: getattr(carry, k).clone() for k in LOCK_STATE}))
    return got


def test_mixed_step_through_switches_is_each_streams_own_run(frames):
    """Bit for bit, every stream of the mixed batch through ``SWITCHES``
    equals the body in the batched step's form run on that stream alone in
    its own mode, switched at the same frame by ``set_stabilization_mode``:
    outputs and lock state, frame by frame."""
    config = tiny_config()
    got = batched_run(frames, config)
    start = init_batched_carry(config, len(MODES), 0, prng.key(5), "cpu")
    for s, m in enumerate(MODES):
        carry, mode = carry_stream(start, s), m
        carry.mode = torch.tensor(int(mode), dtype=torch.int32)
        for t in range(N_FRAMES):
            for who, new_mode in SWITCHES.get(t, ()):
                if who == s:
                    carry, mode = switched_alone(carry, new_mode), new_mode
            carry, (out, _) = one_stream(carry, frames[t, s][None], config, "batched_mixed",
                                         modes=[int(mode)])
            where = f"stream {s} frame {t}"
            assert torch.equal(out[0], got[t][0][s]), where
            for k in LOCK_STATE:
                assert torch.equal(getattr(carry, k), got[t][1][k][s]), f"{where}: {k}"
    # the switches did something: stream 1's lock re-anchored at frame 3,
    # stream 2 left its lock there
    eye = torch.eye(3)
    assert not torch.equal(got[2][1]["accum_h"][1], eye)
    assert torch.equal(got[3][1]["accum_h"][1], eye) and bool(got[3][1]["accum_active"][1])
    assert bool(got[2][1]["accum_active"][2]) and not bool(got[3][1]["accum_active"][2])


def test_counters_count_calls_mode_reads_and_switches(frames):
    config = tiny_config()
    pinned = dataclasses.replace(config, static_mode=int(M.GLOBAL_SMOOTHING))
    reset_batched_counters()
    carry = init_batched_carry(config, 2, 0, prng.key(1), "cpu")
    carry = set_stream_mode(carry, 1, int(M.TRANSLATION_LOCK))
    step = make_batched_step_fn(config)
    for t in range(2):
        carry, _ = step(carry, frames[t, :2])
    carry, _ = step(carry, frames[2, :2], [0, int(M.TRANSLATION_LOCK)])   # modes given
    carry, _ = make_batched_step_fn(pinned)(carry, frames[3, :2])
    assert batched_counters["calls"] == 4
    assert batched_counters["mode_reads"] == 2
    assert batched_counters["switches"] == 1
    assert batched_counters["host_s"] > 0
    reset_batched_counters()
    assert batched_counters == {"calls": 0, "host_s": 0.0, "mode_reads": 0, "switches": 0}


def test_stage_ranges_only_while_profiling(frames):
    """``stage:mode_read`` shows once per mixed call and ``stage:mode_switch``
    once per switch, only while ``stage_profile.enabled`` is set."""
    from video_stabilization_tpu_torch.utils import stage_profile

    config = tiny_config()
    step = make_batched_step_fn(config)
    carry = init_batched_carry(config, 2, 0, prng.key(1), "cpu")
    seen = {}
    for on in (False, True):
        stage_profile.enabled = on
        try:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                carry = set_stream_mode(carry, 0, int(M.ROTATION_LOCK))
                carry, _ = step(carry, frames[0, :2])
        finally:
            stage_profile.enabled = False
        seen[on] = {e.key: e.count for e in prof.key_averages()
                    if e.key in ("stage:mode_read", "stage:mode_switch")}
    assert seen[False] == {}
    assert seen[True] == {"stage:mode_read": 1, "stage:mode_switch": 1}
