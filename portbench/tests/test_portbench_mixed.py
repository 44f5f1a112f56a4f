"""The live batched cells ``cfg5.step`` and ``cfg5.mixed`` on the CPU at a
small size: the mixed-mode reference (``reference/mixed.py``) held to the
program through switches and to itself from step 0, faults of the switch
coming out not correct, a program without the switch or the counters, and
the two readers."""

import dataclasses

import pytest
import torch

from portbench import harness, reference, trace
from portbench.drivers import batched_step
from portbench.reference import config as rc
from portbench.reference import mixed
from portbench.tests.conftest import cpu_context
from portbench.traffic import footage
from video_stabilization_tpu_torch import config as pc
from video_stabilization_tpu_torch import parallel
from video_stabilization_tpu_torch.parallel import streams
from video_stabilization_tpu_torch.utils import prng

M = rc.StabilizationMode
KW = dict(frame_height=120, frame_width=160, working_height=96, past_frames=6, future_frames=3)
TRAFFIC = dict(footage_frames=8, texture_size=512, trajectory_seed_offset=5,
               pos_amplitude=0.004, roll_amplitude=0.3, smoothness=0.8)
SEED, KEY = 2**31 + 77, 11
CYCLE = [int(M.GLOBAL_SMOOTHING), int(M.TRANSLATION_LOCK), int(M.ROTATION_LOCK)]
STREAMS, STEPS = 4, 34
# stream s switches to the cycle's next mode before steps 3·(s+1) + 12·i
MODES0 = [CYCLE[s % 3] for s in range(STREAMS)]
SWITCHES = {}
for _s in range(STREAMS):
    for _i, _t in enumerate(range(3 * (_s + 1), STEPS, 12)):
        SWITCHES.setdefault(_t, []).append((_s, CYCLE[(_s + _i + 1) % 3]))
# the cell on the CPU with a switch every other step, every feed every 16
FAST_SWITCHES = dict(switch_spacing=2, switch_period=16)


@pytest.fixture(scope="module")
def foot():
    return footage.render_streams(TRAFFIC, 120, 160, STREAMS, SEED, "cpu")


def frames_at(foot):
    def at(steps):
        return foot[:, [footage.pingpong(j, 8) for j in steps]]
    return at


def ref_config():
    return rc.StabilizerConfig(**KW, gftt=rc.GFTTConfig(max_features=130))


@pytest.fixture(scope="module")
def program_outputs(foot):
    """(S, STEPS, H, W, 3): the program's mixed batched step through
    ``SWITCHES``, each made with ``set_stream_mode`` before its step."""
    cfg = pc.StabilizerConfig(**KW, gftt=pc.GFTTConfig(max_features=130))
    carry = parallel.init_batched_carry(cfg, STREAMS, 0, prng.key(KEY), "cpu")
    for s, m in enumerate(MODES0):
        carry = parallel.set_stream_mode(carry, s, m)
    step = parallel.make_batched_step_fn(cfg)
    outs = []
    for j in range(STEPS):
        for s, m in SWITCHES.get(j, ()):
            carry = parallel.set_stream_mode(carry, s, m)
        carry, (out, valid) = step(carry, foot[:, footage.pingpong(j, 8)])
        assert bool(valid.all())
        outs.append(out)
    return torch.stack(outs, 1)


def test_the_mixed_reference_equals_the_program_through_switches(foot, program_outputs):
    """From its bounded start, over the last steps (every stream switched
    twice or more, the lock streams re-anchored), the reference equals the
    program bit for bit; and the schedule did put streams in every mode."""
    first = 22
    start = mixed.start_step(ref_config(), MODES0, SWITCHES, first)
    assert 0 < start <= first - (ref_config().total_window - 1)
    ref = mixed.mixed_outputs(ref_config(), MODES0, SWITCHES, frames_at(foot),
                              reference.prng.key(KEY), first, STEPS, "cpu")
    assert torch.equal(program_outputs[:, first:], ref)
    assert set(mixed.modes_at(MODES0, SWITCHES, first)) == set(CYCLE)


def test_the_bounded_start_equals_a_replay_from_step_0(foot, program_outputs):
    first = 26
    got = {start: mixed.mixed_outputs(ref_config(), MODES0, SWITCHES, frames_at(foot),
                                      reference.prng.key(KEY), first, STEPS, "cpu",
                                      start=start)
           for start in (None, 0)}
    assert torch.equal(got[None], got[0])
    assert torch.equal(got[0], program_outputs[:, first:])


def test_start_steps_follow_the_lock_anchors():
    cfg = ref_config()          # W = 10, F = 3
    sw = {20: [(0, int(M.TRANSLATION_LOCK))], 22: [(1, int(M.GLOBAL_SMOOTHING))],
          35: [(0, int(M.GLOBAL_SMOOTHING))]}
    modes0 = [int(M.GLOBAL_SMOOTHING), int(M.ROTATION_LOCK)]
    # both in smoothing: the window's start
    assert mixed.start_step(cfg, modes0, sw, 40) == 31
    # stream 0 locked since 20: three steps before its anchor
    assert mixed.start_step(cfg, modes0, sw, 30) == 17
    # stream 1 locked since step 0
    assert mixed.start_step(cfg, modes0, sw, 21) == 0
    with pytest.raises(ValueError):
        mixed.mixed_outputs(cfg, [int(M.ORB_FULL_LOCK)], {}, None, None, 0, 1, "cpu")


def run_cell(name, **overrides):
    cell = harness.find_cell(name)
    ctx = cpu_context(cell)
    ctx.overrides = {**ctx.overrides, **overrides}
    outcome = batched_step.run(ctx)
    return outcome, harness.result_line(cell, outcome, False, {"platform": "cpu"})


def test_the_schedule_of_the_configuration():
    sched = batched_step.Schedule(cpu_context(harness.find_cell("cfg5.mixed")))
    assert sched.modes0 == [CYCLE[s % 3] for s in range(8)]
    assert sched.switches_at(30) == [(0, int(M.TRANSLATION_LOCK))]
    assert sched.switches_at(60) == [(1, int(M.ROTATION_LOCK))]
    assert sched.switches_at(270) == [(0, int(M.ROTATION_LOCK))]
    assert sched.switches_at(31) == [] and len(sched.until(481)) == 16
    pinned = batched_step.Schedule(cpu_context(harness.find_cell("cfg5.step")))
    assert pinned.pinned and pinned.switches_at(30) == [] and set(pinned.modes0) == {0}


def test_the_mixed_cell_runs_correct_through_switches():
    outcome, line = run_cell("cfg5.mixed", **FAST_SWITCHES)
    assert line["correct"] is True, line["checks"]
    assert outcome.layer["batched"]["switches"] > 0
    assert outcome.layer["batched"]["mode_reads"] == outcome.layer["batched"]["calls"]


def _faulty_switch(fault):
    switch = parallel.set_stream_mode
    swap = {int(M.TRANSLATION_LOCK): int(M.ROTATION_LOCK),
            int(M.ROTATION_LOCK): int(M.TRANSLATION_LOCK)}

    def wrong_mode(carry, s, mode):
        return switch(carry, s, swap.get(int(mode), int(mode)))

    def keeps_lock_state(carry, s, mode):
        modes = carry.mode.clone()
        modes[s] = int(mode)
        return dataclasses.replace(carry, mode=modes)

    return {"wrong_mode": wrong_mode, "keeps_lock_state": keeps_lock_state}[fault]


def _late_switches(monkeypatch):
    """Each switch made after the next step instead of before it."""
    switch, make = parallel.set_stream_mode, parallel.make_batched_step_fn
    pending = []

    def deferred(carry, s, mode):
        if int(carry.n.max()) == 0:         # the feeds' first modes, before any step
            return switch(carry, s, mode)
        pending.append((s, mode))
        return carry

    def make_late(config):
        step = make(config)

        def late(carry, frames, modes=None):
            carry, result = step(carry, frames, modes)
            while pending:
                carry = switch(carry, *pending.pop(0))
            return carry, result
        return late

    monkeypatch.setattr(parallel, "set_stream_mode", deferred)
    monkeypatch.setattr(parallel, "make_batched_step_fn", make_late)


@pytest.mark.parametrize("fault", ["wrong_mode", "keeps_lock_state", "one_step_late"])
def test_a_faulty_switch_comes_out_not_correct(fault, monkeypatch):
    if fault == "one_step_late":
        _late_switches(monkeypatch)
    else:
        monkeypatch.setattr(parallel, "set_stream_mode", _faulty_switch(fault))
    outcome, line = run_cell("cfg5.mixed", **FAST_SWITCHES)
    assert line["correct"] is False
    assert outcome.checks["out_bytes_off"]["value"] > outcome.checks["out_bytes_off"]["limit"]


def test_a_program_without_the_switch_or_the_counters(monkeypatch):
    """As the parent program: ``cfg5.mixed`` fails at once on the missing
    switch; ``cfg5.step`` runs correct, without the batched counters'
    metric."""
    monkeypatch.delattr(parallel, "set_stream_mode")
    with pytest.raises(AttributeError):
        run_cell("cfg5.mixed")
    monkeypatch.delattr(streams, "reset_batched_counters")
    outcome, line = run_cell("cfg5.step")
    assert line["correct"] is True and outcome.layer["batched"] is None
    assert harness.load_metric("engine.enqueue_ms.batched").read(
        outcome, harness.find_cell("cfg5.step")) is None


def _outcome(layer=None, t=None):
    return harness.Outcome(frames=1, window_s=1.0, setup_s=1.0, attempted=1, failed=0,
                           checks={}, memory_peak_bytes=0, trace=t, layer=layer or {})


@pytest.mark.parametrize("name", ["cfg5.step", "cfg5.mixed"])
def test_the_readers_with_and_without_their_counters(name):
    cell = harness.find_cell(name)
    enqueue = harness.load_metric("engine.enqueue_ms.batched")
    launches = harness.load_metric("device.launches_per_step.batched")
    counted = {"calls": 4, "host_s": 0.32, "mode_reads": 4, "switches": 1}
    assert enqueue.read(_outcome({"batched": counted}), cell) == pytest.approx(80.0)
    for layer in ({}, {"batched": None}, {"batched": dict(counted, calls=0)}):
        assert enqueue.read(_outcome(layer), cell) is None
    t = trace.Slice(busy_s=0.1, window_s=0.4, launches=13200, calls=4, stream_frames=32,
                    kernel_s={}, stage_device_s={}, idle_s={})
    assert launches.read(_outcome(t=t), cell) == 3300
    assert launches.read(_outcome(), cell) is None
    assert launches.read(_outcome(t=dataclasses.replace(t, launches=0)), cell) is None
