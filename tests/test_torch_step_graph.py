"""When ``Stabilizer`` replays its step as a CUDA graph, on the CPU.

A graph cannot be captured here, so the tests of the replay's bookkeeping
put a stand-in in ``StepGraph``'s place that reruns the captured function
on every replay, as a graph reruns its kernels on the same tensors: the
static input, the carry written back in place, adoption of a carry put in
its place, the fresh outputs and the counters.  No JAX reference."""

import numpy as np
import pytest
import torch

from video_stabilization_tpu_torch.config import (
    GFTTConfig, RansacConfig, StabilizationMode, StabilizerConfig)
from video_stabilization_tpu_torch.engine import Stabilizer, map_carry, stabilize_step
from video_stabilization_tpu_torch.engine import stabilizer as stab_mod
from video_stabilization_tpu_torch.engine.checkpoint import save_carry
from video_stabilization_tpu_torch.engine.state import init_carry
from video_stabilization_tpu_torch.utils import prng

GS = StabilizationMode.GLOBAL_SMOOTHING
ACCUM = StabilizationMode.ACCUMULATED_FULL_LOCK


def tiny_config(**kw):
    kw.setdefault("gftt", GFTTConfig(max_features=64))
    return StabilizerConfig(past_frames=4, future_frames=2, working_height=96,
                            frame_height=120, frame_width=160, **kw)


def clip(n, seed=0):
    """n (120, 160, 3) u8 frames: one texture of 4x4 blocks, shaken by up to
    3 pixels a frame."""
    rng = np.random.default_rng(seed)
    tex = rng.integers(0, 256, (40, 55, 3), dtype=np.uint8)
    tex = np.repeat(np.repeat(tex, 4, 0), 4, 1)
    shifts = 20 + rng.integers(-3, 4, (n, 2))
    return np.stack([tex[y:y + 120, x:x + 160] for y, x in shifts])


class RerunGraph:
    """``StepGraph``'s stand-in: each replay reruns the captured function."""

    def __init__(self, fn, device):
        self.fn = fn

    def replay(self):
        return self.fn()


@pytest.fixture
def replaying(monkeypatch):
    """``Stabilizer`` on the CPU takes the replay path, with
    :class:`RerunGraph` for the graph."""
    monkeypatch.setattr(stab_mod, "step_replays", lambda config, device: True)
    monkeypatch.setattr(stab_mod, "StepGraph", RerunGraph)
    stab_mod.reset_step_counters()


def carry_equal(a, b):
    eq = []
    map_carry(lambda x, y: eq.append(torch.equal(x, y)), a, b)
    return all(eq)


def test_cpu_step_counts_calls_and_never_replays():
    """On the CPU the step stays eager: the counters count its calls, with
    no replay and no capture."""
    stab_mod.reset_step_counters()
    stab = Stabilizer(tiny_config(), device="cpu")
    assert stab._graphs is None
    for f in clip(3):
        stab.stabilize_frame(f)
    assert stab_mod.step_counters == {"calls": 3, "replays": 0, "captures": 0}


@pytest.mark.parametrize("name,config", [
    ("rigid", tiny_config()),
    ("homography model", tiny_config(ransac=RansacConfig(motion_model="homography"))),
    ("cv2exact ransac", tiny_config(ransac=RansacConfig(method="cv2exact"))),
    ("host gftt", tiny_config(gftt=GFTTConfig(max_features=64, selection="host"))),
    ("cv2exact gftt", tiny_config(gftt=GFTTConfig(max_features=64, selection="cv2exact"))),
    ("reference_compat", tiny_config(reference_compat=True)),
])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_which_steps_replay(name, config, device):
    """A step replays only on a CUDA card, and only where no stage reads
    the device to the host: the referee's host split, host GFTT and cv2's
    exact greedy corners stay eager."""
    want = device == "cuda" and name in ("rigid", "homography model")
    assert stab_mod.step_replays(config, device) is want


@pytest.mark.parametrize("mode", [StabilizationMode.ORB_FULL_LOCK,
                                  StabilizationMode.SIFT_FULL_LOCK])
@pytest.mark.parametrize("pinned", [False, True])
def test_registration_locks_stay_eager(replaying, monkeypatch, mode, pinned):
    """The ORB and SIFT locks run eagerly where the step would replay,
    whether the Stabilizer's mode or ``config.static_mode`` names them; the
    step itself is stubbed, since only the choice is under test."""
    calls = []

    def stub(carry, frame, config, mode, ext_motion=None):
        calls.append(mode)
        return carry, (frame.clone(), torch.ones((), dtype=torch.bool))

    monkeypatch.setattr(stab_mod, "stabilize_step", stub)
    cfg = tiny_config(static_mode=int(mode)) if pinned else tiny_config()
    stab = Stabilizer(cfg, GS if pinned else mode, device="cpu")
    for f in clip(4):
        stab.stabilize_frame(f)
    assert calls == [GS if pinned else mode] * 4
    assert stab_mod.step_counters == {"calls": 4, "replays": 0, "captures": 0}


def test_step_without_constants_gives_the_same():
    """``stabilize_step`` uploads its centre and scale itself when not
    given them, and gives what it gives with :func:`step_constants`."""
    cfg = tiny_config()
    frames = torch.from_numpy(clip(5))
    a = init_carry(cfg, int(GS), prng.key(3), "cpu")
    b = map_carry(torch.clone, a)
    center, scale = stab_mod.step_constants(cfg, "cpu")
    assert torch.equal(center, torch.tensor([cfg.working_size[1] / 2.0,
                                             cfg.working_size[0] / 2.0]))
    assert torch.equal(scale, torch.tensor(cfg.scale_factor))
    for f in frames:
        a, (oa, _) = stabilize_step(a, f, cfg, int(GS))
        b, (ob, _) = stabilize_step(b, f, cfg, int(GS), center=center, scale_factor=scale)
        assert torch.equal(oa, ob)
    assert carry_equal(a, b)


def test_replay_equals_eager_across_switches_and_resume(replaying, tmp_path):
    """Past the window's fill, through a switch to the accumulated lock and
    back and a resume from a saved carry, the replaying Stabilizer equals an
    eager one in every output and every carry field; :attr:`carry` keeps
    its identity across replays, and each output is a tensor of its own."""
    cfg = tiny_config()
    frames = clip(22, seed=1)
    eager = Stabilizer(cfg, device="cpu")
    eager._graphs = None
    graphed = Stabilizer(cfg, device="cpu")
    assert graphed._graphs is not None
    saved = str(tmp_path / "carry.npz")
    outs = []
    for i, f in enumerate(frames):
        if i == 8:
            for s in (eager, graphed):
                s.set_stabilization_mode(ACCUM)
        if i == 14:
            for s in (eager, graphed):
                s.set_stabilization_mode(GS)
        if i == 17:
            save_carry(saved, eager.carry)
        if i == 19:
            for s in (eager, graphed):
                s.resume(saved)
        want = eager.stabilize_frame(f)
        got = graphed.stabilize_frame(f)
        assert torch.equal(got, want), f"frame {i}"
        assert carry_equal(graphed.carry, eager.carry), f"frame {i}"
        outs.append(got)
    assert len({o.data_ptr() for o in outs}) == len(outs)
    assert graphed.carry is graphed._static
    # GS from frame 1, ACCUM from 9, GS again from 14 (warm): a capture each
    # at frames 1 and 9; every call after a key's first replays
    assert stab_mod.step_counters["captures"] == 2
    assert stab_mod.step_counters["replays"] == 22 - 2
    assert stab_mod.step_counters["calls"] == 2 * 22


def test_stabilize_clip_outputs_are_distinct(replaying):
    """``stabilize_clip`` stacks fresh outputs, equal to the eager clip's,
    after one capture and replays from the second frame on."""
    cfg = tiny_config()
    frames = torch.from_numpy(clip(10, seed=2))
    eager = Stabilizer(cfg, device="cpu")
    eager._graphs = None
    graphed = Stabilizer(cfg, device="cpu")
    stab_mod.reset_step_counters()
    got = graphed.stabilize_clip(frames)
    assert stab_mod.step_counters == {"calls": 10, "replays": 9, "captures": 1}
    assert torch.equal(got, eager.stabilize_clip(frames))
    assert not torch.equal(got[-1], got[-2])


def test_a_float_frame_is_its_own_graph(replaying):
    """A frame of another dtype keys a graph and an input of its own."""
    cfg = tiny_config()
    frames = clip(6, seed=3)
    eager = Stabilizer(cfg, device="cpu")
    eager._graphs = None
    graphed = Stabilizer(cfg, device="cpu")
    for i, f in enumerate(frames):
        f = torch.from_numpy(f)
        f = f.float() if i % 2 else f
        assert torch.equal(graphed.stabilize_frame(f), eager.stabilize_frame(f))
    assert len(graphed._inputs) == 2
    assert stab_mod.step_counters["captures"] == 2


def test_graph_cache_is_bounded_and_lazy():
    """A key's first lookup asks for the eager call, its second captures;
    the least recently used graph goes first."""
    from video_stabilization_tpu_torch.engine.step_graph import GraphCache

    cache = GraphCache(size=2)
    made = []

    def capture(k):
        return lambda: made.append(k) or f"graph {k}"

    assert cache.get("a", capture("a")) is None
    assert cache.get("a", capture("a")) == "graph a"
    assert cache.get("a", capture("a")) == "graph a"
    for k in "bc":
        assert cache.get(k, capture(k)) is None
        assert cache.get(k, capture(k)) == f"graph {k}"
    assert made == ["a", "b", "c"]
    assert cache.get("a", capture("a")) == "graph a"      # warm: captured again
    assert made == ["a", "b", "c", "a"]
