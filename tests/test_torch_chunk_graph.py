"""When the stream-batched chunk replays a CUDA graph, on the CPU.

A graph cannot be captured here, so these tests put a stand-in in
``StepGraph``'s place that reruns the captured function on every replay,
as a graph reruns its kernels on the same tensors, and patch the predicate
``step_replays`` to hold: the static frames, the carry written back in
place, a carry from elsewhere copied in, fresh outputs, one set of graphs
per slot, the stages that stay eager and the counters.  No JAX reference."""

import dataclasses

import numpy as np
import pytest
import torch

from video_stabilization_tpu_torch.config import (
    GFTTConfig, RansacConfig, StabilizationMode, StabilizerConfig)
from video_stabilization_tpu_torch.engine import map_carry, offline
from video_stabilization_tpu_torch.parallel import (
    init_batched_carry, make_sharded_offline_fn, shard_carry)
from video_stabilization_tpu_torch.utils import prng

GS = StabilizationMode.GLOBAL_SMOOTHING
K = 3


def tiny_config(mode=GS, **kw):
    kw.setdefault("gftt", GFTTConfig(max_features=64))
    return StabilizerConfig(past_frames=4, future_frames=2, working_height=96,
                            frame_height=120, frame_width=160, static_mode=int(mode), **kw)


def clips(streams, n, seed=0):
    """(streams, n, 120, 160, 3) u8: one texture of 4x4 blocks per stream,
    shaken by up to 3 pixels a frame."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(streams):
        tex = np.repeat(np.repeat(rng.integers(0, 256, (40, 55, 3), dtype=np.uint8), 4, 0), 4, 1)
        shifts = 20 + rng.integers(-3, 4, (n, 2))
        out.append(np.stack([tex[y:y + 120, x:x + 160] for y, x in shifts]))
    return torch.from_numpy(np.stack(out))


class RerunGraph:
    """``StepGraph``'s stand-in: each replay reruns the captured function
    and, as a graph does, writes its outputs into the same tensors."""

    def __init__(self, fn, device):
        self.fn = fn
        self.outputs = None

    def replay(self):
        new = self.fn()
        if self.outputs is None:
            self.outputs = new
        else:
            for mine, x in zip(self.outputs, new):
                mine.copy_(x)
        return self.outputs


@pytest.fixture
def replaying(monkeypatch):
    """The chunk on the CPU takes the replay path, with :class:`RerunGraph`
    for the graph; fresh callables and counters."""
    monkeypatch.setattr(offline, "step_replays", lambda config, device: True)
    monkeypatch.setattr(offline, "StepGraph", RerunGraph)
    offline.make_offline_batched_fn.cache_clear()
    offline.reset_chunk_counters()
    yield
    offline.make_offline_batched_fn.cache_clear()


def carry_equal(a, b):
    eq = []
    map_carry(lambda x, y: eq.append(torch.equal(x, y)), a, b)
    return all(eq)


def fresh(cfg, streams=2, seed=3):
    return init_batched_carry(cfg, streams, int(cfg.static_mode), prng.key(seed), "cpu")


def test_cpu_chunk_counts_calls_and_never_replays():
    """On the CPU the chunk stays eager: the counters count its calls, with
    no replay and no capture."""
    offline.make_offline_batched_fn.cache_clear()
    offline.reset_chunk_counters()
    cfg = tiny_config()
    fn = offline.make_offline_batched_fn(cfg)
    carry, frames = fresh(cfg), clips(2, 2 * K)
    for i in range(0, 2 * K, K):
        carry, _ = fn(carry, frames[:, i:i + K])
    assert offline.chunk_counters == {"calls": 2, "replays": 0, "captures": 0}
    assert fn._rings == {}


def test_replay_equals_eager_and_outputs_stay(replaying):
    """Over 5 chunks, past the window's fill, the replayed chunk equals the
    eager body in every output, ``valid`` and carry field; the outputs of a
    call are unchanged after the next; the carry returned from the second
    call on is the graph's own; one capture, a replay of every call but the
    first."""
    cfg = tiny_config()
    fn = offline.make_offline_batched_fn(cfg)
    frames = clips(2, 5 * K, seed=1)
    graphed, eager = fresh(cfg), fresh(cfg)
    kept = []
    for c in range(5):
        part = frames[:, c * K:(c + 1) * K]
        eager, (want, want_valid) = fn.body(eager, part)
        graphed, (got, valid) = fn(graphed, part)
        assert torch.equal(got, want) and torch.equal(valid, want_valid), f"chunk {c}"
        assert carry_equal(graphed, eager), f"chunk {c}"
        kept.append((got, got.clone()))
    for c, (got, snapshot) in enumerate(kept):
        assert torch.equal(got, snapshot), f"chunk {c} overwritten"
    assert len({got.data_ptr() for got, _ in kept}) == len(kept)
    ring_graphs = fn._rings[id(graphed.frames)]
    assert graphed.n is ring_graphs.carry.n
    assert offline.chunk_counters == {"calls": 5, "replays": 4, "captures": 1}


@pytest.mark.parametrize("elsewhere", ["an eager call's", "fresh on the slot's ring"])
def test_a_carry_from_elsewhere_is_copied_in(replaying, elsewhere):
    """A carry that is not the graph's but shares its ring (one the eager
    body returned, or a fresh carry put on the slot's ring) is copied into
    the graph's carry, and the chunk gives the eager answers from it; the
    graph is not captured again."""
    cfg = tiny_config()
    fn = offline.make_offline_batched_fn(cfg)
    frames = clips(2, 6 * K, seed=2)
    graphed, eager = fresh(cfg), fresh(cfg)
    for c in range(3):
        part = frames[:, c * K:(c + 1) * K]
        graphed, _ = fn(graphed, part)
        eager, _ = fn.body(eager, part)
    part = frames[:, 3 * K:4 * K]
    if elsewhere == "an eager call's":
        graphed, _ = fn.body(graphed, part)
        eager, _ = fn.body(eager, part)
    else:
        graphed = dataclasses.replace(fresh(cfg, seed=5), frames=graphed.frames)
        eager = dataclasses.replace(fresh(cfg, seed=5), frames=eager.frames)
    mine = fn._rings[id(graphed.frames)].carry
    assert graphed.n is not mine.n
    for c in range(4, 6):
        part = frames[:, c * K:(c + 1) * K]
        eager, (want, _) = fn.body(eager, part)
        graphed, (got, _) = fn(graphed, part)
        assert torch.equal(got, want), f"chunk {c}"
        assert carry_equal(graphed, eager), f"chunk {c}"
    assert graphed.n is mine.n
    assert offline.chunk_counters == {"calls": 5, "replays": 4, "captures": 1}


def test_each_slot_of_a_mesh_has_its_graph(replaying):
    """Over a mesh of two "cpu" slots, each slot's ring has graphs of its
    own, captured once in 4 calls (none evicted by the other slot's), and
    each slot equals its streams through the eager body."""
    cfg = tiny_config()
    mesh = [torch.device("cpu")] * 2
    sharded = make_sharded_offline_fn(cfg, mesh)
    fn = offline.make_offline_batched_fn(cfg)
    frames = clips(4, 4 * K, seed=3)
    carry = shard_carry(fresh(cfg, streams=4), mesh)
    alone = [map_carry(torch.clone, part) for part in carry.parts]
    for c in range(4):
        part = frames[:, c * K:(c + 1) * K]
        carry, (out, _) = sharded(carry, part)
        for d in range(2):
            alone[d], (want, _) = fn.body(alone[d], part[2 * d:2 * d + 2])
            assert torch.equal(out.parts[d], want), f"chunk {c} slot {d}"
            assert carry_equal(carry.parts[d], alone[d]), f"chunk {c} slot {d}"
    assert set(fn._rings) == {id(part.frames) for part in carry.parts}
    assert offline.chunk_counters == {"calls": 8, "replays": 6, "captures": 2}


@pytest.mark.parametrize("name,config", [
    ("orb lock", tiny_config(StabilizationMode.ORB_FULL_LOCK)),
    ("sift lock", tiny_config(StabilizationMode.SIFT_FULL_LOCK)),
    ("cv2exact ransac", tiny_config(ransac=RansacConfig(method="cv2exact"))),
    ("host gftt", tiny_config(gftt=GFTTConfig(max_features=64, selection="host"))),
    ("reference_compat", tiny_config(reference_compat=True)),
])
def test_host_reading_stages_stay_eager(monkeypatch, name, config):
    """With the predicate as on a card, the registration locks and the
    stages that read the device to the host run the chunk eagerly in every
    call; the body is stubbed, since only the choice is under test."""
    real = offline.step_replays
    monkeypatch.setattr(offline, "step_replays", lambda config, device: real(config, "cuda"))
    monkeypatch.setattr(offline, "StepGraph", RerunGraph)
    offline.reset_chunk_counters()
    fn = offline._ChunkReplay(config)
    calls = []

    def stub(carry, frames, **kw):
        calls.append(kw)
        return carry, (frames.clone(), torch.ones(frames.shape[:2], dtype=torch.bool))

    fn.body = stub
    carry, frames = fresh(config), clips(2, 3 * K)
    for c in range(3):
        carry, _ = fn(carry, frames[:, c * K:(c + 1) * K])
    assert calls == [{"modes": None}] * 3
    assert offline.chunk_counters == {"calls": 3, "replays": 0, "captures": 0}
    assert fn._rings == {}


def test_frames_on_another_device_are_refused(replaying):
    """Frames off the carry's device go to the eager body, which raises,
    whether or not the slot has a graph."""
    cfg = tiny_config()
    fn = offline.make_offline_batched_fn(cfg)
    carry, frames = fresh(cfg), clips(2, 2 * K)
    for c in range(2):
        carry, _ = fn(carry, frames[:, c * K:(c + 1) * K])
    with pytest.raises(ValueError, match="frames on meta"):
        fn(carry, frames[:, :K].to("meta"))
