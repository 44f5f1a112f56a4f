"""S streams over a mesh of ``cell.chips`` cards, one slot a card, chunk
after chunk through ``parallel.streams.make_sharded_offline_fn(cfg,
mesh)``, the call ``serve_files`` makes on such a host; each slot's S/D
streams of footage resident on its card, the outputs left there.

The mesh is cards ``0 .. chips - 1`` (on the CPU ``[cpu] * chips``, as the
tests run it).  Slot d holds streams ``d·S/D ..``: the footage
``render_streams`` gives those streams of S, rendered on slot d's card.
Calls are enqueued back to back; the window ends at a synchronize of
every card after the last call enqueued before the deadline.  The answers
checked are the outputs and ``valid`` flags of the window's last
``check_last_calls`` calls, each slot's against the reference of that
slot's streams as one batch (``reference/slots.py``).  Besides the cell's
metrics, stderr gets each card's idle share and memory peak and each
slot's mean host enqueue.
"""

from __future__ import annotations

import collections
import math
import sys

from portbench import harness, reference
from portbench.mesh_trace import MeshTracer
from portbench.reference import config as ref_config
from portbench.reference.slots import slot_chunk_outputs, slot_keys
from portbench.trace import span
from portbench.traffic.footage import pingpong, pingpong_indices, render_streams


FRAME_DIMS = 3          # an answer is an (H, W, 3) frame


def mesh_of(ctx: harness.Context) -> list:
    import torch

    chips = ctx.cell.chips
    if ctx.device.type == "cuda":
        return [torch.device("cuda", i) for i in range(chips)]
    return [ctx.device] * chips


def footage(ctx: harness.Context, mesh=None) -> list:
    """[(S/D, L, H, W, 3) uint8]: each slot's streams of footage, slot d's
    on ``mesh[d]`` (default: ``cell.chips`` slots, all on ``ctx.device``)."""
    mesh = mesh or [ctx.device] * ctx.cell.chips
    per = int(ctx.setting("streams")) // len(mesh)
    traffic = ctx.cell.traffic
    # stream s's trajectory seed is offset + seed + s; slot d's first stream is d·S/D
    return [render_streams(dict(traffic, trajectory_seed_offset=int(
                traffic["trajectory_seed_offset"]) + d * per),
                ctx.setting("frame_height"), ctx.setting("frame_width"), per, ctx.seed, dev)
            for d, dev in enumerate(mesh)]


def reference_outputs(ctx: harness.Context, foot: list, first: int, count: int,
                      precision: str = "float32"):
    """(S, count, H, W, 3) on ``ctx.device``: the reference's outputs of
    steps ``first ..`` of every stream, each slot's computed on its
    footage's device."""
    import torch

    rcfg = harness.stabilizer_config(ctx, ref_config)
    mode = int(ref_config.StabilizationMode[ctx.setting("mode")])
    key = reference.prng.key(harness.key_seed(ctx.seed))
    streams = int(ctx.setting("streams"))

    def slot(d, part):
        def frames_at(steps):
            idx = torch.tensor([pingpong(j, part.shape[1]) for j in steps], device=part.device)
            return part.index_select(1, idx)
        return frames_at, slot_keys(key, streams, len(foot), d), part.device

    outs = slot_chunk_outputs(rcfg, mode, [slot(d, part) for d, part in enumerate(foot)],
                              int(ctx.setting("chunk")), first, first + count, precision)
    return torch.cat([o.to(ctx.device) for o in outs])


def _mesh_counters():
    """The program's record of the sharded forms' host dispatch
    (``parallel.streams.mesh_counters``), or None where it has none."""
    from video_stabilization_tpu_torch.parallel import streams

    reset = getattr(streams, "reset_mesh_counters", None)
    return (streams.mesh_counters, reset) if reset else (None, None)


def run(ctx: harness.Context) -> harness.Outcome:
    import torch

    from video_stabilization_tpu_torch import config as port_config
    from video_stabilization_tpu_torch import parallel
    from video_stabilization_tpu_torch.utils import prng

    params = ctx.cell.params
    cuda = ctx.device.type == "cuda"
    mesh = mesh_of(ctx)
    cards = mesh if cuda else []
    cfg = harness.stabilizer_config(ctx, port_config, static=True)
    streams, k = int(ctx.setting("streams")), int(ctx.setting("chunk"))
    foot = footage(ctx, mesh)
    n_foot = foot[0].shape[1]
    # the footage frames of each chunk of one cycle of the replay, on each card
    cycle = math.lcm(2 * n_foot - 2, k) // k
    rows = [pingpong_indices(c * k, k, n_foot) for c in range(cycle)]
    tables = [torch.tensor(rows, dtype=torch.long, device=dev) for dev in mesh]

    def frames_of(c):
        return parallel.Sharded(tuple(part.index_select(1, table[c % cycle])
                                      for part, table in zip(foot, tables)))

    def parts(value):
        return value.parts if isinstance(value, parallel.Sharded) else (value,)

    def synchronize():
        for dev in cards:
            torch.cuda.synchronize(dev)

    key = harness.key_seed(ctx.seed)
    carry = parallel.init_sharded_carry(cfg, streams, int(cfg.static_mode), prng.key(key), mesh)
    fn = parallel.make_sharded_offline_fn(cfg, mesh)
    calls = 0

    def call():
        nonlocal carry, calls
        carry, result = fn(carry, frames_of(calls))
        calls += 1
        return result

    for _ in range(int(params["warmup_calls"])):
        call()
    synchronize()
    for dev in cards:
        torch.cuda.reset_peak_memory_stats(dev)
    counters, reset_counters = _mesh_counters()
    if reset_counters:
        reset_counters()
    t_start = harness.now()
    deadline = t_start + ctx.seconds
    kept = collections.deque(maxlen=int(params["check_last_calls"]))
    first_call = calls
    while harness.now() < deadline:
        kept.append(call())
    synchronize()
    t_end = harness.now()
    window_end = calls
    dispatch = None
    if counters is not None:
        dispatch = dict(calls=counters["calls"], dispatch_s=counters["dispatch_s"],
                        enqueue_s=list(counters["enqueue_s"]))
    memory = {dev.index: torch.cuda.max_memory_allocated(dev) for dev in cards}

    traced, card_idle = None, {}
    if ctx.trace:
        tracer = MeshTracer(mesh)
        tracer.start()
        for _ in range(int(params["trace_calls"])):
            with span("chunk_call"):
                call()
        traced = tracer.stop(int(params["trace_calls"]),
                             int(params["trace_calls"]) * streams * k)
        card_idle = tracer.card_idle
    # every slot's answers, in stream order, on the first card
    outs = torch.cat([torch.cat([p.to(ctx.device) for p in parts(out)]) for out, _ in kept], 1)
    valid = torch.cat([torch.cat([p.to(ctx.device) for p in parts(v)]) for _, v in kept], 1)
    n_kept = len(kept)
    del carry, fn, kept
    if cuda:
        torch.cuda.empty_cache()

    ref = reference_outputs(ctx, foot, (window_end - n_kept) * k, outs.shape[1])
    checks = reference.checks(outs, ref, FRAME_DIMS, params["limits"])
    checks["valid_off"] = {"value": int((~valid).sum()), "limit": 0}
    _log(dispatch, card_idle, memory)
    frames = (window_end - first_call) * streams * k
    return harness.Outcome(
        frames=frames, window_s=t_end - t_start, setup_s=t_start - ctx.t_process,
        attempted=frames, failed=0, checks=checks,
        memory_peak_bytes=max(memory.values(), default=0), trace=traced,
        layer={"mesh_dispatch": dispatch, "card_idle": card_idle})


def _log(dispatch, card_idle: dict, memory: dict) -> None:
    """Each slot's mean enqueue, each card's idle share and memory peak, on
    stderr: the card or slot the others wait on, by name."""
    if dispatch and dispatch["calls"]:
        n = dispatch["calls"]
        print("mesh: dispatch ms/call %.3f; enqueue ms/call by slot %s" % (
            1e3 * dispatch["dispatch_s"] / n,
            ", ".join(f"{1e3 * s / n:.3f}" for s in dispatch["enqueue_s"])), file=sys.stderr)
    for card, share in sorted(card_idle.items()):
        print(f"mesh: card {card} idle share {share:.4f}", file=sys.stderr)
    for card, peak in sorted(memory.items()):
        print(f"mesh: card {card} memory peak {peak} B", file=sys.stderr)
