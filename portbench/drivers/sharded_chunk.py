"""S streams of footage resident on the card, chunk after chunk through
``parallel.streams.make_sharded_offline_fn(cfg, [device])``, the call
``serve_files`` makes; the outputs stay on the card.

Calls are enqueued back to back; the window ends at a synchronize after
the last call enqueued before the deadline.  The answers checked are the
outputs and ``valid`` flags of the window's last ``check_last_calls``
calls.
"""

from __future__ import annotations

import collections
import math

from portbench import harness, reference
from portbench.reference import config as ref_config
from portbench.trace import Tracer, span
from portbench.traffic.footage import pingpong, pingpong_indices, render_streams


FRAME_DIMS = 3          # an answer is an (H, W, 3) frame


def footage(ctx: harness.Context):
    """(S, L, H, W, 3) uint8 footage on the card."""
    return render_streams(ctx.cell.traffic, ctx.setting("frame_height"),
                          ctx.setting("frame_width"), int(ctx.setting("streams")), ctx.seed,
                          ctx.device)


def reference_outputs(ctx: harness.Context, foot, first: int, count: int,
                      precision: str = "float32"):
    """(S, count, H, W, 3): the reference's outputs of steps ``first ..``
    of every stream, on the card."""
    import torch

    rcfg = harness.stabilizer_config(ctx, ref_config)
    mode = int(ref_config.StabilizationMode[ctx.setting("mode")])
    n_foot = foot.shape[1]

    def frames_at(steps):
        idx = torch.tensor([pingpong(j, n_foot) for j in steps], device=foot.device)
        return foot.index_select(1, idx)

    return reference.chunk_outputs(
        rcfg, mode, frames_at, reference.prng.key(harness.key_seed(ctx.seed)),
        int(ctx.setting("streams")), int(ctx.setting("chunk")), first, first + count,
        ctx.device, precision)


def run(ctx: harness.Context) -> harness.Outcome:
    import torch

    from video_stabilization_tpu_torch import config as port_config
    from video_stabilization_tpu_torch import parallel
    from video_stabilization_tpu_torch.utils import prng

    params = ctx.cell.params
    dev = ctx.device
    cuda = dev.type == "cuda"
    cfg = harness.stabilizer_config(ctx, port_config, static=True)
    streams, k = int(ctx.setting("streams")), int(ctx.setting("chunk"))
    foot = footage(ctx)
    n_foot = foot.shape[1]
    # the footage frames of each chunk of one cycle of the replay
    cycle = math.lcm(2 * n_foot - 2, k) // k
    table = torch.tensor([pingpong_indices(c * k, k, n_foot) for c in range(cycle)],
                         dtype=torch.long, device=dev)

    def frames_of(c):
        return foot.index_select(1, table[c % cycle])

    mesh = [dev]
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
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t_start = harness.now()
    deadline = t_start + ctx.seconds
    kept = collections.deque(maxlen=int(params["check_last_calls"]))
    first_call = calls
    while harness.now() < deadline:
        kept.append(call())
    if cuda:
        torch.cuda.synchronize(dev)
    t_end = harness.now()
    window_end = calls
    memory = torch.cuda.max_memory_allocated(dev) if cuda else 0

    traced = None
    if ctx.trace:
        tracer = Tracer(dev)
        tracer.start()
        for _ in range(int(params["trace_calls"])):
            with span("chunk_call"):
                call()
        traced = tracer.stop(int(params["trace_calls"]),
                             int(params["trace_calls"]) * streams * k)
    outs = torch.cat([out for out, _ in kept], 1)
    valid = torch.cat([v for _, v in kept], 1)
    n_kept = len(kept)
    del carry, fn, kept
    if cuda:
        torch.cuda.empty_cache()

    ref = reference_outputs(ctx, foot, (window_end - n_kept) * k, outs.shape[1])
    checks = reference.checks(outs, ref, FRAME_DIMS, params["limits"])
    checks["valid_off"] = {"value": int((~valid).sum()), "limit": 0}
    frames = (window_end - first_call) * streams * k
    return harness.Outcome(
        frames=frames, window_s=t_end - t_start, setup_s=t_start - ctx.t_process,
        attempted=frames, failed=0, checks=checks, memory_peak_bytes=memory, trace=traced)
