"""One live stream, closed loop: each host BGR frame goes into
``Stabilizer.stabilize_frame``, its output is read back to host memory,
then the next frame goes in (the app's live loop).

A frame's latency runs from the call until its output is in host memory;
the enqueue time from the call until it returns, before the read.  The
window's last frame starts before the deadline, and the window ends when
its output is read.  The answers checked are the outputs of the window's
last ``check_last_calls`` calls.
"""

from __future__ import annotations

import collections

import numpy as np

from portbench import harness, reference
from portbench.reference import config as ref_config
from portbench.trace import Tracer, span
from portbench.traffic.footage import pingpong, render_streams


FRAME_DIMS = 3          # an answer is an (H, W, 3) frame


def footage(ctx: harness.Context) -> np.ndarray:
    """(L, H, W, 3) uint8 host frames of the stream."""
    foot = render_streams(ctx.cell.traffic, ctx.setting("frame_height"),
                          ctx.setting("frame_width"), 1, ctx.seed, ctx.device)[0]
    return foot.cpu().numpy()


def reference_outputs(ctx: harness.Context, host: np.ndarray, first: int, count: int,
                      precision: str = "float32"):
    """The reference's outputs of steps ``first .. first + count - 1``, on
    the host."""
    import torch

    rcfg = harness.stabilizer_config(ctx, ref_config)
    mode = int(ref_config.StabilizationMode[ctx.setting("mode")])
    return reference.streaming_outputs(
        rcfg, mode, lambda j: torch.from_numpy(host[pingpong(j, host.shape[0])]),
        reference.prng.key(harness.key_seed(ctx.seed)), first, first + count, ctx.device,
        precision).cpu()


def run(ctx: harness.Context) -> harness.Outcome:
    import torch

    from video_stabilization_tpu_torch import config as port_config
    from video_stabilization_tpu_torch.engine import Stabilizer

    params = ctx.cell.params
    dev = ctx.device
    cuda = dev.type == "cuda"
    cfg = harness.stabilizer_config(ctx, port_config)
    mode = port_config.StabilizationMode[ctx.setting("mode")]
    host = footage(ctx)
    n_foot = host.shape[0]
    stab = Stabilizer(cfg, mode, seed=harness.key_seed(ctx.seed), device=dev)

    step = 0

    def call():
        nonlocal step
        out = stab.stabilize_frame(host[pingpong(step, n_foot)])
        step += 1
        return out

    for _ in range(int(params["warmup_calls"])):
        call().cpu()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t_start = harness.now()
    deadline = t_start + ctx.seconds
    latencies, enqueue = [], []
    kept = collections.deque(maxlen=int(params["check_last_calls"]))
    t_done = t_start
    while t_done < deadline:
        t0 = harness.now()
        out = call()
        t1 = harness.now()
        frame = out.cpu().numpy()
        t_done = harness.now()
        latencies.append(1e3 * (t_done - t0))
        enqueue.append(1e3 * (t1 - t0))
        kept.append((step - 1, frame))
    n_window = len(latencies)
    memory = torch.cuda.max_memory_allocated(dev) if cuda else 0

    traced = None
    if ctx.trace:
        tracer = Tracer(dev)
        tracer.start()
        for _ in range(int(params["trace_calls"])):
            with span("stabilize_frame"):
                out = call()
            with span("read_output"):
                out.cpu()
        traced = tracer.stop(int(params["trace_calls"]), int(params["trace_calls"]))
    del stab, out
    if cuda:
        torch.cuda.empty_cache()

    ref = reference_outputs(ctx, host, kept[0][0], len(kept))
    prog = torch.from_numpy(np.stack([f for _, f in kept]))
    checks = reference.checks(prog, ref, FRAME_DIMS, params["limits"])
    return harness.Outcome(
        frames=n_window, window_s=t_done - t_start, setup_s=t_start - ctx.t_process,
        attempted=n_window, failed=0, checks=checks, memory_peak_bytes=memory,
        latencies_ms=latencies, trace=traced,
        layer={"enqueue_ms": sum(enqueue) / len(enqueue)})
