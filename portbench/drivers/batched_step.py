"""S live feeds on one card, closed loop, one client: each step hands the
S feeds' host BGR frames, one (S, H, W, 3) numpy array uploaded to the
card, to ``parallel.make_batched_step_fn``, and reads all S outputs back
to host memory before the next step (an operator console's loop).

With a ``mode`` in the configuration every feed runs it, pinned.  Without
one the feeds run in mixed modes (no static mode): feed s starts in
``mode_cycle[s % len(mode_cycle)]`` and switches to the cycle's next mode
before steps ``switch_spacing·(s+1) + switch_period·i`` through
``parallel.set_stream_mode`` (:class:`Schedule`), as an operator's mode
keys would.

The window ends when the outputs of its last step, begun before the
deadline, are read.  The answers checked are every feed's outputs and
``valid`` flags of the window's last ``check_last_frames`` steps, against
the plain reference: the stream-batched chunk at K = 1 for a pinned mode,
``reference/mixed.py`` for mixed modes.
"""

from __future__ import annotations

import collections
import sys

import numpy as np

from portbench import harness, reference
from portbench.reference import config as ref_config
from portbench.reference import mixed
from portbench.trace import Tracer, span
from portbench.traffic.footage import pingpong, render_streams


FRAME_DIMS = 3          # an answer is an (H, W, 3) frame


class Schedule:
    """The feeds' modes: each feed's first mode and the switches made
    before a step (none with a pinned ``mode``)."""

    def __init__(self, ctx: harness.Context):
        streams = int(ctx.setting("streams"))
        modes = ref_config.StabilizationMode
        if ctx.setting("mode") is not None:
            self.cycle = [int(modes[ctx.setting("mode")])]
            self.modes0 = self.cycle * streams
            self.spacing = self.period = None
        else:
            self.cycle = [int(modes[m]) for m in ctx.setting("mode_cycle")]
            self.modes0 = [self.cycle[s % len(self.cycle)] for s in range(streams)]
            self.spacing = int(ctx.setting("switch_spacing"))
            self.period = int(ctx.setting("switch_period"))

    @property
    def pinned(self) -> bool:
        return self.spacing is None

    def switches_at(self, j: int) -> list:
        """[(feed, mode)]: the switches made before step ``j``."""
        if self.pinned:
            return []
        out = []
        for s in range(len(self.modes0)):
            since = j - self.spacing * (s + 1)
            if since >= 0 and since % self.period == 0:
                out.append((s, self.cycle[(s + since // self.period + 1) % len(self.cycle)]))
        return out

    def until(self, stop: int) -> dict:
        """{step: switches} of the steps before ``stop``."""
        return {j: sw for j in range(stop) if (sw := self.switches_at(j))}


def footage(ctx: harness.Context) -> np.ndarray:
    """(L, S, H, W, 3) uint8 host frames: step j's frames of every feed are
    ``footage[pingpong(j, L)]``, one contiguous (S, H, W, 3) array."""
    import torch

    foot = render_streams(ctx.cell.traffic, ctx.setting("frame_height"),
                          ctx.setting("frame_width"), int(ctx.setting("streams")), ctx.seed,
                          ctx.device)
    host = np.ascontiguousarray(foot.cpu().numpy().swapaxes(0, 1))
    del foot
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return host


def reference_outputs(ctx: harness.Context, host: np.ndarray, first: int, count: int,
                      precision: str = "float32"):
    """(S, count, H, W, 3): the reference's outputs of steps ``first ..
    first + count - 1`` of every feed, on the device."""
    import torch

    rcfg = harness.stabilizer_config(ctx, ref_config)
    schedule = Schedule(ctx)
    n_foot = host.shape[0]
    key = reference.prng.key(harness.key_seed(ctx.seed))

    def frames_at(steps):
        return torch.from_numpy(np.stack([host[pingpong(j, n_foot)] for j in steps], 1))

    if schedule.pinned:
        return reference.chunk_outputs(rcfg, schedule.cycle[0], frames_at, key,
                                       len(schedule.modes0), 1, first, first + count,
                                       ctx.device, precision)
    return mixed.mixed_outputs(rcfg, schedule.modes0, schedule.until(first + count), frames_at,
                               key, first, first + count, ctx.device, precision)


def _batched_counters():
    """The program's batched-step counters and their reset
    (``parallel.streams.batched_counters``), or None where it has none."""
    from video_stabilization_tpu_torch.parallel import streams

    reset = getattr(streams, "reset_batched_counters", None)
    return (streams.batched_counters, reset) if reset else (None, None)


def run(ctx: harness.Context) -> harness.Outcome:
    import torch

    from video_stabilization_tpu_torch import config as port_config
    from video_stabilization_tpu_torch import parallel
    from video_stabilization_tpu_torch.utils import prng

    params = ctx.cell.params
    dev = ctx.device
    cuda = dev.type == "cuda"
    schedule = Schedule(ctx)
    # a program without the switch fails here, before any set-up
    switch = None if schedule.pinned else parallel.set_stream_mode
    cfg = harness.stabilizer_config(ctx, port_config, static=schedule.pinned)
    streams = len(schedule.modes0)
    host = footage(ctx)
    n_foot = host.shape[0]
    carry = parallel.init_batched_carry(cfg, streams, schedule.modes0[0],
                                        prng.key(harness.key_seed(ctx.seed)), dev)
    if switch is not None:
        for s, m in enumerate(schedule.modes0):
            carry = switch(carry, s, m)
    step_fn = parallel.make_batched_step_fn(cfg)
    step = 0

    def call():
        nonlocal carry, step
        for s, m in schedule.switches_at(step):
            carry = switch(carry, s, m)
        frames = torch.from_numpy(host[pingpong(step, n_foot)]).to(dev)
        carry, result = step_fn(carry, frames)
        step += 1
        return result

    for _ in range(int(params["warmup_calls"])):
        call()[0].cpu()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    counters, reset_counters = _batched_counters()
    if reset_counters:
        reset_counters()
    t_start = harness.now()
    deadline = t_start + ctx.seconds
    kept = collections.deque(maxlen=int(params["check_last_frames"]))
    first_step = step
    t_done = t_start
    while t_done < deadline:
        out, valid = call()
        answer = (step - 1, out.cpu(), valid.cpu())
        t_done = harness.now()
        kept.append(answer)
    n_steps = step - first_step
    batched = dict(counters) if counters is not None else None
    memory = torch.cuda.max_memory_allocated(dev) if cuda else 0

    traced = None
    if ctx.trace:
        tracer = Tracer(dev)
        tracer.start()
        for _ in range(int(params["trace_calls"])):
            with span("batched_step"):
                out, _ = call()
            with span("read_output"):
                out.cpu()
        traced = tracer.stop(int(params["trace_calls"]), int(params["trace_calls"]) * streams)
    del carry, step_fn, out
    if cuda:
        torch.cuda.empty_cache()

    prog = torch.stack([o for _, o, _ in kept], 1)
    valid = torch.stack([v for _, _, v in kept], 1)
    t_ref = harness.now()
    ref = reference_outputs(ctx, host, kept[0][0], len(kept))
    print(f"batched_step: {n_steps} steps in the window; the reference of steps "
          f"{kept[0][0]}-{kept[-1][0]} took {harness.now() - t_ref:.1f} s", file=sys.stderr)
    checks = reference.checks(prog, ref, FRAME_DIMS, params["limits"])
    checks["valid_off"] = {"value": int((~valid).sum()), "limit": 0}
    frames = n_steps * streams
    return harness.Outcome(
        frames=frames, window_s=t_done - t_start, setup_s=t_start - ctx.t_process,
        attempted=frames, failed=0, checks=checks, memory_peak_bytes=memory, trace=traced,
        layer={"batched": batched})
