"""Per-stage host time and device time of the port's per-frame step.

    python -m video_stabilization_tpu_torch.utils.stage_profile [--config {1,3}]
        [--frames N] [--warm N] [--seed N]

Counterpart of the JAX package's ``utils/stage_profile.py`` for one CUDA
card.  Config 1 is 1080x1920 frames in GLOBAL_SMOOTHING, config 3 is
720x1280 frames in ORB_FULL_LOCK, both at working height 360 with a
30 + 1 + 15 window.  The step and the ORB lock mark their stages with
:func:`stage`, which opens a ``stage:<name>`` profiler range only while
this tool profiles (``enabled``) and costs one call otherwise.  On shaky
simulator footage rendered on the card it runs
``--warm`` frames, times ``--frames`` frames with CUDA events, then runs
``--frames`` more under ``torch.profiler`` and prints per frame: the
unprofiled ms, the device-busy ms (kernel time) and idle share, the kernel
count, the host ms of each stage, and the device time of the heaviest
kernels and of the hand-written ones.  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
import time

import numpy as np
import torch

HAND_WRITTEN = ("fast_levels_kernel", "affine_warp_kernel")
# set by main() around the profiled frames only
enabled = False


def stage(name: str):
    """A ``stage:<name>`` profiler range while ``enabled``, else a no-op."""
    if enabled:
        return torch.profiler.record_function(f"stage:{name}")
    return contextlib.nullcontext()


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", None)
                 or getattr(evt, "self_cuda_time_total", 0.0))


def footage(cfg, n_frames: int, seed: int, dev) -> torch.Tensor:
    """(T, H, W, 3) uint8 shaky simulator frames rendered on ``dev``."""
    from video_stabilization_tpu_torch.sim import (
        DEFAULT_APP_PARAMS, make_default_texture, render_frame, shake_trajectory)

    rng = np.random.default_rng(seed)
    tex = torch.from_numpy(make_default_texture(rng, 512)).to(dev)
    traj = shake_trajectory(rng.standard_normal((n_frames, 3)),
                            rng.standard_normal(n_frames), DEFAULT_APP_PARAMS,
                            pos_amplitude=0.004, roll_amplitude=0.3, device=dev)
    return torch.stack([render_frame(tex, traj[i], cfg.frame_height, cfg.frame_width)
                        for i in range(n_frames)])


def main() -> int:
    from video_stabilization_tpu_torch.config import StabilizationMode, StabilizerConfig
    from video_stabilization_tpu_torch.engine import Stabilizer

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", type=int, choices=(1, 3), default=3)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--warm", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stage_profile: needs a CUDA card", file=sys.stderr)
        return 2

    size, mode = {1: ((1080, 1920), StabilizationMode.GLOBAL_SMOOTHING),
                  3: ((720, 1280), StabilizationMode.ORB_FULL_LOCK)}[args.config]
    cfg = StabilizerConfig(frame_height=size[0], frame_width=size[1], working_height=360,
                           past_frames=30, future_frames=15)
    dev = torch.device("cuda", 0)
    n = args.frames
    frames = footage(cfg, args.warm + 2 * n, args.seed, dev)
    stab = Stabilizer(cfg, mode, seed=args.seed, device=dev)
    for f in frames[:args.warm]:
        stab.stabilize_frame(f)

    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    ev0.record()
    for f in frames[args.warm:args.warm + n]:
        stab.stabilize_frame(f)
    ev1.record()
    torch.cuda.synchronize()
    wall = ev0.elapsed_time(ev1) / n

    # the package's module, not this one: run with -m, this file is __main__
    from video_stabilization_tpu_torch.utils import stage_profile

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    stage_profile.enabled = True
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for f in frames[args.warm + n:]:
                stab.stabilize_frame(f)
            torch.cuda.synchronize()
            wall_prof = 1e3 * (time.perf_counter() - t0) / n
    finally:
        stage_profile.enabled = False

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    # device-side events (kernels, copies, fills) only: a CPU op's device
    # time is that of the kernels it launched, counted here already, and
    # the stage ranges also show on the device timeline as annotations
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("stage:")]
    busy = sum(_device_us(e) for e in kernels) / 1e3 / n
    count = sum(e.count for e in kernels)
    print(f"config {args.config} ({size[0]}x{size[1]}, {mode.name}), {n} frames; {card}")
    print(f"wall {wall:.3f} ms/frame (CUDA events, unprofiled), {wall_prof:.3f} under "
          f"the profiler; device busy {busy:.3f} ms/frame, idle share "
          f"{1 - busy / wall:.3f} of the unprofiled wall; {count / n:.0f} device "
          "events per frame")
    stages = [e for e in events if e.key.startswith("stage:")
              and e.device_type == torch.autograd.DeviceType.CPU]
    for e in sorted(stages, key=lambda e: e.cpu_time_total, reverse=True):
        print(f"  host {e.key[6:]}: {e.cpu_time_total / 1e3 / n:.3f} ms/frame "
              f"({e.count / n:.0f} calls/frame)")
    for e in sorted(kernels, key=_device_us, reverse=True)[:12]:
        print(f"  device {_device_us(e) / 1e3 / n:.4f} ms/frame, {e.count / n:.1f}/frame: "
              f"{e.key[:90]}")
    for name in HAND_WRITTEN:
        hits = [e for e in kernels if name in e.key]
        us = sum(_device_us(e) for e in hits)
        calls = sum(e.count for e in hits)
        if calls:
            print(f"  kernel {name}: {us / calls:.2f} us/launch device, {calls / n:.0f} "
                  f"launches/frame, {us / 1e3 / n:.4f} ms/frame")
    return 0


if __name__ == "__main__":
    sys.exit(main())
