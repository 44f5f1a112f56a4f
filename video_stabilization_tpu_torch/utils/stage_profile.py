"""Per-stage host time and device time of the port's per-frame step.

    python -m video_stabilization_tpu_torch.utils.stage_profile [--config {1,3,4,5}]
        [--frames N] [--warm N] [--seed N] [--chunk K [--turns R]] [--streams S]

Counterpart of the JAX package's ``utils/stage_profile.py`` for one CUDA
card.  Config 1 is 1080x1920 frames in GLOBAL_SMOOTHING, config 3 is
720x1280 frames in ORB_FULL_LOCK, config 4 is 1080x1920 frames in
SIFT_FULL_LOCK with ECC refinement (30 iterations), config 5 is 1080x1920
frames in TRANSLATION_LOCK, 8 streams by default, all at working height
360 with a 30 + 1 + 15 window (``bench.py``'s configurations).  The step
and the locks mark their stages with
:func:`stage`, which opens a ``stage:<name>`` profiler range only while
this tool profiles (``enabled``) and costs one call otherwise.  On shaky
simulator footage rendered on the card it runs
``--warm`` frames, times ``--frames`` frames with CUDA events, then runs
``--frames`` more under ``torch.profiler`` and prints per frame: the
unprofiled ms, the profiled ms, the device-busy ms (kernel time) and the
idle share of the profiled window (busy time and wall time both from it),
the kernel count, the host ms, device events and device ms of each stage,
and the device time of the heaviest kernels and of the hand-written ones.  With
``--chunk K`` it drives the offline chunk step (``engine/offline.py``) in
K-frame chunks instead, ``--warm`` and ``--frames`` rounded up to whole
chunks; its stages are those of the chunk.  With ``--streams S`` it drives
S streams (one texture, trajectory seed 5 + ``--seed`` + s each, as
``bench.py`` renders several streams) through the batched step
(``parallel/streams.py``), or with ``--chunk K`` the stream-batched chunk,
and a "frame" is then one frame of every stream.  With ``--turns R`` as well it
profiles nothing: it times the two forms in turns, R times, each turn from
fresh carries over the same frames (the offline form chunk by chunk, the
streaming step over the same ``--frames`` after the same ``--warm``).  It
needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
import time

import numpy as np
import torch

HAND_WRITTEN = ("fast_levels_kernel", "affine_warp_kernel", "y4m_c420_kernel",
                "y4m_c444_kernel")
# the one switch of every stage range: set by main() around the profiled
# frames only, and by whatever else profiles the program
enabled = False
_OFF = contextlib.nullcontext()


def stage(name: str):
    """A ``stage:<name>`` profiler range while ``enabled``, else a shared
    no-op context."""
    if enabled:
        return torch.profiler.record_function(f"stage:{name}")
    return _OFF


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", None)
                 or getattr(evt, "self_cuda_time_total", 0.0))


def _stage_device_events(prof) -> dict:
    """{"stage:<name>": device events (kernels, copies, fills) launched
    inside that stage's ranges}, nested stages included."""
    def under(e):
        return len(e.kernels) + sum(under(c) for c in e.cpu_children)

    counts: dict = {}
    for e in prof.events():
        if e.name.startswith("stage:") and e.device_type == torch.autograd.DeviceType.CPU:
            counts[e.name] = counts.get(e.name, 0) + under(e)
    return counts


# the reference's printTimings taxonomy (src/stabilizer.cpp:982-1009) over
# the top-level stages of the step body and of the referee's track prefix
# (``engine/stabilizer.py::make_track_fn``: gray, pyramid, lk_track); the
# stages nested in them (lock_detect, orb_detect, match, ecc, ...) are not
# listed, so nothing counts twice
REFERENCE_TAXONOMY = {
    "gftt": "goodFeaturesToTrack",
    "lk_track": "calcOpticalFlowPyrLK",
    "lk": "calcOpticalFlowPyrLK",
    "fit": "estimateAffinePartial2D",
    "warp": "warpPerspective",
    "gray": "resize+cvtColor+pyramid",
    "pyramid": "resize+cvtColor+pyramid",
    "gray_pyramid": "resize+cvtColor+pyramid",
    "smoothing": "smoothing window",
    "lock": "lock transform",
    "rotation_split": "rotation split",
}


def profile_stages(run, device, n_calls: int = 1) -> dict:
    """Run ``run()`` (``n_calls`` step calls on ``device``) under
    ``torch.profiler`` with the stage ranges on, and return ms per call:
    ``{stage: ms}`` for the stages of :data:`REFERENCE_TAXONOMY`, plus
    "total" and "other" (the rest of "total").  On the card the times are
    device times (the kernels launched inside each range, and all kernels
    for "total"); on the CPU, host times (the wall of ``run`` for
    "total")."""
    global enabled
    cuda = torch.device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    enabled = True
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run()
            if cuda:
                torch.cuda.synchronize(device)
            wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        enabled = False
    events = prof.key_averages()
    out = {}
    for e in events:
        name = e.key[6:] if e.key.startswith("stage:") else None
        if name in REFERENCE_TAXONOMY and e.device_type == torch.autograd.DeviceType.CPU:
            us = e.device_time_total if cuda else e.cpu_time_total
            out[name] = us / 1e3 / n_calls
    if cuda:
        total = sum(_device_us(e) for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.key.startswith("stage:")) / 1e3 / n_calls
    else:
        total = wall_ms / n_calls
    out["total"] = total
    out["other"] = max(total - sum(v for k, v in out.items() if k != "total"), 0.0)
    return out


def format_taxonomy(stage_ms: dict) -> str:
    """One line in the printTimings style from :func:`profile_stages`."""
    by_label: dict = {}
    for name, ms in stage_ms.items():
        if name in REFERENCE_TAXONOMY:
            label = REFERENCE_TAXONOMY[name]
            by_label[label] = by_label.get(label, 0.0) + ms
    parts = [f"{label}: {ms:.2f} ms" for label, ms in by_label.items() if ms > 0.0]
    parts.append(f"other: {stage_ms.get('other', 0.0):.2f} ms")
    parts.append(f"total: {stage_ms.get('total', 0.0):.2f} ms")
    return " | ".join(parts)


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()


# bench.py:149-152's footage of several streams: one texture (seed 0), and
# stream s shaken along trajectory seed 5 + s
STREAM_SEED = 5


def footage(cfg, n_frames: int, seed: int, dev, streams: int = 0) -> torch.Tensor:
    """(T, H, W, 3) uint8 shaky simulator frames rendered on ``dev`` from
    ``seed``; with ``streams``, (S, T, H, W, 3) over one texture, stream s
    along trajectory seed ``STREAM_SEED + seed + s`` (the benchmark's
    streams at seed 0)."""
    from video_stabilization_tpu_torch.sim import (
        DEFAULT_APP_PARAMS, make_default_texture, render_frame, shake_trajectory)

    def shaken(tex, rng):
        traj = shake_trajectory(rng.standard_normal((n_frames, 3)),
                                rng.standard_normal(n_frames), DEFAULT_APP_PARAMS,
                                pos_amplitude=0.004, roll_amplitude=0.3, device=dev)
        return torch.stack([render_frame(tex, traj[i], cfg.frame_height, cfg.frame_width)
                            for i in range(n_frames)])

    def texture(rng):
        return torch.from_numpy(make_default_texture(rng, 512)).to(dev)

    if streams:
        tex = texture(np.random.default_rng(0))
        return torch.stack([shaken(tex, np.random.default_rng(STREAM_SEED + seed + s))
                            for s in range(streams)])
    rng = np.random.default_rng(seed)
    return shaken(texture(rng), rng)


def feeder(cfg, mode, seed: int, chunk: int, dev, streams: int = 0):
    """A function that feeds a (T, H, W, 3) run of frames to one stream: the
    streaming step frame by frame, or with ``chunk`` the offline step in
    ``chunk``-frame calls; with ``streams``, an (S, T, H, W, 3) run to S
    streams through the batched step or the stream-batched chunk."""
    import dataclasses

    from video_stabilization_tpu_torch.engine import (
        init_carry, make_offline_batched_fn, make_offline_fn, make_step_fn)
    from video_stabilization_tpu_torch.parallel import init_batched_carry, make_batched_step_fn
    from video_stabilization_tpu_torch.utils import prng

    cfg = dataclasses.replace(cfg, static_mode=int(mode))
    if streams:
        state = {"carry": init_batched_carry(cfg, streams, int(mode), prng.key(seed), dev)}
        # the stream-batched chunk run eagerly, as its first call runs (its
        # CUDA graph's replay would show no stage)
        fn = make_offline_batched_fn(cfg).body if chunk else make_batched_step_fn(cfg)

        def feed_streams(frames):
            parts = ([frames[:, i:i + chunk] for i in range(0, frames.shape[1], chunk)]
                     if chunk else frames.unbind(1))
            for part in parts:
                state["carry"], _ = fn(state["carry"], part)
        return feed_streams
    # one stream: the offline chunk, or the streaming step run eagerly, as
    # Stabilizer runs a key's first call (its CUDA graph's replay would show
    # no stage)
    step = make_offline_fn(cfg) if chunk else make_step_fn(cfg)
    state = {"carry": init_carry(cfg, int(mode), prng.key(seed), dev)}

    def feed(frames):
        parts = [frames[i:i + chunk] for i in range(0, len(frames), chunk)] if chunk else frames
        for part in parts:
            state["carry"], _ = step(state["carry"], part)
    return feed


def time_in_turns(cfg, mode, frames, seed: int, chunk: int, warm: int, turns: int,
                  dev) -> None:
    """Print, for each of ``turns`` turns, the offline step's ms/frame per
    chunk after the ``warm`` frames and the streaming step's ms/frame over
    the same frames (CUDA events; fresh carries each turn)."""
    def timed(feed, part) -> float:
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        ev0.record()
        feed(part)
        ev1.record()
        torch.cuda.synchronize()
        return ev0.elapsed_time(ev1) / len(part)

    for turn in range(turns):
        feed = feeder(cfg, mode, seed, chunk, dev)
        feed(frames[:warm])
        per_chunk = [timed(feed, frames[i:i + chunk]) for i in range(warm, len(frames), chunk)]
        stream = feeder(cfg, mode, seed, 0, dev)
        stream(frames[:warm])
        ms_stream = timed(stream, frames[warm:])
        print(f"turn {turn}: offline {sum(per_chunk) / len(per_chunk):.3f} ms/frame (per chunk "
              f"of {chunk}: {', '.join(f'{t:.3f}' for t in per_chunk)}); streaming "
              f"{ms_stream:.3f} ms/frame; frames {warm}..{len(frames) - 1} after {warm} of "
              "warm-up", flush=True)


def main() -> int:
    from video_stabilization_tpu_torch.config import (
        ECCConfig, StabilizationMode, StabilizerConfig)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", type=int, choices=(1, 3, 4, 5), default=3)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--warm", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=0,
                    help="offline chunks of K frames (default 0: the streaming step)")
    ap.add_argument("--turns", type=int, default=0,
                    help="with --chunk: time offline and streaming in R turns, no profile")
    ap.add_argument("--streams", type=int, default=0,
                    help="S streams through the batched forms (default 0: one stream; "
                         "config 5: 8)")
    args = ap.parse_args()
    streams = args.streams or (8 if args.config == 5 else 0)
    if args.turns and streams:
        ap.error("--turns times one stream; it does not take --streams")
    if not torch.cuda.is_available():
        print("stage_profile: needs a CUDA card", file=sys.stderr)
        return 2

    size, mode = {1: ((1080, 1920), StabilizationMode.GLOBAL_SMOOTHING),
                  3: ((720, 1280), StabilizationMode.ORB_FULL_LOCK),
                  4: ((1080, 1920), StabilizationMode.SIFT_FULL_LOCK),
                  5: ((1080, 1920), StabilizationMode.TRANSLATION_LOCK)}[args.config]
    cfg = StabilizerConfig(frame_height=size[0], frame_width=size[1], working_height=360,
                           past_frames=30, future_frames=15,
                           ecc=ECCConfig(enabled=args.config == 4, max_iters=30))
    dev = torch.device("cuda", 0)
    whole = max(args.chunk, 1)
    n = -(-args.frames // whole) * whole
    warm = -(-args.warm // whole) * whole
    if args.turns and args.chunk:
        print(f"config {args.config} ({size[0]}x{size[1]}, {mode.name}); {card_line()}",
              flush=True)
        time_in_turns(cfg, mode, footage(cfg, warm + n, args.seed, dev), args.seed,
                      args.chunk, warm, args.turns, dev)
        return 0
    frames = footage(cfg, warm + 2 * n, args.seed, dev, streams)

    def span(a, b):      # frames a..b-1 (of every stream)
        return frames[:, a:b] if streams else frames[a:b]

    feed = feeder(cfg, mode, args.seed, args.chunk, dev, streams)
    feed(span(0, warm))

    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    ev0.record()
    feed(span(warm, warm + n))
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
            feed(span(warm + n, warm + 2 * n))
            torch.cuda.synchronize()
            wall_prof = 1e3 * (time.perf_counter() - t0) / n
    finally:
        stage_profile.enabled = False

    card = card_line()
    # device-side events (kernels, copies, fills) only: a CPU op's device
    # time is that of the kernels it launched, counted here already, and
    # the stage ranges also show on the device timeline as annotations
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("stage:")]
    busy = sum(_device_us(e) for e in kernels) / 1e3 / n
    count = sum(e.count for e in kernels)
    form = f"offline chunks of {args.chunk}" if args.chunk else "streaming"
    if streams:
        form += (f", {streams} streams batched (a frame is one frame of each; "
                 f"{streams * 1e3 / wall:.1f} frames/s in all, unprofiled)")
    print(f"config {args.config} ({size[0]}x{size[1]}, {mode.name}), {form}, {n} frames; "
          f"{card}")
    print(f"wall {wall:.3f} ms/frame (CUDA events, unprofiled), {wall_prof:.3f} under "
          f"the profiler; device busy {busy:.3f} ms/frame, idle share "
          f"{1 - busy / wall_prof:.3f} of the profiled wall; {count / n:.0f} device "
          "events per frame")
    stages = [e for e in events if e.key.startswith("stage:")
              and e.device_type == torch.autograd.DeviceType.CPU]
    launched = _stage_device_events(prof)
    for e in sorted(stages, key=lambda e: e.cpu_time_total, reverse=True):
        print(f"  host {e.key[6:]}: {e.cpu_time_total / 1e3 / n:.3f} ms/frame "
              f"({e.count / n:.3g} calls/frame); its device events "
              f"{launched.get(e.key, 0) / n:.0f}/frame, {e.device_time_total / 1e3 / n:.4f} "
              "ms/frame")
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
