"""Timing of device work, and the app's rolling stage timer.

Port of ``video_stabilization_tpu/utils/timing.py``:

- :func:`honest_time`: milliseconds per call, CUDA events around the calls
  on the card (the launches are asynchronous, so a host clock alone times
  the queueing), a ``synchronize`` and the host clock elsewhere;
- :class:`StageTimer`: the rolling average the reference prints
  (``avg += (x - avg) / n``).

The JAX module's ``profiler_trace`` has no counterpart: the stage ranges
of ``utils/stage_profile.py`` (on while ``stage_profile.enabled`` is set)
label a ``torch.profiler`` trace, and its tool and the benchmark
(``portbench/trace.py``) profile the program themselves.

The JAX module's ``enable_compile_cache`` (JAX's persistent compilation
cache) has no counterpart: the port compiles nothing at run time but its
kernels, which ``utils/cuda_build.py`` keeps under ``build/kernels/``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict

import torch


def _device_of(tree: Any):
    """The device of the first tensor in ``tree`` (tensors in nested tuples
    and lists), or None."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, (tuple, list)):
        for x in tree:
            dev = _device_of(x)
            if dev is not None:
                return dev
    return None


def honest_time(fn: Callable, *args, iters: int = 5, warmup: int = 1) -> float:
    """Milliseconds per call of ``fn(*args)`` over ``iters`` calls after
    ``warmup`` untimed ones: CUDA events on the current stream when the
    first tensor argument lies on the card, else the host clock after each
    batch of calls has finished."""
    dev = _device_of(args)
    cuda = dev is not None and dev.type == "cuda"
    for _ in range(warmup):
        fn(*args)
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters * 1000.0


class StageTimer:
    """Host-side rolling-average stage timer in the reference's
    printTimings style: ``record(stage, ms)`` updates ``avg += (ms - avg) /
    n``; ``maybe_print`` prints at most once per ``print_interval_s``."""

    def __init__(self) -> None:
        self._avg: Dict[str, float] = {}
        self._count: Dict[str, int] = {}
        self._last_print = time.perf_counter()
        self.print_interval_s = 1.0

    def record(self, stage: str, ms: float) -> None:
        n = self._count.get(stage, 0) + 1
        avg = self._avg.get(stage, 0.0)
        self._avg[stage] = avg + (ms - avg) / n
        self._count[stage] = n

    def averages(self) -> Dict[str, float]:
        return dict(self._avg)

    def maybe_print(self, out=None) -> None:
        now = time.perf_counter()
        if now - self._last_print < self.print_interval_s:
            return
        self._last_print = now
        parts = [f"{k}: {v:.2f} ms (n={self._count[k]})" for k, v in self._avg.items()]
        print("[timings] " + "; ".join(parts), file=out)

