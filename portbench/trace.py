"""The traced slice of a run: a fixed count of calls under
``torch.profiler``, with the program's ``stage:*`` ranges switched on
(``utils/stage_profile.enabled``) and the harness's own ``portbench:*``
spans around its calls into the program.

:class:`Tracer` starts and stops the profiler; :func:`summarize` reduces
its events to a :class:`Slice`: the device's busy time (the union of its
kernels, copies and fills), the slice's wall time, device time per kernel
name and per stage range, the device events launched, and the idle gaps,
each labelled by the innermost host range open when it began.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import numpy as np

SLICE = "portbench:slice"


@dataclasses.dataclass
class Slice:
    busy_s: float
    window_s: float
    launches: int
    calls: int                  # driver calls traced
    stream_frames: int          # stabilized frames those calls produced
    kernel_s: dict              # device op name -> seconds
    stage_device_s: dict        # "stage:<name>" -> device seconds under its ranges
    idle_s: dict                # label of the host range -> idle device seconds

    def breakdown(self) -> dict:
        def top(d):
            return [[_short(k), v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(self.kernel_s), "idle_gaps": top(self.idle_s)}


def _short(name: str, n: int = 96) -> str:
    """A kernel's name without its return type, cut to ``n`` characters."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= n else name[:n - 3] + "..."


class Tracer:
    """``start()`` before the first traced call, ``stop(calls, frames)``
    after the last: the profiler with the stage ranges on, and one
    ``portbench:slice`` range over the whole slice."""

    def __init__(self, device):
        self.device = device
        self._prof = None
        self._range = None

    def start(self) -> None:
        import torch

        from video_stabilization_tpu_torch.utils import stage_profile

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        stage_profile.enabled = True
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._range = torch.profiler.record_function(SLICE)
        self._range.__enter__()

    def stop(self, calls: int, stream_frames: int) -> Slice:
        import torch

        from video_stabilization_tpu_torch.utils import stage_profile

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        stage_profile.enabled = False
        return summarize(self._prof, calls, stream_frames)


def _annotation(event) -> bool:
    """A host range's copy on the device's timeline, not device work."""
    return (getattr(event, "is_user_annotation", False) or event.name.startswith("stage:")
            or event.name.startswith("portbench:"))


def _device_intervals(prof) -> list:
    """[(name, start_us, end_us)] of every device event (kernels, copies,
    fills): the profiler's device function events, else its exported
    trace's."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.device_type == cuda and not _annotation(e)]
    if out:
        return out
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    return [(ev["name"], float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0)))
            for ev in trace.get("traceEvents", [])
            if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def _merged(intervals: list) -> list:
    spans = []
    for a, b in sorted(intervals):
        if spans and a <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], b)
        else:
            spans.append([a, b])
    return spans


def summarize(prof, calls: int, stream_frames: int) -> Slice:
    import torch

    cpu = torch.autograd.DeviceType.CPU
    events = prof.events()
    host = [e for e in events if e.device_type == cpu
            and (e.name.startswith("stage:") or e.name.startswith("portbench:"))]
    whole = [e for e in host if e.name == SLICE]
    t0 = min(e.time_range.start for e in whole)
    t1 = max(e.time_range.end for e in whole)
    dev = [(n, max(a, t0), min(b, t1)) for n, a, b in _device_intervals(prof)
           if b > t0 and a < t1]
    kernel_s: dict = {}
    for n, a, b in dev:
        kernel_s[n] = kernel_s.get(n, 0.0) + (b - a) / 1e6
    busy = _merged([(a, b) for _, a, b in dev])
    busy_us = sum(b - a for a, b in busy)

    stage_s: dict = {}
    for e in host:
        if e.name.startswith("stage:"):
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            stage_s[e.name] = stage_s.get(e.name, 0.0) + us / 1e6

    # idle gaps, labelled by the innermost host range open when each began
    edges = [t0] + [x for a, b in busy for x in (a, b)] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    labelled = [e for e in host if e.name != SLICE]
    starts = np.array([e.time_range.start for e in labelled], dtype=np.float64)
    ends = np.array([e.time_range.end for e in labelled], dtype=np.float64)
    names = [e.name for e in labelled]
    idle: dict = {}
    for a, b in gaps:
        label = "portbench:slice (no range open)"
        if len(starts):
            inside = np.flatnonzero((starts <= a) & (ends >= a))
            if len(inside):
                label = names[inside[np.argmin(ends[inside] - starts[inside])]]
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    return Slice(busy_s=busy_us / 1e6, window_s=(t1 - t0) / 1e6, launches=len(dev),
                 calls=calls, stream_frames=stream_frames, kernel_s=kernel_s,
                 stage_device_s=stage_s, idle_s=idle)


def span(name: str):
    """A ``portbench:<name>`` host range (a no-op without a profiler)."""
    import torch

    return torch.profiler.record_function(f"portbench:{name}")

