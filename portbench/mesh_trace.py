"""The traced slice of a run over several cards, card by card.

``trace.summarize`` merges every card's device operations into one union:
over a mesh, one busy card hides the idle ones.  :class:`MeshTracer` is
``trace.Tracer`` that synchronizes every card of the mesh at the slice's
edges and keeps, per card, the share of the slice's wall in which that
card ran no device operation (the profiler's ``device_index`` of each
kernel, copy and fill).
"""

from __future__ import annotations

import json
import os
import tempfile

from portbench import trace


def card_idle_shares(intervals, cards, t0: float, t1: float) -> dict:
    """{card: 1 - (union of the card's device intervals within [t0, t1]) /
    (t1 - t0)} for each of ``cards``; ``intervals`` is [(card, start,
    end)], one unit of time throughout.  A card with no interval reads
    1.0."""
    wall = t1 - t0
    shares = {}
    for card in cards:
        busy = trace._merged([(max(a, t0), min(b, t1)) for c, a, b in intervals
                              if c == card and b > t0 and a < t1])
        shares[card] = 1.0 - sum(b - a for a, b in busy) / wall
    return shares


def device_intervals(prof) -> list:
    """[(card, start_us, end_us)] of every device operation of the
    profile: its device function events, else its exported trace's."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = [(e.device_index, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.device_type == cuda and not trace._annotation(e)]
    if out:
        return out
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    return [(int(ev.get("args", {}).get("device", ev.get("pid", 0))), float(ev["ts"]),
             float(ev["ts"]) + float(ev.get("dur", 0.0)))
            for ev in events if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def slice_edges(prof) -> tuple:
    """(start_us, end_us) of the ``portbench:slice`` host range."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    whole = [e for e in prof.events() if e.device_type == cpu and e.name == trace.SLICE]
    return min(e.time_range.start for e in whole), max(e.time_range.end for e in whole)


class MeshTracer(trace.Tracer):
    """``trace.Tracer`` over a mesh: every card synchronized before the
    slice starts and before it stops; after :meth:`stop`, ``card_idle``
    holds {card index: idle share of the slice}."""

    def __init__(self, mesh):
        super().__init__(mesh[0])
        self.mesh = list(mesh)
        self.card_idle: dict = {}

    def _synchronize(self) -> None:
        import torch

        for dev in self.mesh:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def start(self) -> None:
        self._synchronize()
        super().start()

    def stop(self, calls: int, stream_frames: int) -> trace.Slice:
        self._synchronize()
        sliced = super().stop(calls, stream_frames)
        cards = sorted({dev.index for dev in self.mesh if dev.type == "cuda"})
        if cards:
            self.card_idle = card_idle_shares(device_intervals(self._prof), cards,
                                              *slice_edges(self._prof))
        return sliced
