"""A step of tensors captured once as a CUDA graph, then replayed.

The streaming step launches some 3,300 small device operations a 1080p
frame from Python, and the host's dispatch of them, not the card, sets the
frame's pace.  A ``torch.cuda.CUDAGraph`` of the step replays the same
operations, in the same order, from one launch: the eager call's work, bit
for bit.

:class:`StepGraph` captures ``fn()``, a function whose tensors stay at
fixed addresses: the caller fills its inputs in place (``copy_``) before a
replay and reads its outputs after it, and ``fn`` writes any state it
carries back into its own inputs, inside the graph.  Nothing of ``fn`` may
read the device to the host, or copy from pageable host memory: capture
refuses both.

:class:`GraphCache` keeps a few graphs by key and captures lazily: a key's
first call runs eagerly, which loads the kernel libraries, makes the cuBLAS
handle and fills the caches that capture must find full; its second
captures.  :func:`copy_carry` and :func:`static_input` fill a graph's
carry and input in place.

The hand-written kernels' launch counters (``ops.affine_warp.launches``,
``ops.fast.launches``) count the launches the card runs: a capture runs
nothing, so it leaves them as they were, and each replay adds the launches
its capture recorded.
"""

from __future__ import annotations

import collections
from typing import Callable, Hashable, Optional

import torch

from video_stabilization_tpu_torch.engine.state import EngineCarry, map_carry
from video_stabilization_tpu_torch.ops import affine_warp, fast

_LAUNCH_COUNTERS = (affine_warp, fast)


class StepGraph:
    """One capture of ``fn()`` on ``device``; :meth:`replay` runs it on that
    card's current stream and returns the tensors ``fn`` returned,
    overwritten by every replay."""

    def __init__(self, fn: Callable[[], object], device):
        self.device = device
        before = [m.launches for m in _LAUNCH_COUNTERS]
        self.graph = torch.cuda.CUDAGraph()
        try:
            # a side stream of this card: torch.cuda.graph's default capture
            # stream is one stream of the card current at its first use
            with torch.cuda.device(device), torch.cuda.graph(
                    self.graph, stream=torch.cuda.Stream(device)):
                self.outputs = fn()
        finally:
            self.launches = [m.launches - n for m, n in zip(_LAUNCH_COUNTERS, before)]
            for m, n in zip(_LAUNCH_COUNTERS, before):
                m.launches = n

    def replay(self):
        with torch.cuda.device(self.device):
            self.graph.replay()
        for m, n in zip(_LAUNCH_COUNTERS, self.launches):
            m.launches += n
        return self.outputs


class GraphCache:
    """At most ``size`` :class:`StepGraph` by key, the least recently used
    dropped first.  :meth:`get` returns None at a key's first call, where
    the caller runs eagerly, and captures at its second."""

    def __init__(self, size: int = 4):
        self.size = size
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._warm: set = set()

    def get(self, key: Hashable, capture: Callable[[], StepGraph]) -> Optional[StepGraph]:
        graph = self._graphs.get(key)
        if graph is not None:
            self._graphs.move_to_end(key)
            return graph
        if key not in self._warm:
            self._warm.add(key)
            return None
        graph = self._graphs[key] = capture()
        while len(self._graphs) > self.size:
            self._graphs.popitem(last=False)
        return graph


def copy_carry(dst: EngineCarry, src: EngineCarry) -> None:
    """Copy each tensor of ``src`` into ``dst``'s, but those they share."""
    map_carry(lambda d, s: d if s is d else d.copy_(s), dst, src)


def static_input(buffers: dict, src: torch.Tensor, device) -> torch.Tensor:
    """``src`` copied into the tensor of ``buffers`` (by shape and dtype)
    on ``device``, made at its first use: a graph's input, at a fixed
    address."""
    key = (tuple(src.shape), src.dtype)
    buf = buffers.get(key)
    if buf is None:
        buf = buffers[key] = torch.empty(src.shape, dtype=src.dtype, device=device)
    return buf.copy_(src)
