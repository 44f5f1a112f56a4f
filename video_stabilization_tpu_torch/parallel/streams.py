"""Stream-parallel execution: many independent streams on one card.

Port of ``video_stabilization_tpu/parallel/streams.py``.  The JAX package
vmaps the per-frame step over streams and shards the stream axis over a
device mesh.  The port writes the stream dimension out: a carry of S
streams has a leading (S,) on every tensor (:func:`init_batched_carry`), and
the batched step is the offline chunk body
(``engine/offline.py::offline_batched_chunk_step``) at K = 1, whose stages
run as one batch over the streams: one warp launch for each of dense LK's
four warps and one for the output, whatever S.  At K = 1 that body is the
streaming step, so each stream keeps its own ``fold_in`` keys, ring slots
and window.  On a CUDA card a batch of one is the streaming step bit for
bit, while a batch of several rounds differently in dense LK's band
products (cuBLAS) and RANSAC's row sums (the CUDA reductions), whose
summation order follows the batch's shape.

The port branches on a host mode (``config.static_mode``), so every batched
form requires it and raises without: a batch of streams in mixed modes has
no counterpart of the JAX vmap's all-branches select.

Sharding: the port runs on one card.  The sharded functions are the
one-device case (a "mesh" is a list of devices, :func:`make_stream_mesh`);
a mesh of more than one device raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Sequence

import torch

from video_stabilization_tpu_torch.config import StabilizerConfig
from video_stabilization_tpu_torch.engine.offline import (
    BOUNDED_MODES,
    make_offline_batched_fn,
    offline_batched_chunk_step,
    require_static_mode,
)
from video_stabilization_tpu_torch.engine.state import EngineCarry, init_carry, map_carry
from video_stabilization_tpu_torch.utils import prng

STREAM_AXIS = "streams"

_MULTI_DEVICE = ("a stream mesh of more than one device is not ported yet (ROADMAP Queue 1 "
                 "item 15); the port runs the streams on one device")


def init_batched_carry(config: StabilizerConfig, n_streams: int, mode: int,
                       key_words: torch.Tensor, device="cuda") -> EngineCarry:
    """A fresh carry of ``n_streams`` streams on ``device``: every tensor
    has a leading (n_streams,), and stream s has the key
    ``prng.split(key_words, n_streams)[s]``, as ``jax.random.split``."""
    keys = prng.split(torch.as_tensor(key_words, dtype=torch.int64), n_streams)
    one = init_carry(config, mode, keys[0], device)
    carry = map_carry(lambda x: x[None].expand((n_streams,) + x.shape).clone(), one)
    return dataclasses.replace(carry, key=keys.to(device))


def _batched_config(config: StabilizerConfig) -> StabilizerConfig:
    """The batched step's warp arguments, as the JAX package's: the output
    warp without the projective fallback where the correction is bounded by
    construction (``engine.offline.BOUNDED_MODES``), with ``warp_projective_fallback``
    elsewhere; LK's warps, which remove the current global-motion estimate
    first, without it."""
    bounded = (config.static_mode is not None
               and int(config.static_mode) in BOUNDED_MODES)
    return dataclasses.replace(
        config,
        warp_projective_fallback=config.warp_projective_fallback and not bounded,
        lk=dataclasses.replace(config.lk, warp_fallback=False),
    )


@functools.lru_cache(maxsize=32)
def make_batched_step_fn(config: StabilizerConfig) -> Callable:
    """(carry of S streams, frames (S, Hf, Wf, C)) -> (carry, (outputs (S,
    Hf, Wf, C), valid (S,))): one frame of every stream, the streaming
    step's semantics per stream (ECC's fallback, the referee's u8 gray and
    host-GFTT lanes are the streaming step's).
    Requires ``config.static_mode``."""
    require_static_mode(config, "make_batched_step_fn")
    cfg = _batched_config(config)

    def step(carry: EngineCarry, frames: torch.Tensor):
        carry, (outputs, valid) = offline_batched_chunk_step(
            carry, frames[:, None], cfg, streaming=True)
        return carry, (outputs[:, 0], valid[:, 0])

    return step


@functools.lru_cache(maxsize=32)
def make_batched_scan_fn(config: StabilizerConfig) -> Callable:
    """(carry of S streams, frames (T, S, Hf, Wf, C)) -> (carry, (outputs
    (T, S, Hf, Wf, C), valid (T, S))): the batched step over T frames."""
    step = make_batched_step_fn(config)

    def scan(carry: EngineCarry, frames: torch.Tensor):
        outputs, valid = [], []
        for f in frames:
            carry, (out, ok) = step(carry, f)
            outputs.append(out)
            valid.append(ok)
        return carry, (torch.stack(outputs), torch.stack(valid))

    return scan


def _indexed(device) -> torch.device:
    """``device`` with its index: plain "cuda" is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_stream_mesh(devices: Sequence | None = None) -> List[torch.device]:
    """The devices the streams run on: the given ones ("cuda" is the
    current card), or every CUDA card (raises without one)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_stream_mesh: no CUDA device; pass devices=['cpu'] "
                               "to run on the CPU")
    return [_indexed(d) for d in devices]


def _mesh_device(mesh: Sequence[torch.device]) -> torch.device:
    if len(mesh) != 1:
        raise NotImplementedError(f"{_MULTI_DEVICE}: got {len(mesh)} devices")
    return mesh[0]


def shard_carry(carry: EngineCarry, mesh: Sequence[torch.device]) -> EngineCarry:
    """Place a batched carry on the mesh: on its one device."""
    dev = _mesh_device(mesh)
    return map_carry(lambda x: x.to(dev), carry)


def _on_device(fn: Callable, dev: torch.device) -> Callable:
    def run(carry: EngineCarry, frames: torch.Tensor):
        if carry.frames.device != dev:
            raise ValueError(f"carry on {carry.frames.device}, mesh on {dev}: shard_carry it")
        return fn(carry, frames)
    return run


def make_sharded_step_fn(config: StabilizerConfig, mesh: Sequence[torch.device]) -> Callable:
    """The batched step of a carry placed by :func:`shard_carry` on a
    one-device mesh."""
    return _on_device(make_batched_step_fn(config), _mesh_device(mesh))


def make_sharded_offline_fn(config: StabilizerConfig,
                            mesh: Sequence[torch.device]) -> Callable:
    """The stream-batched offline chunk (``make_offline_batched_fn``) of a
    carry placed by :func:`shard_carry` on a one-device mesh."""
    return _on_device(make_offline_batched_fn(config), _mesh_device(mesh))
