"""Stream-parallel execution: many independent streams, on one card or
sharded over several.

Port of ``video_stabilization_tpu/parallel/streams.py``.  The JAX package
vmaps the per-frame step over streams and shards the stream axis over a
device mesh.  The port writes the stream dimension out: a carry of S
streams has a leading (S,) on every tensor (:func:`init_batched_carry`), and
the batched step is the engine's one body
(``engine/offline.py::offline_batched_chunk_step``) at K = 1 in the forms
"batched" and "batched_mixed" of ``engine/offline.py::FORMS``, whose stages
run as one batch over the streams: one warp launch for each of dense LK's
four warps and one for the output, whatever S.  The streaming step is the
same body on one stream, so each stream keeps its own ``fold_in`` keys,
ring slots and window.  On a CUDA card a batch of one is the streaming step
bit for bit, while a batch of several rounds differently in dense LK's band
products (cuBLAS) and RANSAC's row sums (the CUDA reductions), whose
summation order follows the batch's shape.

Modes: with ``config.static_mode`` set every stream runs that mode and a
call reads nothing back.  Without it the batched step, its scan and the
sharded step run each stream in its own ``carry.mode``, as the JAX package's
vmap of the dynamic-mode step does: a call reads ``carry.mode`` to the host
once (the scan once for all its frames; over a mesh once per slot, every
slot's before any slot is enqueued), runs the shared stages once over all
S streams, the registration lock only for the ORB and SIFT streams, and
selects each stream's lock and stabilizing homography on the device
(``engine/offline.py``).  :func:`set_stream_mode` switches one stream of a
batched or sharded carry between calls, as ``Stabilizer.set_stabilization_mode``
switches a single stream.  The offline chunk over streams (``make_offline_batched_fn``,
:func:`make_sharded_offline_fn`) requires ``config.static_mode``, as the
JAX package's does.

Sharding: a mesh is a list of devices (:func:`make_stream_mesh`), one
slot per entry.  :func:`shard_carry` splits a carry of S streams into D
contiguous slices of S/D streams, one per slot, and the sharded functions
run the batched forms on each slot's slice on its own device, as the JAX
package shards the stream axis over a 1-D mesh.  Streams never interact,
so nothing moves between devices: a slot's carry, frames and outputs stay
on its device, with no collective.  One host thread enqueues every slot's
work before it waits on any (the forms make no host sync), so the devices
compute at once as far as the host enqueues a slot faster than a device
computes one: on a card the stream-batched chunk enqueues a slot as one
replay of its CUDA graph (``make_offline_batched_fn``), the batched step
kernel by kernel.  On a mesh of more than one slot the carry and the outputs
are :class:`~video_stabilization_tpu_torch.engine.state.Sharded`, with one
part per slot; :func:`unshard` brings them to one device in stream order.
A one-slot mesh keeps the plain carry and tensors.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, List, Sequence

import torch

from video_stabilization_tpu_torch.config import StabilizerConfig
from video_stabilization_tpu_torch.engine.offline import (
    make_offline_batched_fn,
    offline_batched_chunk_step,
)
from video_stabilization_tpu_torch.engine.state import EngineCarry, Sharded, init_carry, map_carry
from video_stabilization_tpu_torch.utils import prng
from video_stabilization_tpu_torch.utils.precision import in_float32
from video_stabilization_tpu_torch.utils.stage_profile import stage

STREAM_AXIS = "streams"

# what the sharded forms' calls (``_over_mesh``, any mesh) cost the host since
# the last :func:`reset_mesh_counters`, host clock only and no sync: the
# calls, each call's wall from its start to its return summed
# (``dispatch_s``), and per slot the time from the call into the slot's
# batched form until it returns, summed (``enqueue_s``, one entry per slot
# of the largest mesh counted); with one host thread the dispatch is about
# the sum of its slots' enqueues
mesh_counters: dict = {}


def reset_mesh_counters() -> None:
    mesh_counters.clear()
    mesh_counters.update(calls=0, dispatch_s=0.0, enqueue_s=[])


reset_mesh_counters()

# what the batched step's calls (:func:`make_batched_step_fn`, the scan's and
# the sharded step's slots included) and :func:`set_stream_mode` cost the
# host since the last :func:`reset_batched_counters`, host clock only and
# no sync: the calls, each call's wall from its start to its return summed
# (``host_s``), the calls that read ``carry.mode`` (``mode_reads``) and the
# streams switched (``switches``)
batched_counters: dict = {}


def reset_batched_counters() -> None:
    batched_counters.clear()
    batched_counters.update(calls=0, host_s=0.0, mode_reads=0, switches=0)


reset_batched_counters()


def init_batched_carry(config: StabilizerConfig, n_streams: int, mode: int,
                       key_words: torch.Tensor, device="cuda") -> EngineCarry:
    """A fresh carry of ``n_streams`` streams on ``device``: every tensor
    has a leading (n_streams,), and stream s has the key
    ``prng.split(key_words, n_streams)[s]``, as ``jax.random.split``."""
    keys = prng.split(torch.as_tensor(key_words, dtype=torch.int64), n_streams)
    return _carry_of_keys(config, mode, keys, device)


def _carry_of_keys(config: StabilizerConfig, mode: int, keys: torch.Tensor,
                   device) -> EngineCarry:
    """A fresh carry on ``device`` of one stream per row of ``keys``."""
    one = init_carry(config, mode, keys[0], device)
    carry = map_carry(lambda x: x[None].expand((len(keys),) + x.shape).clone(), one)
    return dataclasses.replace(carry, key=keys.to(device))


@functools.lru_cache(maxsize=32)
def make_batched_step_fn(config: StabilizerConfig) -> Callable:
    """(carry of S streams, frames (S, Hf, Wf, C)) -> (carry, (outputs (S,
    Hf, Wf, C), valid (S,))): one frame of every stream, the streaming
    step's semantics per stream (ECC's fallback, the referee's u8 gray and
    host-GFTT lanes are the streaming step's).  Without
    ``config.static_mode`` each stream runs its own ``carry.mode``, read
    once per call, or given as ``modes`` (host ints, one per stream) by a
    caller that has read it (the read opens ``stage("mode_read")``).  Float32
    whatever the caller set for TF32.  Each call adds to
    :data:`batched_counters`."""
    form = "batched" if config.static_mode is not None else "batched_mixed"

    @in_float32
    def step(carry: EngineCarry, frames: torch.Tensor, modes=None):
        t = time.perf_counter()
        if config.static_mode is None and modes is None:
            with stage("mode_read"):
                modes = carry.mode.tolist()     # the call's one host read
            batched_counters["mode_reads"] += 1
        carry, (outputs, valid) = offline_batched_chunk_step(
            carry, frames[:, None], config, form=form, modes=modes)
        batched_counters["calls"] += 1
        batched_counters["host_s"] += time.perf_counter() - t
        return carry, (outputs[:, 0], valid[:, 0])

    return step


def set_stream_mode(carry, s: int, mode: int):
    """The carry with stream ``s`` switched to ``mode``: the batched form of
    ``Stabilizer.set_stabilization_mode`` (the reference app's mode keys).
    Stream s's mode is set and its lock state cleared (``accum_h``,
    ``accum_active``, ``lock_prev_h``, ``last_lock_matches`` and both
    registration references); its frame and transform window and every
    other stream stay as they were.  ``carry`` is a batched carry or a
    ``Sharded`` one (the switch lands on the part that holds stream s); its
    tensors are left alone, the new ones are written on their device with
    no host sync.  Opens ``stage("mode_switch")``; counts one switch in
    :data:`batched_counters`."""
    if isinstance(carry, Sharded):
        per = carry.parts[0].n.shape[0]
        parts = list(carry.parts)
        parts[s // per] = set_stream_mode(parts[s // per], s % per, mode)
        return Sharded(tuple(parts))
    with stage("mode_switch"):
        def row(x, value):              # x with row s set to value
            x = x.clone()
            x[s] = value
            return x

        eye = torch.eye(3, dtype=torch.float32, device=carry.accum_h.device)
        refs = {name: map_carry(lambda x: row(x, 0), getattr(carry, name))
                for name in ("orb_ref", "sift_ref")}
        carry = dataclasses.replace(
            carry, mode=row(carry.mode, int(mode)), accum_h=row(carry.accum_h, eye),
            accum_active=row(carry.accum_active, False), lock_prev_h=row(carry.lock_prev_h, eye),
            last_lock_matches=row(carry.last_lock_matches, 0), **refs)
    batched_counters["switches"] += 1
    return carry


@functools.lru_cache(maxsize=32)
def make_batched_scan_fn(config: StabilizerConfig) -> Callable:
    """(carry of S streams, frames (T, S, Hf, Wf, C)) -> (carry, (outputs
    (T, S, Hf, Wf, C), valid (T, S))): the batched step over T frames;
    without ``config.static_mode`` the modes are read once for the T
    frames (the step keeps ``carry.mode``)."""
    step = make_batched_step_fn(config)

    def scan(carry: EngineCarry, frames: torch.Tensor):
        modes = carry.mode.tolist() if config.static_mode is None else None
        outputs, valid = [], []
        for f in frames:
            carry, (out, ok) = step(carry, f, modes)
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
    """The mesh: the devices the streams run on, one slot per entry; the
    given ones ("cuda" is the current card), or every CUDA card (raises
    without one).  An entry may repeat: ``["cpu"] * 4`` or ``[cuda:0,
    cuda:0]`` are several slots on one device, each with its own slice of
    the streams.  They stand in for the JAX tests' virtual CPU devices, and
    for a check of the sharded forms on one card; a slot per device is what
    serves streams faster."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_stream_mesh: no CUDA device; pass devices=['cpu'] "
                               "to run on the CPU")
    return [_indexed(d) for d in devices]


def _per_slot(n_streams: int, mesh: Sequence[torch.device]) -> int:
    if n_streams % len(mesh):
        raise ValueError(f"{n_streams} streams do not split evenly over a mesh of "
                         f"{len(mesh)} slots")
    return n_streams // len(mesh)


def shard_carry(carry, mesh: Sequence[torch.device]):
    """Place a batched carry of S streams on the mesh: on a one-slot mesh
    the carry on its device; else a ``Sharded`` carry whose part d holds
    streams ``d·S/D`` to ``(d+1)·S/D − 1``, copied to slot d's device.  S
    must divide by D (``ValueError``)."""
    mesh = make_stream_mesh(mesh)
    if len(mesh) == 1:
        return map_carry(lambda x: x.to(mesh[0]), carry)
    per = _per_slot(carry.n.shape[0], mesh)
    return Sharded(tuple(map_carry(lambda x: x[d * per:(d + 1) * per].to(dev, copy=True), carry)
                         for d, dev in enumerate(mesh)))


def init_sharded_carry(config: StabilizerConfig, n_streams: int, mode: int,
                       key_words: torch.Tensor, mesh: Sequence[torch.device]):
    """``shard_carry(init_batched_carry(...), mesh)``, each slot's part made
    on its own device: nothing is copied between devices."""
    mesh = make_stream_mesh(mesh)
    if len(mesh) == 1:
        return init_batched_carry(config, n_streams, mode, key_words, mesh[0])
    per = _per_slot(n_streams, mesh)
    keys = prng.split(torch.as_tensor(key_words, dtype=torch.int64), n_streams)
    return Sharded(tuple(_carry_of_keys(config, mode, keys[d * per:(d + 1) * per], dev)
                         for d, dev in enumerate(mesh)))


def _slots(carry, mesh: Sequence[torch.device]) -> tuple:
    """The carry's parts, one per slot, each checked to lie on its slot's
    device."""
    parts = carry.parts if isinstance(carry, Sharded) else (carry,)
    if len(parts) != len(mesh):
        raise ValueError(f"a carry in {len(parts)} part(s) for a mesh of {len(mesh)} slots: "
                         "shard_carry it")
    for d, (part, dev) in enumerate(zip(parts, mesh)):
        if part.frames.device != dev:
            raise ValueError(f"slot {d}: carry on {part.frames.device}, mesh on {dev}: "
                             "shard_carry it")
    return parts


def split_streams(frames, mesh: Sequence[torch.device]) -> list:
    """Frames of all S streams (a tensor or an array with a leading stream
    dimension) as the slots' parts of S/D streams, each moved to its slot's
    device (no copy where it is there already); a ``Sharded`` value is taken
    as already split by slot."""
    if isinstance(frames, Sharded):
        parts = frames.parts
        if len(parts) != len(mesh):
            raise ValueError(f"frames in {len(parts)} parts for a mesh of {len(mesh)} slots")
    else:
        parts = torch.as_tensor(frames).split(_per_slot(frames.shape[0], mesh))
    return [p.to(dev, non_blocking=True) for p, dev in zip(parts, mesh)]


def _over_mesh(fn: Callable, mesh: Sequence[torch.device],
               read_modes: bool = False) -> Callable:
    """``fn`` (a batched form: (carry, frames) -> (carry, (outputs, valid)))
    run on each slot's part of the carry and of the frames.  Every slot is
    enqueued before the next call reads anything back.  With ``read_modes``
    each slot's ``carry.mode`` is read first, every slot's before any slot
    is enqueued, and given to ``fn`` as ``modes``.  Slot d's read and its
    enqueue each open a ``slot<d>`` stage range.  Each call adds to
    :data:`mesh_counters`."""
    mesh = tuple(make_stream_mesh(mesh))

    def run(carry, frames):
        t_call = time.perf_counter()
        slots = _slots(carry, mesh)
        modes = [None] * len(mesh)
        if read_modes:
            for d, c in enumerate(slots):
                with stage(f"slot{d}"):
                    modes[d] = c.mode.tolist()
        results, enqueue_s = [], []
        for d, (c, f) in enumerate(zip(slots, split_streams(frames, mesh))):
            with stage(f"slot{d}"):
                t = time.perf_counter()
                results.append(fn(c, f, modes=modes[d]))
                enqueue_s.append(time.perf_counter() - t)
        if len(mesh) == 1:
            result = results[0]
        else:
            carries, outs = zip(*results)
            outputs, valid = zip(*outs)
            result = Sharded(carries), (Sharded(outputs), Sharded(valid))
        _count(enqueue_s, time.perf_counter() - t_call)
        return result

    return run


def _count(enqueue_s: list, dispatch_s: float) -> None:
    """Add one call of ``_over_mesh`` to :data:`mesh_counters`."""
    slots = mesh_counters["enqueue_s"]
    slots.extend([0.0] * (len(enqueue_s) - len(slots)))
    for d, s in enumerate(enqueue_s):
        slots[d] += s
    mesh_counters["calls"] += 1
    mesh_counters["dispatch_s"] += dispatch_s


def make_sharded_step_fn(config: StabilizerConfig, mesh: Sequence[torch.device]) -> Callable:
    """The batched step over the mesh: (carry placed by :func:`shard_carry`,
    frames (S, Hf, Wf, C)) -> (carry, (outputs (S, Hf, Wf, C), valid (S,))),
    each slot's streams through :func:`make_batched_step_fn` on its device;
    ``Sharded`` carry and outputs on a mesh of several slots.  Without
    ``config.static_mode`` each slot's modes are read once per call."""
    return _over_mesh(make_batched_step_fn(config), mesh, config.static_mode is None)


def make_sharded_offline_fn(config: StabilizerConfig,
                            mesh: Sequence[torch.device]) -> Callable:
    """The stream-batched offline chunk (``make_offline_batched_fn``) over
    the mesh: (carry placed by :func:`shard_carry`, frames (S, K, Hf, Wf,
    C)) -> (carry, (outputs (S, K, Hf, Wf, C), valid (S, K))), as
    :func:`make_sharded_step_fn`."""
    return _over_mesh(make_offline_batched_fn(config), mesh)
