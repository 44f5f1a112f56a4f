"""Multi-stream serving harness: N video streams -> the stream-sharded
offline pipeline over a mesh of cards -> per-stream stabilized outputs.

Port of ``video_stabilization_tpu/serve.py``.  The streams are split over
the mesh's slots (``parallel/streams.py``; :func:`pick_serving_devices`
takes the largest prefix of the cards that divides the stream count), S/D
streams per slot.  Data path per chunk of K frames of every stream:

  native C++ Y4M block fread (``io/native.py``, one call per stream and
  chunk) straight into pinned host memory
    -> per slot, one asynchronous H2D copy of its streams' (S/D, K, bytes)
       planar YUV (1.5 B/px for C420) to its card
    -> YUV -> BGR on that card (``ops/image.py::yuv_flat_to_bgr``)
    -> the stream-sharded offline chunk (``parallel/streams.py``): each
       slot's streams through the stream-batched chunk on its card
    -> per slot, the Y4M encode of its outputs on that card
       (``ops/y4m.py``, one launch: the Y|U|V planes, 1.5 B/px for C420)
    -> per slot, asynchronous D2H copies of the planes into pinned host
       memory, then an event on its card's stream
    -> per-stream Y4M writers, one chunk behind, which only write bytes.

Nothing is copied between cards.  Two sets of pinned buffers alternate
between chunks; a slot's parts of them are slices of one pinned allocation
(pinned memory serves every card of the process).  The host waits on a
chunk's events, one per slot, only when it drains that chunk, after it has
queued the next one, so the cards compute chunk i while the host writes
chunk i - 1: a ``.cpu()`` on a compute stream would wait for chunk i as
well.

Run it (on every card; ``device="cpu"`` from Python for the CPU):

  python -m video_stabilization_tpu_torch.serve --files a.y4m b.y4m \\
      --mode smoothing --output-dir out/
  python -m video_stabilization_tpu_torch.serve --simulator 8 --frames 64 \\
      --mode accumulated --output-dir out/

The in-memory entry point :func:`stabilize_streams_sharded` runs the same
pipeline on decoded footage; ``serve_files``' outputs equal it on the same
mesh bit for bit (the planes are ``io/video.py::encode_y4m_planes``' bytes
of what came out).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import shutil
import sys
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from video_stabilization_tpu_torch.utils.stage_profile import stage

# the last serve_files run's counts, its mesh and its wall time split
# (seconds): fread, queueing (H2D, decode, the chunk, the encode, the D2H
# copies), the drain's event waits and its writes (``write_s``: ``_drain``
# whole), and within the writes the writers' own host encode (0: the planes
# come encoded) and file or pipe write, over all writers (``encode_s``,
# ``pipe_write_s``); the frames encoded on the slots' devices in the enqueue
# (``device_encoded``) and the frames each writer wrote (``written``); per
# slot, device ms of its H2D copies, its decode, chunk and encode, and its
# D2H copies (CUDA events, on the card only; slots that share a card share
# its stream, so their spans overlap).  The loop's parts also open stage
# ranges: ``serve_enqueue`` per chunk, within it ``y4m_encode`` per slot,
# ``serve_wait`` per drain, and the readers' ``y4m_read`` and the writers'
# ``y4m_write``.
last_run: dict = {}
# ``torch.cuda.set_sync_debug_mode`` of the chunk loop on the card (after
# the set-up): "warn" lists every synchronizing call the loop makes; the
# drain's event waits are counted in ``last_run["event_waits"]`` instead
loop_sync_debug = None


def pick_serving_devices(devices: Sequence, n_streams: int) -> list:
    """Largest device prefix that divides the stream count (each device
    takes an equal share of the streams)."""
    for d in range(min(len(devices), n_streams), 0, -1):
        if n_streams % d == 0:
            return list(devices[:d])
    return [devices[0]]


def _serve_config(h: int, w: int, working_height: int, past: int, future: int,
                  mode: int, ecc: bool = False):
    from video_stabilization_tpu_torch.config import ECCConfig, StabilizerConfig

    return StabilizerConfig(
        past_frames=past,
        future_frames=future,
        working_height=working_height,
        frame_height=h,
        frame_width=w,
        static_mode=mode,
        ecc=ECCConfig(enabled=ecc),
    )


def stabilize_streams_sharded(footage, config, mesh, chunk: int = 8, key=None):
    """In-memory serving path: footage (S, T, H, W, 3) u8 (a tensor or an
    array, on any device) -> stabilized (S, T, H, W, 3) u8, validity (S, T)
    and the carry, through the stream-sharded offline chunk over ``mesh``.
    Each slot's streams are moved to its device once, up front.  On a mesh
    of several slots the three are ``Sharded`` (``parallel.unshard`` joins
    them), else on the mesh's device.  T must be a multiple of ``chunk``;
    ``key`` is the carry's key words (default ``prng.key(0)``)."""
    from video_stabilization_tpu_torch.parallel import (
        Sharded, init_sharded_carry, make_sharded_offline_fn, make_stream_mesh, split_streams)
    from video_stabilization_tpu_torch.utils import prng

    if config.static_mode is None:
        raise ValueError("serving requires config.static_mode")
    s, t = footage.shape[:2]
    if t % chunk:
        raise ValueError(f"frame count {t} not a multiple of chunk {chunk}")
    if key is None:
        key = prng.key(0)
    mesh = make_stream_mesh(mesh)
    carry = init_sharded_carry(config, s, int(config.static_mode), key, mesh)
    fn = make_sharded_offline_fn(config, mesh)
    parts = split_streams(footage, mesh)
    outs, valids = [], []
    for i in range(0, t, chunk):
        carry, (out, valid) = fn(carry, Sharded(tuple(p[:, i:i + chunk] for p in parts)))
        outs.append(out)
        valids.append(valid)
    if len(mesh) == 1:
        return torch.cat(outs, 1), torch.cat(valids, 1), carry

    def join(chunks):               # per slot, its chunks along time
        return Sharded(tuple(torch.cat([c.parts[d] for c in chunks], 1)
                             for d in range(len(mesh))))

    return join(outs), join(valids), carry


@contextlib.contextmanager
def _loop_sync_debug(cuda: bool):
    """:data:`loop_sync_debug` as the sync debug mode of the enclosed loop."""
    if not (cuda and loop_sync_debug):
        yield
        return
    torch.cuda.set_sync_debug_mode(loop_sync_debug)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


class _Buffers:
    """One set of host buffers of a chunk, for all S streams: the planar
    YUV it reads into, and the outputs' Y4M planes (in the inputs' chroma
    layout, so of the same size) and validity it drains from (pinned on the
    card; slot d's part is the slice of its streams), and each slot's
    events of the chunk."""

    def __init__(self, s: int, chunk: int, nbytes: int, cuda: bool):
        def host(shape, dtype):
            t = torch.empty(shape, dtype=dtype)
            return t.pin_memory() if cuda else t

        self.yuv = host((s, chunk, nbytes), torch.uint8)
        self.out = host((s, chunk, nbytes), torch.uint8)
        self.valid = host((s, chunk), torch.bool)
        self.events = None          # per slot: {name: event on its card's stream}

    def record(self, d: int, name: str, dev: torch.device) -> None:
        if dev.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(dev))
            self.events[d][name] = ev


def serve_files(paths: Sequence[str], output_dir: Optional[str], mode,
                working_height: int = 360, past: int = 60, future: int = 45,
                chunk: int = 8, max_frames: Optional[int] = None,
                devices: Optional[Sequence] = None, config=None, log=print):
    """Stream N Y4M files through the stream-sharded pipeline; write
    per-stream stabilized Y4M files ``stabilized_<name>`` to ``output_dir``
    (skipped when None).  ``devices`` (default every CUDA card; ``["cpu"]``
    runs on the CPU) gives the mesh, of which :func:`pick_serving_devices`
    takes the slots the stream count divides over.  ``mode``: a
    ``StabilizationMode`` or its name, in the app CLI's spelling
    (``cli/args.py::MODE_NAMES``), in serve's (the same without "-lock") or
    as the enum member's.  Returns (frames_done_per_stream, wall_seconds);
    :data:`last_run` holds the run's split."""
    from video_stabilization_tpu_torch.config import StabilizationMode
    from video_stabilization_tpu_torch.io.native import NativeY4MReader
    from video_stabilization_tpu_torch.io.video import VideoWriter
    from video_stabilization_tpu_torch.ops.image import yuv_flat_to_bgr
    from video_stabilization_tpu_torch.ops.y4m import encode_y4m
    from video_stabilization_tpu_torch.parallel import (
        Sharded, init_sharded_carry, make_sharded_offline_fn, make_stream_mesh)
    from video_stabilization_tpu_torch.utils import prng

    readers = [NativeY4MReader(p) for p in paths]
    sizes = {r.frame_size for r in readers}
    c420s = {r.is_c420 for r in readers}
    if len(sizes) != 1 or len(c420s) != 1:
        raise ValueError(f"all streams must share frame size and chroma mode, got "
                         f"sizes {sizes}, c420 {c420s}")
    (h, w), c420 = sizes.pop(), c420s.pop()
    s = len(readers)

    mesh = make_stream_mesh(pick_serving_devices(make_stream_mesh(devices), s))
    n_slots, per = len(mesh), s // len(mesh)
    cuda = mesh[0].type == "cuda"
    log(f"serving {s} stream(s) of {w}x{h} over {n_slots} device(s) "
        f"[{', '.join(map(str, mesh))}], chunk {chunk}")

    if isinstance(mode, str):
        # the app's CLI spellings ("orb-lock"), serve's (the same without
        # "-lock": "orb") and the enum member names ("ORB_FULL_LOCK")
        from video_stabilization_tpu_torch.cli.args import MODE_NAMES

        mode = StabilizationMode[MODE_NAMES.get(mode) or MODE_NAMES.get(f"{mode}-lock")
                                 or mode.upper()]
    else:
        mode = StabilizationMode(mode)
    if config is not None:                  # test/tuned override
        cfg = dataclasses.replace(config, frame_height=h, frame_width=w, static_mode=int(mode))
    else:
        cfg = _serve_config(h, w, working_height, past, future, int(mode),
                            ecc=(mode == StabilizationMode.SIFT_FULL_LOCK))

    offline = make_sharded_offline_fn(cfg, mesh)
    carry = init_sharded_carry(cfg, s, int(mode), prng.key(0), mesh)

    writers = None
    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)
        writers = [VideoWriter(os.path.join(output_dir, f"stabilized_{os.path.basename(p)}"),
                               r.fps, (h, w), subsampling="420" if c420 else "444")
                   for p, r in zip(paths, readers)]

    nbytes = readers[0].yuv_bytes
    buffers = [_Buffers(s, chunk, nbytes, cuda) for _ in range(2)]
    split = dict(read_s=0.0, queue_s=0.0, wait_s=0.0, write_s=0.0,
                 h2d_ms=[0.0] * n_slots, compute_ms=[0.0] * n_slots, d2h_ms=[0.0] * n_slots)
    waits = encoded = 0

    def streams_of(d: int) -> slice:
        return slice(d * per, (d + 1) * per)

    def drain(buf: _Buffers) -> None:
        nonlocal waits
        t0 = time.perf_counter()
        with stage("serve_wait"):
            if cuda:
                for d, ev in enumerate(buf.events):
                    ev["copied"].synchronize()         # this chunk's slot d only
                    waits += 1
                    split["h2d_ms"][d] += ev["start"].elapsed_time(ev["uploaded"])
                    split["compute_ms"][d] += ev["uploaded"].elapsed_time(ev["computed"])
                    split["d2h_ms"][d] += ev["computed"].elapsed_time(ev["copied"])
        t1 = time.perf_counter()
        if writers is not None:
            _drain(writers, buf.out.numpy(), buf.valid.numpy())
        split["wait_s"] += t1 - t0
        split["write_s"] += time.perf_counter() - t1

    done = 0
    t_start = time.perf_counter()
    pending = None                  # the buffers of the chunk still in flight
    i = 0
    with _loop_sync_debug(cuda):
        while max_frames is None or done < max_frames:
            buf = buffers[i % 2]
            t0 = time.perf_counter()
            blocks = [r.read_yuv_block(chunk, out=buf.yuv[si].numpy())
                      for si, r in enumerate(readers)]
            split["read_s"] += time.perf_counter() - t0
            if any(b is None or len(b) < chunk for b in blocks):
                break                   # the shortest stream sets the length
            t0 = time.perf_counter()
            with stage("serve_enqueue"):
                buf.events = [{} for _ in mesh]
                frames = []
                for d, dev in enumerate(mesh):      # each slot's streams on its card
                    buf.record(d, "start", dev)
                    yuv = buf.yuv[streams_of(d)].to(dev, non_blocking=True)
                    buf.record(d, "uploaded", dev)
                    frames.append(yuv_flat_to_bgr(yuv, h, w, c420))
                carry, (out, valid) = offline(carry, Sharded(tuple(frames)))
                outs = out.parts if n_slots > 1 else (out,)
                valids = valid.parts if n_slots > 1 else (valid,)
                for d, dev in enumerate(mesh):     # each slot's outputs encoded on its card
                    with stage("y4m_encode"):
                        planes = encode_y4m(outs[d].reshape(per * chunk, h, w, 3), c420)
                    encoded += per * chunk
                    buf.record(d, "computed", dev)
                    buf.out[streams_of(d)].copy_(planes.view(per, chunk, nbytes),
                                                 non_blocking=True)
                    buf.valid[streams_of(d)].copy_(valids[d], non_blocking=True)
                    buf.record(d, "copied", dev)
            split["queue_s"] += time.perf_counter() - t0
            # drain the PREVIOUS chunk while the cards compute this one
            if pending is not None:
                drain(pending)
            pending = buf
            done += chunk
            i += 1
        if pending is not None:
            drain(pending)
    dt = time.perf_counter() - t_start

    for r in readers:
        r.close()
    for wr in writers or ():
        wr.close()
    encode_s = sum(wr.encode_s for wr in writers or ())
    pipe_write_s = sum(wr.file_write_s for wr in writers or ())
    written = [wr.frames for wr in writers or ()]
    last_run.clear()
    last_run.update(streams=s, frames=done, chunks=i, chunk=chunk, wall_s=dt,
                    devices=[str(d) for d in mesh], event_waits=waits, **split,
                    encode_s=encode_s, pipe_write_s=pipe_write_s, device_encoded=encoded,
                    written=written)
    # an operator's view of the run's split, with no profiler
    log(f"served {done} frames x {s} streams in {dt:.2f}s ({done * s / dt:.1f} aggregate "
        f"fps); host s: read {split['read_s']:.2f}, enqueue {split['queue_s']:.2f}, wait "
        f"{split['wait_s']:.2f}, encode {encode_s:.2f}, pipe write {pipe_write_s:.2f}; "
        f"frames encoded on the device {encoded}; frames written per stream {written}"
        if done else "no full chunks")
    return done, dt


def _drain(writers, planes: np.ndarray, valid: np.ndarray) -> None:
    """Append one chunk's valid frames, their Y4M planes (S, K, bytes) and
    validity (S, K) on the host, to each stream's writer."""
    for si, wr in enumerate(writers):
        for ki in range(planes.shape[1]):
            if valid[si, ki]:
                wr.write_planes(planes[si, ki])


def _render_sim_streams(n_streams, n_frames, h, w, out_dir, device="cuda", log=print):
    """Simulator footage for ``--simulator`` serving, one shake trajectory
    per stream (trajectory seed 5 + s, one texture of seed 0), rendered on
    ``device`` and written as C420 Y4M files into ``out_dir``, so the native
    ingest path is what gets exercised.  Returns the paths."""
    from video_stabilization_tpu_torch.io.video import VideoWriter
    from video_stabilization_tpu_torch.sim import (
        DEFAULT_APP_PARAMS, make_default_texture, render_frame, shake_trajectory)

    tex = torch.from_numpy(make_default_texture(np.random.default_rng(0), 512)).to(device)
    paths = []
    for si in range(n_streams):
        rng = np.random.default_rng(5 + si)
        traj = shake_trajectory(rng.standard_normal((n_frames, 3)),
                                rng.standard_normal(n_frames), DEFAULT_APP_PARAMS,
                                pos_amplitude=0.004, roll_amplitude=0.3, device=device)
        path = os.path.join(out_dir, f"stream{si}.y4m")
        wr = VideoWriter(path, 30.0, (h, w), subsampling="420")
        for i in range(n_frames):
            wr.write(render_frame(tex, traj[i], h, w).cpu().numpy())
        wr.close()
        paths.append(path)
    log(f"rendered {n_streams} simulator streams x {n_frames} frames -> {out_dir}")
    return paths


def main(argv=None, device=None, keep_inputs: bool = False):
    """The command line.  Serves over ``device``: every CUDA card by default
    (``parallel.make_stream_mesh()``), else the one device named (``"cpu"``
    for the CPU) or a list of them, the mesh.  ``--simulator`` streams are
    rendered on the mesh's first device into a temporary directory, removed
    at the end unless ``keep_inputs`` (its paths are then in
    ``last_run["inputs"]``)."""
    ap = argparse.ArgumentParser(
        prog="python -m video_stabilization_tpu_torch.serve",
        description="Multi-stream stabilization serving over the CUDA cards.")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--files", nargs="+", help="input Y4M files, one per stream")
    src.add_argument("--simulator", type=int, metavar="N",
                     help="serve N synthetic simulator streams")
    ap.add_argument("--mode", default="smoothing",
                    choices=["smoothing", "accumulated", "orb", "sift",
                             "translation", "rotation"])
    ap.add_argument("--output-dir", default=None,
                    help="write stabilized_<name>.y4m per stream here")
    ap.add_argument("--working-height", type=int, default=360)
    ap.add_argument("--past-window", type=float, default=2.0,
                    help="seconds (reference default, src/main_utils.hpp:25)")
    ap.add_argument("--future-window", type=float, default=1.5)
    ap.add_argument("--fps", type=float, default=30.0,
                    help="fps used to size the temporal window")
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--frames", type=int, default=None,
                    help="stop after this many frames per stream")
    ap.add_argument("--sim-size", default="1920x1080",
                    help="WxH of --simulator streams")
    args = ap.parse_args(argv)

    from video_stabilization_tpu_torch.parallel import make_stream_mesh

    if isinstance(device, (str, torch.device)):
        device = [device]
    if any(torch.device(d).type == "cuda" for d in device or ()) and \
            not torch.cuda.is_available():
        raise RuntimeError(f"serve: devices {device} requested but CUDA is not available")
    mesh = make_stream_mesh(device)
    paths = args.files
    sim_dir = None
    if paths is None:
        w, h = (int(x) for x in args.sim_size.split("x"))
        sim_dir = tempfile.mkdtemp(prefix="vstab_serve_")
        paths = _render_sim_streams(args.simulator, args.frames or 64, h, w, sim_dir, mesh[0])

    past = max(1, int(round(args.past_window * args.fps)))
    future = max(0, int(round(args.future_window * args.fps)))
    try:
        serve_files(paths, args.output_dir, args.mode,
                    working_height=args.working_height, past=past, future=future,
                    chunk=args.chunk, max_frames=args.frames, devices=mesh)
    finally:
        if sim_dir is not None and not keep_inputs:
            shutil.rmtree(sim_dir, ignore_errors=True)
    if keep_inputs:
        last_run["inputs"] = list(paths)
    return 0


if __name__ == "__main__":
    sys.exit(main())
