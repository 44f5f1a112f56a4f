"""Smoke run of the PyTorch / CUDA port on the NVIDIA GPUs of one host (one
card is enough; phase 13 takes every card there is).

    python3 chip_smoke.py [--seed N] [--frames N] [--lock-frames N] [--orb-frames N]
    python3 chip_smoke.py --mesh-only    # phases 1, 2, 13 and 14's mesh part: the multi-card check

Phases (each prints its lines; any failure raises and the exit code is not 0):

1. device: CUDA must be available (no CPU fallback); torch/CUDA versions and
   the card's name and power limit from nvidia-smi;
2. build: compile every kernel of ``csrc/``, one nvcc per source, all at
   once (seconds each);
3. kernels vs plain: the fused warp kernel at every warp shape of configs
   1 and 3, on (H, W, C) and planar memory, inside the rotation envelope
   and outside it (the gather branch on the device), and the FAST-levels
   kernel on the ten ORB level shapes of a 360x640 working image at once
   (random integer images and the real level images of one rendered
   720x1280 frame), against their plain PyTorch versions on the card
   (exact), with median CUDA-event times; the warp kernel's batches at
   every batched path's shapes (16 items for an offline chunk of configs 1,
   3 and 4, 8 and 64 for config 5's batched step and chunk; mixed inside
   and outside the envelope, per-item borders), exact, with their device
   times;
   ``grid_sample`` at 3x1080x1920 as a yardstick for a one-pass warp of the
   same bytes;
4. the config-1 slice: bench config 1 (1080x1920 frames, working height
   360, window 30 + 1 + 15) through ``Stabilizer.stabilize_frame`` on footage
   rendered on the card by the port's simulator; GLOBAL_SMOOTHING, then
   ACCUMULATED_FULL_LOCK; launch counts, the device's count of warps
   outside the envelope (read once), host syncs of one frame under
   ``torch.cuda.set_sync_debug_mode``, corner drift against the analytic
   inter-frame motion, jitter reduction, ms/frame;
5. the ORB slice: bench config 3 (720x1280 frames, working height 360, the
   default ORB settings, window 30 + 1 + 15) in ORB_FULL_LOCK through
   ``Stabilizer.stabilize_frame``; launch counts of both kernels, host
   syncs of one frame, the captured reference, lock matches, jitter against
   the raw footage and an ideal lock, ms/frame;
6. the SIFT slice: bench config 4 (1080x1920 frames, working height 360,
   the default SIFT settings, ECC with 30 iterations, same window) in
   SIFT_FULL_LOCK, with the ORB slice's checks, the shares of registered
   frames whose ECC refinement was valid and raised rho above its start,
   and ECC with the warp kernel against ECC with the plain warp on one real
   frame pair (equal, and moved from the identity);
7. reference: the step on a small clip, on the card and on the CPU (plain
   versions), frame for frame, in GLOBAL_SMOOTHING, in ORB_FULL_LOCK and in
   SIFT_FULL_LOCK with ECC;
8. the offline slices: the offline chunk step (``engine/offline.py``) in
   chunks of 16 on the footage of the config-1 (GLOBAL_SMOOTHING part), ORB
   and SIFT slices (config 4: its first 32 frames, a depth cut); launches
   per chunk, host syncs of the warm-up chunk, outputs against the streaming
   slice's frame by frame, the slice's quality bounds, ms/frame and device
   events per frame beside the streaming step's;
9. the config-5 slice: bench config 5 (8 streams of 1080x1920 frames, one
   trajectory seed each, working height 360, window 30 + 1 + 15, 24
   frames) in TRANSLATION_LOCK and in GLOBAL_SMOOTHING through the batched
   step (``parallel.make_batched_step_fn``) and the stream-batched offline
   chunk (``engine.make_offline_batched_fn``, chunks of 8): warp launches
   per step and per chunk, host syncs of an untimed warm-up step and chunk,
   the device's count of warps outside the envelope, each stream's outputs
   against its own single-stream run frame by frame (and stream 0 alone, a
   batch of one, bit for bit), where a batch of the streams rounds
   differently from one stream on the card, ms per batched frame
   and frames/s, device events per batched frame beside 8 x the
   single-stream step's, and peak device memory;
10. serving: ``serve.main`` at bench config 5's size (8 simulator streams of
   1080x1920 rendered on the card into C420 Y4M files, 32 frames, window 30
   + 1 + 15, chunks of 8, GLOBAL_SMOOTHING), its files against the
   in-memory ``stabilize_streams_sharded`` on the same decoded footage
   (byte for byte through the writer's encode), the card's YUV decode
   against the native reader's, warp launches per chunk, host syncs in the
   loop, the wall time split (read, queueing, drain wait, drain write;
   device H2D, compute, D2H), frames/s and the device's idle share; then a
   short ``--mode orb`` run (2 streams x 16 frames) for FAST's serving path;
   then, on the same inputs, phase 13's serving part over its mesh;
11. the app: ``cli.app.main`` headless at its defaults (720x1280 simulator
   frames, working height 360, window 60 + 1 + 45), 96 frames with
   ``--checkpoint`` and ``--stats``, again with ``--resume`` (frame counter
   192), once more in ``--mode orb-lock``; each file against
   ``Stabilizer.stabilize_frame`` on the same frames, launches and host
   syncs per frame, the loop's ms/frame beside the Stabilizer's alone;
12. every motion model, the referee and the app's flags at config 1's size
   (run after phase 8, on the config-1 slice's footage): 12a, 32
   GLOBAL_SMOOTHING frames with ``motion_model`` similarity, affine and
   homography (warp launches 5 / 5 / 4 per frame, 0 host syncs per steady
   frame, drift and jitter under the slice's bounds, ms/frame, device
   events per frame); 12b, the offline chunk (K = 16) with affine and with
   homography against 12a's streaming runs (5 and 4 launches per chunk);
   12c, the referee, 24 frames each of ``bench.py::compat_drift``'s
   configuration (the host-estimator split; 1 warp launch per frame) and
   ``production_drift``'s (5), with drift, host reads and syncs per frame
   by source line (only in the named host stages), ms/frame, and the exact
   u8 gray on the card against the CPU's; 12d (after phase 11), the app
   with ``--trail``, ``--motion-model homography`` and
   ``--reference-compat``, 60 frames each, against the ``Stabilizer``;
   12e, the device time of the plain PyTorch ops of these paths (the
   perspective and shear warps, the trail, the DLT and affine fits,
   cv2exact LK and its patch extraction, cv2's exact corner list and its
   greedy fixpoint);
13. the sharded forms over a mesh (run after phase 9): with two or more
   cards the slots ``serve.pick_serving_devices`` takes for config 5's 8
   streams, one per card; with one card two slots on it (an earlier line
   says which, and how many cards there are).  With two or more cards
   first the warp (one image and a batch) and FAST on the last card
   against their plain versions there, while card 0 is current.  Config 5
   (phase 9's sizes and seeds, 16 frames) in TRANSLATION_LOCK and
   GLOBAL_SMOOTHING through ``parallel.make_sharded_step_fn`` and
   ``make_sharded_offline_fn`` (chunks of 8), each slot's streams rendered
   once onto its card: each slot's outputs bit for bit against its own
   sub-batch through the one-device batched form, every stream within phase
   9's bound of the one-device run of all 8, 0 host syncs in a warm-up
   call, every carry tensor on its slot's device after every call, 5 warp
   launches per slot per call, no peer-to-peer copy in a profiled call;
   ms per batched frame over the mesh against the one-device forms, busy ms
   and idle share per card, peak memory per card.  Its serving part (in
   phase 10, on phase 10's inputs): ``serve.main --files`` over the mesh,
   its files against the in-memory ``stabilize_streams_sharded`` on the
   same mesh byte for byte, 5 warp launches per slot and chunk, one event
   wait per slot and chunk, no host sync in the loop; and ``--mode orb``
   over the mesh;
14. mixed modes (run after phase 13): config 5 (phase 9's sizes and seeds, 16
   frames) with no static mode through ``parallel.make_batched_step_fn``, the
   streams' modes interleaved GLOBAL_SMOOTHING, TRANSLATION_LOCK,
   ACCUMULATED_FULL_LOCK, ORB_FULL_LOCK, twice: exactly one host sync per
   call, at the mode read (by source line), in a warm-up call; 5 warp and 2
   FAST launches per call; each stream bit for bit against stream s of the
   body on the whole batch in its own mode, with the same warp arguments,
   from a clone of the carry before each call (four runs per call); ms per
   batched frame beside phase 9's one-mode batched step, peak device
   memory.  Then the same modes over phase 13's mesh through
   ``make_sharded_step_fn`` for 8 frames: each slot bit for bit against its
   sub-batch through the one-device mixed form, one mode read per slot per
   call, no peer-to-peer copy, the carry on its slots (``--mesh-only`` runs
   this part too).
15. the Y4M encode kernel (``csrc/y4m_encode.cu``, run after phase 10; it
   replaces no TPU kernel): on serving's chunk at config 5 (8 streams x 8
   frames of 1080x1920, random content), C420 and C444, against its plain
   version on the card and against the numpy encode (``io/video.py::
   encode_y4m_planes``) on the host for the first frames, exact; its
   launches per served chunk from phases 10 and 13 (one per slot and
   chunk, and every served frame encoded on the card); its time by CUDA
   graph and back to back against its byte bound, beside the plain
   version's.

The line before the last holds the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

# per-frame count of 2-pass warps at each shape, by configuration: LK levels
# 2, 1 and 0 (twice) of the 360x640 working image, then the output frame;
# at config 4 ECC warps the 360x640 gray image once per iteration, then at
# the final and the initial transform
ECC_ITERS = 30           # bench config 4 (bench.py engine_config)
SIFT_FRAMES = 64         # frames of the config-4 slice
_LK_WARPS = {(1, 90, 160): 1, (1, 180, 320): 1, (1, 360, 640): 2}
WARPS_PER_FRAME = {"config1": {**_LK_WARPS, (3, 1080, 1920): 1},
                   "config3": {**_LK_WARPS, (3, 720, 1280): 1},
                   "config4": {**_LK_WARPS, (1, 360, 640): 2 + ECC_ITERS + 2,
                               (3, 1080, 1920): 1},
                   # phase 12: the homography model's output goes through
                   # warp_perspective (dense LK's warps only); the referee
                   # with per-point LK warps only its output
                   "config1_lk_only": dict(_LK_WARPS),
                   "output_only": {(3, 1080, 1920): 1}}
SHAPES = sorted({s for warps in WARPS_PER_FRAME.values() for s in warps})
# one launch per warp, whichever branch the device takes
LAUNCHES_PER_FRAME = {k: sum(v.values()) for k, v in WARPS_PER_FRAME.items()}
# one FAST launch per ORB frame covers the ten pyramid levels of the
# 360x640 working image
FAST_SHAPES = ((360, 640), (300, 533), (250, 444), (208, 370), (174, 309),
               (145, 257), (121, 214), (100, 179), (84, 149), (70, 124))
FAST_LAUNCHES_PER_FRAME = 1
FAST_THRESHOLD = 20.0    # ORBConfig defaults
EDGE_THRESHOLD = 31
KERNEL_TOL = 0.0         # the warp kernel equals its plain version bit for bit
FAST_TOL = 0.0           # so does the FAST kernel
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# operations per output pixel: one resample pass (position, floor, two
# guarded taps, lerp) and the border test fused into pass H; FAST (16
# margins, 2 x 57 minima and maxima for the best 9-arc of each polarity by
# block prefix and suffix extrema, one negation, the final maximum and the
# threshold test: 133), its 3x3 NMS (8 maxima, the two tests, the select:
# 11) and the edge mask (4 comparisons, the select: 5)
RESAMPLE_OPS = 12
BORDER_OPS = 10
FAST_OPS = 133 + 11 + 5
DRIFT_TOL = 2.0          # px mean corner drift at working res
SMOOTH_JITTER = 0.75     # stabilized / raw central-crop jitter
LOCK_JITTER = 0.4        # accumulated lock / raw jitter
LOCK_VS_IDEAL = 1.25     # accumulated lock / lock by the analytic motion
ORB_JITTER = 0.6         # ORB lock / raw presented jitter (tests/test_engine.py)
ORB_MATCHED = 0.9        # share of registered frames with >= min_points matches
SIFT_JITTER = 0.6        # SIFT lock / raw presented jitter, as the ORB lock
ECC_IMPROVED = 0.75      # share of registered frames on which ECC raised rho
REF_DRIFT_TOL = 0.05     # px, card vs CPU per-frame last_h
REF_MEAN_U8 = 0.5        # mean |card - CPU| output, u8 levels
REF_MATCHES = 2          # |card - CPU| lock matches per frame
OFFLINE_CHUNK = 16       # the offline form's chunk (bench.py's throughput path)
SIFT_OFFLINE_FRAMES = 32  # config-4 offline frames: a depth cut from 64 (smoke time)
OFFLINE_DIFFER = 0.02    # per frame, share of pixels where offline != streaming
OFFLINE_OFF_BY_MORE = 0.001  # per frame, share off by more than one level
STREAM_PROFILED = 4      # streaming frames profiled for device events per frame
# warp launches of one offline chunk or batched step, whatever its size:
# LK's four warps and the output warp, each over the whole batch; ECC's
# warps stay per frame
BATCHED_LAUNCHES = 5
N_STREAMS = 8            # bench config 5 (bench.py CONFIGS[5])
STREAM_FRAMES = 24       # its max_frames
STREAM_CHUNK = 8         # bench.py's offline chunk for several streams
SHARDED_FRAMES = 16      # phase 13's frames: a depth cut from phase 9's 24 (smoke time)
MESH_ONLY_SERVE_FRAMES = 16  # --mesh-only: frames per served stream (two chunks)
# the batched warps of each batched path: (items per launch, frames per
# launch, launches per shape); config 5's batched step serves one frame of
# each of the 8 streams, its offline chunk 8 frames of each.  At config 4
# the 32 ECC warps per frame stay single launches.
BATCHED_PATHS = {
    "offline_config1": (OFFLINE_CHUNK, OFFLINE_CHUNK, WARPS_PER_FRAME["config1"]),
    "offline_config3": (OFFLINE_CHUNK, OFFLINE_CHUNK, WARPS_PER_FRAME["config3"]),
    "offline_config4": (OFFLINE_CHUNK, OFFLINE_CHUNK, WARPS_PER_FRAME["config1"]),
    "config5": (N_STREAMS, 1, WARPS_PER_FRAME["config1"]),
    "offline_config5": (N_STREAMS * STREAM_CHUNK, STREAM_CHUNK, WARPS_PER_FRAME["config1"]),
    "offline_config1_lk_only": (OFFLINE_CHUNK, OFFLINE_CHUNK, _LK_WARPS),
}
ECC_WARPS = {(1, 360, 640): ECC_ITERS + 2}   # per frame at config 4, single launches
# phase 10: serve.main at bench config 5's size; a short ORB run for the
# FAST kernel's serving path
# (32 frames: a depth cut from 48 that keeps the smoke within half its time
# limit once phase 13 serves the same inputs over the mesh)
SERVE_STREAMS, SERVE_FRAMES, SERVE_CHUNK, SERVE_SIZE = 8, 32, 8, (1080, 1920)
SERVE_ARGV = ["--simulator", str(SERVE_STREAMS), "--frames", str(SERVE_FRAMES), "--sim-size",
              "1920x1080", "--past-window", "1.0", "--future-window", "0.5", "--chunk",
              str(SERVE_CHUNK), "--mode", "smoothing"]
SERVE_ORB_ARGV = ["--simulator", "2", "--frames", "16", "--sim-size", "1920x1080",
                  "--past-window", "1.0", "--future-window", "0.5", "--chunk", "8",
                  "--mode", "orb"]
# phase 11: the app at its defaults (720x1280 simulator, working height
# 360, window 60 + 1 + 45)
APP_FRAMES = 96
# phase 15: the Y4M encode of one served chunk at config 5; per pixel it
# reads 3 B of BGR and writes 1.5 B (C420) or 3 B (C444) of planes, and
# computes Y (3 products, 2 sums), U and V (a difference, a product and a
# sum each), the clip and the cast of each output byte (2 each: 3 a pixel
# at C420, 6 at C444) and, at C420, the 2x2 means of U and V (3 sums and a
# product each, over 4 px: 2 a pixel)
Y4M_FRAMES = N_STREAMS * SERVE_CHUNK
Y4M_NUMPY_FRAMES = 8     # frames also held against the numpy encode
Y4M_BYTES = {True: 3 + 1.5, False: 3 + 3}
Y4M_OPS = {True: 11 + 3 + 2, False: 11 + 6}


def rigid(theta_deg: float, tx: float = 0.0, ty: float = 0.0) -> np.ndarray:
    t = np.deg2rad(theta_deg)
    return np.array([[np.cos(t), -np.sin(t), tx], [np.sin(t), np.cos(t), ty],
                     [0.0, 0.0, 1.0]], np.float32)


TRANSFORMS = {
    "identity": rigid(0.0),
    "translate": rigid(0.0, 7.0, -4.0),
    "rot0.5": rigid(0.5, 1.3, -0.7),
    "rot3": rigid(3.0, -2.6, 1.9),
    "rot8": rigid(8.0, 0.4, -3.3),
    "rot12": rigid(12.0, 2.1, -1.4),     # outside the envelope: the gather
}


def corner_drift(hs_a, hs_b, ww, wh, skip=5) -> float:
    """Mean corner displacement (px, working res) between two sequences of
    3x3 transforms (the benchmark's drift metric)."""
    c = np.array([[0, 0, 1], [ww, 0, 1], [ww, wh, 1], [0, wh, 1]], float).T
    drifts = []
    for ha, hb in zip(hs_a[skip:], hs_b[skip:]):
        pa = ha @ c
        pb = hb @ c
        drifts.append(np.abs(pa[:2] / pa[2] - pb[:2] / pb[2]).mean())
    return float(np.mean(drifts))


def jitter(seq: torch.Tensor, crop) -> float:
    """Mean absolute frame-to-frame difference over a central crop."""
    x = seq[:, crop[0], crop[1]].float()
    return float((x[1:] - x[:-1]).abs().mean())


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, inner: int = 10, warmup: int = 3) -> float:
    """Median over ``reps`` of the per-call time of ``inner`` back-to-back
    calls, from CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def warp_input(shape, layout, rng, dev) -> torch.Tensor:
    """Random 0-255 content as the warp takes it: "hwc" an (H, W, C) frame
    ((H, W) for one channel, as dense LK passes it), "planar" an (H, W, C)
    view of (C, H, W) memory ((H, W, 1) for one channel)."""
    c, h, w = shape
    x = torch.from_numpy(rng.uniform(0, 255, shape).astype(np.float32)).to(dev)
    if layout == "planar":
        return x.permute(1, 2, 0)
    return x[0] if c == 1 else x.permute(1, 2, 0).contiguous()


def device_ms(fn, n: int = 40) -> float:
    """Device time per call of ``fn``: median of 15 replays of a CUDA graph
    of ``n`` calls, CUDA events (the kernels without the host's launch)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(15):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def phase_kernel(dev, rng) -> dict:
    """The fused warp kernel vs its plain version at every warp shape of
    both main paths, both layouts and every transform (exact); returns the
    error, and per configuration the per-frame kernel / plain ms (warps
    weighted by WARPS_PER_FRAME) and bound."""
    import torch.nn.functional as F

    from video_stabilization_tpu_torch.ops import affine_warp as aw
    from video_stabilization_tpu_torch.ops.warp import _inv3x3

    max_err = 0.0
    times = {}
    counter = aw.fallback_counter(dev)
    for shape in SHAPES:
        # the main path's border: the frame's mean colour on the card for the
        # output warp, 0.0 by value for dense LK
        border = (torch.from_numpy(rng.uniform(0, 255, 3).astype(np.float32)).to(dev)
                  if shape[0] == 3 else 0.0)
        for layout in ("hwc", "planar"):
            src = warp_input(shape, layout, rng, dev)
            for name, m in TRANSFORMS.items():
                h = torch.from_numpy(m).to(dev)
                counter.zero_()
                k = aw.warp_affine(src, h, border)
                p = aw.warp_affine_plain(src, h, border)
                err = float((k - p).abs().max())
                max_err = max(max_err, err)
                gathered = int(counter)
                inside = bool(aw.affine_envelope_ok(h))
                if not err <= KERNEL_TOL or gathered != (0 if inside else 1):
                    raise AssertionError(f"warp kernel vs plain {shape} {layout} {name}: "
                                         f"max abs {err}, gather count {gathered}")
        # time one warp as the main path calls it, and the launch alone
        # (inverse map prepared outside the timed call)
        src = warp_input(shape, "hwc", rng, dev)
        h = torch.from_numpy(TRANSFORMS["rot3"]).to(dev)
        items = src[None]
        hinv = _inv3x3(h)[None].contiguous()
        bt = border if isinstance(border, torch.Tensor) else None
        bs = 0.0 if bt is not None else border
        ms = time_ms(lambda: aw._launch(items, hinv, bt, 0, bs, True))
        dev_ms = device_ms(lambda: aw._launch(items, hinv, bt, 0, bs, True))
        call_ms = time_ms(lambda: aw.warp_affine(src, h, border))
        plain_ms = time_ms(lambda: aw.warp_affine_plain(src, h, border))
        times[shape] = (ms, plain_ms, dev_ms)
        print(f"warp {shape}: kernel {ms:.4f} ms back to back, {dev_ms:.4f} ms device "
              f"(CUDA graph), warp_affine call {call_ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"(back to back: median of 20 x 10, CUDA events)", flush=True)
    print(f"warp kernel vs plain: max abs err {max_err} <= {KERNEL_TOL} over "
          f"{len(SHAPES)} shapes x 2 layouts x {len(TRANSFORMS)} transforms "
          f"(rot12 on the device's gather)", flush=True)

    # a one-pass bilinear warp of the same bytes, as a yardstick only: not
    # the same function (direct bilinear, not the 2-pass result)
    x = torch.from_numpy(rng.uniform(0, 255, (1, 3, 1080, 1920)).astype(np.float32)).to(dev)
    theta = torch.from_numpy(TRANSFORMS["rot3"][:2][None]).to(dev)
    grid = F.affine_grid(theta, list(x.shape), align_corners=True)
    gs_ms = time_ms(lambda: F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                                          align_corners=True))
    print(f"yardstick (not the same function): grid_sample bilinear/zeros/align_corners "
          f"3x1080x1920 {gs_ms:.4f} ms vs the warp kernel {times[(3, 1080, 1920)][0]:.4f} ms",
          flush=True)

    out = {"max_abs_err": max_err}
    for name, warps in WARPS_PER_FRAME.items():
        # least time of one frame's warps: one read of the input and one
        # write of the output, C·H·W f32 each
        px = sum(n * c * h * w for (c, h, w), n in warps.items())
        out[name] = {"ms": sum(n * times[s][0] for s, n in warps.items()),
                     "plain_ms": sum(n * times[s][1] for s, n in warps.items()),
                     "device_ms": sum(n * times[s][2] for s, n in warps.items()),
                     **bound_ms(8 * px, (2 * RESAMPLE_OPS + BORDER_OPS) * px)}
        print(f"warp {name}: per frame {out[name]['ms']:.4f} ms back to back, "
              f"{out[name]['device_ms']:.4f} ms device, plain {out[name]['plain_ms']:.4f} "
              f"ms, bound {out[name]['bound_ms']:.5f} ms ({out[name]['bound_by']}, "
              f"{px} px)", flush=True)
    out["times"] = times
    return out


def mixed_transforms(b: int, rng, inside_only: bool = False) -> np.ndarray:
    """(B, 3, 3) rigid transforms of the step's size (within 6 degrees and
    4 px); unless ``inside_only``, every fourth one 12 or 20 degrees,
    outside the envelope."""
    hs = []
    for i in range(b):
        theta = rng.uniform(-6.0, 6.0)
        if not inside_only and i % 4 == 3:
            theta = 12.0 if i % 8 == 3 else 20.0
        hs.append(rigid(theta, *rng.uniform(-4.0, 4.0, 2)))
    return np.stack(hs)


def phase_batched_kernel(dev, rng, single: dict, paths: dict) -> dict:
    """The warp kernel's batches, one launch each, at every batched path's
    shapes (``paths``: BATCHED_PATHS, 16 items for an offline chunk of
    configs 1, 3 and 4, 8 for config 5's batched step, 64 for its chunk;
    and the sharded paths' per-slot batches of phase 13), per-item
    borders on the output frames, a batch that mixes items inside and
    outside the envelope, against the plain version item by item (exact),
    and the device's count of the items outside.  Times a batch as the main
    path launches it (all inside) and returns, per path and per frame (for
    config 5: per batched frame of 8 streams), the kernel / plain / device
    ms and the bound; ``single`` holds phase 3's single-image times, for
    config 4's ECC warps."""
    from video_stabilization_tpu_torch.ops import affine_warp as aw
    from video_stabilization_tpu_torch.ops.warp import _inv3x3

    counter = aw.fallback_counter(dev)
    max_err = 0.0
    times = {}
    batches = sorted({(b,) + shape for b, _, warps in paths.values() for shape in warps})
    for b, c, h, w in batches:
        src = torch.from_numpy(rng.uniform(0, 255, (b, h, w, c)).astype(np.float32)).to(dev)
        if c == 1:
            src = src[..., 0]
        border = (torch.from_numpy(rng.uniform(0, 255, (b, c)).astype(np.float32)).to(dev)
                  if c == 3 else 0.0)
        hs = torch.from_numpy(mixed_transforms(b, rng)).to(dev)
        outside = int((~aw.affine_envelope_ok(hs)).sum())
        counter.zero_()
        launches = aw.launches
        k = aw.warp_affine(src, hs, border)
        if aw.launches - launches != 1:
            raise AssertionError(f"batched warp {b}x{(c, h, w)}: "
                                 f"{aw.launches - launches} launches")
        gathered = int(counter)
        p = aw.warp_affine_plain(src, hs, border)
        err = float((k - p).abs().max())
        max_err = max(max_err, err)
        if not err <= KERNEL_TOL or gathered != outside or outside != b // 4:
            raise AssertionError(f"batched warp {b}x{(c, h, w)} vs plain: max abs {err}, "
                                 f"gather count {gathered} of {outside} outside")
        # as the main path launches it: every item inside the envelope
        hs = torch.from_numpy(mixed_transforms(b, rng, inside_only=True)).to(dev)
        hinv = _inv3x3(hs).contiguous()
        bt = border if isinstance(border, torch.Tensor) else None
        stride = c if bt is not None else 0

        def launch():
            return aw._launch(src, hinv, bt, stride, 0.0, False)

        ms = time_ms(launch)
        # a graph keeps each replayed launch's output: few for a big batch
        dev_ms = device_ms(launch, n=40 if src.numel() < 2 ** 25 else 4)
        plain_ms = time_ms(lambda: aw.warp_affine_plain(src, hs, border), reps=3, inner=1,
                           warmup=1)
        times[(b, c, h, w)] = (ms, plain_ms, dev_ms)
        print(f"batched warp {b} x {(c, h, w)}: equal to the plain version item by item "
              f"(max abs {err}), {gathered} of {b} items on the device's gather; kernel "
              f"{ms:.4f} ms back to back, {dev_ms:.4f} ms device (CUDA graph), plain "
              f"{plain_ms:.4f} ms", flush=True)
        del src, k, p
    out = {"max_abs_err_batched": max_err}
    for path, (b, frames, warps) in paths.items():
        per_frame = ECC_WARPS if path == "offline_config4" else {}
        px = (b * sum(n * c * h * w for (c, h, w), n in warps.items()) / frames
              + sum(n * c * h * w for (c, h, w), n in per_frame.items()))
        out[path] = {name: (sum(n * times[(b,) + shape][i] for shape, n in warps.items()) / frames
                            + sum(n * single[shape][i] for shape, n in per_frame.items()))
                     for i, name in enumerate(("ms", "plain_ms", "device_ms"))}
        out[path].update(bound_ms(8 * px, (2 * RESAMPLE_OPS + BORDER_OPS) * px))
        unit = f"batched frame ({N_STREAMS} streams)" if path.endswith("config5") else "frame"
        print(f"warp {path}: per {unit} {out[path]['ms']:.4f} ms back to back, "
              f"{out[path]['device_ms']:.4f} ms device, plain {out[path]['plain_ms']:.4f} ms, "
              f"bound {out[path]['bound_ms']:.5f} ms ({out[path]['bound_by']}, {px:.0f} px)",
              flush=True)
    return out

def bound_ms(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: bytes over the HBM rate or f32
    operations over the peak rate, whichever is larger."""
    t_bytes, t_ops = 1e3 * n_bytes / PEAK_BYTES, 1e3 * n_ops / PEAK_F32
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def orb_levels(frame: torch.Tensor, cfg) -> list:
    """The ORB pyramid levels of one frame's preprocessed working image, as
    the lock builds them (``engine/lock.py``, ``ops/orb.py``)."""
    from video_stabilization_tpu_torch.ops.filters import preprocess_for_registration
    from video_stabilization_tpu_torch.ops.image import (
        bgr_to_gray, resize_bilinear, resize_nearest)

    wh, ww = cfg.working_size
    proc = preprocess_for_registration(bgr_to_gray(resize_nearest(frame.float(), wh, ww)))
    levels = [proc]
    for h, w in FAST_SHAPES[1:]:
        levels.append(resize_bilinear(proc, h, w).contiguous())
    return levels


def phase_fast_kernel(dev, rng, levels) -> dict:
    """The FAST-levels kernel vs its plain version on the ten level shapes
    at once, on random integer images and on the real ``levels`` of one
    frame: exact equality, and per-frame kernel / plain ms (one launch)."""
    from video_stabilization_tpu_torch.ops import fast

    if [tuple(x.shape) for x in levels] != list(FAST_SHAPES):
        raise AssertionError(f"level shapes {[tuple(x.shape) for x in levels]}")
    noise = [torch.from_numpy(np.round(rng.uniform(0, 255, s)).astype(np.float32)).to(dev)
             for s in FAST_SHAPES]
    max_err = 0.0
    for kind, imgs in (("random", noise), ("frame", levels)):
        k = fast.fast_levels(imgs, FAST_THRESHOLD, EDGE_THRESHOLD)
        p = fast.fast_levels_plain(imgs, FAST_THRESHOLD, EDGE_THRESHOLD)
        errs = [float((a - b).abs().max()) for a, b in zip(k, p)]
        max_err = max([max_err] + errs)
        print(f"fast levels ({kind}): max abs err per level {errs}; "
              f"{sum(int((a > 0).sum()) for a in k)} keypoint candidates", flush=True)
    ms = time_ms(lambda: fast.fast_levels(levels, FAST_THRESHOLD, EDGE_THRESHOLD))
    dev_ms = device_ms(lambda: fast.fast_levels(levels, FAST_THRESHOLD, EDGE_THRESHOLD))
    plain_ms = time_ms(lambda: fast.fast_levels_plain(levels, FAST_THRESHOLD,
                                                      EDGE_THRESHOLD))
    if not max_err <= FAST_TOL:
        raise AssertionError(f"fast kernel vs plain max abs {max_err} > {FAST_TOL}")
    px = sum(h * w for h, w in FAST_SHAPES)
    bound = bound_ms(8 * px, FAST_OPS * px)
    print(f"fast vs plain: max abs err {max_err} over {len(FAST_SHAPES)} level shapes x "
          f"2 images; per frame (one launch) kernel {ms:.4f} ms back to back, {dev_ms:.4f} "
          f"ms device (CUDA graph), plain {plain_ms:.4f} ms, bound {bound['bound_ms']:.5f} "
          f"ms ({bound['bound_by']}, {px} px)", flush=True)
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms,
            **bound}


def count_syncs(fn):
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")``: (its
    result, the source lines of the synchronizing calls it made)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [f"{w.filename}:{w.lineno}" for w in caught
                 if "called a synchronizing" in str(w.message)]


def report_syncs(tag: str, where: list, unit: str = "steady frame") -> None:
    names = sorted(set(where))
    print(f"{tag}: {len(where)} synchronizing calls in one {unit} under "
          f"set_sync_debug_mode('warn')" + (f": {names}" if names else ""), flush=True)
    bad = [n for n in names if "affine_warp.py" in n or "ops/fast.py" in n]
    if bad:
        raise AssertionError(f"{tag}: a kernel wrapper synchronized the host: {bad}")


def render_clip(cfg, n_frames: int, seed: int, dev):
    """Shaky footage of the benchmark's recipe rendered on ``dev``:
    (frames (T, H, W, 3) uint8, trajectory)."""
    from video_stabilization_tpu_torch.sim import (
        DEFAULT_APP_PARAMS, make_default_texture, render_frame, shake_trajectory)

    rng = np.random.default_rng(seed)
    tex = torch.from_numpy(make_default_texture(rng, 512)).to(dev)
    traj = shake_trajectory(rng.standard_normal((n_frames, 3)),
                            rng.standard_normal(n_frames), DEFAULT_APP_PARAMS,
                            pos_amplitude=0.004, roll_amplitude=0.3, device=dev)
    frames = torch.stack([render_frame(tex, traj[i], cfg.frame_height, cfg.frame_width)
                          for i in range(n_frames)])
    return frames, traj


def ideal_lock(frames, traj, first: int, stop: int) -> torch.Tensor:
    """Frames ``first..stop-1`` each warped back to frame ``first`` by the
    analytic full-resolution motion (projective gather): the jitter floor of
    a perfect lock on this footage."""
    from video_stabilization_tpu_torch.ops.warp import warp_perspective
    from video_stabilization_tpu_torch.sim import inter_frame_homography

    hf, wf = frames.shape[1], frames.shape[2]
    acc = np.eye(3)
    out = [frames[first]]
    for k in range(first + 1, stop):
        acc = inter_frame_homography(traj[k - 1], traj[k], hf, wf).double().numpy() @ acc
        back = torch.from_numpy(np.linalg.inv(acc).astype(np.float32)).to(frames.device)
        out.append(torch.clamp(torch.round(warp_perspective(frames[k].float(), back)),
                               0, 255).to(torch.uint8))
    return torch.stack(out)


def phase_slice(cfg, n_smooth: int, n_lock: int, seed: int, dev, card: str) -> dict:
    """The main path: Stabilizer.stabilize_frame over rendered footage."""
    from video_stabilization_tpu_torch.config import StabilizationMode
    from video_stabilization_tpu_torch.engine import Stabilizer
    from video_stabilization_tpu_torch.ops import affine_warp as aw
    from video_stabilization_tpu_torch.sim import inter_frame_homography

    frames, traj = render_clip(cfg, n_smooth + n_lock, seed, dev)
    stab = Stabilizer(cfg, StabilizationMode.GLOBAL_SMOOTHING, seed=seed, device=dev)
    hf, wf = cfg.frame_height, cfg.frame_width
    wh, ww = cfg.working_size
    warm = min(8, n_smooth // 2)

    counter = aw.fallback_counter(dev)
    counter.zero_()
    aw.launches = 0
    outs, est = [], []
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    t_host = 0.0
    syncs = []
    for i in range(n_smooth + n_lock):
        if i == n_smooth:
            stab.set_stabilization_mode(StabilizationMode.ACCUMULATED_FULL_LOCK)
        if i == warm:
            torch.cuda.synchronize()
            ev0.record()
            t0 = time.perf_counter()
        if i == warm - 1:      # the last warm-up frame, under the sync check
            out, syncs = count_syncs(lambda: stab.stabilize_frame(frames[i]))
            outs.append(out)
        else:
            outs.append(stab.stabilize_frame(frames[i]))
        est.append(stab.carry.transforms[-1].clone())
        if i == n_smooth - 1:
            ev1.record()
            torch.cuda.synchronize()
            t_host = time.perf_counter() - t0
    launches = aw.launches
    fallbacks = int(counter)          # the one read of the device's count

    for o in outs:
        if o.shape != (hf, wf, 3) or o.dtype != torch.uint8 or o.device != dev:
            raise AssertionError(f"bad output {tuple(o.shape)} {o.dtype} {o.device}")
    n_total = n_smooth + n_lock
    per_frame = LAUNCHES_PER_FRAME["config1"]
    if launches != per_frame * n_total:
        raise AssertionError(f"warp launches {launches} != {per_frame}/frame x {n_total}")
    report_syncs("slice", syncs)

    # inter-frame estimates vs analytic truth (frames 1 .. n_smooth-1)
    hs_est = [h.double().cpu().numpy() for h in est[1:n_smooth]]
    traj = traj.to("cpu")
    hs_true = [inter_frame_homography(traj[i], traj[i + 1], wh, ww).double().numpy()
               for i in range(n_smooth - 1)]
    drift = corner_drift(hs_est, hs_true, ww, wh)

    out_s = torch.stack(outs[:n_smooth])
    out_l = torch.stack(outs[n_smooth:])
    crop = (slice(hf // 4, 3 * hf // 4), slice(wf // 4, 3 * wf // 4))
    delay = cfg.future_frames
    j_raw = jitter(frames[10:n_smooth - delay], crop)
    j_smooth = jitter(out_s[10 + delay:], crop)
    # lock outputs present frames n_smooth-delay .. n_total-1-delay.  The
    # raw reference is the whole presented clip, as in the JAX package's
    # lock test; the same window's raw jitter and an ideal lock (each frame
    # warped back to the anchor by the analytic motion) are printed too.
    j_raw_all = jitter(frames[10:n_total - delay], crop)
    j_raw_lock = jitter(frames[n_smooth - delay:n_total - delay], crop)
    j_lock = jitter(out_l, crop)
    j_ideal = jitter(ideal_lock(frames, traj, n_smooth - delay, n_total - delay), crop)
    steady = n_smooth - warm
    ms_frame = ev0.elapsed_time(ev1) / steady
    print(f"slice: {n_smooth} smoothing + {n_lock} lock frames {hf}x{wf} -> "
          f"working {wh}x{ww}; warp launches {launches} ({per_frame}/frame), "
          f"warps outside the envelope {fallbacks} (device count)", flush=True)
    print(f"slice: inter-frame corner drift {drift:.4f} px (< {DRIFT_TOL}); jitter "
          f"raw {j_raw:.3f} smoothed {j_smooth:.3f} (ratio {j_smooth / j_raw:.3f} < "
          f"{SMOOTH_JITTER}); lock {j_lock:.3f} vs raw clip {j_raw_all:.3f} (ratio "
          f"{j_lock / j_raw_all:.3f} < {LOCK_JITTER}), vs raw window {j_raw_lock:.3f} "
          f"(ratio {j_lock / j_raw_lock:.3f}), ideal lock {j_ideal:.3f} (ratio "
          f"{j_ideal / j_raw_lock:.3f}; lock/ideal {j_lock / j_ideal:.3f} < "
          f"{LOCK_VS_IDEAL})", flush=True)
    print(f"slice: {ms_frame:.3f} ms/frame (CUDA events, {steady} steady smoothing "
          f"frames), host {1e3 * t_host / steady:.3f} ms/frame; {card}", flush=True)
    if not drift < DRIFT_TOL:
        raise AssertionError(f"corner drift {drift} >= {DRIFT_TOL}")
    if not j_smooth < SMOOTH_JITTER * j_raw:
        raise AssertionError(f"smoothing jitter {j_smooth} !< {SMOOTH_JITTER} x {j_raw}")
    if not j_lock < LOCK_JITTER * j_raw_all:
        raise AssertionError(f"lock jitter {j_lock} !< {LOCK_JITTER} x {j_raw_all}")
    if not j_lock < LOCK_VS_IDEAL * j_ideal:
        raise AssertionError(f"lock jitter {j_lock} !< {LOCK_VS_IDEAL} x ideal {j_ideal}")
    return {"launches": launches, "frames": n_total, "ms_frame": ms_frame,
            "syncs": len(syncs), "footage": (frames, traj), "outs": outs}


def phase_lock(cfg, mode, path: str, n_frames: int, seed: int, dev, card: str) -> dict:
    """A registration-lock slice (ORB or SIFT): Stabilizer.stabilize_frame
    in ``mode`` from the first frame, whose presentation frame becomes the
    reference.  ``path`` names its warp count in WARPS_PER_FRAME."""
    from unittest import mock

    from video_stabilization_tpu_torch.config import StabilizationMode
    from video_stabilization_tpu_torch.engine import Stabilizer, lock
    from video_stabilization_tpu_torch.ops import affine_warp as aw
    from video_stabilization_tpu_torch.ops import fast

    tag = {StabilizationMode.ORB_FULL_LOCK: "orb",
           StabilizationMode.SIFT_FULL_LOCK: "sift"}[mode]
    ref_of = f"{tag}_ref"
    jitter_bound = ORB_JITTER if tag == "orb" else SIFT_JITTER
    fast_per_frame = FAST_LAUNCHES_PER_FRAME if tag == "orb" else 0
    frames, traj = render_clip(cfg, n_frames, seed, dev)
    stab = Stabilizer(cfg, mode, seed=seed, device=dev)
    hf, wf = cfg.frame_height, cfg.frame_width
    delay = cfg.future_frames
    warm = 8
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)

    counter = aw.fallback_counter(dev)
    counter.zero_()
    # each lock frame's ECC result, kept on the device and read once after
    # the run (the first frame's ECC runs against the empty reference, the
    # next ``delay`` frames' on the reference frame itself)
    refine = lock.ecc_refine_euclidean
    ecc_runs = []

    def ecc_kept(*a, **kw):
        ecc_runs.append(refine(*a, **kw))
        return ecc_runs[-1]

    fast.launches = 0
    aw.launches = 0
    outs, matches, is_set = [], [], []
    syncs = []
    with mock.patch.object(lock, "ecc_refine_euclidean", ecc_kept):
        for i in range(n_frames):
            if i == warm:
                torch.cuda.synchronize()
                ev0.record()
                t0 = time.perf_counter()
            if i == warm - 1:      # the last warm-up frame, under the sync check
                out, syncs = count_syncs(lambda: stab.stabilize_frame(frames[i]))
                outs.append(out)
            else:
                outs.append(stab.stabilize_frame(frames[i]))
            matches.append(stab.carry.last_lock_matches.clone())
            is_set.append(getattr(stab.carry, ref_of).is_set.clone())
        ev1.record()
        torch.cuda.synchronize()
    t_host = time.perf_counter() - t0
    fast_launches, warp_launches = fast.launches, aw.launches
    fallbacks = int(counter)          # the one read of the device's count
    if cfg.ecc.enabled:
        if len(ecc_runs) != n_frames:
            raise AssertionError(f"{tag}: ECC ran {len(ecc_runs)} times in {n_frames} frames")
        registered_ecc = ecc_runs[delay + 1:]
        n_ecc_valid = int(torch.stack([r.valid for r in registered_ecc]).sum())
        n_ecc_improved = int(torch.stack([r.valid & (r.rho > r.rho_init)
                                          for r in registered_ecc]).sum())

    for o in outs:
        if o.shape != (hf, wf, 3) or o.dtype != torch.uint8 or o.device != dev:
            raise AssertionError(f"bad output {tuple(o.shape)} {o.dtype} {o.device}")
    if fast_launches != fast_per_frame * n_frames:
        raise AssertionError(f"{tag}: fast launches {fast_launches} != "
                             f"{fast_per_frame} x {n_frames}")
    per_frame = LAUNCHES_PER_FRAME[path]
    if warp_launches != per_frame * n_frames:
        raise AssertionError(f"{tag}: warp launches {warp_launches} != "
                             f"{per_frame} x {n_frames}")
    report_syncs(tag, syncs)
    if not bool(is_set[0]):
        raise AssertionError(f"no {tag} reference captured on the first frame")
    if not all(bool(x) for x in is_set):
        raise AssertionError(f"the {tag} reference was lost")
    # frames that register a new presentation frame against the reference
    # (before that the presented frame is the reference itself)
    registered = [int(m) for m in matches[delay + 1:]]
    min_points = cfg.ransac.min_points
    matched = sum(m >= min_points for m in registered) / len(registered)

    # outputs delay+1.. present frames 1..; the reference is frame 0
    crop = (slice(hf // 4, 3 * hf // 4), slice(wf // 4, 3 * wf // 4))
    stop = n_frames - delay
    j_raw = jitter(frames[1:stop], crop)
    j_lock = jitter(torch.stack(outs[delay + 1:]), crop)
    j_ideal = jitter(ideal_lock(frames, traj.to("cpu"), 0, stop)[1:], crop)
    steady = n_frames - warm
    ms_frame = ev0.elapsed_time(ev1) / steady
    print(f"{tag}: {n_frames} {mode.name} frames {hf}x{wf} -> working "
          f"{cfg.working_size[0]}x{cfg.working_size[1]}; fast launches {fast_launches} "
          f"({fast_per_frame}/frame), warp launches {warp_launches} ({per_frame}/frame), "
          f"warps outside the envelope {fallbacks} (device count)", flush=True)
    print(f"{tag}: lock matches min {min(registered)} median "
          f"{statistics.median(registered)} max {max(registered)}; >= {min_points} on "
          f"{matched:.3f} of {len(registered)} registered frames (>= {ORB_MATCHED})",
          flush=True)
    print(f"{tag}: jitter raw {j_raw:.3f} locked {j_lock:.3f} (ratio {j_lock / j_raw:.3f} "
          f"< {jitter_bound}), ideal lock {j_ideal:.3f} (ratio {j_ideal / j_raw:.3f}; "
          f"lock/ideal {j_lock / j_ideal:.3f} <= {LOCK_VS_IDEAL})", flush=True)
    if cfg.ecc.enabled:
        n_reg = len(registered_ecc)
        print(f"{tag}: ECC ({cfg.ecc.max_iters} iterations) valid on {n_ecc_valid} of "
              f"{n_reg} registered frames ({n_ecc_valid / n_reg:.3f}); rho raised above "
              f"its start on {n_ecc_improved} ({n_ecc_improved / n_reg:.3f} >= "
              f"{ECC_IMPROVED})", flush=True)
    print(f"{tag}: {ms_frame:.3f} ms/frame (CUDA events, {steady} steady frames), host "
          f"{1e3 * t_host / steady:.3f} ms/frame; {card}", flush=True)
    if not matched >= ORB_MATCHED:
        raise AssertionError(f"{tag}: lock matches >= {min_points} on only {matched:.3f}")
    if not j_lock < jitter_bound * j_raw:
        raise AssertionError(f"{tag} lock jitter {j_lock} !< {jitter_bound} x {j_raw}")
    if not j_lock <= LOCK_VS_IDEAL * j_ideal:
        raise AssertionError(f"{tag} lock jitter {j_lock} !<= {LOCK_VS_IDEAL} x ideal "
                             f"{j_ideal}")
    if cfg.ecc.enabled and not n_ecc_improved >= ECC_IMPROVED * n_reg:
        raise AssertionError(f"{tag}: ECC raised rho on only {n_ecc_improved} of "
                             f"{n_reg} registered frames")
    return {"fast_launches": fast_launches, "warp_launches": warp_launches,
            "frames": n_frames, "ms_frame": ms_frame, "syncs": len(syncs),
            "footage": (frames, traj.to("cpu")), "outs": outs}


def phase_ecc_kernel_vs_plain(cfg, seed: int, dev) -> None:
    """ECC on the card with the warp kernel against ECC on the card with the
    plain warp, on one real frame pair (frames 0 and 8 of the slice's
    footage, preprocessed as the lock does) at the working size: equal
    ``h``, ``rho`` and ``valid`` (the kernel equals its plain version bit for
    bit, so any difference is a fault of the ECC port).  The camera moved
    between the two frames, so ECC from the identity must also do work: a
    valid result, rho raised above its start, and a rotation or shift of
    more than ``ecc.epsilon``."""
    from unittest import mock

    from video_stabilization_tpu_torch.engine.lock import _preprocessed
    from video_stabilization_tpu_torch.ops import affine_warp as aw
    from video_stabilization_tpu_torch.ops import ecc as ecc_mod

    wh, ww = cfg.working_size
    frames, _ = render_clip(cfg, 9, seed, dev)
    ref, cur = (_preprocessed(frames[i].float(), cfg)[0] for i in (0, 8))
    eye = torch.eye(3, device=dev)

    def run():
        return ecc_mod.ecc_refine_euclidean(ref, cur, eye, max_iters=cfg.ecc.max_iters,
                                            eps=cfg.ecc.epsilon)

    launches = aw.launches
    k = run()
    if aw.launches - launches != cfg.ecc.max_iters + 2:
        raise AssertionError(f"ECC launched the warp kernel {aw.launches - launches} "
                             f"times, not {cfg.ecc.max_iters + 2}")
    ms = time_ms(run, reps=5, inner=2, warmup=1)
    with mock.patch.object(ecc_mod, "warp_affine", aw.warp_affine_plain):
        p = run()
        plain_ms = time_ms(run, reps=5, inner=2, warmup=1)
    same = (torch.equal(k.h, p.h) and torch.equal(k.rho, p.rho)
            and torch.equal(k.valid, p.valid))
    theta, tx, ty = (float(v) for v in (torch.atan2(k.h[1, 0], k.h[0, 0]), k.h[0, 2],
                                        k.h[1, 2]))
    moved = max(abs(theta), abs(tx), abs(ty))
    print(f"ecc: kernel vs plain warp on frames 0 and 8 ({wh}x{ww}, {cfg.ecc.max_iters} "
          f"iterations from the identity): equal {same}; rho {float(k.rho_init):.6f} -> "
          f"{float(k.rho):.6f}, valid {bool(k.valid)}, theta {theta:.6f} rad, t "
          f"({tx:.4f}, {ty:.4f}) px; {ms:.3f} ms per call with the kernel, "
          f"{plain_ms:.3f} ms with the plain warp (back to back)", flush=True)
    if not same:
        raise AssertionError(f"ECC with the kernel != ECC with the plain warp: h "
                             f"{k.h.tolist()} vs {p.h.tolist()}, rho {float(k.rho)} vs "
                             f"{float(p.rho)}, valid {bool(k.valid)} vs {bool(p.valid)}")
    if not (bool(k.valid) and float(k.rho) > float(k.rho_init) and moved > cfg.ecc.epsilon):
        raise AssertionError(f"ECC did no work on frames 0 and 8: valid {bool(k.valid)}, rho "
                             f"{float(k.rho_init)} -> {float(k.rho)}, largest parameter "
                             f"{moved} (eps {cfg.ecc.epsilon})")


def phase_reference(seed: int, dev) -> None:
    """A small clip through the step on the card and on the CPU, in
    GLOBAL_SMOOTHING, in ORB_FULL_LOCK and in SIFT_FULL_LOCK with ECC."""
    import dataclasses

    from video_stabilization_tpu_torch.config import (
        ECCConfig, GFTTConfig, ORBConfig, RansacConfig, SIFTConfig, StabilizationMode,
        StabilizerConfig)
    from video_stabilization_tpu_torch.engine import Stabilizer

    # the ORB and SIFT settings of tests/test_engine.py's small config: a
    # 120 px working image needs a lower FAST threshold and looser size
    # filters
    cfg = StabilizerConfig(past_frames=6, future_frames=4, working_height=120,
                           frame_height=240, frame_width=320,
                           gftt=GFTTConfig(max_features=256),
                           ransac=RansacConfig(num_hypotheses=128),
                           orb=ORBConfig(max_features=512, n_levels=4,
                                         max_keypoint_size_ratio=0.5, fast_threshold=8),
                           sift=SIFTConfig(max_features=256, max_keypoint_size_ratio=0.5))
    cfg_ecc = dataclasses.replace(cfg, ecc=ECCConfig(enabled=True, max_iters=5))
    frames, _ = render_clip(cfg, 16, seed, dev)
    wh, ww = cfg.working_size
    for mode, c, n in ((StabilizationMode.GLOBAL_SMOOTHING, cfg, 12),
                       (StabilizationMode.ORB_FULL_LOCK, cfg, 16),
                       (StabilizationMode.SIFT_FULL_LOCK, cfg_ecc, 16)):
        a = Stabilizer(c, mode, seed=seed, device=dev)
        b = Stabilizer(c, mode, seed=seed, device="cpu")
        worst_drift = worst_mean = 0.0
        worst_matches = 0
        for f in frames[:n]:
            oa = a.stabilize_frame(f).cpu()
            ob = b.stabilize_frame(f.cpu())
            worst_drift = max(worst_drift, corner_drift(
                [a.carry.last_h.double().cpu().numpy()], [b.carry.last_h.double().numpy()],
                ww, wh, skip=0))
            worst_mean = max(worst_mean, float((oa.float() - ob.float()).abs().mean()))
            worst_matches = max(worst_matches, abs(int(a.carry.last_lock_matches)
                                                   - int(b.carry.last_lock_matches)))
            for ref_of in ("orb_ref", "sift_ref"):
                if (bool(getattr(a.carry, ref_of).is_set)
                        != bool(getattr(b.carry, ref_of).is_set)):
                    raise AssertionError(f"{mode.name}: card and CPU disagree on the "
                                         f"{ref_of}")
        ecc = f", ECC {c.ecc.max_iters} iterations" if c.ecc.enabled else ""
        print(f"reference {mode.name}{ecc}: {n} frames 240x320 card vs CPU: worst last_h "
              f"drift {worst_drift:.2e} px (< {REF_DRIFT_TOL}), worst mean |out| "
              f"{worst_mean:.3f} (<= {REF_MEAN_U8}), worst |lock matches| "
              f"{worst_matches} (<= {REF_MATCHES})", flush=True)
        if not (worst_drift < REF_DRIFT_TOL and worst_mean <= REF_MEAN_U8
                and worst_matches <= REF_MATCHES):
            raise AssertionError(f"{mode.name}: card and CPU disagree on the small clip")


def device_events(fn) -> int:
    """Device events (kernels, copies, fills) that ``fn`` launches, counted
    by ``torch.profiler``."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def phase_offline(cfg, mode, path: str, n_frames: int, seed: int, dev, card: str,
                  stream: dict, depth_cut: str = "") -> dict:
    """The offline chunk step (``engine/offline.py``) in OFFLINE_CHUNK-frame
    chunks over the first ``n_frames`` frames of a streaming slice's footage
    (``stream``, the slice's result), from a fresh carry with the slice's
    seed: launches per chunk, host syncs of the warm-up chunk, outputs
    against the slice's frame by frame, the slice's quality bounds, ms/frame
    and device events per frame beside the streaming step's.  ``depth_cut``
    says why ``n_frames`` is fewer than the slice's, if it is."""
    import dataclasses
    from unittest import mock

    from video_stabilization_tpu_torch.config import StabilizationMode
    from video_stabilization_tpu_torch.engine import (
        Stabilizer, init_carry, make_offline_fn, offline)
    from video_stabilization_tpu_torch.ops import affine_warp as aw
    from video_stabilization_tpu_torch.ops import fast
    from video_stabilization_tpu_torch.sim import inter_frame_homography
    from video_stabilization_tpu_torch.utils import prng

    k = OFFLINE_CHUNK
    tag = f"offline {path}"
    if n_frames < 2 * k:
        raise ValueError(f"{tag}: {n_frames} frames are fewer than two chunks of {k}")
    all_frames, traj = stream["footage"]
    frames = all_frames[:n_frames]
    hf, wf = cfg.frame_height, cfg.frame_width
    wh, ww = cfg.working_size
    delay = cfg.future_frames
    locked = mode in (StabilizationMode.ORB_FULL_LOCK, StabilizationMode.SIFT_FULL_LOCK)
    warp_per_frame = LAUNCHES_PER_FRAME[path]
    # LK and the output warp once per chunk, ECC per frame
    ecc_per_frame = warp_per_frame - BATCHED_LAUNCHES
    fast_per_frame = (FAST_LAUNCHES_PER_FRAME if mode == StabilizationMode.ORB_FULL_LOCK
                      else 0)
    cfg_off = dataclasses.replace(cfg, static_mode=int(mode))
    step = make_offline_fn(cfg_off)
    carry = init_carry(cfg_off, int(mode), prng.key(seed), dev)

    # each frame's lock matches, kept on the device and read once after
    register = offline._registration_lock
    matches = []

    def register_kept(*a, **kw):
        res = register(*a, **kw)
        matches.append(res.n_matches)
        return res

    counter = aw.fallback_counter(dev)
    # one event at each boundary from the end of the warm-up chunk on
    events = []
    outs, est, per_chunk = [], [], []
    counter.zero_()
    aw.launches = 0
    fast.launches = 0
    with mock.patch.object(offline, "_registration_lock", register_kept):
        for c, i in enumerate(range(0, n_frames, k)):
            part = frames[i:i + k]
            w0, f0 = aw.launches, fast.launches
            if c == 0:     # the warm-up chunk, untimed: syncs checked
                (carry, (out, _)), syncs = count_syncs(lambda: step(carry, part))
                torch.cuda.synchronize()
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
                t0 = time.perf_counter()
            else:
                carry, (out, _) = step(carry, part)
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            outs.append(out)
            est.append(carry.transforms[-len(part):].clone())
            per_chunk.append((len(part), aw.launches - w0, fast.launches - f0))
        torch.cuda.synchronize()
    t_host = time.perf_counter() - t0
    warp_launches, fast_launches = aw.launches, fast.launches
    fallbacks = int(counter)          # the one read of the device's count

    out_o = torch.cat(outs)
    if out_o.shape != (n_frames, hf, wf, 3) or out_o.dtype != torch.uint8:
        raise AssertionError(f"{tag}: bad outputs {tuple(out_o.shape)} {out_o.dtype}")
    for size, n_warp, n_fast in per_chunk:
        want = BATCHED_LAUNCHES + size * ecc_per_frame
        if (n_warp, n_fast) != (want, size * fast_per_frame):
            raise AssertionError(f"{tag}: a chunk of {size} launched the warp {n_warp} and "
                                 f"FAST {n_fast} times, not {BATCHED_LAUNCHES} + {size} x "
                                 f"{ecc_per_frame} and {size} x {fast_per_frame}")
    report_syncs(tag, syncs, "chunk (the warm-up one, untimed)")

    # outputs against the streaming step's, frame by frame
    out_s = torch.stack(stream["outs"][:n_frames])
    diff = (out_o.to(torch.int16) - out_s.to(torch.int16)).abs()
    differ = float((diff > 0).float().mean((1, 2, 3)).max())
    off_more = float((diff > 1).float().mean((1, 2, 3)).max())

    crop = (slice(hf // 4, 3 * hf // 4), slice(wf // 4, 3 * wf // 4))
    if locked:
        registered = [int(m) for m in matches[delay + 1:]]
        min_points = cfg.ransac.min_points
        matched = sum(m >= min_points for m in registered) / len(registered)
        stop = n_frames - delay
        bound = ORB_JITTER if mode == StabilizationMode.ORB_FULL_LOCK else SIFT_JITTER
        j_raw = jitter(frames[1:stop], crop)
        j_lock = jitter(out_o[delay + 1:], crop)
        j_ideal = jitter(ideal_lock(frames, traj, 0, stop)[1:], crop)
        quality = (f"lock matches min {min(registered)} median "
                   f"{statistics.median(registered)}; >= {min_points} on {matched:.3f} of "
                   f"{len(registered)} registered frames (>= {ORB_MATCHED}); jitter raw "
                   f"{j_raw:.3f} locked {j_lock:.3f} (ratio {j_lock / j_raw:.3f} < {bound}), "
                   f"lock/ideal {j_lock / j_ideal:.3f} (<= {LOCK_VS_IDEAL})")
        good = (matched >= ORB_MATCHED and j_lock < bound * j_raw
                and j_lock <= LOCK_VS_IDEAL * j_ideal)
    else:
        hs_est = [h.double().cpu().numpy() for h in torch.cat(est)[1:]]
        hs_true = [inter_frame_homography(traj[i], traj[i + 1], wh, ww).double().numpy()
                   for i in range(n_frames - 1)]
        drift = corner_drift(hs_est, hs_true, ww, wh)
        j_raw = jitter(frames[10:n_frames - delay], crop)
        j_smooth = jitter(out_o[10 + delay:], crop)
        quality = (f"inter-frame corner drift {drift:.4f} px (< {DRIFT_TOL}); jitter raw "
                   f"{j_raw:.3f} smoothed {j_smooth:.3f} (ratio {j_smooth / j_raw:.3f} < "
                   f"{SMOOTH_JITTER})")
        good = drift < DRIFT_TOL and j_smooth < SMOOTH_JITTER * j_raw

    # device events per frame: one more chunk (the last one fed again: the
    # launches do not depend on the content), and the streaming step over a
    # few frames after two of warm-up
    state = {"carry": carry}

    def one_chunk():
        state["carry"], _ = step(state["carry"], frames[-k:])

    ev_offline = device_events(one_chunk) / k
    stab = Stabilizer(cfg, mode, seed=seed, device=dev)
    for f in frames[:2]:
        stab.stabilize_frame(f)
    ev_stream = device_events(lambda: [stab.stabilize_frame(f) for f in
                                       frames[2:2 + STREAM_PROFILED]]) / STREAM_PROFILED

    steady = n_frames - per_chunk[0][0]
    ms_frame = events[0].elapsed_time(events[-1]) / steady
    ms_chunks = [a.elapsed_time(b) / size
                 for a, b, (size, _, _) in zip(events, events[1:], per_chunk[1:])]
    print(f"{tag}: {n_frames} {mode.name} frames {hf}x{wf} in chunks of {k}{depth_cut}; warp "
          f"launches {warp_launches} ({BATCHED_LAUNCHES} + {ecc_per_frame}/frame = "
          f"{BATCHED_LAUNCHES + k * ecc_per_frame}/chunk), fast launches {fast_launches} ({fast_per_frame}/frame), warps outside the "
          f"envelope {fallbacks} (device count)", flush=True)
    print(f"{tag}: vs the streaming step's outputs: per frame at most {differ:.5f} of pixels "
          f"differ (<= {OFFLINE_DIFFER}), {off_more:.6f} by more than one level (<= "
          f"{OFFLINE_OFF_BY_MORE})", flush=True)
    print(f"{tag}: {quality}", flush=True)
    print(f"{tag}: {ms_frame:.3f} ms/frame (CUDA events, {steady} frames in the chunks after "
          f"the warm-up one; per chunk {[round(t, 3) for t in ms_chunks]}), host "
          f"{1e3 * t_host / steady:.3f} ms/frame; streaming {stream['ms_frame']:.3f} "
          f"ms/frame; device events per frame {ev_offline:.0f} offline (one chunk) vs "
          f"{ev_stream:.0f} streaming ({STREAM_PROFILED} frames), torch.profiler; {card}",
          flush=True)
    if not (differ <= OFFLINE_DIFFER and off_more <= OFFLINE_OFF_BY_MORE):
        raise AssertionError(f"{tag}: outputs differ from the streaming step's: {differ} of "
                             f"pixels, {off_more} by more than one level")
    if not good:
        raise AssertionError(f"{tag}: outside the streaming slice's bounds: {quality}")
    return {"launches": warp_launches, "fast_launches": fast_launches, "frames": n_frames,
            "ms_frame": ms_frame, "syncs": len(syncs), "events_per_frame": ev_offline,
            "stream_events_per_frame": ev_stream}


def batch_rounding(cfg, frames: torch.Tensor, keys: torch.Tensor, dev) -> str:
    """Where a batch of the streams rounds differently from each stream
    alone (a batch of one) on the same inputs, on the first two frames of
    every stream: dense LK's points, the RANSAC fit, and the ops inside them
    whose summation order may follow the batch's shape: the box filter's
    band product (cuBLAS), and the weighted similarity fit of RANSAC's
    refinement with its sums over the points (CUDA reductions).  Returns the
    line to print."""
    import dataclasses

    from video_stabilization_tpu_torch.engine.offline import _fit_inter_frame, frame_keys
    from video_stabilization_tpu_torch.motion.similarity import fit_similarity_masked
    from video_stabilization_tpu_torch.ops.gftt import good_features_to_track
    from video_stabilization_tpu_torch.ops.image import bgr_to_gray, resize_bilinear
    from video_stabilization_tpu_torch.ops.lk import lk_track
    from video_stabilization_tpu_torch.ops.lk_dense import _band, _bf16
    from video_stabilization_tpu_torch.ops.pyramid import build_pyramid

    s_n = frames.shape[0]
    wh, ww = cfg.working_size
    lk = dataclasses.replace(cfg.lk, warp_fallback=False)
    center = torch.tensor([ww / 2.0, wh / 2.0], device=dev)
    pyr0, pyr1 = (build_pyramid(bgr_to_gray(resize_bilinear(frames[:, t].float(), wh, ww)),
                                lk.pyramid_levels) for t in (0, 1))
    corners = good_features_to_track(pyr0[0], cfg.gftt)
    k_ransac, _ = frame_keys(keys, torch.ones(s_n, dtype=torch.int32, device=dev))
    band = _band(wh, lk.window_size, dev)
    square = _bf16(torch.square(pyr1[0] - pyr0[0]))

    def track(i):
        return lk_track([p[i] for p in pyr0], [p[i] for p in pyr1], corners.points[i],
                        corners.mask[i], lk)

    tracked = track(slice(None))
    weight = tracked.status.float()
    ops = {
        "LK points": lambda i: track(i).points,
        "RANSAC h": lambda i: _fit_inter_frame(corners.points[i], tracked.points[i],
                                               tracked.status[i], k_ransac[i], cfg,
                                               center)[0].h,
        "band product": lambda i: torch.matmul(band, square[i]),
        "similarity fit": lambda i: fit_similarity_masked(corners.points[i], tracked.points[i],
                                                          weight[i])[0],
        "centroid sums": lambda i: (weight[i][..., None] * tracked.points[i]).sum(-2),
        "weighted sums": lambda i: (weight[i] * torch.square(tracked.points[i]).sum(-1)).sum(-1),
    }
    parts = []
    for name, fn in ops.items():
        whole = fn(slice(None))
        alone = torch.cat([fn(slice(s, s + 1)) for s in range(s_n)])
        parts.append(f"{name} {int((whole != alone).sum())} of {whole.numel()} "
                     f"(max abs {float((whole - alone).abs().max()):.3g})")
    return (f"config5: a batch of {s_n} streams against each stream alone on the same "
            "inputs, entries that differ: " + ", ".join(parts))


def against_single(outs: torch.Tensor, single: torch.Tensor):
    """Per frame of every stream, the share of pixels where the batched
    outputs (S, T, H, W, C) differ from the single-stream ones, and the
    share off by more than one level: the largest of each."""
    diff = (outs.to(torch.int16) - single.to(torch.int16)).abs()
    return (float((diff > 0).float().mean((2, 3, 4)).max()),
            float((diff > 1).float().mean((2, 3, 4)).max()))


def phase_streams(cfg, seed: int, dev, card: str) -> dict:
    """Bench config 5 through the batched forms, in TRANSLATION_LOCK and in
    GLOBAL_SMOOTHING: the batched step frame by frame and the stream-batched
    offline chunk in chunks of STREAM_CHUNK, each from a fresh carry of
    N_STREAMS streams (``init_batched_carry`` with the seed), against each
    stream's own single-stream run (``Stabilizer.stabilize_frame`` from the
    same stream key).  Returns per form the warp launches and batched
    frames of both modes' runs, ms per batched frame and device events."""
    import dataclasses

    from video_stabilization_tpu_torch.config import StabilizationMode
    from video_stabilization_tpu_torch.engine import (
        Stabilizer, init_carry, make_offline_batched_fn)
    from video_stabilization_tpu_torch.ops import affine_warp as aw
    from video_stabilization_tpu_torch.parallel import init_batched_carry, make_batched_step_fn
    from video_stabilization_tpu_torch.utils import prng, stage_profile

    n_frames = STREAM_FRAMES
    torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev)
    frames = stage_profile.footage(cfg, n_frames, seed, dev, streams=N_STREAMS)
    hf, wf = cfg.frame_height, cfg.frame_width
    keys = prng.split(prng.key(seed), N_STREAMS)
    print(batch_rounding(cfg, frames, keys.to(dev), dev), flush=True)
    counter = aw.fallback_counter(dev)
    warm = 4
    result = {"step": {"launches": 0, "frames": 0}, "offline": {"launches": 0, "frames": 0}}
    for mode in (StabilizationMode.TRANSLATION_LOCK, StabilizationMode.GLOBAL_SMOOTHING):
        cfg_m = dataclasses.replace(cfg, static_mode=int(mode))
        tag = f"config5 {mode.name}"

        # each stream on its own, from its stream key
        single = []
        for s in range(N_STREAMS):
            stab = Stabilizer(cfg, mode, seed=seed, device=dev)
            stab.carry = init_carry(cfg, int(mode), keys[s], dev)
            single.append(torch.stack([stab.stabilize_frame(f) for f in frames[s]]))
        single = torch.stack(single)

        # the batched step: warm-up steps untimed, the last under the sync check
        step = make_batched_step_fn(cfg_m)
        carry = init_batched_carry(cfg_m, N_STREAMS, int(mode), prng.key(seed), dev)
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        outs, per_step = [], []
        counter.zero_()
        aw.launches = 0
        for t in range(n_frames):
            before = aw.launches
            if t == warm - 1:
                (carry, (out, _)), syncs = count_syncs(lambda: step(carry, frames[:, t]))
                torch.cuda.synchronize()
                ev0.record()
            else:
                carry, (out, _) = step(carry, frames[:, t])
            per_step.append(aw.launches - before)
            outs.append(out)
        ev1.record()
        torch.cuda.synchronize()
        step_launches = aw.launches
        step_fallbacks = int(counter)      # the one read of the device's count
        ms_step = ev0.elapsed_time(ev1) / (n_frames - warm)
        step_differ = against_single(torch.stack(outs, 1), single)
        del outs
        ev_step = device_events(lambda: step(carry, frames[:, -1]))

        # the stream-batched chunk: the first chunk untimed, under the sync check
        chunk_fn = make_offline_batched_fn(cfg_m)
        carry = init_batched_carry(cfg_m, N_STREAMS, int(mode), prng.key(seed), dev)
        events, outs, per_chunk = [], [], []
        counter.zero_()
        aw.launches = 0
        for c, i in enumerate(range(0, n_frames, STREAM_CHUNK)):
            part = frames[:, i:i + STREAM_CHUNK]
            before = aw.launches
            if c == 0:
                (carry, (out, _)), chunk_syncs = count_syncs(lambda: chunk_fn(carry, part))
                torch.cuda.synchronize()
            else:
                carry, (out, _) = chunk_fn(carry, part)
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
            per_chunk.append(aw.launches - before)
            outs.append(out)
        torch.cuda.synchronize()
        chunk_launches = aw.launches
        chunk_fallbacks = int(counter)     # the one read of the device's count
        ms_chunk = events[0].elapsed_time(events[-1]) / (n_frames - STREAM_CHUNK)
        chunk_differ = against_single(torch.cat(outs, 1), single)
        del outs
        ev_chunk = device_events(lambda: chunk_fn(carry, frames[:, -STREAM_CHUNK:])) / STREAM_CHUNK

        # stream 0 alone (a batch of one) through the batched step
        carry = dataclasses.replace(init_batched_carry(cfg_m, 1, int(mode), prng.key(seed), dev),
                                    key=keys[:1].to(dev))
        alone = []
        for t in range(n_frames):
            carry, (out, _) = step(carry, frames[:1, t])
            alone.append(torch.equal(out[0], single[0, t]))

        # one stream's streaming step, for device events per frame
        stab = Stabilizer(cfg, mode, seed=seed, device=dev)
        for f in frames[0, :2]:
            stab.stabilize_frame(f)
        ev_single = device_events(lambda: [stab.stabilize_frame(f) for f in
                                           frames[0, 2:2 + STREAM_PROFILED]]) / STREAM_PROFILED
        del single, stab, carry

        print(f"{tag}: {N_STREAMS} streams x {n_frames} frames {hf}x{wf}; batched step warp "
              f"launches {step_launches} (per step {sorted(set(per_step))}), offline chunks of "
              f"{STREAM_CHUNK} {chunk_launches} (per chunk {per_chunk}); warps outside the "
              f"envelope {step_fallbacks} and {chunk_fallbacks} (device count)", flush=True)
        report_syncs(f"{tag} batched step", syncs, "step (the last warm-up one, untimed)")
        report_syncs(f"{tag} offline", chunk_syncs, "chunk (the warm-up one, untimed)")
        print(f"{tag}: vs each stream's single-stream run, per frame at most: batched step "
              f"{step_differ[0]:.5f} of pixels differ, {step_differ[1]:.6f} by more than one "
              f"level; offline {chunk_differ[0]:.5f}, {chunk_differ[1]:.6f} (<= "
              f"{OFFLINE_DIFFER}, {OFFLINE_OFF_BY_MORE}); stream 0 alone through the "
              f"batched step equals its run in {sum(alone)} of {n_frames} frames", flush=True)
        print(f"{tag}: batched step {ms_step:.3f} ms per batched frame ({n_frames - warm} "
              f"steady steps), {N_STREAMS * 1e3 / ms_step:.1f} frames/s in all, "
              f"{1e3 / ms_step:.2f} per stream; offline {ms_chunk:.3f} ms per batched frame "
              f"({n_frames - STREAM_CHUNK} frames in the chunks after the warm-up one), "
              f"{N_STREAMS * 1e3 / ms_chunk:.1f} frames/s in all, {1e3 / ms_chunk:.2f} per "
              f"stream (CUDA events); device events per batched frame {ev_step:.0f} step, "
              f"{ev_chunk:.0f} offline vs {N_STREAMS} x {ev_single:.0f} = "
              f"{N_STREAMS * ev_single:.0f} single-stream, torch.profiler; {card}", flush=True)
        if syncs or chunk_syncs:
            raise AssertionError(f"{tag}: the batched forms synchronized the host")
        if set(per_step) != {BATCHED_LAUNCHES} or set(per_chunk) != {BATCHED_LAUNCHES}:
            raise AssertionError(f"{tag}: warp launches per step {per_step}, per chunk "
                                 f"{per_chunk}, not {BATCHED_LAUNCHES} each")
        for name, (differ, off_more) in (("batched step", step_differ),
                                         ("offline", chunk_differ)):
            if not (differ <= OFFLINE_DIFFER and off_more <= OFFLINE_OFF_BY_MORE):
                raise AssertionError(f"{tag}: {name} outputs differ from the single-stream "
                                     f"runs: {differ} of pixels, {off_more} by more than one "
                                     "level")
        if not all(alone):
            raise AssertionError(f"{tag}: stream 0 alone through the batched step differs from "
                                 f"its single-stream run in frames "
                                 f"{[t for t, same in enumerate(alone) if not same]}")
        result["step"]["launches"] += step_launches
        result["step"]["frames"] += n_frames
        result["offline"]["launches"] += chunk_launches
        result["offline"]["frames"] += n_frames
        result[mode.name] = {"ms_step": ms_step, "ms_offline": ms_chunk,
                             "events_step": ev_step, "events_offline": ev_chunk,
                             "events_single": ev_single,
                             "syncs": len(syncs) + len(chunk_syncs)}
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"config5: peak device memory {peak / 2 ** 30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated, {mem0 / 2 ** 30:.2f} GiB of it allocated before "
          f"the phase); {card}", flush=True)
    return result


def smoke_mesh() -> list:
    """Phase 13's mesh: with two or more cards the slots
    ``serve.pick_serving_devices`` takes for the N_STREAMS streams, one per
    card; with one card two slots on it (the sharded forms' check on one
    card: each slot's work queues on the card's one stream)."""
    from video_stabilization_tpu_torch.serve import pick_serving_devices

    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if len(cards) >= 2:
        return pick_serving_devices(cards, N_STREAMS)
    return [cards[0], cards[0]]


def sharded_paths(n_slots: int) -> dict:
    """The warp's batches on the sharded paths, as BATCHED_PATHS: each slot
    launches its N_STREAMS / n_slots streams' warps, so a batched frame of
    the N_STREAMS streams takes n_slots launches of each shape."""
    per = N_STREAMS // n_slots
    return {"sharded_config5": (per, 1 / n_slots, WARPS_PER_FRAME["config1"]),
            "offline_sharded_config5": (per * STREAM_CHUNK, STREAM_CHUNK / n_slots,
                                        WARPS_PER_FRAME["config1"])}


def sync_all(devices) -> None:
    for d in set(devices):
        torch.cuda.synchronize(d)


def device_split(prof) -> dict:
    """Per card index of a profiled run: device busy ms (kernels, copies,
    fills) and the count of each kind of copy, by the profiler's name
    ("Memcpy HtoD (Pinned -> Device)", "Memcpy PtoP (Device -> Device)",
    ...)."""
    from video_stabilization_tpu_torch.utils.stage_profile import _device_us

    out: dict = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        card = out.setdefault(e.device_index, {"busy_ms": 0.0, "copies": {}})
        card["busy_ms"] += _device_us(e) / 1e3
        if e.name.startswith("Memcpy"):
            card["copies"][e.name] = card["copies"].get(e.name, 0) + 1
    return out


def copies_of(split: dict, kind: str) -> int:
    """Copies of a profiled run whose name holds ``kind`` ("PtoP",
    "Pageable", ...), on every card."""
    return sum(n for sp in split.values() for name, n in sp["copies"].items() if kind in name)


def profiled(fn, devices):
    """(fn's result, per-card device split, wall ms) of one profiled call."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    sync_all(devices)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync_all(devices)
        wall = 1e3 * (time.perf_counter() - t0)
    return out, device_split(prof), wall


def misplaced(carry, mesh) -> int:
    """Carry tensors that are not on their slot's device (metadata only)."""
    from video_stabilization_tpu_torch.engine import map_carry

    parts = carry.parts if len(mesh) > 1 else (carry,)
    bad = []
    for part, dev in zip(parts, mesh):
        map_carry(lambda x: bad.append(x.device != dev), part)
    return sum(bad)


def phase_sharded(cfg, seed: int, mesh: list, card: str) -> dict:
    """Phase 13: bench config 5 (N_STREAMS streams of 1080x1920, the seeds
    of phase 9) through the sharded step and the sharded offline chunk over
    ``mesh``, in TRANSLATION_LOCK and in GLOBAL_SMOOTHING, SHARDED_FRAMES
    frames.  Each slot's streams are rendered once and copied to its card
    before the runs.  Checks each slot's outputs bit for bit against its
    own sub-batch through the one-device batched form on its card, every
    stream against the one-device run of all N_STREAMS (phase 9's bound),
    0 host syncs in a warm-up call, every carry tensor on its slot's device
    after every call, BATCHED_LAUNCHES warp launches per slot per call, and
    no peer-to-peer copy in a profiled call.  Prints ms per batched frame
    over the mesh and on one card (host clock between synchronizations of
    every card), busy ms and idle share per card, and peak memory per
    card."""
    import dataclasses

    from video_stabilization_tpu_torch.config import StabilizationMode
    from video_stabilization_tpu_torch.engine import make_offline_batched_fn
    from video_stabilization_tpu_torch.ops import affine_warp as aw
    from video_stabilization_tpu_torch.parallel import (
        Sharded, init_batched_carry, init_sharded_carry, make_batched_step_fn,
        make_sharded_offline_fn, make_sharded_step_fn, unshard)
    from video_stabilization_tpu_torch.utils import prng, stage_profile

    n_slots, per = len(mesh), N_STREAMS // len(mesh)
    cards = sorted(set(mesh), key=lambda d: d.index)
    dev0, n_frames = mesh[0], SHARDED_FRAMES
    frames = stage_profile.footage(cfg, n_frames, seed, dev0, streams=N_STREAMS)
    parts = [frames[d * per:(d + 1) * per].to(dv) for d, dv in enumerate(mesh)]
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    mesh_name = ", ".join(map(str, mesh))
    result = {"step": {"launches": 0, "frames": 0}, "offline": {"launches": 0, "frames": 0}}
    for mode in (StabilizationMode.TRANSLATION_LOCK, StabilizationMode.GLOBAL_SMOOTHING):
        cfg_m = dataclasses.replace(cfg, static_mode=int(mode))
        forms = {"step": (make_sharded_step_fn(cfg_m, mesh), make_batched_step_fn(cfg_m), 1, 4),
                 "offline": (make_sharded_offline_fn(cfg_m, mesh),
                             make_offline_batched_fn(cfg_m), STREAM_CHUNK, 1)}
        for form, (sharded_fn, one_fn, k, warm) in forms.items():
            tag = f"sharded {form} {mode.name}"

            def at(x, i):       # the call's frames: one (step) or k (chunk) of each stream
                return x[:, i] if k == 1 else x[:, i:i + k]

            def fresh():
                return init_batched_carry(cfg_m, N_STREAMS, int(mode), prng.key(seed), dev0)

            def timed(fn, carry, frames_of):
                """Every call of ``fn``; the call at ``warm - 1`` under the
                sync check; host ms per batched frame after it."""
                outs, per_call, bad, syncs = [], [], 0, []
                t0 = None
                for c, i in enumerate(range(0, n_frames, k)):
                    before = aw.launches
                    if c == warm - 1:
                        (carry, (out, _)), syncs = count_syncs(lambda: fn(carry, frames_of(i)))
                        sync_all(mesh)
                        t0 = time.perf_counter()
                    else:
                        carry, (out, _) = fn(carry, frames_of(i))
                    per_call.append(aw.launches - before)
                    bad += misplaced(carry, mesh) if fn is sharded_fn else 0
                    outs.append(out)
                sync_all(mesh)
                ms = 1e3 * (time.perf_counter() - t0) / (n_frames - warm * k)
                return carry, outs, per_call, bad, syncs, ms

            # over the mesh, each slot's streams already on its card
            def fresh_sharded():
                return init_sharded_carry(cfg_m, N_STREAMS, int(mode), prng.key(seed), mesh)

            aw.launches = 0
            carry, s_outs, per_call, bad, syncs, ms_mesh = timed(
                sharded_fn, fresh_sharded(), lambda i: Sharded(tuple(at(p, i) for p in parts)))
            launches = aw.launches
            _, split, wall = profiled(
                lambda: sharded_fn(carry, Sharded(tuple(at(p, n_frames - k) for p in parts))),
                mesh)
            # all N_STREAMS streams on one card, and each slot's sub-batch alone
            one, one_outs, _, _, _, ms_one = timed(one_fn, fresh(), lambda i: at(frames, i))
            _, one_split, _ = profiled(lambda: one_fn(one, at(frames, n_frames - k)), [dev0])
            start = fresh_sharded()
            starts = start.parts if n_slots > 1 else (start,)
            slot_equal = 0
            for d, dv in enumerate(mesh):
                c_d = starts[d]
                for c, i in enumerate(range(0, n_frames, k)):
                    c_d, (out, _) = one_fn(c_d, at(parts[d], i))
                    mine = s_outs[c].parts[d] if n_slots > 1 else s_outs[c]
                    slot_equal += bool(torch.equal(out, mine))
            n_calls = n_frames // k
            joined = torch.cat([unshard(o, dev0) if k > 1 else unshard(o, dev0)[:, None]
                                for o in s_outs], 1)
            single = torch.cat(one_outs, 1) if k > 1 else torch.stack(one_outs, 1)
            differ = against_single(joined, single)
            del s_outs, one_outs, joined, single
            ppp = copies_of(split, "PtoP")
            busy = {i: sp["busy_ms"] / k for i, sp in split.items()}
            one_busy = sum(sp["busy_ms"] for sp in one_split.values()) / k

            print(f"{tag}: mesh [{mesh_name}], {N_STREAMS} streams x {n_frames} frames "
                  f"{cfg.frame_height}x{cfg.frame_width}, {per} per slot; warp launches "
                  f"{launches} (per call {sorted(set(per_call))}, {BATCHED_LAUNCHES} per slot "
                  f"expected); carry tensors off their slot's device after a call: {bad}",
                  flush=True)
            report_syncs(tag, syncs, "call (an untimed warm-up one)")
            print(f"{tag}: each slot equal to its own sub-batch through the one-device "
                  f"batched form, bit for bit, in {slot_equal} of {n_slots * n_calls} slot "
                  f"calls; vs the one-device run of all {N_STREAMS} streams, per frame at "
                  f"most {differ[0]:.5f} of pixels differ, {differ[1]:.6f} by more than one "
                  f"level (<= {OFFLINE_DIFFER}, {OFFLINE_OFF_BY_MORE})", flush=True)
            print(f"{tag}: {ms_mesh:.3f} ms per batched frame over the mesh, "
                  f"{N_STREAMS * 1e3 / ms_mesh:.1f} frames/s in all; one card "
                  f"{ms_one:.3f} ms, {N_STREAMS * 1e3 / ms_one:.1f} frames/s (host clock, "
                  f"every card synchronized, {n_frames - warm * k} steady frames); profiled "
                  f"call: device busy ms per batched frame by card "
                  + ", ".join(f"cuda:{i} {b:.3f} (idle {1 - b / ms_mesh:.3f})"
                              for i, b in sorted(busy.items()))
                  + f" against the unprofiled wall; one card {one_busy:.3f} (idle "
                  f"{1 - one_busy / ms_one:.3f}); copies by card "
                  + ", ".join(f"cuda:{i} {sp['copies']}" for i, sp in sorted(split.items()))
                  + f", peer-to-peer {ppp}; {card}", flush=True)
            if set(per_call) != {BATCHED_LAUNCHES * n_slots}:
                raise AssertionError(f"{tag}: warp launches per call {per_call}, not "
                                     f"{BATCHED_LAUNCHES} per slot")
            if syncs or bad or ppp:
                raise AssertionError(f"{tag}: {len(syncs)} host syncs, {bad} misplaced carry "
                                     f"tensors, {ppp} peer-to-peer copies")
            if slot_equal != n_slots * n_calls:
                raise AssertionError(f"{tag}: a slot differs from its own sub-batch")
            if not (differ[0] <= OFFLINE_DIFFER and differ[1] <= OFFLINE_OFF_BY_MORE):
                raise AssertionError(f"{tag}: outputs differ from the one-device run: {differ}")
            result[form]["launches"] += launches
            result[form]["frames"] += n_frames
            result[f"{form} {mode.name}"] = {"ms_mesh": ms_mesh, "ms_one": ms_one,
                                             "busy": busy, "one_busy": one_busy}
    peaks = {c: torch.cuda.max_memory_allocated(c) / 2 ** 30 for c in cards}
    print("sharded: peak device memory per card "
          + ", ".join(f"{c} {g:.2f} GiB" for c, g in peaks.items())
          + f" (torch.cuda.max_memory_allocated); {card}", flush=True)
    return result


def serve_mesh_only(mesh: list, card: str) -> dict:
    """Phase 13's serving part for ``--mesh-only``: SERVE_STREAMS simulator
    streams of MESH_ONLY_SERVE_FRAMES 1080x1920 frames rendered on the
    mesh's first card into C420 Y4M files, then :func:`serve_over_mesh`."""
    import os
    import shutil
    import tempfile

    from video_stabilization_tpu_torch import serve
    from video_stabilization_tpu_torch.io.native import NativeY4MReader
    from video_stabilization_tpu_torch.ops.image import yuv_flat_to_bgr

    h, w = SERVE_SIZE
    tmp = tempfile.mkdtemp(prefix="smoke_mesh_")
    try:
        inputs = serve._render_sim_streams(SERVE_STREAMS, MESH_ONLY_SERVE_FRAMES, h, w, tmp,
                                           mesh[0])
        footage = []
        for path in inputs:
            r = NativeY4MReader(path)
            footage.append(yuv_flat_to_bgr(torch.from_numpy(
                r.read_yuv_block(MESH_ONLY_SERVE_FRAMES)).to(mesh[0]), h, w, True))
            r.close()
        return serve_over_mesh(inputs, torch.stack(footage), mesh, os.path.join(tmp, "out"),
                               card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# phase 14: config 5 in mixed modes, interleaved over the streams (SIFT stays
# in the CPU tests: ~215 ms per frame at config 4, too long for the smoke)
MIXED_MODES = (0, 4, 1, 2, 0, 4, 1, 2)   # GLOBAL_SMOOTHING, TRANSLATION, ACCUMULATED, ORB
MIXED_FRAMES = 16        # a depth cut from phase 9's 24, as phase 13's
MIXED_MESH_FRAMES = 8
MIXED_WARM = 4           # calls before the timed ones; the last under the sync check
MIXED_FAST_PER_CALL = 2  # one FAST launch per ORB stream and frame


def source_line(fn, text: str) -> str:
    """``file:line`` of the first line of ``fn``'s source holding ``text``
    (where a sync warning names its caller)."""
    import inspect

    fn = inspect.unwrap(fn)
    lines, start = inspect.getsourcelines(fn)
    at = next(i for i, ln in enumerate(lines) if text in ln)
    return f"{inspect.getsourcefile(fn)}:{start + at}"


def mixed_carry(cfg, n_streams: int, seed: int, dev, modes=MIXED_MODES):
    """A fresh carry of ``n_streams`` streams from the seed's stream keys,
    stream s in mode ``modes[s % len(modes)]``."""
    import dataclasses

    from video_stabilization_tpu_torch.parallel import init_batched_carry
    from video_stabilization_tpu_torch.utils import prng

    carry = init_batched_carry(cfg, n_streams, 0, prng.key(seed), dev)
    mode = torch.tensor([modes[s % len(modes)] for s in range(n_streams)], dtype=torch.int32)
    return dataclasses.replace(carry, mode=mode.to(dev))


def own_mode_differs(before, frames, cfg, stream_modes, carry, out) -> list:
    """The streams of a mixed call (``before`` -> ``carry``, ``out``) that
    differ from stream s of the body on the whole batch in stream s's own
    mode (K = 1, the mixed call's warp arguments), each mode's run from a
    clone of ``before``: outputs and lock state, bit for bit."""
    from video_stabilization_tpu_torch.engine import map_carry, offline_batched_chunk_step

    bad = []
    for m in sorted(set(stream_modes)):
        ref, (ref_out, _) = offline_batched_chunk_step(
            map_carry(torch.clone, before), frames[:, None], cfg, form="batched_mixed",
            modes=[m] * len(stream_modes))
        for s in (s for s, ms in enumerate(stream_modes) if ms == m):
            same = torch.equal(ref_out[s, 0], out[s]) and all(
                torch.equal(getattr(ref, f)[s], getattr(carry, f)[s])
                for f in ("last_h", "accum_h", "accum_active", "lock_prev_h",
                          "last_lock_matches"))
            if not same:
                bad.append(s)
        del ref, ref_out
    return sorted(bad)


def phase_mixed(cfg, seed: int, dev, card: str, one_mode: dict) -> dict:
    """Phase 14, on one card: bench config 5 (N_STREAMS streams of
    1080x1920, phase 9's seeds, MIXED_FRAMES frames) in the interleaved
    modes MIXED_MODES through ``make_batched_step_fn`` with no static mode.
    Checks exactly one host sync per call, at the mode read (named by its
    source line), in an untimed warm-up call; BATCHED_LAUNCHES warp and
    MIXED_FAST_PER_CALL FAST launches per call; and on a second pass each
    stream bit for bit against stream s of the body on the whole batch in
    its own mode, with the same warp arguments, from a clone of the carry
    before each call.  Prints ms per batched frame beside phase 9's
    one-mode batched step (``one_mode``) and peak device memory."""
    from video_stabilization_tpu_torch.config import StabilizationMode
    from video_stabilization_tpu_torch.engine import map_carry
    from video_stabilization_tpu_torch.engine.offline import accumulating_modes
    from video_stabilization_tpu_torch.ops import affine_warp as aw
    from video_stabilization_tpu_torch.ops import fast
    from video_stabilization_tpu_torch.parallel import make_batched_step_fn, streams
    from video_stabilization_tpu_torch.utils import stage_profile

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev)
    n_frames = MIXED_FRAMES
    frames = stage_profile.footage(cfg, n_frames, seed, dev, streams=N_STREAMS)
    stream_modes = [MIXED_MODES[s % len(MIXED_MODES)] for s in range(N_STREAMS)]
    names = "/".join(StabilizationMode(m).name for m in MIXED_MODES[:4])
    step = make_batched_step_fn(cfg)
    tag = "mixed config5"

    # the timed run: launches counted from 0 just before it
    carry = mixed_carry(cfg, N_STREAMS, seed, dev)
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    per_call, fast_per_call = [], []
    aw.launches = fast.launches = 0
    for t in range(n_frames):
        before, fast_before = aw.launches, fast.launches
        if t == MIXED_WARM - 1:
            (carry, _), syncs = count_syncs(lambda: step(carry, frames[:, t]))
            torch.cuda.synchronize()
            ev0.record()
        else:
            carry, _ = step(carry, frames[:, t])
        per_call.append(aw.launches - before)
        fast_per_call.append(fast.launches - fast_before)
    ev1.record()
    torch.cuda.synchronize()
    launches, fast_launches = aw.launches, fast.launches
    ms_step = ev0.elapsed_time(ev1) / (n_frames - MIXED_WARM)
    matches = carry.last_lock_matches.tolist()
    active = carry.accum_active.tolist()
    captured = carry.orb_ref.is_set.tolist()
    del carry

    # the equality pass: each call against its own modes' runs
    carry = mixed_carry(cfg, N_STREAMS, seed, dev)
    bad = {}
    for t in range(n_frames):
        before = map_carry(torch.clone, carry)
        carry, (out, _) = step(carry, frames[:, t])
        wrong = own_mode_differs(before, frames[:, t], cfg, stream_modes, carry, out)
        if wrong:
            bad[t] = wrong
        del before
    finite = bool(torch.isfinite(carry.last_h).all())
    del carry, frames
    peak = torch.cuda.max_memory_allocated(dev)
    want = source_line(streams.make_batched_step_fn, "carry.mode.tolist()")

    print(f"{tag}: {N_STREAMS} streams x {n_frames} frames {cfg.frame_height}x"
          f"{cfg.frame_width} in modes {names} (stream s in mode s % 4) through the batched "
          f"step with no static mode; warp launches {launches} (per call "
          f"{sorted(set(per_call))}), FAST launches {fast_launches} (per call "
          f"{sorted(set(fast_per_call))}); lock matches {matches}, ORB reference captured "
          f"{captured}, accumulated lock active {active}", flush=True)
    print(f"{tag}: {len(syncs)} synchronizing calls in one call (an untimed warm-up one) "
          f"under set_sync_debug_mode('warn'): {sorted(set(syncs))}; the mode read is "
          f"{want}", flush=True)
    print(f"{tag}: each stream bit for bit equal to stream s of its own mode's run on the "
          f"whole batch (4 runs per call, each from a clone of the carry) in "
          f"{n_frames - len(bad)} of {n_frames} calls" + (f"; differing {bad}" if bad else ""),
          flush=True)
    print(f"{tag}: {ms_step:.3f} ms per batched frame ({n_frames - MIXED_WARM} steady "
          f"calls, CUDA events), {N_STREAMS * 1e3 / ms_step:.1f} frames/s in all; phase 9's "
          f"one-mode batched step in this run: TRANSLATION_LOCK "
          f"{one_mode['TRANSLATION_LOCK']['ms_step']:.3f} ms, GLOBAL_SMOOTHING "
          f"{one_mode['GLOBAL_SMOOTHING']['ms_step']:.3f} ms; peak device memory "
          f"{peak / 2 ** 30:.2f} GiB ({mem0 / 2 ** 30:.2f} GiB allocated before the phase); "
          f"{time.perf_counter() - t_phase:.1f} s; {card}", flush=True)
    if syncs != [want]:
        raise AssertionError(f"{tag}: host syncs {syncs}, not the one mode read at {want}")
    if set(per_call) != {BATCHED_LAUNCHES} or set(fast_per_call) != {MIXED_FAST_PER_CALL}:
        raise AssertionError(f"{tag}: warp launches per call {per_call}, FAST {fast_per_call}")
    if bad or not finite:
        raise AssertionError(f"{tag}: streams differ from their own modes' runs: {bad}; "
                             f"finite last_h {finite}")
    want_captured = [m == StabilizationMode.ORB_FULL_LOCK for m in stream_modes]
    want_active = [m in accumulating_modes(cfg) for m in stream_modes]
    if captured != want_captured or active != want_active:
        raise AssertionError(f"{tag}: ORB reference captured {captured}, accumulated lock "
                             f"active {active}; want {want_captured}, {want_active}")
    return {"launches": launches, "fast_launches": fast_launches, "frames": n_frames,
            "ms_step": ms_step, "syncs": len(syncs)}


def phase_mixed_mesh(cfg, seed: int, mesh: list, card: str) -> dict:
    """Phase 14 over phase 13's mesh: the same modes through
    ``make_sharded_step_fn`` with no static mode, MIXED_MESH_FRAMES frames,
    each slot's streams rendered once onto its card.  Checks each slot bit
    for bit against its own sub-batch through the one-device mixed form on
    its card, one mode read per slot in a warm-up call (and no other sync),
    every carry tensor on its slot's device after every call,
    BATCHED_LAUNCHES warp launches per slot per call, MIXED_FAST_PER_CALL
    FAST launches per call, and no peer-to-peer copy in a profiled call."""
    from video_stabilization_tpu_torch.engine import map_carry
    from video_stabilization_tpu_torch.ops import affine_warp as aw
    from video_stabilization_tpu_torch.ops import fast
    from video_stabilization_tpu_torch.parallel import (
        Sharded, make_batched_step_fn, make_sharded_step_fn, shard_carry, streams)
    from video_stabilization_tpu_torch.utils import stage_profile

    t_phase = time.perf_counter()
    n_slots, per = len(mesh), N_STREAMS // len(mesh)
    dev0, n_frames = mesh[0], MIXED_MESH_FRAMES
    frames = stage_profile.footage(cfg, n_frames, seed, dev0, streams=N_STREAMS)
    parts = [frames[d * per:(d + 1) * per].to(dv) for d, dv in enumerate(mesh)]
    del frames
    tag = "mixed sharded config5"
    sharded = make_sharded_step_fn(cfg, mesh)
    start = mixed_carry(cfg, N_STREAMS, seed, dev0)
    carry = shard_carry(start, mesh)
    outs, per_call, fast_per_call, misplaced_n, syncs = [], [], [], 0, []
    aw.launches = fast.launches = 0
    for t in range(n_frames):
        before, fast_before = aw.launches, fast.launches
        frames_t = Sharded(tuple(p[:, t] for p in parts)) if n_slots > 1 else parts[0][:, t]
        if t == 1:
            (carry, (out, _)), syncs = count_syncs(lambda: sharded(carry, frames_t))
        else:
            carry, (out, _) = sharded(carry, frames_t)
        per_call.append(aw.launches - before)
        fast_per_call.append(fast.launches - fast_before)
        misplaced_n += misplaced(carry, mesh)
        outs.append(out.parts if n_slots > 1 else (out,))
    launches, fast_launches = aw.launches, fast.launches
    last = Sharded(tuple(p[:, -1] for p in parts)) if n_slots > 1 else parts[0][:, -1]
    _, split, _ = profiled(lambda: sharded(map_carry(torch.clone, carry), last), mesh)
    ppp = copies_of(split, "PtoP")
    del carry

    # each slot's sub-batch through the one-device mixed form on its card
    one = make_batched_step_fn(cfg)
    slot_equal = 0
    for d, dv in enumerate(mesh):
        c_d = map_carry(lambda x: x[d * per:(d + 1) * per].to(dv, copy=True), start)
        for t in range(n_frames):
            c_d, (o, _) = one(c_d, parts[d][:, t])
            slot_equal += bool(torch.equal(o, outs[t][d]))
    del start, outs, parts
    want = source_line(streams._over_mesh, "c.mode.tolist()")
    print(f"{tag}: mesh [{', '.join(map(str, mesh))}], {N_STREAMS} streams x {n_frames} "
          f"frames, {per} per slot, modes {MIXED_MODES}; warp launches {launches} (per call "
          f"{sorted(set(per_call))}, {BATCHED_LAUNCHES} per slot expected), FAST "
          f"{fast_launches} (per call {sorted(set(fast_per_call))}); carry tensors off their "
          f"slot's device after a call: {misplaced_n}; peer-to-peer copies in a profiled "
          f"call {ppp}", flush=True)
    print(f"{tag}: {len(syncs)} synchronizing calls in one call (a warm-up one): "
          f"{sorted(set(syncs))}; {n_slots} mode reads expected at {want}", flush=True)
    print(f"{tag}: each slot equal to its own sub-batch through the one-device mixed form, "
          f"bit for bit, in {slot_equal} of {n_slots * n_frames} slot calls; "
          f"{time.perf_counter() - t_phase:.1f} s; {card}", flush=True)
    if syncs != [want] * n_slots:
        raise AssertionError(f"{tag}: host syncs {syncs}, not one mode read per slot")
    if set(per_call) != {BATCHED_LAUNCHES * n_slots} or \
            set(fast_per_call) != {MIXED_FAST_PER_CALL}:
        raise AssertionError(f"{tag}: warp launches per call {per_call}, FAST {fast_per_call}")
    if misplaced_n or ppp or slot_equal != n_slots * n_frames:
        raise AssertionError(f"{tag}: {misplaced_n} misplaced carry tensors, {ppp} "
                             f"peer-to-peer copies, {slot_equal} of {n_slots * n_frames} "
                             "slot calls equal")
    return {"launches": launches, "fast_launches": fast_launches, "frames": n_frames}


def phase_last_card(dev, rng) -> float:
    """With two or more cards: the warp (one image, and a batch of config
    5's shape that mixes items inside and outside the envelope) and FAST's
    levels on the last card, launched while card 0 is the thread's current
    one, against their plain versions there.  Returns the max abs error."""
    from video_stabilization_tpu_torch.ops import affine_warp as aw
    from video_stabilization_tpu_torch.ops import fast

    torch.cuda.set_device(0)
    counter = aw.fallback_counter(dev)
    counter.zero_()
    errs = []
    src = warp_input((3, 1080, 1920), "hwc", rng, dev)
    border = torch.from_numpy(rng.uniform(0, 255, 3).astype(np.float32)).to(dev)
    for name in ("rot3", "rot12"):
        h = torch.from_numpy(TRANSFORMS[name]).to(dev)
        errs.append(float((aw.warp_affine(src, h, border)
                           - aw.warp_affine_plain(src, h, border)).abs().max()))
    batch = torch.from_numpy(rng.uniform(0, 255, (N_STREAMS, 1080, 1920, 3))
                             .astype(np.float32)).to(dev)
    hs = torch.from_numpy(mixed_transforms(N_STREAMS, rng)).to(dev)
    errs.append(float((aw.warp_affine(batch, hs, border)
                       - aw.warp_affine_plain(batch, hs, border)).abs().max()))
    gathered = int(counter)
    levels = [torch.from_numpy(np.round(rng.uniform(0, 255, s)).astype(np.float32)).to(dev)
              for s in FAST_SHAPES]
    errs += [float((a - b).abs().max()) for a, b in
             zip(fast.fast_levels(levels, FAST_THRESHOLD, EDGE_THRESHOLD),
                 fast.fast_levels_plain(levels, FAST_THRESHOLD, EDGE_THRESHOLD))]
    err = max(errs)
    outside = 1 + N_STREAMS // 4
    print(f"last card {dev} (current device cuda:{torch.cuda.current_device()}): warp one "
          f"image and a batch of {N_STREAMS} and FAST's {len(FAST_SHAPES)} levels against "
          f"their plain versions there, max abs err {err}; gathers counted on {dev}: "
          f"{gathered} ({outside} expected)", flush=True)
    if not err <= min(KERNEL_TOL, FAST_TOL) or gathered != outside:
        raise AssertionError(f"kernels on {dev}: max abs {err}, gathers {gathered}")
    return err


def y4m_raw_frames(path: str) -> list:
    """The raw Y|U|V bytes of every frame of a Y4M file (native reader)."""
    from video_stabilization_tpu_torch.io.native import NativeY4MReader

    r = NativeY4MReader(path)
    frames = []
    while (raw := r.read_yuv()) is not None:
        frames.append(raw.tobytes())
    r.close()
    return frames


def encoded(frames, c420: bool) -> list:
    """Each (H, W, 3) u8 frame's Y4M plane bytes, ``VideoWriter``'s encode,
    on a pool of host threads (numpy releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    from video_stabilization_tpu_torch.io.video import encode_y4m_planes

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(lambda f: encode_y4m_planes(f, c420), frames))


def loop_syncs(caught) -> list:
    return [f"{w.filename}:{w.lineno}" for w in caught
            if "called a synchronizing" in str(w.message)]


def phase_serve(seed: int, dev, card: str, mesh: list, cards: str) -> dict:
    """Phase 10: the serving entry point, ``serve.main``, at bench config
    5's size (SERVE_ARGV: 8 simulator streams of 1080x1920 rendered on the
    card into C420 Y4M files, window 30 + 1 + 15, chunks of 8); then a
    short ``--mode orb`` run (SERVE_ORB_ARGV), the FAST kernel's serving
    path.  Checks the frames written against the in-memory path
    (``stabilize_streams_sharded`` on the same decoded footage, through the
    writer's encode, byte for byte), the card's YUV decode against the
    native reader's, warp launches per chunk, the loop's host syncs; prints
    the wall time split, frames/s and the device's idle share in the loop
    (kernel time of a profiled run of two chunks against the unprofiled
    loop's wall per chunk).  Phase 13's serving part (:func:`serve_over_mesh`)
    runs on the same inputs, over ``mesh``."""
    import os
    import shutil
    import tempfile

    from video_stabilization_tpu_torch import serve
    from video_stabilization_tpu_torch.config import StabilizationMode
    from video_stabilization_tpu_torch.io.native import NativeY4MReader
    from video_stabilization_tpu_torch.ops import affine_warp as aw
    from video_stabilization_tpu_torch.ops import fast, y4m
    from video_stabilization_tpu_torch.ops.image import yuv_flat_to_bgr
    from video_stabilization_tpu_torch.utils.stage_profile import _device_us

    tmp = tempfile.mkdtemp(prefix="smoke_serve_")
    inputs = []
    try:
        out_dir = os.path.join(tmp, "out")
        aw.launches = 0
        fast.launches = 0
        y4m.launches = 0
        serve.loop_sync_debug = "warn"
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                serve.main(SERVE_ARGV + ["--output-dir", out_dir], device=dev, keep_inputs=True)
            finally:
                serve.loop_sync_debug = None
        run = dict(serve.last_run)
        launches, fast_launches, y4m_launches = aw.launches, fast.launches, y4m.launches
        syncs = loop_syncs(caught)
        inputs = run["inputs"]
        s, frames, chunks = run["streams"], run["frames"], run["chunks"]
        if s != SERVE_STREAMS or frames != SERVE_FRAMES or chunks != SERVE_FRAMES // SERVE_CHUNK:
            raise AssertionError(f"serve: {s} streams, {frames} frames, {chunks} chunks")

        # the in-memory path on the same decoded footage
        h, w = SERVE_SIZE
        footage = []
        for path in inputs:
            r = NativeY4MReader(path)
            footage.append(yuv_flat_to_bgr(torch.from_numpy(r.read_yuv_block(frames)).to(dev),
                                           h, w, True))
            r.close()
        footage = torch.stack(footage)
        decode_equal = 0
        for si, path in enumerate(inputs):
            r = NativeY4MReader(path)
            for t in range(frames):
                decode_equal += bool(np.array_equal(footage[si, t].cpu().numpy(), r.read()))
            r.close()
        cfg = serve._serve_config(h, w, 360, 30, 15, int(StabilizationMode.GLOBAL_SMOOTHING))
        outs, valid, _ = serve.stabilize_streams_sharded(footage, cfg, [dev], chunk=SERVE_CHUNK)
        n_valid = valid.sum(1).tolist()
        written, equal = [], 0
        for si, path in enumerate(inputs):
            got = y4m_raw_frames(os.path.join(out_dir, f"stabilized_{os.path.basename(path)}"))
            want = encoded(list(outs[si][valid[si]].cpu().numpy()), True)
            written.append(len(got))
            equal += sum(g == w_ for g, w_ in zip(got, want))
        del outs
        shutil.rmtree(out_dir)

        # the device's idle share: kernel time of two profiled chunks
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            serve.serve_files(inputs, out_dir, "smoothing", past=30, future=15,
                              chunk=SERVE_CHUNK, max_frames=2 * SERVE_CHUNK, devices=[dev],
                              log=lambda *a: None)
            torch.cuda.synchronize()
        prof_run = dict(serve.last_run)
        busy_ms = sum(_device_us(e) for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        busy_per_chunk = busy_ms / prof_run["chunks"]
        wall_per_chunk = 1e3 * run["wall_s"] / chunks
        idle = 1.0 - busy_per_chunk / wall_per_chunk
        idle_prof = 1.0 - busy_ms / (1e3 * prof_run["wall_s"])
        sharded = serve_over_mesh(inputs, footage, mesh, os.path.join(tmp, "sharded"), cards)
        del footage
        for path in inputs:
            os.unlink(path)

        # the FAST kernel's serving path: ORB lock streams
        fast.launches = 0
        orb_before = aw.launches
        serve.main(SERVE_ORB_ARGV, device=dev)
        orb_run = dict(serve.last_run)
        orb_fast = fast.launches
        orb_warps = aw.launches - orb_before
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        for path in inputs:
            shutil.rmtree(os.path.dirname(path), ignore_errors=True)

    tag = "serve"
    fps = frames * s / run["wall_s"]
    print(f"{tag}: serve.main {' '.join(SERVE_ARGV)}: {s} streams x {frames} frames "
          f"{w}x{h} C420 in {chunks} chunks of {SERVE_CHUNK}; frames written per stream "
          f"{written}, marked valid by the in-memory path {n_valid}", flush=True)
    print(f"{tag}: written frames equal to the in-memory path's through the C420 encode: "
          f"{equal} of {sum(written)}; card YUV decode equal to the native reader's host "
          f"conversion: {decode_equal} of {s * frames} frames", flush=True)
    print(f"{tag}: warp launches {launches} ({launches / chunks:.2f} per chunk, "
          f"{BATCHED_LAUNCHES} expected), FAST {fast_launches}; host syncs in the loop "
          f"flagged by set_sync_debug_mode('warn'): {len(syncs)}"
          + (f" {sorted(set(syncs))}" if syncs else "")
          + f"; event waits {run['event_waits']} ({run['event_waits'] / chunks:.0f} per "
          "chunk, the drain's)", flush=True)
    print(f"{tag}: Y4M encode launches {y4m_launches} ({y4m_launches / chunks:.2f} per chunk, "
          f"1 expected); frames encoded on the card {run['device_encoded']} of {s * frames}; "
          f"host encode in the drain {run['encode_s']:.4f} s", flush=True)
    print(f"{tag}: wall {run['wall_s']:.3f} s: read {run['read_s']:.3f} s, queueing H2D + "
          f"decode + chunk + encode + D2H {run['queue_s']:.3f} s, drain wait "
          f"{run['wait_s']:.3f} s, drain write {run['write_s']:.3f} s (pipe write "
          f"{run['pipe_write_s']:.3f} s) (host clock); device H2D {sum(run['h2d_ms']):.2f} ms, "
          f"decode + chunk + encode {sum(run['compute_ms']):.2f} ms, D2H "
          f"{sum(run['d2h_ms']):.2f} ms (CUDA events); {fps:.1f} frames/s in all, "
          f"{fps / s:.2f} per stream", flush=True)
    print(f"{tag}: device idle share in the loop {idle:.3f} (kernel time {busy_per_chunk:.2f} "
          f"ms per chunk, torch.profiler over {prof_run['chunks']} chunks, against the "
          f"unprofiled wall {wall_per_chunk:.2f} ms per chunk; {idle_prof:.3f} of the "
          f"profiled run's own wall); {card}", flush=True)
    print(f"{tag}: serve.main {' '.join(SERVE_ORB_ARGV)}: {orb_run['streams']} streams x "
          f"{orb_run['frames']} frames, FAST launches {orb_fast} "
          f"({orb_fast / (orb_run['streams'] * orb_run['frames']):.2f} per stream frame), "
          f"warp launches {orb_warps}, "
          f"{orb_run['frames'] * orb_run['streams'] / orb_run['wall_s']:.1f} frames/s in all",
          flush=True)
    if written != n_valid or equal != sum(written):
        raise AssertionError(f"{tag}: files differ from the in-memory path (written {written}, "
                             f"valid {n_valid}, equal {equal})")
    if decode_equal != s * frames:
        raise AssertionError(f"{tag}: the card's YUV decode differs from the native reader")
    if launches != BATCHED_LAUNCHES * chunks:
        raise AssertionError(f"{tag}: {launches} warp launches in {chunks} chunks")
    if y4m_launches != chunks or run["device_encoded"] != s * frames:
        raise AssertionError(f"{tag}: {y4m_launches} encode launches in {chunks} chunks, "
                             f"{run['device_encoded']} frames encoded on the card")
    if syncs or run["event_waits"] != chunks:
        raise AssertionError(f"{tag}: loop syncs {syncs}, event waits {run['event_waits']}")
    if orb_fast != orb_run["streams"] * orb_run["frames"]:
        raise AssertionError(f"{tag}: FAST launched {orb_fast} times in the ORB serve run")
    # "frames": batched frames (one of each stream), as config 5's offline path
    return {"launches": launches, "frames": frames, "chunks": chunks, "fps": fps,
            "idle": idle, "syncs": len(syncs), "fast_launches": orb_fast,
            "fast_frames": orb_run["streams"] * orb_run["frames"], "sharded": sharded,
            "y4m_launches": y4m_launches, "device_encoded": run["device_encoded"]}


def serve_over_mesh(inputs: list, footage: torch.Tensor, mesh: list, out_dir: str,
                    card: str) -> dict:
    """Phase 13's serving part: ``serve.main --files`` on phase 10's inputs
    (SERVE_ARGV's window and chunk) over ``mesh``, its files against the
    in-memory ``stabilize_streams_sharded`` on the same mesh (byte for byte
    through the writer's encode), its warp launches, loop syncs and event
    waits (one per slot and chunk); then SERVE_ORB_ARGV over ``mesh``,
    FAST's path.  ``footage`` is the inputs decoded."""
    import os
    import shutil

    from video_stabilization_tpu_torch import serve
    from video_stabilization_tpu_torch.config import StabilizationMode
    from video_stabilization_tpu_torch.ops import affine_warp as aw
    from video_stabilization_tpu_torch.ops import fast, y4m
    from video_stabilization_tpu_torch.parallel import unshard

    argv = ["--files", *inputs, "--past-window", "1.0", "--future-window", "0.5", "--chunk",
            str(SERVE_CHUNK), "--mode", "smoothing", "--output-dir", out_dir]
    aw.launches = 0
    y4m.launches = 0
    serve.loop_sync_debug = "warn"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            serve.main(argv, device=mesh)
        finally:
            serve.loop_sync_debug = None
    run = dict(serve.last_run)
    launches, syncs, y4m_launches = aw.launches, loop_syncs(caught), y4m.launches
    used = [torch.device(d) for d in run["devices"]]
    s, frames, chunks = run["streams"], run["frames"], run["chunks"]
    h, w = SERVE_SIZE
    cfg = serve._serve_config(h, w, 360, 30, 15, int(StabilizationMode.GLOBAL_SMOOTHING))
    outs, valid, _ = serve.stabilize_streams_sharded(footage, cfg, used, chunk=SERVE_CHUNK)
    outs, valid = unshard(outs), unshard(valid)
    written, equal = [], 0
    for si, path in enumerate(inputs):
        got = y4m_raw_frames(os.path.join(out_dir, f"stabilized_{os.path.basename(path)}"))
        want = encoded(list(outs[si][valid[si]].numpy()), True)
        written.append(len(got))
        equal += sum(g == w_ for g, w_ in zip(got, want))
    n_valid = valid.sum(1).tolist()
    del outs
    shutil.rmtree(out_dir)
    # one chunk profiled (with its set-up): each slot's upload from and
    # download into the pinned buffers, none through pageable memory or
    # between cards
    _, split, _ = profiled(lambda: serve.serve_files(
        inputs, None, "smoothing", past=30, future=15, chunk=SERVE_CHUNK,
        max_frames=SERVE_CHUNK, devices=mesh, log=lambda *a: None), used)
    from_pinned = copies_of(split, "HtoD (Pinned")
    to_pinned = copies_of(split, "DtoH (Device -> Pinned)")
    to_pageable, ppp = copies_of(split, "-> Pageable"), copies_of(split, "PtoP")

    fast.launches = 0
    serve.main(SERVE_ORB_ARGV, device=mesh)
    orb_run = dict(serve.last_run)
    orb_fast = fast.launches

    tag = "serve sharded"
    fps = frames * s / run["wall_s"]
    slots = len(used)
    print(f"{tag}: serve.main --files ({s} inputs) over [{', '.join(run['devices'])}] "
          f"({slots} slots of {s // slots} streams), {frames} frames in {chunks} chunks of "
          f"{SERVE_CHUNK}; frames written per stream {written}, valid in memory {n_valid}; "
          f"equal to the in-memory sharded path through the C420 encode: {equal} of "
          f"{sum(written)}", flush=True)
    print(f"{tag}: warp launches {launches} ({launches / chunks:.2f} per chunk, "
          f"{BATCHED_LAUNCHES} per slot expected); host syncs in the loop flagged by "
          f"set_sync_debug_mode('warn'): {len(syncs)}"
          + (f" {sorted(set(syncs))}" if syncs else "")
          + f"; event waits {run['event_waits']} ({run['event_waits'] / chunks:.0f} per chunk: "
          f"one per slot); Y4M encode launches {y4m_launches} ({y4m_launches / chunks:.2f} per "
          f"chunk, one per slot expected), frames encoded on the cards "
          f"{run['device_encoded']} of {s * frames}", flush=True)
    print(f"{tag}: one profiled chunk, copies by card "
          + ", ".join(f"cuda:{i} {sp['copies']}" for i, sp in sorted(split.items()))
          + f": from pinned memory {from_pinned} ({slots} uploads expected), into it "
          f"{to_pinned} ({2 * slots}: outputs and validity), into pageable memory "
          f"{to_pageable}, peer-to-peer {ppp}", flush=True)
    print(f"{tag}: wall {run['wall_s']:.3f} s: read {run['read_s']:.3f} s, queueing "
          f"{run['queue_s']:.3f} s, drain wait {run['wait_s']:.3f} s, drain write "
          f"{run['write_s']:.3f} s (host clock); per slot, device H2D "
          f"{[round(x, 2) for x in run['h2d_ms']]} ms, decode + chunk "
          f"{[round(x, 2) for x in run['compute_ms']]} ms, D2H "
          f"{[round(x, 2) for x in run['d2h_ms']]} ms (CUDA events); {fps:.1f} frames/s in "
          f"all; {card}", flush=True)
    print(f"{tag}: serve.main {' '.join(SERVE_ORB_ARGV)} over [{', '.join(orb_run['devices'])}]: "
          f"{orb_run['streams']} streams x {orb_run['frames']} frames, FAST launches "
          f"{orb_fast} ({orb_fast / (orb_run['streams'] * orb_run['frames']):.2f} per stream "
          f"frame)", flush=True)
    if written != n_valid or equal != sum(written):
        raise AssertionError(f"{tag}: files differ from the in-memory sharded path "
                             f"(written {written}, valid {n_valid}, equal {equal})")
    if launches != BATCHED_LAUNCHES * slots * chunks:
        raise AssertionError(f"{tag}: {launches} warp launches in {chunks} chunks")
    if y4m_launches != slots * chunks or run["device_encoded"] != s * frames:
        raise AssertionError(f"{tag}: {y4m_launches} encode launches in {chunks} chunks, "
                             f"{run['device_encoded']} frames encoded on the cards")
    if syncs or run["event_waits"] != slots * chunks:
        raise AssertionError(f"{tag}: loop syncs {syncs}, event waits {run['event_waits']}")
    if from_pinned < slots or to_pinned != 2 * slots or to_pageable or ppp:
        raise AssertionError(f"{tag}: a chunk's copies: {from_pinned} from pinned memory, "
                             f"{to_pinned} into it, {to_pageable} into pageable memory, "
                             f"{ppp} between cards")
    if len(orb_run["devices"]) != len(serve.pick_serving_devices(mesh, orb_run["streams"])) \
            or orb_fast != orb_run["streams"] * orb_run["frames"]:
        raise AssertionError(f"{tag}: the ORB run over {orb_run['devices']} launched FAST "
                             f"{orb_fast} times")
    return {"launches": launches, "frames": frames, "fps": fps, "syncs": len(syncs),
            "fast_launches": orb_fast, "fast_frames": orb_run["streams"] * orb_run["frames"],
            "y4m_launches": y4m_launches, "chunks": chunks, "slots": slots}


def phase_y4m_kernel(dev, rng, card: str, served: dict) -> dict:
    """Phase 15: the Y4M encode kernel on one served chunk of config 5
    (Y4M_FRAMES random 1080x1920 frames), C420 and C444, against its plain
    version on the card and, for the first Y4M_NUMPY_FRAMES, against the
    numpy encode on the host: exact; its device time (CUDA graph) and back
    to back time per chunk against the byte bound, the plain version's
    time; the launches per served chunk that phases 10 and 13 counted
    (``served``, phase 10's record)."""
    from video_stabilization_tpu_torch.ops import y4m

    h, w = SERVE_SIZE
    frames = torch.from_numpy(rng.integers(0, 256, (Y4M_FRAMES, h, w, 3), dtype=np.uint8)
                              ).to(dev)
    out = {}
    for c420 in (True, False):
        name = "c420" if c420 else "c444"
        before = y4m.launches
        got = y4m.encode_y4m(frames, c420)
        one_launch = y4m.launches - before
        plain_equal = bool(torch.equal(got, y4m.encode_y4m_plain(frames, c420)))
        want = encoded(list(frames[:Y4M_NUMPY_FRAMES].cpu().numpy()), c420)
        numpy_equal = sum(bytes(g) == w_ for g, w_ in
                          zip(got[:Y4M_NUMPY_FRAMES].cpu().numpy(), want))
        del got
        dev_ms = device_ms(lambda: y4m.encode_y4m(frames, c420), n=10)
        ms = time_ms(lambda: y4m.encode_y4m(frames, c420))
        plain_ms = time_ms(lambda: y4m.encode_y4m_plain(frames, c420), reps=5, inner=2)
        px = Y4M_FRAMES * h * w
        bound = bound_ms(Y4M_BYTES[c420] * px, Y4M_OPS[c420] * px)
        print(f"y4m encode {name}: {Y4M_FRAMES} frames of {w}x{h} in {one_launch} launch; "
              f"equal to the plain version on the card: {plain_equal}; to the numpy encode: "
              f"{numpy_equal} of {Y4M_NUMPY_FRAMES} frames; per chunk {dev_ms:.4f} ms device "
              f"(CUDA graph), {ms:.4f} ms back to back, plain {plain_ms:.4f} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}, {Y4M_BYTES[c420]} B/px): "
              f"{100 * bound['bound_ms'] / dev_ms:.1f} % of it; {card}", flush=True)
        if one_launch != 1 or not plain_equal or numpy_equal != Y4M_NUMPY_FRAMES:
            raise AssertionError(f"y4m encode {name}: {one_launch} launches, plain equal "
                                 f"{plain_equal}, numpy equal {numpy_equal}")
        out[name] = {"device_ms": dev_ms / Y4M_FRAMES, "ms": ms / Y4M_FRAMES,
                     "plain_ms": plain_ms / Y4M_FRAMES, "bound_ms": bound["bound_ms"] / Y4M_FRAMES,
                     "bound_by": bound["bound_by"], "max_abs_err": 0.0}
    sharded = served["sharded"]
    print(f"y4m encode launches per served chunk: {served['y4m_launches'] / served['chunks']:.2f}"
          f" on one card (phase 10, {served['device_encoded']} frames encoded on the card), "
          f"{sharded['y4m_launches'] / sharded['chunks']:.2f} over {sharded['slots']} slots "
          "(phase 13)", flush=True)
    return out


def phase_app(seed: int, dev, card: str) -> dict:
    """Phase 11: the app, ``cli.app.main``, headless at its defaults
    (720x1280 simulator frames rendered on the card, working height 360,
    window 60 + 1 + 45): APP_FRAMES frames to a Y4M file with
    ``--checkpoint`` and ``--stats``; again with ``--resume`` (the frame
    counter reaches 2 x APP_FRAMES); once more fresh in ``--mode
    orb-lock``.  Each run's file against a ``Stabilizer.stabilize_frame``
    run on the same ``SimulatorSource`` frames (the resumed one from the
    first run's checkpoint), byte for byte through the writer's encode;
    launches and host syncs per frame, the loop's ms/frame beside the
    ``Stabilizer`` alone; then the host syncs of one ``make_step_fn`` call
    and one ``make_scan_fn`` call with the mode from ``carry.mode`` (one
    read each) and pinned by ``static_mode`` (none)."""
    import dataclasses
    import os
    import shutil
    import tempfile

    from video_stabilization_tpu_torch.cli import app
    from video_stabilization_tpu_torch.config import StabilizationMode, StabilizerConfig
    from video_stabilization_tpu_torch.engine import (
        Stabilizer, init_carry, make_scan_fn, make_step_fn)
    from video_stabilization_tpu_torch.io import SimulatorSource
    from video_stabilization_tpu_torch.ops import affine_warp as aw
    from video_stabilization_tpu_torch.ops import fast
    from video_stabilization_tpu_torch.utils import prng

    cfg = StabilizerConfig(frame_height=720, frame_width=1280, working_height=360,
                           past_frames=60, future_frames=45)
    tmp = tempfile.mkdtemp(prefix="smoke_app_")
    runs = {}
    try:
        ckpt = os.path.join(tmp, "s.npz")
        first_ckpt = os.path.join(tmp, "s1.npz")
        plans = (("fresh", ["--checkpoint", ckpt, "--stats"], StabilizationMode.GLOBAL_SMOOTHING),
                 ("resumed", ["--checkpoint", ckpt, "--resume", ckpt],
                  StabilizationMode.GLOBAL_SMOOTHING),
                 ("orb-lock", ["--mode", "orb-lock"], StabilizationMode.ORB_FULL_LOCK))
        for name, extra, mode in plans:
            out = os.path.join(tmp, f"{name}.y4m")
            argv = (["--simulator", "--no-display", "--max-frames", str(APP_FRAMES),
                     "--output", out] + extra)
            if name == "resumed":
                shutil.copy(ckpt, first_ckpt)
            aw.launches = 0
            fast.launches = 0
            app.loop_sync_debug = "warn"
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                try:
                    app.main(argv, device=dev)
                finally:
                    app.loop_sync_debug = None
            wall = time.perf_counter() - t0
            run = dict(app.last_run, warp=aw.launches, fast=fast.launches,
                       syncs=loop_syncs(caught), wall=wall,
                       argv=" ".join(os.path.basename(a) if a.startswith(tmp) else a
                                     for a in argv))
            got = y4m_raw_frames(out)

            # the same frames through the Stabilizer alone
            src = SimulatorSource(device=dev)
            stab = Stabilizer(cfg, mode, device=dev)
            if name == "resumed":
                stab.resume(first_ckpt)
            ref = []
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            for i in range(APP_FRAMES):
                if i == 8:
                    ev0.record()
                ref.append(stab.stabilize_frame(src.read_tensor()))
            ev1.record()
            ev1.synchronize()
            run["ref_ms"] = ev0.elapsed_time(ev1) / (APP_FRAMES - 8)
            want = encoded([f.cpu().numpy() for f in ref[cfg.future_frames:]], False)
            run["written_file"] = len(got)
            run["equal"] = sum(g == w_ for g, w_ in zip(got, want))
            run["want"] = len(want)
            runs[name] = run
            del ref, stab
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the step factories' host mode: one read of carry.mode per call unless
    # the config pins static_mode (engine/stabilizer.py::host_mode)
    src = SimulatorSource(device=dev)
    frames = torch.stack([src.read_tensor() for _ in range(4)])
    factory = {}
    for label, c in (("carry.mode", cfg), ("static_mode", dataclasses.replace(
            cfg, static_mode=int(StabilizationMode.GLOBAL_SMOOTHING)))):
        carry = init_carry(c, int(StabilizationMode.GLOBAL_SMOOTHING), prng.key(seed), dev)
        step = make_step_fn(c)
        carry, _ = step(carry, frames[0])          # warm-up
        (carry, _), step_syncs = count_syncs(lambda: step(carry, frames[1]))
        _, scan_syncs = count_syncs(lambda: make_scan_fn(c)(carry, frames[2:]))
        factory[label] = (step_syncs, scan_syncs)
    del frames, carry

    tag = "app"
    for label, (step_syncs, scan_syncs) in factory.items():
        print(f"{tag}: make_step_fn with the mode from {label}: {len(step_syncs)} host syncs "
              f"per call {sorted(set(step_syncs))}; make_scan_fn over 2 frames: "
              f"{len(scan_syncs)} per call {sorted(set(scan_syncs))}", flush=True)
    for name, run in runs.items():
        lines = sorted(set(run["syncs"]))
        print(f"{tag} {name}: cli.app.main {run['argv']}: {run['frames']} frames, "
              f"{run['written']} written ({run['written_file']} in the file), equal to the "
              f"Stabilizer's outputs {run['equal']} of {run['want']}; "
              f"frame counter at exit {run['frame_counter']}", flush=True)
        print(f"{tag} {name}: warp launches {run['warp']} ({run['warp'] / run['frames']:.2f} "
              f"per frame), FAST {run['fast']} ({run['fast'] / run['frames']:.2f} per frame); "
              f"host syncs in the loop {len(run['syncs'])} "
              f"({len(run['syncs']) / run['frames']:.2f} per frame) at {lines}", flush=True)
        print(f"{tag} {name}: loop {run['ms_per_frame']:.3f} ms/frame (the app's rolling "
              f"average, host clock), Stabilizer.stabilize_frame alone {run['ref_ms']:.3f} "
              f"ms/frame (CUDA events, frames 8..{APP_FRAMES - 1}); run wall "
              f"{run['wall']:.2f} s; {card}", flush=True)
    want_written = APP_FRAMES - cfg.future_frames
    for name, run in runs.items():
        if not (run["written"] == run["written_file"] == run["want"] == want_written
                and run["equal"] == want_written):
            raise AssertionError(f"{tag} {name}: written {run['written']} / "
                                 f"{run['written_file']}, equal {run['equal']}")
    if runs["resumed"]["frame_counter"] != 2 * APP_FRAMES:
        raise AssertionError(f"{tag}: resumed counter {runs['resumed']['frame_counter']}")
    for name in ("resumed", "orb-lock"):
        if runs[name]["warp"] != LAUNCHES_PER_FRAME["config3"] * APP_FRAMES:
            raise AssertionError(f"{tag} {name}: {runs[name]['warp']} warp launches")
    read = [x for syncs in factory["carry.mode"] for x in syncs]
    if (len(factory["carry.mode"][0]) != 1 or len(factory["carry.mode"][1]) != 1
            or any("engine/stabilizer.py" not in x for x in read)
            or any(factory["static_mode"])):
        raise AssertionError(f"{tag}: step factories' host syncs {factory}")
    if runs["orb-lock"]["fast"] != FAST_LAUNCHES_PER_FRAME * APP_FRAMES:
        raise AssertionError(f"{tag}: FAST launched {runs['orb-lock']['fast']} times in "
                             f"{APP_FRAMES} orb-lock frames")
    bad = [x for run in runs.values() for x in run["syncs"]
           if "affine_warp.py" in x or "ops/fast.py" in x]
    if bad:
        raise AssertionError(f"{tag}: a kernel wrapper synchronized the host: {bad}")
    return runs


# phase 12: every motion model, the referee and the app's flags, at config
# 1's size (1080x1920 frames, working height 360, window 30 + 1 + 15)
MODEL_FRAMES = 32        # GLOBAL_SMOOTHING frames per motion model (12a, 12b)
REFEREE_FRAMES = 24      # frames per referee configuration (12c)
APP_FLAG_FRAMES = 60     # app frames per flag (12d): 15 written past the 45-frame buffer
STEADY_FROM = 8          # frames before the timed, sync-checked steady ones
MODEL_PATHS = {"similarity": "config1", "affine": "config1", "homography": "config1_lk_only"}
# the referee's named host stages: the host-estimator split and host GFTT
# (engine/stabilizer.py, Stabilizer._host_motion / _inject_host_corners) and
# cv2exact GFTT's fixpoint check (ops/gftt.py, _greedy_cv2exact)
REFEREE_HOST_STAGES = ("engine/stabilizer.py", "ops/gftt.py")


def quality_of(frames, traj, outs, est, cfg) -> dict:
    """Corner drift of the estimated inter-frame transforms ``est`` (frames
    1 ..) against the analytic motion, and the jitter of the stabilized
    ``outs`` against the raw frames they present (from frame 2 on)."""
    from video_stabilization_tpu_torch.sim import inter_frame_homography

    n = len(frames)
    wh, ww = cfg.working_size
    hf, wf = cfg.frame_height, cfg.frame_width
    delay = cfg.future_frames
    traj = traj.to("cpu")
    hs_est = [h.double().cpu().numpy() for h in est[1:n]]
    hs_true = [inter_frame_homography(traj[i], traj[i + 1], wh, ww).double().numpy()
               for i in range(n - 1)]
    crop = (slice(hf // 4, 3 * hf // 4), slice(wf // 4, 3 * wf // 4))
    j_raw = jitter(frames[2:n - delay], crop)
    j_out = jitter(torch.stack(outs[2 + delay:n]), crop)
    return {"drift": corner_drift(hs_est, hs_true, ww, wh), "j_raw": j_raw,
            "j_out": j_out, "ratio": j_out / j_raw}


def phase_models(cfg, seed: int, dev, card: str, stream: dict) -> dict:
    """Phase 12a-b: every motion model at config 1's size.  12a: the first
    MODEL_FRAMES frames of the config-1 slice's footage in GLOBAL_SMOOTHING
    through ``Stabilizer.stabilize_frame`` with ``motion_model``
    similarity, affine and homography: warp launches per frame (5 / 5 / 4:
    the homography model warps its output by ``warp_perspective``), host
    syncs of one steady frame, corner drift against the analytic motion,
    jitter, ms/frame and device events per frame.  12b: the offline chunk
    (K = OFFLINE_CHUNK) with affine and with homography over the same
    frames: launches per chunk (5 and 4), host syncs of the warm-up chunk,
    outputs against 12a's streaming run frame by frame."""
    import dataclasses

    from video_stabilization_tpu_torch.config import StabilizationMode
    from video_stabilization_tpu_torch.engine import Stabilizer, init_carry, make_offline_fn
    from video_stabilization_tpu_torch.ops import affine_warp as aw
    from video_stabilization_tpu_torch.utils import prng

    mode = StabilizationMode.GLOBAL_SMOOTHING
    all_frames, traj = stream["footage"]
    frames = all_frames[:MODEL_FRAMES]
    counter = aw.fallback_counter(dev)
    size = (f"{cfg.frame_height}x{cfg.frame_width} -> working "
            f"{cfg.working_size[0]}x{cfg.working_size[1]}")
    runs = {}
    for model, path in MODEL_PATHS.items():
        mcfg = dataclasses.replace(cfg, ransac=dataclasses.replace(cfg.ransac,
                                                                   motion_model=model))
        stab = Stabilizer(mcfg, mode, seed=seed, device=dev)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        counter.zero_()
        aw.launches = 0
        outs, est, syncs = [], [], []
        for i, f in enumerate(frames):
            if i == STEADY_FROM:
                torch.cuda.synchronize()
                ev0.record()
            if i == STEADY_FROM - 1:
                out, syncs = count_syncs(lambda: stab.stabilize_frame(f))
            else:
                out = stab.stabilize_frame(f)
            outs.append(out)
            est.append(stab.carry.transforms[-1].clone())
        ev1.record()
        torch.cuda.synchronize()
        launches, fallbacks = aw.launches, int(counter)
        ms_frame = ev0.elapsed_time(ev1) / (MODEL_FRAMES - STEADY_FROM)
        events = device_events(lambda: stab.stabilize_frame(frames[-1]))
        q = quality_of(frames, traj, outs, est, mcfg)
        per_frame = LAUNCHES_PER_FRAME[path]
        print(f"models {model}: {MODEL_FRAMES} GLOBAL_SMOOTHING frames {size}; warp launches {launches} ({launches / MODEL_FRAMES:.2f}/frame, "
              f"want {per_frame}), warps outside the envelope {fallbacks} (device count), "
              f"envelope violations {int(stab.carry.envelope_violations)}", flush=True)
        print(f"models {model}: inter-frame corner drift {q['drift']:.4f} px (< {DRIFT_TOL}); "
              f"jitter raw {q['j_raw']:.3f} smoothed {q['j_out']:.3f} (ratio "
              f"{q['ratio']:.3f} < {SMOOTH_JITTER}); {ms_frame:.3f} ms/frame (CUDA events, "
              f"{MODEL_FRAMES - STEADY_FROM} steady frames); {events} device events per frame "
              f"(torch.profiler); {card}", flush=True)
        report_syncs(f"models {model}", syncs)
        if launches != per_frame * MODEL_FRAMES:
            raise AssertionError(f"models {model}: {launches} warp launches")
        if syncs:
            raise AssertionError(f"models {model}: the step synchronized the host: {syncs}")
        if not (q["drift"] < DRIFT_TOL and q["ratio"] < SMOOTH_JITTER):
            raise AssertionError(f"models {model}: outside the slice's bounds: {q}")
        runs[model] = {"launches": launches, "frames": MODEL_FRAMES, "ms_frame": ms_frame,
                       "syncs": len(syncs), "events_per_frame": events, **q}
        if model != "similarity":
            runs[model]["outs"] = outs
        del stab, outs

    # 12b: the offline chunk with the affine and the homography model
    k = OFFLINE_CHUNK
    for model in ("affine", "homography"):
        ocfg = dataclasses.replace(cfg, static_mode=int(mode),
                                   ransac=dataclasses.replace(cfg.ransac, motion_model=model))
        step = make_offline_fn(ocfg)
        carry = init_carry(ocfg, int(mode), prng.key(seed), dev)
        per_chunk = BATCHED_LAUNCHES - (model == "homography")
        aw.launches = 0
        outs = []
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        for c, i in enumerate(range(0, MODEL_FRAMES, k)):
            if c == 0:
                (carry, (out, _)), syncs = count_syncs(lambda: step(carry, frames[i:i + k]))
                torch.cuda.synchronize()
                ev0.record()
            else:
                carry, (out, _) = step(carry, frames[i:i + k])
            outs.append(out)
        ev1.record()
        torch.cuda.synchronize()
        launches = aw.launches
        n_chunks = MODEL_FRAMES // k
        ms_frame = ev0.elapsed_time(ev1) / (MODEL_FRAMES - k)
        diff = (torch.cat(outs).to(torch.int16)
                - torch.stack(runs[model].pop("outs")).to(torch.int16)).abs()
        differ = float((diff > 0).float().mean((1, 2, 3)).max())
        off_more = float((diff > 1).float().mean((1, 2, 3)).max())
        print(f"models offline {model}: {MODEL_FRAMES} frames in chunks of {k}; warp launches "
              f"{launches} ({per_chunk}/chunk); vs the streaming run per frame at most "
              f"{differ:.5f} of pixels differ (<= {OFFLINE_DIFFER}), {off_more:.6f} by more "
              f"than one level (<= {OFFLINE_OFF_BY_MORE}); {ms_frame:.3f} ms/frame (CUDA "
              f"events, the chunks after the warm-up one); {card}", flush=True)
        report_syncs(f"models offline {model}", syncs, "chunk (the warm-up one, untimed)")
        if launches != per_chunk * n_chunks or syncs:
            raise AssertionError(f"models offline {model}: {launches} launches, syncs {syncs}")
        if not (differ <= OFFLINE_DIFFER and off_more <= OFFLINE_OFF_BY_MORE):
            raise AssertionError(f"models offline {model}: outputs differ from streaming: "
                                 f"{differ}, {off_more}")
        runs[f"offline_{model}"] = {"launches": launches, "frames": MODEL_FRAMES,
                                    "ms_frame": ms_frame, "syncs": len(syncs)}
        del outs, diff
    return runs


def phase_referee(cfg, seed: int, dev, card: str, stream: dict) -> dict:
    """Phase 12c: the reference-compat referee at config 1's size, the first
    REFEREE_FRAMES frames of the config-1 slice's footage (on the card)
    through ``Stabilizer.stabilize_frame`` in GLOBAL_SMOOTHING:
    ``bench.py::compat_drift``'s configuration (reference_compat, cv2exact
    LK, host GFTT of 1300 corners, cv2exact RANSAC: the host-estimator
    split) and ``production_drift``'s (reference_compat alone: cv2's exact
    corner list on the card).  Per configuration: corner drift against the
    analytic motion, warp launches per frame (1 and 5), host reads and host
    syncs per steady frame by source line (all in the named host stages),
    ms/frame (host clock: the host stages run there), and the exact u8
    gray on the card against the same function on this machine's CPU."""
    import dataclasses

    from video_stabilization_tpu_torch.config import (
        GFTTConfig, LKConfig, RansacConfig, StabilizationMode)
    from video_stabilization_tpu_torch.engine import Stabilizer
    from video_stabilization_tpu_torch.ops import affine_warp as aw
    from video_stabilization_tpu_torch.ops.image import gray_u8_cv2exact

    all_frames, traj = stream["footage"]
    frames = all_frames[:REFEREE_FRAMES]
    wh, ww = cfg.working_size
    gray_equal = sum(torch.equal(gray_u8_cv2exact(f, wh, ww).cpu(),
                                 gray_u8_cv2exact(f.cpu(), wh, ww)) for f in frames)
    plans = {
        "compat_drift": (dataclasses.replace(
            cfg, reference_compat=True, lk=LKConfig(method="cv2exact"),
            gftt=GFTTConfig(max_features=1300, selection="host"),
            ransac=RansacConfig(method="cv2exact"),
            static_mode=int(StabilizationMode.GLOBAL_SMOOTHING)), "output_only"),
        "production_drift": (dataclasses.replace(cfg, reference_compat=True), "config1"),
    }
    runs = {}
    for name, (rcfg, path) in plans.items():
        stab = Stabilizer(rcfg, StabilizationMode.GLOBAL_SMOOTHING, seed=seed, device=dev)
        aw.launches = 0
        outs, est, syncs = [], [], []
        reads0 = 0
        for i, f in enumerate(frames):
            if i == STEADY_FROM:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                reads0 = stab.host_reads
            if i >= STEADY_FROM:
                out, caught = count_syncs(lambda: stab.stabilize_frame(f))
                syncs += caught
            else:
                out = stab.stabilize_frame(f)
            outs.append(out)
            est.append(stab.carry.transforms[-1].clone())
        torch.cuda.synchronize()
        steady = REFEREE_FRAMES - STEADY_FROM
        ms_frame = 1e3 * (time.perf_counter() - t0) / steady
        launches = aw.launches
        q = quality_of(frames, traj, outs, est, rcfg)
        named = {}
        for x in syncs:
            named[x] = named.get(x, 0) + 1
        reads = (stab.host_reads - reads0) / steady
        per_frame = LAUNCHES_PER_FRAME[path]
        print(f"referee {name}: {REFEREE_FRAMES} frames {cfg.frame_height}x{cfg.frame_width} "
              f"-> working {wh}x{ww}; warp launches {launches} ({launches / REFEREE_FRAMES:.2f}/frame, want {per_frame}); "
              f"inter-frame corner drift {q['drift']:.4f} px (< {DRIFT_TOL}); jitter ratio "
              f"{q['ratio']:.3f}; last inliers {int(stab.carry.last_inliers)}", flush=True)
        print(f"referee {name}: per steady frame {reads:.2f} host reads "
              f"(Stabilizer.host_reads) and {len(syncs) / steady:.2f} host syncs under "
              f"set_sync_debug_mode('warn'), by source line {named}; {ms_frame:.3f} ms/frame "
              f"(host clock, {steady} steady frames, the sync check on); exact u8 gray on the "
              f"card equal to the CPU's on {gray_equal} of {REFEREE_FRAMES} frames; {card}",
              flush=True)
        stray = [x for x in syncs if not any(h in x for h in REFEREE_HOST_STAGES)]
        if launches != per_frame * REFEREE_FRAMES:
            raise AssertionError(f"referee {name}: {launches} warp launches")
        if stray:
            raise AssertionError(f"referee {name}: syncs outside the named host stages: {stray}")
        if not q["drift"] < DRIFT_TOL:
            raise AssertionError(f"referee {name}: corner drift {q['drift']}")
        runs[name] = {"launches": launches, "frames": REFEREE_FRAMES, "ms_frame": ms_frame,
                      "reads_per_frame": reads, "syncs_per_frame": len(syncs) / steady,
                      "syncs_by_line": named, **q}
        del stab, outs
    if gray_equal != REFEREE_FRAMES:
        raise AssertionError(f"referee: the card's exact gray differs on "
                             f"{REFEREE_FRAMES - gray_equal} frames")
    return runs


def phase_plain_ops(dev, rng, card: str) -> dict:
    """Phase 12e: the device time of the plain PyTorch ops that the new
    paths run outside the warp kernel, at the main path's shapes:
    ``warp_perspective`` of a 1080x1920x3 frame (the homography model's
    output warp), ``warp_affine_shear`` and ``copy_feathered`` of one (the
    trail), the DLT homography fit and the affine fit of 1280
    correspondences (the homography model's eigenvector by repeated
    squaring), one per-point patch extraction of cv2exact LK (1300 windows
    of 21x21 at 360x640), and, with their host reads, cv2exact LK over four
    levels, cv2's exact corner list and its greedy fixpoint alone (6144
    candidates at 360x640).  CUDA-graph replay where the op reads nothing
    back, else CUDA events around back-to-back calls; device events per
    call by ``torch.profiler``."""
    from video_stabilization_tpu_torch.config import GFTTConfig, LKConfig
    from video_stabilization_tpu_torch.models import fit_affine_masked, fit_homography_dlt
    from video_stabilization_tpu_torch.ops import gftt
    from video_stabilization_tpu_torch.ops.compositing import copy_feathered
    from video_stabilization_tpu_torch.ops.image import gray_u8_cv2exact
    from video_stabilization_tpu_torch.ops.lk import _extract_patches, lk_track, reflect_pad
    from video_stabilization_tpu_torch.ops.pyramid import build_pyramid
    from video_stabilization_tpu_torch.ops.warp import warp_affine_shear, warp_perspective
    from video_stabilization_tpu_torch.sim import (
        DEFAULT_APP_PARAMS, make_default_texture, render_frame)

    tex = torch.from_numpy(make_default_texture(np.random.default_rng(0), 512)).to(dev)
    frame = render_frame(tex, DEFAULT_APP_PARAMS, 1080, 1920)
    ff = frame.float()
    border = 0.5 * ff.mean((0, 1))
    h = torch.from_numpy(rigid(2.0, 3.5, -2.25)).to(dev)
    hp = h.clone()
    hp[2, 0], hp[2, 1] = 1e-5, -2e-5
    gray = gray_u8_cv2exact(frame, 360, 640)
    pyr = build_pyramid(gray, 3)
    pyr2 = build_pyramid(torch.roll(gray, (1, 2), (0, 1)), 3)
    n_pts = 1300
    pts = torch.from_numpy(rng.uniform([12, 12], [628, 348], (n_pts, 2))
                           .astype(np.float32)).to(dev)
    src = torch.from_numpy(rng.uniform(0, 640, (1280, 2)).astype(np.float32)).to(dev)
    dst = src @ h[:2, :2].T + h[:2, 2] + torch.randn(src.shape, device=dev) * 0.3
    w = torch.ones(1280, device=dev)
    padded = reflect_pad(pyr[0], 23)
    resp = gftt.min_eig_response(gray)
    cand = torch.where(resp > 0.01 * resp.max(), gftt._nms3(resp), -torch.inf)
    cand[0, :] = cand[-1, :] = cand[:, 0] = cand[:, -1] = -torch.inf
    top, idx = gftt.top_k_stable(cand.flatten(), 6144)
    cpts = torch.stack([(idx % 640).float(), (idx // 640).float()], -1)
    valid = torch.isfinite(top)
    cv2lk = LKConfig(method="cv2exact")
    exact = GFTTConfig(max_features=1280, selection="cv2exact")
    graph_ops = {
        "warp_perspective 1080x1920x3": lambda: warp_perspective(ff, hp, None, border),
        "warp_affine_shear 1080x1920x3": lambda: warp_affine_shear(ff, h, border),
        "copy_feathered 1080x1920x3": lambda: copy_feathered(ff, ff, h),
        "fit_homography_dlt 1280 points": lambda: fit_homography_dlt(src, dst, w),
        "fit_affine_masked 1280 points": lambda: fit_affine_masked(src, dst, w),
        "cv2exact LK patch extraction 1300 x 21x21": lambda: _extract_patches(
            padded, pts - 10.0 + 23.0, 21),
    }
    event_ops = {
        "cv2exact LK, 4 levels, 1300 points": lambda: lk_track(
            pyr, pyr2, pts, torch.ones(n_pts, dtype=torch.bool, device=dev), cv2lk),
        "cv2exact GFTT 360x640": lambda: gftt.good_features_to_track(gray, exact),
        "greedy fixpoint, 6144 candidates": lambda: gftt._greedy_cv2exact(
            cpts, top, valid, 10.0 * 360 / 720, 1280),
    }
    out = {}
    for name, fn in graph_ops.items():
        ms = device_ms(fn, n=10)
        ev = device_events(fn)
        out[name] = {"device_ms": ms, "events": ev}
        print(f"plain op {name}: {ms:.4f} ms device (CUDA graph of 10 calls), {ev} device "
              f"events per call; {card}", flush=True)
    for name, fn in event_ops.items():
        ms = time_ms(fn, reps=5, inner=2, warmup=1)
        _, syncs = count_syncs(fn)
        ev = device_events(fn)
        out[name] = {"ms": ms, "events": ev, "syncs": len(syncs)}
        print(f"plain op {name}: {ms:.4f} ms per call back to back (CUDA events, host "
              f"included), {ev} device events and {len(syncs)} host syncs per call; {card}",
              flush=True)
    return out


def phase_app_flags(seed: int, dev, card: str) -> dict:
    """Phase 12d: ``cli.app.main --simulator --no-display`` at its defaults
    (720x1280, working height 360, window 60 + 1 + 45) with ``--trail``,
    ``--motion-model homography`` and ``--reference-compat`` in turn,
    APP_FLAG_FRAMES frames each (15 written past the sync buffer).  Each
    file against ``Stabilizer.stabilize_frame`` of that configuration on
    the same simulator frames: equal for the motion model and the referee,
    and for the trail every composite differs from the plain output.  Warp
    launches and host syncs per frame in the loop."""
    import dataclasses
    import os
    import shutil
    import tempfile

    from video_stabilization_tpu_torch.cli import app
    from video_stabilization_tpu_torch.config import StabilizationMode, StabilizerConfig
    from video_stabilization_tpu_torch.engine import Stabilizer
    from video_stabilization_tpu_torch.io import SimulatorSource
    from video_stabilization_tpu_torch.ops import affine_warp as aw

    base = StabilizerConfig(frame_height=720, frame_width=1280, working_height=360,
                            past_frames=60, future_frames=45)
    plans = {
        "trail": (["--trail"], base, "config3", False),
        "homography": (["--motion-model", "homography"],
                       dataclasses.replace(base, ransac=dataclasses.replace(
                           base.ransac, motion_model="homography")), "config1_lk_only", True),
        "compat": (["--reference-compat"], dataclasses.replace(base, reference_compat=True),
                   "config3", True),
    }
    tmp = tempfile.mkdtemp(prefix="smoke_app12_")
    runs = {}
    try:
        for name, (extra, cfg, path, equal) in plans.items():
            out = os.path.join(tmp, f"{name}.y4m")
            argv = ["--simulator", "--no-display", "--max-frames", str(APP_FLAG_FRAMES),
                    "--output", out] + extra
            aw.launches = 0
            app.loop_sync_debug = "warn"
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                try:
                    app.main(argv, device=dev)
                finally:
                    app.loop_sync_debug = None
            run = dict(app.last_run, warp=aw.launches, syncs=loop_syncs(caught))
            got = y4m_raw_frames(out)
            src = SimulatorSource(device=dev)
            stab = Stabilizer(cfg, StabilizationMode.GLOBAL_SMOOTHING, device=dev)
            ref = [stab.stabilize_frame(src.read_tensor()) for _ in range(APP_FLAG_FRAMES)]
            want = encoded([f.cpu().numpy() for f in ref[cfg.future_frames:]], False)
            run["same"] = sum(g == w_ for g, w_ in zip(got, want))
            run["written_file"] = len(got)
            run["want"] = len(want)
            if name == "trail":
                d = [np.abs(np.frombuffer(g, np.uint8).astype(np.int16)
                            - np.frombuffer(w_, np.uint8).astype(np.int16)).mean()
                     for g, w_ in zip(got, want)]
                run["mean_abs_vs_plain"] = float(np.mean(d))
            lines = sorted(set(run["syncs"]))
            shown = " ".join(os.path.basename(a) if a.startswith(tmp) else a for a in argv)
            print(f"app12 {name}: cli.app.main {shown}: "
                  f"{run['frames']} frames, {run['written']} written ({len(got)} in the file); "
                  f"equal to the Stabilizer's outputs on {run['same']} of {len(want)}"
                  + (f" (mean |trail - plain| {run['mean_abs_vs_plain']:.2f} levels)"
                     if name == "trail" else "")
                  + f"; warp launches {run['warp']} ({run['warp'] / run['frames']:.2f}/frame); "
                  f"host syncs in the loop {len(run['syncs'])} "
                  f"({len(run['syncs']) / run['frames']:.2f}/frame) at {lines}; loop "
                  f"{run['ms_per_frame']:.3f} ms/frame; {card}", flush=True)
            want_written = APP_FLAG_FRAMES - cfg.future_frames
            if not (run["written"] == len(got) == len(want) == want_written):
                raise AssertionError(f"app12 {name}: written {run['written']} / {len(got)}")
            if run["same"] != (want_written if equal else 0):
                raise AssertionError(f"app12 {name}: {run['same']} frames equal the "
                                     f"Stabilizer's")
            if run["warp"] != LAUNCHES_PER_FRAME[path] * APP_FLAG_FRAMES:
                raise AssertionError(f"app12 {name}: {run['warp']} warp launches")
            bad = [x for x in run["syncs"] if "affine_warp.py" in x]
            if bad:
                raise AssertionError(f"app12 {name}: the warp wrapper synchronized: {bad}")
            run["path"] = path
            runs[name] = run
            del ref, stab
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--lock-frames", type=int, default=16)
    ap.add_argument("--orb-frames", type=int, default=64)
    ap.add_argument("--mesh-only", action="store_true",
                    help="phases 1, 2, 13 and 14's mesh part alone (13's serving part on "
                         "fresh inputs of "
                         f"{MESH_ONLY_SERVE_FRAMES} frames): the check of a host with "
                         "several cards")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script runs "
              "only on a GPU", file=sys.stderr)
        return 2
    # imported after the device check so a bare copy of this script fails there
    from video_stabilization_tpu_torch.config import (
        ECCConfig, StabilizationMode, StabilizerConfig)
    from video_stabilization_tpu_torch.ops import affine_warp as aw
    from video_stabilization_tpu_torch.ops import fast, y4m
    from video_stabilization_tpu_torch.utils import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = nvidia_smi_line()
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda}; {card}",
          flush=True)

    t0 = time.perf_counter()
    names = ("affine_warp", "fast_score", "y4m_encode")
    cuda_build.build_kernels(names)
    aw._kernel_lib()
    fast._kernel_lib()
    y4m._kernel_lib()
    print(f"build: {len(names)} kernels in {time.perf_counter() - t0:.2f} s ("
          + ", ".join(f"{n} nvcc {cuda_build.build_seconds[n]:.2f} s" for n in names)
          + ")", flush=True)

    mesh = smoke_mesh()
    n_cards = torch.cuda.device_count()
    cards = f"{card}, {n_cards} card(s)"      # beside phase 13's numbers
    print(f"mesh of phase 13: [{', '.join(map(str, mesh))}] "
          + ("(one slot per card)" if n_cards >= 2 else "(two slots on the one card)")
          + f"; torch.cuda.device_count() = {n_cards}", flush=True)

    rng = np.random.default_rng(args.seed)
    cfg5 = StabilizerConfig(frame_height=1080, frame_width=1920, working_height=360,
                            past_frames=30, future_frames=15)
    if args.mesh_only:
        if n_cards >= 2:
            phase_last_card(mesh[-1], rng)
        phase_sharded(cfg5, args.seed, mesh, cards)
        phase_mixed_mesh(cfg5, args.seed, mesh, cards)
        serve_mesh_only(mesh, cards)
        print(nvidia_smi_line(), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    kern = phase_kernel(dev, rng)
    kern.update(phase_batched_kernel(dev, rng, kern.pop("times"),
                                     {**BATCHED_PATHS, **sharded_paths(len(mesh))}))
    last_err = phase_last_card(mesh[-1], rng) if n_cards >= 2 else 0.0
    cfg3 = StabilizerConfig(frame_height=720, frame_width=1280, working_height=360,
                            past_frames=30, future_frames=15)
    frame, _ = render_clip(cfg3, 1, args.seed, dev)
    fk = phase_fast_kernel(dev, rng, orb_levels(frame[0], cfg3))
    cfg1 = StabilizerConfig(frame_height=1080, frame_width=1920, working_height=360,
                            past_frames=30, future_frames=15)
    sl = phase_slice(cfg1, args.frames, args.lock_frames, args.seed, dev, card)
    orb = phase_lock(cfg3, StabilizationMode.ORB_FULL_LOCK, "config3", args.orb_frames,
                     args.seed, dev, card)
    cfg4 = StabilizerConfig(frame_height=1080, frame_width=1920, working_height=360,
                            past_frames=30, future_frames=15,
                            ecc=ECCConfig(enabled=True, max_iters=ECC_ITERS))
    sift = phase_lock(cfg4, StabilizationMode.SIFT_FULL_LOCK, "config4", SIFT_FRAMES,
                      args.seed, dev, card)
    phase_ecc_kernel_vs_plain(cfg4, args.seed, dev)
    phase_reference(args.seed, dev)
    off1 = phase_offline(cfg1, StabilizationMode.GLOBAL_SMOOTHING, "config1", args.frames,
                         args.seed, dev, card, sl)
    off3 = phase_offline(cfg3, StabilizationMode.ORB_FULL_LOCK, "config3", args.orb_frames,
                         args.seed, dev, card, orb)
    off4 = phase_offline(cfg4, StabilizationMode.SIFT_FULL_LOCK, "config4",
                         SIFT_OFFLINE_FRAMES, args.seed, dev, card, sift,
                         f" (the first {SIFT_OFFLINE_FRAMES} of the slice's {SIFT_FRAMES}: "
                         "a depth cut that keeps the smoke within its time)")
    models = phase_models(cfg1, args.seed, dev, card, sl)
    referee = phase_referee(cfg1, args.seed, dev, card, sl)
    phase_plain_ops(dev, rng, card)
    for run in (sl, orb, sift):       # the streaming slices' footage is done with
        run.pop("footage")
        run.pop("outs")
    streams = phase_streams(cfg5, args.seed, dev, card)
    sharded = phase_sharded(cfg5, args.seed, mesh, cards)
    mixed = phase_mixed(cfg5, args.seed, dev, card, streams)
    mixed_mesh = phase_mixed_mesh(cfg5, args.seed, mesh, cards)
    served = phase_serve(args.seed, dev, card, mesh, cards)
    y4m_times = phase_y4m_kernel(dev, rng, card, served)
    apps = phase_app(args.seed, dev, card)
    app_flags = phase_app_flags(args.seed, dev, card)

    # launches: each main path's run, counted from 0 just before it; ms,
    # plain_ms and bound_ms are per frame.  The top-level numbers of a kernel
    # are those of the first path that runs it, "paths" holds each path's.
    print(f"host syncs per steady frame: config 1 {sl['syncs']}, config 3 {orb['syncs']}, "
          f"config 4 {sift['syncs']}; per offline chunk (the warm-up one): {off1['syncs']}, "
          f"{off3['syncs']}, {off4['syncs']}; config 5, batched step and chunk: "
          f"{streams['TRANSLATION_LOCK']['syncs']} (TRANSLATION_LOCK), "
          f"{streams['GLOBAL_SMOOTHING']['syncs']} (GLOBAL_SMOOTHING), over the mesh 0 "
          f"(phase 13 raises otherwise); in mixed modes per call {mixed['syncs']} (the mode "
          f"read), over the mesh one per slot (phase 14 raises otherwise); serving loop "
          f"{served['syncs']} (and one event wait per chunk, the drain's); app loop per frame "
          + ", ".join(f"{k} {len(r['syncs']) / r['frames']:.2f}" for k, r in apps.items()),
          flush=True)
    print("host syncs, phase 12: per steady frame of similarity / affine / homography "
          + " / ".join(str(models[m]["syncs"]) for m in MODEL_PATHS)
          + f"; per offline chunk (the warm-up one) {models['offline_affine']['syncs']} "
          f"(affine), {models['offline_homography']['syncs']} (homography); the referee "
          "per steady frame, all in its named host stages: "
          + ", ".join(f"{k} {r['syncs_per_frame']:.2f} ({r['reads_per_frame']:.2f} host reads)"
                      for k, r in referee.items())
          + "; app loop per frame "
          + ", ".join(f"{k} {len(r['syncs']) / r['frames']:.2f}" for k, r in app_flags.items()),
          flush=True)
    def counted(launches: int, run: dict) -> dict:
        return {"launches": launches, "launches_per_frame": launches / run["frames"]}

    warp_paths = {
        "config1": {**counted(sl["launches"], sl), **kern["config1"]},
        "config3": {**counted(orb["warp_launches"], orb), **kern["config3"]},
        "config4": {**counted(sift["warp_launches"], sift), **kern["config4"]},
        "offline_config1": {**counted(off1["launches"], off1), **kern["offline_config1"]},
        "offline_config3": {**counted(off3["launches"], off3), **kern["offline_config3"]},
        "offline_config4": {**counted(off4["launches"], off4), **kern["offline_config4"]},
        # per batched frame: one frame of each of the 8 streams
        "config5": {**counted(streams["step"]["launches"], streams["step"]),
                    **kern["config5"]},
        "offline_config5": {**counted(streams["offline"]["launches"], streams["offline"]),
                            **kern["offline_config5"]},
        # per batched frame of 8 streams; the serving chunk is config 5's
        # offline chunk
        "serve": {**counted(served["launches"], served), **kern["offline_config5"]},
        # phase 13: per batched frame of the 8 streams over the mesh, each
        # slot launching its streams' warps
        "sharded_config5": {**counted(sharded["step"]["launches"], sharded["step"]),
                            **kern["sharded_config5"]},
        "offline_sharded_config5": {**counted(sharded["offline"]["launches"],
                                              sharded["offline"]),
                                    **kern["offline_sharded_config5"]},
        "serve_sharded": {**counted(served["sharded"]["launches"], served["sharded"]),
                          **kern["offline_sharded_config5"]},
        # phase 14: per batched frame of the 8 streams in mixed modes, on one
        # card and over the mesh
        "mixed_config5": {**counted(mixed["launches"], mixed), **kern["config5"]},
        "mixed_sharded_config5": {**counted(mixed_mesh["launches"], mixed_mesh),
                                  **kern["sharded_config5"]},
        # the app's frames are config 3's size (720x1280, working height 360)
        "cli": {**counted(apps["resumed"]["warp"], apps["resumed"]), **kern["config3"]},
        "cli_orb": {**counted(apps["orb-lock"]["warp"], apps["orb-lock"]), **kern["config3"]},
        # phase 12: each motion model at config 1, the offline chunk with the
        # affine and the homography model, the referee, the app's flags
        **{f"config1_{m}": {**counted(models[m]["launches"], models[m]), **kern[path]}
           for m, path in MODEL_PATHS.items()},
        "offline_config1_affine": {**counted(models["offline_affine"]["launches"],
                                             models["offline_affine"]),
                                   **kern["offline_config1"]},
        "offline_config1_homography": {**counted(models["offline_homography"]["launches"],
                                                 models["offline_homography"]),
                                       **kern["offline_config1_lk_only"]},
        "referee_compat_drift": {**counted(referee["compat_drift"]["launches"],
                                           referee["compat_drift"]), **kern["output_only"]},
        "referee_production_drift": {**counted(referee["production_drift"]["launches"],
                                               referee["production_drift"]), **kern["config1"]},
        **{f"cli_{k}": {**counted(r["warp"], r), **kern[r["path"]]}
           for k, r in app_flags.items()}}
    fast_times = {k: fk[k] for k in ("ms", "plain_ms", "device_ms", "bound_ms", "bound_by")}
    fast_paths = {"config3": {**counted(orb["fast_launches"], orb), **fast_times},
                  "offline_config3": {**counted(off3["fast_launches"], off3), **fast_times},
                  "serve_orb": {**counted(served["fast_launches"],
                                          {"frames": served["fast_frames"]}), **fast_times},
                  "serve_orb_sharded": {**counted(served["sharded"]["fast_launches"],
                                                  {"frames": served["sharded"]["fast_frames"]}),
                                        **fast_times},
                  "cli_orb": {**counted(apps["orb-lock"]["fast"], apps["orb-lock"]),
                              **fast_times},
                  "mixed_config5": {**counted(mixed["fast_launches"], mixed), **fast_times},
                  "mixed_sharded_config5": {**counted(mixed_mesh["fast_launches"], mixed_mesh),
                                            **fast_times}}
    record = {"kernels": [{
        "name": "affine_warp",
        "route": "cuda",
        "source": "video_stabilization_tpu_torch/csrc/affine_warp.cu",
        "replaces": "video_stabilization_tpu/ops/pallas_warp.py:65",
        **warp_paths["config1"],
        "max_abs_err": max(kern["max_abs_err"], kern["max_abs_err_batched"], last_err),
        "library_ms": None,
        "paths": warp_paths,
    }, {
        "name": "fast_levels",
        "route": "cuda",
        "source": "video_stabilization_tpu_torch/csrc/fast_score.cu",
        "replaces": "video_stabilization_tpu/ops/fast.py:47",
        **fast_paths["config3"],
        "max_abs_err": max(fk["max_abs_err"], last_err),
        "library_ms": None,
        "paths": fast_paths,
    }, {
        "name": "y4m_encode",
        "route": "cuda",
        "source": "video_stabilization_tpu_torch/csrc/y4m_encode.cu",
        "replaces": None,       # the JAX package encodes its outputs on the host
        **counted(served["y4m_launches"], served), **y4m_times["c420"],
        "library_ms": None,
        "paths": {"serve": {**counted(served["y4m_launches"], served), **y4m_times["c420"]},
                  "serve_sharded": {**counted(served["sharded"]["y4m_launches"],
                                              served["sharded"]), **y4m_times["c420"]},
                  "c444": y4m_times["c444"]},
    }]}
    print(nvidia_smi_line(), flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
