"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--frames N] [--lock-frames N] [--orb-frames N]

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
   (exact), with median CUDA-event times; ``grid_sample`` at 3x1080x1920
   as a yardstick for a one-pass warp of the same bytes;
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
   SIFT_FULL_LOCK with ECC.

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
                               (3, 1080, 1920): 1}}
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
        hinv = _inv3x3(h)
        bt = border if isinstance(border, torch.Tensor) else None
        bs = 0.0 if bt is not None else border
        ms = time_ms(lambda: aw._launch(src, hinv, bt, bs, True))
        dev_ms = device_ms(lambda: aw._launch(src, hinv, bt, bs, True))
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


def report_syncs(tag: str, where: list) -> None:
    names = sorted(set(where))
    print(f"{tag}: {len(where)} synchronizing calls in one steady frame under "
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
            "syncs": len(syncs)}


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
            "frames": n_frames, "ms_frame": ms_frame, "syncs": len(syncs)}


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--lock-frames", type=int, default=16)
    ap.add_argument("--orb-frames", type=int, default=64)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script runs "
              "only on a GPU", file=sys.stderr)
        return 2
    # imported after the device check so a bare copy of this script fails there
    from video_stabilization_tpu_torch.config import (
        ECCConfig, StabilizationMode, StabilizerConfig)
    from video_stabilization_tpu_torch.ops import affine_warp as aw
    from video_stabilization_tpu_torch.ops import fast
    from video_stabilization_tpu_torch.utils import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = nvidia_smi_line()
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda}; {card}",
          flush=True)

    t0 = time.perf_counter()
    names = ("affine_warp", "fast_score")
    cuda_build.build_kernels(names)
    aw._kernel_lib()
    fast._kernel_lib()
    print(f"build: {len(names)} kernels in {time.perf_counter() - t0:.2f} s ("
          + ", ".join(f"{n} nvcc {cuda_build.build_seconds[n]:.2f} s" for n in names)
          + ")", flush=True)

    rng = np.random.default_rng(args.seed)
    kern = phase_kernel(dev, rng)
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

    # launches: each main path's run, counted from 0 just before it; ms,
    # plain_ms and bound_ms are per frame.  The top-level numbers of a kernel
    # are those of the first path that runs it, "paths" holds each path's.
    print(f"host syncs per steady frame: config 1 {sl['syncs']}, config 3 {orb['syncs']}, "
          f"config 4 {sift['syncs']}", flush=True)
    def counted(launches: int, run: dict) -> dict:
        return {"launches": launches, "launches_per_frame": launches / run["frames"]}

    warp_paths = {
        "config1": {**counted(sl["launches"], sl), **kern["config1"]},
        "config3": {**counted(orb["warp_launches"], orb), **kern["config3"]},
        "config4": {**counted(sift["warp_launches"], sift), **kern["config4"]}}
    fast_paths = {"config3": {**counted(orb["fast_launches"], orb),
                              **{k: fk[k] for k in ("ms", "plain_ms", "device_ms",
                                                    "bound_ms", "bound_by")}}}
    record = {"kernels": [{
        "name": "affine_warp",
        "route": "cuda",
        "source": "video_stabilization_tpu_torch/csrc/affine_warp.cu",
        "replaces": "video_stabilization_tpu/ops/pallas_warp.py:65",
        **warp_paths["config1"],
        "max_abs_err": kern["max_abs_err"],
        "library_ms": None,
        "paths": warp_paths,
    }, {
        "name": "fast_levels",
        "route": "cuda",
        "source": "video_stabilization_tpu_torch/csrc/fast_score.cu",
        "replaces": "video_stabilization_tpu/ops/fast.py:47",
        **fast_paths["config3"],
        "max_abs_err": fk["max_abs_err"],
        "library_ms": None,
        "paths": fast_paths,
    }]}
    print(nvidia_smi_line(), flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
