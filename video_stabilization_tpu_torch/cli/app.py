"""The interactive / headless application loop.

Port of ``video_stabilization_tpu/cli/app.py``, which mirrors the
reference's main loop (src/main.cpp:185-260, src/main_utils.cpp): the
input-source factory, window sizing from window seconds x fps, keyboard
mode switching, simulator movement keys, the display sync buffer that
delays the original feed by ``future_frames`` so both views line up
(src/main_utils.cpp:459-493), FPS and camera-pose overlays, "Buffering
frames: k/n" warm-up messages, and headless operation (``--no-display``,
``--output``, ``--max-frames``), ``--checkpoint`` / ``--resume``,
``--stats``, ``--motion-model``, ``--reference-compat`` and ``--trail``
(the reference's dormant feathered trail compositor: each presented frame
blended over a fading background by its stabilizing transform,
``ops/compositing.py``).

The engine runs on the card unless the caller names the CPU (``run(cfg,
device="cpu")``).  A simulator's frames are rendered there and never leave
it; the host reads back an output frame only to write or show it, and
corner lists only for ``--debug-features``.  The trail's background and
transform stay on the device.
"""

from __future__ import annotations

import collections
import os
import sys
import time

import numpy as np
import torch

from video_stabilization_tpu_torch.cli.args import AppConfig, MODE_NAMES, parse_args
from video_stabilization_tpu_torch.config import (
    RansacConfig, StabilizationMode, StabilizerConfig)
from video_stabilization_tpu_torch.io import SimulatorSource, VideoWriter, open_source
from video_stabilization_tpu_torch.utils.timing import StageTimer

# keyboard -> mode (reference: handleStabilizationControls,
# src/main_utils.cpp:371-395)
MODE_KEYS = {
    "x": StabilizationMode.GLOBAL_SMOOTHING,
    "f": StabilizationMode.ACCUMULATED_FULL_LOCK,
    "o": StabilizationMode.ORB_FULL_LOCK,
    "l": StabilizationMode.SIFT_FULL_LOCK,
    "t": StabilizationMode.TRANSLATION_LOCK,
    "r": StabilizationMode.ROTATION_LOCK,
    "g": StabilizationMode.GLOBAL_SMOOTHING,
}
SIM_KEYS = "wsadqec p"

# the last run's summary: frames processed and written, the rolling ms per
# frame of the loop, the frame counter at exit
last_run: dict = {}
# ``torch.cuda.set_sync_debug_mode`` of the frame loop on the card (after
# the set-up, before the checkpoint): "warn" lists every synchronizing call
# the loop makes
loop_sync_debug = None


def _put_text(img, lines, origin=(8, 20)):
    try:
        import cv2
    except Exception:
        return img
    x, y = origin
    for line in lines:
        size, _ = cv2.getTextSize(line, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        cv2.rectangle(img, (x - 2, y - size[1] - 4), (x + size[0] + 2, y + 4),
                      (0, 0, 0), -1)
        cv2.putText(img, line, (x, y), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                    (255, 255, 255), 1, cv2.LINE_AA)
        y += size[1] + 10
    return img


def _host(frame) -> np.ndarray:
    return frame if isinstance(frame, np.ndarray) else frame.cpu().numpy()


def _print_stage_timings(engine_cfg: StabilizerConfig, device) -> None:
    """One-shot per-stage timings in the reference's printTimings taxonomy
    (GFTT / LK / motion fit / warp, src/stabilizer.cpp:982-1009), each
    stage run alone on random input and timed by ``honest_time``."""
    from video_stabilization_tpu_torch.motion.ransac import estimate_similarity_ransac
    from video_stabilization_tpu_torch.ops.affine_warp import warp_affine
    from video_stabilization_tpu_torch.ops.gftt import good_features_to_track
    from video_stabilization_tpu_torch.ops.lk import lk_track
    from video_stabilization_tpu_torch.ops.pyramid import build_pyramid
    from video_stabilization_tpu_torch.utils import prng
    from video_stabilization_tpu_torch.utils.timing import honest_time

    wh, ww = engine_cfg.working_size
    gen = torch.Generator().manual_seed(0)
    gray = (torch.rand((wh, ww), generator=gen) * 255).to(device)
    levels = engine_cfg.lk.pyramid_levels
    pyr = build_pyramid(gray, levels)
    pyr2 = build_pyramid(gray + 1.0, levels)
    c = good_features_to_track(gray, engine_cfg.gftt)
    tr = lk_track(pyr, pyr2, c.points, c.mask, engine_cfg.lk)
    frame = (torch.rand((engine_cfg.frame_height, engine_cfg.frame_width, 3), generator=gen)
             .to(device))
    h = (torch.eye(3) + 1e-3).to(device)
    key = prng.key(1, device)

    print("[stats] standalone stage timings (ms, honest_time):")
    for name, fn, xs in (
        ("goodFeaturesToTrack", lambda g: good_features_to_track(g, engine_cfg.gftt), (gray,)),
        ("calcOpticalFlowPyrLK", lambda a, b, p, m: lk_track(a, b, p, m, engine_cfg.lk),
         (pyr, pyr2, c.points, c.mask)),
        ("estimateAffinePartial2D",
         lambda a, b, m, k: estimate_similarity_ransac(a, b, m, k, engine_cfg.ransac),
         (c.points, tr.points, tr.status, key)),
        ("warpPerspective", lambda f, hh: warp_affine(f, hh, 127.0), (frame, h)),
    ):
        print(f"[stats]   {name:24s} {honest_time(fn, *xs, iters=10):7.2f}")


def main(argv=None, device="cuda") -> int:
    return run(parse_args(argv), device=device)


def run(cfg: AppConfig, device="cuda") -> int:
    """Run the app of ``cfg`` with the engine on ``device`` (the card
    unless the caller names the CPU)."""
    from video_stabilization_tpu_torch.engine import Stabilizer, map_carry, stabilize_step

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"app: device {str(device)!r} requested but CUDA is not available")

    source = open_source(cfg.input_mode, path=cfg.file_path, camera_id=cfg.camera_id,
                         texture=cfg.texture, device=device)
    sim = isinstance(source, SimulatorSource)
    # a simulator frame stays on the device it was rendered on
    read = source.read_tensor if sim else source.read
    fps = source.fps
    fh, fw = source.frame_size

    # window sizing: frames = seconds x fps (reference: src/main.cpp:205-207)
    past = max(0, int(round(cfg.past_window_secs * fps)))
    future = max(0, int(round(cfg.future_window_secs * fps)))
    if past == 0 and future == 0:
        past = 1

    engine_cfg = StabilizerConfig(
        past_frames=past, future_frames=future,
        working_height=cfg.working_height,
        frame_height=fh, frame_width=fw,
        reference_compat=cfg.reference_compat,
        ransac=RansacConfig(motion_model=cfg.motion_model),
    )
    stab = Stabilizer(engine_cfg, StabilizationMode[MODE_NAMES[cfg.mode]], device=device)

    if cfg.resume:
        stab.resume(cfg.resume)
        print(f"[app] resumed engine state from {cfg.resume} "
              f"(frame counter {int(stab.carry.n)})")

    if cfg.stats:
        _print_stage_timings(engine_cfg, device)

    print(f"[app] source: {cfg.input_mode} {fw}x{fh} @ {fps:.1f} fps; engine on {device}")
    print(f"[app] window: past={past} future={future} frames "
          f"(delay {future / fps:.2f}s), working height {cfg.working_height}")
    print("[app] controls: X/G smoothing | F accumulated lock | O ORB lock | "
          "L SIFT lock | T translation lock | R rotation lock | ESC quit")
    if sim:
        print("[app] simulator: W/S/A/D move, Q/E roll, SPACE/C up/down, P reset")

    writer = VideoWriter(cfg.output, fps, (fh, fw)) if cfg.output else None

    # --- preview backend selection ------------------------------------------
    # "cv2": HighGUI windows (src/main_utils.cpp:300-325); "term": ANSI
    # truecolor half-blocks and raw-mode key polling (cli/term_display.py),
    # with no OpenCV and no X server
    backend = None
    term_disp = None
    if cfg.display:
        want = cfg.display_backend
        has_x = bool(os.environ.get("DISPLAY")) or sys.platform == "darwin"
        if want in ("auto", "cv2") and has_x:
            # cv2's Qt backend aborts (uncatchable) without an X server;
            # only try when one is reachable
            try:
                import cv2
                cv2.namedWindow("Original Camera Feed", cv2.WINDOW_NORMAL)
                cv2.namedWindow("Stabilized Output", cv2.WINDOW_NORMAL)
                backend = "cv2"
            except Exception as e:
                print(f"[app] cv2 display unavailable ({e})", file=sys.stderr)
        elif want == "cv2" and not has_x:
            print("[app] no $DISPLAY; running headless", file=sys.stderr)
        if backend is None and want in ("auto", "term"):
            from video_stabilization_tpu_torch.cli.term_display import TerminalDisplay

            if want == "term" or TerminalDisplay._is_tty():
                term_disp = TerminalDisplay()
                backend = "term"
        if backend is None and want == "auto":
            print("[app] no display available; running headless", file=sys.stderr)
    display = backend is not None

    # display sync buffer: delay originals so both views align
    # (reference: src/main_utils.cpp:459-493)
    original_buffer: collections.deque = collections.deque()
    trail_bg = None
    timer = StageTimer()
    n = 0
    written = 0
    stats_last = time.perf_counter()
    taxonomy_line = None
    taxonomy_at = 0.0
    t_prev = time.perf_counter()

    def _refresh_taxonomy(frame):
        """In-loop per-stage times of the step (printTimings parity,
        src/stabilizer.cpp:982-1009): a few live steps on a COPY of the
        carry, so the profile does not advance the engine's state, under
        ``utils.stage_profile.profile_stages``."""
        from video_stabilization_tpu_torch.utils.stage_profile import (
            format_taxonomy, profile_stages)

        try:
            f = stab._as_frame(frame)
            carry_copy = map_carry(lambda x: x.clone(), stab.carry)
            n_prof = 4

            def run_steps():
                c = carry_copy
                for _ in range(n_prof):
                    c, _out = stabilize_step(c, f, engine_cfg, stab.mode)

            stage_ms = profile_stages(run_steps, device, n_calls=n_prof)
            return "[stats] in-loop stages: " + format_taxonomy(stage_ms)
        except Exception as e:  # profiling is best-effort
            return f"[stats] in-loop stage profile unavailable: {e}"

    debug_syncs = device.type == "cuda" and loop_sync_debug
    if debug_syncs:
        torch.cuda.set_sync_debug_mode(loop_sync_debug)
    try:
        while True:
            if cfg.max_frames is not None and n >= cfg.max_frames:
                break

            key = None
            if backend == "cv2":
                import cv2
                k = cv2.waitKey(1) & 0xFF
                if k == 27:
                    break
                if k != 255:
                    key = chr(k).lower()
            elif backend == "term":
                k = term_disp.poll_key()
                if k == "\x1b":
                    break
                if k:
                    key = k.lower()

            if key is not None and key in MODE_KEYS:
                stab.set_stabilization_mode(MODE_KEYS[key])
                print(f"[app] mode -> {MODE_KEYS[key].name}")
            elif key is not None and key in SIM_KEYS and sim:
                source.move(key)

            frame = read()
            if frame is None:
                print("[app] end of stream")
                break

            out = stab.stabilize_frame(frame)
            if cfg.debug_features:
                # corners detected on THIS frame, kept with it in the sync
                # buffer so the overlay drawn on the delayed original matches
                # the displayed image
                dbg = (stab.carry.corners_prev.cpu().numpy(),
                       stab.carry.corners_mask.cpu().numpy())
            else:
                dbg = None
            original_buffer.append((frame, dbg))
            n += 1

            now = time.perf_counter()
            timer.record("frame", (now - t_prev) * 1000.0)
            t_prev = now

            if cfg.stats and (time.perf_counter() - stats_last) >= 1.0:
                stats_last = time.perf_counter()
                avg_ms = timer.averages().get("frame", float("nan"))
                cur_mode = StabilizationMode(stab.mode)
                line = (f"[stats] fps {1000.0 / max(avg_ms, 1e-3):6.1f} | "
                        f"step {avg_ms:6.1f} ms | "
                        f"RANSAC inliers {int(stab.carry.last_inliers):4d}")
                if cur_mode in (StabilizationMode.ORB_FULL_LOCK,
                                StabilizationMode.SIFT_FULL_LOCK):
                    # good-match telemetry of the registration lock
                    # (reference logs per frame, src/stabilizer.cpp:667-702)
                    line += f" | lock matches {int(stab.carry.last_lock_matches):4d}"
                print(line + f" | mode {cur_mode.name}")
                # per-stage breakdown, re-sampled every 10 s (profiling a few
                # steps costs a few frames of work)
                if time.perf_counter() - taxonomy_at > 10.0:
                    taxonomy_line = _refresh_taxonomy(frame)
                    taxonomy_at = time.perf_counter()
                if taxonomy_line:
                    print(taxonomy_line)

            if len(original_buffer) <= future:
                print(f"Buffering frames: {len(original_buffer)}/{future + 1}")
                continue
            delayed, delayed_dbg = original_buffer.popleft()
            if cfg.trail:
                # the presentation frame (the delayed original) blended over
                # the fading background by this step's transform, rescaled
                # to full resolution
                from video_stabilization_tpu_torch.ops.compositing import copy_feathered

                if trail_bg is None:
                    trail_bg = torch.zeros((fh, fw, 3), dtype=torch.float32, device=device)
                h_full = stab.carry.last_h.clone()
                h_full[:2, 2] = h_full[:2, 2] / engine_cfg.scale_factor
                trail_bg = copy_feathered(stab._as_frame(delayed), trail_bg, h_full)
                out = trail_bg.clamp(0, 255).to(torch.uint8)
            if writer is None and not display:
                continue
            out_np = out.cpu().numpy()
            if writer is not None:
                writer.write(out_np)
                written += 1

            if display:
                fps_now = 1000.0 / max(timer.averages().get("frame", 1.0), 1e-3)
                overlay = [f"FPS: {fps_now:.1f}"]
                if sim:
                    overlay += source.pose_text()
                if backend == "cv2":
                    import cv2
                    disp = _put_text(_host(delayed).copy(), overlay)
                else:
                    disp = _host(delayed).copy()
                if cfg.debug_features and delayed_dbg is not None:
                    # tracked-corner overlay (the reference's "features"
                    # debug window, src/stabilizer.cpp:628-634)
                    pts, msk = delayed_dbg
                    inv_s = 1.0 / engine_cfg.scale_factor
                    for x, y in pts[msk][:400]:
                        px, py = int(x * inv_s), int(y * inv_s)
                        if backend == "cv2":
                            cv2.circle(disp, (px, py), 3, (0, 255, 0), 1)
                        else:
                            disp[max(0, py - 1):py + 2, max(0, px - 1):px + 2] = (0, 255, 0)
                if backend == "cv2":
                    cv2.imshow("Original Camera Feed", disp)
                    cv2.imshow("Stabilized Output", out_np)
                else:
                    term_disp.show([
                        (" | ".join(overlay) + "  [original]", disp),
                        (f"mode {StabilizationMode(stab.mode).name}  [stabilized]", out_np),
                    ])
    finally:
        if debug_syncs:
            torch.cuda.set_sync_debug_mode("default")
        source.close()
        if writer is not None:
            writer.close()
        if cfg.checkpoint:
            from video_stabilization_tpu_torch.engine.checkpoint import save_carry

            save_carry(cfg.checkpoint, stab.carry)
            print(f"[app] saved engine state to {cfg.checkpoint}")
        if backend == "cv2":
            try:
                import cv2
                cv2.destroyAllWindows()
            except Exception:
                pass
        elif backend == "term":
            term_disp.close()

    avg = timer.averages().get("frame", float("nan"))
    last_run.clear()
    last_run.update(frames=n, written=written, ms_per_frame=avg,
                    frame_counter=int(stab.carry.n))
    print(f"[app] processed {n} frames, avg {avg:.1f} ms/frame")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
