"""CLI argument parsing with the reference's semantics and constraints.

Port of ``video_stabilization_tpu/cli/args.py`` (its own copy: the same
flags, defaults, checks and ``AppConfig`` fields).  It mirrors the
reference's parseCommandLineArgs (src/main_utils.cpp:35-236):
- exactly one of --simulator / --camera / --file is required;
- --past-window / --future-window in seconds (>= 0), defaults 2.0 / 1.5;
- --working-height in (90, 2160], default 360;
- total window must be at least MIN_STABILIZER_WINDOW_SECONDS = 0.030 s
  (src/main_utils.cpp:10, :209-216);
- unknown arguments are rejected.

Additions the GUI-only reference lacks: --output (headless sink),
--max-frames, --mode (initial stabilization mode), --texture (simulator
floor image), --no-display.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

MIN_STABILIZER_WINDOW_SECONDS = 0.030


@dataclasses.dataclass
class AppConfig:
    input_mode: str                    # "simulator" | "camera" | "file"
    file_path: Optional[str] = None
    camera_id: int = 0
    texture: Optional[str] = None
    past_window_secs: float = 2.0      # reference default (src/main_utils.hpp:25)
    future_window_secs: float = 1.5    # (src/main_utils.hpp:26)
    working_height: int = 360          # (src/main_utils.hpp:27)
    mode: str = "smoothing"
    output: Optional[str] = None
    max_frames: Optional[int] = None
    display: bool = True
    display_backend: str = "auto"      # auto | cv2 | term
    reference_compat: bool = False
    motion_model: str = "rigid"
    checkpoint: Optional[str] = None   # save carry here on exit
    resume: Optional[str] = None       # load carry from here at start
    stats: bool = False                # per-second printTimings-style stats
    trail: bool = False                # feathered trail compositing display
    debug_features: bool = False       # overlay tracked corners (ref imshow)


MODE_NAMES = {
    "smoothing": "GLOBAL_SMOOTHING",
    "accumulated-lock": "ACCUMULATED_FULL_LOCK",
    "orb-lock": "ORB_FULL_LOCK",
    "sift-lock": "SIFT_FULL_LOCK",
    "translation-lock": "TRANSLATION_LOCK",
    "rotation-lock": "ROTATION_LOCK",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m video_stabilization_tpu_torch.cli",
        description=(
            "Real-time video stabilizer on a CUDA GPU. Estimates inter-frame "
            "camera motion from sparse features, models it as rigid 2D "
            "transforms, and smooths it over a sliding temporal window or "
            "locks the view to a reference frame."
        ),
    )
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--simulator", action="store_true",
                     help="use the 3D floor-texture camera simulator")
    src.add_argument("--camera", type=int, metavar="ID", default=None,
                     help="use webcam with the given id")
    src.add_argument("--file", type=str, metavar="PATH", default=None,
                     help="use a video file")
    p.add_argument("--past-window", type=float, default=2.0, metavar="SECS",
                   help="past temporal window in seconds (default 2.0)")
    p.add_argument("--future-window", type=float, default=1.5, metavar="SECS",
                   help="future temporal window in seconds (default 1.5; "
                        "adds this much presentation delay)")
    p.add_argument("--working-height", type=int, default=360, metavar="PX",
                   help="processing resolution height, 91..2160 (default 360)")
    p.add_argument("--mode", choices=sorted(MODE_NAMES), default="smoothing",
                   help="initial stabilization mode")
    p.add_argument("--texture", type=str, default=None,
                   help="floor texture image for the simulator")
    p.add_argument("--output", type=str, default=None,
                   help="write stabilized output to a video file (.mp4/.avi/.y4m)")
    p.add_argument("--max-frames", type=int, default=None,
                   help="stop after N frames (headless runs)")
    p.add_argument("--no-display", action="store_true",
                   help="run without GUI windows")
    p.add_argument("--display-backend", choices=["auto", "cv2", "term"],
                   default="auto",
                   help="preview backend: cv2 HighGUI windows, 'term' ANSI "
                        "truecolor in the terminal (no OpenCV, no X server), "
                        "or auto (cv2 with $DISPLAY, else term on a TTY)")
    p.add_argument("--reference-compat", action="store_true",
                   help="replicate the reference implementation's behavioral "
                        "quirks bit-for-bit (for drift benchmarking)")
    p.add_argument("--motion-model", default="rigid",
                   choices=["rigid", "similarity", "affine", "homography"],
                   help="inter-frame motion family (default: rigid, the "
                        "reference's de-scaled similarity)")
    p.add_argument("--checkpoint", type=str, default=None, metavar="PATH",
                   help="save the engine state (.npz) on exit")
    p.add_argument("--resume", type=str, default=None, metavar="PATH",
                   help="restore engine state saved by --checkpoint")
    p.add_argument("--stats", action="store_true",
                   help="print per-stage kernel timings once at startup and "
                        "a stats line (fps / step ms / RANSAC inliers) every "
                        "second (the reference's printTimings)")
    p.add_argument("--trail", action="store_true",
                   help="display mode: feathered trail compositing onto a "
                        "fading background (the reference's dormant "
                        "copyFeathered path)")
    p.add_argument("--debug-features", action="store_true",
                   help="overlay tracked corners on the original view (the "
                        "reference's debug feature window)")
    return p


def parse_args(argv=None) -> AppConfig:
    p = build_parser()
    a = p.parse_args(argv)

    if a.past_window < 0 or a.future_window < 0:
        p.error("window sizes must be non-negative")
    if a.past_window + a.future_window < MIN_STABILIZER_WINDOW_SECONDS:
        p.error(
            f"total stabilization window must be at least "
            f"{MIN_STABILIZER_WINDOW_SECONDS} seconds"
        )
    if not (90 < a.working_height <= 2160):
        p.error("--working-height must be in (90, 2160]")

    if a.simulator:
        mode = "simulator"
    elif a.camera is not None:
        mode = "camera"
    else:
        mode = "file"

    return AppConfig(
        input_mode=mode,
        file_path=a.file,
        camera_id=a.camera if a.camera is not None else 0,
        texture=a.texture,
        past_window_secs=a.past_window,
        future_window_secs=a.future_window,
        working_height=a.working_height,
        mode=a.mode,
        output=a.output,
        max_frames=a.max_frames,
        display=not a.no_display,
        display_backend=a.display_backend,
        reference_compat=a.reference_compat,
        motion_model=a.motion_model,
        checkpoint=a.checkpoint,
        resume=a.resume,
        stats=a.stats,
        trail=a.trail,
        debug_features=a.debug_features,
    )
