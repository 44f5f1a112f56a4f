"""The per-frame stabilization step, its factories and ``Stabilizer``.

Port of ``video_stabilization_tpu/engine/stabilizer.py``.  The streaming
step is the engine's one body (``engine/offline.py::
offline_batched_chunk_step``) in its streaming form, on one stream and one
frame; the stages are listed there: gray and pyramid, GFTT for the next
frame, LK and the inter-frame fit (or the motion a host estimator computed,
``ext_motion``), the ring, smoothing, the lock, the rotation split, the mode
switch and the output warp.

The mode is a host ``int`` (``Stabilizer`` keeps it, the carry mirrors it as
a tensor), so branching on it never waits for the device.  The step
factories :func:`make_step_fn` and :func:`make_scan_fn` keep the JAX
signatures ``(carry, frame)`` and ``(carry, frames)``: they take the mode
from ``config.static_mode`` when it is set, else from one read of
``carry.mode`` per call (on the card, the one host sync of the call).  The JAX
package's data-dependent ``lax.cond`` on small values become
``torch.where`` over both sides.  On a CUDA card a step reads nothing back
to the host: the warp kernel decides its envelope branch on the device
(``ops/affine_warp.py``).  The exceptions are the referee's stages, which
read to the host by design: cv2exact GFTT's fixpoint (one read every
``ops.gftt.GREEDY_CHECK_EVERY`` rounds) and, with ``ransac.method=
"cv2exact"``, ``Stabilizer``'s host-estimator split (:meth:`Stabilizer.
stabilize_frame`).  The homography model warps its output through
``ops/warp.py::warp_perspective``; the other models through the warp kernel.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Tuple

import numpy as np
import torch

from video_stabilization_tpu_torch.config import StabilizationMode, StabilizerConfig
from video_stabilization_tpu_torch.engine.offline import (
    REGISTRATION_MODES,
    one_stream,
    step_constants,
    step_replays,
    working_gray,
)
from video_stabilization_tpu_torch.engine.state import EngineCarry, init_carry, map_carry
from video_stabilization_tpu_torch.engine.step_graph import (
    GraphCache, StepGraph, copy_carry, static_input)
from video_stabilization_tpu_torch.ops.lk import lk_track
from video_stabilization_tpu_torch.ops.pyramid import build_pyramid
from video_stabilization_tpu_torch.utils import prng
from video_stabilization_tpu_torch.utils.stage_profile import stage


def stabilize_step(
    carry: EngineCarry,
    frame: torch.Tensor,
    config: StabilizerConfig,
    mode: int,
    ext_motion=None,
    center: torch.Tensor | None = None,
    scale_factor: torch.Tensor | None = None,
) -> Tuple[EngineCarry, Tuple[torch.Tensor, torch.Tensor]]:
    """Process one (Hf, Wf, C) uint8 BGR frame -> (carry', (output, valid)).

    ``mode`` is the host copy of ``carry.mode`` (``config.static_mode``
    overrides it).  ``carry.frames`` is updated in place.

    ``ext_motion``: an optional ``(h (3, 3) f32, valid () bool, n_inliers ()
    int32)`` inter-frame rigid motion computed by a host estimator (the
    cv2exact RANSAC replica, ``motion/cv2_ransac.py``); given, the step
    skips its own LK and RANSAC stages.

    ``center`` and ``scale_factor``: the working image's (2,) f32 centre and
    the () f32 working-to-full scale on the frame's device, as
    :func:`step_constants` makes them once; without them the step uploads
    both from the host, which a CUDA graph's capture refuses.

    It is the body in the form "step" (``engine/offline.py::FORMS``) on one
    stream and one frame."""
    if ext_motion is not None:
        ext_motion = tuple(x[None, None] for x in ext_motion)
    carry, (outputs, valid) = one_stream(carry, frame[None], config, "step", modes=[mode],
                                         ext_motion=ext_motion, center=center,
                                         scale_factor=scale_factor)
    return carry, (outputs[0], valid[0])


def host_mode(carry: EngineCarry, config: StabilizerConfig) -> int:
    """The mode a step of ``carry`` runs: ``config.static_mode`` when set,
    else ``carry.mode`` read to the host (a sync when the carry is on the
    card)."""
    if config.static_mode is not None:
        return int(config.static_mode)
    return int(carry.mode)


@functools.lru_cache(maxsize=32)
def make_step_fn(config: StabilizerConfig) -> Callable:
    """(carry, frame (Hf, Wf, C) u8) -> (carry, (output, valid)): the step
    specialized to ``config``, as the JAX package's ``make_step_fn``.  The
    mode is :func:`host_mode`'s: one read of ``carry.mode`` per call unless
    ``config.static_mode`` is set.  ``carry.frames`` is updated in place
    (the JAX step donates the carry)."""

    def step(carry: EngineCarry, frame: torch.Tensor):
        return stabilize_step(carry, frame, config, host_mode(carry, config))

    return step


@functools.lru_cache(maxsize=32)
def make_scan_fn(config: StabilizerConfig) -> Callable:
    """(carry, frames (T, Hf, Wf, C) u8) -> (carry, (outputs (T, Hf, Wf,
    C), valid (T,))): the step over a clip, frame by frame on the carry's
    device, as the JAX package's ``lax.scan`` of it.  The mode is read once
    per clip (:func:`host_mode`); the step keeps ``carry.mode``."""

    def scan(carry: EngineCarry, frames):
        frames = torch.as_tensor(frames).to(carry.frames.device)
        mode = host_mode(carry, config)
        outputs, valid = [], []
        for frame in frames:
            carry, (out, ok) = stabilize_step(carry, frame, config, mode)
            outputs.append(out)
            valid.append(ok)
        return carry, (torch.stack(outputs), torch.stack(valid))

    return scan


@functools.lru_cache(maxsize=32)
def make_track_fn(config: StabilizerConfig) -> Callable:
    """(carry, frame) -> (tracked points (N, 2), status (N,)): the gray,
    pyramid and LK prefix of the step, for the host-estimator split.  The
    step derives its gray and pyramid again; the duplicate is confined to
    the referee, where exactness, not speed, is the point."""

    def track(carry: EngineCarry, frame: torch.Tensor):
        with stage("gray"):
            gray = working_gray(frame, config)
        with stage("pyramid"):
            pyr = build_pyramid(gray, config.lk.pyramid_levels)
        with stage("lk_track"):
            tracked = lk_track(carry.pyr_prev, pyr, carry.corners_prev,
                               carry.corners_mask, config.lk)
        return tracked.points, tracked.status

    return track


@functools.lru_cache(maxsize=32)
def make_step_ext_fn(config: StabilizerConfig) -> Callable:
    """(carry, frame, ext_motion) -> (carry, (output, valid)): the step with
    the inter-frame motion from a host estimator (``stabilize_step``'s
    ``ext_motion``), the mode as :func:`host_mode` gives it."""

    def step_ext(carry: EngineCarry, frame: torch.Tensor, ext_motion):
        return stabilize_step(carry, frame, config, host_mode(carry, config), ext_motion)

    return step_ext


# what Stabilizer.stabilize_frame did since the last reset_step_counters():
# its calls, the calls that replayed a CUDA graph of the step, and the
# graphs it captured; host counts, read without a sync
step_counters: dict = {}


def reset_step_counters() -> None:
    step_counters.clear()
    step_counters.update(calls=0, replays=0, captures=0)


reset_step_counters()


def _as_tensor(frame) -> torch.Tensor:
    if isinstance(frame, np.ndarray):
        return torch.from_numpy(np.require(frame, requirements=("C", "W")))
    return frame


class Stabilizer:
    """One stream: construct with a config, feed frames one at a time,
    switch modes at runtime (the reference's public API).  It runs on the
    CUDA card unless ``device`` names the CPU; with no card, asking for CUDA
    raises rather than falls back.

    With ``ransac.method="cv2exact"`` (the reference-compat referee) each
    frame runs the host-estimator split: the track prefix on the device,
    the bit-exact ``cv2.estimateAffinePartial2D`` replica on the host
    (``motion/cv2_ransac.py``), then the step with that motion; with
    ``gftt.selection="host"`` too, the element-exact corner list of
    ``ops/gftt_host.py`` replaces the step's corners.  Host traffic per
    frame, by design: one read of the previous corners, tracked points and
    status together; the motion's upload; with host GFTT, a read of the
    frame (none when it is given as a numpy array) and the corners' upload.
    :attr:`host_reads` counts the reads."""

    def __init__(self, config: StabilizerConfig,
                 mode: StabilizationMode = StabilizationMode.GLOBAL_SMOOTHING,
                 seed: int = 0, *, device="cuda"):
        # f32 everywhere: TF32 would cost three decimal digits in the filters
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Stabilizer: device {device!r} requested but CUDA "
                               "is not available")
        self.config = config
        if config.ransac.method == "cv2exact" and config.ransac.motion_model != "rigid":
            raise ValueError("cv2exact RANSAC supports the rigid model only")
        self._track = make_track_fn(config) if config.ransac.method == "cv2exact" else None
        self.host_reads = 0
        self._mode = int(mode)
        self.carry = init_carry(config, self._mode, prng.key(seed), self.device)
        # the step's CUDA graphs by (mode, frame shape, frame dtype), the
        # carry they read and write, and their input frames by shape and dtype
        self._graphs = GraphCache() if step_replays(config, self.device) else None
        self._constants = step_constants(config, self.device) if self._graphs is not None else None
        self._static = None
        self._inputs: dict = {}

    def set_stabilization_mode(self, mode: StabilizationMode) -> None:
        """Switch modes; clears lock state, keeps the frame/transform window."""
        dev = self.device
        eye = torch.eye(3, dtype=torch.float32, device=dev)

        def cleared(ref):
            return ref.__class__(points=torch.zeros_like(ref.points),
                                 desc=torch.zeros_like(ref.desc),
                                 mask=torch.zeros_like(ref.mask),
                                 gray=torch.zeros_like(ref.gray),
                                 is_set=torch.zeros_like(ref.is_set))

        self._mode = int(mode)
        self.carry = dataclasses.replace(
            self.carry,
            mode=torch.tensor(self._mode, dtype=torch.int32, device=dev),
            accum_h=eye,
            accum_active=torch.zeros((), dtype=torch.bool, device=dev),
            orb_ref=cleared(self.carry.orb_ref),
            sift_ref=cleared(self.carry.sift_ref),
            lock_prev_h=eye.clone(),
            last_lock_matches=torch.zeros((), dtype=torch.int32, device=dev),
        )

    @property
    def mode(self) -> int:
        """The host mode the next step runs (``carry.mode``'s host copy)."""
        return self._mode

    def resume(self, path: str) -> None:
        """Restore the carry saved by ``engine.checkpoint.save_carry`` (of
        either package) and take the host mode from its ``mode``."""
        from video_stabilization_tpu_torch.engine.checkpoint import load_carry

        self.carry = load_carry(path, self.carry)
        self._mode = int(self.carry.mode)

    def _as_frame(self, frame) -> torch.Tensor:
        return _as_tensor(frame).to(self.device)

    def stabilize_frame(self, frame) -> torch.Tensor:
        """Feed one (Hf, Wf, C) uint8 BGR frame (array or tensor); returns the
        stabilized, delayed output frame on the device.  Stage ranges: the
        frame's upload (``input_h2d``), then the rest (``step``).

        Where :func:`step_replays` holds, in a mode other than the
        registration locks, the step is a CUDA graph captured per (mode,
        frame shape, frame dtype) at the key's second call
        (``engine/step_graph.py``): the frame is copied into the graph's
        input, the replay runs under ``step_replay`` and the output is a
        fresh copy.  :attr:`carry` then stays one object whose tensors each
        replay overwrites, so a carry read before a call is no snapshot of
        it after the call (its ``frames`` ring never was); a carry put in
        its place (a mode switch, :meth:`resume`) is copied in before the
        next replay.  :data:`step_counters` counts the calls, replays and
        captures."""
        step_counters["calls"] += 1
        src = _as_tensor(frame)
        pinned = self.config.static_mode
        mode = self._mode if pinned is None else int(pinned)
        key = None
        if self._graphs is not None and mode not in REGISTRATION_MODES:
            key = (mode, tuple(src.shape), src.dtype)
        with stage("input_h2d"):
            f = static_input(self._inputs, src, self.device) if key else src.to(self.device)
        graph = self._graphs.get(key, lambda: self._capture(key[0], f)) if key else None
        if graph is not None:
            with stage("step_replay"):
                self._adopt_carry()
                output = graph.replay().clone()
            step_counters["replays"] += 1
            return output
        with stage("step"):
            if self._track is None:
                self.carry, (output, _) = stabilize_step(self.carry, f, self.config,
                                                         self._mode)
                return output
            self.carry, (output, _) = stabilize_step(self.carry, f, self.config, self._mode,
                                                     self._host_motion(f))
            if self.config.gftt.selection == "host":
                self._inject_host_corners(frame)
            return output

    def _adopt_carry(self) -> EngineCarry:
        """:attr:`carry` as the graphs' carry, whose tensors stay put: at
        first a copy of it that shares its frame ring, later the same
        tensors refilled from whatever carry took its place (an eager step,
        a mode switch, a resume)."""
        if self._static is None:
            ring = self.carry.frames
            self._static = map_carry(lambda x: x if x is ring else x.clone(), self.carry)
        elif self.carry is not self._static:
            copy_carry(self._static, self.carry)
        self.carry = self._static
        return self._static

    def _capture(self, mode: int, f: torch.Tensor) -> StepGraph:
        """The step in ``mode`` on the graphs' input ``f``, captured: it
        reads the graphs' carry and writes its next carry back into it."""
        carry = self._adopt_carry()
        cfg = self.config
        center, scale_factor = self._constants

        def step():
            new, (output, _) = stabilize_step(carry, f, cfg, mode, center=center,
                                              scale_factor=scale_factor)
            copy_carry(carry, new)
            return output

        step_counters["captures"] += 1
        return StepGraph(step, self.device)

    def _host_motion(self, f: torch.Tensor):
        """The host estimator stage: the track prefix on the device, one read
        of (previous corners | tracked points | status), the cv2exact RANSAC
        replica and de-scale in float64, the motion uploaded."""
        from video_stabilization_tpu_torch.motion.cv2_ransac import estimate_rigid_cv2_host

        pts, status = self._track(self.carry, f)
        with stage("host_read"):
            both = torch.cat([self.carry.corners_prev, pts, status.float()[:, None]], 1).cpu()
            self.host_reads += 1
        wh, ww = self.config.working_size
        with stage("host_ransac"):
            h, valid, n_inl = estimate_rigid_cv2_host(
                both[:, 0:2].numpy(), both[:, 2:4].numpy(), both[:, 4].numpy() > 0.5,
                center=(ww / 2.0, wh / 2.0), min_points=self.config.ransac.min_points,
                ransac_reproj_threshold=self.config.ransac.inlier_threshold)
        dev = self.device
        return (torch.tensor(h, dtype=torch.float32).to(dev, non_blocking=True),
                torch.tensor(valid).to(dev, non_blocking=True),
                torch.tensor(n_inl, dtype=torch.int32).to(dev, non_blocking=True))

    def _inject_host_corners(self, frame) -> None:
        """cv2's element-exact corner list of ``frame`` (``ops/gftt_host.py``)
        into the carry, so the next frame's hypothesis stream stays the
        reference pipeline's."""
        from video_stabilization_tpu_torch.ops.gftt_host import detect_corners_host

        if not isinstance(frame, np.ndarray):
            with stage("host_read"):
                frame = frame.cpu().numpy()
                self.host_reads += 1
        cfg = self.config
        wh, ww = cfg.working_size
        with stage("host_gftt"):
            pts, mask = detect_corners_host(
                np.asarray(frame, np.uint8), (wh, ww), cfg.gftt.max_features,
                cfg.gftt.quality_level, cfg.gftt.min_distance_at_720 * (wh / 720.0))
        dev = self.device
        self.carry = dataclasses.replace(
            self.carry, corners_prev=torch.from_numpy(pts).to(dev, non_blocking=True),
            corners_mask=torch.from_numpy(mask).to(dev, non_blocking=True))

    def stabilize_clip(self, frames) -> torch.Tensor:
        """Feed a (T, Hf, Wf, C) clip frame by frame; returns the outputs."""
        return torch.stack([self.stabilize_frame(f) for f in frames])

    @property
    def total_frame_window_size(self) -> int:
        return self.config.total_window
