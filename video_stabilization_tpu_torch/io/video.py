"""Frame sources and sinks.

Port of ``video_stabilization_tpu/io/video.py``:

- :class:`CameraSource`: a webcam through ``cv2.VideoCapture``, 1280x720
  requested, fps 30 when the camera reports none;
- :class:`FileSource`: a video file through ``cv2.VideoCapture``;
- :class:`SimulatorSource`: the port's floor-texture simulator, rendered on
  the card (or the CPU when asked), with the demo app's start pose and its
  movement and roll keys, at a fixed 30 fps;
- :class:`VideoWriter`: a file sink, ``.y4m`` written without any library
  (the same bytes as the JAX package's writer), other containers via cv2.

Every source gives (H, W, 3) uint8 BGR numpy frames.  OpenCV is optional:
only the camera, non-Y4M files and texture images need it.
"""

from __future__ import annotations

import abc
import os
import time
from typing import Optional, Tuple

import numpy as np

from video_stabilization_tpu_torch.ops.y4m import frame_bytes
from video_stabilization_tpu_torch.utils.stage_profile import stage

try:
    import cv2
    _HAS_CV2 = True
except Exception:  # pragma: no cover
    cv2 = None
    _HAS_CV2 = False


class FrameSource(abc.ABC):
    """Abstract frame source."""

    fps: float = 30.0
    frame_size: Tuple[int, int] = (720, 1280)    # (H, W)

    @abc.abstractmethod
    def read(self) -> Optional[np.ndarray]:
        """The next (H, W, 3) uint8 BGR frame, or None at the end."""

    def close(self) -> None:
        pass


class CameraSource(FrameSource):
    def __init__(self, camera_id: int = 0):
        if not _HAS_CV2:
            raise RuntimeError("OpenCV required for camera capture")
        self.cap = cv2.VideoCapture(camera_id)
        if not self.cap.isOpened():
            raise RuntimeError(f"cannot open camera {camera_id}")
        self.cap.set(cv2.CAP_PROP_FRAME_WIDTH, 1280)
        self.cap.set(cv2.CAP_PROP_FRAME_HEIGHT, 720)
        fps = self.cap.get(cv2.CAP_PROP_FPS)
        self.fps = fps if fps and fps > 0 else 30.0
        ok, frame = self.cap.read()
        if not ok:
            raise RuntimeError("camera produced no frames")
        self.frame_size = frame.shape[:2]
        self._first = frame

    def read(self):
        if self._first is not None:
            f, self._first = self._first, None
            return f
        ok, frame = self.cap.read()
        return frame if ok else None

    def close(self):
        self.cap.release()


class FileSource(FrameSource):
    def __init__(self, path: str):
        if not _HAS_CV2:
            raise RuntimeError("OpenCV required for file decode")
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise RuntimeError(f"cannot open video file {path}")
        fps = self.cap.get(cv2.CAP_PROP_FPS)
        self.fps = fps if fps and fps > 0 else 30.0
        self.frame_size = (
            int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
        )

    def read(self):
        ok, frame = self.cap.read()
        return frame if ok else None           # None at the end of the file

    def close(self):
        self.cap.release()


class SimulatorSource(FrameSource):
    """The port's camera simulator with interactive pose control: the demo
    app's start pose (``sim.DEFAULT_APP_PARAMS``), frames rendered on
    ``device`` (the card unless the caller names the CPU) and copied to the
    host.  The default texture is ``sim.make_default_texture`` drawn from
    ``numpy.random.default_rng(seed)``."""

    def __init__(self, texture_path: Optional[str] = None,
                 frame_size: Tuple[int, int] = (720, 1280), seed: int = 0,
                 device="cuda"):
        import torch

        from video_stabilization_tpu_torch.sim import DEFAULT_APP_PARAMS, make_default_texture

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"SimulatorSource: device {device!r} requested but CUDA "
                               "is not available")
        self.fps = 30.0
        self.frame_size = tuple(frame_size)
        if texture_path is not None:
            if not _HAS_CV2:
                raise RuntimeError("OpenCV required to load a texture file")
            tex = cv2.imread(texture_path)
            if tex is None:
                raise RuntimeError(f"could not load floor texture '{texture_path}'")
            tex = np.ascontiguousarray(tex)
        else:
            tex = make_default_texture(np.random.default_rng(seed))
        self.texture = torch.from_numpy(tex).to(self.device)
        self.params = DEFAULT_APP_PARAMS
        self._pose = None        # self.params on the device, uploaded once per move

    def move(self, key: str, amount: float = 1.0) -> None:
        """Apply one movement key: W/S forward/back, A/D left/right, SPACE/C
        up/down, Q/E roll, P reset the pose."""
        from video_stabilization_tpu_torch.sim import (
            DEFAULT_APP_PARAMS, move_backward, move_down, move_forward, move_left,
            move_right, move_up, roll_clockwise, roll_counterclockwise)

        actions = {
            "w": move_forward, "s": move_backward,
            "a": move_left, "d": move_right,
            " ": move_up, "c": move_down,
        }
        if key in actions:
            self.params = actions[key](self.params, amount)
        elif key == "q":
            self.params = roll_counterclockwise(self.params, amount)
        elif key == "e":
            self.params = roll_clockwise(self.params, amount)
        elif key == "p":
            self.params = DEFAULT_APP_PARAMS
        self._pose = None

    def read_tensor(self):
        """The current pose's frame as an (H, W, 3) uint8 tensor on the
        source's device."""
        from video_stabilization_tpu_torch.sim import render_frame

        if self._pose is None:
            self._pose = self.params.to(self.device)
        h, w = self.frame_size
        return render_frame(self.texture, self._pose, h, w)

    def read(self):
        return self.read_tensor().cpu().numpy()

    def pose_text(self) -> list[str]:
        """The on-frame pose overlay lines."""
        p = self.params
        pos = p.position.cpu().numpy()
        return [
            f"pos: ({pos[0]:+.2f}, {pos[1]:+.2f}, {pos[2]:+.2f})",
            f"pan: {float(p.pan):+.1f}  tilt: {float(p.tilt):+.1f}  "
            f"roll: {float(p.roll):+.1f}",
        ]


def encode_y4m_planes(frame_bgr: np.ndarray, c420: bool) -> bytes:
    """One (H, W, 3) uint8 BGR frame as the Y|U|V bytes of a Y4M frame:
    BT.601 in f32, C420 chroma as the mean of each 2x2 block (the native
    reader repeats each chroma sample 2x2)."""
    h, w = frame_bgr.shape[:2]
    f = frame_bgr.astype(np.float32)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = 128.0 + 0.564 * (b - y)
    v = 128.0 + 0.713 * (r - y)
    if c420:
        u = u.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
        v = v.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
    return b"".join(np.clip(plane, 0, 255).astype(np.uint8).tobytes() for plane in (y, u, v))


class VideoWriter:
    """Frame sink: ``.y4m`` without any library (C444, or C420 with
    ``subsampling="420"``), mp4 / avi via cv2.  :meth:`write` takes a BGR
    frame; :meth:`write_planes` a Y4M frame already encoded (Y4M only).  It
    counts the ``frames`` it wrote and, for Y4M, the host seconds of their
    encode (``encode_s``) and of their file writes (``file_write_s``), each
    also a stage range (``y4m_encode``, ``y4m_write``); cv2's encode and
    write are not timed."""

    def __init__(self, path: str, fps: float, frame_size: Tuple[int, int],
                 subsampling: str = "444"):
        self.path = path
        self.fps = fps
        self.h, self.w = frame_size
        self._y4m = path.endswith(".y4m")
        self._c420 = subsampling == "420"
        self.frames = 0
        self.encode_s = 0.0
        self.file_write_s = 0.0
        if self._c420 and (self.h % 2 or self.w % 2):
            raise ValueError("C420 output needs even frame dimensions")
        if self._y4m:
            self._f = open(path, "wb")
            chroma = "420" if self._c420 else "444"
            hdr = (f"YUV4MPEG2 W{self.w} H{self.h} F{int(round(fps))}:1 "
                   f"Ip A1:1 C{chroma}\n")
            self._f.write(hdr.encode())
        else:
            if not _HAS_CV2:
                raise RuntimeError("OpenCV required for non-y4m output")
            fourcc = cv2.VideoWriter_fourcc(*("mp4v" if path.endswith(".mp4") else "XVID"))
            self._vw = cv2.VideoWriter(path, fourcc, fps, (self.w, self.h))

    def write(self, frame_bgr: np.ndarray) -> None:
        self.frames += 1
        if not self._y4m:
            self._vw.write(frame_bgr)
            return
        t0 = time.perf_counter()
        with stage("y4m_encode"):
            data = b"FRAME\n" + encode_y4m_planes(frame_bgr, self._c420)
        t1 = time.perf_counter()
        with stage("y4m_write"):
            self._f.write(data)
        self.encode_s += t1 - t0
        self.file_write_s += time.perf_counter() - t1

    def write_planes(self, planes: np.ndarray) -> None:
        """Append one frame given as its Y|U|V planes, the bytes of
        :func:`encode_y4m_planes` (a contiguous uint8 array), with no copy."""
        if not self._y4m:
            raise ValueError("write_planes needs a .y4m output")
        expected = frame_bytes(self.h, self.w, self._c420)
        if planes.nbytes != expected:
            raise ValueError(f"write_planes: {planes.nbytes} bytes, a frame has {expected}")
        self.frames += 1
        t0 = time.perf_counter()
        with stage("y4m_write"):
            self._f.write(b"FRAME\n")
            self._f.write(planes)
        self.file_write_s += time.perf_counter() - t0

    def close(self) -> None:
        if self._y4m:
            self._f.close()
        else:
            self._vw.release()


def open_source(mode: str, *, path: Optional[str] = None,
                camera_id: int = 0, texture: Optional[str] = None,
                frame_size: Tuple[int, int] = (720, 1280), device="cuda") -> FrameSource:
    """The input source of a mode: "camera", "file" or "simulator" (rendered
    on ``device``)."""
    if mode == "camera":
        return CameraSource(camera_id)
    if mode == "file":
        return FileSource(path)
    if mode == "simulator":
        return SimulatorSource(texture, frame_size, device=device)
    raise ValueError(f"unknown input mode {mode!r}")
