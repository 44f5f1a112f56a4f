"""ctypes bindings for the native host runtime (``native/framebuf.cpp``).

Port of ``video_stabilization_tpu/io/native.py``:

- :class:`NativeFrameRing`: a producer/consumer ring of raw frames in
  contiguous storage (a decode thread pushes, the device feeder pops);
- :class:`NativeY4MReader`: a YUV4MPEG2 reader with no dependencies, the
  YUV -> BGR conversion in C++ (``read``) or none at all (``read_yuv``,
  ``read_yuv_block``: raw planes for ``ops.image.yuv_flat_to_bgr`` on the
  card);
- :class:`PrefetchingYUVSource` and :class:`PrefetchingFileSource`: a
  background thread that reads ahead through a ring.

The library is built at first use from ``native/framebuf.cpp`` with ``g++``
into ``build/native/`` at the root of the checkout, under a name that
carries a hash of the source, so an edited source is rebuilt.  Nothing is
written into ``native/``, and the library committed there is never loaded:
its toolchain and ABI are unknown.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from video_stabilization_tpu_torch.io.video import FrameSource
from video_stabilization_tpu_torch.utils.stage_profile import stage

SOURCE = Path(__file__).resolve().parents[2] / "native" / "framebuf.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-pthread", "-shared")

_lib = None
_lock = threading.Lock()


def lib_path() -> Path:
    """Where the library of the current source lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libframebuf-{digest}.so"


def _build(path: Path) -> None:
    """Compile the source to ``path``: into a temporary file of the same
    directory first, then renamed, so processes that build at once never
    load a half-written library."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    try:
        proc = subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp,
                               str(SOURCE)], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"building {SOURCE.name} failed:\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = lib_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.ring_create.restype = ctypes.c_void_p
        lib.ring_create.argtypes = [ctypes.c_int, ctypes.c_long]
        lib.ring_destroy.argtypes = [ctypes.c_void_p]
        lib.ring_push.restype = ctypes.c_int
        lib.ring_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.ring_pop.restype = ctypes.c_int
        lib.ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.ring_size.restype = ctypes.c_int
        lib.ring_size.argtypes = [ctypes.c_void_p]
        lib.ring_close.argtypes = [ctypes.c_void_p]
        lib.y4m_open.restype = ctypes.c_void_p
        lib.y4m_open.argtypes = [ctypes.c_char_p]
        lib.y4m_width.restype = ctypes.c_int
        lib.y4m_width.argtypes = [ctypes.c_void_p]
        lib.y4m_height.restype = ctypes.c_int
        lib.y4m_height.argtypes = [ctypes.c_void_p]
        lib.y4m_fps.restype = ctypes.c_double
        lib.y4m_fps.argtypes = [ctypes.c_void_p]
        lib.y4m_read_bgr.restype = ctypes.c_int
        lib.y4m_read_bgr.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.y4m_read_yuv.restype = ctypes.c_int
        lib.y4m_read_yuv.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.y4m_read_yuv_block.restype = ctypes.c_int
        lib.y4m_read_yuv_block.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.y4m_is_c420.restype = ctypes.c_int
        lib.y4m_is_c420.argtypes = [ctypes.c_void_p]
        lib.y4m_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class NativeFrameRing:
    """A ring of ``capacity`` frames of ``frame_shape`` uint8: ``push``
    blocks while it is full, ``pop`` while it is empty (both up to
    ``timeout_ms``, or forever when negative); after ``close`` a push fails
    and a pop drains what is left, then returns None."""

    def __init__(self, capacity: int, frame_shape: Tuple[int, ...]):
        self._lib = _load()
        self.frame_shape = tuple(frame_shape)
        self.frame_bytes = int(np.prod(frame_shape))
        self._ring = self._lib.ring_create(capacity, self.frame_bytes)
        if not self._ring:
            raise RuntimeError("ring_create failed")

    def push(self, frame: np.ndarray, timeout_ms: int = -1) -> bool:
        buf = np.ascontiguousarray(frame, dtype=np.uint8)
        if buf.nbytes != self.frame_bytes:
            raise ValueError(f"frame of {buf.nbytes} bytes, the ring holds "
                             f"{self.frame_bytes}-byte frames")
        return bool(self._lib.ring_push(self._ring, buf.ctypes.data, timeout_ms))

    def pop(self, timeout_ms: int = -1) -> Optional[np.ndarray]:
        out = np.empty(self.frame_shape, np.uint8)
        ok = self._lib.ring_pop(self._ring, out.ctypes.data, timeout_ms)
        return out if ok else None

    def size(self) -> int:
        return int(self._lib.ring_size(self._ring))

    def close(self) -> None:
        self._lib.ring_close(self._ring)

    def __del__(self):
        try:
            if getattr(self, "_ring", None):
                self._lib.ring_close(self._ring)
                self._lib.ring_destroy(self._ring)
                self._ring = None
        except Exception:
            pass


class NativeY4MReader(FrameSource):
    """A Y4M file (C444 or C420) decoded in native code."""

    def __init__(self, path: str):
        self._lib = _load()
        self._r = self._lib.y4m_open(os.fsencode(path))
        if not self._r:
            raise RuntimeError(f"cannot open y4m file {path}")
        self.frame_size = (self._lib.y4m_height(self._r), self._lib.y4m_width(self._r))
        self.fps = float(self._lib.y4m_fps(self._r)) or 30.0

    def read(self) -> Optional[np.ndarray]:
        """The next frame as (H, W, 3) uint8 BGR, converted on the host;
        None at the end of the file."""
        h, w = self.frame_size
        out = np.empty((h, w, 3), np.uint8)
        ok = self._lib.y4m_read_bgr(self._r, out.ctypes.data)
        return out if ok else None

    @property
    def is_c420(self) -> bool:
        return bool(self._lib.y4m_is_c420(self._r))

    @property
    def yuv_bytes(self) -> int:
        h, w = self.frame_size
        return h * w * 3 // 2 if self.is_c420 else h * w * 3

    def read_yuv(self) -> Optional[np.ndarray]:
        """The next frame's raw packed Y|U|V planes, (yuv_bytes,) uint8,
        with no colour conversion (``ops.image.yuv_flat_to_bgr`` does it on
        the card)."""
        out = np.empty((self.yuv_bytes,), np.uint8)
        ok = self._lib.y4m_read_yuv(self._r, out.ctypes.data)
        return out if ok else None

    def read_yuv_block(self, k: int, out: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
        """Up to ``k`` frames of raw planes as one contiguous (n, yuv_bytes)
        array, in one native call (a ``y4m_read`` stage range); None at the
        end of the file.  ``out``, a C-contiguous (k, yuv_bytes) uint8 array
        (a view of pinned memory, say), receives them instead of a new
        array."""
        if out is None:
            out = np.empty((k, self.yuv_bytes), np.uint8)
        elif out.shape != (k, self.yuv_bytes) or out.dtype != np.uint8 \
                or not out.flags.c_contiguous:
            raise ValueError(f"out must be C-contiguous uint8 of shape {(k, self.yuv_bytes)}")
        with stage("y4m_read"):
            n = self._lib.y4m_read_yuv_block(self._r, out.ctypes.data, k)
        if n == 0:
            return None
        return out[:n]

    def close(self) -> None:
        if self._r:
            self._lib.y4m_close(self._r)
            self._r = None


class PrefetchingYUVSource:
    """A background thread freads raw Y|U|V frames from a
    :class:`NativeY4MReader` into a native ring; ``read`` pops flat uint8
    plane buffers.  The host never touches pixel values."""

    def __init__(self, reader: NativeY4MReader, depth: int = 8):
        self.reader = reader
        self.frame_size = reader.frame_size
        self.is_c420 = reader.is_c420
        self.fps = reader.fps
        self.ring = NativeFrameRing(depth, (reader.yuv_bytes,))
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self) -> None:
        while True:
            buf = self.reader.read_yuv()
            if buf is None or not self.ring.push(buf):
                break
        self.ring.close()

    def read(self) -> Optional[np.ndarray]:
        return self.ring.pop()

    def close(self) -> None:
        # join the producer before freeing the reader: it may be inside
        # read_yuv's fread when the consumer stops before the end
        self.ring.close()
        self._thread.join()
        self.reader.close()


class PrefetchingFileSource(FrameSource):
    """Any :class:`FrameSource` read ahead on a background thread through a
    native ring."""

    def __init__(self, inner: FrameSource, depth: int = 8):
        self.inner = inner
        self.fps = inner.fps
        self.frame_size = inner.frame_size
        h, w = inner.frame_size
        self.ring = NativeFrameRing(depth, (h, w, 3))
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self) -> None:
        while True:
            frame = self.inner.read()
            if frame is None or not self.ring.push(frame):
                break
        self.ring.close()

    def read(self) -> Optional[np.ndarray]:
        return self.ring.pop()

    def close(self) -> None:
        self.ring.close()
        self._thread.join()
        self.inner.close()
