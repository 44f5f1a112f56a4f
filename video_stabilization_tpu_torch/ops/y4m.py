"""The Y4M planes of BGR frames, encoded on the frames' device.

:func:`encode_y4m` turns (N, H, W, 3) uint8 BGR frames into (N, bytes)
uint8 rows, each the Y|U|V planes of one Y4M frame (C420 or C444), the
bytes of ``io/video.py::encode_y4m_planes`` (numpy, on the host): BT.601 in
float32, each product and sum rounded in numpy's order, C420 chroma as the
mean of each 2x2 block, a clip to [0, 255] and a truncation toward zero.
On a CUDA tensor it is one launch of the hand-written kernel of
``csrc/y4m_encode.cu``; on a CPU tensor its plain version
:func:`encode_y4m_plain`.

Replaces no TPU kernel: the JAX package encodes its outputs on the host.
Serving encodes its outputs here, on each slot's device, so that its host
only writes bytes.  The kernel is bound by bytes (3 B/px read, 1.5 B/px
written at C420: 9.3 MB a 1080x1920 frame); the plain version writes about
ten float32 full-frame intermediates.
"""

from __future__ import annotations

import ctypes

import torch

from video_stabilization_tpu_torch.utils.cuda_build import load_kernel

# BT.601 as io/video.py::encode_y4m_planes writes it (float32 constants)
KR, KG, KB = 0.299, 0.587, 0.114
KU, KV = 0.564, 0.713

# Launches of the CUDA kernel: a plain integer that a caller resets and
# reads around the run it wants to account for.
launches = 0
MAX_FRAMES = 65535       # frames one launch takes (grid y)

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = load_kernel("y4m_encode")
        fn = lib.vstab_y4m_encode
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def frame_bytes(h: int, w: int, c420: bool) -> int:
    """Bytes of one Y4M frame's planes."""
    return h * w * 3 // 2 if c420 else h * w * 3


def _check(frames: torch.Tensor, c420: bool) -> None:
    if frames.dtype != torch.uint8 or frames.dim() != 4 or frames.shape[-1] != 3:
        raise ValueError("y4m: frames must be (N, H, W, 3) uint8, got "
                         f"{frames.dtype} {tuple(frames.shape)}")
    n, h, w = frames.shape[:3]
    if c420 and (h % 2 or w % 2):
        raise ValueError(f"y4m: C420 needs even frame dimensions, got {h}x{w}")


def encode_y4m_plain(frames: torch.Tensor, c420: bool) -> torch.Tensor:
    """Plain PyTorch version of :func:`encode_y4m`, numpy's order written
    out: every operation rounds to float32 on its own, and the 2x2 mean is
    ((top-left + top-right) + (bottom-left + bottom-right)) / 4."""
    _check(frames, c420)
    n, h, w = frames.shape[:3]
    f = frames.float()
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    y = (KR * r + KG * g) + KB * b
    u = 128.0 + KU * (b - y)
    v = 128.0 + KV * (r - y)
    if c420:
        def mean2x2(p):
            q = p.reshape(n, h // 2, 2, w // 2, 2)
            return ((q[:, :, 0, :, 0] + q[:, :, 0, :, 1])
                    + (q[:, :, 1, :, 0] + q[:, :, 1, :, 1])) / 4.0
        u, v = mean2x2(u), mean2x2(v)
    return torch.cat([p.clamp(0, 255).to(torch.uint8).reshape(n, -1) for p in (y, u, v)], 1)


def _launch(frames: torch.Tensor, c420: bool) -> torch.Tensor:
    """One launch over every frame (CUDA); returns the (N, bytes) rows."""
    _check(frames, c420)
    n, h, w = frames.shape[:3]
    dev = frames.device
    if dev.type != "cuda":
        raise ValueError(f"y4m: unsupported device {dev}")
    if not frames.is_contiguous() or frames.data_ptr() % 2:
        raise ValueError("y4m: frames must be contiguous and start on an even address")
    if not 1 <= n <= MAX_FRAMES:
        raise ValueError(f"y4m: 1 to {MAX_FRAMES} frames per launch, got {n}")
    out = torch.empty((n, frame_bytes(h, w, c420)), dtype=torch.uint8, device=dev)
    # the entry point makes the frames' device current for the launch
    err = _kernel_lib().vstab_y4m_encode(frames.data_ptr(), out.data_ptr(), n, h, w, int(c420),
                                         dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"y4m_encode launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out


def encode_y4m(frames: torch.Tensor, c420: bool) -> torch.Tensor:
    """(N, H, W, 3) uint8 BGR -> (N, bytes) uint8 Y|U|V planes of Y4M
    frames, on the frames' device.

    CPU tensors go to :func:`encode_y4m_plain`; CUDA tensors to one launch
    of the kernel, which raises rather than falls back if it cannot run."""
    if frames.device.type == "cpu":
        return encode_y4m_plain(frames, c420)
    return _launch(frames, c420)
