"""Preprocessing filters of the registration locks.

Port of ``video_stabilization_tpu/ops/filters.py``.  The reference's chain
(src/stabilizer.cpp:464-477) is

    medianBlur(5) -> sharpen 3x3 [[0,-1,0],[-1,5,-1],[0,-1,0]] ->
    CLAHE(clip 2.0, 8x8 tiles) -> medianBlur(5)

on integer-valued (u8) images.  The median is the JAX package's 8-step
bisection on the order statistic (exact for integers).  CLAHE builds its
tile histograms with one ``index_add_`` and reads the four neighbouring
tiles' LUTs by direct indexing, where the JAX package used one-hot matmuls;
the bilinear blend keeps its order, rows first, then columns.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _pad2d(img: torch.Tensor, pad, mode: str) -> torch.Tensor:
    """F.pad of an (H, W) image; ``pad`` = (left, right, top, bottom)."""
    return F.pad(img[None, None], pad, mode=mode)[0, 0]


def median_blur(img: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """ksize x ksize median of an integer-valued (H, W) image in [0, 255],
    replicate borders (cv2.medianBlur on u8)."""
    pad = ksize // 2
    x = _pad2d(img.float(), (pad, pad, pad, pad), "replicate")
    h, w = img.shape
    shifts = torch.stack([x[dy:dy + h, dx:dx + w]
                          for dy in range(ksize) for dx in range(ksize)])
    # the median of k² integers is the largest m with count(v >= m) >= k²//2+1
    need = ksize * ksize // 2 + 1
    m = torch.zeros((h, w), dtype=torch.float32, device=img.device)
    for bit in (128.0, 64.0, 32.0, 16.0, 8.0, 4.0, 2.0, 1.0):
        t = m + bit
        cnt = (shifts >= t).sum(0)
        m = torch.where(cnt >= need, t, m)
    return m


SHARPEN_KERNEL = ((0.0, -1.0, 0.0), (-1.0, 5.0, -1.0), (0.0, -1.0, 0.0))


def sharpen3(img: torch.Tensor) -> torch.Tensor:
    """3x3 sharpening stencil, reflect-101 borders (cv2.filter2D default)."""
    h, w = img.shape
    x = _pad2d(img.float(), (1, 1, 1, 1), "reflect")
    out = torch.zeros((h, w), dtype=torch.float32, device=img.device)
    for dy in range(3):
        for dx in range(3):
            k = SHARPEN_KERNEL[dy][dx]
            if k != 0.0:
                out = out + k * x[dy:dy + h, dx:dx + w]
    return out


def _tile_weights(n: int, tile: int, n_tiles: int, device):
    """Per pixel along one axis: the two neighbouring tiles (i0, i1), the
    blend weight of each as the JAX package's weight matrix holds it (both
    on one tile where i0 == i1), and whether i1 is a second tile.

    The tile coordinate ``i / tile − 0.5`` is rounded as the JAX package's
    compiled step rounds it: a multiply by the float32 reciprocal fused
    with the subtraction (here in float64, where that product is exact).
    Rounded in plain f32 instead, 0.6% of the pixels of
    ``tests/test_torch_filters.py::test_clahe[shape0]`` move by one level,
    above its 0.1% limit."""
    recip = float(torch.tensor(1.0 / tile, dtype=torch.float32))
    f = (torch.arange(n, dtype=torch.float64, device=device) * recip - 0.5).float()
    fl = torch.floor(f)
    i0 = fl.clamp(0, n_tiles - 1).long()
    i1 = (i0 + 1).clamp(0, n_tiles - 1)
    wt = torch.where(f < 0, 0.0, (f - fl).clamp(0.0, 1.0))
    same = i1 == i0
    # weight matrix row: (i0 == t)·(1 − w) + (i1 == t)·w
    w0 = torch.where(same, (1.0 - wt) + wt, 1.0 - wt)
    return i0, i1, w0, wt, ~same


def clahe(img: torch.Tensor, clip_limit: float = 2.0,
          tiles: Tuple[int, int] = (8, 8)) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization of an (H, W) image
    with u8 values (rounded and clipped to [0, 255] first)."""
    ty, tx = tiles
    h, w = img.shape
    dev = img.device
    img_u8 = torch.clamp(torch.round(img.float()), 0, 255)

    # pad to a multiple of the tile grid (reflect-101, like cv::CLAHE)
    th, tw = -(-h // ty), -(-w // tx)
    ph, pw = th * ty - h, tw * tx - w
    padded = _pad2d(img_u8, (0, pw, 0, ph), "reflect") if (ph or pw) else img_u8
    hh, ww = padded.shape
    vals = padded.long()

    # per-tile 256-bin histograms: one index_add_ of ones (integer counts,
    # exact in f32 whatever order the adds land in)
    tile_of = ((torch.arange(hh, device=dev) // th)[:, None] * tx
               + (torch.arange(ww, device=dev) // tw)[None, :])
    hist = torch.zeros(ty * tx * 256, dtype=torch.float32, device=dev)
    hist.index_add_(0, (tile_of * 256 + vals).reshape(-1),
                    torch.ones(hh * ww, dtype=torch.float32, device=dev))
    hist = hist.reshape(ty * tx, 256)

    # clip + redistribute (OpenCV calcLut integer semantics)
    tile_area = th * tw
    limit = max(1.0, float(int(clip_limit * tile_area / 256.0)))
    excess = torch.clamp(hist - limit, min=0.0).sum(-1, keepdim=True)
    hist = torch.clamp(hist, max=limit)
    batch = torch.floor(excess / 256.0)
    residual = excess - batch * 256.0
    hist = hist + batch
    step = torch.clamp(torch.floor(256.0 / torch.clamp(residual, min=1.0)), min=1.0)
    bin_idx = torch.arange(256, dtype=torch.float32, device=dev)[None, :]
    gets_one = (torch.remainder(bin_idx, step) == 0) & (bin_idx / step < residual)
    hist = hist + gets_one.float()

    cdf = torch.cumsum(hist, -1)
    scale = torch.tensor(255.0 / tile_area, dtype=torch.float32)
    luts = torch.clamp(torch.round(cdf * scale), 0, 255).reshape(-1)   # (T·256,)

    # bilinear blend of the neighbouring tiles' LUTs at each pixel's value
    y0, y1, wy0, wy1, y_two = _tile_weights(hh, th, ty, dev)
    x0, x1, wx0, wx1, x_two = _tile_weights(ww, tw, tx, dev)

    def lut(ty_idx, tx_idx):
        return luts[(ty_idx[:, None] * tx + tx_idx[None, :]) * 256 + vals]

    def rows(tx_idx):
        upper = lut(y0, tx_idx) * wy0[:, None]
        lower = lut(y1, tx_idx) * wy1[:, None]
        return torch.where(y_two[:, None], upper + lower, upper)

    # the column sum rounds once, as the fused multiply-add that the JAX
    # package's second einsum compiles to on the CPU: right·wx1 + left in
    # float64, where the product of two f32 values is exact.  Summed in
    # plain f32 instead, the locks of
    # ``tests/test_torch_engine.py::test_orb_slice_matches_jax`` part at
    # frame 5: 2.8% of the output pixels then differ by more than a level.
    left = rows(x0) * wx0[None, :]
    right = rows(x1).double() * wx1.double()[None, :]
    out = torch.where(x_two[None, :], (right + left.double()).float(), left)
    return out[:h, :w]


def preprocess_for_registration(gray: torch.Tensor, clip_limit: float = 2.0,
                                tiles: Tuple[int, int] = (8, 8),
                                median_ksize: int = 5) -> torch.Tensor:
    """The reference's preprocessing chain of the lock modes on an (H, W)
    gray image; every stage holds integer values, like the reference's u8
    Mats."""
    x = torch.clamp(torch.round(gray.float()), 0.0, 255.0)
    x = median_blur(x, median_ksize)
    x = torch.clamp(sharpen3(x), 0.0, 255.0)
    x = torch.clamp(torch.round(clahe(x, clip_limit, tiles)), 0.0, 255.0)
    return median_blur(x, median_ksize)
