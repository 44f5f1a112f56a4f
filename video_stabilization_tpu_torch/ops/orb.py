"""ORB detect + describe: multi-scale FAST and steered BRIEF, fixed shapes.

Port of ``video_stabilization_tpu/ops/orb.py`` (cv::ORB with the reference's
settings, src/stabilizer.cpp:483-493).  Every level image is built first;
then FAST, 3x3 NMS and the edge-threshold border of every level at its
exact shape (``ops/fast.py::fast_levels``, one launch of the CUDA kernel on
the card), and per level the best responder per 4x4 (2x2 on small levels)
cell and the 7-tap Gaussian blur.  Then one top-k over every level's cell
winners, patch extraction per level, and one describe pass: the
intensity-centroid angle quantized to 72 bins, and 256 steered test pairs
read from the blurred patch.

The JAX package samples the descriptor with a 17.7 MB one-hot matmul over
patches rotated by multiples of 90°; here each keypoint gathers its bin's
256 + 256 linear indices (``_steered_lin``) from the unrotated patch, which
reads the same pixels.  Both read bf16-rounded patches
(``ops/patches.py``).  ``lax.top_k`` puts ties in index order, so the port
sorts stably wherever the JAX package takes a top-k.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.nn.functional as F

from video_stabilization_tpu_torch.config import ORBConfig
from video_stabilization_tpu_torch.ops.fast import fast_levels
from video_stabilization_tpu_torch.ops.gftt import top_k_stable
from video_stabilization_tpu_torch.ops.image import resize_bilinear
from video_stabilization_tpu_torch.ops.patches import extract_patches
from video_stabilization_tpu_torch.ops.pyramid import _reflect101_pad, _taps

PATCH_RADIUS = 15          # patchSize 31
_EXTRACT_RADIUS = 24       # covers the rotated test pairs' reach (15·√2 ≈ 21.2)
_EXTRACT = 2 * _EXTRACT_RADIUS + 1
N_ANGLE_BINS = 72

# the seeded-Gaussian BRIEF pairs of ``ORBConfig.pattern="brief"`` (x, y)
_rng = np.random.default_rng(20240816)
_P1 = np.clip(np.round(_rng.normal(0.0, PATCH_RADIUS / 2.0, (256, 2))), -15, 15)
_P2 = np.clip(np.round(_rng.normal(0.0, PATCH_RADIUS / 2.0, (256, 2))), -15, 15)
BRIEF_PATTERN_1 = np.asarray(_P1, np.float32)
BRIEF_PATTERN_2 = np.asarray(_P2, np.float32)

# intensity-centroid moments over the circular 31x31 patch
_yy, _xx = np.mgrid[-PATCH_RADIUS:PATCH_RADIUS + 1, -PATCH_RADIUS:PATCH_RADIUS + 1]
_CIRC = (_yy ** 2 + _xx ** 2) <= PATCH_RADIUS ** 2
CENTROID_X = np.asarray(_xx * _CIRC, np.float32)
CENTROID_Y = np.asarray(_yy * _CIRC, np.float32)

_G7 = np.exp(-0.5 * (np.arange(-3, 4) / 2.0) ** 2).astype(np.float32)
_G7 = [float(v) for v in _G7 / _G7.sum()]


def _steered_lin(pattern: np.ndarray) -> np.ndarray:
    """(72, 256) linear indices into the flattened 49x49 patch of the
    pattern rotated to each angle bin and rounded.  Bins m + 18k are exact
    90°·k rotations of bin m, as in the JAX package."""
    out = np.zeros((N_ANGLE_BINS, pattern.shape[0]), np.int32)
    n_res = N_ANGLE_BINS // 4
    for b in range(n_res):
        a = 2.0 * np.pi * b / N_ANGLE_BINS
        c, s = np.cos(a), np.sin(a)
        rx = np.clip(np.round(c * pattern[:, 0] - s * pattern[:, 1]),
                     -_EXTRACT_RADIUS, _EXTRACT_RADIUS).astype(np.int32)
        ry = np.clip(np.round(s * pattern[:, 0] + c * pattern[:, 1]),
                     -_EXTRACT_RADIUS, _EXTRACT_RADIUS).astype(np.int32)
        x, y = rx, ry
        for k in range(4):
            out[b + n_res * k] = (y + _EXTRACT_RADIUS) * _EXTRACT + (x + _EXTRACT_RADIUS)
            x, y = -y, x
    return out


@functools.lru_cache(maxsize=4)
def _pattern_tables(name: str):
    """The steered (72, 256) index tables of both members of each pair."""
    if name == "cv2":
        from video_stabilization_tpu_torch.ops.orb_pattern import CV2_ORB_P0, CV2_ORB_P1

        return _steered_lin(CV2_ORB_P0), _steered_lin(CV2_ORB_P1)
    if name == "brief":
        return _steered_lin(BRIEF_PATTERN_1), _steered_lin(BRIEF_PATTERN_2)
    raise ValueError(f"unknown ORB pattern {name!r} (use 'cv2' or 'brief')")


@functools.lru_cache(maxsize=8)
def _device_tables(name: str, device: torch.device):
    """(lin1, lin2, centroid x, centroid y) on ``device``, uploaded once."""
    lin1, lin2 = _pattern_tables(name)
    return (torch.from_numpy(lin1.astype(np.int64)).to(device),
            torch.from_numpy(lin2.astype(np.int64)).to(device),
            torch.from_numpy(CENTROID_X.reshape(-1)).to(device),
            torch.from_numpy(CENTROID_Y.reshape(-1)).to(device))


@dataclass
class ORBFeatures:
    points: torch.Tensor     # (N, 2) f32, level-0 pixel coords (x, y)
    angle: torch.Tensor      # (N,) f32 radians
    response: torch.Tensor   # (N,) f32 FAST score
    size: torch.Tensor       # (N,) f32 keypoint diameter at level 0
    desc: torch.Tensor       # (N, 256) int8 in {-1, +1} (0 on masked lanes)
    mask: torch.Tensor       # (N,) bool


def _gauss7(img: torch.Tensor) -> torch.Tensor:
    """7-tap Gaussian (sigma 2), reflect-101 (cv::ORB's GaussianBlur(7, 7,
    2, 2) of each level before sampling descriptors)."""
    h, w = img.shape[-2], img.shape[-1]
    rows = _taps(_reflect101_pad(img, 3, -2), _G7, h, -2)
    return _taps(_reflect101_pad(rows, 3, -1), _G7, w, -1)


def _level_budgets(total: int, n_levels: int, scale: float) -> list[int]:
    r = 1.0 / (scale * scale)
    weights = [r ** i for i in range(n_levels)]
    s = sum(weights)
    return [max(16, int(round(total * w / s))) for w in weights]


def _cell_reduce(score: torch.Tensor, cell: int):
    """Best responder per cell of one level's score map: (n_cells,) values
    and level-local float coords (first maximum within a cell)."""
    h, w = score.shape
    gh, gw = -(-h // cell), -(-w // cell)
    rp = F.pad(score, (0, gw * cell - w, 0, gh * cell - h))
    cells = rp.reshape(gh, cell, gw, cell).permute(0, 2, 1, 3).reshape(gh, gw, cell * cell)
    best_in = torch.argmax(cells, -1)
    best_val = cells.amax(-1)
    dev = score.device
    cy = torch.arange(gh, device=dev)[:, None] * cell + best_in // cell
    cx = torch.arange(gw, device=dev)[None, :] * cell + best_in % cell
    return best_val.reshape(-1), cy.reshape(-1).float(), cx.reshape(-1).float()


def _describe_patches(patches: torch.Tensor, mask: torch.Tensor, pattern: str = "cv2"):
    """Angles and steered-BRIEF descriptors of (N, 2, 49, 49) patches (raw,
    blurred): (angles (N,) f32, desc (N, 256) int8)."""
    n = patches.shape[0]
    lin1, lin2, cx, cy = _device_tables(pattern, patches.device)
    off = _EXTRACT_RADIUS - PATCH_RADIUS
    raw31 = patches[:, 0, off:off + 2 * PATCH_RADIUS + 1,
                    off:off + 2 * PATCH_RADIUS + 1].reshape(n, -1)
    m10 = raw31 @ cx
    m01 = raw31 @ cy
    angles = torch.atan2(m01, m10)
    bins = torch.remainder(
        torch.round(angles * (N_ANGLE_BINS / (2.0 * math.pi))).long(), N_ANGLE_BINS)
    blur = patches[:, 1].reshape(n, _EXTRACT * _EXTRACT)
    v0 = torch.gather(blur, 1, lin1[bins])
    v1 = torch.gather(blur, 1, lin2[bins])
    one = torch.ones((), dtype=torch.int8, device=patches.device)
    bits = torch.where(v0 < v1, one, -one)
    return angles, torch.where(mask[:, None], bits, torch.zeros_like(bits))


def _fix_capacity(feats: ORBFeatures, cap: int) -> ORBFeatures:
    """Pad, or keep the ``cap`` strongest valid slots, so the output has
    exactly ``cap`` slots however many levels fit the image."""
    n = feats.points.shape[0]
    if n == cap:
        return feats
    if n < cap:
        pad = cap - n
        return ORBFeatures(
            points=F.pad(feats.points, (0, 0, 0, pad)),
            angle=F.pad(feats.angle, (0, pad)),
            response=F.pad(feats.response, (0, pad)),
            size=F.pad(feats.size, (0, pad)),
            desc=F.pad(feats.desc, (0, 0, 0, pad)),
            mask=F.pad(feats.mask, (0, pad)),
        )
    score = torch.where(feats.mask, feats.response, -torch.inf)
    _, idx = top_k_stable(score, cap)
    return ORBFeatures(points=feats.points[idx], angle=feats.angle[idx],
                       response=feats.response[idx], size=feats.size[idx],
                       desc=feats.desc[idx], mask=feats.mask[idx])


def orb_detect_and_compute(img: torch.Tensor, config: ORBConfig = ORBConfig()
                           ) -> ORBFeatures:
    """Detect and describe on an (H, W) float32 gray image."""
    h, w = img.shape
    img = img.float().contiguous()
    dev = img.device
    budgets = _level_budgets(config.max_features, config.n_levels, config.scale_factor)
    e = config.edge_threshold

    # every level that fits, all resized from the input; then FAST, NMS and
    # the border of all of them at once, and per level the cell reduce and blur
    level_imgs = []
    for level in range(config.n_levels):
        lh = int(round(h / (config.scale_factor ** level)))
        lw = int(round(w / (config.scale_factor ** level)))
        if lh <= 2 * e or lw <= 2 * e:
            break
        level_imgs.append(resize_bilinear(img, lh, lw).contiguous() if level else img)
    scores = fast_levels(level_imgs, config.fast_threshold, e)
    levels = []
    vals, cys, cxs = [], [], []
    for level, (level_img, score) in enumerate(zip(level_imgs, scores)):
        lh, lw = level_img.shape
        v, cy, cx = _cell_reduce(score, 4 if min(lh, lw) >= 200 else 2)
        levels.append((level_img, _gauss7(level_img), lh, lw, config.scale_factor ** level))
        vals.append(v)
        cys.append(cy)
        cxs.append(cx)
    n_lv = len(levels)

    # one top-k over every level's cell winners (zero-padded rows)
    k0 = max(budgets[:n_lv])
    n_max = max([k0] + [v.shape[0] for v in vals])

    def stackpad(xs):
        return torch.stack([F.pad(x, (0, n_max - x.shape[0])) for x in xs])

    top, idx = top_k_stable(stackpad(vals), k0)                  # (L, k0)
    coords = torch.stack([stackpad(cxs), stackpad(cys)], 1)       # (L, 2, n_max)
    picked = torch.gather(coords, 2, idx[:, None, :].expand(n_lv, 2, k0))

    # patches per level, one describe pass over all of them
    all_pts, all_resp, all_size, all_mask, all_patches = [], [], [], [], []
    for level, (level_img, blur, lh, lw, scale) in enumerate(levels):
        nb = budgets[level]
        xs_l, ys_l = picked[level, 0, :nb], picked[level, 1, :nb]
        resp = top[level, :nb]
        iy = (torch.round(ys_l).long() - _EXTRACT_RADIUS).clamp(0, lh - _EXTRACT)
        ix = (torch.round(xs_l).long() - _EXTRACT_RADIUS).clamp(0, lw - _EXTRACT)
        all_patches.append(extract_patches(torch.stack([level_img, blur]), iy, ix,
                                           _EXTRACT))
        all_pts.append(torch.stack([xs_l, ys_l], -1) * scale)
        all_resp.append(resp)
        all_size.append(torch.full((nb,), config.patch_size * scale,
                                   dtype=torch.float32, device=dev))
        all_mask.append(resp > 0)

    mask_all = torch.cat(all_mask)
    angles, desc = _describe_patches(torch.cat(all_patches), mask_all, config.pattern)
    feats = ORBFeatures(points=torch.cat(all_pts), angle=angles,
                        response=torch.cat(all_resp), size=torch.cat(all_size),
                        desc=desc, mask=mask_all)
    feats = _fix_capacity(feats, config.max_features)
    # relative keypoint-size filter (reference: filterKeypointByRelativeSize,
    # src/stabilizer.cpp:290-309)
    keep = feats.size <= (h * config.max_keypoint_size_ratio)
    return replace(feats, mask=feats.mask & keep)
