"""SIFT detect + describe: DoG scale space, fixed shapes, batched binning.

Port of ``video_stabilization_tpu/ops/sift.py`` (cv::SIFT with the
reference's settings, src/stabilizer.cpp:496-507: 2,500-feature budget, 3
octave layers, contrast threshold 0.04, edge threshold 5, sigma 1.2), with
the same deviations from OpenCV: no initial 2x upsampling unless
``SIFTConfig.upsample_2x``, a 2-D quadratic subpixel fit at the detected
layer, one orientation per keypoint unless ``SIFTConfig.multi_orientation``.

- **Scale space**: per octave, ``n_octave_layers + 3`` Gaussian images by
  separable incremental blurs with reflect-101 borders; DoG differences.
- **Extrema**: 3x3x3 window extrema (``max_pool2d``; the minimum as
  ``-max_pool2d(-x)``, both padded with -inf as ``reduce_window`` pads),
  a contrast prefilter and the 2x2 Hessian edge test on wrapped neighbours
  (``torch.roll``, as ``jnp.roll``).
- **Per-layer top-k** with area-proportional budgets, by a stable
  descending sort: ``lax.top_k`` takes equal values (the many zero
  responses of a small image) by the lower index, ``torch.topk`` promises
  no order.
- **Orientation and descriptor**: each keypoint's 32x32 gradient patch (one
  gather of the bf16-rounded gradients, as the JAX package's one-hot
  matmuls round them), a 36-bin orientation histogram and the 4x4x8
  descriptor, each as a batched contraction of weighted one-hot maps over a
  layer's keypoints.  No scatter: float atomics would add in another order
  on every run, and the step must give the same bits from run to run.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, fields, replace

import numpy as np
import torch
import torch.nn.functional as F

from video_stabilization_tpu_torch.config import SIFTConfig
from video_stabilization_tpu_torch.ops.gftt import top_k_stable
from video_stabilization_tpu_torch.ops.image import resize_bilinear
from video_stabilization_tpu_torch.ops.patches import extract_patches
from video_stabilization_tpu_torch.ops.pyramid import _reflect101_pad
from video_stabilization_tpu_torch.utils.stage_profile import stage

_N_ORI_BINS = 36
_DESC_PATCH = 32          # axis-aligned gradient patch side for descriptors
_TWO_PI = 2 * math.pi


@dataclass
class SIFTFeatures:
    points: torch.Tensor    # (N, 2) f32 image coords at input resolution
    angle: torch.Tensor     # (N,) f32 radians
    response: torch.Tensor  # (N,) f32 |DoG| response
    size: torch.Tensor      # (N,) f32 keypoint diameter at input resolution
    desc: torch.Tensor      # (N, 128) f32 L2-normalized descriptors
    mask: torch.Tensor      # (N,) bool


def _fix_capacity(feats: SIFTFeatures, cap: int) -> SIFTFeatures:
    """Pad with zeros, or keep the ``cap`` strongest valid slots (ties to the
    lower index), so the carry's reference has a fixed shape."""
    n = feats.points.shape[0]
    if n == cap:
        return feats
    if n < cap:
        def pad(x):
            return F.pad(x, (0, 0) * (x.dim() - 1) + (0, cap - n))
        return SIFTFeatures(**{f.name: pad(getattr(feats, f.name)) for f in fields(feats)})
    score = torch.where(feats.mask, feats.response, -torch.inf)
    _, idx = top_k_stable(score, cap)
    return SIFTFeatures(**{f.name: getattr(feats, f.name)[idx] for f in fields(feats)})


def _fma_taps(x: torch.Tensor, kernel, n: int, axis: int) -> torch.Tensor:
    """sum_i kernel[i]·x[i : i + n] along ``axis``, rounded as the JAX
    package's compiled CPU code contracts the taps into fused multiply-adds:
    fma(k0, x0, k1·x1), then fma(k_i, x_i, acc) for i >= 2.  Emulated in
    float64, where the product of two f32 values is exact, with one f32
    rounding per tap (each tap one kernel: a float64 add written to f32)."""
    x64 = x.double()
    acc = torch.empty(x64.narrow(axis, 0, n).shape, dtype=torch.float32, device=x.device)
    nxt = torch.empty_like(acc)
    torch.mul(x64.narrow(axis, 1, n), kernel[1], out=acc)
    for i in [0] + list(range(2, len(kernel))):
        torch.add(acc, x64.narrow(axis, i, n), alpha=kernel[i], out=nxt)
        acc, nxt = nxt, acc
    return acc


def _gauss_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of an (H, W) map with a static f32 kernel and
    reflect-101 borders, rounded as the compiled JAX function rounds it
    (:func:`_fma_taps`): the DoG extrema and the top-k order depend on the
    last bit where neighbouring values tie."""
    radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = [float(v) for v in (k / k.sum()).astype(np.float32)]
    rows = _fma_taps(_reflect101_pad(img, radius, 0), k, img.shape[0], 0)
    return _fma_taps(_reflect101_pad(rows, radius, 1), k, img.shape[1], 1)


def _win_max(x: torch.Tensor) -> torch.Tensor:
    """3x3 window maximum, -inf outside the map."""
    return F.max_pool2d(x[None, None], 3, stride=1, padding=1)[0, 0]


def _extrema_mask(dog_prev, dog_cur, dog_next, contrast_thresh, edge_thresh):
    """3x3x3 extrema + contrast + edge tests on one DoG layer."""
    is_max = ((dog_cur >= _win_max(dog_cur))
              & (dog_cur > _win_max(dog_prev))
              & (dog_cur > _win_max(dog_next)))
    is_min = ((dog_cur <= -_win_max(-dog_cur))
              & (dog_cur < -_win_max(-dog_prev))
              & (dog_cur < -_win_max(-dog_next)))
    strong = dog_cur.abs() > contrast_thresh

    # 2x2 spatial Hessian edge rejection: tr²/det < (r+1)²/r, wrapped
    d = dog_cur
    r = torch.roll
    dxx = r(d, -1, 1) + r(d, 1, 1) - 2 * d
    dyy = r(d, -1, 0) + r(d, 1, 0) - 2 * d
    dxy = 0.25 * (r(r(d, -1, 0), -1, 1) + r(r(d, 1, 0), 1, 1)
                  - r(r(d, -1, 0), 1, 1) - r(r(d, 1, 0), -1, 1))
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    e = edge_thresh
    not_edge = (det > 0) & (tr * tr * e < (e + 1) * (e + 1) * det)
    return (is_max | is_min) & strong & not_edge


def _subpixel_xy(dog: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor):
    """2-D quadratic offsets at integer extrema (clamped 3x3 gathers)."""
    h, w = dog.shape

    def at(dy, dx):
        return dog[(ys + dy).clamp(0, h - 1), (xs + dx).clamp(0, w - 1)]

    dx = 0.5 * (at(0, 1) - at(0, -1))
    dy = 0.5 * (at(1, 0) - at(-1, 0))
    dxx = at(0, 1) + at(0, -1) - 2 * at(0, 0)
    dyy = at(1, 0) + at(-1, 0) - 2 * at(0, 0)
    dxy = 0.25 * (at(1, 1) + at(-1, -1) - at(1, -1) - at(-1, 1))
    det = dxx * dyy - dxy * dxy
    det = torch.where(det.abs() > 1e-10, det, 1.0)
    ox = (-(dyy * dx - dxy * dy) / det).clamp(-0.5, 0.5)
    oy = (-(dxx * dy - dxy * dx) / det).clamp(-0.5, 0.5)
    return ox, oy


@functools.lru_cache(maxsize=64)
def _patch_constants(sigma_kp: float, device: torch.device):
    """(ori_w, offx, offy): the orientation window and the coordinates of
    the 32x32 patch pixels about the keypoint, (P²,) f32 on ``device``;
    computed in numpy as the JAX package's constants are, and uploaded once
    per scale and device."""
    d = np.arange(_DESC_PATCH) - _DESC_PATCH // 2 + 0.5
    offy = np.tile(d[:, None], (1, _DESC_PATCH)).reshape(-1).astype(np.float32)
    offx = np.tile(d[None, :], (_DESC_PATCH, 1)).reshape(-1).astype(np.float32)
    r2 = offx ** 2 + offy ** 2
    # orientation window: Gaussian sigma = 1.5 sigma_kp, radius 4.5 sigma
    ori_sigma = 1.5 * sigma_kp
    ori_w = np.exp(-r2 / (2 * ori_sigma ** 2)).astype(np.float32)
    ori_w = np.where(r2 <= (4.5 * ori_sigma) ** 2, ori_w, 0.0).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (ori_w, offx, offy))


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of the integer-valued ``idx`` over ``n`` classes (an
    elementwise comparison: no scatter, no range check on the host)."""
    return (idx.long()[..., None] == torch.arange(n, device=idx.device)).float()


def _orient_and_describe(gx: torch.Tensor, gy: torch.Tensor, pts: torch.Tensor,
                         mask: torch.Tensor, sigma_kp: float,
                         multi_orientation: bool = False, ori_peak_ratio: float = 0.8):
    """Orientation + 128-d descriptor of the (N,) keypoints ``pts`` of one
    scale layer with gradients ``gx``, ``gy``: (angles, descs), or with
    ``multi_orientation`` (angles, descs, angles2, descs2, has2), the
    strongest secondary histogram peak >= ``ori_peak_ratio`` · max (cv2's
    duplicate keypoint)."""
    dev = gx.device
    half = _DESC_PATCH // 2
    pad = half + 1
    ori_w, offx, offy = _patch_constants(sigma_kp, dev)

    # descriptor geometry: 4x4 spatial bins, bin width 3 sigma_kp
    bin_w = 3.0 * sigma_kp

    planes = F.pad(torch.stack([gx, gy]), (pad, pad, pad, pad))
    hp, wp = planes.shape[1], planes.shape[2]
    iy_tl = (pts[:, 1].to(torch.int32) + (pad - half)).clamp(0, hp - _DESC_PATCH)
    ix_tl = (pts[:, 0].to(torch.int32) + (pad - half)).clamp(0, wp - _DESC_PATCH)
    patches = extract_patches(planes, iy_tl, ix_tl, _DESC_PATCH)   # (N, 2, P, P)
    n = patches.shape[0]
    pgx = patches[:, 0].reshape(n, -1)
    pgy = patches[:, 1].reshape(n, -1)

    mag = torch.sqrt(pgx * pgx + pgy * pgy)
    ang = torch.atan2(pgy, pgx)

    # orientation: 36-bin weighted histogram, smoothed, peak
    bins = torch.remainder(ang / _TWO_PI * _N_ORI_BINS, _N_ORI_BINS)
    b0 = torch.floor(bins)
    fb = bins - b0
    b0i = b0.to(torch.int64) % _N_ORI_BINS
    two_hot = ((1 - fb)[..., None] * _one_hot(b0i, _N_ORI_BINS)
               + fb[..., None] * _one_hot((b0i + 1) % _N_ORI_BINS, _N_ORI_BINS))
    wmag = mag * ori_w
    hist = torch.bmm(wmag[:, None, :], two_hot)[:, 0]                # (N, 36)
    for _ in range(2):   # circular [1, 1, 1] / 3 smoothing, twice
        hist = (torch.roll(hist, 1, 1) + hist + torch.roll(hist, -1, 1)) / 3.0

    def peak_theta(peak):
        # parabola on the circular neighbourhood
        def h_at(i):
            return torch.gather(hist, 1, (i % _N_ORI_BINS)[:, None])[:, 0]
        hl, hc, hr = h_at(peak - 1), h_at(peak), h_at(peak + 1)
        denom = hl - 2 * hc + hr
        off = torch.where(denom.abs() > 1e-10, 0.5 * (hl - hr) / denom, 0.0)
        return (peak.float() + off) * (_TWO_PI / _N_ORI_BINS)

    peak = torch.argmax(hist, 1)                                     # first maximum
    theta = peak_theta(peak)

    def describe(th, keep):
        d = _describe_at(th, mag, ang, bin_w, offx, offy)
        return torch.where(keep[:, None], d, 0.0)

    if not multi_orientation:
        return theta, describe(theta, mask)

    # strongest secondary local peak (circular), cv2's 0.8 ratio
    is_local = (hist >= torch.roll(hist, 1, 1)) & (hist >= torch.roll(hist, -1, 1))
    bins_idx = torch.arange(_N_ORI_BINS, device=dev)[None, :]
    sec = torch.where(is_local & (bins_idx != peak[:, None]), hist, -torch.inf)
    peak2 = torch.argmax(sec, 1)
    sec_max = torch.gather(sec, 1, peak2[:, None])[:, 0]
    hist_max = torch.gather(hist, 1, peak[:, None])[:, 0]
    has2 = sec_max >= ori_peak_ratio * hist_max
    theta2 = peak_theta(peak2)
    return theta, describe(theta, mask), theta2, describe(theta2, mask & has2), has2


def _describe_at(theta, mag, ang, bin_w, offx, offy):
    """4x4x8 SIFT descriptors of the (N,) keypoints' (N, P²) gradient
    patches (``mag``, ``ang``) at orientations ``theta``: (N, 128), laid out
    [row bin][column bin][orientation bin] as the JAX package's einsum."""
    th = theta[:, None]
    c, s = torch.cos(-th), torch.sin(-th)
    u = (c * offx - s * offy) / bin_w          # descriptor-frame coords
    v = (s * offx + c * offy) / bin_w
    # the gradients are y-down, cv2's y-up: the relative angle is negated
    # before binning (see the JAX package)
    rel_ang = torch.remainder(th - ang, _TWO_PI)

    ub = u + 2.0 - 0.5                         # spatial bin coordinates
    vb = v + 2.0 - 0.5
    ob = rel_ang / _TWO_PI * 8.0
    w_desc = torch.exp(-(u * u + v * v) / (2 * 2.0 ** 2)) * mag

    u0, v0, o0 = torch.floor(ub), torch.floor(vb), torch.floor(ob)
    fu, fv, fo = ub - u0, vb - v0, ob - o0

    # trilinear weights as two contractions over the patch pixels: a
    # four-hot (row bin, column bin) map and a two-hot orientation map
    spatial = 0
    for dv in (0, 1):
        wv = (1 - fv) if dv == 0 else fv
        vi = v0 + dv
        v_ok = (vi >= 0) & (vi <= 3)
        for du in (0, 1):
            wu = (1 - fu) if du == 0 else fu
            ui = u0 + du
            u_ok = (ui >= 0) & (ui <= 3)
            cell = vi.clamp(0, 3) * 4 + ui.clamp(0, 3)
            w = torch.where(u_ok & v_ok, w_desc * wu * wv, 0.0)
            spatial = spatial + w[..., None] * _one_hot(cell, 16)
    o0i = o0.to(torch.int64)
    orient = ((1 - fo)[..., None] * _one_hot(o0i % 8, 8)
              + fo[..., None] * _one_hot((o0i + 1) % 8, 8))
    desc = torch.bmm(spatial.transpose(1, 2), orient)               # (N, 16, 8)
    d = desc.reshape(desc.shape[0], -1)
    norm = torch.linalg.vector_norm(d, dim=1, keepdim=True) + 1e-7
    d = torch.clamp_max(d / norm, 0.2)         # SIFT clip + renormalize
    return d / (torch.linalg.vector_norm(d, dim=1, keepdim=True) + 1e-7)


def sift_detect_and_compute(img: torch.Tensor,
                            config: SIFTConfig = SIFTConfig()) -> SIFTFeatures:
    """Detect + describe on an (H, W) float32 grayscale image (0..255)."""
    h, w = img.shape
    dev = img.device
    # the compiled JAX function multiplies by the f32 reciprocal
    img = img.float() * (1.0 / 255.0)
    if config.upsample_2x:
        # cv2 parity: the scale space on a 2x-upsampled base (assumed input
        # blur 0.5 doubles to 1.0); coordinates and sizes map back by 0.5
        work = resize_bilinear(img, 2 * h, 2 * w)
        base_sigma_inc = math.sqrt(max(config.sigma ** 2 - 1.0, 0.01))
        coord_scale = 0.5
    else:
        work = img
        base_sigma_inc = config.sigma
        coord_scale = 1.0
    wh, ww = work.shape
    n_layers = config.n_octave_layers
    n_octaves = max(1, int(math.floor(math.log2(min(wh, ww) / 32.0))) + 1)
    k = 2.0 ** (1.0 / n_layers)
    contrast = 0.5 * config.contrast_threshold / n_layers

    # per-octave budgets proportional to area, trimmed to max_features
    weights = [0.25 ** i for i in range(n_octaves)]
    total_w = sum(weights)
    budgets = [max(32, int(round(config.max_features * wt / total_w))) for wt in weights]
    while sum(budgets) > config.max_features:
        budgets[budgets.index(max(budgets))] -= sum(budgets) - config.max_features

    # the Gaussian scale space: n_layers + 3 images per octave, each octave
    # from the previous one's layer n_layers taken at every second pixel
    with stage("sift_scale_space"):
        octaves = []
        octave_img = _gauss_blur(work, base_sigma_inc)
        for octave in range(n_octaves):
            gauss = [octave_img]
            sig_prev = config.sigma
            for i in range(1, n_layers + 3):
                sig_total = config.sigma * (k ** i)
                sig_inc = math.sqrt(max(sig_total ** 2 - sig_prev ** 2, 0.01))
                gauss.append(_gauss_blur(gauss[-1], sig_inc))
                sig_prev = sig_total
            octaves.append(gauss)
            octave_img = gauss[n_layers][::2, ::2]

    parts = []
    for octave, gauss in enumerate(octaves):
        oh, ow = gauss[0].shape
        oct_scale = (2.0 ** octave) * coord_scale
        dog = [gauss[i + 1] - gauss[i] for i in range(n_layers + 2)]

        budget_layer = max(16, budgets[octave] // n_layers)
        # keep clear of the border for patch extraction
        border = 8
        valid_region = torch.zeros((oh, ow), dtype=torch.bool, device=dev)
        if oh > 2 * border and ow > 2 * border:
            valid_region[border:-border, border:-border] = True
        for layer in range(1, n_layers + 1):
            mask2d = _extrema_mask(dog[layer - 1], dog[layer], dog[layer + 1],
                                   contrast, config.edge_threshold)
            resp = torch.where(mask2d & valid_region, dog[layer].abs(), 0.0)
            top, idx = top_k_stable(resp.reshape(-1), budget_layer)
            ys, xs = idx // ow, idx % ow
            kp_mask = top > 0
            ox, oy = _subpixel_xy(dog[layer], ys, xs)
            pts_layer = torch.stack([xs.float() + ox, ys.float() + oy], -1)

            sigma_kp = config.sigma * (k ** layer)
            gl = gauss[layer]
            gx = 0.5 * (torch.roll(gl, -1, 1) - torch.roll(gl, 1, 1))
            gy = 0.5 * (torch.roll(gl, -1, 0) - torch.roll(gl, 1, 0))
            res = _orient_and_describe(gx, gy, pts_layer, kp_mask, sigma_kp,
                                       multi_orientation=config.multi_orientation,
                                       ori_peak_ratio=config.ori_peak_ratio)
            size = torch.full((budget_layer,), 2.0 * sigma_kp * oct_scale,
                              dtype=torch.float32, device=dev)
            parts.append(SIFTFeatures(points=pts_layer * oct_scale, angle=res[0],
                                      response=top, size=size, desc=res[1], mask=kp_mask))
            if config.multi_orientation:
                # the second keypoint at the secondary peak, with a slightly
                # lower response so capacity truncation prefers the primary
                ang2, desc2, has2 = res[2:]
                parts.append(SIFTFeatures(points=pts_layer * oct_scale, angle=ang2,
                                          response=top * 0.999, size=size, desc=desc2,
                                          mask=kp_mask & has2))

    feats = SIFTFeatures(**{f.name: torch.cat([getattr(p, f.name) for p in parts])
                            for f in fields(SIFTFeatures)})
    feats = _fix_capacity(feats, config.max_features)
    # relative keypoint-size filter (reference ratio 0.05 for SIFT,
    # src/stabilizer.cpp:496-507, filterKeypointByRelativeSize :290-309)
    keep = feats.size <= (h * config.max_keypoint_size_ratio)
    return replace(feats, mask=feats.mask & keep)
