"""The streaming step of the plain reference: a frozen copy of the
program's ``engine/stabilizer.py`` for the cells' configurations, in plain
PyTorch, with no kernel of the program.

Kept: the stages of GLOBAL_SMOOTHING with the rigid motion model and the
cell GFTT selection: working gray + pyramid, dense LK, RANSAC similarity
and the removal of its isotropic scale, the ring updates, the smoothing
homography, the rotation split and the plain two-pass warp of the
presentation frame.  Left out, and refused: the lock modes, the other motion
models, ``reference_compat`` and host GFTT (no cell runs them).
"""

from __future__ import annotations

from typing import Tuple

import torch

from portbench.reference.config import StabilizationMode, StabilizerConfig
from portbench.reference.smoothing import smoothing_homography
from portbench.reference.state import Carry
from portbench.reference.homography import remove_isotropic_scale
from portbench.reference.ransac import estimate_similarity_ransac
from portbench.reference.affine_warp import warp_affine
from portbench.reference.gftt import Corners, good_features_to_track
from portbench.reference.image import bgr_to_gray, resize_bilinear
from portbench.reference.lk import lk_track
from portbench.reference.pyramid import build_pyramid
from portbench.reference import prng


def check_config(config: StabilizerConfig, mode: int) -> None:
    """Refuse what this reference does not cover."""
    if (int(mode) != StabilizationMode.GLOBAL_SMOOTHING or config.reference_compat
            or config.ransac.motion_model != "rigid" or config.ransac.method != "vmapped"
            or config.gftt.selection != "cell" or config.lk.method != "dense"
            or config.lk.corner_polish_iters):
        raise ValueError("the reference covers GLOBAL_SMOOTHING with the rigid model, "
                         "dense LK without the corner polish and cell GFTT only")


# the working gray's precision: bfloat16 only in the control
# (``reference.set_precision``)
GRAY_DTYPE = torch.float32


def working_gray(frames: torch.Tensor, config: StabilizerConfig) -> torch.Tensor:
    """(..., Hf, Wf, C) u8 frames -> (..., wh, ww) f32 working gray: resize
    then gray, the reference's order."""
    wh, ww = config.working_size
    return bgr_to_gray(resize_bilinear(frames.float(), wh, ww)).to(GRAY_DTYPE).float()


def next_corners(gray: torch.Tensor, config: StabilizerConfig) -> Corners:
    """The corners for the next frame on (..., wh, ww) grays."""
    return good_features_to_track(gray, config.gftt)


def _fit_inter_frame(src, dst, status, key, config: StabilizerConfig, center):
    """RANSAC fit of the tracked correspondences -> (result, inter-frame T):
    the similarity fit, then removal of the isotropic scale about the image
    centre."""
    ransac = estimate_similarity_ransac(src, dst, status, key, config.ransac)
    t_rigid, _ = remove_isotropic_scale(ransac.h, center)
    return ransac, t_rigid


def frame_keys(base_key: torch.Tensor, n: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(k_ransac, k_lock) of frame ``n``: ``fold_in(key, 2n)`` and
    ``fold_in(key, 2n + 1)``, as in the JAX package."""
    return prng.fold_in(base_key, n * 2), prng.fold_in(base_key, n * 2 + 1)


def stabilized_outputs(h_smooth, pres_frames, frames, is_first, scale_factor,
                       projective_fallback: bool):
    """The step's tail over any leading dims (none for the streaming step,
    (S, K) for a chunk of S streams) in GLOBAL_SMOOTHING: the smoothing
    homography rescaled to full resolution and one batched warp of all
    (..., Hf, Wf, C) presentation frames, each with the border 0.5 · its
    mean colour; where ``is_first``, the new frame in ``frames`` passes
    through unwarped.  (The program splits the identity lock homography
    here too; in this mode that selects nothing.)  Returns outputs (...,
    Hf, Wf, C) u8."""
    h_scaled = h_smooth.clone()
    h_scaled[..., 0:2, 2] = h_smooth[..., 0:2, 2] / scale_factor
    pres = pres_frames.reshape((-1,) + pres_frames.shape[-3:]).float()
    border = 0.5 * pres.mean(dim=(1, 2))
    out = warp_affine(pres, h_scaled.reshape(-1, 3, 3), border_value=border,
                      projective_fallback=projective_fallback)
    warped_u8 = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return torch.where(is_first[..., None, None, None], frames.to(torch.uint8),
                       warped_u8.reshape(pres_frames.shape))


def stabilize_step(carry: Carry, frame: torch.Tensor, config: StabilizerConfig
                   ) -> Tuple[Carry, torch.Tensor]:
    """Process one (Hf, Wf, C) uint8 BGR frame -> (carry', output).
    ``carry.frames`` is updated in place."""
    dev = frame.device
    f32 = dict(dtype=torch.float32, device=dev)
    w = config.total_window
    future = config.future_frames
    wh, ww = config.working_size
    center = torch.tensor([ww / 2.0, wh / 2.0]).to(dev, non_blocking=True)
    scale_factor = torch.tensor(config.scale_factor).to(dev, non_blocking=True)
    eye = torch.eye(3, **f32)
    k_ransac, _ = frame_keys(carry.key, carry.n)

    # 1. working-res gray + pyramid
    gray = working_gray(frame, config)
    pyr = build_pyramid(gray, config.lk.pyramid_levels)

    # 2-3. track + inter-frame motion
    tracked = lk_track(carry.pyr_prev, pyr, carry.corners_prev, carry.corners_mask, config.lk)
    ransac, t_rigid = _fit_inter_frame(carry.corners_prev, tracked.points, tracked.status,
                                       k_ransac, config, center)
    is_first = carry.n == 0
    have_prev = carry.n >= 1
    t_new = torch.where(have_prev & ransac.valid, t_rigid, eye)

    # 4. ring updates
    n_after = carry.n + 1
    slot = torch.remainder(carry.n, w).long().view(1)
    frames = carry.frames
    frames.index_copy_(0, slot, frame.to(torch.uint8)[None])
    pushed_tr = torch.cat([carry.transforms[1:], t_new[None]], 0)
    pushed_tv = torch.cat([carry.tvalid[1:], torch.ones(1, dtype=torch.bool, device=dev)])
    transforms = torch.where(have_prev, pushed_tr, carry.transforms)
    tvalid = torch.where(have_prev, pushed_tv, carry.tvalid)

    # window geometry
    length = torch.clamp(n_after, max=w)
    num_tr = length - 1
    zero_i = torch.zeros_like(length)
    pres = torch.where(length > future, length - future - 1, zero_i)
    pres_abs = torch.where(n_after > future, n_after - future - 1, zero_i)
    pres_slot = torch.remainder(pres_abs, w).long().view(1)
    pres_frame = frames.index_select(0, pres_slot)[0].float()

    # 5. smoothing, then the rescale and warp
    h_smooth = smoothing_homography(transforms, tvalid, pres, num_tr, False)
    output = stabilized_outputs(h_smooth, pres_frame, frame, is_first, scale_factor,
                                config.warp_projective_fallback)

    # 10. features for the next frame
    corners = next_corners(gray, config)
    return Carry(frames=frames, transforms=transforms, tvalid=tvalid, pyr_prev=pyr,
                 corners_prev=corners.points, corners_mask=corners.mask, n=n_after,
                 key=carry.key), output
