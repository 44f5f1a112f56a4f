"""Shi-Tomasi corners (goodFeaturesToTrack), fixed shape.

Port of ``video_stabilization_tpu/ops/gftt.py``.  Two selections
(``GFTTConfig.selection``):

- ``"cell"`` (also what ``"host"`` runs here, as in the JAX package: the
  host stage, ``ops/gftt_host.py``, replaces the list afterwards):
  min-eigenvalue response -> relative quality threshold -> strict 3x3 NMS
  -> best survivor per min-distance cell -> the top ``max_features`` cells;
- ``"cv2exact"``: cv2's own pipeline, whose greedy response-ordered
  min-distance suppression is computed as a parallel priority-MIS fixpoint
  (:func:`_greedy_cv2exact`): a candidate is accepted iff no accepted
  higher-response candidate lies within minDistance.

``lax.top_k`` breaks ties by the lower index; ``torch.topk`` promises no
order, so the port sorts stably instead.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from portbench.reference.config import GFTTConfig
from portbench.reference.gradients import box_sum, sobel_xy


@dataclass
class Corners:
    points: torch.Tensor    # (..., max_corners, 2) f32 (x, y)
    response: torch.Tensor  # (..., max_corners) f32
    mask: torch.Tensor      # (..., max_corners) bool


def min_eig_response(img: torch.Tensor, block_size: int = 3) -> torch.Tensor:
    """Per-pixel smaller eigenvalue of the structure tensor (Sobel 3x3,
    ``block_size`` box window, reflect-101 borders)."""
    ix, iy = sobel_xy(img)
    a = box_sum(ix * ix, block_size)
    b = box_sum(ix * iy, block_size)
    c = box_sum(iy * iy, block_size)
    half_tr = 0.5 * (a + c)
    disc = torch.sqrt(torch.square(0.5 * (a - c)) + torch.square(b))
    return half_tr - disc


def _nms3(resp: torch.Tensor) -> torch.Tensor:
    """Keep 3x3 local maxima of (..., H, W) (ties keep all); -inf outside
    the image."""
    planes = resp.reshape((-1, 1) + resp.shape[-2:])
    neigh = F.max_pool2d(planes, 3, stride=1, padding=1).reshape(resp.shape)
    return torch.where(resp >= neigh, resp, torch.full_like(resp, -torch.inf))


def top_k_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index (``lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# rounds of the greedy fixpoint between two host reads of "anything left
# undecided?": rounds after the fixpoint change nothing, so checking every
# few rounds keeps the list exact and costs one host sync per few rounds
GREEDY_CHECK_EVERY = 8


def good_features_to_track(img: torch.Tensor, config: GFTTConfig = GFTTConfig(),
                           min_distance: float | None = None) -> Corners:
    """Up to ``config.max_features`` corners on each (..., H, W) float image;
    every field gains the image's leading dims, and each image gives what a
    call on it alone gives (the quality threshold and the top-k are per
    image).  ``config.selection`` picks the method (module docstring)."""
    if config.selection == "cv2exact":
        return good_features_to_track_cv2exact(img, config, min_distance)
    h, w = img.shape[-2], img.shape[-1]
    if min_distance is None:
        min_distance = config.min_distance_at_720 * (h / 720.0)
    cell = max(int(min_distance), 1)

    resp = min_eig_response(img, config.block_size)
    thresh = config.quality_level * resp.amax((-2, -1), keepdim=True)
    resp = torch.where(resp >= thresh, resp, torch.full_like(resp, -torch.inf))
    resp = _nms3(resp)

    gh, gw = -(-h // cell), -(-w // cell)
    rp = F.pad(resp, (0, gw * cell - w, 0, gh * cell - h), value=-torch.inf)
    cells = (rp.unflatten(-1, (gw, cell)).unflatten(-3, (gh, cell))
             .transpose(-3, -2).flatten(-2))                     # (..., gh, gw, cell²)
    best_in_cell = torch.argmax(cells, -1)                       # first maximum
    best_resp = torch.gather(cells, -1, best_in_cell[..., None])[..., 0]

    dev = img.device
    cy = torch.arange(gh, device=dev)[:, None] * cell + best_in_cell // cell
    cx = torch.arange(gw, device=dev)[None, :] * cell + best_in_cell % cell
    flat_resp = best_resp.flatten(-2)
    flat_x = cx.flatten(-2).float()
    flat_y = cy.flatten(-2).float()

    k = config.max_features
    n_cells = flat_resp.shape[-1]
    if n_cells < k:
        flat_resp = F.pad(flat_resp, (0, k - n_cells), value=-torch.inf)
        flat_x = F.pad(flat_x, (0, k - n_cells))
        flat_y = F.pad(flat_y, (0, k - n_cells))

    top_resp, top_idx = top_k_stable(flat_resp, k)
    points = torch.stack([flat_x.gather(-1, top_idx), flat_y.gather(-1, top_idx)], -1)
    mask = torch.isfinite(top_resp)
    points = torch.where(mask[..., None], points, 0.0)
    return Corners(points=points, response=torch.where(mask, top_resp, 0.0), mask=mask)
