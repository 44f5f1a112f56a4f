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

from video_stabilization_tpu_torch.config import GFTTConfig
from video_stabilization_tpu_torch.ops.gradients import box_sum, sobel_xy


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


def _greedy_cv2exact(pts: torch.Tensor, resp: torch.Tensor, valid: torch.Tensor,
                     min_distance: float, k: int) -> Corners:
    """cv2's greedy min-distance suppression of (M, 2) candidates already
    sorted by response (descending), as a priority-MIS fixpoint: every round
    accepts each undecided candidate with no undecided or accepted
    higher-priority neighbour, and rejects each one with an accepted
    neighbour.  Neighbours are cv2's: strictly closer than ``min_distance``
    and in the 3x3 neighbourhood of ``round(min_distance)`` cells (so a
    pair slightly closer than min_distance but two cells apart does not
    suppress).  The first ``k`` accepted, in response order, are returned.
    The loop reads "anything undecided?" to the host every
    ``GREEDY_CHECK_EVERY`` rounds."""
    m = pts.shape[0]
    x, y = pts[:, 0], pts[:, 1]
    cell = max(int(round(min_distance)), 1)
    cx = torch.div(x.to(torch.int32), cell, rounding_mode="floor")
    cy = torch.div(y.to(torch.int32), cell, rounding_mode="floor")
    dx = x[:, None] - x[None, :]
    dy = y[:, None] - y[None, :]
    near_cell = ((cx[:, None] - cx[None, :]).abs() <= 1) & ((cy[:, None] - cy[None, :]).abs() <= 1)
    within = (dx * dx + dy * dy < min_distance * min_distance) & near_cell
    del dx, dy, near_cell
    # j suppresses i iff j precedes i in response order
    order = torch.arange(m, device=pts.device)
    adj = within & (order[None, :] < order[:, None]) & valid[:, None] & valid[None, :]
    del within

    acc = torch.zeros(m, dtype=torch.bool, device=pts.device)
    rej = torch.zeros_like(acc)
    rounds = 0
    while rounds < m:
        for _ in range(min(GREEDY_CHECK_EVERY, m - rounds)):
            und = valid & ~acc & ~rej
            sup = (adj & acc[None, :]).any(1)       # an accepted higher neighbour
            pend = (adj & und[None, :]).any(1)      # an undecided higher neighbour
            acc = acc | (und & ~sup & ~pend)
            rej = rej | (und & sup)
        rounds += GREEDY_CHECK_EVERY
        if not bool((valid & ~acc & ~rej).any()):
            break

    # the greedy stops after k acceptances: the first k accepted in response
    # order (decisions before the cap do not depend on it)
    keep = acc & (torch.cumsum(acc.to(torch.int32), 0) <= k)
    score = torch.where(keep, resp, torch.full_like(resp, -torch.inf))
    top_resp, idx = top_k_stable(score, k)
    mask = torch.isfinite(top_resp)
    points = torch.where(mask[:, None], pts[idx], 0.0)
    return Corners(points=points, response=torch.where(mask, top_resp, 0.0), mask=mask)


def good_features_to_track_cv2exact(img: torch.Tensor, config: GFTTConfig = GFTTConfig(),
                                    min_distance: float | None = None) -> Corners:
    """cv2.goodFeaturesToTrack's exact corner list on each (..., H, W)
    image: strict quality threshold (response > quality · max), 3x3
    dilate-compare NMS over the interior, response sort (ties to the lower
    scan index, as ``lax.top_k``), the greedy fixpoint."""
    h, w = img.shape[-2], img.shape[-1]
    if min_distance is None:
        min_distance = config.min_distance_at_720 * (h / 720.0)
    resp = min_eig_response(img, config.block_size)
    thresh = config.quality_level * resp.amax((-2, -1), keepdim=True)
    ninf = torch.full_like(resp, -torch.inf)
    cand = torch.where(resp > thresh, _nms3(resp), ninf)
    interior = torch.zeros((h, w), dtype=torch.bool, device=img.device)
    interior[1:-1, 1:-1] = True
    cand = torch.where(interior, cand, ninf)

    m = min(config.max_candidates, h * w)
    top, idx = top_k_stable(cand.flatten(-2), m)
    pts = torch.stack([(idx % w).float(), (idx // w).float()], -1)
    valid = torch.isfinite(top)
    lead = top.shape[:-1]
    items = [_greedy_cv2exact(p, r, v, float(min_distance), config.max_features)
             for p, r, v in zip(pts.reshape(-1, m, 2), top.reshape(-1, m),
                                valid.reshape(-1, m))]
    k = config.max_features
    return Corners(points=torch.stack([c.points for c in items]).reshape(lead + (k, 2)),
                   response=torch.stack([c.response for c in items]).reshape(lead + (k,)),
                   mask=torch.stack([c.mask for c in items]).reshape(lead + (k,)))


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
