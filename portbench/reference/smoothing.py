"""Temporal-window trajectory smoothing — the GLOBAL_SMOOTHING brain.

Port of ``video_stabilization_tpu/engine/smoothing.py``:

    past side:    P_j = T[p-j]^-1 · P_{j-1}         (maps frame p -> p-j)
    future side:  F_j = T[p+j] · F_{j-1}            (maps frame p -> p+j+1)
    Q = ( Σ_j P_j + [I] + Σ_j F_j ) / count

with the reference's three quirks under ``reference_compat`` (future bound
excludes the newest transform, no identity term, right-chaining).  The JAX
package's ``associative_scan`` chains become a log-depth doubling scan of
batched 3x3 products; regrouping changes results by ~1e-6.
"""

from __future__ import annotations

import torch

from portbench.reference.warp import _inv3x3


def _prefix_products(a: torch.Tensor, left: bool) -> torch.Tensor:
    """Inclusive prefix products along the third-last axis of (..., n, 3, 3):
    out_j = A_j ··· A_0 (left) or A_0 ··· A_j (right), by Hillis-Steele
    doubling."""
    out = a
    shift = 1
    n = a.shape[-3]
    while shift < n:
        earlier, later = out[..., :-shift, :, :], out[..., shift:, :, :]
        prod = torch.matmul(later, earlier) if left else torch.matmul(earlier, later)
        out = torch.cat([out[..., :shift, :, :], prod], -3)
        shift *= 2
    return out


def smoothing_homography(
    transforms: torch.Tensor,
    tvalid: torch.Tensor,
    presentation_idx: torch.Tensor,
    num_transforms: torch.Tensor,
    reference_compat: bool = False,
) -> torch.Tensor:
    """Smoothing homography Q (..., 3, 3) of the presentation frame.

    ``transforms`` (..., W-1, 3, 3) chronological, newest last, of which the
    last ``num_transforms`` (...) slots are real; ``presentation_idx`` (...)
    is the presentation frame's chronological index over that suffix.  Each
    leading index is one window."""
    wm1 = transforms.shape[-3]
    dtype = transforms.dtype
    dev = transforms.device
    base = (wm1 - num_transforms)[..., None]
    p = presentation_idx[..., None]
    nt = num_transforms[..., None]
    eye = torch.eye(3, dtype=dtype, device=dev)
    ar = torch.arange(wm1, device=dev)

    def chrono_batch(idx):
        slot = (base + idx).clamp(0, wm1 - 1).long()
        t = torch.take_along_dim(transforms, slot[..., None, None], dim=-3)
        return t, tvalid.gather(-1, slot) & (idx >= 0) & (idx < nt)

    t_past, v_past = chrono_batch(p - (ar + 1))
    a_past = torch.where(v_past[..., None, None], _inv3x3(t_past), eye)
    past_terms = _prefix_products(a_past, left=True)

    last_allowed = nt - (2 if reference_compat else 1)
    fidx = p + ar
    t_fut, v_fut = chrono_batch(fidx)
    v_fut = v_fut & (fidx <= last_allowed)
    b_fut = torch.where(v_fut[..., None, None], t_fut, eye)
    future_terms = _prefix_products(b_fut, left=not reference_compat)

    zero = torch.zeros((), dtype=dtype, device=dev)
    h_sum = (torch.where(v_past[..., None, None], past_terms, zero).sum(-3)
             + torch.where(v_fut[..., None, None], future_terms, zero).sum(-3))
    count = v_past.sum(-1) + v_fut.sum(-1)
    if not reference_compat:
        h_sum = h_sum + eye
        count = count + 1
    h_avg = h_sum / count.clamp(min=1).to(dtype)[..., None, None]
    ok = (count > 0) & torch.isfinite(h_avg).flatten(-2).all(-1)
    return torch.where(ok[..., None, None], h_avg, eye)
