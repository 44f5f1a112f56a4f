"""float32 matrix products whatever the caller set.

The port computes in float32: dense LK's box sums (``ops/lk_dense.py::
_box_same``) and the homography fits are matrix products, and TF32 would
cost them three decimal digits.  ``Stabilizer`` turns TF32 off for the
process; the chunk and batched-step entry points (and so serving's chunk)
run under :func:`in_float32` instead, so a library caller who turned TF32
on for its own work gets float32 inside the port's call and its own
setting back after it.
"""

from __future__ import annotations

import functools

import torch


def in_float32(fn):
    """``fn`` with cuBLAS matrix products in float32 (TF32 off) during each
    call, the caller's setting restored after it.  Through
    ``fp32_precision``, which reads the setting made by either of torch's
    switches (``allow_tf32`` raises once the other one set it)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        matmul = torch.backends.cuda.matmul
        before = matmul.fp32_precision
        matmul.fp32_precision = "ieee"
        try:
            return fn(*args, **kwargs)
        finally:
            matmul.fp32_precision = before
    return wrapped
