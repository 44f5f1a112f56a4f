"""The plain reference that decides ``correct``: a frozen copy of the
program's GLOBAL_SMOOTHING pipeline in plain PyTorch (``step.py``,
``chunk.py`` and the ops they call), with the plain two-pass warp in place
of the program's CUDA kernel.  It imports nothing of the program and takes
nothing the program made: it starts from the footage the harness made and
the key words the harness gave.

A stream's state in this mode is windowed: the output of step j depends
on frames j-W+1 .. j and on the frame counter alone (W the window).  So
the reference starts a fresh carry at step ``first - (W - 1)`` (rounded
down to a whole chunk) with the counter set there, and gives the outputs
of steps ``first ..`` that a run from step 0 gives.
"""

from __future__ import annotations

from typing import Callable

import torch

from portbench.reference import prng, step  # noqa: F401  (prng: the key words)
from portbench.reference.chunk import offline_batched_chunk_step, offline_config
from portbench.reference.config import StabilizerConfig
from portbench.reference.state import init_batched_carry, init_carry
from portbench.reference.step import check_config, stabilize_step

PRECISIONS = ("float32", "tf32", "bf16")


def set_precision(precision: str) -> None:
    """float32 with TF32 off, as the configurations state.  The controls:
    ``"tf32"``, the next precision below (matrix products in TF32), and
    ``"bf16"``, the working gray images (what GFTT and LK read) rounded to
    bfloat16."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    step.GRAY_DTYPE = torch.bfloat16 if precision == "bf16" else torch.float32


def start_step(first: int, window: int, chunk: int = 1) -> int:
    """The step a fresh carry starts at to give step ``first``'s output."""
    return max(0, (first - (window - 1)) // chunk * chunk)


def streaming_outputs(config: StabilizerConfig, mode: int, frame_at: Callable, key_words,
                      first: int, stop: int, device, precision: str = "float32"
                      ) -> torch.Tensor:
    """(stop - first, Hf, Wf, C) uint8: the streaming step's outputs of steps
    ``first .. stop - 1``; ``frame_at(j)`` is step j's (Hf, Wf, C) frame."""
    check_config(config, mode)
    set_precision(precision)
    try:
        t0 = start_step(first, config.total_window)
        carry = init_carry(config, key_words, device, n0=t0)
        outs = []
        for j in range(t0, stop):
            carry, out = stabilize_step(carry, frame_at(j).to(device), config)
            if j >= first:
                outs.append(out)
        return torch.stack(outs)
    finally:
        set_precision("float32")


def chunk_outputs(config: StabilizerConfig, mode: int, frames_at: Callable, key_words,
                  streams: int, chunk: int, first: int, stop: int, device,
                  precision: str = "float32") -> torch.Tensor:
    """(S, stop - first, Hf, Wf, C) uint8: the stream-batched chunk's outputs
    of steps ``first .. stop - 1`` of S streams, in chunks of ``chunk``
    aligned at step 0; ``frames_at(steps)`` is (S, len(steps), Hf, Wf, C)."""
    check_config(config, mode)
    set_precision(precision)
    try:
        cfg = offline_config(config)
        t0 = start_step(first, cfg.total_window, chunk)
        carry = init_batched_carry(cfg, streams, key_words, device, n0=t0)
        outs = []
        for c in range(t0, stop, chunk):
            carry, out = offline_batched_chunk_step(
                carry, frames_at(list(range(c, c + chunk))).to(device), cfg)
            lo, hi = max(first - c, 0), min(stop - c, chunk)
            if lo < hi:
                outs.append(out[:, lo:hi])
        return torch.cat(outs, 1)
    finally:
        set_precision("float32")


def bytes_off(prog: torch.Tensor, ref: torch.Tensor, frame_dims: int) -> float:
    """The largest share, over the frames of ``prog`` and ``ref`` (same
    shape, uint8, each frame its last ``frame_dims`` dims), of a frame's
    bytes that differ from the reference."""
    if prog.shape != ref.shape:
        raise ValueError(f"shapes differ: {tuple(prog.shape)} vs {tuple(ref.shape)}")
    if not prog.numel():
        return 0.0
    diff = prog.to(ref.device) != ref
    return float(diff.flatten(-frame_dims).double().mean(-1).max())


def checks(prog: torch.Tensor, ref: torch.Tensor, frame_dims: int, limits: dict) -> dict:
    """The number compared, with its limit: ``out_bytes_off``, of
    :func:`bytes_off`."""
    return {"out_bytes_off": {"value": bytes_off(prog, ref, frame_dims),
                              "limit": limits["out_bytes_off"]}}
