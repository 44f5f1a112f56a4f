"""The reference of the stream-sharded chunk, one slot at a time.

The program runs a mesh of D slots as D batches of S/D streams, slot d
holding streams ``d·S/D ..`` with the key rows ``prng.split(key, S)[d·S/D
..]``.  A batch's summation order follows its shape (dense LK's band
products, RANSAC's row sums), so the reference of a slot is that slot's
streams as one batch of S/D, started from their key rows: a batch of all S
would round differently.  :func:`slot_chunk_outputs` is
``chunk_outputs`` (``__init__.py``) with each slot's stream keys given, not
split, and the slots' chunks in turns.
"""

from __future__ import annotations

import torch

from portbench.reference import prng, set_precision, start_step
from portbench.reference.chunk import offline_batched_chunk_step, offline_config
from portbench.reference.config import StabilizerConfig
from portbench.reference.state import init_carry, map_carry
from portbench.reference.step import check_config


def slot_keys(key_words: torch.Tensor, streams: int, slots: int, slot: int) -> torch.Tensor:
    """(S/D, 2): the key rows of slot ``slot``'s streams of ``streams``
    over ``slots`` slots."""
    per = streams // slots
    return prng.split(key_words, streams)[slot * per:(slot + 1) * per]


def slot_chunk_outputs(config: StabilizerConfig, mode: int, slots, chunk: int, first: int,
                       stop: int, precision: str = "float32") -> list:
    """[(n, stop - first, Hf, Wf, C) uint8]: for each slot ``(frames_at,
    keys, device)`` the stream-batched chunk's outputs of steps ``first ..
    stop - 1`` of the n streams whose keys are the rows of ``keys`` (n, 2),
    as one batch on ``device``, in chunks of ``chunk`` aligned at step 0;
    ``frames_at(steps)`` is (n, len(steps), Hf, Wf, C).  The slots' chunks
    are enqueued in turns, so slots on several cards compute at once."""
    check_config(config, mode)
    set_precision(precision)
    try:
        cfg = offline_config(config)
        t0 = start_step(first, cfg.total_window, chunk)
        carries, outs = [], []
        for _, keys, device in slots:
            one = init_carry(cfg, keys[0], device, t0)
            carry = map_carry(lambda x: x[None].expand((len(keys),) + x.shape).clone(), one)
            carry.key = keys.to(device)
            carries.append(carry)
            outs.append([])
        for c in range(t0, stop, chunk):
            lo, hi = max(first - c, 0), min(stop - c, chunk)
            for d, (frames_at, _, device) in enumerate(slots):
                carries[d], out = offline_batched_chunk_step(
                    carries[d], frames_at(list(range(c, c + chunk))).to(device), cfg)
                if lo < hi:
                    outs[d].append(out[:, lo:hi])
        return [torch.cat(o, 1) for o in outs]
    finally:
        set_precision("float32")
