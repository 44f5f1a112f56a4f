"""Carry state across packages and processes as named numpy arrays.

The engine's only parameters are its state, so this is how "weights" cross
between the JAX package and the port.  The layout is that of the JAX
package's ``engine/checkpoint.py::save_carry``: one array per leaf, keyed by
its pytree path (``.frames``, ``.pyr_prev[0]``, ``.orb_ref.desc``, ...), the
PRNG key as its uint32 ``key_data`` under ``.key``.
"""

from __future__ import annotations

from dataclasses import fields
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from video_stabilization_tpu_torch.engine.state import EngineCarry, RegistrationRef


def _leaves(obj, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    for f in fields(obj):
        val = getattr(obj, f.name)
        name = f"{prefix}.{f.name}"
        if isinstance(val, RegistrationRef):
            yield from _leaves(val, name)
        elif isinstance(val, tuple):
            for i, leaf in enumerate(val):
                yield f"{name}[{i}]", leaf
        else:
            yield name, val


def carry_to_numpy(carry: EngineCarry) -> Dict[str, np.ndarray]:
    """The carry as ``{pytree path: array}``; the key as uint32 words."""
    out = {name: leaf.detach().cpu().numpy() for name, leaf in _leaves(carry)}
    out[".key"] = out[".key"].astype(np.uint32)
    return out


def carry_from_numpy(arrays: Dict[str, np.ndarray], device) -> EngineCarry:
    """Build a carry on ``device`` from ``{pytree path: array}`` (the layout
    :func:`carry_to_numpy` and the JAX package's ``save_carry`` write)."""
    def take(name: str) -> torch.Tensor:
        if name not in arrays:
            raise KeyError(f"carry field {name} missing from the arrays")
        a = np.asarray(arrays[name])
        if name == ".key":
            a = a.astype(np.int64)
        # a copy, 0-d arrays kept 0-d (``ascontiguousarray`` makes them
        # (1,)); the step writes the frame ring in place
        return torch.from_numpy(np.array(a, order="C")).to(device)

    def ref(prefix: str) -> RegistrationRef:
        return RegistrationRef(**{f.name: take(f"{prefix}.{f.name}")
                                  for f in fields(RegistrationRef)})

    n_levels = sum(1 for k in arrays if k.startswith(".pyr_prev["))
    kw = {}
    for f in fields(EngineCarry):
        name = f".{f.name}"
        if f.name in ("orb_ref", "sift_ref"):
            kw[f.name] = ref(name)
        elif f.name == "pyr_prev":
            kw[f.name] = tuple(take(f"{name}[{i}]") for i in range(n_levels))
        else:
            kw[f.name] = take(name)
    return EngineCarry(**kw)
