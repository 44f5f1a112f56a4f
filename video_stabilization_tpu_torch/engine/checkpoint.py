"""Carry state across packages and processes: named numpy arrays and the
checkpoint files of ``--checkpoint`` / ``--resume``.

The engine's only parameters are its state, so this is how "weights" cross
between the JAX package and the port.  The layout is that of the JAX
package's ``engine/checkpoint.py::save_carry``: one array per leaf, keyed by
its pytree path (``.frames``, ``.pyr_prev[0]``, ``.orb_ref.desc``, ...), the
PRNG key as its uint32 ``key_data`` under ``.key``.  A checkpoint file is an
``.npz`` of ``leaf_i`` arrays in the JAX package's leaf order and a
``__meta__`` JSON list of ``{"kind": "array" | "prng_key", "name": path}``,
so a file written by either package loads in the other.
"""

from __future__ import annotations

import json
import warnings
from dataclasses import fields
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from video_stabilization_tpu_torch.engine.state import (
    EngineCarry, RegistrationRef, Sharded, unshard)


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


def save_carry(path: str, carry: EngineCarry) -> None:
    """Write ``carry`` (of one stream or of S) to ``path`` as an ``.npz``:
    ``leaf_i`` in leaf order, the key as its uint32 words, ``__meta__``.
    A ``Sharded`` carry writes the file of the same carry unsharded, its
    streams in order; :func:`load_carry` then ``parallel.shard_carry``
    restores it (the JAX package's "leaves re-sharded by the caller")."""
    if isinstance(carry, Sharded):
        carry = unshard(carry)
    arrays, meta = {}, []
    for i, (name, leaf) in enumerate(_leaves(carry)):
        arr = leaf.detach().cpu().numpy()
        if name == ".key":
            arrays[f"leaf_{i}"] = arr.astype(np.uint32)
            meta.append({"kind": "prng_key", "name": name})
        else:
            arrays[f"leaf_{i}"] = arr
            meta.append({"kind": "array", "name": name})
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def load_carry(path: str, template: EngineCarry) -> EngineCarry:
    """The carry saved in ``path`` by either package's ``save_carry``, on
    ``template``'s device with its dtypes.  ``template`` (a fresh
    ``init_carry`` of the same configuration) fixes the shapes: a field of
    another shape raises; a field the file lacks keeps the template's value
    and one the template lacks is ignored, each with a warning.  A file of
    the older positional layout (``__meta__`` a list of kinds) loads only
    when its leaf count matches."""
    data = np.load(path)
    meta = json.loads(bytes(data["__meta__"]).decode())
    t_leaves = list(_leaves(template))
    if meta and isinstance(meta[0], str):
        if len(meta) != len(t_leaves):
            raise ValueError(
                f"checkpoint {path} is from an older engine version ({len(meta)} leaves, "
                f"current carry has {len(t_leaves)}); positional restore would misalign "
                "fields — re-create it with the current version")
        meta = [{"kind": kind, "name": name} for kind, (name, _) in zip(meta, t_leaves)]
    by_name = {m["name"]: f"leaf_{i}" for i, m in enumerate(meta)}
    arrays = {}
    for name, t_leaf in t_leaves:
        want = t_leaf.detach().cpu().numpy()
        if name not in by_name:
            warnings.warn(f"checkpoint {path} has no entry for carry field {name} (saved by "
                          "an older engine version); keeping the fresh template value for it")
            arrays[name] = want
            continue
        arr = data[by_name.pop(name)]
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"checkpoint field {name} shape {tuple(arr.shape)} != config "
                             f"shape {tuple(want.shape)}")
        arrays[name] = arr.astype(want.dtype)
    for name in by_name:
        warnings.warn(f"checkpoint {path} field {name} does not exist in this engine "
                      "version; ignored")
    return carry_from_numpy(arrays, template.frames.device)
