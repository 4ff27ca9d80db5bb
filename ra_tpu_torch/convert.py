"""Engine state carried across: ``LaneState`` <-> ``<field>:<leaf>`` arrays.

The key scheme is the reference engine's checkpoint archive
(``ra_tpu/engine/lockstep.py`` ``LockstepEngine.save``): one numpy array
per leaf, keyed ``<field>:<j>`` with leaves in ``jax.tree.flatten`` order
(``telem:0..7``; ``mac:0`` for the counter).  So an archive written by
either engine restores into the other, and tests compare the two
engines' states leaf for leaf.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core.tree import tree_leaves, tree_unflatten


def state_to_numpy(state) -> dict:
    """``{"<field>:<j>": np.ndarray}`` for every leaf of ``state``."""
    return {f"{name}:{j}": x.cpu().numpy()
            for name in state._fields
            for j, x in enumerate(tree_leaves(getattr(state, name)))}


def state_from_numpy(arrays: dict, like, device: torch.device,
                     defaults: Optional[dict] = None):
    """Build a state of ``like``'s type and structure from ``arrays``.

    Every leaf must match ``like``'s shape and dtype.  A field with no
    key in ``arrays`` follows ``defaults[field]``: ``"zeros"`` zero-fills
    it, ``"init"`` keeps ``like``'s value, ``"require"`` (and any field
    when ``defaults`` is None) raises.  Keys naming a field ``like`` does
    not have raise: dropping state silently is not a choice made here."""
    by_field: dict = {}
    for k in arrays:
        by_field.setdefault(k.split(":", 1)[0], []).append(k)
    unknown = sorted(set(by_field) - set(like._fields))
    if unknown:
        raise ValueError(f"checkpoint carries unknown schema fields "
                         f"{unknown[:6]} (written by a newer engine?); "
                         "refusing to drop state")
    fields = []
    for name in like._fields:
        cur = getattr(like, name)
        leaves = tree_leaves(cur)
        if not leaves:
            fields.append(cur)
            continue
        if name not in by_field:
            mode = (defaults or {}).get(name, "require")
            if mode == "require":
                raise ValueError(f"checkpoint is missing required field "
                                 f"{name!r}")
            new = [torch.zeros_like(x) for x in leaves] \
                if mode == "zeros" else list(leaves)
        elif len(by_field[name]) != len(leaves):
            raise ValueError(f"checkpoint leaf count mismatch for {name!r}: "
                             f"archive has {len(by_field[name])}, engine "
                             f"needs {len(leaves)}")
        else:
            new = []
            for j, x in enumerate(leaves):
                got = torch.from_numpy(
                    np.ascontiguousarray(arrays[f"{name}:{j}"])).to(device)
                if tuple(got.shape) != tuple(x.shape):
                    raise ValueError(f"checkpoint geometry mismatch for "
                                     f"{name}:{j}: {tuple(got.shape)} != "
                                     f"{tuple(x.shape)}")
                if got.dtype != x.dtype:
                    raise ValueError(f"checkpoint dtype mismatch for "
                                     f"{name}:{j}: {got.dtype} != {x.dtype}")
                new.append(got)
        fields.append(tree_unflatten(cur, new))
    return type(like)(*fields)
