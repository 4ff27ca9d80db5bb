"""Engine state carried across: ``LaneState`` <-> ``<field>:<leaf>`` arrays.

The key scheme is the reference engine's checkpoint archive
(``ra_tpu/engine/lockstep.py`` ``LockstepEngine.save``): one numpy array
per leaf, keyed ``<field>:<j>`` with leaves in ``jax.tree.flatten`` order
(``telem:0..7``; ``mac:0`` for the counter).  So an archive written by
either engine restores into the other, and tests compare the two
engines' states leaf for leaf.  The older positional archive (``a<i>``
keys over the whole state's leaves, with or without the telemetry
leaves) restores through :func:`state_from_positional`.
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


def state_from_positional(arrays: dict, like, device: torch.device):
    """Build a state of ``like``'s type from a positional archive: keys
    ``a<i>`` over every leaf of the state in ``jax.tree.flatten`` order,
    as the reference engine wrote checkpoints before the schema-named
    keys (``ra_tpu/engine/lockstep.py::_restore_positional``).  An
    archive short by exactly the telemetry leaves (``telem``) predates
    the telemetry plane: those leaves are zero-filled.  Any other leaf
    count, a shape that differs from ``like``'s, or a dtype that does,
    raises."""
    flat = tree_leaves(like)
    n, n_arch = len(flat), len(arrays)
    at = like._fields.index("telem")
    tel_at = len(tree_leaves(tuple(like[:at])))
    n_tel = len(tree_leaves(like[at]))
    legacy = n_arch == n - n_tel
    if not legacy and n_arch != n:
        raise ValueError(f"checkpoint leaf count mismatch: archive has "
                         f"{n_arch} arrays, engine state needs {n}")
    loaded, j = [], 0
    for i, x in enumerate(flat):
        if legacy and tel_at <= i < tel_at + n_tel:
            loaded.append(torch.zeros_like(x))
            continue
        got = torch.from_numpy(np.ascontiguousarray(arrays[f"a{j}"]))
        j += 1
        if tuple(got.shape) != tuple(x.shape):
            raise ValueError(f"checkpoint geometry mismatch: "
                             f"{tuple(got.shape)} != {tuple(x.shape)}")
        if got.dtype != x.dtype:
            raise ValueError(f"checkpoint dtype mismatch for a{j - 1}: "
                             f"{got.dtype} != {x.dtype}")
        loaded.append(got.to(device))
    return tree_unflatten(like, loaded)
