"""State carried across from the reference: the engine's checkpoint
arrays, and the classic plane's pickles.

**Engine state**: ``LaneState`` <-> ``<field>:<leaf>`` arrays.

The key scheme is the reference engine's checkpoint archive
(``ra_tpu/engine/lockstep.py`` ``LockstepEngine.save``): one numpy array
per leaf, keyed ``<field>:<j>`` with leaves in ``jax.tree.flatten`` order
(``telem:0..7``; ``mac:0`` for the counter).  So an archive written by
either engine restores into the other, and tests compare the two
engines' states leaf for leaf.  The older positional archive (``a<i>``
keys over the whole state's leaves, with or without the telemetry
leaves) restores through :func:`state_from_positional`.

**Classic-plane pickles**: a data directory of the classic plane holds
pickles (the log's meta with its ``voted_for`` server ids, the snapshot
containers' metadata and the machine states in them, the directory's
records, and the codec's FALLBACK command images such as membership
changes).  Those written by the reference name ``ra_tpu.core.types...``,
so unpickling them as they are would import the reference.  Every
pickle load of the port's classic plane goes through :func:`loads`
instead, whose :class:`ClassicUnpickler` maps a ``ra_tpu.X`` path onto
``ra_tpu_torch.X`` and refuses by name any ``ra_tpu`` path the port has
no counterpart for.  A JAX array (a reference JitMachine's state pickled
into a snapshot) pickles as ``jax._src.array._reconstruct_array`` over
numpy's own reduce of its host value; that one name reads as a CPU
tensor of the same dtype and values, with no JAX import, and the
recovering server puts the state on its machine's device
(``JitMachine.place_state``).  Every other ``jax``/``jaxlib`` name is
refused.  So the port's ``RaSystem`` recovers a directory the reference
wrote.  The reverse is not promised: the port's own pickles name
``ra_tpu_torch``.
"""
from __future__ import annotations

import io
import pickle
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


def _tensor_from_jax_array(fun, args, arr_state, _aval_state):
    """The reduce of a pickled JAX array (``_reconstruct_array``): numpy
    rebuilds the host value, which comes back as a CPU tensor."""
    value = fun(*args)
    value.__setstate__(arr_state)
    return torch.from_numpy(np.array(value))


class ClassicUnpickler(pickle.Unpickler):
    """An unpickler for classic-plane data written by either package: a
    class under ``ra_tpu`` resolves to its counterpart under
    ``ra_tpu_torch``; a JAX array reads as a CPU tensor; a reference path
    the port lacks, and any other ``jax``/``jaxlib`` name, raises
    ``pickle.UnpicklingError`` naming it."""

    def find_class(self, module: str, name: str):
        if (module, name) == ("jax._src.array", "_reconstruct_array"):
            return _tensor_from_jax_array
        top = module.split(".", 1)[0]
        if top == "ra_tpu":
            ported = "ra_tpu_torch" + module[len("ra_tpu"):]
            try:
                return super().find_class(ported, name)
            except (ImportError, AttributeError) as exc:
                raise pickle.UnpicklingError(
                    f"the pickle names {module}.{name} of the reference, "
                    f"which has no counterpart {ported}.{name} in the "
                    "port") from exc
        if top in ("jax", "jaxlib"):
            raise pickle.UnpicklingError(
                f"the pickle holds a JAX object ({module}.{name}); the port "
                "reads JAX arrays only")
        return super().find_class(module, name)


def loads(data: bytes):
    """``pickle.loads`` through :class:`ClassicUnpickler`."""
    return ClassicUnpickler(io.BytesIO(data)).load()
