"""What the two window-fold kernel wrappers (``slot_fold``, ``fifo_fold``)
share: the choice of plain version or kernel by the tensors' device, the
shape the kernels take, and the output buffers the kernel writes.

A fold kernel folds a whole window in order, as the reference's
``sequential_window_fold``.  On a card the machines launch it for every
window: where the reference's vectorised fast fold would be taken the two
folds agree, so no branch is chosen and nothing waits on the device.
"""
from __future__ import annotations

import torch

from ..core.tree import tree_leaves, tree_map

I32 = torch.int32


def fold_device(commands, mask, state) -> str:
    """``"cpu"`` when every tensor lies on the CPU, ``"cuda"`` when all lie
    on one CUDA device; anything else raises."""
    ts = [commands, mask] + tree_leaves(state)
    devs = {t.device for t in ts}
    if all(d.type == "cpu" for d in devs):
        return "cpu"
    if len(devs) == 1 and next(iter(devs)).type == "cuda":
        return "cuda"
    raise ValueError(f"fold inputs on {sorted(map(str, devs))}; expected "
                     "all on the CPU or all on one CUDA device")


def kernel_operands(meta, commands, mask, state):
    """``(commands, mask, index, state, out_k, out)`` as the kernels take
    them.  Every operand gets a member axis when the window has one
    leading dim (``out_k`` is ``out`` with it, ``out`` what the caller
    returns).  ``index`` is int32 [N,P,A] (any strides).  ``out`` holds
    fresh contiguous buffers, one a state leaf, for the kernel to write."""
    out = tree_map(lambda s: torch.empty_like(
        s, memory_format=torch.contiguous_format), state)
    index = torch.broadcast_to(
        torch.as_tensor(meta["index"], device=mask.device).to(I32),
        mask.shape)
    squeeze = mask.dim() == 2
    if squeeze:
        commands, mask, index = (x.unsqueeze(1)
                                 for x in (commands, mask, index))
        state, out_k = (tree_map(lambda x: x.unsqueeze(1), t)
                        for t in (state, out))
    else:
        out_k = out
    return commands, mask, index, state, out_k, out


def check_fold_operands(commands, mask, index, state_leaves, out_leaves,
                        width: int) -> torch.device:
    """Raise unless the kernel can take these: commands int32 [N,P,A,C]
    with C >= ``width`` and mask bool / index int32 [N,P,A] (any strides;
    ``index`` None for a kernel that reads none),
    every state and output leaf int32, contiguous and of one shape pair,
    outputs sharing no memory with the state, all on one CUDA device."""
    if commands.dim() != 4 or commands.shape[-1] < width:
        raise ValueError(f"commands must be [N, P, A, >={width}], got "
                         f"{tuple(commands.shape)}")
    lead = tuple(commands.shape[:3])
    named = [("commands", commands, I32, None),
             ("mask", mask, torch.bool, lead)]
    if index is not None:
        named.append(("index", index, I32, lead))
    for name, t, dtype, shape in named:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    owned = {s.untyped_storage().data_ptr() for s in state_leaves}
    for s, o in zip(state_leaves, out_leaves):
        if s.dtype != I32 or o.dtype != I32:
            raise TypeError("fold state leaves must be int32")
        if tuple(s.shape) != tuple(o.shape) or \
                tuple(s.shape[:2]) != lead[:2]:
            raise ValueError(f"state leaf {tuple(s.shape)} and output "
                             f"{tuple(o.shape)} must match the window's "
                             f"[N, P] = {lead[:2]}")
        if not (s.is_contiguous() and o.is_contiguous()):
            raise ValueError("fold state and output leaves must be "
                             "contiguous")
        if o.untyped_storage().data_ptr() in owned:
            raise ValueError("a fold output shares memory with the state")
    devs = {t.device for _n, t, _d, _s in named} | \
        {t.device for t in [*state_leaves, *out_leaves]}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"fold operands on {sorted(map(str, devs))}; "
                         "expected one CUDA device")
    return next(iter(devs))


def strides(t: torch.Tensor) -> tuple:
    return tuple(int(s) for s in t.stride())
