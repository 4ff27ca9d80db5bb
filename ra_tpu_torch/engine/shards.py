"""The placement of one engine's state over a ``(members, lanes)`` mesh.

The reference places a sharded engine's state with GSPMD: every leaf is
one global array laid out over the mesh, and XLA inserts the collectives
a step needs.  The port has no global sharded tensor.  Instead a
sharded ``LockstepEngine`` holds one :class:`LaneShard` per lane slice
``[lo, hi)`` (the slices ``bounds[i] = round(i * N / lanes)`` that
``per_device_wal_shards`` assumes), and runs the unchanged step on each
shard's home device, mesh slot ``(0, j)``.  Lanes are independent, so a
lanes-only mesh moves nothing between devices.

On a mesh with a members axis, the leaves with a member axis (``[N, P,
...]`` fields and the machine state) are split over the ``m`` member
slots of the shard's column: member slot ``i`` holds columns
``member_bounds[i]`` on device ``(i, j)``.  The lane-local leaves (the
ring, ``read_buf``, the ``[N]`` fields and the telemetry) live on the
home slot only.  Before a dispatch :meth:`LaneShard.gather` copies the
member columns onto the home slot, and after it :meth:`LaneShard.scatter`
copies them back: the reference moves that data inside the step, the
port at its edges.  The results are the same.

:class:`LaneParts` is a tensor split along its lane axis, one piece a
shard, each on its shard's device: a sharded engine's step aux and the
driver's staged blocks.  Indexing it takes the leading (inner-step)
axis of every piece, ``np.asarray`` and ``.cpu()`` concatenate.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..core.tree import tree_leaves, tree_unflatten

Tensor = torch.Tensor

#: LaneState fields that stay on a shard's home slot whatever their rank:
#: the ring and the pending-read buffer have ring depth or read slots as
#: axis 1, never members, and the telemetry is per lane
LANE_LOCAL = ("ring", "read_buf", "telem")


def split_bounds(n: int, parts: int) -> list:
    """``[(lo, hi), ...]``: ``n`` split into ``parts`` contiguous slices,
    ``bounds[i] = round(i * n / parts)`` (the WAL shards' split)."""
    edges = [int(round(i * n / parts)) for i in range(parts + 1)]
    return list(zip(edges[:-1], edges[1:]))


def member_leaf_mask(state) -> list:
    """One bool a leaf of ``state`` (a ``LaneState``), in flattening
    order: True where the leaf has a member axis (axis 1)."""
    out = []
    for name in type(state)._fields:
        for leaf in tree_leaves(getattr(state, name)):
            out.append(name not in LANE_LOCAL and leaf.dim() >= 2)
    return out


def copy_to(x: Tensor, device: torch.device) -> Tensor:
    """A contiguous copy of ``x`` on ``device``: always a new storage,
    so that every mesh slot owns its own buffers, even where several
    slots share one device."""
    if x.device == device:
        return x.clone(memory_format=torch.contiguous_format)
    if device.type == "cuda" and x.device.type == "cpu":
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        return host.to(device, non_blocking=True)
    return x.to(device, memory_format=torch.contiguous_format)


class LaneParts:
    """A tensor split along its lane axis ``axis`` into one piece a lane
    shard, each on its shard's device."""

    __slots__ = ("parts", "axis")

    def __init__(self, parts: Sequence[Tensor], axis: int) -> None:
        self.parts = tuple(parts)
        self.axis = axis

    def __getitem__(self, i):
        """The leading axis of every piece (an inner step of a stacked
        superstep aux, or of a staged block)."""
        if self.axis == 0:
            raise TypeError("the leading axis of these pieces is the lane "
                            "axis: index .parts instead")
        return LaneParts([p[i] for p in self.parts], self.axis - 1)

    @property
    def shape(self) -> torch.Size:
        s = list(self.parts[0].shape)
        s[self.axis] = sum(int(p.shape[self.axis]) for p in self.parts)
        return torch.Size(s)

    @property
    def devices(self) -> list:
        return [p.device for p in self.parts]

    def bounds(self) -> list:
        """``[(lo, hi), ...]``: the lanes of each piece."""
        out, lo = [], 0
        for p in self.parts:
            out.append((lo, lo + int(p.shape[self.axis])))
            lo = out[-1][1]
        return out

    def cpu(self) -> Tensor:
        """The whole tensor on the host (a synchronous copy)."""
        return torch.cat([p.cpu() for p in self.parts], self.axis)

    def __array__(self, dtype=None, copy=None):
        arr = self.cpu().numpy()
        return arr if dtype is None else arr.astype(dtype)


class LaneShard:
    """Lanes ``[lo, hi)`` of a sharded engine.  ``devices[i]`` is member
    slot ``i`` of the shard's mesh column; ``devices[0]`` is its home,
    where the shard's steps run.  ``state`` is the shard's ``LaneState``
    on the home slot, its member leaves narrowed to member slot 0's
    columns when the members axis is split; ``blocks[i - 1]`` holds
    member slot ``i``'s columns of every member leaf."""

    def __init__(self, index: int, lo: int, hi: int,
                 devices: Sequence[torch.device], n_members: int,
                 mask: list, zeros: dict) -> None:
        #: the shard's position in the engine's shard list
        self.index = index
        self.lo, self.hi = lo, hi
        self.devices = list(devices)
        self.home = self.devices[0]
        self.member_bounds = split_bounds(n_members, len(self.devices))
        self._mask = mask
        self.state: Any = None
        self.blocks: list = []
        #: the shard's zero inputs (fail, elect, n_read, read_q) on home
        self.zeros = zeros
        #: the shard's captured graphs (a CUDA home), one cache a slot
        self.graphs = None
        if self.home.type == "cuda":
            from .graph import GraphCache
            self.graphs = GraphCache()
        #: bytes the member gather and scatter copy a dispatch
        self.copy_bytes = 0

    @property
    def n(self) -> int:
        return self.hi - self.lo

    @property
    def split(self) -> bool:
        return len(self.devices) > 1

    def place(self, full) -> None:
        """Take ``full`` (the shard's lanes of a ``LaneState``, on any
        device) as the shard's state: copies on the home slot, and the
        member columns of member slots 1.. on their devices."""
        home_leaves, blocks = [], [[] for _ in self.devices[1:]]
        nbytes = 0
        for leaf, member in zip(tree_leaves(full), self._mask):
            if member and self.split:
                a, b = self.member_bounds[0]
                home_leaves.append(copy_to(leaf[:, a:b], self.home))
                for i, (a, b) in enumerate(self.member_bounds[1:]):
                    blocks[i].append(copy_to(leaf[:, a:b],
                                             self.devices[i + 1]))
                    nbytes += blocks[i][-1].numel() * leaf.element_size()
            else:
                home_leaves.append(copy_to(leaf, self.home))
        self.state = tree_unflatten(full, home_leaves)
        self.blocks = blocks
        self.copy_bytes = 2 * nbytes

    def gather(self):
        """The shard's full ``LaneState`` on the home slot: member slot
        ``i``'s columns copied over and joined after slot 0's."""
        if not self.split:
            return self.state
        leaves, j = [], 0
        for leaf, member in zip(tree_leaves(self.state), self._mask):
            if member:
                leaves.append(torch.cat(
                    [leaf] + [blk[j].to(self.home) for blk in self.blocks],
                    dim=1))
                j += 1
            else:
                leaves.append(leaf)
        return tree_unflatten(self.state, leaves)

    def scatter(self, full) -> None:
        """Take a dispatch's new full state (on the home slot): slot 0's
        columns stay, the other member slots' are copied back to their
        devices."""
        if not self.split:
            self.state = full
            return
        home_leaves, blocks = [], [[] for _ in self.devices[1:]]
        for leaf, member in zip(tree_leaves(full), self._mask):
            if member:
                a, b = self.member_bounds[0]
                home_leaves.append(leaf[:, a:b])
                for i, (a, b) in enumerate(self.member_bounds[1:]):
                    blocks[i].append(copy_to(leaf[:, a:b],
                                             self.devices[i + 1]))
            else:
                home_leaves.append(leaf)
        self.state = tree_unflatten(full, home_leaves)
        self.blocks = blocks

    def take(self, x, axis: int, dtype: torch.dtype,
             zero: Optional[Tensor] = None) -> Tensor:
        """This shard's lanes of a dispatch input on the home slot: a
        ``LaneParts`` piece as it is (staged there), host data or a
        tensor sliced along ``axis`` and copied (host data from pinned
        memory, without blocking), or ``zero`` for None."""
        if x is None:
            return zero
        if isinstance(x, LaneParts):
            return x.parts[self.index].to(self.home)
        if not isinstance(x, Tensor):
            x = torch.as_tensor(np.asarray(x))
        part = x.narrow(axis, self.lo, self.n).to(dtype)
        return copy_to(part, self.home) if part.device != self.home \
            else part
