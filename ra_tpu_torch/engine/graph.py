"""One device program a dispatch: a function captured as a CUDA graph.

The counterpart of the reference's jitted step cache
(``ra_tpu/engine/lockstep.py`` ``_build_jit``/``_compile_step``): on a
CUDA engine each ``superstep`` replays one captured graph of its K
inner steps instead of issuing some two hundred kernels a step from the
host.

* :class:`CapturedCall` captures ``fn`` once on static copies of its
  arguments.  A call copies the new arguments into those buffers,
  replays the graph, and returns fresh clones of the graph's outputs:
  the next replay overwrites the outputs, and a state or aux the caller
  holds must never change under it (the reference's arrays are
  immutable).  Before the capture ``fn`` runs once eagerly on a side
  stream, as ``torch.cuda.graph`` requires: that first run also does
  the kernels' one-time host work (module loading, shared-memory
  attributes) outside the capture.
* :class:`GraphCache` keeps one graph per shape key, like a jit cache
  keyed by shapes: a new key captures once.  It holds at most
  ``MAX_GRAPHS`` graphs (each owns static inputs, outputs and a private
  memory pool), evicting the least recently used; every capture is
  counted by ``devicewatch``, and a key captured again after its
  eviction counts as a re-capture.

There is no eager fallback: a capture that fails raises.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Callable

import torch

from .. import devicewatch
from ..core.tree import tree_leaves, tree_map


#: graphs a cache keeps; each holds static inputs, outputs and a pool
MAX_GRAPHS = 4


class CapturedCall:
    """``fn(*args)`` captured as one CUDA graph on ``device``.
    ``launch_counts()`` returns ``{kernel: host launches so far}``; the
    launches made during the capture are kept in ``captured_launches``."""

    def __init__(self, fn: Callable, args: tuple, device: torch.device,
                 launch_counts: Callable[[], dict]) -> None:
        self.device = device
        t0 = time.perf_counter()
        with torch.cuda.device(device):
            self.inputs = tree_map(torch.clone, args)
            cur = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                fn(*self.inputs)
            cur.wait_stream(side)
            before = launch_counts()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.outputs = fn(*self.inputs)
            after = launch_counts()
        #: device bytes the graph holds between replays: its static
        #: inputs and its outputs (its pool's free blocks not counted)
        self.held_bytes = sum(
            {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
             for t in tree_leaves((self.inputs, self.outputs))}.values())
        self.captured_launches = {k: after[k] - before[k] for k in after}
        self.capture_ms = (time.perf_counter() - t0) * 1e3

    def __call__(self, *args) -> Any:
        """Copy ``args`` into the static inputs, replay, and return clones
        of the outputs (all on the device's current stream)."""
        tree_map(lambda dst, src: dst.copy_(src), self.inputs, args)
        with torch.cuda.device(self.device):
            self.graph.replay()
        return tree_map(torch.clone, self.outputs)


class GraphCache:
    """Captured graphs by shape key."""

    def __init__(self) -> None:
        self._graphs: collections.OrderedDict = collections.OrderedDict()
        self._seen: set = set()

    def __len__(self) -> int:
        return len(self._graphs)

    def __contains__(self, key) -> bool:
        return key in self._graphs

    def get(self, key, fn: Callable, args: tuple, device: torch.device,
            launch_counts: Callable[[], dict]) -> CapturedCall:
        """The graph of ``key``, captured from ``fn(*args)`` if there is
        none."""
        g = self._graphs.get(key)
        if g is not None:
            self._graphs.move_to_end(key)
            return g
        g = CapturedCall(fn, args, device, launch_counts)
        devicewatch.record_capture(key in self._seen)
        self._seen.add(key)
        self._graphs[key] = g
        while len(self._graphs) > MAX_GRAPHS:
            self._graphs.popitem(last=False)
        return g
