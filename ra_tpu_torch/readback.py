"""Asynchronous device-to-host readback handles.

The port's counterpart of the reference's ``copy_to_host_async`` /
``is_ready`` / ``np.asarray`` idiom: the dispatch-ahead driver's
watermark, ``LockstepEngine.committed_lanes_async`` and the telemetry
sampler's harvest all start a copy, go on dispatching, and read the
copy only once it has landed (or at a window boundary, waiting).
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

Tensor = torch.Tensor


class Readback:
    """An asynchronous copy of a tensor, or a dict of tensors, to the host.

    From a CUDA tensor the copy goes into pinned host memory with
    ``non_blocking=True`` on the device's current stream, followed by an
    event: :meth:`is_ready` polls the event and :meth:`result` (or
    ``np.asarray(handle)`` for a single tensor) waits on it.  From a CPU
    tensor the copy is made at once and the handle is always ready.  A
    sharded engine's ``LaneParts`` (``engine/shards.py``) copies each
    piece into its own pinned buffer, with one event a device, and reads
    back as the joined array; the handle is ready when every copy is.

    No device-side copy comes first, as the reference's ``+ 0`` does:
    that one decouples the readback from buffer donation, and the port
    donates nothing.  The engine never writes a state or aux tensor in
    place, and the copy is ordered on the stream after the work that
    produced its source."""

    def __init__(self, src) -> None:
        self._single = not isinstance(src, dict)
        items = {"": src} if self._single else dict(src)
        self._events: dict = {}
        self._host = {}
        self._axis = {}
        nbytes = 0
        for k, t in items.items():
            pieces = getattr(t, "parts", None)
            if pieces is not None:
                self._axis[k] = t.axis
            hs = [self._copy(p) for p in (pieces or (t,))]
            self._host[k] = hs if pieces is not None else hs[0]
            nbytes += sum(p.numel() * p.element_size()
                          for p in (pieces or (t,)))
        #: bytes copied (host metadata: the ledger's count)
        self.nbytes = nbytes
        for dev in self._events:
            self._events[dev] = torch.cuda.Event()
            self._events[dev].record(torch.cuda.current_stream(dev))
        self._np = None

    def _copy(self, t: Tensor) -> Tensor:
        if t.device.type != "cuda":
            return t.clone()
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        self._events[t.device] = None
        return h

    @property
    def event(self) -> Optional[torch.cuda.Event]:
        """The event recorded after the copy (None from a CPU tensor):
        another stream that waits on it runs after the work that
        produced the source.  Only for a copy from one device."""
        if len(self._events) > 1:
            raise ValueError("a readback from several devices has an "
                             "event a device")
        return next(iter(self._events.values()), None)

    def is_ready(self) -> bool:
        """True once the copy has landed (never blocks)."""
        return all(e.query() for e in self._events.values())

    def wait(self) -> bool:
        """Block until the copy has landed; True if that took a wait."""
        waited = False
        for e in self._events.values():
            if not e.query():
                e.synchronize()
                waited = True
        return waited

    def result(self):
        """The copied value(s) as numpy: an array, or a dict of arrays
        for a dict source.  Waits for the copy."""
        if self._np is None:
            self.wait()
            out = {k: np.concatenate([p.numpy() for p in h], self._axis[k])
                   if k in self._axis else h.numpy()
                   for k, h in self._host.items()}
            self._np = out[""] if self._single else out
        return self._np

    def __array__(self, dtype=None, copy=None):
        if not self._single:
            raise TypeError("a readback of a dict converts with result()")
        arr = self.result()
        return arr if dtype is None else arr.astype(dtype)
