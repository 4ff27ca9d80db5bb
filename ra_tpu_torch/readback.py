"""Asynchronous device-to-host readback handles.

The port's counterpart of the reference's ``copy_to_host_async`` /
``is_ready`` / ``np.asarray`` idiom: the dispatch-ahead driver's
watermark, ``LockstepEngine.committed_lanes_async`` and the telemetry
sampler's harvest all start a copy, go on dispatching, and read the
copy only once it has landed (or at a window boundary, waiting).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

Tensor = torch.Tensor


class Readback:
    """An asynchronous copy of a tensor, or a dict of tensors, to the host.

    From a CUDA tensor the copy goes into pinned host memory with
    ``non_blocking=True`` on the device's current stream, followed by an
    event: :meth:`is_ready` polls the event and :meth:`result` (or
    ``np.asarray(handle)`` for a single tensor) waits on it.  From a CPU
    tensor the copy is made at once and the handle is always ready.

    No device-side copy comes first, as the reference's ``+ 0`` does:
    that one decouples the readback from buffer donation, and the port
    donates nothing.  The engine never writes a state or aux tensor in
    place, and the copy is ordered on the stream after the work that
    produced its source."""

    def __init__(self, src: Union[Tensor, dict]) -> None:
        self._single = isinstance(src, Tensor)
        items = {"": src} if self._single else dict(src)
        #: bytes copied (host metadata: the ledger's count)
        self.nbytes = sum(t.numel() * t.element_size()
                          for t in items.values())
        self._event: Optional[torch.cuda.Event] = None
        self._host = {}
        dev = None
        for k, t in items.items():
            if t.device.type == "cuda":
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                dev = t.device
            else:
                h = t.clone()
            self._host[k] = h
        if dev is not None:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(dev))
        self._np = None

    @property
    def event(self) -> Optional[torch.cuda.Event]:
        """The event recorded after the copy (None from a CPU tensor):
        another stream that waits on it runs after the work that
        produced the source."""
        return self._event

    def is_ready(self) -> bool:
        """True once the copy has landed (never blocks)."""
        return self._event is None or self._event.query()

    def wait(self) -> bool:
        """Block until the copy has landed; True if that took a wait."""
        if self._event is None or self._event.query():
            return False
        self._event.synchronize()
        return True

    def result(self):
        """The copied value(s) as numpy: an array, or a dict of arrays
        for a dict source.  Waits for the copy."""
        if self._np is None:
            self.wait()
            out = {k: h.numpy() for k, h in self._host.items()}
            self._np = out[""] if self._single else out
        return self._np

    def __array__(self, dtype=None, copy=None):
        if not self._single:
            raise TypeError("a readback of a dict converts with result()")
        arr = self.result()
        return arr if dtype is None else arr.astype(dtype)
