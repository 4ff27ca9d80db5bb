"""The dispatch-ahead host pipeline of the superstep path.

The port of ``ra_tpu/engine/lockstep.py::DispatchAheadDriver``: while
the device runs dispatch i, the host stages block i+1 -- copies it into
pinned memory and starts its copy to the device on a side stream -- and
the in-flight cap is kept with asynchronous watermark readbacks, so the
loop waits on the device only at a window boundary (``window_syncs``).

On a CUDA engine the reference's ``device_put`` becomes two staging
slots used in turn, each a pinned host buffer and a device buffer per
staged array: the host copy into the pinned buffer waits for that
slot's previous host-to-device copy to land (normally long since done),
the host-to-device copy runs ``non_blocking`` on the driver's copy
stream after the dispatch that last read the slot's device buffers, and
the dispatch stream waits on the copy's event, not the host.  A large
block is copied into pinned memory by a few threads at once (numpy
releases the interpreter lock while it copies): one thread copies the
bench's 41 MB block in about as long as the device takes to run it.
The copy is complete when ``submit`` returns, so the caller may reuse
its arrays at once.

On a sharded engine (``parallel.mesh.shard_engine_state``) every staged
array is staged as one piece a lane shard, each straight onto its
shard's home device (a pinned buffer, a device buffer, a copy stream a
device and the events a piece), so that a dispatch makes no copy
between devices for its inputs; the pieces reach ``superstep`` as
``LaneParts``.
"""
from __future__ import annotations

import collections
import concurrent.futures
import time
from typing import Optional

import numpy as np
import torch

from .. import devicewatch
from ..readback import Readback
from .shards import LaneParts


#: threads copying a staged array of at least _SPLIT_BYTES into pinned
#: memory, each a share of its lanes
_COPY_THREADS = 4
_SPLIT_BYTES = 1 << 20


class _Slot:
    """One staging slot: for each target (a lane shard's home device, or
    the engine's one device) pinned and device buffers by (position,
    shape, dtype), the event of its last host-to-device copy, and the
    event of the last dispatch that read its device buffers."""

    def __init__(self, targets: list) -> None:
        self.bufs: dict = {}
        self.copied = [torch.cuda.Event() for _ in targets]
        self.consumed = [torch.cuda.Event() for _ in targets]
        self.devices = [dev for _lo, _hi, dev in targets]
        #: targets with a device buffer allocated since their last copy
        self.fresh: set = set()

    def buffers(self, t: int, i: int, arr: np.ndarray) -> tuple:
        key = (t, i, arr.shape, arr.dtype)
        if key not in self.bufs:
            if len(self.bufs) >= 8 * len(self.devices):
                self.bufs.clear()        # a caller that keeps changing K
            dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
            self.bufs[key] = (
                torch.empty(arr.shape, dtype=dtype, pin_memory=True),
                torch.empty(arr.shape, dtype=dtype,
                            device=self.devices[t]))
            self.fresh.add(t)
        return self.bufs[key]


class DispatchAheadDriver:
    """Dispatch-ahead pipeline for ``LockstepEngine.superstep``.

    :meth:`submit` stages THIS block and dispatches the PREVIOUSLY staged
    one, so the host staging of block i+1 overlaps the device running
    dispatch i.  Each dispatch starts an asynchronous readback of its
    last inner step's committed watermark; only when more than
    ``max_in_flight`` dispatches are unobserved does the driver take the
    OLDEST readback, and a take that had to wait counts in
    ``window_syncs``.  Elect schedules are host data and go to
    ``superstep`` as they are.  A sharded engine's blocks are staged one
    piece a lane shard; ``shardings``, where given, must be
    ``superstep_block_shardings`` of the engine's own mesh."""

    def __init__(self, engine, max_in_flight: int = 2,
                 shardings: Optional[dict] = None) -> None:
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        mesh = engine._mesh
        if shardings is not None:
            if mesh is None:
                raise ValueError("shardings given for an engine that is "
                                 "not sharded (shard_engine_state first)")
            if any(sh.mesh != mesh for sh in shardings.values()):
                raise ValueError("the shardings' mesh is not the engine's")
        self.shardings = shardings or {}
        self.engine = engine
        self.max_in_flight = max_in_flight
        self._staged = None
        self._handles: collections.deque = collections.deque()
        #: newest OBSERVED per-lane cumulative committed counts
        self.last_committed: Optional[np.ndarray] = None
        #: newest observed cumulative read counters (np.int32[N])
        self.last_read_served: Optional[np.ndarray] = None
        self.last_read_shed: Optional[np.ndarray] = None
        self.last_read_stale: Optional[np.ndarray] = None
        #: observed read aux (numpy) in dispatch order, bounded
        self.read_obs: collections.deque = collections.deque(maxlen=64)
        #: seconds ``submit`` spent waiting at window boundaries (the
        #: time of the window syncs)
        self.window_wait_s = 0.0
        dev = engine.device
        #: (lo, hi, device) a staged piece: one a lane shard
        self._targets = [(0, engine.n_lanes, dev)] if mesh is None else \
            [(sh.lo, sh.hi, sh.home) for sh in engine._shards]
        if dev.type == "cuda":
            self._copy_streams = {d: torch.cuda.Stream(d)
                                  for _lo, _hi, d in self._targets}
            self._slots = [_Slot(self._targets), _Slot(self._targets)]
            self._next_slot = 0
            self._pool = concurrent.futures.ThreadPoolExecutor(
                _COPY_THREADS, thread_name_prefix="ra-stage")
        engine._driver = self

    def in_flight(self) -> int:
        return len(self._handles)

    def _start_stage(self, n_new_blk, payloads_blk, elect_blk,
                     read_blk) -> tuple:
        """Start the host copy of a block into a staging slot's pinned
        buffers (a large array on the staging threads)."""
        t0 = time.monotonic()
        arrays = [np.asarray(n_new_blk, np.int32), np.asarray(payloads_blk)]
        if read_blk is not None:
            arrays += [np.asarray(read_blk[0], np.int32),
                       np.asarray(read_blk[1])]
        if self.engine.device.type != "cuda":
            bufs = [torch.from_numpy(np.array(a)) for a in arrays]
            if len(self._targets) > 1:
                # a sharded CPU engine: the pieces are views
                bufs = [LaneParts([b[:, lo:hi] for lo, hi, _d in
                                   self._targets], 1) for b in bufs]
            return arrays, bufs, None, [], elect_blk, time.monotonic() - t0
        slot = self._slots[self._next_slot]
        self._next_slot ^= 1
        # the pinned buffers are free again once their last copy landed
        for ev in slot.copied:
            ev.synchronize()
        bufs = [[slot.buffers(t, i, a[:, lo:hi])
                 for t, (lo, hi, _d) in enumerate(self._targets)]
                for i, a in enumerate(arrays)]
        jobs = []
        for per_target, a in zip(bufs, arrays):
            for (host, _dev), (lo, hi, _d) in zip(per_target,
                                                  self._targets):
                dst, src = host.numpy(), a[:, lo:hi]
                if src.nbytes < _SPLIT_BYTES:
                    np.copyto(dst, src)
                    continue
                edges = np.linspace(0, src.shape[1],
                                    _COPY_THREADS + 1).astype(int)
                jobs += [self._pool.submit(np.copyto, dst[:, e0:e1],
                                           src[:, e0:e1])
                         for e0, e1 in zip(edges[:-1], edges[1:])
                         if e1 > e0]
        return arrays, bufs, slot, jobs, elect_blk, time.monotonic() - t0

    def _finish_stage(self, staging: tuple) -> None:
        """Wait for the host copies of a block, then start its copy to the
        device on the copy stream."""
        t0 = time.monotonic()
        arrays, bufs, slot, jobs, elect_blk, started_s = staging
        for job in jobs:
            job.result()
        tensors = bufs
        if slot is not None:
            for t, (_lo, _hi, d) in enumerate(self._targets):
                stream = self._copy_streams[d]
                dispatch_stream = torch.cuda.current_stream(d)
                with torch.cuda.stream(stream):
                    # the device buffers are free once the dispatch that
                    # read them last is done; a buffer just allocated came
                    # from the dispatch stream's pool, where work still
                    # queued may read the tensor that held it before
                    if t in slot.fresh:
                        stream.wait_stream(dispatch_stream)
                    stream.wait_event(slot.consumed[t])
                    for per_target in bufs:
                        host, dev = per_target[t]
                        dev.copy_(host, non_blocking=True)
                    slot.copied[t].record(stream)
            slot.fresh.clear()
            tensors = [[dev for _host, dev in per_target]
                       for per_target in bufs]
            tensors = [ts[0] if len(ts) == 1 else LaneParts(ts, 1)
                       for ts in tensors]
        # host staging: what the dispatch thread spends on the block's
        # host copy and on starting its device copy
        self.engine.phases.note("host_staging",
                                started_s + time.monotonic() - t0)
        self.engine.pipeline_counters["blocks_staged"] += 1
        devicewatch.record_h2d("driver_stage",
                               sum(a.nbytes for a in arrays),
                               events=len(arrays))
        self._staged = (tensors, elect_blk, slot)

    def submit(self, n_new_blk, payloads_blk, elect_blk=None,
               read_blk=None) -> Optional[Readback]:
        """Stage this block, dispatch the previous one: the host copy of
        this block runs while the previous one is issued, and is complete
        when ``submit`` returns.  ``read_blk``: optional ``(n_read_blk
        [K,N], read_q_blk [K,N,Kr,Cq])`` read schedule riding the same
        dispatch.  Returns the previous dispatch's committed-watermark
        readback, or None on the first call."""
        prev = self._staged
        staging = self._start_stage(n_new_blk, payloads_blk, elect_blk,
                                    read_blk)
        try:
            return self._dispatch(prev) if prev is not None else None
        finally:
            self._finish_stage(staging)

    def _dispatch(self, blk) -> Readback:
        t_sub = time.monotonic()
        tensors, elect_blk, slot = blk
        eng = self.engine
        if slot is not None:
            for t, (_lo, _hi, d) in enumerate(self._targets):
                torch.cuda.current_stream(d).wait_event(slot.copied[t])
        read = len(tensors) == 4
        aux = eng.superstep(tensors[0], tensors[1], elect_blk=elect_blk,
                            n_read_blk=tensors[2] if read else None,
                            read_q_blk=tensors[3] if read else None)
        if slot is not None:
            for t, (_lo, _hi, d) in enumerate(self._targets):
                slot.consumed[t].record(torch.cuda.current_stream(d))
        h = Readback(aux["committed_lanes"][-1])
        # the ledger counts each readback once, when its copy starts
        devicewatch.record_d2h("driver_watermark", h.nbytes)
        robs = None
        if eng.reads_enabled:
            # the cumulative read counters ride every dispatch (a batch
            # registered earlier may serve now); the replies only the
            # dispatches that carry reads
            src = {k: aux[k][-1] for k in ("read_served_lanes",
                                           "read_shed_lanes",
                                           "read_stale_lanes")}
            if read:
                src.update({k: aux[k] for k in ("read_done",
                                                "read_replies",
                                                "read_watermark")})
            robs = Readback(src)
            devicewatch.record_d2h("driver_read", robs.nbytes,
                                   events=len(src))
        self._handles.append((t_sub, h, robs))
        while len(self._handles) > self.max_in_flight:
            # window boundary: take the OLDEST dispatch's watermark; only
            # a take that had to wait is a window sync
            t0, oldest, orobs = self._handles.popleft()
            t_wait = time.perf_counter()
            if oldest.wait():
                eng.pipeline_counters["window_syncs"] += 1
                self.window_wait_s += time.perf_counter() - t_wait
            self._observe(t0, oldest, orobs)
        return h

    def _observe(self, t_sub: float, h: Readback,
                 robs: Optional[Readback]) -> None:
        """Take a popped dispatch's readbacks: the committed watermark,
        and the read counters and answers."""
        self.last_committed = np.asarray(h)
        # device dispatch: submit to the watermark observed on the host
        self.engine.phases.note("device_dispatch",
                                time.monotonic() - t_sub)
        if robs is None:
            return
        obs = robs.result()
        self.last_read_served = obs["read_served_lanes"]
        self.last_read_shed = obs["read_shed_lanes"]
        self.last_read_stale = obs["read_stale_lanes"]
        self.read_obs.append(obs)
        # read service: read-block submit to its outcome observed, only
        # for dispatches that served reads
        if "read_done" in obs and obs["read_done"].any():
            self.engine.phases.note("read_e2e", time.monotonic() - t_sub)

    def drain(self) -> Optional[np.ndarray]:
        """Dispatch the staged block, if any, and take every readback in
        flight; returns the newest per-lane committed watermark
        (np.int32[N])."""
        if self._staged is not None:
            blk, self._staged = self._staged, None
            self._dispatch(blk)
        while self._handles:
            self._observe(*self._handles.popleft())
        return self.last_committed

    def close(self) -> None:
        """Drain, then stop the staging threads (a CUDA engine's)."""
        self.drain()
        if self.engine.device.type == "cuda":
            self._pool.shutdown()
