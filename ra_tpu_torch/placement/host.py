"""One lane-engine host: a durable engine, an ingress plane and a wire
listener under one engine id, the data-plane unit the placement table
assigns lane ranges to.  The port's copy of ``ra_tpu/placement/host.py``:
the engine, and an adopted victim's recovery, run on the host's
``device`` (None: the card).

Failure is **kill-9, not shutdown**: :meth:`LaneEngineHost.kill9` kills
every WAL shard abruptly (queued, unfsynced writes are lost), stops the
shard supervisor and abandons the engine with no flush or checkpoint.
Commits gate on the fsync confirm and acks fan out only on commit, so
what a client was acked is on disk; only the never-acked tail is lost.

Recovery is **adoption, not restart**: a survivor opens the victim's
durable directory through :func:`ra_tpu_torch.engine.durable.open_engine`
(checkpoint, the WAL shards merged at any layout, replay to the fsynced
watermark) and serves it behind a fresh plane and listener of its own,
whose dedup-slot cursors re-seed from the recovered machine's watermarks
(``WireListener._recovered_lane_next``); clients claim their old slots
through ``WireListener.loopback_rehome``.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..blackbox import record
from ..wire.framing import data_stride
from ..wire.server import WireListener


class LaneEngineHost:
    """One engine id's serving stack.  ``machine_factory`` builds the lane
    machine (one a stack; an adoption builds its own); the geometry
    mirrors the wire soak's.  ``port=None`` serves loopback fleets,
    ``port=0`` binds ephemeral TCP listeners."""

    def __init__(self, engine_id: str, data_dir: str, *,
                 machine_factory, lanes: int = 64,
                 ring_capacity: int = 512, max_step_cmds: int = 16,
                 wal_shards: int = 2, superstep_k: int = 4,
                 max_conns: int = 256, ring_records: int = 32,
                 port: Optional[int] = None, device=None) -> None:
        self.engine_id = engine_id
        self.data_dir = data_dir
        self.lanes = int(lanes)
        self._geometry = dict(ring_capacity=ring_capacity,
                              max_step_cmds=max_step_cmds,
                              superstep_k=superstep_k, max_conns=max_conns,
                              ring_records=ring_records, device=device)
        self._wal_shards = wal_shards
        self._machine_factory = machine_factory
        self._port = port
        self.engine, self.plane, self.listener = self._stack(
            data_dir, wal_shards, port)
        self._alive = True
        #: victim engine id -> (engine, plane, listener) adopted here
        self.adopted: dict = {}

    def _stack(self, data_dir: str, wal_shards: int, port) -> tuple:
        from ..engine.durable import open_engine
        from ..ingress import IngressPlane
        g = self._geometry
        eng = open_engine(self._machine_factory(), data_dir, self.lanes,
                          wal_shards=wal_shards,
                          ring_capacity=g["ring_capacity"],
                          max_step_cmds=g["max_step_cmds"],
                          device=g["device"])
        plane = IngressPlane(eng, superstep_k=g["superstep_k"],
                             window_s=0.001, soft_credit=1 << 20,
                             hard_credit=1 << 20)
        lst = WireListener(plane, port=port, max_conns=g["max_conns"],
                           ring_bytes=g["ring_records"] * data_stride(
                               eng.payload_width))
        return eng, plane, lst

    def alive(self) -> bool:
        """The supervisor's heartbeat probe."""
        return self._alive

    def kill9(self) -> None:
        """Abrupt whole-host death: the WAL shards die with their queued
        writes, no flush or checkpoint, and this host never serves again
        (a survivor adopts its directory)."""
        if not self._alive:
            return
        self._alive = False
        dur = getattr(self.engine, "_dur", None)
        if dur is not None:
            # stop the shard supervisor first, or it resurrects the shards
            dur._sup_stop.set()
            for wal in dur.wals:
                wal.kill()

    def close(self) -> None:
        """Teardown (not the failure path): adopted stacks and the
        listener; the engine too unless kill9() abandoned it."""
        for eng, _plane, lst in self.adopted.values():
            lst.close()
            eng.close()
        self.adopted.clear()
        self.listener.close()
        if self._alive:
            self._alive = False
            self.engine.close()

    def _stacks(self) -> list:
        return [(self.plane, self.listener)] + [
            (plane, lst) for _eng, plane, lst in self.adopted.values()]

    def cycle(self) -> None:
        """One pump of every serving stack: its own and each adopted."""
        if not self._alive:
            return
        for plane, lst in self._stacks():
            lst.sweep()
            plane.pump(force=True)

    def settle(self, timeout: float = 30.0) -> None:
        if not self._alive:
            return
        for plane, _lst in self._stacks():
            plane.settle(timeout=timeout)

    def adopt(self, victim_id: str, victim_dir: str, *,
              wal_shards: Optional[int] = None,
              trace_ctx: Optional[str] = None) -> WireListener:
        """Recover ``victim_dir`` on this host's device and serve it
        behind a fresh plane and listener (returned: the new home of the
        re-homed sessions).  The plane is built like the victim's, so the
        key→lane hash puts every session on the lane its recovered state
        lives in.  A re-delivered failover adopts once."""
        if victim_id in self.adopted:
            return self.adopted[victim_id][2]
        eng, plane, lst = self._stack(
            victim_dir, self._wal_shards if wal_shards is None
            else wal_shards, None if self._port is None else 0)
        self.adopted[victim_id] = (eng, plane, lst)
        st = eng.state
        tail = st.last_index.cpu().numpy()[np.arange(self.lanes),
                                           st.leader_slot.cpu().numpy()]
        record("placement.adopt", trace=trace_ctx, victim=victim_id,
               survivor=self.engine_id,
               recovered_tail_max=int(tail.max(initial=0)),
               wal_dirs=len([d for d in os.listdir(victim_dir)
                             if d.startswith(("wal", "shard"))]))
        return lst

    def adopted_listener(self, victim_id: str) -> WireListener:
        return self.adopted[victim_id][2]

    def adopted_engine(self, victim_id: str):
        return self.adopted[victim_id][0]
