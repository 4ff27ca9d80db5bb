"""Offline log replay for debugging — the ra_dbg role (ra_dbg.erl:26-55;
the port's own copy of ``ra_tpu/dbg.py``): fold a server's persisted log
through a machine without starting any runtime, deduping overwritten
indexes the same way WAL recovery does.  Snapshots and commands load
through the port's readers, so a reference data directory replays too.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Optional

from .core.machine import ApplyMeta, Machine
from .core.types import Entry, UserCommand
from .log.durable import _read_snapshot_file, decode_command
from .log.snapshot import DEFAULT_SNAPSHOT_MODULE
from .log.segment import SegmentFile
from .log.wal import scan_wal_file


def read_log(data_dir: str, uid: str, snapshot_module=None) -> tuple:
    """Collect (snapshot, ordered entries) for a server from its on-disk
    state: snapshot + segments + surviving WAL files."""
    server_dir = os.path.join(data_dir, uid)
    snapshot = None
    snapdir = os.path.join(server_dir, "snapshot")
    if os.path.isdir(snapdir):
        for fname in sorted(os.listdir(snapdir), reverse=True):
            got = _read_snapshot_file(os.path.join(snapdir, fname))
            if got is not None:
                mod = snapshot_module or DEFAULT_SNAPSHOT_MODULE
                snapshot = (got[0], mod.decode(got[1]))
                break
    entries: dict[int, tuple] = {}
    if os.path.isdir(server_dir):
        for fname in sorted(os.listdir(server_dir)):
            if not fname.endswith(".segment"):
                continue
            seg = SegmentFile(os.path.join(server_dir, fname))
            r = seg.range()
            if r is not None:
                for idx in range(r[0], r[1] + 1):
                    got = seg.read(idx)
                    if got is not None:
                        entries[idx] = got
            seg.close()
    waldir = os.path.join(data_dir, "wal")
    tables: dict = {}
    if os.path.isdir(waldir):
        for fname in sorted(f for f in os.listdir(waldir)
                            if f.endswith(".wal")):
            try:
                scan_wal_file(os.path.join(waldir, fname), tables)
            except Exception:
                pass  # torn tail: keep the prefix
    for idx, (term, payload) in tables.get(uid, {}).items():
        entries[idx] = (term, payload)
    snap_idx = snapshot[0].index if snapshot else 0
    ordered = [Entry(i, entries[i][0], decode_command(entries[i][1]))
               for i in sorted(entries) if i > snap_idx]
    return snapshot, ordered


def replay_log(data_dir: str, uid: str, machine: Machine,
               on_entry: Optional[Callable] = None,
               device: Any = None) -> Any:
    """Replay a server's committed-on-disk log through ``machine`` and
    return the final machine state (replay_log/3, ra_dbg.erl:26-55).
    A JitMachine's state lives on ``device`` (None: the card; the CPU by
    name only), a snapshot's state too (``place_state``)."""
    # the machine's snapshot module decodes its own state format
    # (snapshot_module/0 override, ra_machine.erl:435-437)
    snapshot, entries = read_log(data_dir, uid,
                                 snapshot_module=machine.snapshot_module())
    config = {"uid": uid, "dbg": True, "device": device}
    if snapshot is not None:
        place = getattr(machine, "place_state", None)
        state = snapshot[1] if place is None else place(snapshot[1], config)
    else:
        state = machine.init(config)
    for e in entries:
        if isinstance(e.command, UserCommand):
            meta = ApplyMeta(index=e.index, term=e.term)
            result = machine.apply(meta, e.command.data, state)
            state = result[0]
        # noop/membership entries don't touch machine state
        if on_entry is not None:
            on_entry(e, state)
    return state
