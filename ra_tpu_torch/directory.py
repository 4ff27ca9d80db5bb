"""Per-system server registry — the ra_directory role.

The reference keeps, per system, a UId-keyed ETS forward map
{pid, parent, server name, cluster name} plus a dets-backed reverse map
name→UId that survives restarts (ra_directory.erl:68-121).  Here both
directions live in one pickled file under the system data dir, written
with atomic replace; registration happens in RaSystem.log_factory (every
server start passes through it), and the persisted record carries the
reconstructable parts of the server config so a system restart can
revive its registered servers (the ra_system_recover `registered`
strategy + ra_server_sup_sup:recover_config, :34-68 / :80-103).

The machine itself is NOT persisted: the reference stores a module
reference, which Python lacks for closures — recovery takes a
machine resolver instead (see RaSystem.recover_servers).
"""
from __future__ import annotations

import os
import pickle
import threading
from typing import Optional

from .convert import loads as _classic_loads


class Directory:
    def __init__(self, data_dir: str) -> None:
        self.path = os.path.join(data_dir, "directory")
        self._lock = threading.Lock()
        self._by_uid: dict[str, dict] = {}
        self._by_name: dict[str, str] = {}
        #: uids whose servers were force-deleted — recovered WAL data for
        #: these (and ONLY these) may be purged at boot.  Absence from the
        #: registry alone proves nothing: the file may predate a record,
        #: so unknown uids are kept conservatively (see RaSystem boot).
        self._tombstones: set[str] = set()
        #: True when a directory file exists but could not be read — the
        #: registry contents are unknown and nothing may be purged on its
        #: authority
        self.load_failed = False
        if os.path.exists(self.path):
            try:
                with open(self.path, "rb") as f:
                    raw = _classic_loads(f.read())
                if isinstance(raw, dict) and "records" in raw:
                    self._by_uid = raw["records"]
                    self._tombstones = set(raw.get("tombstones", ()))
                else:  # pre-tombstone format: plain records dict
                    self._by_uid = raw
                self._by_name = {rec["name"]: uid
                                 for uid, rec in self._by_uid.items()}
            except Exception:
                self._by_uid, self._by_name = {}, {}
                self._tombstones = set()
                self.load_failed = True

    def _persist(self) -> None:
        tmp = self.path + ".partial"
        with open(tmp, "wb") as f:
            pickle.dump({"records": self._by_uid,
                         "tombstones": self._tombstones}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def register(self, uid: str, name: str, cluster_name: str,
                 config: Optional[dict] = None) -> None:
        """register_name/6 (:68-90).  A name re-registering under a new
        uid supersedes the old record (delete + re-create of a server)."""
        with self._lock:
            old_uid = self._by_name.get(name)
            if old_uid is not None and old_uid != uid:
                self._by_uid.pop(old_uid, None)
            self._by_uid[uid] = {"name": name, "cluster": cluster_name,
                                 "config": config or {}}
            self._by_name[name] = uid
            self._tombstones.discard(uid)
            self._persist()

    def unregister(self, uid: str, *, tombstone: bool = False) -> None:
        """Remove a uid; with ``tombstone=True`` (force-delete) durably
        record that this uid's WAL remnants are garbage, authorising the
        boot purge to destroy them."""
        with self._lock:
            rec = self._by_uid.pop(uid, None)
            if rec is not None and self._by_name.get(rec["name"]) == uid:
                del self._by_name[rec["name"]]
            if tombstone:
                self._tombstones.add(uid)
            self._persist()

    def is_tombstoned(self, uid: str) -> bool:
        with self._lock:
            return uid in self._tombstones

    def tombstones(self) -> set:
        with self._lock:
            return set(self._tombstones)

    def prune_tombstones(self, uids) -> None:
        """Drop tombstones that have served their purpose (their WAL data
        is gone) so the set cannot grow without bound."""
        with self._lock:
            before = len(self._tombstones)
            self._tombstones.difference_update(uids)
            if len(self._tombstones) != before:
                self._persist()

    def where_is(self, name: str) -> Optional[str]:
        """name -> uid (where_is/2 :106-121)."""
        with self._lock:
            return self._by_name.get(name)

    def name_of(self, uid: str) -> Optional[str]:
        with self._lock:
            rec = self._by_uid.get(uid)
            return rec["name"] if rec else None

    def cluster_of(self, uid: str) -> Optional[str]:
        with self._lock:
            rec = self._by_uid.get(uid)
            return rec["cluster"] if rec else None

    def config_of(self, uid: str) -> Optional[dict]:
        with self._lock:
            rec = self._by_uid.get(uid)
            return dict(rec["config"]) if rec else None

    def is_registered_uid(self, uid: str) -> bool:
        with self._lock:
            return uid in self._by_uid

    def uids(self) -> list:
        with self._lock:
            return list(self._by_uid)

    def overview(self) -> dict:
        with self._lock:
            return {uid: {"name": rec["name"], "cluster": rec["cluster"]}
                    for uid, rec in self._by_uid.items()}
