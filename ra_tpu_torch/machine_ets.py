"""Node-owned side tables for machines — the ra_machine_ets role.

The reference runs a hidden gen_server under the top supervisor whose
only job is to OWN ETS tables created on behalf of user machines
(ra_machine_ets.erl:28-33, started from ra_sup.erl:33-35): because the
owner is the long-lived service and not the server process, a machine's
side table survives member crash/restart.  There are no in-tree
callers — it is a service for user machine modules.

Here an Erlang node maps to the Python process, so the registry is
process-global: tables survive server stop/start, supervised restarts,
and RaNode teardown, and are dropped only explicitly (or with the
process).  A "table" is a plain dict — the host-machine analogue of an
ETS set — guarded by the registry lock only for create/delete;
per-table access follows the same discipline as the reference (the
creating machine coordinates its own readers/writers).

Usage from a machine (any callback; typically ``init``, whose config
dict carries the server ``uid``)::

    from ra_tpu_torch import machine_ets

    def init(self, config):
        # scope by uid: two co-hosted clusters picking the same table
        # name get DISTINCT tables instead of silently shared state
        self._tab = machine_ets.create_table("my_index",
                                             scope=config["uid"])
        ...
    # compatibility shim: bare names keep the old process-global
    # behaviour for existing callers (deliberately shared tables)
    tab = machine_ets.create_table("my_machine_index")

Scoped tables are wiped by ``drop_scope(uid)``, which the force-delete
paths call — a deleted member's durable footprint includes its side
tables (the reference deletes a machine's ETS tables with the server's
data the same way).
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

_lock = threading.Lock()
_tables: Dict[str, dict] = {}


def _key(name: str, scope: Optional[str]) -> str:
    # "/" cannot appear in a uid (base64url, RaSystem.validate_uid), so
    # scoped keys can never collide with each other or with bare names
    return f"{scope}/{name}" if scope else name


def create_table(name: str, scope: Optional[str] = None) -> dict:
    """Return the named table, creating it if needed (idempotent — the
    reference's create_table replaces an existing table only because
    ETS errors on duplicate names; machines recreate on restart, so
    keep-existing is the behaviour they actually rely on).  ``scope``
    (typically the server uid from the machine's init config)
    namespaces the name; None keeps the process-global namespace."""
    with _lock:
        return _tables.setdefault(_key(name, scope), {})


def delete_table(name: str, scope: Optional[str] = None) -> None:
    """Drop the named table (no-op if absent)."""
    with _lock:
        _tables.pop(_key(name, scope), None)


def drop_scope(scope: str) -> None:
    """Drop every table created under ``scope`` — the machine-ets half
    of force_delete_server's footprint wipe."""
    if not scope:
        return
    prefix = f"{scope}/"
    with _lock:
        for key in [k for k in _tables if k.startswith(prefix)]:
            del _tables[key]


def which_tables(scope: Optional[str] = None) -> tuple:
    """Names of live tables (overview/debugging).  With ``scope``, the
    bare names under that scope; without, every raw key."""
    with _lock:
        if scope is None:
            return tuple(sorted(_tables))
        prefix = f"{scope}/"
        return tuple(sorted(k[len(prefix):] for k in _tables
                            if k.startswith(prefix)))
