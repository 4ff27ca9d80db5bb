"""Pluggable snapshot behaviour — the ra_snapshot module contract.

Mirrors ra_snapshot.erl:98-168: the snapshot
*container* (file naming, magic, crc, meta framing, pending-write and
chunked-accept state) is owned by the log layer, while the **module**
controls how machine state becomes the container's data section and
back, plus how that byte stream is cut into install_snapshot chunks.
Machines select a module by overriding ``Machine.snapshot_module()``
(ra_machine.erl:435-437); the default is the
pickle module — the ``term_to_binary`` role of ra_log_snapshot.erl.

Module contract (all callbacks pure, stateless):

* ``encode(machine_state) -> bytes`` — the ``prepare``+``write`` role
  (ra_snapshot.erl:120-128)
* ``decode(data) -> machine_state`` — the ``recover`` role (:150-156)
* ``chunks(data, size)`` — the ``begin_read``/``read_chunk`` role
  (:129-143): yield the data as transfer chunks.  Default: plain byte
  slices; override for formats with natural chunk boundaries.
* ``validate(data) -> bool`` — extra format-level validation on top of
  the container crc (:157-160).  Fault-model note (INTERNALS §6.3):
  the container layer already catches read-side bit corruption by crc
  (with one fresh-read retry) and torn writes by the pending-dir
  rename discipline, so ``validate`` only needs to reject
  *format*-level mismatches (e.g. a module change without migration) —
  it must NOT silently accept-and-reinterpret foreign bytes, which
  recover_snapshot_state treats as a loud failure rather than a
  fallback.

The follower's accept side (begin_accept/accept_chunk/complete_accept,
:144-149) is chunk-format-agnostic by construction: chunks are
re-concatenated before ``decode`` runs, so a custom module only needs
encode/decode for full install+recovery round-trips.
"""
from __future__ import annotations

import pickle
from typing import Any, Iterator

from ..convert import loads as _classic_loads


class SnapshotModule:
    """Default module: pickle (ra_log_snapshot's term_to_binary role)."""

    #: short format tag recorded for observability (context/0 role)
    name = "pickle"

    def encode(self, machine_state: Any) -> bytes:
        return pickle.dumps(machine_state,
                            protocol=pickle.HIGHEST_PROTOCOL)

    def decode(self, data: bytes) -> Any:
        return _classic_loads(data)

    def chunks(self, data: bytes, size: int) -> Iterator[bytes]:
        if not data:
            yield b""
            return
        for i in range(0, len(data), size):
            yield data[i:i + size]

    def validate(self, data: bytes) -> bool:
        return True


DEFAULT_SNAPSHOT_MODULE = SnapshotModule()
