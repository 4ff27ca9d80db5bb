"""Read-only accessors into server internals for aux handlers — ra_aux.

The reference lets ``handle_aux`` callbacks inspect the server through an
opaque internal state handle (ra_aux.erl:25-67: machine_state/1,
leader_id/1, members/1, overview/1, log_fetch/2, log_stats/1, ...).
Here the handle is the RaServer itself, passed as the last argument of
``Machine.handle_aux``; these functions are the sanctioned read surface
over it — aux handlers must not mutate the server.
"""
from __future__ import annotations

from typing import Any, Optional


def machine_state(internal) -> Any:
    """ra_aux:machine_state/1."""
    return internal.machine_state


def leader_id(internal):
    """ra_aux:leader_id/1."""
    return internal.leader_id


def current_term(internal) -> int:
    """ra_aux:current_term/1."""
    return internal.current_term


def members(internal) -> list:
    """ra_aux:members/1 — cluster member ids."""
    return list(internal.cluster)


def effective_machine_version(internal) -> int:
    """ra_aux:effective_machine_version/1."""
    return internal.effective_machine_version


def overview(internal) -> dict:
    """ra_aux:overview/1."""
    return internal.overview()


def log_last_index_term(internal):
    """ra_aux:log_last_index_term/1."""
    return internal.log.last_index_term()


def log_fetch(idx: int, internal) -> Optional[Any]:
    """ra_aux:log_fetch/2 — a committed entry by index (None when
    truncated or out of range)."""
    return internal.log.fetch(idx)


def log_stats(internal) -> dict:
    """ra_aux:log_stats/1."""
    return internal.log.overview()
