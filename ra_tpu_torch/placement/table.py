"""The replicated PlacementTable machine: lane-range → engine assignments
on a classic control cluster, the only authority on who serves which lane
range.  The port's copy of ``ra_tpu/placement/table.py``; its pickles
read the reference's (``convert.ClassicUnpickler``).

The table changes only by committed commands, so a leader kill-9
mid-migration leaves it pre- or post-move (a migration is one command),
and every assignment carries a **generation** that only moves forward, so
a re-delivered migration is a no-op.  Everything downstream (the session
directory's placements, a listener's lane mask, a client's home) is a
cache of it (:class:`PlacementCache`), valid at the revision it was read.

State (plain dicts: picklable, cheap to copy at tens of ranges)::

    {"engines": {eid: {"status": "up"|"down", "generation": int}},
     "ranges":  {rid: {"engine": eid, "generation": int,
                       "lo": int, "hi": int}},
     "rev": int}     # bumps on every effective mutation
"""
from __future__ import annotations

from typing import Any

from ..core.machine import ApplyMeta, Machine
from ..machines import machine_spec, register_machine

MACHINE_NAME = "placement_table"


def _copy(state: dict) -> dict:
    """Two-level copy-on-write: apply never mutates its input (queries
    may hold old snapshots)."""
    return {"engines": {k: dict(v) for k, v in state["engines"].items()},
            "ranges": {k: dict(v) for k, v in state["ranges"].items()},
            "rev": state["rev"]}


class PlacementTableMachine(Machine):
    """Commands (picklable tuples) and their replies:

    * ``("register_engine", eid)``: an engine up at generation 1
      (idempotent).
    * ``("assign", rid, eid, lo, hi)``: the range ``[lo, hi)`` on ``eid``
      at generation 1; identical re-assigns are no-ops, any other
      re-assign of an existing range is refused (``migrate`` moves one).
    * ``("engine_down", eid, expect_gen)``: down, gated on the engine's
      generation.
    * ``("migrate", rid, from_eid, to_eid, new_gen)``: applied only while
      the range is on ``from_eid`` below ``new_gen``; the reply carries
      the placement that stands, so a re-delivered migrate observes the
      move it already made.
    """

    def init(self, config: dict) -> dict:
        return {"engines": {}, "ranges": {}, "rev": 0}

    def apply(self, meta: ApplyMeta, command: Any, state: dict):
        op = command[0]
        if op == "register_engine":
            _, eid = command
            if eid in state["engines"]:
                ent = state["engines"][eid]
                return state, ("engine", eid, ent["status"],
                               ent["generation"])
            state = _copy(state)
            state["engines"][eid] = {"status": "up", "generation": 1}
            state["rev"] += 1
            return state, ("engine", eid, "up", 1)
        if op == "assign":
            _, rid, eid, lo, hi = command
            cur = state["ranges"].get(rid)
            if cur is not None:
                ok = cur["engine"] == eid and cur["lo"] == lo and \
                    cur["hi"] == hi
                return state, (("placed" if ok else "refused"), rid,
                               cur["engine"], cur["generation"])
            state = _copy(state)
            state["ranges"][rid] = {"engine": eid, "generation": 1,
                                    "lo": int(lo), "hi": int(hi)}
            state["rev"] += 1
            return state, ("placed", rid, eid, 1)
        if op == "engine_down":
            _, eid, expect_gen = command
            ent = state["engines"].get(eid)
            if ent is None:
                return state, ("refused", eid, None, 0)
            if ent["status"] == "down" or ent["generation"] != expect_gen:
                return state, ("engine", eid, ent["status"],
                               ent["generation"])
            state = _copy(state)
            ent = state["engines"][eid]
            ent["status"] = "down"
            state["rev"] += 1
            return state, ("engine", eid, "down", ent["generation"])
        if op == "migrate":
            _, rid, from_eid, to_eid, new_gen = command
            cur = state["ranges"].get(rid)
            if cur is None:
                return state, ("refused", rid, None, 0)
            if cur["engine"] == from_eid and cur["generation"] < new_gen:
                state = _copy(state)
                cur = state["ranges"][rid]
                cur["engine"] = to_eid
                cur["generation"] = int(new_gen)
                state["rev"] += 1
            return state, ("placed", rid, cur["engine"], cur["generation"])
        raise ValueError(f"placement_table: unknown command {op!r}")

    def overview(self, state: dict) -> dict:
        return {"rev": state["rev"], "engines": len(state["engines"]),
                "ranges": len(state["ranges"])}


def placement_spec() -> tuple:
    """The picklable machine spec cross-node starts ship."""
    return machine_spec(MACHINE_NAME)


def owned_ranges(state: dict, eid: str) -> list:
    """[(rid, entry)] of every range currently homed on ``eid``."""
    return sorted((rid, dict(ent)) for rid, ent in state["ranges"].items()
                  if ent["engine"] == eid)


class PlacementCache:
    """A consumer's cache of the table: placements are learned from
    committed table state only, and a cached entry is valid while its
    revision is the table's.  ``refresh`` is revision-monotone (a lagging
    follower's older snapshot never rolls it back)."""

    def __init__(self) -> None:
        self.rev = -1
        self._ranges: dict = {}

    def refresh(self, state: dict) -> bool:
        """Adopt a table snapshot; True when it superseded the cache."""
        if state["rev"] <= self.rev:
            return False
        self.rev = state["rev"]
        self._ranges = {rid: dict(ent)
                        for rid, ent in state["ranges"].items()}
        return True

    def invalidate(self) -> None:
        self.rev = -1
        self._ranges = {}

    def lookup(self, rid: str):
        """(engine, generation) or None."""
        ent = self._ranges.get(rid)
        return None if ent is None else (ent["engine"], ent["generation"])

    def lane_owner(self, lane: int):
        """The engine homing ``lane``, or None when no range covers it."""
        for ent in self._ranges.values():
            if ent["lo"] <= lane < ent["hi"]:
                return ent["engine"]
        return None

    def ranges(self) -> dict:
        """``rid -> entry`` copies (a listener's lane mask comes from
        these)."""
        return {rid: dict(ent) for rid, ent in self._ranges.items()}

    def stale_against(self, state: dict) -> bool:
        return state["rev"] > self.rev


register_machine(MACHINE_NAME, lambda **kw: PlacementTableMachine())
