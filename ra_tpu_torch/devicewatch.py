"""Device-plane counters: the transfer ledger and the graph-capture sentinel.

The port's own copy of the part of ``ra_tpu/devicewatch.py`` that its
dispatch path needs, behind one process-wide ``WATCH`` as in the
reference:

* **Transfer ledger** -- :func:`record_h2d` / :func:`record_d2h` count
  copy events and bytes per named call site (``driver_stage``,
  ``driver_watermark``, ``driver_read``, ``lanes_async``,
  ``sampler_harvest``, and ``wal_readback``: the durable engine's WAL
  shards pulling a step's compacted rows and headers off the device) in
  ``WATCH.sites``.  A copy is counted when it
  starts, from the sizes the caller already holds, so an awaited handle
  is never counted twice and the taps never touch the device.
* **Capture sentinel** -- the twin of the reference's recompile
  sentinel.  A CUDA engine's ``superstep`` replays one captured graph
  per shape key; :func:`record_capture` counts each capture in
  ``WATCH.counters["graph_captures"]``, and a *re-capture* of a key the
  engine had already captured (and evicted) in ``graph_recaptures``.  A
  steady dispatch loop makes no capture at all, and re-captures stay 0.

Memory watermarks and signature-drift attribution are not ported yet.
"""
from __future__ import annotations

import collections

__all__ = ["DeviceWatch", "WATCH", "record_h2d", "record_d2h",
           "record_capture"]


def _new_site() -> dict:
    return {"h2d_events": 0, "h2d_bytes": 0,
            "d2h_events": 0, "d2h_bytes": 0}


class DeviceWatch:
    """Process-wide transfer ledger and capture counters."""

    def __init__(self) -> None:
        self.counters = {"graph_captures": 0, "graph_recaptures": 0}
        #: call site -> its slice of the transfer ledger
        self.sites: collections.defaultdict = \
            collections.defaultdict(_new_site)

    def record_capture(self, recapture: bool) -> None:
        self.counters["graph_captures"] += 1
        self.counters["graph_recaptures"] += bool(recapture)

    def record_h2d(self, site: str, nbytes: int, events: int = 1) -> None:
        s = self.sites[site]
        s["h2d_events"] += events
        s["h2d_bytes"] += nbytes

    def record_d2h(self, site: str, nbytes: int, events: int = 1) -> None:
        s = self.sites[site]
        s["d2h_events"] += events
        s["d2h_bytes"] += nbytes


#: the process-wide watch: instrumented sites call the module-level taps
WATCH = DeviceWatch()


def record_h2d(site: str, nbytes: int, events: int = 1) -> None:
    WATCH.record_h2d(site, nbytes, events)


def record_d2h(site: str, nbytes: int, events: int = 1) -> None:
    WATCH.record_d2h(site, nbytes, events)


def record_capture(recapture: bool) -> None:
    WATCH.record_capture(recapture)
