"""Device-plane runtime observatory: capture sentinel, transfer ledger and
memory watermarks.

The port's own copy of ``ra_tpu/devicewatch.py``: three cheap host-side
instruments behind one process-wide ``WATCH`` (the ``RECORDER`` idiom),
surfaced as the ``device`` Observatory source and the ``DEVICE_FIELDS``
registry group.

* **Capture sentinel** -- the twin of the reference's recompile
  sentinel, with the CUDA graph capture (``engine/graph.py``) in place of
  the XLA compile.  A CUDA engine's ``superstep`` replays one captured
  graph per shape key; every capture counts in ``compiles`` and its wall
  time in ``compile_ms``.  A capture beyond a site's first -- a key
  captured again after its eviction, or a new shape at a site that had
  one -- is a ``recompile``: it diffs the capture's argument signature
  (shape and dtype per leaf) against the site's previous one to name the
  leaf that drifted, and records ``device.recompile``.  A site is one
  variant of one engine's graph cache (a superstep with a read schedule
  and one without capture different functions, as the reference's
  sentinel wraps each jitted function), so a new engine's first capture
  of a variant is never a recompile.  A sharded engine keeps one graph
  cache a lane shard (``engine/shards.py``), so each shard's first
  capture, on whatever device, is a compile and not a recompile.  A
  steady dispatch loop captures nothing.
* **Transfer ledger** -- :func:`record_h2d` / :func:`record_d2h` count
  copy events and bytes per named call site (``driver_stage``,
  ``driver_watermark``, ``driver_read``, ``lanes_async``,
  ``sampler_harvest``, ``mesh_shard`` (an engine's placement over a
  mesh, charged once when it is sharded), and ``wal_readback``: the
  durable engine's WAL
  shards pulling a step's compacted rows and headers off the device) in
  ``WATCH.sites`` and in the totals.  A copy is counted when it starts,
  from the sizes the caller already holds, so the taps never touch the
  device.
* **Memory watermarks** -- :meth:`DeviceWatch.sample_watermarks`, called
  from the TelemetrySampler's harvest tick, reads the CUDA caching
  allocator's host-side statistics (``torch.cuda.memory_stats``:
  allocations and bytes held, allocations freed).  No device sync.  The
  counts include the private pools of captured graphs, so
  ``live_buffers`` counts allocator blocks, not the reference's
  ``jax.live_arrays()`` arrays.  Without an initialised card there is no
  census and the call returns False, as the reference does on a backend
  without ``live_arrays``.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Optional

from .blackbox import record
from .metrics import DEVICE_FIELDS

__all__ = ["DeviceWatch", "WATCH", "record_h2d", "record_d2h",
           "sample_watermarks", "bench_tail_keys", "abstract_sig",
           "diff_sig"]


def _leaf_sig(x: Any) -> tuple:
    """(shape, dtype, "") of one argument leaf -- metadata only (the
    third slot is the reference's sharding, always empty on one card)."""
    shape = getattr(x, "shape", None)
    if shape is None:
        return ("py", type(x).__name__, "")
    return (str(tuple(shape)), str(getattr(x, "dtype", None)), "")


def abstract_sig(args: Any, path: str = "") -> list:
    """``[(path, leaf_sig)]`` of a call's arguments, so a drift report
    says ``[0].commit`` instead of "leaf 17"."""
    if isinstance(args, dict):
        return [e for k in sorted(args)
                for e in abstract_sig(args[k], f"{path}[{k!r}]")]
    if isinstance(args, tuple) and hasattr(args, "_fields"):
        return [e for name, v in zip(args._fields, args)
                for e in abstract_sig(v, f"{path}.{name}")]
    if isinstance(args, (tuple, list)):
        return [e for i, v in enumerate(args)
                for e in abstract_sig(v, f"{path}[{i}]")]
    return [(path, _leaf_sig(args))]


def diff_sig(old: list, new: list) -> str:
    """Name the first drifting argument between two call signatures."""
    if len(old) != len(new):
        return (f"arg tree structure changed "
                f"({len(old)} -> {len(new)} leaves)")
    for (opath, osig), (npath, nsig) in zip(old, new):
        if osig != nsig:
            what = ("shape" if osig[0] != nsig[0] else
                    "dtype" if osig[1] != nsig[1] else "sharding")
            return f"{npath or opath}: {what} {osig} -> {nsig}"
    return "signature-identical retrace (cache eviction?)"


def _new_site() -> dict:
    return {"h2d_events": 0, "h2d_bytes": 0,
            "d2h_events": 0, "d2h_bytes": 0}


def _new_fn_entry() -> dict:
    return {"compiles": 0, "recompiles": 0, "compile_ms": 0.0}


class DeviceWatch:
    """Process-wide device-plane observatory: capture sentinel + transfer
    ledger + memory watermarks, one ``overview()`` dict."""

    def __init__(self) -> None:
        #: master switch: False = every tap is a no-op
        self.enabled = True
        self.counters: dict = {}
        #: tag -> per-site sentinel detail (compiles / recompiles /
        #: compile_ms / last_drift)
        self.per_fn: collections.defaultdict = \
            collections.defaultdict(_new_fn_entry)
        #: call site -> its slice of the transfer ledger
        self.sites: collections.defaultdict = \
            collections.defaultdict(_new_site)
        self._prev_freed: Optional[int] = None
        self._last_census_s = float("-inf")
        self.reset()

    def reset(self) -> None:
        """Zero every instrument."""
        self.counters = {f: 0 for f in DEVICE_FIELDS}
        self.counters["compile_ms"] = 0.0
        self.per_fn.clear()
        self.sites.clear()
        self._prev_freed = None
        self._last_census_s = float("-inf")

    # -- capture sentinel --------------------------------------------------

    def note_capture(self, tag: str, ms: float, drift: Optional[str]) -> None:
        """Count one graph capture of site ``tag`` that took ``ms``;
        ``drift`` is None for the site's first capture, else the
        signature diff that makes it a recompile."""
        if not self.enabled:
            return
        c = self.counters
        ent = self.per_fn[tag]
        c["compiles"] += 1
        c["compile_ms"] += ms
        ent["compiles"] += 1
        ent["compile_ms"] += ms
        if drift is not None:
            c["recompiles"] += 1
            ent["recompiles"] += 1
            ent["last_drift"] = drift
            record("device.recompile", fn=tag, drift=drift,
                   compile_ms=round(ms, 3))

    # -- transfer ledger ---------------------------------------------------

    def record_h2d(self, site: str, nbytes: int, events: int = 1) -> None:
        if not self.enabled:
            return
        c = self.counters
        c["h2d_events"] += events
        c["h2d_bytes"] += nbytes
        s = self.sites[site]
        s["h2d_events"] += events
        s["h2d_bytes"] += nbytes

    def record_d2h(self, site: str, nbytes: int, events: int = 1) -> None:
        if not self.enabled:
            return
        c = self.counters
        c["d2h_events"] += events
        c["d2h_bytes"] += nbytes
        s = self.sites[site]
        s["d2h_events"] += events
        s["d2h_bytes"] += nbytes

    # -- memory watermarks -------------------------------------------------

    @staticmethod
    def _allocator_stats() -> Optional[dict]:
        """The caching allocator's host-side statistics of the current
        card, or None without an initialised card (no census there)."""
        import torch
        if not torch.cuda.is_initialized():
            return None
        return torch.cuda.memory_stats()

    def sample_watermarks(self, min_interval_s: float = 0.0) -> bool:
        """Allocator census, called from the TelemetrySampler's harvest
        tick: host-side counters only, no device sync.  ``min_interval_s``
        caps the census rate; a throttled call, or one without a card,
        returns False without sampling."""
        if not self.enabled:
            return False
        if min_interval_s > 0.0 and \
                time.monotonic() - self._last_census_s < min_interval_s:
            return False
        stats = self._allocator_stats()
        if stats is None:
            return False
        self._last_census_s = time.monotonic()
        c = self.counters
        nbytes = int(stats.get("allocated_bytes.all.current", 0))
        freed = int(stats.get("allocation.all.freed", 0))
        c["live_buffers"] = int(stats.get("allocation.all.current", 0))
        c["live_bytes"] = nbytes
        if nbytes > c["peak_live_bytes"]:
            c["peak_live_bytes"] = nbytes
        if self._prev_freed is not None and freed > self._prev_freed:
            c["buffers_freed"] += freed - self._prev_freed
        self._prev_freed = freed
        c["watermark_samples"] += 1
        return True

    def device_memory_stats(self) -> dict:
        """Per card, the allocator's bytes in use and their peak (``{}``
        without an initialised card): a diagnostic surface, not part of
        the sampled counters."""
        import torch
        out: dict = {}
        if not torch.cuda.is_initialized():
            return out
        for d in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(d)
            out[str(d)] = {
                "bytes_in_use": int(stats.get(
                    "allocated_bytes.all.current", -1)),
                "peak_bytes_in_use": int(stats.get(
                    "allocated_bytes.all.peak", -1)),
            }
        return out

    # -- surface -----------------------------------------------------------

    def overview(self) -> dict:
        """The ``device`` Observatory source: flat DEVICE_FIELDS counters
        plus nested per-site sentinel detail and the per-site transfer
        ledger (flattened into ``device_per_fn_<tag>_<field>`` ring
        keys)."""
        snap = dict(self.counters)
        snap["per_fn"] = {tag: dict(ent) for tag, ent in self.per_fn.items()}
        snap["sites"] = {site: dict(s) for site, s in self.sites.items()}
        return snap


#: the process-wide watch: instrumented sites call the module-level taps
WATCH = DeviceWatch()


def record_h2d(site: str, nbytes: int, events: int = 1) -> None:
    WATCH.record_h2d(site, nbytes, events)


def record_d2h(site: str, nbytes: int, events: int = 1) -> None:
    WATCH.record_d2h(site, nbytes, events)


def sample_watermarks(min_interval_s: float = 0.0) -> bool:
    return WATCH.sample_watermarks(min_interval_s)


def bench_tail_keys(commands: Optional[int] = None) -> dict:
    """The device-plane stamp of a bench or soak tail row, under the
    reference's keys: ``n_compiles`` and ``n_recompiles`` (graph captures
    and re-captures), ``compile_time_s`` their wall time,
    ``transfer_bytes`` the ledger's bytes both ways (with
    ``transfer_bytes_per_cmd`` when the caller passes its command count),
    ``peak_live_bytes`` the census's high-water mark.  Process-lifetime
    totals, as in the reference."""
    c = WATCH.counters
    out = {
        "n_compiles": c["compiles"],
        "n_recompiles": c["recompiles"],
        "compile_time_s": round(c["compile_ms"] / 1e3, 6),
        "transfer_bytes": c["h2d_bytes"] + c["d2h_bytes"],
        "peak_live_bytes": c["peak_live_bytes"],
    }
    if commands:
        out["transfer_bytes_per_cmd"] = round(
            out["transfer_bytes"] / commands, 4)
    return out
