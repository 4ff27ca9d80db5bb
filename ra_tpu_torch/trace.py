"""Tracing hooks: the port's own copy of ``ra_tpu/trace.py``.

Profiling stays out of the hot path, with an always-off-by-default
contract:

* a process-wide swappable :class:`Tracer` (``set_tracer`` /
  ``get_tracer``);
* span recording into a bounded in-memory buffer, dumped as Chrome
  trace-event JSON (chrome://tracing and perfetto load it directly);
* when no tracer is installed the instrumentation costs one module
  attribute read and an ``is None`` test per site.

Instrumented sites: the durable engine's dispatch and its WAL bridge
(``engine/lockstep.py``, ``engine/durable.py``), the WAL batch loop
(``log/wal.py``), and anything user code wraps in ``trace.span``.
:func:`torch_profile`, the counterpart of the reference's
``jax_profile``, captures a device timeline with ``torch.profiler``.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Iterator, Optional

#: the installed tracer, or None (tracing disabled).  Module attribute on
#: purpose: instrumented call sites read it once per operation.
_tracer: Optional["Tracer"] = None


def set_tracer(tracer: Optional["Tracer"]) -> None:
    """Install (or, with None, remove) the process-wide tracer."""
    global _tracer
    _tracer = tracer


def get_tracer() -> Optional["Tracer"]:
    return _tracer


class Tracer:
    """Bounded in-memory span/counter recorder.

    Spans nest freely across threads (thread id becomes the Chrome
    ``tid``); the buffer is a ring of ``capacity`` events — tracing a
    long bench keeps the newest events instead of growing unboundedly.
    """

    def __init__(self, capacity: int = 200_000) -> None:
        self.capacity = capacity
        self._events: list = []
        self._head = 0          # ring cursor once the buffer is full
        self._dropped = 0       # events overwritten after the ring wrapped
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    # -- recording ---------------------------------------------------------

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _push(self, evt: dict) -> None:
        with self._lock:
            if len(self._events) < self.capacity:
                self._events.append(evt)
            else:
                self._events[self._head] = evt
                self._head = (self._head + 1) % self.capacity
                self._dropped += 1

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "ra", **args: Any) -> Iterator[None]:
        """Record a complete ("ph":"X") span around the with-body."""
        start = self._now_us()
        try:
            yield
        finally:
            self._push({"name": name, "cat": cat, "ph": "X",
                        "ts": start, "dur": self._now_us() - start,
                        "pid": os.getpid(),
                        "tid": threading.get_ident() & 0xFFFF,
                        **({"args": args} if args else {})})

    def instant(self, name: str, cat: str = "ra", **args: Any) -> None:
        self._push({"name": name, "cat": cat, "ph": "i", "s": "t",
                    "ts": self._now_us(), "pid": os.getpid(),
                    "tid": threading.get_ident() & 0xFFFF,
                    **({"args": args} if args else {})})

    def counter(self, name: str, **values: float) -> None:
        self._push({"name": name, "ph": "C", "ts": self._now_us(),
                    "pid": os.getpid(), "tid": 0, "args": values})

    # -- readout -----------------------------------------------------------

    def events(self) -> list:
        with self._lock:
            if len(self._events) < self.capacity:
                return list(self._events)
            return (self._events[self._head:] + self._events[:self._head])

    @property
    def wrapped(self) -> bool:
        """True once the ring has overwritten at least one event —
        the buffer no longer holds the full history."""
        return self._dropped > 0

    @property
    def dropped_events(self) -> int:
        return self._dropped

    def dump_chrome_trace(self, path: str) -> str:
        """Write the buffer as Chrome trace-event JSON (atomic replace);
        load in chrome://tracing or ui.perfetto.dev."""
        payload = {"traceEvents": self.events(),
                   "displayTimeUnit": "ms"}
        tmp = path + ".partial"
        with open(tmp, "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path

    def summary(self) -> dict:
        """Per-span-name {count, total_us, max_us} rollup — the quick
        console profile when a full timeline is overkill.  The ``_meta``
        entry reports whether the ring wrapped (``wrapped: True`` +
        ``dropped_events``): a truncated trace's counts cover only the
        newest ``capacity`` events and must not be read as totals."""
        out: dict[str, dict] = {}
        for e in self.events():
            if e.get("ph") != "X":
                continue
            s = out.setdefault(e["name"],
                               {"count": 0, "total_us": 0.0, "max_us": 0.0})
            s["count"] += 1
            s["total_us"] += e["dur"]
            s["max_us"] = max(s["max_us"], e["dur"])
        out["_meta"] = {"wrapped": self.wrapped,
                        "dropped_events": self._dropped}
        return out


# -- zero-overhead instrumentation helper -----------------------------------

#: shared no-op context (nullcontext is documented reentrant+reusable):
#: the disabled path allocates nothing per call
_NULL = contextlib.nullcontext()


def span(name: str, cat: str = "ra", **args: Any):
    """Span against the installed tracer, or a shared no-op context when
    tracing is off (one attribute read + None test + the call itself)."""
    t = _tracer
    if t is None:
        return _NULL
    return t.span(name, cat, **args)


def instant(name: str, cat: str = "ra", **args: Any) -> None:
    t = _tracer
    if t is not None:
        t.instant(name, cat, **args)


# -- device-side profiling ---------------------------------------------------

@contextlib.contextmanager
def torch_profile(log_dir: str) -> Iterator[Any]:
    """Capture a ``torch.profiler`` trace (host ops and, on a card, its
    kernels and copies) around the with-body and write it to
    ``log_dir/trace.json`` (Chrome trace-event format) on exit.  Yields
    the profiler, so the caller can read ``key_averages()`` too.

    The capture is stamped into the flight recorder on exit
    (``profile.captured`` + the profile dir), so it shows up in
    timelines next to the events it covers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .blackbox import record

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    record("profile.captured", dir=str(log_dir),
           wall_s=round(time.perf_counter() - t0, 3))
