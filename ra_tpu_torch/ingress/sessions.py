"""Session directory: a million external clients mapped onto the lane
plane.  A copy of ``ra_tpu/ingress/sessions.py`` (host numpy).

The reference's heritage is MQTT-scale fan-in — thousands of clusters
sharing node-wide batching infrastructure (PAPER.md §0).  Here the
session tier sits ABOVE the lane data plane (the hierarchical
composition of Fast Raft, arxiv 2506.17793): an external client id maps
deterministically to a ``(tenant, lane, shard)`` placement, reconnects
land on the same lane under a bumped session *epoch*, and a per-session
seqno watermark makes resends at-most-once end-to-end — the dedup the
classic FifoClient does per mailbox, vectorized over a million rows.

Scale forces the layout: a Python object per session would be ~1GB of
heap and a per-command attribute chase.  Sessions are therefore rows in
flat numpy arrays (``lane``/``tenant``/``epoch``/``last_seqno``),
addressed by an integer *handle*; every per-command operation
(:meth:`SessionDirectory.fresh`, :meth:`mark`) is one vectorized sweep
over the submitted batch, never a per-session loop.  String external
ids resolve to handles on the (rare) connect path only; bulk fleets use
:meth:`connect_bulk`, which synthesizes placements with a vectorized
splitmix64 so a million sessions connect in milliseconds.

Dedup contract (the at-most-once invariant, pinned by tests): a
``(session, seqno)`` pair enters the engine at most once, ever —
within a batch by first-occurrence uniqueness, across batches/reconnects
by the monotone ``last_seqno`` watermark, which only advances for rows
the coalescer actually PLACED (``mark``), so an admission-rejected or
shed command's seqno survives for a later resend.  Clients submit
seqnos in order (the FifoClient protocol); trace ids are minted as
``<external_id>/<seqno>`` — stable across resends, so a retried command
records under ONE id (the trace-id contract).
"""
from __future__ import annotations

import zlib

import numpy as np

_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _mix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer — the deterministic placement
    hash (stable across processes and PYTHONHASHSEED, unlike hash())."""
    with np.errstate(over="ignore"):  # uint64 wraparound is the point
        z = (x + np.uint64(0x9E3779B97F4A7C15)) & _M64
        z = ((z ^ (z >> np.uint64(30))) *
             np.uint64(0xBF58476D1CE4E5B9)) & _M64
        z = ((z ^ (z >> np.uint64(27))) *
             np.uint64(0x94D049BB133111EB)) & _M64
        return z ^ (z >> np.uint64(31))


class SessionDirectory:
    """External client ids → (tenant, lane, shard) with vectorized
    per-session seqno dedup.  One instance per ingress plane."""

    def __init__(self, n_lanes: int, *, n_shards: int = 1, seed: int = 0,
                 capacity: int = 4096) -> None:
        if n_lanes < 1:
            raise ValueError("n_lanes must be >= 1")
        self.n_lanes = int(n_lanes)
        self.n_shards = max(1, int(n_shards))
        self.seed = int(seed)
        self.n_sessions = 0
        self._ids: dict[str, int] = {}       # named sessions only
        self._bulk: dict[str, tuple] = {}    # bulk key -> (base, n)
        self._tenant_ids: dict[str, int] = {}
        cap = max(16, int(capacity))
        self.lane = np.zeros(cap, np.int32)
        self.tenant = np.zeros(cap, np.int32)
        self.epoch = np.zeros(cap, np.int32)
        #: highest seqno PLACED into the engine path per session — the
        #: at-most-once watermark (advanced by mark(), never by fresh())
        self.last_seqno = np.zeros(cap, np.int64)

    # -- capacity ----------------------------------------------------------

    @property
    def capacity(self) -> int:
        return len(self.lane)

    def _ensure(self, n: int) -> None:
        cap = len(self.lane)
        if n <= cap:
            return
        new = max(n, cap * 2)
        for name in ("lane", "tenant", "epoch", "last_seqno"):
            arr = getattr(self, name)
            grown = np.zeros(new, arr.dtype)
            grown[:cap] = arr
            setattr(self, name, grown)

    # -- placement ---------------------------------------------------------

    def _hash_id(self, external_id: str) -> int:
        return int(_mix64(np.uint64(
            (zlib.crc32(external_id.encode()) ^ (self.seed & 0xFFFFFFFF))
            & 0xFFFFFFFF)))

    def place(self, external_id: str) -> tuple:
        """Deterministic ``(tenant, lane, shard)`` for an external id —
        stable across reconnects and processes.  Tenant is the id's
        ``<tenant>/<client>`` prefix (or ``"default"``)."""
        tenant, sep, _rest = external_id.partition("/")
        if not sep:
            tenant = "default"
        lane = self._hash_id(external_id) % self.n_lanes
        return tenant, lane, self.shard_of(lane)

    def lanes_of(self, handles) -> np.ndarray:
        """Vectorized handle → lane gather (the serving-path placement
        check reads this per sweep batch)."""
        return self.lane[np.asarray(handles, np.int64)]

    def shard_of(self, lane) -> np.ndarray:
        """Lane → WAL/engine shard bucket (contiguous lane slices, the
        EngineDurability layout)."""
        return (np.asarray(lane, np.int64) * self.n_shards
                // self.n_lanes).astype(np.int32)

    def _tenant_id(self, tenant: str) -> int:
        tid = self._tenant_ids.get(tenant)
        if tid is None:
            tid = len(self._tenant_ids)
            self._tenant_ids[tenant] = tid
        return tid

    @property
    def n_tenants(self) -> int:
        return max(1, len(self._tenant_ids))

    # -- connect -----------------------------------------------------------

    def connect(self, external_id: str) -> tuple:
        """Resolve (or create) the session for an external id.  Returns
        ``(handle, reconnected)``; a reconnect bumps the session epoch
        but keeps placement AND the dedup watermark — resends of
        in-flight commands from before the drop hit the same at-most-
        once gate (the reconnect contract the tests pin)."""
        h = self._ids.get(external_id)
        if h is not None:
            self.epoch[h] += 1
            return h, True
        tenant, lane, _shard = self.place(external_id)
        h = self.n_sessions
        self._ensure(h + 1)
        self.n_sessions = h + 1
        self.lane[h] = lane
        self.tenant[h] = self._tenant_id(tenant)
        self.epoch[h] = 1
        self._ids[external_id] = h
        return h, False

    def connect_bulk(self, n: int, *, key: str = "bulk",
                     tenants: int = 1) -> np.ndarray:
        """Connect ``n`` synthetic sessions (the simulation-scale path):
        placement is a vectorized splitmix64 over ``(seed, key, i)``,
        tenants assigned round-robin over ``tenants`` synthetic tenant
        names.  Calling again with the same key returns the SAME
        handles with every epoch bumped (a fleet-wide reconnect)."""
        got = self._bulk.get(key)
        if got is not None:
            base, m = got
            if m != n:
                raise ValueError(f"bulk key {key!r} has {m} sessions")
            h = np.arange(base, base + n, dtype=np.int64)
            self.epoch[h] += 1
            return h
        base = self.n_sessions
        self._ensure(base + n)
        self.n_sessions = base + n
        h = np.arange(base, base + n, dtype=np.int64)
        mix = _mix64(np.uint64(zlib.crc32(f"{self.seed}:{key}".encode()))
                     + h.astype(np.uint64))
        self.lane[h] = (mix % np.uint64(self.n_lanes)).astype(np.int32)
        # round-robin over the REGISTERED bulk tenant ids: with named
        # tenants already in the table, raw modulo values would alias
        # them and charge the fleet to an innocent tenant's quota
        tids = np.array([self._tenant_id(f"bulk-{t}")
                         for t in range(max(1, tenants))], np.int32)
        self.tenant[h] = tids[h % max(1, tenants)]
        self.epoch[h] = 1
        self._bulk[key] = (base, n)
        return h

    # -- seqno dedup (vectorized; the at-most-once gate) -------------------

    def fresh(self, handles: np.ndarray, seqnos: np.ndarray) -> np.ndarray:
        """Boolean mask of rows never seen before: seqno above the
        session's placed watermark AND first occurrence of its
        ``(handle, seqno)`` pair within this batch.  Pure — the
        watermark only advances via :meth:`mark` for rows that were
        actually placed, so a rejected/shed row's resend stays fresh."""
        handles = np.asarray(handles, np.int64)
        seqnos = np.asarray(seqnos, np.int64)
        fresh = seqnos > self.last_seqno[handles]
        if len(handles) > 1:
            # first-occurrence uniqueness on the FULL (handle, seqno)
            # pair: a resend duplicated WITHIN one batch must not pass
            # the watermark check twice.  Lexsort + neighbor compare —
            # a packed single-key form would truncate one component
            # and silently DUP two distinct rows that collide
            n = len(handles)
            order = np.lexsort((seqnos, handles))
            sh, ss = handles[order], seqnos[order]
            dup_sorted = np.zeros(n, bool)
            dup_sorted[1:] = (sh[1:] == sh[:-1]) & (ss[1:] == ss[:-1])
            mask = np.empty(n, bool)
            mask[order] = ~dup_sorted
            fresh &= mask
        return fresh

    def mark(self, handles: np.ndarray, seqnos: np.ndarray) -> None:
        """Advance the placed watermark for rows the coalescer accepted
        (call with the PLACED subset only)."""
        np.maximum.at(self.last_seqno, np.asarray(handles, np.int64),
                      np.asarray(seqnos, np.int64))

    def next_seqnos(self, handles: np.ndarray) -> np.ndarray:
        """Convenience for tests/demos: mint the next seqnos a well-
        behaved client would send (watermark + within-batch rank + 1).
        Real clients own their seqno counters (the FifoClient model)."""
        from .coalesce import batch_rank
        handles = np.asarray(handles, np.int64)
        return self.last_seqno[handles] + batch_rank(handles) + 1

    def trace_ctx(self, external_id: str, seqno: int) -> str:
        """Deterministic ingress trace id (the trace-id contract): stable
        across resends, so a retried command's duplicate records under
        the same id — mirrors FifoClient._trace_ctx."""
        return f"{external_id}/{seqno}"

    def overview(self) -> dict:
        return {
            "sessions": int(self.n_sessions),
            "tenants": len(self._tenant_ids),
            "named_sessions": len(self._ids),
            "n_lanes": self.n_lanes,
            "n_shards": self.n_shards,
        }


def default_directory(engine, **kw) -> SessionDirectory:
    """Directory sized for an engine: lanes from the engine, shard
    count from its durability bridge when attached."""
    dur = getattr(engine, "_dur", None)
    n_shards = getattr(dur, "wal_shards", 1) if dur is not None else 1
    kw.setdefault("n_shards", n_shards)
    return SessionDirectory(engine.n_lanes, **kw)
