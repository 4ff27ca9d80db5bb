"""The at-least-once wire client library (the client half
docs/INGRESS.md specifies).  A copy of ``ra_tpu/wire/client.py`` (host
numpy and sockets).

Delivery contract (the reference's split, PAPER.md §1): the server
gate is at-most-once, so the client owns redelivery —

* commands pipeline freely under per-session seqnos (the
  ``pipeline_command`` discipline);
* every command is an **op** with a monotone per-session ``op_id`` and
  stays in the client's replay window until *acked* (its session's
  committed-row watermark covers it);
* a **refusal** (defer/reject/shed credit verdict) re-queues the op —
  its seqno is burned, the resend gets a fresh one;
* a **reconnect** observes the epoch bump in HELLO_ACK and re-enqueues
  every unacked op — including placed-but-unacked ones, whose first
  copy may still commit: the duplicate is absorbed MACHINE-side
  (:class:`~ra_tpu_torch.wire.dedup.DedupCounterMachine`), which is what
  upgrades end-to-end semantics to exactly-once-observable.

Two implementations share the contract:

* :class:`WireClient` — one real TCP connection (blocking socket,
  per-frame Python): the integration-test / example client.
* :class:`LoopbackFleet` — N in-process connections driven as flat
  numpy arrays (the C100k→C1M ladder client): every step — op
  creation, seqno minting, DATA encode, credit/ack decode, replay
  bookkeeping — is a vectorized sweep over the whole fleet, mirroring
  the server's RA09 discipline from the client side.
"""
from __future__ import annotations

import socket
from typing import Optional

import numpy as np

from ..ingress.coalesce import batch_rank
from .server import dedup_watermarks
from .framing import (DEFER, DUP, OK, REJECT, SHED, SLOW, T_ACK, T_CREDIT,
                      T_ERR, T_HELLO_ACK, T_REHOME, decode_ack,
                      decode_credit, decode_error, decode_hello_ack,
                      decode_rehome, encode_data, encode_hello,
                      read_frame)

#: op replay states
QUEUED, SENT, PLACED = 0, 1, 2


class WireClient:
    """One TCP connection, ``n_sessions`` multiplexed wire sessions,
    at-least-once op replay."""

    def __init__(self, address, key: str, *, n_sessions: int = 1,
                 tenants: int = 1, payload_width: int = 3,
                 timeout: float = 10.0) -> None:
        self.address = tuple(address)
        self.key = key
        self.n_sessions = int(n_sessions)
        self.tenants = int(tenants)
        self.payload_width = int(payload_width)
        self.timeout = float(timeout)
        self.epoch = 0
        self.handle_base = -1
        self.slots: Optional[np.ndarray] = None
        self.next_seq = np.ones(self.n_sessions, np.int64)
        self.next_op = np.ones(self.n_sessions, np.int64)
        self.placed_cnt = np.zeros(self.n_sessions, np.int64)
        self.watermark = np.zeros(self.n_sessions, np.int64)
        self.reconnects = 0
        #: ops: parallel lists (a client is per-connection scale — the
        #: vectorized bookkeeping lives in LoopbackFleet)
        self.op_sess: list = []
        self.op_id: list = []
        self.op_pay: list = []
        self.op_state: list = []
        self.op_rank: list = []       # placement rank per session
        #: ever placed on SOME home (survives the rank reset a re-home
        #: performs): such an op's refused replay is dropped, never
        #: re-keyed — its first copy is placed and will commit
        self.op_ever: list = []
        self._queued: list = []       # op indices awaiting (re)send
        self._pending: dict = {}      # (sess, seqno) -> op index
        self._placed_order: dict = {} # sess -> [op index] in rank order
        self._rx = b""
        self.last_credit_level = 0
        #: REHOME hint handling: ``rehome_resolver`` maps an
        #: engine id to its listener address (the client's service-
        #: discovery hook); a received hint is followed — reconnect to
        #: the resolved home, epoch bump, unacked window replayed — AT
        #: MOST ONCE per connection epoch, so a burst of hints from
        #: frames already on the wire cannot reconnect-storm the client
        self.rehome_resolver = None
        self.rehome_hint = None          # latest (engine, gen, rev)
        self.rehome_follows = 0
        self._followed_epoch = -1
        self.sock: Optional[socket.socket] = None
        self._connect()

    # -- connection lifecycle ----------------------------------------------

    def _connect(self) -> None:
        # a fresh socket is a fresh frame stream: a stale partial
        # frame kept from the old connection would swallow the new
        # HELLO_ACK bytes as its body and desynchronize every frame
        # after it
        self._rx = b""
        self.sock = socket.create_connection(self.address,
                                             timeout=self.timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock.sendall(encode_hello(self.key, self.n_sessions,
                                       tenants=self.tenants,
                                       payload_width=self.payload_width))
        body = self._read_frame_blocking()
        if body is None:
            raise ConnectionError("wire: no HELLO_ACK")
        if body[0] == T_ERR:
            # the listener refused the handshake (version or
            # payload-width mismatch): surface its reason verbatim
            err = decode_error(body[1])
            raise ConnectionError("wire: refused: %s" % err["message"])
        if body[0] != T_HELLO_ACK:
            raise ConnectionError("wire: no HELLO_ACK")
        ack = decode_hello_ack(body[1])
        srv_width = ack.get("payload_width", 0)
        if srv_width and srv_width != self.payload_width:
            raise ConnectionError(
                "wire: payload_width %d != listener's %d"
                % (self.payload_width, srv_width))
        new_epoch = ack["epoch"]
        self.handle_base = ack["handle_base"]
        self.slots = ack["slots"][:self.n_sessions] \
            if ack["slots"] is not None else None
        if self.epoch and new_epoch > self.epoch:
            # the at-least-once pivot: everything unacked replays under
            # fresh seqnos; machine-level dedup absorbs the duplicates
            self._requeue_unacked()
        self.epoch = new_epoch

    def reconnect(self) -> None:
        """Drop the connection and redial under the SAME key: the
        server bumps the session epoch and the client re-enqueues its
        unacked window (the docs/INGRESS.md client contract).  Pending
        verdicts are drained first (best effort); one genuinely lost
        with the wire is covered by the one-batch-per-session flush
        gate — the un-credited window is always a send-order SUFFIX,
        so the old-id replay is gap-free and machine-dedup exact."""
        try:
            self.poll()
        except OSError:
            pass
        self.close(keep_state=True)
        self.reconnects += 1
        self._connect()

    def _requeue_unacked(self) -> None:
        self._pending.clear()
        requeue = [i for i in range(len(self.op_state))
                   if self.op_state[i] != QUEUED and not self._acked(i)]
        for i in requeue:
            self.op_state[i] = QUEUED
        self._queued = sorted(set(self._queued) | set(requeue))

    def rehome_to(self, address, durable=None) -> None:
        """Move this client to a NEW home serving its recovered
        session state (placement failover over TCP) — the
        WireClient twin of :meth:`LoopbackFleet.rehome`.  The new
        listener must have PRE-CLAIMED this client's session block
        (:meth:`WireListener.claim_sessions` — the ``host_rehome``
        control verb) with the old dedup slots and the acked
        watermarks, so replayed payloads hit the recovered machine's
        per-(lane, slot) dedup.

        Rank bookkeeping restarts at the acked watermark (ranks the
        old home burned on rows it never durably committed die with
        it), the pending window drops (old-home credits never
        arrive), and every unacked op requeues for at-least-once
        replay.  ``durable`` — the per-session durably-applied op-id
        watermarks ``claim_sessions`` returned — re-bases
        ``op_ever``: an op the old home placed but never fsynced is
        gone from every durable record, so its replay may re-key on
        refusal like any never-placed op.  Without it (``None``, the
        self-serve hint-follow path) every previously-placed op stays
        ever-placed — conservatively never double-applies, at the
        cost that a shed replay of a LOST copy is dropped rather than
        re-keyed."""
        self.address = tuple(address)
        n = len(self.op_state)
        dur = None if durable is None else np.asarray(durable, np.int64)
        for i in range(n):
            ever = self.op_rank[i] >= 0 or self.op_ever[i]
            if dur is not None:
                ever = ever and \
                    self.op_id[i] <= int(dur[self.op_sess[i]])
            self.op_ever[i] = ever
            if self.op_state[i] != QUEUED and not self._acked(i):
                self.op_state[i] = QUEUED
                self.op_rank[i] = -1
                self._queued.append(i)
        self._queued = sorted(set(self._queued))
        self._pending.clear()
        self.placed_cnt[:] = self.watermark
        self._placed_order = {}
        self.close(keep_state=True)
        self.reconnects += 1
        self._connect()

    def close(self, keep_state: bool = False) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None
        if not keep_state:
            self._rx = b""

    # -- enqueue / flush ----------------------------------------------------

    def enqueue(self, delta: int, sess: int = 0) -> int:
        """Queue one op; returns its op index.  Payload layout follows
        the DedupCounterMachine contract when the server handed out
        dedup slots (``[slot, op_id, delta]``), else a bare counter
        increment."""
        op = int(self.next_op[sess])
        self.next_op[sess] += 1
        idx = len(self.op_sess)
        self.op_sess.append(int(sess))
        self.op_id.append(op)
        self.op_pay.append(int(delta))
        self.op_state.append(QUEUED)
        self.op_rank.append(-1)
        self.op_ever.append(False)
        self._queued.append(idx)
        return idx

    def _payload(self, idx_list) -> np.ndarray:
        n = len(idx_list)
        pay = np.zeros((n, self.payload_width), np.int32)
        deltas = np.array([self.op_pay[i] for i in idx_list], np.int32)
        if self.payload_width >= 3 and self.slots is not None:
            sess = np.array([self.op_sess[i] for i in idx_list])
            pay[:, 0] = self.slots[sess]
            pay[:, 1] = np.array([self.op_id[i] for i in idx_list])
            pay[:, 2] = deltas
        else:
            pay[:, 0] = deltas
        return pay

    def flush(self) -> int:
        """Encode + send every queued op (pipelined, fresh seqnos);
        returns the number of records sent."""
        if not self._queued or self.sock is None:
            return 0
        # one outstanding un-credited batch per session (the gap-free
        # crash-replay discipline, docs/INGRESS.md): a session with
        # verdicts still in flight must not layer NEW ops above a
        # possible unknown refusal — its un-credited window then stays
        # a send-order SUFFIX, so an old-id replay after a crash can
        # never be watermark-skipped below a later commit
        busy = {self.op_sess[i] for i in self._pending.values()}
        held = [i for i in set(self._queued)
                if self.op_sess[i] in busy]
        # per-session ascending op ids (see LoopbackFleet.send_queued:
        # replays below an already-placed id must only ever be placed
        # dups, never droppable fresh ops)
        idx = sorted(set(self._queued) - set(held),
                     key=lambda i: (self.op_sess[i], self.op_id[i]))
        self._queued = held
        if not idx:
            return 0
        sess = np.array([self.op_sess[i] for i in idx], np.int64)
        seq = self.next_seq[sess] + batch_rank(sess)
        np.add.at(self.next_seq, sess, 1)
        for i, s, q in zip(idx, sess.tolist(), seq.tolist()):
            self._pending[(s, q)] = i
            self.op_state[i] = SENT
        try:
            self.sock.sendall(encode_data(sess, seq,
                                          self._payload(idx)))
        except OSError:
            # connection died mid-send: ops stay pending; the epoch
            # bump at reconnect() replays them
            pass
        return len(idx)

    # -- receive ------------------------------------------------------------

    def _read_frame_blocking(self):
        self.sock.settimeout(self.timeout)
        while True:
            got = read_frame(self._rx)
            if got is not None:
                t, body, off = got
                self._rx = self._rx[off:]
                return t, body
            chunk = self.sock.recv(1 << 16)
            if not chunk:
                return None
            self._rx += chunk

    def poll(self, max_frames: int = 64) -> int:
        """Drain available CREDIT/ACK frames without blocking; returns
        the number of frames processed."""
        if self.sock is None:
            return 0
        self.sock.settimeout(0.0)
        try:
            while len(self._rx) < 1 << 20:
                chunk = self.sock.recv(1 << 16)
                if not chunk:
                    break
                self._rx += chunk
        except (BlockingIOError, socket.timeout, OSError):
            pass
        done = 0
        while done < max_frames:
            got = read_frame(self._rx)
            if got is None:
                break
            t, body, off = got
            self._rx = self._rx[off:]
            self._handle_frame(t, body)
            done += 1
        return done

    def _handle_frame(self, t: int, body: bytes) -> None:
        if t == T_CREDIT:
            _level, rec = decode_credit(body)
            self.last_credit_level = _level
            for r in rec:
                self._on_verdict(int(r["sess"]), int(r["seqno"]),
                                 int(r["status"]))
        elif t == T_ACK:
            for r in decode_ack(body):
                s = int(r["sess"])
                self.watermark[s] = max(self.watermark[s],
                                        int(r["acked"]))
        elif t == T_REHOME:
            hint = decode_rehome(body)
            self.rehome_hint = (hint["engine"], hint["generation"],
                                hint["rev"])
            self._maybe_follow_rehome(hint)

    def _maybe_follow_rehome(self, hint: dict) -> None:
        """Follow a REHOME hint at most once per connection epoch
       .  The gate is recorded BEFORE the redial: any
        further hints already buffered from the old socket (or drained
        by reconnect()'s best-effort poll) find the epoch spent and
        are kept as data only — no reconnect storm.  Without a
        resolver the hint is surfaced (``rehome_hint``) but never
        acted on; the caller owns service discovery."""
        if self.rehome_resolver is None:
            return
        if self._followed_epoch == self.epoch:
            return
        addr = self.rehome_resolver(hint["engine"])
        if addr is None:
            return
        self._followed_epoch = self.epoch
        self.rehome_follows += 1
        self.rehome_to(addr)

    def _on_verdict(self, sess: int, seqno: int, status: int) -> None:
        i = self._pending.pop((sess, seqno), None)
        if i is None:
            return
        if status in (OK, SLOW):
            self.op_state[i] = PLACED
            self.op_rank[i] = int(self.placed_cnt[sess])
            self.op_ever[i] = True
            self.placed_cnt[sess] += 1
            self._placed_order.setdefault(sess, []).append(i)
        elif status in (DEFER, REJECT, SHED):
            if self.op_rank[i] >= 0 or self.op_ever[i]:
                # refused REPLAY of an ever-placed op: the first copy
                # is placed and will commit — drop the replay
                self.op_state[i] = PLACED
                return
            # a refusal of a never-placed op re-keys: the machine's
            # per-slot watermark dedup requires op ids to reach it
            # monotonically, and a stale id replayed after later ops
            # committed would be skipped as a duplicate — a lost
            # command (re-keying a possibly-placed op would instead
            # double-apply; only never-placed refusals may re-key)
            self.op_state[i] = QUEUED
            self.op_id[i] = int(self.next_op[sess])
            self.next_op[sess] += 1
            self._queued.append(i)
        elif status == DUP:
            # already placed under an earlier seqno: nothing to replay
            self.op_state[i] = PLACED
            self.op_ever[i] = True

    # -- progress -----------------------------------------------------------

    def _acked(self, i: int) -> bool:
        return self.op_state[i] == PLACED and self.op_rank[i] >= 0 and \
            self.op_rank[i] < self.watermark[self.op_sess[i]]

    def acked_count(self) -> int:
        return sum(1 for i in range(len(self.op_state))
                   if self._acked(i))

    def unacked_count(self) -> int:
        return len(self.op_state) - self.acked_count()

    def pending_count(self) -> int:
        return len(self._pending) + len(self._queued)


class LoopbackFleet:
    """N in-process wire connections as flat numpy state — the ladder
    client.  One instance drives the whole fleet: ops, seqnos, encode,
    credit/ack decode and the at-least-once replay window are all
    vectorized sweeps (no per-connection Python anywhere on the wave
    path)."""

    #: packed (handle, seqno) join key base (seqnos stay < 2^40)
    _SEQ_BITS = 40

    def __init__(self, listener, n_conns: int, *,
                 sessions_per_conn: int = 1, key: str = "fleet",
                 tenants: int = 1, seed: int = 0,
                 max_ops: int = 1 << 20) -> None:
        self.listener = listener
        self.n_conns = int(n_conns)
        self.spc = int(sessions_per_conn)
        self.key = key
        self.tenants = max(1, int(tenants))
        self.rng = np.random.default_rng(seed)
        self.conns = listener.loopback_connect(
            n_conns, sessions_per_conn=self.spc, key=key,
            tenants=tenants)
        self.n_sessions = self.n_conns * self.spc
        self.base = int(listener.hbase[self.conns[0]])
        self.handles = self.base + np.arange(self.n_sessions,
                                             dtype=np.int64)
        self.slots = listener.session_slots(self.handles)
        self.payload_width = listener.payload_width
        # per-session state
        self.next_seq = np.ones(self.n_sessions, np.int64)
        self.next_op = np.ones(self.n_sessions, np.int64)
        self.placed_cnt = np.zeros(self.n_sessions, np.int64)
        self.watermark = np.zeros(self.n_sessions, np.int64)
        # op store (preallocated; sess is the FLEET session index)
        self.max_ops = int(max_ops)
        self.op_sess = np.zeros(self.max_ops, np.int64)
        self.op_id = np.zeros(self.max_ops, np.int64)
        self.op_delta = np.zeros(self.max_ops, np.int32)
        self.op_state = np.zeros(self.max_ops, np.int8)
        self.op_rank = np.full(self.max_ops, -1, np.int64)
        #: ever placed on SOME home — survives the rank reset a
        #: re-home performs, so the refusal path can still tell "this
        #: replay's first copy may have committed" (such ops are
        #: dropped on refusal, never re-keyed; see _on_credit)
        self.op_ever = np.zeros(self.max_ops, bool)
        self.n_ops = 0
        # (packed key -> op) pending-credit join, kept sorted
        self._pend_key = np.zeros(0, np.int64)
        self._pend_op = np.zeros(0, np.int64)
        #: un-credited rows in flight per session — the one-batch
        #: flush gate (see send_queued)
        self._pend_per_sess = np.zeros(self.n_sessions, np.int64)
        self.reconnects = 0
        #: REHOME hints drained from the listener: the
        #: latest ``(slot, engine, generation, rev)`` plus a count —
        #: the driver (soak / rehome harness) owns the follow action,
        #: mirroring WireClient.rehome_resolver
        self.rehome_hint = None
        self.rehome_hints = 0
        # per-tenant verdict tallies (the soak's shed-fairness evidence)
        d = listener.plane.directory
        self.tenant_of = d.tenant[self.handles].astype(np.int64)
        nt = max(1, d.n_tenants)
        self.tenant_rows = np.zeros(nt, np.int64)
        self.tenant_shed = np.zeros(nt, np.int64)

    # -- ops ----------------------------------------------------------------

    def new_ops(self, sess_idx: np.ndarray, deltas: np.ndarray) -> None:
        """Mint one op per row (monotone per-session op ids)."""
        n = len(sess_idx)
        if self.n_ops + n > self.max_ops:
            raise RuntimeError("fleet op store full")
        lo = self.n_ops
        self.n_ops += n
        sess_idx = np.asarray(sess_idx, np.int64)
        self.op_sess[lo:lo + n] = sess_idx
        self.op_id[lo:lo + n] = self.next_op[sess_idx] + \
            batch_rank(sess_idx)
        np.add.at(self.next_op, sess_idx, 1)
        self.op_delta[lo:lo + n] = deltas
        self.op_state[lo:lo + n] = QUEUED
        self.op_rank[lo:lo + n] = -1

    def queued_ops(self) -> np.ndarray:
        return np.flatnonzero(self.op_state[:self.n_ops] == QUEUED)

    # -- send (vectorized wave) --------------------------------------------

    def send_queued(self, max_rows: int = 1 << 20) -> int:
        """Encode + feed every queued op into the server rings (fresh
        seqnos, conn-ordered records); returns rows actually placed on
        the transport (ring overflow keeps the tail queued)."""
        idx = self.queued_ops()
        if not len(idx):
            return 0
        # one outstanding un-credited batch per session (the gap-free
        # crash-replay discipline, docs/INGRESS.md): never layer new
        # sends above verdicts still in flight — the un-credited
        # window stays a send-order suffix, so a crash replay under
        # original ids can never be watermark-skipped below a later
        # commit.  (The synchronous soak cycle collects credit before
        # each wave, so this gate binds only under genuine loss.)
        idx = idx[self._pend_per_sess[self.op_sess[idx]] == 0]
        if not len(idx):
            return 0
        sess = self.op_sess[idx]
        conn_i = sess // self.spc
        # send order is per-session ASCENDING op id, not op-creation
        # order: the queue mixes storm replays (old ids) with re-keyed
        # refusals (fresh high ids), and the machine's watermark dedup
        # drops any never-placed op that arrives below an already-
        # placed id — ascending ids per session make that impossible
        # (a replayed-below-watermark op is then always a placed dup)
        order = np.lexsort((self.op_id[idx], sess, conn_i))
        idx, sess, conn_i = idx[order], sess[order], conn_i[order]
        # max_rows truncation AFTER the sort: a prefix of the sorted
        # batch keeps every surviving session's lowest ids, so a
        # truncated session still sends an ascending prefix.  (An
        # op-creation-order cut would send a re-keyed high id while a
        # newer low-id op waits — exactly the inversion the sort
        # exists to prevent; found as a real ~0.1% command loss at the
        # C1M rung.)
        if len(idx) > max_rows:
            idx = idx[:max_rows]
            sess = sess[:max_rows]
            conn_i = conn_i[:max_rows]
        seq = self.next_seq[sess] + batch_rank(sess)
        np.add.at(self.next_seq, sess, 1)
        pay = np.zeros((len(idx), self.payload_width), np.int32)
        if self.payload_width >= 3:
            pay[:, 0] = self.slots[sess]
            pay[:, 1] = self.op_id[idx]
            pay[:, 2] = self.op_delta[idx]
        else:
            pay[:, 0] = self.op_delta[idx]
        off = sess % self.spc
        rec_bytes = encode_data(off, seq, pay)
        runs, counts = _runs(conn_i)
        take = self.listener.loopback_feed(self.conns[runs], rec_bytes,
                                           counts)
        rank = np.arange(len(idx)) - \
            (np.cumsum(counts) - counts)[np.repeat(
                np.arange(len(runs)), counts)]
        fed = rank < np.repeat(take, counts)
        self.op_state[idx[fed]] = SENT
        np.add.at(self._pend_per_sess, sess[fed], 1)
        key = (self.handles[sess[fed]] << self._SEQ_BITS) | seq[fed]
        self._pend_key = np.concatenate([self._pend_key, key])
        self._pend_op = np.concatenate([self._pend_op, idx[fed]])
        order = np.argsort(self._pend_key, kind="stable")
        self._pend_key = self._pend_key[order]
        self._pend_op = self._pend_op[order]
        return int(fed.sum())

    # -- receive (vectorized credit/ack) ------------------------------------

    def collect(self) -> None:
        """Drain the listener's loopback credit/ack outboxes into the
        replay window (all joins vectorized)."""
        credit, ack = self.listener.collect_loopback()
        for conns, counts, rec in credit:
            handles = self.listener.hbase[np.repeat(conns, counts)] + \
                rec["sess"].astype(np.int64)
            self._on_credit(handles, rec["seqno"].astype(np.int64),
                            rec["status"].astype(np.int8))
        for conns, counts, rec in ack:
            handles = self.listener.hbase[np.repeat(conns, counts)] + \
                rec["sess"].astype(np.int64)
            sess = handles - self.base
            np.maximum.at(self.watermark, sess,
                          rec["acked"].astype(np.int64))
        collect_hints = getattr(self.listener, "collect_rehome_hints",
                                None)
        if collect_hints is not None:
            hints = collect_hints()
            if hints:
                self.rehome_hint = hints[-1]
                self.rehome_hints += len(hints)

    def _on_credit(self, handles, seqnos, statuses) -> None:
        key = (handles << self._SEQ_BITS) | seqnos
        pos = np.searchsorted(self._pend_key, key)
        pos = np.clip(pos, 0, max(0, len(self._pend_key) - 1))
        hit = len(self._pend_key) > 0
        match = hit & (self._pend_key[pos] == key) if hit else \
            np.zeros(len(key), bool)
        ops = self._pend_op[pos[match]]
        st = statuses[match]
        np.add.at(self._pend_per_sess, self.op_sess[ops], -1)
        tn = self.tenant_of[self.op_sess[ops]]
        np.add.at(self.tenant_rows, tn, 1)
        np.add.at(self.tenant_shed, tn[st == SHED], 1)
        placed = (st == OK) | (st == SLOW)
        # DUP is unreachable for a fresh-seqno fleet (it means a seqno
        # was replayed); defensively mark placed WITHOUT a rank so the
        # server's committed-row watermark accounting stays aligned
        self.op_state[ops[st == DUP]] = PLACED
        self.op_ever[ops[st == DUP]] = True
        p_ops = ops[placed]
        sess = self.op_sess[p_ops]
        # placement rank per session: credit rows arrive in placement
        # order, so rank = running count + within-batch rank
        self.op_rank[p_ops] = self.placed_cnt[sess] + batch_rank(sess)
        np.add.at(self.placed_cnt, sess, 1)
        self.op_state[p_ops] = PLACED
        self.op_ever[p_ops] = True
        refused = ops[~placed & (st != DUP)]
        # a refused REPLAY of an ever-placed op is simply dropped: its
        # first copy is placed and will commit — requeueing (let alone
        # re-keying) it would double-apply.  op_ever keeps this truth
        # across a re-home's rank reset.
        ever = (self.op_rank[refused] >= 0) | self.op_ever[refused]
        self.op_state[refused[ever]] = PLACED
        refused = refused[~ever]
        self.op_state[refused] = QUEUED
        # never-placed refusals re-key (see WireClient._on_verdict):
        # the machine's watermark dedup needs monotone op ids per
        # slot, and a refusal of a never-placed op means a fresh id
        # cannot double-apply.  Credit rows arrive in send order, so
        # the re-keyed ids stay monotone within the batch too.
        sess_r = self.op_sess[refused]
        self.op_id[refused] = self.next_op[sess_r] + batch_rank(sess_r)
        np.add.at(self.next_op, sess_r, 1)
        # retire matched pending entries
        keep = np.ones(len(self._pend_key), bool)
        keep[pos[match]] = False
        self._pend_key = self._pend_key[keep]
        self._pend_op = self._pend_op[keep]

    # -- reconnect storm ----------------------------------------------------

    def storm(self, frac: float) -> np.ndarray:
        """Kill ``frac`` of the fleet's connections mid-flight: unswept
        ring bytes are LOST, epochs bump, and every unacked op of the
        victims re-enters the replay queue under fresh seqnos (the
        at-least-once contract; the machine dedups the duplicates)."""
        n = max(1, int(frac * self.n_conns))
        victims = self.rng.choice(self.n_conns, size=n, replace=False)
        vconns = self.conns[victims]
        self.listener.loopback_kill(vconns)
        self.reconnects += n
        vict_sess = (victims[:, None] * self.spc
                     + np.arange(self.spc)[None, :]).ravel()
        vmask = np.zeros(self.n_sessions, bool)
        vmask[vict_sess] = True
        live = self.op_state[:self.n_ops]
        osess = self.op_sess[:self.n_ops]
        acked = (live == PLACED) & (self.op_rank[:self.n_ops] >= 0) & \
            (self.op_rank[:self.n_ops] < self.watermark[osess])
        requeue = vmask[osess] & (live != QUEUED) & ~acked
        self.op_state[:self.n_ops][requeue] = QUEUED
        # drop the victims' pending-credit entries: their ring bytes
        # are gone, the credit will never arrive (the flush gate
        # reopens with them)
        pend_sess = (self._pend_key >> self._SEQ_BITS) - self.base
        keep = ~vmask[pend_sess]
        self._pend_key = self._pend_key[keep]
        self._pend_op = self._pend_op[keep]
        self._pend_per_sess = np.bincount(
            (self._pend_key >> self._SEQ_BITS) - self.base,
            minlength=self.n_sessions)
        return np.flatnonzero(requeue)

    # -- placement re-home ---------------------------------------

    def rehome(self, new_listener, trace_ctx=None) -> np.ndarray:
        """Move the whole fleet to a NEW home serving this fleet's
        recovered lane state (placement failover): bind the same key
        on ``new_listener`` claiming the OLD dedup slots and seeding
        the committed-row watermarks at the acked counts
        (WireListener.loopback_rehome), then carry every in-flight op
        across the move under the at-least-once contract — all unacked
        ops requeue and replay; the recovered machine's per-slot op-id
        watermarks absorb the ones whose first copy committed on the
        old home before it died.

        Rank bookkeeping restarts at the acked watermark: ranks the
        old home assigned to rows it never durably committed are
        burned with it (they would otherwise hold the cumulative ack
        watermark below the replays forever).  ``op_ever`` is re-based
        against the RECOVERED watermarks — an op the old home placed
        but never fsynced is gone from every durable record, so its
        replay is a first copy and may re-key on refusal like any
        never-placed op.

        Returns the indices of the requeued (replaying) ops."""
        old_d = self.listener.plane.directory
        old_lanes = old_d.lane[self.handles].copy()
        self.conns = new_listener.loopback_rehome(
            self.n_conns, sessions_per_conn=self.spc, key=self.key,
            tenants=self.tenants, slots=self.slots,
            committed=self.watermark, trace_ctx=trace_ctx)
        self.listener = new_listener
        self.base = int(new_listener.hbase[self.conns[0]])
        self.handles = self.base + np.arange(self.n_sessions,
                                             dtype=np.int64)
        d = new_listener.plane.directory
        lanes = d.lane[self.handles]
        if not (lanes == old_lanes).all():
            # key→lane hashing is deterministic per (seed, key): a
            # mismatch means the new home's directory was built with a
            # different seed/lane count and the recovered per-lane
            # machine state would not line up with the new placements
            raise RuntimeError(
                "rehome: lane placement diverged between homes")
        self.tenant_of = d.tenant[self.handles].astype(np.int64)
        # per-session durably-applied op-id watermark, straight from
        # the recovered machine state (the fsynced-watermark gate)
        dur_sess = np.zeros(self.n_sessions, np.int64)
        seq = dedup_watermarks(new_listener.plane.engine)
        if seq is not None:
            seq = seq.max(axis=1)
            dur_sess = seq[lanes.astype(np.int64),
                           self.slots.astype(np.int64)].astype(np.int64)
        live = self.op_state[:self.n_ops]
        rank = self.op_rank[:self.n_ops]
        osess = self.op_sess[:self.n_ops]
        acked = (live == PLACED) & (rank >= 0) & \
            (rank < self.watermark[osess])
        durable = self.op_id[:self.n_ops] <= dur_sess[osess]
        self.op_ever[:self.n_ops] = \
            ((rank >= 0) | self.op_ever[:self.n_ops]) & durable
        requeue = (live != QUEUED) & ~acked
        self.op_state[:self.n_ops][requeue] = QUEUED
        self.op_rank[:self.n_ops][requeue] = -1
        self.placed_cnt[:] = self.watermark
        # old-home credits will never arrive: drop the whole pending
        # window (the flush gate reopens with it)
        self._pend_key = np.zeros(0, np.int64)
        self._pend_op = np.zeros(0, np.int64)
        self._pend_per_sess = np.zeros(self.n_sessions, np.int64)
        self.reconnects += self.n_conns
        return np.flatnonzero(requeue)

    # -- progress / oracle --------------------------------------------------

    def acked_mask(self) -> np.ndarray:
        live = self.op_state[:self.n_ops]
        return (live == PLACED) & (self.op_rank[:self.n_ops] >= 0) & \
            (self.op_rank[:self.n_ops]
             < self.watermark[self.op_sess[:self.n_ops]])

    def unplaced_count(self) -> int:
        return int((self.op_state[:self.n_ops] != PLACED).sum())

    def expected_lane_sums(self, n_lanes: int) -> np.ndarray:
        """The exactly-once oracle's truth: every op's delta exactly
        once, summed per lane."""
        lanes = self.listener.plane.directory.lane[
            self.handles[self.op_sess[:self.n_ops]]]
        out = np.zeros(n_lanes, np.int64)
        np.add.at(out, lanes, self.op_delta[:self.n_ops].astype(np.int64))
        return out


def _runs(keys: np.ndarray) -> tuple:
    """Run-length encode a non-decreasing key array."""
    n = len(keys)
    new = np.empty(n, bool)
    new[0] = True
    new[1:] = keys[1:] != keys[:-1]
    starts = np.flatnonzero(new)
    counts = np.diff(np.append(starts, n))
    return keys[starts], counts
