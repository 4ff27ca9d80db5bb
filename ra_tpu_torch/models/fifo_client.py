"""Client session for :class:`ra_tpu_torch.models.fifo.FifoMachine` (the
port's own copy of ``ra_tpu/models/fifo_client.py``).

The reference pairs its fifo machine with ``test/ra_fifo_client.erl``: a
stateful client that assigns per-sender sequence numbers, pipelines
enqueues with applied-notifications, resends unapplied commands after a
leader change, and demultiplexes deliveries.  This is the equivalent
here, built on the public API (ra_tpu_torch.api).

A client owns a :class:`Mailbox` — the opaque "pid" the machine monitors
and delivers to.  The node shell routes SendMsg effects to callables, so
Mailbox is callable and thread-safe by way of deque's atomic appends.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Any, Optional

from .. import api
from ..core.types import Priority, ServerId
# the ONE verdict enum: FifoClient's ok → slow → StopSending ladder
# speaks the same values the ingress CreditLadder and the wire credit
# frame serialize (imported from the enum's home module to keep this
# import cycle-free; ra_tpu_torch.wire re-exports it)
from ..ingress.backpressure import OK, REJECT, SLOW, STATUS_NAMES

_mailbox_ids = itertools.count()


class Mailbox:
    """An addressable message sink standing in for an Erlang pid.

    Identity is the *name*, not the object: machine state keys enqueuers
    and consumers by pid, and pids cross pickle boundaries (WAL replay,
    snapshot install, TCP relays).  Identity-based hashing would make
    every unpickled copy a distinct enqueuer and silently break seqno
    dedup after recovery."""

    def __init__(self, name: str = "", node: str = "") -> None:
        self.name = name or f"mbox-{next(_mailbox_ids)}"
        #: node tag used by the machine's nodeup/noconnection handling
        self.node = node
        self.queue: deque = deque()

    def __call__(self, msg: Any) -> None:
        self.queue.append(msg)

    def drain(self) -> list:
        out = []
        while self.queue:
            out.append(self.queue.popleft())
        return out

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Mailbox) and other.name == self.name

    def __hash__(self) -> int:
        return hash(("Mailbox", self.name))

    def __repr__(self) -> str:
        return f"<Mailbox {self.name}>"


class StopSending(RuntimeError):
    """enqueue() refused: unapplied commands reached max_pending (the
    reference's `{error, stop_sending}`, ra_fifo_client.erl:106-110) —
    drain with flush()/poll_applied() before sending more.

    On the unified verdict surface this IS the ``reject``
    tier: :attr:`VERDICT` carries the shared enum value the wire
    plane's credit frames serialize for the same condition."""

    #: the shared-admission-enum value this exception represents —
    #: one verdict enum for FifoClient, the ingress ladder and the
    #: wire credit frame
    VERDICT: int = REJECT


class FifoClient:
    """Enqueue/checkout session against one fifo cluster."""

    #: in-flight window where enqueue() starts answering "slow"
    #: (?SOFT_LIMIT, ra_fifo_client.erl:21)
    SOFT_LIMIT = 256

    def __init__(self, servers: list, router=None, tag: str = "c1",
                 node: str = "", soft_limit: int = SOFT_LIMIT,
                 max_pending: int = 0) -> None:
        assert servers, "need at least one member"
        self.servers = list(servers)
        self.router = router
        self.tag = tag
        self.soft_limit = soft_limit
        # hard ceiling defaults to 4x the soft signal so the graduated
        # ok -> slow -> StopSending protocol cannot invert
        self.max_pending = max_pending or 4 * soft_limit
        assert self.soft_limit <= self.max_pending
        # globally unique pid name: two clients sharing a tag must not
        # alias each other's enqueuer/consumer identity
        self.mailbox = Mailbox(name=f"{tag}.{next(_mailbox_ids)}", node=node)
        self.next_seqno = 1
        #: seqno -> raw msg, unacknowledged pipelined enqueues
        self.pending: dict[int, Any] = {}
        #: monotonic ts of the FIRST refused enqueue of the current
        #: StopSending episode (None when the window is open) — the
        #: client-side shed-decision input the ingress ladder
        #: generalizes: how LONG a session has
        #: been blocked, not just that it is
        self.blocked_since: Optional[float] = None
        #: enqueues refused by the hard window across the client's
        #: lifetime (the StopSending analogue of INGRESS_FIELDS
        #: ``rejected``)
        self.ingress_rejections = 0
        self._applied = Mailbox(name=f"{tag}-applied")
        self.deliveries: list = []       # [(msg_id, header, raw)]
        self._seed = servers[0]

    # -- enqueue ------------------------------------------------------------

    def enqueue(self, msg: Any) -> tuple:
        """Pipeline an enqueue; returns ``(status, seqno)`` where status
        is "ok", or "slow" once the unapplied window passes soft_limit
        (keep sending, but ease off — the reference's `{slow, State}`
        backpressure signal).  Raises :class:`StopSending` at
        max_pending.  Delivery/apply is asynchronous — track with
        :meth:`pending_count` / :meth:`flush`."""
        self.poll_applied()                  # status must see fresh acks
        if len(self.pending) >= self.max_pending:
            # observable shed input: stamp when THIS blocked episode
            # began (first refusal only) and count every refusal, so a
            # caller deciding to shed/defer can read "blocked for 2s,
            # 40 refusals" instead of a bare exception
            if self.blocked_since is None:
                self.blocked_since = time.monotonic()
            self.ingress_rejections += 1
            raise StopSending(f"{len(self.pending)} enqueues unapplied")
        self.blocked_since = None            # window open again
        seqno = self.next_seqno
        self.next_seqno += 1
        self.pending[seqno] = msg
        self._pipeline(seqno, msg)
        # status strings derive from the ONE shared verdict enum
        # (ra_tpu_torch.wire.framing / ingress.backpressure): "ok"/"slow"
        # exactly as before, now spelled by the wire plane's names
        status = STATUS_NAMES[SLOW] \
            if len(self.pending) >= self.soft_limit else STATUS_NAMES[OK]
        return status, seqno

    def current_verdict(self) -> int:
        """The session's admission verdict on the shared enum: OK
        below soft_limit, SLOW past it, REJECT (= StopSending) at
        max_pending — what a credit frame would say about this
        session right now."""
        self.poll_applied()
        n = len(self.pending)
        if n >= self.max_pending:
            return REJECT
        return SLOW if n >= self.soft_limit else OK

    def credit_frame(self) -> bytes:
        """Serialize the session's current verdict with the wire
        plane's ONE credit-frame encoder:
        a FifoClient backpressure episode and a wire credit frame are
        the same protocol, byte for byte."""
        from ..wire.framing import encode_credit
        return encode_credit(0, [0], [max(0, self.next_seqno - 1)],
                             [self.current_verdict()])

    def _trace_ctx(self, seqno: int) -> str:
        """Deterministic ingress trace id for one enqueue:
        session tag + seqno, STABLE across resends — a post-leader-
        change resend of the same seqno records under the same id, so
        the duplicate committed entry the machine dedups is visible in
        the command's timeline rather than a mystery second lifecycle."""
        return f"{self.mailbox.name}/{seqno}"

    def _pipeline(self, seqno: int, msg: Any) -> None:
        target = self._leader_hint()
        try:
            api.pipeline_command(
                target, ("enqueue", self.mailbox, seqno, msg),
                correlation=seqno, notify_to=self._applied,
                priority=Priority.LOW, router=self.router,
                trace_ctx=self._trace_ctx(seqno))
        except RuntimeError:
            pass  # node down: stays pending, resend() recovers

    def enqueue_sync(self, msg: Any, timeout: float = 5.0) -> None:
        """Enqueue with consensus await (for tests needing certainty).
        The seqno stays in pending until the call succeeds so a timeout
        never leaves a permanent sequence gap — resend()/flush() retry it
        with the machine's dedup absorbing any duplicate."""
        seqno = self.next_seqno
        self.next_seqno += 1
        self.pending[seqno] = msg
        api.process_command(self._leader_hint(),
                            ("enqueue", self.mailbox, seqno, msg),
                            router=self.router, timeout=timeout,
                            trace_ctx=self._trace_ctx(seqno))
        self.pending.pop(seqno, None)

    def poll_applied(self) -> None:
        """Fold applied-notifications into the pending set."""
        for batch in self._applied.drain():
            for (corr, _reply) in batch:
                self.pending.pop(corr, None)

    def pending_count(self) -> int:
        self.poll_applied()
        return len(self.pending)

    def resend(self) -> None:
        """Re-pipeline all unacknowledged enqueues in seqno order — the
        post-leader-change recovery step (ra_fifo_client resends)."""
        self.poll_applied()
        for seqno in sorted(self.pending):
            self._pipeline(seqno, self.pending[seqno])

    def flush(self, timeout: float = 10.0) -> None:
        """Block until every pipelined enqueue has been applied.  Resends
        only when no acks have landed for a while (the reference client
        resends on leader change, not on a poll timer) — resending every
        poll would flood the log with duplicate committed entries."""
        deadline = time.monotonic() + timeout
        last_progress = time.monotonic()
        last_count = self.pending_count()
        while time.monotonic() < deadline:
            n = self.pending_count()
            if n == 0:
                return
            now = time.monotonic()
            if n < last_count:
                last_count, last_progress = n, now
            elif now - last_progress > 0.5:
                self.resend()
                last_progress = now
            time.sleep(0.02)
        raise TimeoutError(
            f"fifo client: {len(self.pending)} enqueues unapplied")

    # -- consume ------------------------------------------------------------

    @property
    def consumer_id(self) -> tuple:
        return (self.tag, self.mailbox)

    def checkout(self, lifetime: str = "auto", credit: int = 10,
                 timeout: float = 5.0) -> Any:
        return api.process_command(
            self._leader_hint(), ("checkout", (lifetime, credit),
                                  self.consumer_id),
            router=self.router, timeout=timeout)

    def cancel_checkout(self, timeout: float = 5.0) -> Any:
        return api.process_command(
            self._leader_hint(), ("checkout", "cancel", self.consumer_id),
            router=self.router, timeout=timeout)

    def dequeue(self, settled: bool = True, timeout: float = 5.0) -> Any:
        res = api.process_command(
            self._leader_hint(),
            ("checkout", ("dequeue", "settled" if settled else "unsettled"),
             self.consumer_id),
            router=self.router, timeout=timeout)
        return res.reply if hasattr(res, "reply") else res

    def settle(self, msg_ids, timeout: float = 5.0) -> Any:
        return api.process_command(
            self._leader_hint(), ("settle", tuple(msg_ids),
                                  self.consumer_id),
            router=self.router, timeout=timeout)

    def return_(self, msg_ids, timeout: float = 5.0) -> Any:
        return api.process_command(
            self._leader_hint(), ("return", tuple(msg_ids),
                                  self.consumer_id),
            router=self.router, timeout=timeout)

    def discard(self, msg_ids, timeout: float = 5.0) -> Any:
        return api.process_command(
            self._leader_hint(), ("discard", tuple(msg_ids),
                                  self.consumer_id),
            router=self.router, timeout=timeout)

    def poll_deliveries(self) -> list:
        """Drain the mailbox; returns newly delivered (msg_id, header, raw)
        and accumulates them in :attr:`deliveries`."""
        new = []
        for msg in self.mailbox.drain():
            if isinstance(msg, tuple) and msg and msg[0] == "delivery":
                _, _tag, batch = msg
                new.extend(batch)
        self.deliveries.extend(new)
        return new

    # -- leader tracking ----------------------------------------------------

    def _leader_hint(self) -> ServerId:
        """Best local guess at the leader: ask any reachable member for its
        leader_id; fall back to the member itself (process_command's
        redirect loop finishes the job; pipeline_command needs the guess
        to be right to avoid follower drops)."""
        from ..node import DEFAULT_ROUTER
        router = self.router or DEFAULT_ROUTER
        for sid in self.servers:
            node = router.nodes.get(sid.node)
            if node is None:
                continue
            shell = node.shells.get(sid.name)
            if shell is None:
                continue
            leader = shell.server.leader_id
            if leader is not None and leader.node in router.nodes:
                self._seed = leader
                return leader
            return sid
        return self._seed
