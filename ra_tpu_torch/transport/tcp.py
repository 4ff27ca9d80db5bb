"""TCP transport + node failure detection — the cross-host fabric (the
port's own copy of ``ra_tpu/transport/tcp.py``).

Replicates the semantics the reference gets from Erlang distribution +
aten (SURVEY.md §2.4 'Distributed communication backend'):

* sends are NEVER blocking: each peer has a bounded outbound queue and a
  sender thread; a full queue or broken/unreachable connection drops the
  message and counts it (the [noconnect, nosuspend] cast semantics of
  ra_server_proc.erl:1317-1341 — Raft's pipeline catch-up recovers)
* per-peer connection status (normal | disconnected) feeds drop decisions
  and metrics (ra.hrl:329-330 drop counters)
* a lightweight heartbeat failure detector stands in for aten: every
  connected peer is pinged on an interval; silence beyond SUSPECT_AFTER
  marks the node "suspect" (internal pre-down state the reliable RPC
  layer uses to invalidate cached connections before retrying), silence
  beyond DOWN_AFTER emits NodeEvent(node, "down") to every local server
  shell and closes the cached connection, recovery emits
  NodeEvent(node, "up") (aten's poll-interval role,
  ra_server_proc.erl:790-810, 1690-1700)
* node-LIFECYCLE calls ride the reliable RPC frames (FRAME_RPC_REQ/
  FRAME_RPC_RESP, transport/rpc.py): retried by the sender under one
  request id, deduplicated by the receiver — control-plane traffic must
  survive a peer restart that Raft data traffic merely drops through
* an optional seeded FaultPlan (transport/rpc.py) is consulted on the
  send and recv paths: deterministic drop/delay/duplicate/reorder/
  partition per (peer, frame-class) stream for in-process chaos tests
* frames are length-prefixed pickles between cluster hosts — the same
  mutual-trust model as Erlang distribution inside a cluster; do not
  expose the port beyond it.  Every frame loads through
  :func:`ra_tpu_torch.convert.loads`, so a frame that a reference
  process encoded (naming ``ra_tpu`` classes) decodes to the port's
  equal message

TcpRouter extends the in-process LocalRouter: ServerIds whose node is
hosted locally are delivered directly; remote nodes resolve through the
address book.
"""
from __future__ import annotations

import logging
import pickle
import queue
import socket
import struct
import threading
import time
import uuid
from collections import OrderedDict
from dataclasses import replace as _dc_replace
from typing import Optional

from ..blackbox import record
from ..core.types import (
    AppendEntriesRpc,
    CommandEvent,
    CommandsEvent,
    Entry,
    NODE_SCOPE,
    NodeControlEvent,
    NodeEvent,
    ReplyMode,
    ServerId,
    UserCommand,
    strip_msg_handles,
)
from ..codec import decode_command, decode_user_parts, encode_user
from ..convert import loads as _wire_loads
from ..metrics import RPC_FIELDS
from ..node import LocalRouter
from .rpc import RpcReceiver, stamp_origin

logger = logging.getLogger("ra_tpu_torch.transport")

_LEN = struct.Struct("<I")
FRAME_MSG = 0
FRAME_PING = 1
FRAME_HELLO = 2
FRAME_REPLY = 3
FRAME_NOTIFY = 4
FRAME_RPC_REQ = 5
FRAME_RPC_RESP = 6
#: batch-encoded data frame: ONE pickle + ONE length prefix
#: for every plain routed message the sender loop coalesced — the
#: per-item _encode_item path paid a pickle and a frame header per
#: message, which at batched-AER rates dominated the sender thread
FRAME_MSG_BATCH = 7

#: fault kinds the recv/ping paths can honor (they cannot delay,
#: duplicate or reorder — see FaultPlan.decide's honor contract)
_DROP_ONLY = frozenset({"drop"})

#: frame kind -> FaultPlan frame class (rpc.FaultPlan keys decisions by
#: (peer, frame-class, direction) so chaos schedules can target the
#: control plane, the data plane, or the detector independently)
_FRAME_CLASS = {FRAME_MSG: "msg", FRAME_PING: "ping",
                FRAME_HELLO: "hello", FRAME_REPLY: "reply",
                FRAME_NOTIFY: "notify", FRAME_RPC_REQ: "rpc_req",
                FRAME_RPC_RESP: "rpc_resp", FRAME_MSG_BATCH: "msg"}

SEND_QUEUE_MAX = 10_000
MAX_FRAME = 64 * 1024 * 1024  # snapshot chunks are 1MB; generous headroom
PING_INTERVAL = 0.5
SUSPECT_AFTER = 1.0       # silence before the RPC layer distrusts the conn
DOWN_AFTER = 2.0          # silence threshold (aten default poll is 1s)
CONNECT_TIMEOUT = 1.0
RECONNECT_BACKOFF = 0.5


class _FaultHeld:
    """Wrapper marking a queue item the FaultPlan already processed
    (delayed frames re-enter the send queue exempt from a second
    decision, or they would be re-delayed/dropped forever)."""

    __slots__ = ("item",)

    def __init__(self, item) -> None:
        self.item = item


class _Peer:
    __slots__ = ("name", "addr", "queue", "sock", "thread", "status",
                 "last_attempt", "lock", "send_lock")

    def __init__(self, name: str, addr: tuple) -> None:
        self.name = name
        self.addr = addr
        self.queue: "queue.Queue" = queue.Queue(maxsize=SEND_QUEUE_MAX)
        self.sock: Optional[socket.socket] = None
        self.thread: Optional[threading.Thread] = None
        self.status = "disconnected"
        self.last_attempt = 0.0
        self.lock = threading.Lock()
        # serializes sendall between the sender and detector threads: an
        # interleaved ping inside a partially-sent frame corrupts the stream
        self.send_lock = threading.Lock()


class TcpRouter(LocalRouter):
    """LocalRouter + TCP reach to remote nodes."""

    def __init__(self, listen_addr: tuple, address_book: dict) -> None:
        super().__init__()
        self.listen_addr = listen_addr
        self.address_book = dict(address_book)  # node name -> (host, port)
        self.peers: dict[str, _Peer] = {}
        self.dropped_sends = 0
        self.last_heard: dict[str, float] = {}
        self.node_status: dict[str, str] = {}
        #: detector windows — instance-configurable: the
        #: module constants stay the defaults; ``detector_hysteresis``
        #: is the minimum CONTINUOUS suspect time before a down
        #: verdict, so a latency spike (slow fsync, injected delay)
        #: that clears within the window never escalates.  0.0
        #: preserves the historical silence-only behavior.
        self.suspect_after = SUSPECT_AFTER
        self.down_after = DOWN_AFTER
        self.detector_hysteresis = 0.0
        #: node -> monotonic time it ENTERED suspect (hysteresis clock)
        self._suspect_since: dict[str, float] = {}
        #: nemesis hook: nodes whose traffic is blocked at the socket
        #: level (the inet_tcp_proxy role the reference's
        #: partitions_SUITE uses, partitions_SUITE.erl:29-57) — sends
        #: drop+count, inbound frames are ignored, the failure detector
        #: sees silence and rules the node down
        self.blocked_nodes: set = set()
        self._stop = False
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(listen_addr)
        self._server.listen(64)
        self.listen_addr = self._server.getsockname()
        # outstanding cross-host client calls: call id -> Future
        self._calls: dict = {}
        self._call_seq = 0
        self._call_lock = threading.Lock()
        # remote pipeline fan-in: per-target buffers of
        # pipelined commands flushed as {commands, Batch} events — the
        # cross-host twin of RaNode's low-priority flush, so a wire
        # client's casts ride multi-command frames instead of one
        # CommandEvent frame per command
        self._pipe_bufs: dict = {}
        self._pipe_lock = threading.Lock()
        self._pipe_evt = threading.Event()
        self._pipe_thread: Optional[threading.Thread] = None
        # durable applied-notification sinks for pipelined commands that
        # cross hosts: nid -> callable, id(callable) -> nid.  Unlike
        # _calls these are multi-shot (one client receives many Notify
        # batches), so they persist; an LRU cap bounds them when callers
        # pass a fresh callable per command instead of reusing a sink
        self._notify_handles: OrderedDict = OrderedDict()
        self._notify_ids: dict = {}
        self._notify_seq = 0
        # distinguishes this router in rnotify handles: bind-address
        # equality is unreliable under wildcard binds (0.0.0.0 on every
        # host would alias all routers)
        self._router_id = uuid.uuid4().hex[:12]
        # lazily-created peers keyed by raw address (reply routing)
        self._addr_peers: dict[tuple, _Peer] = {}
        # reliable control-plane RPC (transport/rpc.py): pending sender
        # futures by request id, shared counters, receiver-side dedup
        self._rpc_pending: dict = {}
        self.rpc_counters: dict = {f: 0 for f in RPC_FIELDS}
        self._rpc_receiver = RpcReceiver(self._rpc_execute,
                                         counters=self.rpc_counters)
        #: optional seeded FaultPlan consulted at send/recv (rpc.py)
        self.fault_plan = None
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True,
                                               name="ra-tcp-accept")
        self._accept_thread.start()
        self._detector_thread = threading.Thread(target=self._detector_loop,
                                                 daemon=True,
                                                 name="ra-failure-detector")
        self._detector_thread.start()

    # ------------------------------------------------------------------
    # send path
    # ------------------------------------------------------------------

    def block_node(self, node: str) -> None:
        """Partition this host from ``node``: drop the live connection,
        purge already-queued frames, and refuse traffic both ways until
        :meth:`unblock_node`."""
        self.blocked_nodes.add(node)
        victims = [self.peers.get(node)]
        addr = self.address_book.get(node)
        if addr is not None:  # reply/notify links to the same host too
            victims.append(self._addr_peers.get(tuple(addr)))
        for peer in victims:
            if peer is None:
                continue
            self._close_peer(peer)
            while True:  # frames queued pre-partition must not flush out
                try:
                    peer.queue.get_nowait()
                    self.dropped_sends += 1
                except queue.Empty:
                    break

    def unblock_node(self, node: str) -> None:
        self.blocked_nodes.discard(node)

    def send(self, src_node: str, to: ServerId, msg) -> bool:
        if to.node in self.blocked_nodes:
            self.dropped_sends += 1
            return False
        if to.node in self.nodes or (src_node, to.node) in self.blocked:
            return super().send(src_node, to, msg)
        peer = self._peer_for(to.node)
        if peer is None:
            self.dropped_sends += 1
            return False
        try:
            peer.queue.put_nowait((to, self._rewrite_for_wire(msg),
                                   src_node))
        except queue.Full:
            # nosuspend: never block the Raft loop on a slow connection
            self.dropped_sends += 1
            return False
        self._ensure_sender(peer)
        return True

    def _rewrite_for_wire(self, msg):
        """Relayed command events carry local ack sinks (notify_to
        callables); swap them for ('rnotify', addr, id) handles so
        applied-notifications route back across hosts instead of landing
        on an orphan unpickled copy.  CommandsEvent batches are left to
        the SENDER thread's compact wire form, which does
        the same handle swap per batch instead of one dataclass-replace
        per command here on the caller's thread."""
        if isinstance(msg, CommandsEvent):
            return msg
        if isinstance(msg, CommandEvent):
            return _dc_replace(msg, command=self._rewrite_cmd(msg.command))
        return msg

    def _rewrite_cmd(self, cmd):
        nt = getattr(cmd, "notify_to", None)
        if nt is not None and callable(nt):
            handle = ("rnotify", tuple(self.listen_addr), self._router_id,
                      self._notify_id(nt))
            return _dc_replace(cmd, notify_to=handle)
        return cmd

    NOTIFY_SINK_MAX = 4096

    def _notify_id(self, fn) -> int:
        with self._call_lock:
            nid = self._notify_ids.get(id(fn))
            if nid is None:
                self._notify_seq += 1
                nid = self._notify_seq
                self._notify_ids[id(fn)] = nid
                self._notify_handles[nid] = fn
                while len(self._notify_handles) > self.NOTIFY_SINK_MAX:
                    old_nid, old_fn = self._notify_handles.popitem(last=False)
                    self._notify_ids.pop(id(old_fn), None)
            else:
                self._notify_handles.move_to_end(nid)
            return nid

    def _peer_for(self, node: str) -> Optional[_Peer]:
        peer = self.peers.get(node)
        if peer is None:
            addr = self.address_book.get(node)
            if addr is None:
                return None
            peer = self.peers.setdefault(node, _Peer(node, tuple(addr)))
        return peer

    def _ensure_sender(self, peer: _Peer) -> None:
        with peer.lock:
            if peer.thread is None or not peer.thread.is_alive():
                peer.thread = threading.Thread(
                    target=self._sender_loop, args=(peer,), daemon=True,
                    name=f"ra-tcp-send-{peer.name}")
                peer.thread.start()

    #: frames coalesced into one sendall by the sender loop — the
    #: gen_batch_server shape on the wire: whatever accumulated while
    #: the previous syscall ran goes out as one write; plain routed
    #: messages additionally share ONE batch frame + ONE pickle
    #: (FRAME_MSG_BATCH), so deeper coalescing amortizes
    #: encode setup as well as the syscall
    SEND_COALESCE = 256

    def _sender_loop(self, peer: _Peer) -> None:
        while not self._stop:
            try:
                item = peer.queue.get(timeout=1.0)
            except queue.Empty:
                continue
            items = [item]
            while len(items) < self.SEND_COALESCE:
                try:
                    items.append(peer.queue.get_nowait())
                except queue.Empty:
                    break
            plan = self.fault_plan
            if plan is not None:
                # fault filtering happens HERE, before the socket, so a
                # later socket failure counts only the frames actually
                # attempted: fault drops count once (inside the filter)
                # and delayed frames (a Timer re-queues them) never
                # count as connection losses.  Plan-level partition
                # also suppresses the redial handshake: a partitioned
                # peer must go silent for the detector.
                if plan.is_partitioned(self._fault_peer_name(peer)):
                    self.dropped_sends += len(items)
                    continue
                items = self._apply_send_faults(plan, peer, items)
                if not items:
                    continue
            if not self._send_items(peer, items):
                # drop the batch (and drain cheaply while down: pipeline
                # catch-up will resend what matters)
                self.dropped_sends += len(items)

    def _wire_form(self, to, msg, src):
        """Routed-message wire image, built on the SENDER thread.  Two
        compact forms:

        * an AppendEntries batch carrying its encoded durable payloads
          ships as index base + per-entry terms + payload bytes instead
          of pickled command objects — pickling bytes is a memcpy while
          pickling a dataclass per entry dominated the sender loop, and
          the payload IS the handle-stripped durable image so no strip
          pass is needed;
        * a CommandsEvent of plain pipelined notify-mode commands ships
          as per-command codec payload images (``__cmds2__``)
          — the SAME bytes the leader will append, the WAL will write,
          and segments will store, so this one encode is the only
          object-encode the command ever sees.  The notify-handle swap
          (_notify_id) happens first, memoized per batch, so the remote
          handle is baked into the image.  A CommandsEvent that already
          CARRIES images (a follower relaying a wire batch to the
          leader) re-ships them byte-for-byte — relay is a memcpy.

        The receiver thread rebuilds the objects (decode off BOTH
        nodes' event-loop threads)."""
        tm = type(msg)
        if tm is AppendEntriesRpc and msg.payloads is not None \
                and msg.entries:
            ents = msg.entries
            return (to, src, ("__aer__", msg.term, msg.leader_id,
                              msg.prev_log_index, msg.prev_log_term,
                              msg.leader_commit, ents[0].index,
                              tuple(e.term for e in ents),
                              msg.payloads))
        if tm is CommandsEvent:
            cmds = msg.commands
            images = msg.images
            if images is not None and len(images) == len(cmds):
                traces = tuple(c.trace for c in cmds) \
                    if any(c.trace is not None for c in cmds) else None
                return (to, src, ("__cmds2__", images, traces))
            handles: dict = {}  # per-batch memo: id(fn) -> handle
            rows = []
            any_trace = False
            for c in cmds:
                if type(c) is not UserCommand or \
                        c.reply_mode is not ReplyMode.NOTIFY or \
                        c.from_ is not None or c.reply_from is not None:
                    rows = None
                    break
                nt = c.notify_to
                if nt is not None and callable(nt):
                    h = handles.get(id(nt))
                    if h is None:
                        h = handles[id(nt)] = (
                            "rnotify", tuple(self.listen_addr),
                            self._router_id, self._notify_id(nt))
                    nt = h
                img = encode_user(c.data, ReplyMode.NOTIFY,
                                  c.correlation, nt, None, None)
                if img is None:  # shape outside the fixed layout
                    rows = None
                    break
                rows.append(img)
                if c.trace is not None:
                    any_trace = True
            if rows is not None:
                traces = tuple(c.trace for c in cmds) if any_trace \
                    else None
                return (to, src, ("__cmds2__", tuple(rows), traces))
            # mixed batch (rare): the legacy per-command rewrite + strip
            msg = CommandsEvent(tuple(self._rewrite_cmd(c)
                                      for c in cmds))
            return (to, src, msg)
        return (to, src, strip_msg_handles(msg))

    @staticmethod
    def _from_wire(msg):
        """Inverse of _wire_form, run on the receiver thread."""
        if type(msg) is tuple and msg:
            tag = msg[0]
            if tag == "__aer__":
                (_tag, term, leader_id, pli, plt, commit, first, terms,
                 payloads) = msg
                entries = tuple(
                    Entry(first + i, terms[i],
                          decode_command(payloads[i]))
                    for i in range(len(payloads)))
                return AppendEntriesRpc(
                    term=term, leader_id=leader_id, prev_log_index=pli,
                    prev_log_term=plt, leader_commit=commit,
                    entries=entries, payloads=payloads)
            if tag == "__cmds2__":
                _tag, images, traces = msg
                if traces is None:
                    cmds = tuple(decode_command(img) for img in images)
                else:
                    cmds = tuple(
                        UserCommand(*decode_user_parts(img), trace=tr)
                        for img, tr in zip(images, traces))
                # keep the shipped images: the leader appends these
                # exact bytes (no re-encode), a relaying follower
                # re-ships them
                return CommandsEvent(cmds, images)
            if tag == "__cmds__":
                # pre-codec compact form — decode-only compatibility
                return CommandsEvent(tuple(
                    UserCommand(data, reply_mode=ReplyMode.NOTIFY,
                                correlation=corr, notify_to=nt,
                                trace=tr)
                    for data, corr, nt, tr in msg[1]))
        return msg

    def _encode_item(self, item) -> Optional[bytes]:
        if isinstance(item, _FaultHeld):  # plan cleared mid-delay
            item = item.item
        to, msg, src = (item if len(item) == 3 else (*item, None))
        try:
            if to == "__reply__":
                frame = bytes([FRAME_REPLY]) + pickle.dumps(  # ra10-ok: control-plane single (reply), rare by design
                    msg, protocol=pickle.HIGHEST_PROTOCOL)
            elif to == "__notify__":
                frame = bytes([FRAME_NOTIFY]) + pickle.dumps(  # ra10-ok: control-plane single (notify), rare by design
                    msg, protocol=pickle.HIGHEST_PROTOCOL)
            elif to == "__rpc_req__":
                frame = bytes([FRAME_RPC_REQ]) + pickle.dumps(  # ra10-ok: control-plane single (rpc req), rare by design
                    msg, protocol=pickle.HIGHEST_PROTOCOL)
            elif to == "__rpc_resp__":
                frame = bytes([FRAME_RPC_RESP]) + pickle.dumps(  # ra10-ok: control-plane single (rpc resp), rare by design
                    msg, protocol=pickle.HIGHEST_PROTOCOL)
            else:
                payload = pickle.dumps(self._wire_form(to, msg, src),  # ra10-ok: ONE frame envelope; command payloads inside are codec images (bytes)
                                       protocol=pickle.HIGHEST_PROTOCOL)
                frame = bytes([FRAME_MSG]) + payload
        except (pickle.PicklingError, TypeError, AttributeError):
            # per-message failure: drop it, the connection is healthy
            return None
        return _LEN.pack(len(frame)) + frame

    def _encode_msg_batch(self, items: list) -> Optional[bytes]:
        """ONE frame for a run of plain routed messages: the batch is
        pickled in a single dumps call with a shared length prefix, so
        the pickle setup and the per-frame header amortize across
        everything the sender loop coalesced (rule RA10).
        Falls back to per-item encoding when any message in the batch
        refuses to pickle (the per-item path then drops just that
        message)."""
        try:
            triples = [self._wire_form(to, msg, src)
                       for to, msg, src in items]
            frame = bytes([FRAME_MSG_BATCH]) + pickle.dumps(  # ra10-ok: ONE envelope per coalesced batch; commands inside are codec images
                triples, protocol=pickle.HIGHEST_PROTOCOL)
        except (pickle.PicklingError, TypeError, AttributeError):
            return None
        return _LEN.pack(len(frame)) + frame

    def _send_items(self, peer: _Peer, items: list) -> bool:
        if peer.name in self.blocked_nodes or \
                self._addr_blocked(tuple(peer.addr)):
            return False  # partitioned: no redial, no flush
        sock = self._peer_sock(peer)
        if sock is None:
            return False
        buf = bytearray()
        # routed messages batch into one frame; control-plane singles
        # (reply/notify/rpc frames — rare) keep their per-item frames
        plain: list = []
        for item in items:  # per-ITEM partition of control-plane singles (the encodes inside carry the ra10 tags); data frames batch below
            if isinstance(item, _FaultHeld):  # plan cleared mid-delay
                item = item.item
            if isinstance(item[0], str) and item[0].startswith("__"):
                encoded = self._encode_item(item)  # ra10-ok: control-plane singles (reply/notify/rpc) are rare
                if encoded is not None:
                    buf += encoded
            else:
                plain.append(item if len(item) == 3 else (*item, None))
        if len(plain) == 1:
            encoded = self._encode_item(plain[0])
            if encoded is not None:
                buf += encoded
        elif plain:
            encoded = self._encode_msg_batch(plain)
            if encoded is None:
                for item in plain:
                    encoded = self._encode_item(item)  # ra10-ok: fallback after a batch pickling failure
                    if encoded is not None:
                        buf += encoded
            else:
                buf += encoded
        if not buf:
            return True  # every item unpicklable: dropped individually
        try:
            with peer.send_lock:
                sock.sendall(bytes(buf))
            return True
        except OSError:
            self._close_peer(peer)
            return False

    def _peer_sock(self, peer: _Peer) -> Optional[socket.socket]:
        if peer.sock is not None:
            return peer.sock
        now = time.monotonic()
        if now - peer.last_attempt < RECONNECT_BACKOFF:
            return None
        peer.last_attempt = now
        try:
            sock = socket.create_connection(peer.addr,
                                            timeout=CONNECT_TIMEOUT)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            hello = bytes([FRAME_HELLO]) + self._my_name().encode()
            sock.sendall(_LEN.pack(len(hello)) + hello)
            peer.sock = sock
            peer.status = "normal"
            self._mark_heard(peer.name)
            return sock
        except OSError:
            peer.status = "disconnected"
            return None

    def _close_peer(self, peer: _Peer) -> None:
        if peer.sock is not None:
            try:
                peer.sock.close()
            except OSError:
                pass
            peer.sock = None
        peer.status = "disconnected"

    def _my_name(self) -> str:
        return ",".join(sorted(self.nodes)) or "?"

    # ------------------------------------------------------------------
    # cross-host client calls (the gen_statem:call-over-dist role)
    # ------------------------------------------------------------------

    def remote_call(self, target: ServerId, make_event):
        """Send a client event to a server on a remote node; returns a
        Future resolved by the FRAME_REPLY, or None when unroutable."""
        from ..node import Future
        peer = self._peer_for(target.node)
        if peer is None:
            return None
        with self._call_lock:
            self._call_seq += 1
            call_id = self._call_seq
            fut = Future()
            self._calls[call_id] = fut
        handle = ("rcall", tuple(self.listen_addr), call_id)
        event = make_event(handle)
        if not self.send("?", target, event):
            with self._call_lock:
                self._calls.pop(call_id, None)
            return None
        return fut

    def forget_call(self, fut) -> None:
        with self._call_lock:
            for cid, f in list(self._calls.items()):
                if f is fut:
                    del self._calls[cid]

    # ------------------------------------------------------------------
    # remote pipeline fan-in (api.pipeline_command's cross-host half)
    # ------------------------------------------------------------------

    #: commands per flushed {commands, Batch} frame and the straggler
    #: flush cadence — PIPELINE_FLUSH_SIZE matches the server-side
    #: command_flush_size default so one wire frame fills one leader
    #: batch append
    PIPELINE_FLUSH_SIZE = 512
    PIPELINE_FLUSH_INTERVAL_S = 0.002

    def pipeline_cast(self, target: ServerId, cmd) -> bool:
        """Buffer one fire-and-forget command toward ``target``; full
        buffers flush inline as a CommandsEvent, stragglers are flushed
        by a small cadence thread within ~PIPELINE_FLUSH_INTERVAL_S.
        Same at-most-once posture as every data-plane cast: a dropped
        frame is the client's timeout/retry problem.  The steady-state
        cast is one lock cycle + one list append: the flusher wake and
        the thread-liveness check run only on a buffer's FIRST fill.
        Full-buffer flushes send INSIDE the buffer lock — the cadence
        flusher sends under the same lock, so one caller's casts reach
        the peer queue in submission order (an inline flush racing a
        swapped-but-unsent cadence batch would otherwise overtake it);
        send() is nonblocking (put_nowait), so the hold is short."""
        with self._pipe_lock:
            buf = self._pipe_bufs.get(target)
            if buf is None:
                buf = self._pipe_bufs[target] = []
            buf.append(cmd)
            n = len(buf)
            if n >= self.PIPELINE_FLUSH_SIZE:
                del self._pipe_bufs[target]
                return self.send("?", target, CommandsEvent(tuple(buf)))
        if n == 1:
            if self._pipe_thread is None or \
                    not self._pipe_thread.is_alive():
                with self._pipe_lock:
                    if self._pipe_thread is None or \
                            not self._pipe_thread.is_alive():
                        self._pipe_thread = threading.Thread(
                            target=self._pipe_flusher, daemon=True,
                            name="ra-tcp-pipe-flush")
                        self._pipe_thread.start()
            self._pipe_evt.set()
        return True

    def pipeline_cast_many(self, target: ServerId, cmds) -> bool:
        """Burst twin of pipeline_cast: one lock cycle and one extend for
        the whole batch (api.pipeline_commands' cross-host half).  A
        burst may overfill the buffer past PIPELINE_FLUSH_SIZE; it
        flushes as one oversized CommandsEvent rather than splitting —
        the leader's batcher re-chunks on its side."""
        with self._pipe_lock:
            buf = self._pipe_bufs.get(target)
            if buf is None:
                buf = self._pipe_bufs[target] = []
            n0 = len(buf)
            buf.extend(cmds)
            if len(buf) >= self.PIPELINE_FLUSH_SIZE:
                del self._pipe_bufs[target]
                return self.send("?", target, CommandsEvent(tuple(buf)))
        if n0 == 0:
            if self._pipe_thread is None or \
                    not self._pipe_thread.is_alive():
                with self._pipe_lock:
                    if self._pipe_thread is None or \
                            not self._pipe_thread.is_alive():
                        self._pipe_thread = threading.Thread(
                            target=self._pipe_flusher, daemon=True,
                            name="ra-tcp-pipe-flush")
                        self._pipe_thread.start()
            self._pipe_evt.set()
        return True

    def _pipe_flusher(self) -> None:
        while not self._stop:
            time.sleep(self.PIPELINE_FLUSH_INTERVAL_S)
            with self._pipe_lock:
                # swap AND send under the buffer lock: see pipeline_cast
                # — an inline full-buffer flush must not overtake a
                # swapped-but-unsent cadence batch
                bufs, self._pipe_bufs = self._pipe_bufs, {}
                for target, buf in bufs.items():
                    if buf:
                        self.send("?", target, CommandsEvent(tuple(buf)))
            if not bufs:
                # idle: park until the next cast instead of spinning
                self._pipe_evt.wait(0.25)
                self._pipe_evt.clear()

    # ------------------------------------------------------------------
    # reliable control-plane RPC (transport/rpc.py rides these)
    # ------------------------------------------------------------------

    def set_fault_plan(self, plan) -> None:
        """Install (or clear, with None) a seeded FaultPlan; consulted
        on every send/recv until replaced."""
        self.fault_plan = plan

    def rpc_routable(self, node: str) -> bool:
        return node in self.nodes or node in self.address_book

    def rpc_note(self, field: str, n: int = 1) -> None:
        self.rpc_counters[field] = self.rpc_counters.get(field, 0) + n

    def rpc_register(self, rid: str):
        """Arm (or re-arm, across retryable responses) the future a
        response to ``rid`` resolves."""
        from ..node import Future
        fut = Future()
        with self._call_lock:
            self._rpc_pending[rid] = fut
        return fut

    def rpc_forget(self, rid: str) -> None:
        with self._call_lock:
            self._rpc_pending.pop(rid, None)

    def rpc_send(self, node: str, req) -> bool:
        """Queue one request attempt toward ``node``; loopback requests
        (the target node hosted HERE) go straight through the receiver
        so local calls share the same at-most-once path."""
        req = stamp_origin(req, self.listen_addr, self._router_id)
        if node in self.nodes:
            self._rpc_receiver.handle(
                req, lambda resp, _r=req: self._rpc_respond(_r, resp))
            return True
        if node in self.blocked_nodes:
            self.dropped_sends += 1
            return False
        peer = self._peer_for(node)
        if peer is None:
            return False
        try:
            peer.queue.put_nowait(("__rpc_req__", req))
        except queue.Full:
            self.dropped_sends += 1
            return False
        self._ensure_sender(peer)
        return True

    def rpc_peer_state(self, node: str) -> str:
        """Classification input for the reliable RPC layer's deadline
        verdict: the detector's status when it has one, else whether a
        connection was EVER established — a peer refusing every dial is
        'never-connected' (Unreachable), not a timeout."""
        status = self.node_status.get(node)
        if status is not None:
            return status
        peer = self.peers.get(node)
        if peer is None or peer.sock is None:
            return "never-connected"
        return "up"

    def rpc_invalidate_peer(self, node: str) -> None:
        """Reconnect-aware retry: when the failure detector holds the
        peer suspect/down (or the connection already broke), drop the
        cached socket and clear the redial backoff so the next attempt
        dials fresh — a one-shot send into a half-dead socket is
        exactly the silent loss this layer exists to prevent."""
        peer = self.peers.get(node)
        if peer is None:
            return
        if self.node_status.get(node) in ("suspect", "down") or \
                peer.status == "disconnected":
            self._close_peer(peer)
            peer.last_attempt = 0.0

    def _rpc_execute(self, req, done) -> bool:
        """RpcReceiver's executor: hand the op to the local RaNode's
        control plane; False when that node is not hosted here (the
        receiver answers 'retryable' — a restarting worker may register
        it shortly)."""
        node = self.nodes.get(req.node)
        if node is None:
            return False
        return node.deliver(ServerId(NODE_SCOPE, req.node),
                            NodeControlEvent(req.op, dict(req.args),
                                             from_=done))

    def _rpc_respond(self, req, resp) -> None:
        """Route a response back to the request's origin (loopback
        resolves the local pending future directly)."""
        origin = tuple(req.origin)
        if req.origin_router == self._router_id or \
                origin == tuple(self.listen_addr):
            with self._call_lock:
                fut = self._rpc_pending.pop(resp.rid, None)
            if fut is not None:
                fut.set(resp)
            return
        self._queue_to_addr(origin, ("__rpc_resp__", resp))

    # ------------------------------------------------------------------
    # fault injection (FaultPlan hooks)
    # ------------------------------------------------------------------

    def _fault_peer_name(self, peer: _Peer) -> str:
        """Resolve reply-path peers (named addr:host:port) back to the
        node name the FaultPlan keys on, when the address book knows
        it."""
        if not peer.name.startswith("addr:"):
            return peer.name
        addr = tuple(peer.addr)
        for node, book_addr in self.address_book.items():
            if tuple(book_addr) == addr:
                return node
        return peer.name

    @staticmethod
    def _item_class(item) -> str:
        to = item[0]
        return {"__reply__": "reply", "__notify__": "notify",
                "__rpc_req__": "rpc_req",
                "__rpc_resp__": "rpc_resp"}.get(to, "msg")

    def _apply_send_faults(self, plan, peer: _Peer, items: list) -> list:
        """Filter one send batch through the plan: drops vanish (and
        count), delays re-queue exempt after a timer, duplicates send
        twice, reorders move behind the rest of the batch.  Held items
        (already-delayed) pass through untouched."""
        fault_peer = self._fault_peer_name(peer)
        out: list = []
        tail: list = []
        for item in items:
            if isinstance(item, _FaultHeld):
                out.append(item.item)
                continue
            d = plan.decide(fault_peer, self._item_class(item), "send")
            if d.action == "drop":
                self.dropped_sends += 1
                continue
            if d.delay_s > 0:
                t = threading.Timer(d.delay_s, self._requeue_held,
                                    args=(peer, item))
                t.daemon = True
                t.start()
                continue
            if d.reorder:
                tail.append(item)
                continue
            out.append(item)
            if d.duplicate:
                out.append(item)
        return out + tail

    def _requeue_held(self, peer: _Peer, item) -> None:
        try:
            peer.queue.put_nowait(_FaultHeld(item))
        except queue.Full:
            self.dropped_sends += 1
            return
        self._ensure_sender(peer)

    def _addr_blocked(self, origin: tuple) -> bool:
        """True when the node listening at ``origin`` is partitioned off
        (replies/notifies must not tunnel through a blocked link)."""
        if not self.blocked_nodes:
            return False
        for node, addr in self.address_book.items():
            if tuple(addr) == origin:
                return node in self.blocked_nodes
        return False

    def _queue_to_addr(self, origin: tuple, item: tuple) -> None:
        """Shared addr-keyed return routing for replies, notifies and
        RPC responses: lazily build the addr peer, enqueue nonblocking
        with drop accounting, honor partitions."""
        if self._addr_blocked(origin):
            self.dropped_sends += 1
            return
        peer = self._addr_peers.get(origin)
        if peer is None:
            peer = self._addr_peers.setdefault(
                origin, _Peer(f"addr:{origin[0]}:{origin[1]}", origin))
        try:
            peer.queue.put_nowait(item)
        except queue.Full:
            self.dropped_sends += 1
            return
        self._ensure_sender(peer)

    def reply_remote(self, handle: tuple, msg) -> None:
        _tag, origin, call_id = handle
        origin = tuple(origin)
        if origin == tuple(self.listen_addr):
            with self._call_lock:
                fut = self._calls.pop(call_id, None)
            if fut is not None:
                fut.set(msg)
            return
        self._queue_to_addr(origin, ("__reply__", (call_id, msg)))

    def notify_remote(self, handle: tuple, correlations) -> None:
        """Route an applied-notification batch back to the host that
        registered the sink (see _rewrite_cmd)."""
        _tag, origin, router_id, nid = handle
        origin = tuple(origin)
        if router_id == self._router_id:
            fn = self._notify_handles.get(nid)
            if fn is not None:
                fn(correlations)
            return
        self._queue_to_addr(origin, ("__notify__", (nid, correlations)))

    # ------------------------------------------------------------------
    # receive path
    # ------------------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            t = threading.Thread(target=self._recv_loop, args=(conn,),
                                 daemon=True, name="ra-tcp-recv")
            t.start()

    def _recv_loop(self, conn: socket.socket) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        remote_names: list = []  # every node co-hosted behind this conn
        try:
            while not self._stop:
                hdr = self._recv_exact(conn, _LEN.size)
                if hdr is None:
                    break
                (length,) = _LEN.unpack(hdr)
                if length == 0 or length > MAX_FRAME:
                    break  # corrupt/hostile header: drop the connection
                frame = self._recv_exact(conn, length)
                if frame is None:
                    break
                kind = frame[0]
                plan = self.fault_plan
                if kind == FRAME_HELLO:
                    remote_names = frame[1:].decode().split(",")
                    for name in remote_names:
                        if name in self.blocked_nodes:
                            continue
                        if plan is not None and \
                                name in plan.partitioned:
                            # a partitioned peer must stay silent: its
                            # redial handshake cannot reset last_heard
                            # or the down verdict would oscillate
                            continue
                        self._mark_heard(name)
                    continue
                if remote_names and \
                        all(n in self.blocked_nodes for n in remote_names):
                    continue  # partitioned: total inbound silence
                if plan is not None:
                    # recv side honors drop/partition only; delay/dup/
                    # reorder are send-side faults (one injection point
                    # per fault kind keeps schedules interpretable),
                    # and un-honorable decisions must not spend the
                    # spec's limit or counters
                    pname = plan.recv_peer(remote_names)
                    cls = _FRAME_CLASS.get(kind, "msg")
                    if plan.decide(pname, cls, "recv",
                                   honor=_DROP_ONLY).action == "drop":
                        continue
                # any delivered frame proves the connection's unblocked
                # hosts alive (hoisted: every frame kind counts)
                for name in remote_names:
                    if name not in self.blocked_nodes:
                        self._mark_heard(name)
                if kind == FRAME_MSG:
                    to, src, msg = _wire_loads(frame[1:])
                    if src in self.blocked_nodes:
                        continue  # per-source drop (co-hosted routers)
                    node = self.nodes.get(to.node)
                    if node is not None:
                        node.deliver(to, self._from_wire(msg))
                elif kind == FRAME_MSG_BATCH:
                    # one frame, many routed messages: the
                    # recv-side fault decision above covered the frame
                    # as one "msg"-class delivery, matching the one
                    # syscall it rode in on
                    for to, src, msg in _wire_loads(frame[1:]):
                        if src in self.blocked_nodes:
                            continue
                        node = self.nodes.get(to.node)
                        if node is not None:
                            node.deliver(to, self._from_wire(msg))
                elif kind == FRAME_REPLY:
                    call_id, reply = _wire_loads(frame[1:])
                    with self._call_lock:
                        fut = self._calls.pop(call_id, None)
                    if fut is not None:
                        fut.set(reply)
                elif kind == FRAME_NOTIFY:
                    nid, correlations = _wire_loads(frame[1:])
                    fn = self._notify_handles.get(nid)
                    if fn is not None:
                        fn(correlations)
                elif kind == FRAME_RPC_REQ:
                    req = _wire_loads(frame[1:])
                    self._rpc_receiver.handle(
                        req,
                        lambda resp, _r=req: self._rpc_respond(_r, resp))
                elif kind == FRAME_RPC_RESP:
                    resp = _wire_loads(frame[1:])
                    with self._call_lock:
                        fut = self._rpc_pending.pop(resp.rid, None)
                    if fut is not None:
                        fut.set(resp)
        except (OSError, pickle.UnpicklingError, EOFError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    # ------------------------------------------------------------------
    # failure detector (the aten role)
    # ------------------------------------------------------------------

    def _mark_heard(self, node: str) -> None:
        self.last_heard[node] = time.monotonic()
        self._suspect_since.pop(node, None)
        status = self.node_status.get(node)
        if status == "down":
            self.node_status[node] = "up"
            self._broadcast_node_event(node, "up")
        else:
            # also clears "suspect" silently — only the down->up edge
            # is a NodeEvent (aten emits verdicts, not hunches)
            self.node_status[node] = "up"

    def _detector_loop(self) -> None:
        while not self._stop:
            time.sleep(PING_INTERVAL)
            now = time.monotonic()
            # ping every peer we have a live connection to — including
            # addr-keyed reply links: a member-less client learns the
            # server's liveness only through them, and without pings a
            # verb slower than DOWN_AFTER would decay the caller's view
            # of a healthy, still-executing peer to down
            for peer in list(self.peers.values()) + \
                    list(self._addr_peers.values()):
                if peer.name in self.blocked_nodes:
                    continue
                sock = peer.sock
                if sock is not None:
                    plan = self.fault_plan
                    if plan is not None and plan.decide(
                            peer.name, "ping", "send",
                            honor=_DROP_ONLY).action == "drop":
                        continue  # injected ping loss
                    try:
                        frame = bytes([FRAME_PING])
                        with peer.send_lock:
                            sock.sendall(_LEN.pack(len(frame)) + frame)
                    except OSError:
                        self._close_peer(peer)
            # verdicts: up -> suspect (RPC retries stop trusting the
            # cached conn) -> down (NodeEvent broadcast + conn closed,
            # so the next send must redial rather than vanish into a
            # half-dead socket)
            for node, heard in list(self.last_heard.items()):
                if node in self.nodes:
                    continue
                status = self.node_status.get(node, "up")
                silent = now - heard
                if status != "down" and silent > self.down_after and \
                        now - self._suspect_since.get(node, now) >= \
                        self.detector_hysteresis:
                    # down needs BOTH silence beyond the window AND
                    # (when hysteresis is configured) a continuous
                    # suspect streak — a delayed-but-alive peer whose
                    # frames land inside the streak never escalates
                    self.node_status[node] = "down"
                    self._suspect_since.pop(node, None)
                    record("detector.down", peer=node,
                           age=round(silent, 4))
                    peer = self.peers.get(node)
                    if peer is not None:
                        self._close_peer(peer)
                    self._broadcast_node_event(node, "down")
                elif status == "up" and silent > self.suspect_after:
                    self.node_status[node] = "suspect"
                    self._suspect_since[node] = now
                    record("detector.suspect", peer=node,
                           age=round(silent, 4))

    def _broadcast_node_event(self, node: str, status: str) -> None:
        evt = NodeEvent(node, status)
        for ranode in list(self.nodes.values()):
            for name in list(ranode.shells):
                ranode.submit(name, evt)

    # ------------------------------------------------------------------

    def stop(self) -> None:
        self._stop = True
        try:
            self._server.close()
        except OSError:
            pass
        for peer in self.peers.values():
            self._close_peer(peer)

    def overview(self) -> dict:
        out = {
            "listen": self.listen_addr,
            "dropped_sends": self.dropped_sends,
            "peers": {p.name: p.status for p in self.peers.values()},
            "node_status": dict(self.node_status),
            "rpc": self._rpc_receiver.overview(),
        }
        if self.fault_plan is not None:
            out["faults"] = self.fault_plan.overview()
        return out
