"""The port's TCP transport (``ra_tpu_torch/transport/tcp.py``) against
the reference's.

* Frames: one seeded queue of routed messages of every wire form (an
  AppendEntries batch with its codec payloads, a pipelined command batch
  with callable notify sinks, a relayed batch carrying its images, single
  commands, votes, replies, reply/notify/RPC singles) encoded by each
  package's router (``_encode_item``, ``_encode_msg_batch``): the port
  decodes the reference's frames, through ``convert.loads`` and
  ``_from_wire``, to messages equal to its own and to the reference's
  decode.
* Faults: the same queue sent between two routers of each package over
  a real socket under one seeded ``FaultPlan`` (drop, duplicate, reorder,
  a partition, drops on the receive side): the same deliveries, in the
  same order, and the same ``dropped_sends``, plan counters and receiver
  ``rpc_counters``.
* Twins of the reference's in-process ``TcpRouter`` tests
  (``tests/test_rpc_faults.py``, ``test_blackbox.py``'s RPC trace test and
  ``test_fifo_machine.py``'s cross-host pipeline), the port alone: their
  outcome depends on timing, so each holds the reference test's
  invariants.
* Twins of ``tests/test_tcp_transport.py``: one spawned OS process a
  member (``chip_smoke.py``'s ``TcpCluster``, which imports the port
  only, on the CPU), the port alone, each against the reference test's invariants
  (no loss, no duplicate, the state equal to the fold of the acknowledged
  commands).
"""
import os
import pickle
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import ra_tpu_torch
from ra_tpu import codec as ref_codec
from ra_tpu.core import types as ref_types
from ra_tpu.transport import rpc as ref_rpc
from ra_tpu.transport import tcp as ref_tcp
from ra_tpu_torch import codec as port_codec
from ra_tpu_torch import convert
from ra_tpu_torch.core import types as port_types
from ra_tpu_torch.core.machine import SimpleMachine
from ra_tpu_torch.machines import machine_spec, register_machine
from ra_tpu_torch.node import RaNode
from ra_tpu_torch.transport import rpc as port_rpc
from ra_tpu_torch.transport import tcp as port_tcp
from ra_tpu_torch.transport.rpc import (FaultPlan, FaultSpec, RpcTimeout,
                                        Unreachable)
from ra_tpu_torch.transport.tcp import TcpRouter

from test_torch_classic_core import norm
from chip_smoke import TcpCluster

REF = SimpleNamespace(t=ref_types, codec=ref_codec, rpc=ref_rpc, tcp=ref_tcp)
PORT = SimpleNamespace(t=port_types, codec=port_codec, rpc=port_rpc,
                       tcp=port_tcp)

register_machine("torch_rpcfaults",
                 lambda: SimpleMachine(lambda c, s: s + c, 0))


@pytest.fixture(autouse=True)
def _scoped_port_plans():
    """Plans a test registers in the port's process-global registry are
    unregistered when it ends."""
    pre = list(port_rpc.live_fault_plans())
    yield
    for p in port_rpc.live_fault_plans():
        if p not in pre:
            p.unregister()


# -- frames -------------------------------------------------------------------

def notify_sink(_batch):
    """A callable applied-notification sink (swapped for a handle)."""


def wire_items(pkg, seed, n=120):
    """A seeded send queue of ``n`` items of every frame kind, in
    ``pkg``'s classes: routed ``(to, msg, src)`` triples toward node
    ``n2`` and control-plane singles ``(tag, payload)``."""
    t, rng = pkg.t, np.random.default_rng(seed)
    to, last_rid = t.ServerId("m2", "n2"), None
    items = []
    for i in range(n):
        kind = int(rng.integers(0, 9))
        vals = [int(v) for v in rng.integers(-2 ** 31, 2 ** 31 - 1, 3)]
        notify = [t.UserCommand(v, reply_mode=t.ReplyMode.NOTIFY,
                                correlation=("c", i, j), notify_to=notify_sink)
                  for j, v in enumerate(vals)]
        if kind == 0:
            cmds = [t.UserCommand(v) for v in vals]
            items.append((to, t.AppendEntriesRpc(
                term=3, leader_id=t.ServerId("m1", "n1"),
                prev_log_index=10 + i, prev_log_term=2, leader_commit=9 + i,
                entries=tuple(t.Entry(11 + i + j, 3, c)
                              for j, c in enumerate(cmds)),
                payloads=tuple(pkg.codec.encode_command(c) for c in cmds)),
                "n1"))
        elif kind == 1:
            items.append((to, t.CommandsEvent(tuple(notify)), "n1"))
        elif kind == 2:
            imgs = tuple(pkg.codec.encode_command(
                t.UserCommand(v, reply_mode=t.ReplyMode.NOTIFY,
                              correlation=("r", i)))
                for v in vals)
            items.append((to, t.CommandsEvent(
                tuple(pkg.codec.decode_command(b) for b in imgs), imgs),
                "n1"))
        elif kind == 3:
            items.append((to, t.CommandEvent(notify[0]), "n1"))
        elif kind == 4:
            items.append((to, t.RequestVoteRpc(
                term=i, candidate_id=t.ServerId("m1", "n1"),
                last_log_index=vals[0] & 1023, last_log_term=2), "n1"))
        elif kind == 5:
            items.append((to, t.AppendEntriesReply(
                term=3, success=bool(vals[1] & 1), next_index=i + 1,
                last_index=i, last_term=3,
                from_=t.ServerId("m3", "n3")), "n3"))
        elif kind == 6:
            items.append(("__notify__", (7, tuple(("c", i, j) for j in
                                                  range(3)))))
        elif kind == 7:
            items.append(("__reply__", (i, ("ok", vals[0]))))
        else:
            # a request to the receiver's node, a third of them a resend
            # of the one before (answered from the receiver's cache)
            if last_rid is None or vals[2] % 3:
                last_rid = f"rid-{i}"
            items.append(("__rpc_req__", pkg.rpc.RpcRequest(
                rid=last_rid, node="n2", op="ping", args={"i": i})))
    return items


def frame_kind_and_body(frame: bytes):
    """(kind, pickled body) of one length-prefixed frame."""
    (length,) = port_tcp._LEN.unpack(frame[:4])
    assert length == len(frame) - 4
    return frame[4], frame[5:]


def encoded_frames(pkg, items):
    """Each item's own frame, then runs of routed items as batch frames."""
    router = pkg.tcp.TcpRouter(("127.0.0.1", 0), {})
    try:
        router.listen_addr, router._router_id = ("127.0.0.1", 1), "r0"
        frames = [router._encode_item(it) for it in items]
        plain = [it for it in items if not isinstance(it[0], str)]
        frames += [router._encode_msg_batch(plain[lo:lo + 16])
                   for lo in range(0, len(plain), 16)]
        return frames
    finally:
        router.stop()


def decoded(frames, loads, from_wire):
    out = []
    for frame in frames:
        kind, body = frame_kind_and_body(frame)
        got = loads(body)
        if kind == port_tcp.FRAME_MSG:
            got = (got[0], got[1], from_wire(got[2]))
        elif kind == port_tcp.FRAME_MSG_BATCH:
            got = [(to, src, from_wire(m)) for to, src, m in got]
        out.append((kind, got))
    return out


def test_port_decodes_reference_frames():
    ref_frames = encoded_frames(REF, wire_items(REF, 3))
    port_frames = encoded_frames(PORT, wire_items(PORT, 3))
    assert [f[4] for f in ref_frames] == [f[4] for f in port_frames]
    kinds = {f[4] for f in ref_frames}
    assert kinds == {port_tcp.FRAME_MSG, port_tcp.FRAME_MSG_BATCH,
                     port_tcp.FRAME_REPLY, port_tcp.FRAME_NOTIFY,
                     port_tcp.FRAME_RPC_REQ}
    from_wire = port_tcp.TcpRouter._from_wire
    port_of_ref = decoded(ref_frames, convert.loads, from_wire)
    port_own = decoded(port_frames, convert.loads, from_wire)
    ref_own = decoded(ref_frames, pickle.loads,
                      ref_tcp.TcpRouter._from_wire)
    assert norm(port_of_ref) == norm(port_own) == norm(ref_own)
    # the reference's frames read as the port's classes
    msgs = [m for _k, got in port_of_ref
            for m in (got if isinstance(got, list) else [got])]
    assert {type(m[2]).__module__ for m in msgs
            if isinstance(m, tuple) and len(m) == 3 and
            hasattr(m[2], "__dataclass_fields__")} == \
        {"ra_tpu_torch.core.types"}


class Sink:
    """A node stand-in on a router: records what it is handed, and
    answers control ops at once."""

    def __init__(self):
        self.got, self.shells = [], {}

    def deliver(self, to, msg):
        if type(msg).__name__ == "NodeControlEvent":
            self.got.append(("ctl", (msg.op, sorted(msg.args.items()))))
            msg.from_(("pong", "n2"))
        else:
            # the package the receiver decoded into, and the message
            self.got.append((type(msg).__module__.split(".")[0],
                             repr(norm(to)), norm(msg)))
        return True


def fault_run(pkg, seed, send_plan=None, recv_plan=None, partition=False,
              recv_pkg=None):
    """``wire_items`` from a router of ``pkg`` hosting ``n1`` to one of
    ``recv_pkg`` (default ``pkg``) hosting ``n2``, every item queued before
    the sender thread starts (so the batches are fixed): (deliveries,
    sender dropped_sends, plan counters, receiver rpc_counters)."""
    recv = (recv_pkg or pkg).tcp.TcpRouter(("127.0.0.1", 0), {})
    send = pkg.tcp.TcpRouter(("127.0.0.1", 0), {"n2": recv.listen_addr})
    sink = Sink()
    try:
        send.nodes["n1"], recv.nodes["n2"] = Sink(), sink
        send.listen_addr, send._router_id = ("127.0.0.1", 1), "r0"
        recv._notify_handles[7] = lambda corrs: sink.got.append(
            ("notify", norm(corrs)))
        origin = send._server.getsockname()
        items = [(tag, pkg.rpc.stamp_origin(req, origin, "r0"))
                 if tag == "__rpc_req__" else (tag, req, *rest)
                 for tag, req, *rest in wire_items(pkg, seed)]
        if send_plan is not None:
            send.set_fault_plan(send_plan)
            if partition:
                send_plan.partition("n2")
        if recv_plan is not None:
            recv.set_fault_plan(recv_plan)
        peer = send._peer_for("n2")
        for it in items:
            peer.queue.put_nowait(it)
        send._ensure_sender(peer)
        last, quiet_since = -1, time.monotonic()
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            n = len(sink.got)
            if n != last:
                last, quiet_since = n, time.monotonic()
            elif peer.queue.empty() and time.monotonic() - quiet_since > 0.6:
                break
            time.sleep(0.05)
        plans = [p.counters.copy() for p in (send_plan, recv_plan) if p]
        return sink.got, send.dropped_sends, plans, dict(recv.rpc_counters)
    finally:
        for p in (send_plan, recv_plan):
            if p is not None:
                p.unregister()
        send.stop()
        recv.stop()


FAULT_CASES = {
    "none": dict(),
    "drop": dict(send=FaultSpec(drop=0.3)),
    "duplicate": dict(send=FaultSpec(duplicate=0.3)),
    "reorder": dict(send=FaultSpec(reorder=0.3)),
    "mixed": dict(send=FaultSpec(drop=0.2, duplicate=0.2, reorder=0.2)),
    "partition": dict(send=FaultSpec(), partition=True),
    "recv_drop": dict(recv=FaultSpec(drop=0.3)),
}


def case_plans(case, send_pkg, recv_pkg):
    """The case's seeded plans, each in the package of its router: the
    queue's frame classes only (the detector's pings, whose number depends
    on the clock, keep a clean stream of their own)."""
    spec = FAULT_CASES[case]

    def mk(key, pkg):
        return pkg.rpc.FaultPlan(21, by_class={
            c: pkg.rpc.FaultSpec(**vars(spec[key]))
            for c in ("msg", "reply", "notify", "rpc_req")}) \
            if key in spec else None
    return mk("send", send_pkg), mk("recv", recv_pkg), \
        spec.get("partition", False)


def packages(run):
    """The packages a run's deliveries were decoded into, and the run
    with them left out."""
    delivered = run[0]
    return {d[0] for d in delivered if len(d) == 3}, \
        ([d[1:] if len(d) == 3 else d for d in delivered], *run[1:])


@pytest.mark.parametrize("case", sorted(FAULT_CASES))
def test_fault_plan_deliveries_match_reference(case):
    port_pkgs, got = packages(fault_run(PORT, 5, *case_plans(case, PORT,
                                                            PORT)))
    ref_pkgs, want = packages(fault_run(REF, 5, *case_plans(case, REF, REF)))
    assert got == want
    assert port_pkgs <= {"ra_tpu_torch"} and ref_pkgs <= {"ra_tpu"}
    delivered, dropped, _plans, rpc_counters = got
    if case == "partition":
        assert delivered == [] and dropped == 120
    else:
        assert len(delivered) > 40 and rpc_counters["rpc_requests_executed"]
    if case == "none":
        assert dropped == 0 and rpc_counters["rpc_dedup_hits"] > 0


@pytest.mark.parametrize("case", ["none", "mixed", "recv_drop"])
def test_port_router_receives_reference_frames(case):
    """A reference router sends the queue to a port router over a real
    socket: the port's receive path delivers what it delivers when a port
    router sends the same queue under the same plans."""
    got = fault_run(REF, 5, *case_plans(case, REF, PORT), recv_pkg=PORT)
    assert got == fault_run(PORT, 5, *case_plans(case, PORT, PORT))
    assert len(got[0]) > 40 and packages(got)[0] == {"ra_tpu_torch"}


# -- twins of the reference's in-process TcpRouter tests ----------------------

@pytest.fixture
def pair():
    """A server router hosting one RaNode and a member-less client router
    that reaches it over real sockets."""
    server = TcpRouter(("127.0.0.1", 0), {})
    node = RaNode("fn1", router=server, device="cpu")
    client = TcpRouter(("127.0.0.1", 0), {"fn1": server.listen_addr})
    yield client, server, node
    node.stop()
    client.stop()
    server.stop()


def ping(client, timeout=30):
    return ra_tpu_torch.node_call("fn1", "ping", {}, router=client,
                                  timeout=timeout)


def test_node_call_completes_under_mixed_chaos(pair):
    client, _server, _node = pair
    plan = FaultPlan(7, default=FaultSpec(drop=0.2, delay=0.1,
                                          duplicate=0.1, delay_ms=(1, 10)))
    client.set_fault_plan(plan)
    for _ in range(10):
        assert ping(client) == ("pong", "fn1")
    assert client.rpc_counters["rpc_calls"] == 10
    assert sum(plan.counters.values()) > 0, plan.overview()
    assert client.rpc_counters["rpc_retries"] >= 1
    assert client.rpc_counters["rpc_timeouts"] == 0


def test_lifecycle_verbs_exactly_once_under_drop_and_reconnect(pair):
    client, server, node = pair
    sid = port_types.ServerId("m1", "fn1")
    client.set_fault_plan(FaultPlan(
        11, default=FaultSpec(drop=0.2),
        by_class={"rpc_resp": FaultSpec(drop=1.0, limit=1)}))
    executed0 = server.rpc_counters["rpc_requests_executed"]
    ra = ra_tpu_torch
    assert tuple(ra.start_server("fc", machine_spec("torch_rpcfaults"), sid,
                                 [sid], router=client)) == tuple(sid)
    assert ra.restart_server(sid, router=client) is not None
    client._close_peer(client.peers["fn1"])    # a forced reconnect
    ra.stop_server(sid, router=client)
    assert node.shells.get("m1") is None
    assert ra.restart_server(sid, router=client) is not None
    assert node.shells.get("m1") is not None
    ra.force_delete_server(sid, router=client)
    assert node.shells.get("m1") is None
    with pytest.raises(RuntimeError, match="not_found"):
        ra.restart_server(sid, router=client)
    assert server.rpc_counters["rpc_requests_executed"] - executed0 == 6
    assert client.rpc_counters["rpc_retries"] >= 1
    assert server.rpc_counters["rpc_dedup_hits"] >= 1
    assert server.rpc_counters["rpc_responses_resent"] >= 1


def test_duplicate_requests_execute_once(pair):
    client, server, _node = pair
    client.set_fault_plan(FaultPlan(
        5, by_class={"rpc_req": FaultSpec(duplicate=1.0)}))
    executed0 = server.rpc_counters["rpc_requests_executed"]
    dedup0 = server.rpc_counters["rpc_dedup_hits"]
    for _ in range(5):
        assert ping(client) == ("pong", "fn1")
    deadline = time.monotonic() + 5.0
    while server.rpc_counters["rpc_dedup_hits"] - dedup0 < 5 and \
            time.monotonic() < deadline:
        time.sleep(0.02)
    assert server.rpc_counters["rpc_dedup_hits"] - dedup0 >= 5
    assert server.rpc_counters["rpc_requests_executed"] - executed0 == 5


def test_partition_unreachable_then_heal(pair):
    client, _server, _node = pair
    assert ping(client, 10) == ("pong", "fn1")
    plan = FaultPlan(3)
    client.set_fault_plan(plan)
    plan.partition("fn1")
    t0 = time.monotonic()
    with pytest.raises(Unreachable):
        ping(client, 4)
    assert time.monotonic() - t0 < 6
    assert client.rpc_counters["rpc_unreachable"] == 1
    plan.heal()
    assert ping(client, 15) == ("pong", "fn1")


def test_timeout_when_peer_alive_but_unresponsive(pair):
    client, server, _node = pair
    server.set_fault_plan(FaultPlan(
        9, by_class={"rpc_req": FaultSpec(drop=1.0)}))
    with pytest.raises(RpcTimeout):
        ping(client, 0.6)
    assert client.rpc_counters["rpc_timeouts"] == 1
    assert client.rpc_counters["rpc_retries"] >= 1


def test_unknown_node_is_unreachable_immediately(pair):
    client, _server, _node = pair
    t0 = time.monotonic()
    with pytest.raises(Unreachable, match="address book"):
        ra_tpu_torch.node_call("ghost", "ping", {}, router=client,
                               timeout=30)
    assert time.monotonic() - t0 < 1.0


def test_local_router_has_no_remote_reach():
    with pytest.raises(Unreachable, match="no RPC transport"):
        ra_tpu_torch.node_call("nowhere", "ping", {},
                               router=ra_tpu_torch.LocalRouter(), timeout=5)


class Trio:
    """Three in-process TcpRouters, a RaNode on each, and a cluster of
    the summing machine started over the reliable control plane from the
    first router."""

    def __init__(self, prefix, election_timeout_ms):
        self.names = [f"{prefix}{i}" for i in (1, 2, 3)]
        self.routers = {n: TcpRouter(("127.0.0.1", 0), {})
                        for n in self.names}
        for n in self.names:
            self.routers[n].address_book.update(
                {m: self.routers[m].listen_addr for m in self.names
                 if m != n})
        self.nodes = {n: RaNode(n, router=self.routers[n], device="cpu")
                      for n in self.names}
        self.sids = [port_types.ServerId(f"m_{n}", n) for n in self.names]
        started = ra_tpu_torch.start_cluster(
            f"{prefix}c", machine_spec("torch_rpcfaults"), self.sids,
            router=self.routers[self.names[0]],
            election_timeout_ms=election_timeout_ms, tick_interval_ms=100)
        assert set(started) == set(self.sids)

    def leader(self):
        return next((s for s in self.sids if self.nodes[s.node].shells[
            s.name].server.raft_state.value == "leader"), None)

    def stop(self):
        for n in self.names:
            self.nodes[n].stop()
            self.routers[n].stop()


def test_raft_traffic_survives_seeded_message_drops():
    """Seeded 10% drops of the Raft msg frames on every member's router:
    commands sent to the leader from its own host keep committing (the
    pipeline catch-up resends what the plan eats), the counter exact."""
    trio = Trio("fr", 200)
    try:
        for r in trio.routers.values():
            r.set_fault_plan(FaultPlan(17, by_class={
                "msg": FaultSpec(drop=0.1)}))
        sent, total = 0, 0
        deadline = time.monotonic() + 90
        while sent < 15 and time.monotonic() < deadline:
            leader = trio.leader()
            if leader is None:
                time.sleep(0.05)
                continue
            try:
                total = ra_tpu_torch.process_command(
                    leader, 1, router=trio.routers[leader.node],
                    timeout=15).reply
            except (TimeoutError, RuntimeError):
                continue
            sent += 1
        assert (sent, total) == (15, 15)
        assert any(r.fault_plan.counters.get("drop", 0) > 0
                   for r in trio.routers.values())
    finally:
        trio.stop()


def test_batched_replication_at_most_once_under_dup_reorder():
    """Duplicated and reordered AppendEntries batch frames between the
    members: every pipelined +1 applies once (the total equals the
    commands sent) and no correlation is notified twice."""
    trio = Trio("bd", 300)
    client = TcpRouter(("127.0.0.1", 0),
                       {n: r.listen_addr for n, r in trio.routers.items()})
    try:
        res, deadline = None, time.monotonic() + 60
        while res is None and time.monotonic() < deadline:
            try:
                res = ra_tpu_torch.process_command(trio.sids[0], 0,
                                                   router=client, timeout=10)
            except TimeoutError:
                pass
        assert res is not None, "no leader over TCP"
        for r in trio.routers.values():
            r.set_fault_plan(FaultPlan(23, by_class={
                "msg": FaultSpec(duplicate=0.3, reorder=0.3)}))
        notified, lock = [], threading.Lock()

        def on_notify(batch):
            with lock:
                notified.extend(c for c, _r in batch)
        n = 400
        for i in range(n):
            ra_tpu_torch.pipeline_command(res.leader, 1, correlation=("bd", i),
                                          notify_to=on_notify, router=client,
                                          trace_ctx=False)
        deadline = time.monotonic() + 60
        while len(notified) < n and time.monotonic() < deadline:
            time.sleep(0.05)
        with lock:
            assert sorted(notified) == [("bd", i) for i in range(n)]
        # a majority acks: a follower may still be catching up here
        deadline = time.monotonic() + 30
        for name, sid in zip(trio.names, trio.sids):
            while True:
                r = ra_tpu_torch.local_query(sid, lambda s: s,
                                             router=trio.routers[name],
                                             timeout=10)
                if r.reply >= n or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            assert r.reply == n, (name, r.reply)
        assert any(r.fault_plan.counters.get("duplicate", 0) +
                   r.fault_plan.counters.get("reorder", 0) > 0
                   for r in trio.routers.values())
    finally:
        client.stop()
        trio.stop()


def test_rpc_trace_ctx_survives_duplicates_and_partition():
    """Duplicated and reordered request frames execute once, the
    duplicates recorded under the call's trace id in the port's flight
    recorder; a partition surfaces Unreachable and is recorded."""
    from ra_tpu_torch import trace
    from ra_tpu_torch.blackbox import RECORDER
    RECORDER.clear()
    server = TcpRouter(("127.0.0.1", 0), {})
    node = RaNode("bz1", router=server, device="cpu")
    client = TcpRouter(("127.0.0.1", 0), {"bz1": server.listen_addr})
    try:
        client.set_fault_plan(FaultPlan(11, by_class={
            "rpc_req": FaultSpec(duplicate=1.0, limit=3)}))
        trace.set_trace_origin("rpx")
        assert ra_tpu_torch.node_call("bz1", "ping", {}, router=client,
                                      timeout=20) == ("pong", "bz1")
        evs = RECORDER.events("rpc")
        ctx = next(e for e in evs if e[1] == "rpc.send")[2]["trace"]
        assert ctx.startswith("rpx-")
        assert len([e for e in evs if e[1] == "rpc.recv" and
                    e[2]["trace"] == ctx]) == 1
        assert [e for e in evs if e[1] == "rpc.dup" and
                e[2]["trace"] == ctx]
        assert server.rpc_counters["rpc_dedup_hits"] >= 1
        assert any(e[1] == "net.fault" and e[2]["kind"] == "duplicate"
                   for e in RECORDER.events("net"))
        plan2 = FaultPlan(12, by_class={
            "rpc_req": FaultSpec(reorder=1.0, limit=2)})
        client.set_fault_plan(plan2)
        executed0 = server.rpc_counters["rpc_requests_executed"]
        assert ra_tpu_torch.node_call("bz1", "ping", {}, router=client,
                                      timeout=20) == ("pong", "bz1")
        assert server.rpc_counters["rpc_requests_executed"] - executed0 == 1
        plan2.partition("bz1")
        with pytest.raises(Unreachable):
            ra_tpu_torch.node_call("bz1", "ping", {}, router=client,
                                   timeout=2)
        assert any(e[2]["kind"] == "partition"
                   for e in RECORDER.events("net"))
        plan2.heal()
    finally:
        node.stop()
        client.stop()
        server.stop()
        RECORDER.clear()


def test_fifo_cross_host_pipeline_acks():
    """Three single-node hosts over TCP; a FifoClient co-hosted with a
    follower pipelines enqueues: the follower relays them, the applied
    notifications route back across hosts and the seqno dedup holds, so
    every enqueue is ready exactly once."""
    from ra_tpu_torch.models import FifoClient, FifoMachine
    from ra_tpu_torch.models.fifo import query_messages_ready
    names = ("h1", "h2", "h3")
    routers = {n: TcpRouter(("127.0.0.1", 0), {}) for n in names}
    for n in names:
        routers[n].address_book.update({m: routers[m].listen_addr
                                        for m in names if m != n})
    nodes = {n: RaNode(n, router=routers[n], device="cpu") for n in names}
    sids = {n: port_types.ServerId(f"q_{n}", n) for n in names}
    try:
        for n in names:
            ra_tpu_torch.start_server("xq", FifoMachine, sids[n],
                                      list(sids.values()), router=routers[n])
        ra_tpu_torch.trigger_election(sids["h1"], routers["h1"])
        leader, deadline = None, time.monotonic() + 10.0
        while leader is None and time.monotonic() < deadline:
            leader = next((n for n in names if nodes[n].shells[
                sids[n].name].server.raft_state.value == "leader"), None)
            time.sleep(0.02)
        assert leader, "no leader over TCP"
        follower = next(n for n in names if n != leader)
        client = FifoClient([sids[follower]], router=routers[follower],
                            tag="xh")
        for i in range(10):
            client.enqueue(i)
        client.flush(timeout=20.0)
        assert ra_tpu_torch.leader_query(
            sids[leader], query_messages_ready,
            router=routers[leader]).reply == 10
    finally:
        for n in names:
            nodes[n].stop()
            routers[n].stop()


# -- twins of tests/test_tcp_transport.py: one OS process a member ----------

NAMES = ["tn1", "tn2", "tn3"]


def fabric(kind="counter", names=NAMES, root=None, extra=()):
    """``names`` as member processes on the CPU (``chip_smoke``'s
    TcpCluster) with a cluster ``tcp`` of ``kind`` started on all but
    ``extra``, an election triggered on the first."""
    f = TcpCluster(names, root=root)
    try:
        members = [n for n in names if n not in extra]
        if members:
            f.start("tcp", kind, members, election_timeout_ms=500)
            f.call(members[0], "elect", "tcp")
    except BaseException:
        f.stop()
        raise
    return f


def command(f, n, value, timeout=60):
    """``value`` through member ``n`` (15 s to commit), its answer awaited
    ``timeout``: ("ok", reply, leader node) or ("err", ...)."""
    return f.ask(n, "command", "tcp", value, 15.0, timeout=timeout)


def state(f, n, cluster="tcp"):
    return f.call(n, "state", cluster, True)[0]


def await_converged(f, want, nodes=None, timeout=30):
    deadline = time.monotonic() + timeout
    states = {}
    while time.monotonic() < deadline:
        states = {n: state(f, n) for n in nodes or f.names}
        if all(s["state"] == want for s in states.values()):
            return states
        time.sleep(0.2)
    raise AssertionError(f"no convergence to {want!r}: {states}")


def await_identical_lists(f, acked, timeout=90):
    """Every member holds one identical list holding every acked value
    once; returns it."""
    deadline = time.monotonic() + timeout
    lists, last_err = [], None
    while time.monotonic() < deadline:
        try:
            lists = [state(f, n)["state"] for n in f.names]
        except Exception as e:  # noqa: BLE001 -- a retried probe
            last_err = e
            time.sleep(0.5)
            continue
        if all(x == lists[0] for x in lists) and set(acked) <= set(lists[0]):
            break
        time.sleep(0.4)
    assert lists, f"no member ever answered: {last_err!r}"
    assert all(x == lists[0] for x in lists), lists
    assert set(acked) <= set(lists[0]), "acked values lost"
    assert len(lists[0]) == len(set(lists[0])), "duplicates applied"
    return lists[0]


@pytest.fixture
def fabric3():
    f = fabric()
    yield f
    f.stop()


def test_cross_process_cluster(fabric3):
    f = fabric3
    f.leader("tcp")
    r = command(f, "tn1", 5)
    assert r[0] == "ok" and r[1] == 5, r
    r = command(f, "tn2", 7)       # redirected over TCP
    assert r[0] == "ok" and r[1] == 12, r
    await_converged(f, 12)


def test_leader_process_kill_failover(fabric3):
    f = fabric3
    f.leader("tcp")
    r = command(f, "tn1", 1)
    assert r[0] == "ok"
    leader_node = r[2]
    f.kill(leader_node)
    rest = [n for n in f.names if n != leader_node]
    got, deadline = None, time.monotonic() + 30
    while got is None and time.monotonic() < deadline:
        r = command(f, rest[0], 2, timeout=30)
        got = r if r[0] == "ok" else None
        time.sleep(0 if got else 0.3)
    assert got is not None and got[1] == 3, got
    assert got[2] != leader_node


def test_partition_no_loss_no_dup():
    f = fabric("list")
    try:
        leader = f.leader("tcp")
        acked = []
        for v in range(10):
            assert command(f, leader, v)[0] == "ok"
            acked.append(v)
        victim = [n for n in f.names if n != leader][0]
        f.partition(victim)
        for v in range(10, 20):
            assert command(f, leader, v, timeout=30)[0] == "ok"
            acked.append(v)
        deadline, seen_down = time.monotonic() + 10, False
        while time.monotonic() < deadline and not seen_down:
            ov = f.call(victim, "overview")[0]
            seen_down = "down" in ov["node_status"].values()
            time.sleep(0.2)
        assert seen_down, ov
        f.heal()
        states = await_converged(f, acked, timeout=40)
        for n, s in states.items():
            assert s["state"] == acked, n
            assert len(set(s["state"])) == len(s["state"]), n
    finally:
        f.stop()


def test_drop_counters_during_partition():
    f = fabric()
    try:
        leader = f.leader("tcp")
        victim = [n for n in f.names if n != leader][0]
        f.call(leader, "partition", [victim])
        for v in range(5):
            assert command(f, leader, v + 1, timeout=30)[0] == "ok"
        time.sleep(1.0)
        assert f.call(leader, "overview")[0]["dropped_sends"] > 0
    finally:
        f.stop()


def test_snapshot_install_over_tcp(tmp_path):
    f = fabric("snapcounter", root=tmp_path)
    try:
        leader = f.leader("tcp")
        victim = [n for n in f.names if n != leader][0]
        f.partition(victim)
        for _ in range(120):
            assert command(f, leader, 1, timeout=30)[0] == "ok"
        deadline, snap_idx = time.monotonic() + 15, 0
        while time.monotonic() < deadline and snap_idx == 0:
            snap_idx = f.call(leader, "metrics", "tcp")[0].get(
                "snapshot_index") or 0
            time.sleep(0.2)
        assert snap_idx > 0
        f.heal()
        await_converged(f, 120, timeout=60)
        m = f.call(victim, "metrics", "tcp")[0]
        assert (m.get("snapshot_index") or 0) >= snap_idx, m
    finally:
        f.stop()


def test_membership_change_over_tcp():
    f = fabric(names=NAMES + ["tn4"], extra=("tn4",))
    try:
        leader = f.leader("tcp")
        for v in (1, 2, 3):
            assert command(f, leader, v)[0] == "ok"
        f.start("tcp", "counter", NAMES, on=["tn4"], election_timeout_ms=500)
        assert f.ask(leader, "add_member", "tcp", "tn4", timeout=30)[0] == \
            "ok"
        deadline, ok = time.monotonic() + 30, False
        while time.monotonic() < deadline and not ok:
            s, members = state(f, "tn4"), f.call(leader, "members", "tcp")[0]
            ok = s["state"] == 6 and "tn4" in members
            time.sleep(0.2)
        assert ok, (s, members)
        assert f.ask(leader, "remove_member", "tcp", "tn4",
                     timeout=30)[0] == "ok"
        deadline = time.monotonic() + 20
        while "tn4" in f.call(leader, "members", "tcp")[0] and \
                time.monotonic() < deadline:
            time.sleep(0.2)
        assert "tn4" not in f.call(leader, "members", "tcp")[0]
    finally:
        f.stop()


@pytest.mark.parametrize("victim_role", ["leader", "follower"])
def test_wal_crash_on_node_over_tcp(tmp_path, victim_role):
    f = fabric("list", root=tmp_path)
    try:
        leader = f.leader("tcp")
        victim = leader if victim_role == "leader" else \
            [n for n in f.names if n != leader][0]
        acked = []
        for v in range(5):
            assert command(f, leader, v)[0] == "ok"
            acked.append(v)
        assert f.ask(victim, "kill_wal")[0] == "ok"
        # every attempt a fresh value: a timed-out one may still commit
        deadline, val, oks, r = time.monotonic() + 60, 100, 0, None
        while oks < 7 and time.monotonic() < deadline:
            r = command(f, leader, val, timeout=30)
            if r[0] == "ok":
                acked.append(val)
                oks += 1
            else:
                leader = f.leader("tcp")
            val += 1
        assert oks == 7, (oks, r)
        assert f.ask(victim, "wal_alive") == ("ok", True)
        await_identical_lists(f, acked, timeout=60)
    finally:
        f.stop()


def test_randomized_fault_schedule_over_tcp(tmp_path):
    """Seeded partitions and heals, WAL crashes, kills and respawns over
    the durable log, one fault at a time, with unique commands: every
    acked value survives once on every member."""
    import random
    rng = random.Random(7)
    f = fabric("list", root=tmp_path)
    try:
        leader = f.leader("tcp")
        acked, val, fault = [], 0, None
        for _ in range(26):
            roll = rng.random()
            if roll < 0.5:
                val += 1
                r = command(f, leader, val, timeout=45)
                if r[0] == "ok":
                    acked.append(val)
                else:
                    leader = f.leader("tcp", timeout=45)
            elif roll < 0.65 and fault is None:
                victim = rng.choice([n for n in f.names if n != leader])
                f.partition(victim)
                fault = ("part", victim)
            elif roll < 0.8 and fault is not None:
                if fault[0] == "part":
                    f.heal()
                else:
                    f.respawn(fault[1])
                fault = None
            elif roll < 0.9 and fault is None:
                victim = rng.choice(f.names)
                f.kill(victim)
                fault = ("kill", victim)
                if victim == leader:
                    leader = f.leader("tcp", timeout=45)
            elif fault is None:
                f.ask(leader, "kill_wal", timeout=45)
        if fault is not None and fault[0] == "kill":
            f.respawn(fault[1])
        f.heal()
        await_identical_lists(f, acked, timeout=90)
    finally:
        f.stop()


def test_node_restart_over_tcp(tmp_path):
    f = fabric(root=tmp_path)
    try:
        leader = f.leader("tcp")
        for v in (10, 20, 30):
            assert command(f, leader, v)[0] == "ok"
        await_converged(f, 60)
        victim = [n for n in f.names if n != leader][0]
        assert f.ask(victim, "stop") == ("stopped", victim)
        f.kill(victim)
        assert command(f, leader, 5, timeout=30)[0] == "ok"
        f.respawn(victim)
        assert await_converged(f, 65, timeout=40)[victim]["state"] == 65
    finally:
        f.stop()


def test_cross_node_lifecycle_control_plane(tmp_path):
    """A client with no members starts a three-node cluster in one
    ``start_cluster`` call over the control plane, then stops, restarts
    (after a process kill, from the target node's disk), and
    force-deletes a member remotely."""
    ra = ra_tpu_torch
    names = ["cp1", "cp2", "cp3"]
    f = fabric(names=names, root=tmp_path, extra=tuple(names))
    client = f.client
    spec = machine_spec("chip_tcp", kind="counter")
    try:
        assert ra.node_call("cp1", "ping", {}, router=client) == \
            ("pong", "cp1")
        sids = [port_types.ServerId("ctl", n) for n in names]
        assert ra.start_cluster("ctl", spec, sids, router=client,
                                election_timeout_ms=500,
                                tick_interval_ms=200) == sids
        with pytest.raises(RuntimeError, match="already_started"):
            ra.start_server("ctl", spec, sids[0], sids, router=client)
        res, deadline = None, time.monotonic() + 90
        while res is None and time.monotonic() < deadline:
            try:
                res = ra.process_command(sids[0], 5, router=client,
                                         timeout=10.0)
            except (TimeoutError, RuntimeError):
                ra.trigger_election(sids[0], router=client)
        assert res is not None and res.leader is not None
        leader = res.leader
        assert ra.process_command(leader, 3, router=client,
                                  timeout=30.0).reply == 8
        follower = next(s for s in sids if s != leader)
        assert ra.process_command(leader, 2, router=client, timeout=30.0,
                                  reply_from=("member", follower)).reply == 10
        ra.stop_server(follower, router=client)
        assert state(f, follower.node, "ctl")["raft"] == "noproc"
        with pytest.raises(RuntimeError, match="not_new"):
            ra.start_server("ctl", spec, follower, sids, router=client)
        assert ra.process_command(leader, 10, router=client,
                                  timeout=30.0).reply == 20
        f.kill(follower.node)
        f.respawn(follower.node)
        assert tuple(ra.restart_server(follower, router=client)) == \
            tuple(follower)
        deadline, st = time.monotonic() + 60, None
        while time.monotonic() < deadline:
            st = state(f, follower.node, "ctl")
            if st["raft"] in ("follower", "leader") and st["state"] == 20:
                break
            time.sleep(0.4)
        assert st["state"] == 20, st
        ra.force_delete_server(follower, router=client)
        assert state(f, follower.node, "ctl")["raft"] == "noproc"
        assert [d for d in os.listdir(tmp_path / follower.node)
                if d.startswith("ctl_")] == []
        with pytest.raises(RuntimeError, match="not_found"):
            ra.restart_server(follower, router=client)
    finally:
        f.stop()
