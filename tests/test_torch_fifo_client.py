"""The port's ``FifoClient`` (``ra_tpu_torch/models/fifo_client.py``)
against the reference's.

* The verdict ladder (``ok`` -> ``slow`` -> ``StopSending``) on the shared
  enum, and the client's credit frame byte for byte, in both packages.
* Twins of the reference's ``FifoClient`` tests on the in-process fabric
  (``tests/test_fifo_machine.py``, ``test_machine_effects.py``'s eol test,
  ``test_blackbox.py``'s seqno trace id): where one client fixes the log
  order (end to end, consumer death, back pressure) both packages run the
  same script and their deliveries, statuses and counters are equal;
  where the result depends on timing the port runs alone and is held to
  the reference test's invariants.
* Twins of ``tests/test_partitions.py``: a five-member FIFO cluster under
  the same nemesis scripts (partitions, heals, restarts), the port alone,
  and every enqueued message delivered exactly once (and in order per
  enqueuer) after the heal.
"""
import threading
import time
from types import SimpleNamespace

import pytest

import ra_tpu
import ra_tpu_torch
from ra_tpu.core import types as ref_types
from ra_tpu.models import fifo as ref_fifo
from ra_tpu.models import fifo_client as ref_client
from ra_tpu.wire import framing as ref_framing
from ra_tpu_torch.core import types as port_types
from ra_tpu_torch.models import fifo as port_fifo
from ra_tpu_torch.models import fifo_client as port_client
from ra_tpu_torch.wire import framing as port_framing

from nemesis import Nemesis, await_leader

REF = SimpleNamespace(ra=ra_tpu, t=ref_types, fifo=ref_fifo,
                      client=ref_client, framing=ref_framing)
PORT = SimpleNamespace(ra=ra_tpu_torch, t=port_types, fifo=port_fifo,
                       client=port_client, framing=port_framing)


class Fabric:
    """``n`` RaNodes on one LocalRouter, a FIFO cluster of one member
    each (``systems``: each node over its own RaSystem), the leader
    elected."""

    def __init__(self, pkg, name, n=3, base=None, election_timeout_ms=None,
                 machine=None):
        self.pkg, ra = pkg, pkg.ra
        self.router = ra.LocalRouter()
        self.sids = [pkg.t.ServerId(f"{name}{i}", f"{name}n{i}")
                     for i in range(1, n + 1)]
        self.systems = {s.node: ra.RaSystem(f"{base}/{s.node}")
                        for s in self.sids} if base else {}
        self.nodes = [ra.RaNode(s.node, router=self.router,
                                system=self.systems.get(s.node))
                      for s in self.sids]
        kw = {} if election_timeout_ms is None else \
            {"election_timeout_ms": election_timeout_ms}
        ra.start_cluster(name, machine or pkg.fifo.FifoMachine, self.sids,
                         router=self.router, **kw)
        ra.trigger_election(self.sids[0], self.router)
        self.leader = await_leader(self.router, self.sids)

    def client(self, tag, sids=None, **kw):
        return self.pkg.client.FifoClient(sids or self.sids,
                                          router=self.router, tag=tag, **kw)

    def close(self):
        self.router.heal()
        for n in self.nodes:
            n.stop()
        for s in self.systems.values():
            s.close()


def poll(client, want, timeout=10.0):
    deadline = time.monotonic() + timeout
    while len(client.deliveries) < want and time.monotonic() < deadline:
        client.poll_deliveries()
        time.sleep(0.02)
    return client.deliveries


# -- the verdict ladder and its credit frame ------------------------------------

def verdicts(pkg):
    cli = pkg.client.FifoClient.__new__(pkg.client.FifoClient)
    cli.pending, cli.next_seqno, cli.soft_limit, cli.max_pending = {}, 5, 2, 4
    cli._applied = pkg.client.Mailbox("applied")
    out = []
    for pending in ({}, {1: "a", 2: "b"}, {1: "a", 2: "b", 3: "c", 4: "d"}):
        cli.pending = dict(pending)
        out.append((cli.current_verdict(), cli.credit_frame()))
    return out, pkg.client.StopSending.VERDICT


def test_verdict_ladder_and_credit_frame_match_reference():
    got, want = verdicts(PORT), verdicts(REF)
    assert got == want
    fw = PORT.framing
    assert [v for v, _ in got[0]] == [fw.OK, fw.SLOW, fw.REJECT]
    assert got[1] == fw.REJECT
    t, body, _ = fw.read_frame(got[0][-1][1])
    _level, rec = fw.decode_credit(body)
    assert t == fw.T_CREDIT and rec["status"].tolist() == [fw.REJECT]
    assert rec["seqno"].tolist() == [4]


# -- twins of tests/test_fifo_machine.py -----------------------------------------

def end_to_end(pkg):
    f = Fabric(pkg, "fe")
    try:
        client = f.client("w1")
        client.checkout("auto", credit=50)
        for i in range(30):
            client.enqueue(f"msg-{i}")
        client.flush(timeout=10.0)
        got = list(poll(client, 30))
        client.settle([i for (i, _h, _r) in got])
        out = pkg.ra.leader_query(f.leader,
                                  pkg.fifo.query_messages_checked_out,
                                  router=f.router).reply
        return got, out
    finally:
        f.close()


def test_fifo_end_to_end_matches_reference():
    got, want = end_to_end(PORT), end_to_end(REF)
    assert got == want
    assert [raw for (_i, _h, raw) in got[0]] == [f"msg-{i}"
                                                 for i in range(30)]
    assert got[1] == 0


def consumer_death(pkg):
    f = Fabric(pkg, "fd")
    try:
        c1, c2 = f.client("dead"), f.client("alive")
        c1.checkout("auto", credit=10)
        for i in range(5):
            c1.enqueue_sync(i)
        first = list(poll(c1, 5))
        for node in f.nodes:
            node.process_down(c1.mailbox, "killed")
        c2.checkout("auto", credit=10)
        again = sorted(poll(c2, 5), key=lambda d: d[2])
        return first, again
    finally:
        f.close()


def test_fifo_consumer_death_redelivers_matches_reference():
    got, want = consumer_death(PORT), consumer_death(REF)
    assert got == want
    first, again = got
    assert len(first) == 5 and [r for (_i, _h, r) in again] == [0, 1, 2, 3, 4]
    assert all(h["delivery_count"] == 1 for (_i, h, _r) in again)


def test_fifo_release_cursor_truncates_log():
    f = Fabric(PORT, "fr", machine=lambda: port_fifo.FifoMachine(
        shadow_copy_interval=8))
    try:
        client = f.client("rc")
        for i in range(40):
            client.enqueue(i)
        client.flush(timeout=10.0)
        client.checkout("auto", credit=64)
        client.settle([i for (i, _h, _r) in poll(client, 40)])
        shell = f.nodes[[s.name for s in f.sids].index(f.leader.name)] \
            .shells[f.leader.name]
        deadline = time.monotonic() + 5.0
        while shell.server.log.first_index() <= 1 and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        assert shell.server.log.first_index() > 1
    finally:
        f.close()


def back_pressure(pkg):
    """The cluster configured but not elected, so pipelined enqueues park
    in the client's pending set; then elected, drained and open again."""
    ra, t = pkg.ra, pkg.t
    router = ra.LocalRouter()
    sids = [t.ServerId(f"bp{i}", f"bpn{i}") for i in (1, 2, 3)]
    nodes = {s.node: ra.RaNode(s.node, router=router) for s in sids}
    try:
        for sid in sids:
            nodes[sid.node].start_server(t.ServerConfig(
                server_id=sid, uid=ra.new_uid(sid.name), cluster_name="bp",
                initial_members=tuple(sids), machine=pkg.fifo.FifoMachine(),
                election_timeout_ms=10_000, tick_interval_ms=50))
        client = pkg.client.FifoClient(sids, router=router, soft_limit=4,
                                       max_pending=8)
        out = [client.enqueue(i)[0] for i in range(8)]
        out.append((client.blocked_since, client.ingress_rejections))
        t0 = time.monotonic()
        for msg in ("overflow", "overflow-2"):
            with pytest.raises(pkg.client.StopSending):
                client.enqueue(msg)
        stamp = client.blocked_since
        assert stamp is not None and t0 <= stamp <= time.monotonic()
        out.append(client.ingress_rejections)
        ra.trigger_election(sids[0], router=router)
        await_leader(router, sids)
        client.flush(timeout=15.0)
        out += [client.pending_count(), client.enqueue("after")[0],
                client.blocked_since, client.ingress_rejections]
        return out
    finally:
        for n in nodes.values():
            n.stop()


def test_client_backpressure_soft_limit_and_stop_sending_matches_reference():
    got = back_pressure(PORT)
    assert got == back_pressure(REF)
    assert got == ["ok"] * 3 + ["slow"] * 5 + [(None, 0), 2, 0, "ok",
                                                None, 2]


# -- twins of the effects and flight-recorder FifoClient tests ------------------

def test_deleted_cluster_emits_eol_to_attached_pids():
    f = Fabric(PORT, "el")
    try:
        cli = f.client("eol-consumer")
        cli.checkout(credit=2)
        cli.enqueue_sync("m1")
        assert ra_tpu_torch.delete_cluster(f.leader,
                                           router=f.router).reply == "ok"
        deadline, eol = time.monotonic() + 10, None
        while time.monotonic() < deadline and eol is None:
            eol = next((m for m in cli.mailbox.drain()
                        if isinstance(m, tuple) and m[0] == "eol"), None)
            time.sleep(0.05)
        assert eol is not None, "consumer never saw the eol signal"
    finally:
        f.close()


def test_pipeline_command_and_fifo_seqno_ctx(tmp_path):
    """A FifoClient enqueue records under ``<mailbox>/<seqno>`` in the
    port's flight recorder, and a resend reuses that id."""
    from ra_tpu_torch.blackbox import RECORDER
    RECORDER.clear()
    f = Fabric(PORT, "fx", base=str(tmp_path))
    try:
        cli = f.client("fxc")
        cli.enqueue(b"one")
        cli.flush()
        want = f"{cli.mailbox.name}/1"
        evs = [e for e in RECORDER.events("cmd")
               if e[2].get("trace") == want]
        assert {"cmd.ingress", "cmd.append"} <= {e[1] for e in evs}
        cli.pending[1] = b"one"
        cli.resend()
        assert len([e for e in RECORDER.events("cmd")
                    if e[1] == "cmd.ingress" and
                    e[2].get("trace") == want]) >= 2
    finally:
        f.close()
        RECORDER.clear()


# -- twins of tests/test_partitions.py (the port alone) --------------------------

class Enqueuer:
    """A continuous pipelined-enqueue workload of unique payloads; the
    client resends unacknowledged seqnos after leader changes."""

    def __init__(self, f, sids=None, tag="enq"):
        self.client = f.client(tag, sids)
        self.sent: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        i = 0
        while not self._stop.is_set():
            try:
                self.client.enqueue(f"{self.client.tag}-{i}")
            except port_client.StopSending:
                self.client.resend()
                self._stop.wait(0.05)
                continue
            self.sent.append(f"{self.client.tag}-{i}")
            i += 1
            if i % 25 == 0:
                self.client.resend()
            time.sleep(0.005)

    def acked(self):
        return len(self.sent) - self.client.pending_count()

    def stop_and_flush(self, timeout=60.0):
        self._stop.set()
        self._thread.join(timeout=10.0)
        self.client.flush(timeout=timeout)
        return self.sent


def drain_all(f, expect, timeout=30.0):
    """Settled dequeues until the queue is empty: every raw payload."""
    client, got = f.client("drain"), []
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            res = client.dequeue(settled=True)
        except TimeoutError:
            continue
        if res == ("dequeue", "empty"):
            if len(got) >= expect:
                break
            time.sleep(0.1)
            continue
        kind, (_header, raw) = res
        assert kind == "dequeue"
        got.append(raw)
    return got


@pytest.fixture
def five():
    f = Fabric(PORT, "p", n=5, election_timeout_ms=100)
    yield f
    f.close()


def test_enq_drain_minority_partitioned_leader(five):
    f, leader = five, five.leader
    majority = [s for s in f.sids if s.node != leader.node]
    enq = Enqueuer(f, majority)
    time.sleep(0.5)
    for other in majority:
        f.router.block(leader.node, other.node)
    assert await_leader(f.router, majority, timeout=10.0) != leader
    at_takeover = enq.acked()
    time.sleep(1.5)
    assert enq.acked() > at_takeover, \
        "no commits landed under the majority leader during the partition"
    f.router.heal()
    time.sleep(1.0)
    sent = enq.stop_and_flush()
    assert sorted(drain_all(f, len(sent))) == sorted(sent)


def test_random_partition_schedule(five):
    nem = Nemesis(five.router, five.nodes, seed=42)
    enq = Enqueuer(five)
    nem.run([("part_random", 1.5), ("wait", 0.5), ("part_random", 1.5),
             ("wait", 0.5), ("part_random", 1.5), ("heal",), ("wait", 1.0)])
    sent = enq.stop_and_flush()
    assert sorted(drain_all(five, len(sent))) == sorted(sent)


def test_app_restart_under_load(tmp_path):
    """Followers, then the leader, restarted under load over durable
    logs: no loss and no duplicate."""
    f = Fabric(PORT, "p", n=5, base=str(tmp_path), election_timeout_ms=100)
    try:
        nem = Nemesis(f.router, f.nodes, seed=7)
        enq = Enqueuer(f)
        time.sleep(0.5)
        followers = [s for s in f.sids if s != f.leader]
        nem.run([("app_restart", followers[:2]), ("wait", 1.0),
                 ("app_restart", [f.leader]), ("wait", 1.5)])
        sent = enq.stop_and_flush()
        assert sorted(drain_all(f, len(sent))) == sorted(sent)
    finally:
        f.close()


def test_two_enqueuers_through_partitions(five):
    nem = Nemesis(five.router, five.nodes, seed=9)
    e1, e2 = Enqueuer(five, tag="alpha"), Enqueuer(five, tag="beta")
    nem.run([("part_random", 1.5), ("wait", 1.0)])
    sent1, sent2 = e1.stop_and_flush(), e2.stop_and_flush()
    got = drain_all(five, len(sent1) + len(sent2))
    assert sorted(got) == sorted(sent1 + sent2)
    for tag, sent in (("alpha", sent1), ("beta", sent2)):
        assert [g for g in got if g.startswith(tag)] == sent


def test_leader_in_minority_cannot_commit(five):
    f, leader = five, five.leader
    client = f.client("strict")
    for i in range(10):
        client.enqueue_sync(f"pre-{i}")
    for o in (s.node for s in f.sids if s.node != leader.node):
        f.router.block(leader.node, o)
    majority = [s for s in f.sids if s.node != leader.node]
    assert await_leader(f.router, majority, timeout=10.0) != leader
    with pytest.raises((TimeoutError, RuntimeError)):
        ra_tpu_torch.process_command(leader, ("enqueue", None, None, "ghost"),
                                     router=f.router, timeout=1.0)
    f.router.heal()
    time.sleep(1.0)
    got = drain_all(f, expect=10)
    assert [g for g in got if g.startswith("pre-")] == \
        [f"pre-{i}" for i in range(10)]
