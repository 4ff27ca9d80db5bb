"""The port's wire plane (``ra_tpu_torch/wire/``) against the reference's
(``ra_tpu/wire/``), the port's engines on the CPU:

* framing: every frame the port encodes is byte-equal to the
  reference's, and decodes back;
* the listener's sweep, ring backpressure, protocol-garbage closes and
  slot reuse, the refused-op re-key and the reconnect storm over the
  loopback fleet: the same calls on a reference stack and a port stack,
  every counter, op state and lane sum equal;
* the socket path over localhost (version and width refusals, mux and
  reconnect, crash replay, slot reuse) on the port, held to the
  exactly-once oracle;
* ``run_wire_soak`` at a CPU scale, volatile and durable, against the
  reference's soak with the same seed: every count of the tail row
  (times and the device stamp aside) and the final state, leaf for
  leaf;
* the twin of ``test_recovery_reseeds_dedup_slots_across_generations``.
"""
import socket
import time

import numpy as np
import pytest

import ra_tpu.engine.lockstep as ref_lockstep_mod
from ra_tpu.engine import LockstepEngine as RefEngine
from ra_tpu.engine import open_engine as ref_open_engine
from ra_tpu.ingress import IngressPlane as RefPlane
from ra_tpu.wire import DedupCounterMachine as RefDedup
from ra_tpu.wire import LoopbackFleet as RefFleet
from ra_tpu.wire import WireListener as RefListener
from ra_tpu.wire import framing as ref_framing
from ra_tpu.wire.soak import run_wire_soak as ref_run_wire_soak
from ra_tpu_torch.convert import state_to_numpy
from ra_tpu_torch.engine import driver as port_driver
from ra_tpu_torch.engine import lockstep as port_lockstep
from ra_tpu_torch.engine.durable import open_engine
from ra_tpu_torch.ingress import IngressPlane
from ra_tpu_torch.wire import (OK, SHED, DedupCounterMachine, LoopbackFleet,
                               WireClient, WireListener, framing)
from ra_tpu_torch.wire.soak import run_wire_soak
from test_torch_engine import assert_same, assert_same_arrays, ref_arrays

CPU = "cpu"


def mk_engine(pkg, lanes=32, cmds=8, ring=128, slots=64):
    if pkg == "ref":
        return RefEngine(RefDedup(slots=slots), lanes, 3, ring_capacity=ring,
                         max_step_cmds=cmds, donate=False)
    return port_lockstep.LockstepEngine(
        DedupCounterMachine(slots=slots), lanes, 3, ring_capacity=ring,
        max_step_cmds=cmds, device=CPU)


def mk_plane(pkg, eng, **kw):
    kw.setdefault("superstep_k", 2)
    kw.setdefault("window_s", 0.0)
    kw.setdefault("soft_credit", 1 << 20)
    kw.setdefault("hard_credit", 1 << 20)
    return (RefPlane if pkg == "ref" else IngressPlane)(eng, **kw)


def mk_listener(pkg, plane, **kw):
    return (RefListener if pkg == "ref" else WireListener)(plane, **kw)


def mk_fleet(pkg, lst, n, **kw):
    return (RefFleet if pkg == "ref" else LoopbackFleet)(lst, n, **kw)


def lane_values(eng, lanes):
    return np.asarray(eng.consistent_read(np.asarray(lanes))["value"]) \
        .astype(np.int64)


# -- framing --------------------------------------------------------------

def test_framing_round_trips_and_matches_reference():
    pay = np.arange(6, dtype=np.int32).reshape(2, 3)
    frames = [
        ("encode_hello", ("acme/alice", 3), dict(tenants=2,
                                                 payload_width=3)),
        ("encode_hello_ack", (7, 1234), dict(slots=[4, 5, 6],
                                             payload_width=3)),
        ("encode_error", (framing.E_PAYLOAD_WIDTH, "width 4 != 3"), {}),
        ("encode_data", ([0, 1], [10, 11], pay), {}),
        ("encode_credit", (1, [0, 2], [5, 6], [OK, SHED]), {}),
        ("encode_ack", ([1], [99]), {}),
        ("encode_read", ([0, 1], [3, 4], np.ones((2, 2), np.int32)),
         dict(payload_width=3)),
    ]
    for name, args, kw in frames:
        got = getattr(framing, name)(*args, **kw)
        assert got == getattr(ref_framing, name)(*args, **kw), name
    f = framing.encode_hello("acme/alice", 3, tenants=2, payload_width=3)
    t, body, off = framing.read_frame(f)
    assert t == framing.T_HELLO and off == len(f)
    assert framing.decode_hello(body) == {
        "version": framing.WIRE_VERSION, "tenants": 2, "key": "acme/alice",
        "n_sessions": 3, "payload_width": 3}
    _t, body, _ = framing.read_frame(framing.encode_hello_ack(
        7, 1234, slots=[4, 5, 6], payload_width=3))
    d = framing.decode_hello_ack(body)
    assert d["epoch"] == 7 and d["handle_base"] == 1234
    assert d["slots"].tolist() == [4, 5, 6]
    blob = framing.encode_data([0, 1], [10, 11], pay)
    assert len(blob) == 2 * framing.data_stride(3)
    rec = framing.decode_data(blob, 3)
    assert rec["seqno"].tolist() == [10, 11]
    assert rec["pay"].tolist() == pay.tolist()
    c = framing.encode_credit(1, [0, 2], [5, 6], [OK, SHED])
    _t, body, _ = framing.read_frame(c)
    level, crec = framing.decode_credit(body)
    assert level == 1 and crec["status"].tolist() == [OK, SHED]
    assert framing.read_frame(c[:3]) is None
    assert framing.read_frame(c[:-1]) is None
    assert framing.STATUS_NAMES == ref_framing.STATUS_NAMES
    assert framing.WIRE_VERSION == ref_framing.WIRE_VERSION


# -- the loopback listener, both packages side by side -----------------------

def _stacks(**kw):
    eng_kw = {k: kw.pop(k) for k in ("lanes", "cmds", "ring", "slots")
              if k in kw}
    plane_kw = kw.pop("plane", {})
    out = {}
    for pkg in ("ref", "port"):
        eng = mk_engine(pkg, **eng_kw)
        plane = mk_plane(pkg, eng, **plane_kw)
        out[pkg] = (eng, plane, mk_listener(pkg, plane, port=None, **kw))
    return out


def _assert_stacks_equal(stacks, fleets, what):
    (_re, rp, rl), (_pe, pp, pl) = stacks["ref"], stacks["port"]
    assert pl.counters == rl.counters, what
    assert pp.counters == rp.counters, what
    assert pp.gauges() == rp.gauges(), what
    rf, pf = fleets["ref"], fleets["port"]
    assert pf.n_ops == rf.n_ops, what
    for k in ("op_state", "op_rank", "op_id"):
        assert np.array_equal(getattr(pf, k)[:pf.n_ops],
                              getattr(rf, k)[:rf.n_ops]), (what, k)
    assert np.array_equal(pf.watermark, rf.watermark), what
    assert np.array_equal(pl.rfill, rl.rfill), what


def _close(stacks):
    for eng, _plane, lst in stacks.values():
        lst.close()
        eng.close()


def test_sweep_decodes_rings_into_one_ingress_batch():
    stacks = _stacks(lanes=16, cmds=4, max_conns=32, ring_bytes=2048)
    fleets = {}
    for pkg, (eng, plane, lst) in stacks.items():
        fleet = mk_fleet(pkg, lst, 8, sessions_per_conn=4, key="mux",
                         seed=0)
        assert fleet.n_sessions == 32
        fleet.new_ops(np.arange(32), np.ones(32, np.int32))
        assert fleet.send_queued() == 32
        assert lst.sweep() == 32
        fleet.collect()
        assert int((fleet.op_state[:32] == 2).sum()) == 32
        assert lst.counters["credit_ok"] == 32
        plane.pump(force=True)
        plane.settle()
        fleet.collect()
        assert fleet.acked_mask().all()
        assert lst.counters["ack_rows"] > 0
        fleets[pkg] = fleet
    _assert_stacks_equal(stacks, fleets, "swept")
    assert_same(stacks["ref"][0], stacks["port"][0], what="swept")
    _close(stacks)


def test_loopback_feed_backpressure_keeps_tail_queued():
    stride = framing.data_stride(3)
    stacks = _stacks(lanes=4, cmds=4, max_conns=4, ring_bytes=4 * stride)
    fleets = {}
    for pkg, (_eng, _plane, lst) in stacks.items():
        fleet = mk_fleet(pkg, lst, 1, key="tiny", seed=0)
        fleet.new_ops(np.zeros(10, np.int64), np.ones(10, np.int32))
        assert fleet.send_queued() == 4
        assert len(fleet.queued_ops()) == 6
        lst.sweep()
        fleet.collect()
        assert fleet.send_queued() == 4
        fleets[pkg] = fleet
    _assert_stacks_equal(stacks, fleets, "backpressure")
    _close(stacks)


def test_sweep_closes_conns_on_protocol_garbage_and_reuses_the_slot():
    stacks = _stacks(lanes=4, cmds=4, max_conns=4, ring_bytes=2048)
    fleets = {}
    for pkg, (_eng, _plane, lst) in stacks.items():
        fleet = mk_fleet(pkg, lst, 2, key="bad", seed=0)
        lst.loopback_feed(fleet.conns[:1], bytes(range(lst.stride)),
                          np.array([1]))
        assert lst.sweep() == 0
        assert lst.counters["protocol_errors"] == 1
        assert lst.counters["conns_closed"] == 1
        assert lst.counters["credit_shed"] == 0
        assert int(lst.rfill[fleet.conns[0]]) == 0
        fresh = mk_fleet(pkg, lst, 1, key="fresh", seed=1)
        assert int(fresh.conns[0]) == int(fleet.conns[0])
        fresh.new_ops(np.zeros(1, np.int64), np.full(1, 7, np.int32))
        assert fresh.send_queued() == 1
        assert lst.sweep() == 1
        fresh.collect()
        assert (fresh.op_state[:1] == 2).all()
        fleets[pkg] = fresh
    _assert_stacks_equal(stacks, fleets, "garbage")
    _close(stacks)


def _until_placed(fleet, lst, plane, deadline_s=60.0):
    deadline = time.monotonic() + deadline_s
    while fleet.unplaced_count() > 0:
        fleet.send_queued()
        lst.sweep()
        fleet.collect()
        plane.pump(force=True)
        fleet.collect()
        assert time.monotonic() < deadline


def test_refused_op_rekeys_and_is_not_lost():
    """A tiny coalescer ring forces sheds; the client re-keys each refused
    op, and every op applies exactly once, in both packages alike."""
    stacks = _stacks(lanes=2, cmds=2, ring=64, slots=8, max_conns=4,
                     ring_bytes=4096, plane=dict(superstep_k=1,
                                                 capacity=2))
    fleets = {}
    for pkg, (eng, plane, lst) in stacks.items():
        fleet = mk_fleet(pkg, lst, 1, key="shed", seed=0)
        fleet.new_ops(np.zeros(32, np.int64), np.ones(32, np.int32))
        _until_placed(fleet, lst, plane)
        plane.settle()
        fleet.collect()
        assert lst.counters["credit_shed"] > 0
        lane = int(plane.directory.lane[fleet.handles[0]])
        assert int(lane_values(eng, [lane])[0]) == 32
        assert fleet.acked_mask().all()
        fleets[pkg] = fleet
    _assert_stacks_equal(stacks, fleets, "re-key")
    assert_same(stacks["ref"][0], stacks["port"][0], what="re-key")
    _close(stacks)


def test_reconnect_storm_dedup_matches_reference():
    """400 connections of 2 sessions, 6 waves of 1,000 ops, 40% of the
    connections killed mid-flight: duplicates are made and absorbed by
    the machine, the lane sums equal the fleet's oracle, and every count,
    op state and leaf equals the reference's."""
    stacks = _stacks(lanes=32, cmds=8, ring=256, slots=128, max_conns=512,
                     ring_bytes=4096)
    fleets = {}
    for pkg, (eng, plane, lst) in stacks.items():
        fleet = mk_fleet(pkg, lst, 400, sessions_per_conn=2, key="storm",
                         tenants=4, seed=3, max_ops=1 << 16)
        rng = np.random.default_rng(3)
        for w in range(6):
            fleet.new_ops(rng.integers(0, fleet.n_sessions, 1000),
                          rng.integers(1, 8, 1000).astype(np.int32))
            fleet.send_queued()
            lst.sweep()
            fleet.collect()
            plane.pump(force=True)
            fleet.collect()
            if w == 3:
                assert len(fleet.storm(0.4)) > 0
        _until_placed(fleet, lst, plane)
        plane.settle()
        fleet.collect()
        np.testing.assert_array_equal(lane_values(eng, np.arange(32)),
                                      fleet.expected_lane_sums(32))
        ranked = fleet.op_rank[:fleet.n_ops] >= 0
        assert fleet.acked_mask()[ranked].all()
        assert lst.counters["swept_rows"] > fleet.n_ops
        assert plane.counters["reconnects"] > 0
        fleets[pkg] = fleet
    _assert_stacks_equal(stacks, fleets, "storm")
    assert_same(stacks["ref"][0], stacks["port"][0], what="storm")
    _close(stacks)


# -- the socket path, on the port -------------------------------------------

def _drive(lst, plane, cli, *, want_acked, timeout=30.0):
    deadline = time.monotonic() + timeout
    while cli.acked_count() < want_acked:
        cli.flush()
        lst.sweep()
        plane.pump(force=True)
        plane.settle()
        cli.poll()
        assert time.monotonic() < deadline, \
            (cli.acked_count(), want_acked)


def _socket_stack(lanes=16, cmds=4, slots=64, **kw):
    eng = mk_engine("port", lanes=lanes, cmds=cmds, slots=slots)
    plane = mk_plane("port", eng, **kw)
    return eng, plane, WireListener(plane, port=0, max_conns=16,
                                    ring_bytes=4096)


def test_socket_client_end_to_end_with_mux_and_reconnect():
    eng, plane, lst = _socket_stack()
    cli = WireClient(lst.address, key="acme/alice", n_sessions=3)
    assert cli.epoch == 1 and cli.slots is not None
    for i in range(12):
        cli.enqueue(i + 1, sess=i % 3)
    cli.flush()
    _drive(lst, plane, cli, want_acked=12)
    old_slots = cli.slots.copy()
    cli.reconnect()
    assert cli.epoch == 2 and cli.slots.tolist() == old_slots.tolist()
    cli.enqueue(100, sess=0)
    cli.flush()
    _drive(lst, plane, cli, want_acked=13)
    assert int(lane_values(eng, np.arange(16)).sum()) == \
        sum(range(1, 13)) + 100
    assert lst.counters["hello_reconnects"] == 1
    lst.close()
    cli.close()
    eng.close()


def test_crash_reconnect_replays_exactly_once():
    eng, plane, lst = _socket_stack(lanes=8, slots=8)
    cli = WireClient(lst.address, key="crash/c1")
    for i in range(6):
        cli.enqueue(i + 1)
    cli.flush()
    deadline = time.monotonic() + 30.0
    while lst.counters["swept_rows"] < 6:
        lst.sweep()
        assert time.monotonic() < deadline
        time.sleep(0.005)
    plane.pump(force=True)
    plane.settle()
    cli._rx = b""                     # verdicts and acks never read
    cli.close(keep_state=True)
    cli._connect()
    assert cli.epoch == 2 and len(cli._queued) == 6
    deadline = time.monotonic() + 30.0
    while int(cli.watermark[0]) < 6:   # the handshake's watermark replay
        cli.poll()
        assert time.monotonic() < deadline
        time.sleep(0.005)
    assert int(cli.watermark[0]) == 6
    _drive(lst, plane, cli, want_acked=6)
    assert int(lane_values(eng, np.arange(8)).sum()) == sum(range(1, 7))
    lst.close()
    cli.close()
    eng.close()


def test_slot_reuse_and_version_and_width_refusals():
    """A closed client's slot is reused without closing the new tenant;
    a HELLO of another wire version gets an ERR frame and a close; a
    client declaring another payload width is refused at HELLO."""
    eng, plane, lst = _socket_stack(lanes=8)
    a = WireClient(lst.address, key="a")
    a.close()
    deadline = time.monotonic() + 10.0
    while lst.counters["conns_closed"] < 1:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    b = WireClient(lst.address, key="b")
    a2 = WireClient(lst.address, key="a")
    assert a2.epoch == 2
    b.enqueue(5)
    b.flush()
    _drive(lst, plane, b, want_acked=1)
    assert lst.counters["protocol_errors"] == 0
    sock = socket.create_connection(lst.address, timeout=5.0)
    bad = bytearray(framing.encode_hello("v2-client", 1))
    bad[5] = framing.WIRE_VERSION + 1
    sock.sendall(bytes(bad))
    buf, fr = b"", None
    while fr is None:
        assert time.monotonic() < deadline + 10
        chunk = sock.recv(64)
        if not chunk:
            break
        buf += chunk
        fr = framing.read_frame(buf)
    assert fr is not None and fr[0] == framing.T_ERR
    assert framing.decode_error(fr[1])["code"] == framing.E_VERSION
    assert sock.recv(64) == b""
    sock.close()
    with pytest.raises(ConnectionError, match="payload_width"):
        WireClient(lst.address, key="wide/c1", payload_width=4)
    ok = WireClient(lst.address, key="wide/c2",
                    payload_width=lst.payload_width)
    assert ok.epoch == 1
    for c in (ok, a2, b):
        c.close()
    lst.close()
    eng.close()


# -- the soak, against the reference's --------------------------------------

#: tail-row keys that are times, rates or the device-plane stamp: they
#: differ between any two runs
_TIMED = {"value", "wire_cmds_per_s", "wire_reconnect_recovery_s",
          "elapsed_s", "work_s", "n_compiles", "n_recompiles",
          "compile_time_s", "transfer_bytes", "peak_live_bytes",
          "transfer_bytes_per_cmd"}


@pytest.fixture
def dispatch_barrier(monkeypatch):
    """Every dispatch of either package's driver behind a durability
    barrier (each WAL shard confirmed), so that a durable soak commits
    the same steps in both; and each engine's last state, taken as it
    closes."""
    finals = {}
    for name, cls in (("ref", ref_lockstep_mod.DispatchAheadDriver),
                      ("port", port_driver.DispatchAheadDriver)):
        for meth in ("submit", "drain"):
            orig = getattr(cls, meth)

            def call(self, *a, _orig=orig, **kw):
                if getattr(self.engine, "_dur", None) is not None:
                    self.engine._dur.flush_all()
                return _orig(self, *a, **kw)
            monkeypatch.setattr(cls, meth, call)
    for name, cls, arrays in (
            ("ref", ref_lockstep_mod.LockstepEngine, ref_arrays),
            ("port", port_lockstep.LockstepEngine, state_to_numpy)):
        orig = cls.close

        def close(self, _orig=orig, _name=name, _arrays=arrays):
            finals[_name] = _arrays(self.state)
            return _orig(self)
        monkeypatch.setattr(cls, "close", close)
    return finals


@pytest.mark.parametrize("durable", [False, True])
def test_wire_soak_cpu_scale_matches_reference(tmp_path, dispatch_barrier,
                                               durable):
    """256 connections, 64 lanes, 3 waves of 1,000 ops, the storm at
    wave 1, member chaos: the oracle holds in the port's soak, and every
    count of its tail row and every leaf of its final state equal the
    reference's soak with the same seed."""
    kw = dict(conns=256, lanes=64, waves=3, wave_ops=1_000, cmds=8,
              superstep_k=2, storm_wave=1, tenants=4)
    rows = {}
    for pkg, fn in (("ref", ref_run_wire_soak), ("port", run_wire_soak)):
        extra = {"device": CPU} if pkg == "port" else {}
        if durable:
            extra["durable_dir"] = str(tmp_path / pkg)
        rows[pkg] = fn(5, **kw, **extra)
    got, want = rows["port"], rows["ref"]
    assert got["durable"] == durable and got["storm_requeued"] > 0
    assert got["dup_rows_absorbed"] > 0 and got["ops"] > 0
    assert {k: v for k, v in got.items() if k not in _TIMED} == \
        {k: v for k, v in want.items() if k not in _TIMED}
    assert_same_arrays(dispatch_barrier["port"], dispatch_barrier["ref"],
                       "soak final state")


def test_wire_soak_with_sockets_and_disk_faults(tmp_path):
    """The reference's CPU-scaled socket and disk-fault rung, on the port:
    a loopback fleet beside real-socket clients, durable with a seeded
    DiskFaultPlan injecting WAL faults, the storm; the soak's
    exactly-once oracle holds (it raises otherwise).  The wave hook is
    called as each wave starts and as the drain starts."""
    seen = []
    res = run_wire_soak(1, conns=1_000, lanes=64, waves=4, wave_ops=2_000,
                        cmds=8, superstep_k=2, socket_conns=2, socket_ops=8,
                        durable_dir=str(tmp_path / "w"), disk_faults=True,
                        device=CPU, on_wave=seen.append)
    assert seen == [0, 1, 2, 3, 4]
    assert res["durable"] and res["socket_conns"] == 2
    assert res["dup_rows_absorbed"] >= 0
    assert res["wire_swept_rows"] > res["ops"] > 0
    assert sum(res["disk_faults_injected"].values()) > 0


def test_wire_soak_refuses_a_mesh():
    """``mesh=True`` shards over the visible cards: a CPU engine cannot
    be placed there (without a card the mesh itself cannot be built),
    and the soak raises rather than run on one device."""
    with pytest.raises((RuntimeError, ValueError),
                       match="no CUDA device|not the engine's"):
        run_wire_soak(0, conns=8, lanes=4, mesh=True, device=CPU)


def test_recovery_reseeds_dedup_slots_across_generations(tmp_path):
    """Machine state is durable, the session/slot directory is not: a
    listener over a recovered engine skips the dead generation's dedup
    slots, so a fresh client's early ops are not deduped against a dead
    client's watermark.  The port recovers the reference's data dir, and
    its own, to the same state."""
    runs = {}
    for pkg in ("ref", "port"):
        d = str(tmp_path / pkg)
        if pkg == "ref":
            eng = ref_open_engine(RefDedup(slots=64), d, 16, wal_shards=2,
                                  ring_capacity=256, max_step_cmds=8,
                                  donate=False)
        else:
            eng = open_engine(DedupCounterMachine(slots=64), d, 16,
                              wal_shards=2, ring_capacity=256,
                              max_step_cmds=8, device=CPU)
        plane = mk_plane(pkg, eng)
        lst = mk_listener(pkg, plane, port=None, max_conns=64,
                          ring_bytes=2048)
        f = mk_fleet(pkg, lst, 32, key="gen1", seed=0)
        f.new_ops(np.arange(32), np.full(32, 3, np.int32))
        f.send_queued()
        lst.sweep()
        f.collect()
        plane.pump(force=True)
        plane.settle()
        runs[pkg] = f.expected_lane_sums(16)
        eng._dur.flush_all()
        lst.close()
        eng.checkpoint()
        eng.close()
    assert np.array_equal(runs["ref"], runs["port"])
    expected = runs["port"]
    # the port reopens its own dir under another shard layout, and the
    # reference's dir: the dedup watermarks recover in both
    for src in ("port", "ref"):
        eng2 = open_engine(DedupCounterMachine(slots=64),
                           str(tmp_path / src), 16, wal_shards=4,
                           ring_capacity=256, max_step_cmds=8, device=CPU)
        np.testing.assert_array_equal(lane_values(eng2, np.arange(16)),
                                      expected)
        plane2 = mk_plane("port", eng2)
        lst2 = WireListener(plane2, port=None, max_conns=64,
                            ring_bytes=2048)
        assert (lst2._lane_next > 0).any()
        f2 = LoopbackFleet(lst2, 32, key="gen2", seed=1)
        seq = eng2.consistent_read(np.arange(16))["seq"]
        for i in range(32):
            lane = int(plane2.directory.lane[f2.handles[i]])
            assert int(seq[lane][int(f2.slots[i])]) == 0, (src, i)
        f2.new_ops(np.arange(32), np.full(32, 5, np.int32))
        f2.send_queued()
        lst2.sweep()
        f2.collect()
        plane2.pump(force=True)
        plane2.settle()
        f2.collect()
        np.testing.assert_array_equal(
            lane_values(eng2, np.arange(16)),
            expected + f2.expected_lane_sums(16))
        assert f2.acked_mask().all()
        lst2.close()
        eng2.close()
