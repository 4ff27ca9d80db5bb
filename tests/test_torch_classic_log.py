"""The port's classic log plane against the reference's.

* ``MemoryLog`` and ``DurableLog``: one seeded script of appends,
  overwrites, confirms, WAL rollovers with segment flushes, release
  cursors (snapshots) and meta stores goes to both packages, each in its
  own directory; after every operation the logs read back equal (index,
  term and codec image; meta by value), and again after a reopen.  The
  port also reopens a copy of the reference's directory to the same log.
* Segment files: one written by either package reads in the other.
* A data directory written by the reference's ``RaSystem`` under a
  three-member KV cluster with one membership change and snapshots is
  recovered by the port's ``RaSystem`` (through ``convert.py``'s reader)
  to the terms, commit indexes, logs and machine states of the
  reference's own recovery of the same directory, then served live.
* The WAL write strategies (``default``, ``o_sync``,
  ``sync_after_notify``): both packages round-trip each, refuse a bogus
  one, run the durable engine under ``o_sync``, and re-write the
  confirmed suffix after a failed deferred sync.
"""
import os
import shutil
import time

import numpy as np
import pytest
import torch

import ra_tpu
import ra_tpu.codec as ref_codec
import ra_tpu.core.types as ref_types
import ra_tpu.log.faults as ref_faults
import ra_tpu_torch
import ra_tpu_torch.codec as port_codec
import ra_tpu_torch.core.types as port_types
import ra_tpu_torch.log.faults as port_faults
from ra_tpu.log.memory import MemoryLog as RefMemoryLog
from ra_tpu.log.segment import SegmentFile as RefSegmentFile
from ra_tpu.log.wal import Wal as RefWal, scan_wal_file as ref_scan
from ra_tpu.models.kv import KvMachine as RefKv
from ra_tpu.system import RaSystem as RefSystem
from ra_tpu_torch.core.server import RaServer
from ra_tpu_torch.log.memory import MemoryLog
from ra_tpu_torch.log.segment import SegmentFile
from ra_tpu_torch.log.wal import Wal, scan_wal_file
from ra_tpu_torch.models.kv import KvMachine
from ra_tpu_torch.system import RaSystem

from nemesis import await_leader
from test_torch_classic_core import log_image, norm
from test_torch_durable import K, N, assert_engines_equal, barrier, \
    open_pair

REF = dict(types=ref_types, codec=ref_codec, system=RefSystem,
           memlog=RefMemoryLog)
PORT = dict(types=port_types, codec=port_codec, system=RaSystem,
            memlog=MemoryLog)

# injected faults legitimately poison WAL files; the ladder is the test
pytestmark = pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")


@pytest.fixture(autouse=True)
def _clean_fault_state():
    for f in (ref_faults, port_faults):
        f.clear_plan()
        f.reset_disk_fault_counters()
    yield
    for f in (ref_faults, port_faults):
        f.clear_plan()
        f.reset_disk_fault_counters()


# -- one log, driven in both packages -----------------------------------------

class LogSide:
    """One package's log (memory, or durable over its own RaSystem)."""

    def __init__(self, pkg, data_dir=None):
        self.pkg, self.dir = pkg, data_dir
        self.system = None
        self.open()

    def open(self):
        t = self.pkg["types"]
        if self.dir is None:
            self.log = self.pkg["memlog"]()
            return
        self.system = self.pkg["system"](self.dir, wal_supervise=False)
        self.log = self.system.log_factory(t.ServerConfig(
            server_id=None, uid="u1", cluster_name="c",
            initial_members=(), machine=None))

    def close(self):
        if self.system is not None:
            self.system.close()

    def drain(self, timeout=10.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for e in self.log.take_events():
                self.log.handle_written(e)
            if self.log.last_written().index >= \
                    self.log.last_index_term().index:
                return
            time.sleep(0.002)
        raise TimeoutError("log never confirmed")

    def flush_segments(self):
        if self.system is not None:
            self.system.wal.rollover()
            self.system.wal.flush()
            self.system.segment_writer.await_idle()

    def view(self):
        log = self.log

        class _S:
            pass
        s = _S()
        s.log = log
        snap = log.recover_snapshot_state()
        return dict(
            entries=log_image(s, self.pkg["codec"]),
            last=tuple(log.last_index_term()),
            written=tuple(log.last_written()),
            first=log.first_index(),
            snap=tuple(log.snapshot_index_term()),
            snap_state=norm(snap) if snap else None,
            meta={k: norm(log.fetch_meta(k))
                  for k in ("current_term", "voted_for", "last_applied")})


def log_script(rng, n_ops):
    """Seeded operations: (kind, args) over plain values."""
    ops, last, term = [], 0, 1
    for _ in range(n_ops):
        kind = ["append", "append", "append", "overwrite", "segments",
                "release", "meta"][int(rng.integers(7))]
        if kind == "append" or last < 3:
            k = int(rng.integers(1, 12))
            vals = [int(v) for v in rng.integers(-99, 99, k)]
            ops.append(("append", last + 1, term, vals))
            last += k
        elif kind == "overwrite":
            term += 1
            at = int(rng.integers(last - 2, last + 1))
            ops.append(("overwrite", at, term, int(rng.integers(99))))
            last = at
        elif kind == "release":
            ops.append(("release", int(rng.integers(1, last + 1))))
        else:
            ops.append((kind, term, int(rng.integers(1, 4))))
    return ops


def apply_op(side, op):
    t = side.pkg["types"]
    log = side.log
    kind = op[0]
    if kind == "append":
        _k, lo, term, vals = op
        for i, v in enumerate(vals):
            data = (v, f"k{v % 7}") if v % 3 == 0 else v
            log.append(t.Entry(lo + i, term, t.UserCommand(data)))
    elif kind == "overwrite":
        _k, at, term, v = op
        log.write([t.Entry(at, term, t.UserCommand(v))])
    elif kind == "release":
        side.drain()
        idx = min(op[1], log.last_written().index)
        if idx > log.snapshot_index_term().index:
            cluster = ((t.ServerId("s1", "n1"), t.Membership.VOTER),)
            log.update_release_cursor(idx, cluster, 0, {"acc": idx})
    elif kind == "segments":
        side.drain()
        side.flush_segments()
    elif kind == "meta":
        _k, term, who = op
        log.store_meta(current_term=term,
                       voted_for=t.ServerId(f"s{who}", f"n{who}"),
                       last_applied=log.last_written().index)
    side.drain()


@pytest.mark.parametrize("durable", [False, True], ids=["memory", "durable"])
def test_log_script_matches_reference(tmp_path, durable):
    rng = np.random.default_rng(11)
    ops = log_script(rng, 40)
    ref = LogSide(REF, str(tmp_path / "ref") if durable else None)
    port = LogSide(PORT, str(tmp_path / "port") if durable else None)
    try:
        for op in ops:
            apply_op(ref, op)
            apply_op(port, op)
            assert port.view() == ref.view(), op
        assert ref.view()["snap"][0] > 0
        if not durable:
            return
        want = ref.view()
        for side in (ref, port):
            side.close()
            side.open()
            assert side.view() == want
        # the port reopens a copy of the reference's directory
        ref.close()
        shutil.copytree(tmp_path / "ref", tmp_path / "ref_copy")
        cross = LogSide(PORT, str(tmp_path / "ref_copy"))
        try:
            assert cross.view() == want
        finally:
            cross.close()
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_segment_file_reads_in_other_package(tmp_path, writer):
    classes = {"ref": (RefSegmentFile, ref_codec),
               "port": (SegmentFile, port_codec)}
    W, wcodec = classes[writer]
    R, _ = classes["port" if writer == "ref" else "ref"]
    path = str(tmp_path / "t.segment")
    seg = W(path, max_count=16, create=True)
    t = ref_types if writer == "ref" else port_types
    images = {i: wcodec.encode_command(t.UserCommand(("v", i * 11)))
              for i in range(1, 13)}
    for i, img in images.items():
        assert seg.append(i, 1 + i // 5, img)
    seg.flush()
    seg.close()
    got = R(path)
    assert got.range() == (1, 12)
    for i, img in images.items():
        term, payload = got.read(i)
        assert (term, payload) == (1 + i // 5, img)
    got.close()


# -- a reference data directory, recovered by the port --------------------------

def write_reference_cluster(base):
    """Three nodes, each with its own reference RaSystem, a KV cluster
    with snapshots every 8 commands, a WAL rollover into segments, one
    membership change (a follower leaves) and puts on either side of it.
    Returns the member that left."""
    router = ra_tpu.LocalRouter()
    sids = [ref_types.ServerId(f"m{i}", f"node{i}") for i in (1, 2, 3)]
    systems = {s.node: RefSystem(os.path.join(base, s.node)) for s in sids}
    nodes = {s.node: ra_tpu.RaNode(s.node, router=router,
                                   log_factory=systems[s.node].log_factory)
             for s in sids}
    try:
        for sid in sids:
            nodes[sid.node].start_server(ref_types.ServerConfig(
                server_id=sid, uid=f"uid{sid.name}", cluster_name="kv",
                initial_members=tuple(sids),
                machine=RefKv(snapshot_interval=8),
                election_timeout_ms=300))
        ra_tpu.trigger_election(sids[0], router)
        leader = await_leader(router, sids)
        rng = np.random.default_rng(3)
        for i in range(30):
            ra_tpu.process_command(
                leader, ("put", f"k{int(rng.integers(6))}", i),
                router=router)
        for system in systems.values():   # part of the log to segments
            system.wal.rollover()
            system.wal.flush()
            system.segment_writer.await_idle()
        victim = [s for s in sids if s != leader][-1]
        ra_tpu.remove_member(leader, victim, router=router)
        leader = await_leader(router, [s for s in sids if s != victim])
        for i in range(30, 41):
            ra_tpu.process_command(
                leader, ("put", f"k{int(rng.integers(6))}", i),
                router=router)
    finally:
        for n in nodes.values():
            n.stop()
        for s in systems.values():
            s.close()
    return victim


def recover_cores(pkg, base, machine_cls):
    """Every registered server of every node dir, recovered into a bare
    ``RaServer`` core (no node, no timers): its state after recovery."""
    t = pkg["types"]
    core = RaServer if pkg is PORT else __import__(
        "ra_tpu.core.server", fromlist=["RaServer"]).RaServer
    out = {}
    for node in sorted(os.listdir(base)):
        system = pkg["system"](os.path.join(base, node),
                               wal_supervise=False)
        try:
            for uid in system.directory.uids():
                snap = system.directory.config_of(uid)
                cfg = t.ServerConfig(
                    server_id=t.ServerId(*snap["server_id"]), uid=uid,
                    cluster_name=snap["cluster_name"],
                    initial_members=tuple(t.ServerId(*m)
                                          for m in snap["initial_members"]),
                    machine=machine_cls(snapshot_interval=8))
                srv = core(cfg, system.log_factory(cfg))
                srv.recover()
                out[uid] = dict(
                    term=srv.current_term, voted_for=norm(srv.voted_for),
                    commit=srv.commit_index, applied=srv.last_applied,
                    cluster=sorted(repr(norm(m)) for m in srv.cluster),
                    log=log_image(srv, pkg["codec"]),
                    snap=tuple(srv.log.snapshot_index_term()),
                    state=norm(srv.machine_state))
        finally:
            system.close()
    return out


def test_port_system_recovers_reference_directory(tmp_path):
    base = str(tmp_path / "ref")
    victim = write_reference_cluster(base)
    shutil.copytree(base, tmp_path / "for_port")
    want = recover_cores(REF, base, RefKv)
    got = recover_cores(PORT, str(tmp_path / "for_port"), KvMachine)
    assert got == want
    assert any(v["snap"][0] > 0 for v in want.values())
    assert all(len(v["cluster"]) == 2 for k, v in want.items()
               if k != f"uid{victim.name}")
    # ... and served live: the port's nodes recover the two members and
    # answer a linearizable read equal to the recovered state
    router = ra_tpu_torch.LocalRouter()
    systems, nodes = {}, {}
    live = [n for n in ("node1", "node2", "node3") if n != victim.node]
    try:
        for node in live:
            systems[node] = RaSystem(str(tmp_path / "for_port" / node))
            nodes[node] = ra_tpu_torch.RaNode(
                node, router=router, system=systems[node], device="cpu")
            systems[node].recover_servers(
                nodes[node], lambda c, s: KvMachine(snapshot_interval=8))
        sids = [port_types.ServerId(f"m{n[-1]}", n) for n in live]
        ra_tpu_torch.trigger_election(sids[0], router)
        leader = await_leader(router, sids)
        res = ra_tpu_torch.consistent_query(
            leader, lambda st: dict(st.data), router=router)
        ref_state = want[f"uid{sids[0].name}"]["state"]
        assert norm(res.reply) == dict(ref_state[1])["data"]
    finally:
        for n in nodes.values():
            n.stop()
        for s in systems.values():
            s.close()


# -- WAL write strategies -------------------------------------------------------

def _strategy_roundtrip(path, wal_cls, scan, strategy):
    confirms = []
    wal = wal_cls(str(path), sync_mode=1, write_strategy=strategy)
    wal.register("u1", lambda uid, lo, hi, term: confirms.append((lo, hi)))
    for i in range(1, 21):
        wal.write("u1", i, 1, f"payload-{i}".encode())
    wal.flush()
    wal.close()
    tables = {}
    wdir = os.path.join(str(path), "wal")
    for f in sorted(os.listdir(wdir)):
        if f.endswith(".wal"):
            scan(os.path.join(wdir, f), tables)
    return confirms[-1][1], {i: v for i, v in tables["u1"].items()}


@pytest.mark.parametrize("strategy",
                         ["default", "o_sync", "sync_after_notify"])
def test_wal_strategy_roundtrip_matches_reference(tmp_path, strategy):
    want = _strategy_roundtrip(tmp_path / "ref", RefWal, ref_scan, strategy)
    got = _strategy_roundtrip(tmp_path / "port", Wal, scan_wal_file,
                              strategy)
    assert got == want and got[0] == 20 and sorted(got[1]) == \
        list(range(1, 21))
    assert Wal(str(tmp_path / "x"), write_strategy=strategy).write_strategy \
        == strategy


def test_wal_strategy_unknown_rejected(tmp_path):
    for cls in (RefWal, Wal):
        with pytest.raises(ValueError, match="bogus"):
            cls(str(tmp_path), write_strategy="bogus")


def test_engine_durable_o_sync_strategy_matches_reference(tmp_path):
    """The durable engine runs over the o_sync strategy in both packages
    to equal states, horizons and counters."""
    ref, port = open_pair(tmp_path, sync_mode=1, write_strategy="o_sync")
    try:
        assert port._dur._bb_config["write_strategy"] == "o_sync"
        assert all(s.wal.write_strategy == "o_sync"
                   for s in port._dur._shards)
        rng = np.random.default_rng(8)
        n, k = N, K
        for step in range(10):
            n_new = rng.integers(0, k + 1, n).astype(np.int32) \
                if step < 6 else np.zeros(n, np.int32)
            pay = rng.integers(-9, 10, (n, k, 1)).astype(np.int32)
            barrier(ref, port)
            ref.step(n_new, pay)
            port.step(n_new, pay)
        assert_engines_equal(ref, port, "o_sync")
        assert port.committed_total() == ref.committed_total() > 0
    finally:
        ref.close()
        port.close()


def _sync_after_notify_fault(path, wal_cls, scan, faults):
    sent, confirmed = {}, []
    wal = wal_cls(str(path), sync_mode=1,
                  write_strategy="sync_after_notify")
    try:
        def notify(uid, lo, hi, term):
            if lo is None:
                for i in sorted(sent):
                    if i > hi:
                        wal.write(uid, i, 1, sent[i])
            else:
                confirmed.append((lo, hi))

        wal.register("u1", notify)
        faults.install_plan(faults.DiskFaultPlan(
            seed=27, by_class={"wal": faults.DiskFaultSpec(fsync_eio=1.0,
                                                           limit=1)}))
        for i in range(1, 21):
            sent[i] = f"v-{i}".encode()
            wal.write("u1", i, 1, sent[i])
        wal.flush(timeout=10.0)
        faults.clear_plan()
        ctr = faults.disk_fault_counters()
    finally:
        faults.clear_plan()
        wal.close()
    tables: dict = {}
    wdir = os.path.join(str(path), "wal")
    for f in sorted(os.listdir(wdir)):
        if f.endswith(".wal"):
            scan(os.path.join(wdir, f), tables)
    return (ctr["poisoned_files"], ctr["fsync_retries_after_failure"],
            max(hi for _lo, hi in confirmed), tables.get("u1", {}))


def test_sync_after_notify_fault_rewrites_confirmed_suffix(tmp_path):
    """A failed deferred sync poisons the file and pulls the resend floor
    below the already-confirmed suffix (``confirmed=``), so the whole log
    is on disk in the fresh file: equal in both packages."""
    want = _sync_after_notify_fault(tmp_path / "ref", RefWal, ref_scan,
                                    ref_faults)
    got = _sync_after_notify_fault(tmp_path / "port", Wal, scan_wal_file,
                                   port_faults)
    assert got == want
    poisoned, retries, hi, table = got
    assert poisoned >= 1 and retries == 0 and hi == 20
    assert sorted(table) == list(range(1, 21)) and \
        table[20][1] == b"v-20"


# -- a reply handle survives a segment flush (ROADMAP Queue 3 item 11) --------

def test_flush_keeps_unapplied_reply_handles(tmp_path):
    """Local commands with reply handles, confirmed, then flushed to
    segments past the apply watermark before the apply reads them: the
    port hands every unapplied entry back with its handle, while the
    reference reads it back from the segment with ``from_`` None, the
    lost reply (a departure kept on purpose).  Applied entries read back
    from the segment in both, and the segments are equal."""
    from concurrent.futures import Future
    vals = [int(v) for v in np.random.default_rng(12).integers(-99, 99, 16)]
    applied, up_to = 5, 12
    sides = {"ref": LogSide(REF, str(tmp_path / "ref")),
             "port": LogSide(PORT, str(tmp_path / "port"))}
    try:
        kept = {}
        for name, side in sides.items():
            t = side.pkg["types"]
            hs = [Future() for _ in vals]
            for i, (v, h) in enumerate(zip(vals, hs), 1):
                side.log.append(t.Entry(i, 1, t.UserCommand(v, from_=h)))
            side.drain()
            if name == "port":
                side.log.note_applied(applied)
            side.log.flush_mem_to_segments(up_to)
            kept[name] = [side.log.fetch(i).command.from_ is h
                          for i, h in enumerate(hs, 1)]
        n = len(vals)
        assert kept["port"] == [False] * applied + [True] * (n - applied)
        assert kept["ref"] == [False] * up_to + [True] * (n - up_to)
        assert sides["port"].view() == sides["ref"].view()
        # the apply passes the kept entries: the port prunes them
        sides["port"].log.note_applied(up_to)
        assert [sides["port"].log.fetch(i).command.from_ is None
                for i in range(1, n + 1)] == \
            [True] * up_to + [False] * (n - up_to)
        assert sides["port"].view() == sides["ref"].view()
    finally:
        for side in sides.values():
            side.close()


def test_every_put_answers_across_wal_rollovers(tmp_path):
    """Three nodes, each with a ``RaSystem`` rolling its WAL every 24
    entries, 200 KV puts through ``process_command``: every put answers
    within 3 s and every member applies them all.  The port only: the
    reference loses a reply at a timing-dependent put."""
    from test_torch_classic_card import PORT as CARD, Deployment
    pkg = dict(CARD, system=lambda d: RaSystem(d, wal_max_entries=24))
    dep = Deployment(pkg, str(tmp_path), KvMachine)
    try:
        for i in range(200):
            res = ra_tpu_torch.process_command(
                dep.leader, ("put", f"k{i % 7}", i), router=dep.router,
                timeout=3.0)
            assert not isinstance(res, port_types.ErrorResult), (i, res)
        assert dep.settle() >= 200
    finally:
        dep.close()


# -- a reference JitMachine snapshot, read by the port ------------------------

def snapshotting(cls):
    """``cls`` (a JitKvMachine of either package) releasing its log every
    8 indexes, so its state lands in a snapshot."""
    class Snapshotting(cls):
        def apply(self, meta, command, state):
            new, reply = super().apply(meta, command, state)
            if meta.index % 8 == 0:
                return new, reply, [self.release(meta.index, new)]
            return new, reply
    return Snapshotting


def recover_jit_states(core, system_cls, base, machine, **core_kw):
    """Every server of every node dir of ``base`` recovered into a bare
    core: uid -> (snapshot index, last applied, {leaf: numpy array})."""
    out = {}
    for node in sorted(os.listdir(base)):
        system = system_cls(os.path.join(base, node), wal_supervise=False)
        try:
            for uid in system.directory.uids():
                snap = system.directory.config_of(uid)
                cfg = machine.types.ServerConfig(
                    server_id=machine.types.ServerId(*snap["server_id"]),
                    uid=uid, cluster_name=snap["cluster_name"],
                    initial_members=tuple(machine.types.ServerId(*m)
                                          for m in snap["initial_members"]),
                    machine=machine())
                srv = core(cfg, system.log_factory(cfg), **core_kw)
                srv.recover()
                out[uid] = (srv.log.snapshot_index_term().index,
                            srv.last_applied, leaf_arrays(srv.machine_state))
        finally:
            system.close()
    return out


def jit_kv_machines():
    """Factories of a snapshotting ``JitKvMachine(8)`` of each package,
    each carrying its package's types: (reference, port)."""
    from ra_tpu.core.types import ReleaseCursor as RefRelease
    from ra_tpu.models.jit_kv import JitKvMachine as RefJitKv
    from ra_tpu_torch.models.jit_kv import JitKvMachine

    ref_cls = snapshotting(RefJitKv)
    ref_cls.release, ref_cls.types = staticmethod(RefRelease), ref_types
    port_cls = snapshotting(JitKvMachine)
    port_cls.release = staticmethod(port_types.ReleaseCursor)
    port_cls.types = port_types
    ref_machine = lambda: ref_cls(n_keys=8)  # noqa: E731
    ref_machine.types = ref_types
    port_machine = lambda: port_cls(n_keys=8)  # noqa: E731
    port_machine.types = port_types
    return ref_machine, port_machine


def write_reference_jit_cluster(base: str, ref_machine) -> None:
    """A reference three-node ``JitKvMachine`` cluster under ``base``: 29
    seeded puts, snapshots every 8 indexes (JAX arrays in the pickle)."""
    router = ra_tpu.LocalRouter()
    sids = [ref_types.ServerId(f"m{i}", f"node{i}") for i in (1, 2, 3)]
    systems = {s.node: RefSystem(os.path.join(base, s.node)) for s in sids}
    nodes = {s.node: ra_tpu.RaNode(s.node, router=router,
                                   log_factory=systems[s.node].log_factory)
             for s in sids}
    try:
        for sid in sids:
            nodes[sid.node].start_server(ref_types.ServerConfig(
                server_id=sid, uid=f"uid{sid.name}", cluster_name="jkv",
                initial_members=tuple(sids), machine=ref_machine(),
                election_timeout_ms=300))
        ra_tpu.trigger_election(sids[0], router)
        leader = await_leader(router, sids)
        rng = np.random.default_rng(13)
        for _ in range(29):
            k, v = (int(x) for x in rng.integers(0, [8, 2 ** 31 - 1]))
            ra_tpu.process_command(leader, ("put", k, v), router=router)
    finally:
        for n in nodes.values():
            n.stop()
        for s in systems.values():
            s.close()


def leaf_arrays(st) -> dict:
    """A machine state's leaves: name -> (device or None, numpy array)."""
    leaves = st if isinstance(st, dict) else {"state": st}
    return {k: (getattr(v, "device", None),
                np.asarray(v.cpu() if hasattr(v, "cpu") else v))
            for k, v in leaves.items()}


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)])
def test_port_recovers_reference_jit_machine_snapshot(tmp_path, device):
    """A reference three-node ``JitKvMachine`` cluster whose snapshots hold
    JAX arrays, recovered by the port: every member's state equal to the
    reference's own recovery of the same directory (values and dtypes),
    every leaf on the device the node names."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from ra_tpu.core.server import RaServer as RefServer

    ref_machine, port_machine = jit_kv_machines()
    base = str(tmp_path / "ref")
    write_reference_jit_cluster(base, ref_machine)
    shutil.copytree(base, tmp_path / "for_port")
    want = recover_jit_states(RefServer, RefSystem, base, ref_machine)
    got = recover_jit_states(RaServer, RaSystem, str(tmp_path / "for_port"),
                             port_machine, machine_config={"device": device})
    assert sorted(got) == sorted(want) and len(want) == 3
    for uid, (snap, applied, leaves) in want.items():
        g_snap, g_applied, g_leaves = got[uid]
        assert (g_snap, g_applied) == (snap, applied) and snap >= 24
        assert sorted(g_leaves) == sorted(leaves)
        for k, (_, arr) in leaves.items():
            g_dev, g_arr = g_leaves[k]
            assert g_dev.type == device, (uid, k, g_dev)
            assert g_arr.dtype == arr.dtype and np.array_equal(g_arr, arr)


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)])
def test_dbg_replays_reference_jit_machine_directory(tmp_path, device):
    """``dbg.replay_log`` over each node of a reference ``JitKvMachine``
    directory whose snapshot holds JAX arrays: the replayed state equal to
    the reference ``dbg``'s (values and dtypes), and every leaf on the
    device asked for, the snapshot's state as well as every applied one."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from ra_tpu import dbg as ref_dbg
    from ra_tpu_torch import dbg

    ref_machine, port_machine = jit_kv_machines()
    base = str(tmp_path / "ref")
    write_reference_jit_cluster(base, ref_machine)
    shutil.copytree(base, tmp_path / "for_port")
    for node in ("node1", "node2", "node3"):
        uid = f"uidm{node[-1]}"
        d = os.path.join(base, node)
        assert ref_dbg.read_log(d, uid)[0] is not None
        want = leaf_arrays(ref_dbg.replay_log(d, uid, ref_machine()))
        seen = []
        got = leaf_arrays(dbg.replay_log(
            str(tmp_path / "for_port" / node), uid, port_machine(),
            on_entry=lambda e, st: seen.append(leaf_arrays(st)),
            device=device))
        assert seen and sorted(got) == sorted(want)
        for leaves in seen + [got]:
            assert {dev.type for dev, _ in leaves.values()} == {device}
        for k, (_, arr) in want.items():
            assert got[k][1].dtype == arr.dtype
            assert np.array_equal(got[k][1], arr), (node, k)
        if not torch.cuda.is_available():
            # no device named: the card, which a snapshot's state is not
            # quietly kept off
            with pytest.raises(RuntimeError, match="no CUDA device"):
                dbg.replay_log(str(tmp_path / "for_port" / node), uid,
                               port_machine())


def test_dbg_replays_reference_directory(tmp_path):
    """``dbg.read_log`` and ``dbg.replay_log`` over each node of a
    reference KV directory (snapshot, segments and WAL): the port reads
    the same snapshot and entries and replays to the same state as the
    reference's ``dbg``, every entry's state seen by ``on_entry`` too."""
    from ra_tpu import dbg as ref_dbg
    from ra_tpu_torch import dbg

    base = str(tmp_path / "ref")
    write_reference_cluster(base)
    shutil.copytree(base, tmp_path / "for_port")
    for node in ("node1", "node2", "node3"):
        uid = f"uidm{node[-1]}"
        runs = {}
        for name, mod, machine, root in (
                ("ref", ref_dbg, RefKv, base),
                ("port", dbg, KvMachine, str(tmp_path / "for_port"))):
            d = os.path.join(root, node)
            snap, entries = mod.read_log(d, uid)
            seen = []
            state = mod.replay_log(
                d, uid, machine(snapshot_interval=8),
                on_entry=lambda e, st: seen.append((e.index, norm(st))))
            runs[name] = (norm(snap), [(e.index, e.term, norm(e.command))
                                       for e in entries],
                          norm(state), seen)
        assert runs["port"] == runs["ref"], node
        assert runs["port"][0] is not None and runs["port"][1]
