"""The port's WAL plane (``ra_tpu_torch.log``, ``native``, ``blackbox``,
``trace``) against the reference's.

* WAL files written by either package's ``Wal`` scan equal through the
  other's ``scan_wal_file``: entries, batch runs, an overwrite that
  truncates, and the engine's blocks.
* The native library is built from the port's own source into the
  ignored ``build/`` directory, and the reference's ``libra_wal.so`` is
  never loaded.
* The port's singletons are its own: a disk fault plan, the flight
  recorder and the tracer of one package do not reach the other.
* A durable port engine under injected WAL fsync failures commits only
  what is durable and recovers every commit it reported."""
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from ra_tpu import metrics as ref_metrics
from ra_tpu.blackbox import RECORDER as REF_RECORDER
from ra_tpu.log import faults as ref_faults
from ra_tpu.log.wal import Wal as RefWal
from ra_tpu.log.wal import scan_wal_file as ref_scan
from ra_tpu_torch import blackbox, metrics, native, trace
from ra_tpu_torch.engine.durable import open_engine
from ra_tpu_torch.log import Wal, WalDown, faults, scan_wal_file
from ra_tpu_torch.log.faults import DiskFaultPlan, DiskFaultSpec
from ra_tpu_torch.log.wal import MAX_POISON_STREAK
from ra_tpu_torch.models import CounterMachine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_field_registries_match_reference():
    for name in ("WAL_FIELDS", "ENGINE_WAL_FIELDS", "DISK_FAULT_FIELDS"):
        assert getattr(metrics, name) == getattr(ref_metrics, name), name
    for group in ("wal", "engine_wal", "disk_faults"):
        assert metrics.FIELD_REGISTRY[group] == \
            ref_metrics.FIELD_REGISTRY[group], group


def write_wal(wal_cls, data_dir):
    """Two writers: single entries, a batch run, an overwrite below the
    tail (a truncation) and a rollover between them."""
    wal = wal_cls(data_dir, sync_mode=0)
    confirmed = []
    wal.register("a", lambda uid, lo, hi, term: confirmed.append(hi))
    wal.register("b", lambda uid, lo, hi, term: None)
    for i in range(1, 8):
        wal.write("a", i, 1, b"a%03d" % i)
    wal.write_many("b", [(i, 2, b"b" * i, False) for i in range(1, 6)])
    wal.flush()
    wal.rollover()
    wal.write("a", 5, 2, b"a-overwrite", truncate=True)
    wal.write("a", 6, 2, b"a-6")
    wal.write_many("b", [(i, 2, b"B%d" % i, False) for i in range(6, 9)])
    wal.flush()
    wal.close()
    assert confirmed and max(confirmed) >= 6
    return os.path.join(data_dir, "wal")


def scan_dir(scan, wal_dir):
    tables: dict = {}
    for name in sorted(os.listdir(wal_dir)):
        if name.endswith(".wal"):
            scan(os.path.join(wal_dir, name), tables)
    return tables


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_wal_files_scan_equal_both_ways(tmp_path, writer):
    wal_dir = write_wal(RefWal if writer == "ref" else Wal, str(tmp_path))
    got = scan_dir(scan_wal_file, wal_dir)
    want = scan_dir(ref_scan, wal_dir)
    assert got == want
    assert sorted(got) == ["a", "b"]
    assert got["a"][5] == (2, b"a-overwrite") and 7 not in got["a"]
    assert got["b"][8] == (2, b"B8")


@pytest.mark.parametrize("torn", [2, 3])
def test_wal_open_rolls_past_a_torn_magic_write(tmp_path, torn):
    """A torn write of a fresh file's magic unlinks that file and opens
    the next, up to MAX_POISON_STREAK files (the reference raises at the
    first): the WAL then takes writes that scan back whole."""
    faults.install_plan(DiskFaultPlan(seed=0, by_class={
        "wal": DiskFaultSpec(short_write=1.0, limit=torn)}))
    try:
        if torn >= MAX_POISON_STREAK:
            with pytest.raises(OSError, match="torn"):
                Wal(str(tmp_path), sync_mode=0)
            return
        wal = Wal(str(tmp_path), sync_mode=0)
    finally:
        faults.clear_plan()
    wal_dir = str(tmp_path / "wal")
    assert os.listdir(wal_dir) == [f"{torn + 1:08d}.wal"]
    wal.register("a", lambda uid, lo, hi, term: None)
    for i in range(1, 4):
        wal.write("a", i, 1, b"a%d" % i)
    wal.flush()
    wal.close()
    assert scan_dir(scan_wal_file, wal_dir) == {
        "a": {i: (1, b"a%d" % i) for i in range(1, 4)}}


def test_engine_wal_written_by_either_scans_equal(tmp_path):
    """The durable engine's own WAL (RTB blocks) scans equal through
    both packages' scanners."""
    eng = open_engine(CounterMachine(), str(tmp_path), 8, 3, sync_mode=0,
                      ring_capacity=64, max_step_cmds=4, wal_shards=2,
                      device="cpu")
    for _ in range(3):
        eng.step(np.full(8, 3, np.int32), np.ones((8, 4, 1), np.int32))
    eng.close()
    for shard in ("shard00", "shard01"):
        wal_dir = str(tmp_path / shard / "wal")
        got, want = scan_dir(scan_wal_file, wal_dir), scan_dir(ref_scan,
                                                              wal_dir)
        assert got == want and len(got["__engine__"]) == 3


def test_native_library_builds_from_the_ports_source():
    assert native.SRC == \
        __import__("pathlib").Path(REPO, "ra_tpu_torch", "native",
                                   "wal_native.cpp")
    so = native.target()
    assert so.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "ra_tpu_torch")
    assert faults.IO._base is native.IO
    # in a fresh process: a WAL write loads the port's library, built from
    # that source, and never the reference's
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import tempfile\n"
        "from ra_tpu_torch import native\n"
        "from ra_tpu_torch.log import Wal\n"
        "assert not native.IO._loaded\n"
        "w = Wal(tempfile.mkdtemp(), sync_mode=1)\n"
        "w.register('u', lambda *a: None)\n"
        "w.write('u', 1, 1, b'x'); w.flush(); w.close()\n"
        "maps = open('/proc/self/maps').read()\n"
        "print(native.IO.native, str(native.target()) in maps,\n"
        "      'ra_tpu/native/libra_wal.so' in maps)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=180, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["True", "True", "False"], r.stdout


def test_fault_plan_recorder_and_tracer_are_the_ports_own(tmp_path):
    plan = DiskFaultPlan(seed=1, by_class={"wal": DiskFaultSpec(
        fsync_eio=1.0, limit=1)})
    faults.reset_disk_fault_counters()
    ref_before = dict(ref_faults.disk_fault_counters())
    faults.install_plan(plan)
    try:
        assert faults.current_plan() is plan
        assert ref_faults.current_plan() is None
        wal = Wal(str(tmp_path), sync_mode=1)
        wal.register("u", lambda *a: None)
        for i in range(1, 4):
            wal.write("u", i, 1, b"x")
        wal.flush()
        wal.close()
    finally:
        faults.clear_plan()
    assert faults.disk_fault_counters()["faults_injected"] == 1
    assert faults.disk_fault_counters()["fsync_retries_after_failure"] == 0
    assert ref_faults.disk_fault_counters() == ref_before
    n_ref = len(REF_RECORDER.events("disk"))
    assert any(e[1] == "disk.fault" for e in blackbox.RECORDER.events("disk"))
    assert len(REF_RECORDER.events("disk")) == n_ref
    assert blackbox.RECORDER.counters["unregistered_events"] == 0
    # a bundle and the recovery stamp that joins it
    path = blackbox.RECORDER.dump("test", what="w", data_dir=str(tmp_path))
    doc = blackbox.load_bundle(path)
    assert doc["reason"] == "test" and "disk_fault_plan" in doc["sources"]
    rep = blackbox.stamp_recovery({"plane": "engine"},
                                  data_dir=str(tmp_path))
    assert os.path.basename(path) in open(rep).read()
    # the tracer: off by default, then spans land in the port's buffer
    assert trace.get_tracer() is None
    tr = trace.Tracer()
    trace.set_tracer(tr)
    try:
        with trace.span("engine.step", "engine", k=1):
            pass
    finally:
        trace.set_tracer(None)
    assert [e["name"] for e in tr.events()] == ["engine.step"]
    out = tr.dump_chrome_trace(str(tmp_path / "t.json"))
    assert os.path.getsize(out) > 0


# a streak of failed fsyncs escalates to the WAL thread's death on
# purpose (the supervisor restarts it): part of the scenario under test
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_durable_engine_under_fsync_faults_recovers_every_commit(tmp_path):
    """WAL fsync failures poison and roll the file (or escalate to a
    supervised restart); the engine commits only what a later fsync made
    durable, and a reopen recovers every commit reported before the
    close."""
    n, p, k = 8, 3, 4
    kw = dict(sync_mode=1, ring_capacity=64, max_step_cmds=k, wal_shards=2,
              max_pending=16, device="cpu")
    eng = open_engine(CounterMachine(), str(tmp_path), n, p, **kw)
    faults.reset_disk_fault_counters()
    faults.install_plan(DiskFaultPlan(seed=5, by_class={
        "wal": DiskFaultSpec(fsync_eio=0.5, limit=4)}))
    try:
        for _ in range(12):
            eng.step(np.full(n, 2, np.int32), np.ones((n, k, 1), np.int32))
    finally:
        faults.clear_plan()
    for _ in range(8):
        try:
            eng._dur.flush_all()
        except WalDown:         # between an escalation and its restart
            time.sleep(0.05)
        eng.step(np.zeros(n, np.int32), np.zeros((n, k, 1), np.int32))
    eng._dur.flush_all()
    ctr = faults.disk_fault_counters()
    assert ctr["faults_injected"] >= 1 and ctr["poisoned_files"] >= 1
    assert ctr["fsync_retries_after_failure"] == 0
    st = eng.state
    lead = st.leader_slot.numpy()
    com = st.commit.numpy()[np.arange(n), lead]
    assert (com <= eng._dur.confirm_upto).all()
    committed = st.total_committed.numpy().copy()
    assert (committed == 24).all()
    eng.close()
    eng2 = open_engine(CounterMachine(), str(tmp_path), n, p, **kw)
    assert (eng2.state.total_committed.numpy() >= committed).all()
    mac = eng2.state.mac.numpy()
    assert (mac[np.arange(n), eng2.state.leader_slot.numpy()] == 24).all()
    eng2.close()
